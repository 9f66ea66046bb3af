"""The PyTorch port's kernels against the JAX package's.

On the CPU the port's kernel wrappers take their plain PyTorch versions;
they are held here against the Pallas kernels run in interpret mode and
against the jnp oracle, on inputs made from a numpy seed.  The CUDA
kernels are held against the plain versions on the card in
``tests/test_torch_cuda.py``.

Tolerances: every comparison is exact (bit for bit), except where the
JAX package's padded route evaluates in float32 what the port evaluates
in float64.  The port decides every event as the JAX package's host
evaluator (``repro.core.neardata.program_eval_np``, the staged
semantics): its group values (MASS, ΔR, HT, EXPR) are float64, in the
host's operation order.  The JAX padded route's are float32, so at an
event within float32 rounding of a cut the two padded routes may decide
otherwise.  Where a mask differs from the JAX padded route's, the port's
decision must be the JAX host evaluator's and the JAX padded route's
must not, on the columnar data the padded inputs hold
(:func:`_host_data`); the port's mass and ΔR values equal the host's bit
for bit.  The JAX route's float32 masses are held to the port's as
before: XLA's float32 cos/sin/sinh/cosh are off by an ulp or a few (up
to 6 for sinh), and the invariant mass is the root of a difference of
squares, m² = (E1+E2)² - |p1+p2|², which magnifies those ulps wherever m
is small beside E, so m² agrees to ``2e-6`` times (E1+E2)² + |p1+p2|²,
the scale it is the difference of.
"""

import dataclasses
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402  (the sweep programs and inputs the card checks use)
from repro.data.codecs import (  # noqa: E402
    bitpack_decode,
    bitpack_encode,
    bitpack_raw_parts,
)
from repro.core import expr as jexpr  # noqa: E402
from repro.core.neardata import program_eval_np as jprogram_eval_np  # noqa: E402
from repro.kernels import basket_decode as jbd  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.predicate_eval import Group as JGroup  # noqa: E402
from repro.kernels.predicate_eval import Program as JProgram  # noqa: E402
from repro_torch.kernels import basket_decode as tbd  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.kernels import skim_fused as tsf  # noqa: E402
from repro_torch.core.expr import RPN_CONST, RPN_SUM  # noqa: E402
from repro_torch.kernels.program import (  # noqa: E402
    GROUP_DR,
    GROUP_EXPR,
    GROUP_MASS,
    program_from_fields,
)

RTOL_TRANSCENDENTAL = 2e-6


def _jax_program(program):
    """The JAX package's Program with the same fields."""
    groups, *rest = dataclasses.astuple(program)
    return JProgram(tuple(JGroup(*g) for g in groups), *rest)


# ---------------------------------------------------------------------------
# basket_decode
# ---------------------------------------------------------------------------


RNG = np.random.default_rng(11)


@pytest.mark.parametrize(
    "dtype,gen",
    [
        (np.int32, lambda n: RNG.integers(-3000, 3000, n).astype(np.int32)),
        # smooth floats take the raw bail-out (kind 3, passthrough)
        (np.float32, lambda n: (RNG.exponential(30, n) + 1).astype(np.float32)),
        # discrete floats xor-compress: the kind-1 path
        (np.float32, lambda n: RNG.choice(
            np.array([1.0, 1.25, 1.5, 1.75], np.float32), n)),
        (np.bool_, lambda n: RNG.random(n) < 0.2),
    ],
)
@pytest.mark.parametrize("sizes", [(64,), (100, 5000, 333), (4096, 4096)])
def test_basket_decode_sweep(dtype, gen, sizes):
    """The sweep of tests/test_kernels.py: exact against the source
    values, the host codec and the JAX package's device tier."""
    arrs = [gen(n) for n in sizes]
    blobs = [bitpack_encode(a) for a in arrs]
    parts = [bitpack_raw_parts(b) for b in blobs]
    got = tops.basket_decode_batch(parts, dtype, device="cpu")
    want = jops.basket_decode_batch(parts, dtype)
    for a, b, g, w in zip(arrs, blobs, got, want):
        assert g.dtype == a.dtype and g.tobytes() == a.tobytes()
        assert g.tobytes() == bitpack_decode(b, dtype).tobytes()
        assert g.tobytes() == np.asarray(w).astype(dtype).tobytes()


@pytest.mark.parametrize("kind", [0, 1, 2])
def test_basket_decode_matches_pallas_interpret(kind):
    """Random plane words of every width up to 32 (int sums wrap, xor
    results hit NaN and -0.0 patterns), ragged word counts."""
    rng = np.random.default_rng(kind)
    N, W = 3, 129
    widths = [1, 1, 1] if kind == 2 else [32, 17, 5]
    B = max(widths)
    planes = np.zeros((N, B, W), np.uint32)
    for i, w in enumerate(widths):
        planes[i, :w] = rng.integers(0, 1 << 32, (w, W), dtype=np.uint64)
    firsts = rng.integers(0, 1 << 32, N, dtype=np.uint64).astype(np.uint32)
    jdt = jnp.float32 if kind == 1 else jnp.int32
    tdt = torch.float32 if kind == 1 else torch.int32
    want = np.asarray(jbd.basket_decode(
        jnp.asarray(planes), jnp.asarray(firsts), kind=kind, n_bits=B,
        out_dtype=jdt, interpret=True,
    ))
    got = tbd.basket_decode(
        torch.from_numpy(planes.view(np.int32)), torch.from_numpy(firsts.view(np.int32)),
        kind=kind, n_bits=B, out_dtype=tdt,
    ).numpy()
    assert got.tobytes() == want.tobytes()


_I = np.iinfo(np.int32)


@pytest.mark.parametrize(
    "arr",
    [
        np.arange(1, dtype=np.int32),
        RNG.integers(-50, 50, 31).astype(np.int32),
        RNG.integers(-50, 50, 4095).astype(np.int32),
        RNG.integers(-50, 50, 4097).astype(np.int32),
        # uint32 prefix sums that wrap (deltas stay inside int32)
        np.array([-5, 10, -(1 << 30), (1 << 30) - 1, _I.max, -1] * 683, np.int32),
        # -0.0 and negative denormals through the xor path
        np.array([0x80000000, 0x80000001, 0x80000000, 0x80000003] * 1024,
                 np.uint32).view(np.float32),
        # NaN payloads
        (np.uint32(0x7FC00000) | RNG.integers(0, 1 << 16, 4097).astype(np.uint32)
         ).view(np.float32),
        RNG.random(4097) < 0.5,
    ],
    ids=["n1", "n31", "n4095", "n4097", "wrap", "neg-zero", "nan", "bool4097"],
)
def test_basket_decode_edges_bit_exact(arr):
    part = bitpack_raw_parts(bitpack_encode(arr))
    assert part["kind"] != 3
    (got,) = tops.basket_decode_batch([part], arr.dtype, device="cpu")
    assert got.tobytes() == arr.tobytes()
    bits, W = part["bits"], part["n_pad"] // 32
    planes = part["planes"].reshape(-1, W)[None, :bits]
    firsts = np.array([part["first"]], np.uint32)
    want = np.asarray(jbd.basket_decode(
        jnp.asarray(planes), jnp.asarray(firsts), kind=part["kind"], n_bits=bits,
        out_dtype=jnp.float32 if part["kind"] == 1 else jnp.int32, interpret=True,
    ))[0, : len(arr)]
    assert got.view(np.int32 if arr.dtype != np.bool_ else np.bool_).tobytes() == (
        want.astype(arr.dtype).tobytes()
    )


_DECODE_OUT = [(0, d) for d in ("int32", "int16", "int8", "uint8", "bool", "int64",
                                 "float32")] + [(1, "float32"), (1, "float64"),
                                                (2, "bool"), (2, "int8"), (2, "int32")]


@pytest.mark.parametrize("kind,name", _DECODE_OUT)
def test_basket_decode_store_width_is_the_plain_cast(kind, name):
    """What the CUDA kernel stores for each output type (``store_width``)
    equals the plain version's cast of the 32-bit result: the low bytes
    of the little-endian word, a bool byte ``!= 0``, or (None) the cast
    itself after a 32-bit store."""
    rng = np.random.default_rng(kind)
    B = 1 if kind == 2 else 20
    planes = torch.from_numpy(
        rng.integers(0, 1 << 32, (2, B, 8), dtype=np.uint64).astype(np.uint32).view(np.int32))
    firsts = torch.from_numpy(rng.integers(0, 1 << 32, 2, dtype=np.uint64)
                              .astype(np.uint32).view(np.int32))
    out_dtype = getattr(torch, name)
    want = tref.basket_decode_ref(planes, firsts, kind, 256, out_dtype)
    if kind == 1:  # the kernel's 32-bit word: a float's bits
        word = tref.basket_decode_ref(planes, firsts, kind, 256, torch.float32)
        word = word.view(torch.int32)
    else:
        word = tref.basket_decode_ref(planes, firsts, kind, 256, torch.int32)
    width = tbd.store_width(kind, out_dtype)
    if width is None:
        stored = tref.finish_decode(word, kind, out_dtype)
    else:
        nbytes, as_bool = width
        assert nbytes == out_dtype.itemsize
        low = word.view(torch.uint8).reshape(2, 256, 4)[..., :nbytes].contiguous()
        stored = (word != 0) if as_bool else low.view(out_dtype).reshape(2, 256)
    assert stored.dtype == want.dtype
    assert stored.view(torch.uint8).numpy().tobytes() == want.view(torch.uint8).numpy().tobytes()


def test_slot_sum_is_xla_slot_order():
    """The plain versions sum the K slots left to right, as XLA does on
    the CPU; torch.sum reduces in another order."""
    x = np.random.default_rng(5).normal(30, 40, (20_000, 32)).astype(np.float32)
    want = np.asarray(jnp.asarray(x).sum(axis=-1))
    got = tref.slot_sum(torch.from_numpy(x)).numpy()
    assert got.tobytes() == want.tobytes()


# ---------------------------------------------------------------------------
# skim_fused
# ---------------------------------------------------------------------------


def _skim_fused_program():
    """tests/test_skim_fused.py's program, built in the JAX package."""
    from repro.kernels.ref import GROUP_ANY, GROUP_COUNT, GROUP_HT, OP_IDS

    return JProgram(
        groups=(
            JGroup(GROUP_COUNT, (0, 1), (OP_IDS[">"], OP_IDS["abs<"]), (20.0, 25.0)),
            JGroup(GROUP_HT, (2,), (OP_IDS[">"],), (10.0,),
                   cmp_op=OP_IDS[">"], cmp_thr=100.0),
            JGroup(GROUP_ANY, (3,), (OP_IDS[">="],), (0.5,)),
        ),
        term_branches=("a", "b", "c", "d"),
        group_collections=("X", None, None),
        group_weights=(None, "w", None),
    )


@pytest.mark.parametrize("E,K,D", [(256, 4, 3), (1000, 8, 6), (2048, 1, 1)])
def test_skim_fused_matches_pallas_interpret(E, K, D):
    """tests/test_skim_fused.py's sweep: exact."""
    rng = np.random.default_rng(3)
    jprog = _skim_fused_program()
    prog = program_from_fields(dataclasses.astuple(jprog))
    terms = rng.normal(20, 15, (4, E, K)).astype(np.float32)
    valid = (rng.random((3, E, K)) < 0.4).astype(np.float32)
    weights = np.abs(rng.normal(30, 20, (3, E, K))).astype(np.float32)
    payload = rng.normal(size=(E, D)).astype(np.float32)
    # the port reads the ANY term (term 3, read by no other group) as
    # nonzero, as the staged evaluator reads it as bool; the JAX kernel's
    # compiled ``>= 0.5`` reads its 0/1 plane the same way
    as_bool = terms.copy()
    as_bool[3] = terms[3] != 0
    want, want_n = jops.skim_fused(as_bool, valid, weights, payload, jprog,
                                   interpret=True)
    got, n = tsf.skim_fused(*(torch.from_numpy(x) for x in
                              (terms, valid, weights, payload)), prog)
    assert int(n) == int(want_n)
    assert int(n) > 0 or K == 1  # at K=1 the HT cut rarely passes
    assert got.numpy().tobytes() == np.asarray(want).tobytes()


def _jax_mass_value(program, g, terms, valid):
    """The JAX oracle's float32 mass of group ``g`` (its own helpers) and
    the scale its square is the difference of."""
    grp = program.groups[g]
    ids = grp.term_ids
    same = program.group_collections[g] == program.group_collections2[g]
    va, vb = jref._unpack_validity(valid[g])
    half = len(ids) // 2
    oh1, oh2, _ = jref._pair_onehots(terms[ids[0]], va, terms[ids[half]], vb, same)
    px1, py1, pz1, e1 = jref._p4(*(jref._sel(terms[i], oh1) for i in ids[:4]))
    px2, py2, pz2, e2 = jref._p4(*(jref._sel(terms[i], oh2) for i in ids[4:]))
    se, sx, sy, sz = e1 + e2, px1 + px2, py1 + py2, pz1 + pz2
    m2 = se * se - sx * sx - sy * sy - sz * sz
    scale = se * se + sx * sx + sy * sy + sz * sz
    return np.asarray(jnp.sqrt(jnp.maximum(m2, 0.0))), np.asarray(scale, np.float64)


def _host_data(program, terms, valid):
    """The columnar data the host evaluator reads, rebuilt from padded
    inputs of ``chip_smoke.sweep_inputs``: a collection's objects are its
    valid slots in slot order, with their ``n<Coll>`` counts (a collection
    only ``sum()`` reads keeps all K slots: its padding is +0.0, which
    leaves a float64 sum as it is); a flat branch is slot 0."""
    slots = {}
    for g, grp in enumerate(program.groups):
        c1 = program.group_collections[g]
        if grp.kind in (GROUP_MASS, GROUP_DR):
            slots[c1] = np.remainder(valid[g], 2.0) >= 1.0
            slots[program.group_collections2[g]] = valid[g] >= 2.0
        elif c1 is not None:
            slots[c1] = valid[g] > 0
    summed = {int(arg) for grp in program.groups if grp.kind == GROUP_EXPR
              for op, arg in grp.rpn if op == RPN_SUM}
    data = {}
    for t, branch in enumerate(program.term_branches):
        coll = branch.split("_", 1)[0]
        if coll in slots or t in summed:
            keep = slots.get(coll, np.ones(terms[t].shape, bool))
            data[branch] = terms[t][keep]
            data[f"n{coll}"] = keep.sum(axis=1)
        else:
            data[branch] = terms[t][:, 0]
    return data


def _assert_masks_agree(program, terms, valid, got_mask, want_mask):
    """The port's mask (``got_mask``) against the JAX padded route's
    (``want_mask``): where they differ, the port decides as the JAX host
    evaluator and the JAX padded route does not; the port's mass and ΔR
    values are the host's bit for bit, the JAX route's float32 masses
    within the stated tolerance of them (see the module note)."""
    data = _host_data(program, terms, valid)
    host = jprogram_eval_np(data, _jax_program(program), terms.shape[1])
    diff = np.nonzero(got_mask != want_mask)[0]
    np.testing.assert_array_equal(got_mask[diff], host[diff])
    tt, tv = torch.from_numpy(terms), torch.from_numpy(valid)
    for g, grp in enumerate(program.groups):
        if grp.kind not in (GROUP_MASS, GROUP_DR):
            continue
        v_t, ok_t = (x.numpy() for x in tref.pair_group_value(program, g, tt, tv))
        pair = jexpr.leading_pair_mass if grp.kind == GROUP_MASS else jexpr.leading_delta_r
        v_h, ok_h = pair(data, program.group_collections[g], program.group_collections2[g])
        np.testing.assert_array_equal(ok_t, ok_h)
        assert v_t.dtype == np.float64
        assert v_t[ok_t].tobytes() == v_h[ok_h].tobytes()
        if grp.kind == GROUP_MASS:
            v_j, scale = _jax_mass_value(program, g, jnp.asarray(terms), jnp.asarray(valid))
            slack = RTOL_TRANSCENDENTAL * scale
            assert (np.abs(v_t ** 2 - np.float64(v_j) ** 2)[ok_t] <= slack[ok_t]).all()


SWEEP = {name: prog for name, prog in chip_smoke.sweep_programs()}


@pytest.mark.parametrize("name", sorted(SWEEP))
def test_skim_fused_group_kinds_match_pallas_interpret(name):
    """Every group kind and op through the JAX package's fused Pallas
    kernel (interpret mode) and the port's plain version."""
    prog = SWEEP[name]
    jprog = _jax_program(prog)
    E, K, D = 512, 4, 2
    host = chip_smoke.sweep_inputs(np.random.default_rng(7), prog, E, K, D)
    want, want_n = jops.skim_fused(*host, jprog, interpret=True)
    got, n = tsf.skim_fused(*(torch.from_numpy(x) for x in host), prog)
    want, got = np.asarray(want), got.numpy()
    if name == "empty":
        assert int(n) == 0
    if name == "full":
        assert int(n) == E
    if int(n) == int(want_n) and got.tobytes() == want.tobytes():
        return
    mask_t = np.zeros(E, bool)
    mask_t[got[: int(n), 0].astype(np.int64)] = True
    mask_j = np.zeros(E, bool)
    mask_j[want[: int(want_n), 0].astype(np.int64)] = True
    _assert_masks_agree(prog, host[0], host[1], mask_t, mask_j)


@pytest.mark.parametrize("K", [1, 16])
@pytest.mark.parametrize("name", sorted(SWEEP))
def test_predicate_mask_matches_jnp_oracle(name, K):
    """The plain predicate against the jnp oracle at a wider shape."""
    prog = SWEEP[name]
    terms, valid, weights, _ = chip_smoke.sweep_inputs(
        np.random.default_rng(K), prog, 4096, K, 1
    )
    want = np.asarray(jref.predicate_mask(
        _jax_program(prog), jnp.asarray(terms), jnp.asarray(valid),
        jnp.asarray(weights),
    ))
    got = tref.predicate_mask(
        prog, torch.from_numpy(terms), torch.from_numpy(valid),
        torch.from_numpy(weights),
    ).numpy()
    if K == 16 and name not in ("empty", "full", "expr"):
        assert 0 < want.sum() < len(want)
    _assert_masks_agree(prog, terms, valid, got, want)


def test_program_descriptor_layout():
    """The flattened program the CUDA kernel reads: one row per group,
    ops/thresholds aligned with the term ids, RPN operands split."""
    prog = SWEEP["expr"]
    ints, doubles, off = tsf.flatten_program(prog)
    grp = prog.groups[0]
    row = ints[off["groups"]: off["groups"] + 8].tolist()
    assert row == [grp.kind, 0, len(grp.term_ids), grp.min_count, grp.cmp_op,
                   1, 0, len(grp.rpn)]
    n = len(grp.rpn)
    assert ints[off["rpn_op"]: off["rpn_op"] + n].tolist() == [op for op, _ in grp.rpn]
    assert (ints.dtype, doubles.dtype) == (np.int32, np.float64)
    assert doubles[off["cmp_thrs"]] == grp.cmp_thr
    consts = doubles[off["rpn_const"]: off["rpn_const"] + n]
    assert consts.tolist() == [float(a) if op == RPN_CONST else 0.0 for op, a in grp.rpn]


def test_program_descriptor_cache_holds_only_live_programs():
    """Descriptors are cached by identity while the program lives: a
    second call returns the same arrays, and a collected program's entry
    goes, so compiling a query per run does not grow the cache."""
    import gc

    cpu = torch.device("cpu")
    before = len(tsf._DESCRIPTORS)
    for _ in range(20):
        prog = dataclasses.replace(SWEEP["expr"])
        first = tsf.program_descriptor(prog, cpu)
        assert tsf.program_descriptor(prog, cpu) is first
        assert len(tsf._DESCRIPTORS) <= before + 1
        del prog, first
        gc.collect()
    assert len(tsf._DESCRIPTORS) == before

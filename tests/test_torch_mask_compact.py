"""The dense predicate mask and the stream compaction, on the CPU.

``predicate_eval`` runs the cascade stage kernel's evaluator with a mask
epilogue on the card, and ``stream_compact`` is one single-pass launch
sharing the look-back and its workspace with ``skim_fused``.  On the CPU
the wrappers take their plain versions: these tests hold them against the
JAX package (the Pallas predicate in interpret mode, the compaction's
oracle ``ref.stream_compact_ref``) on inputs made from a numpy seed, and
check the Python the card path runs before its launch: the mask launch's
lanes, tile, copy mode and shared memory, and the workspace's epochs.

Tolerances: none; masks and packed rows are compared exactly.
"""

import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
for p in (ROOT, ROOT / "tests"):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))

import chip_smoke  # noqa: E402  (the programs and inputs the card checks use)
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import predicate_eval as tpe  # noqa: E402
from repro_torch.kernels import skim_fused as tsf  # noqa: E402
from repro_torch.kernels import stream_compact as tsc  # noqa: E402
from test_torch_kernels import SWEEP, _jax_program  # noqa: E402


def _bench_inputs(seed: int, E: int):
    """``benchmarks/bench_kernels.py``'s predicate inputs at E events, K = 8,
    as numpy: (program, terms (2, E, 8), valid (1, E, 8), weights (1, E, 8))."""
    program, *planes = chip_smoke.bench_predicate(np.random.default_rng(seed), E, "cpu")
    return program, *(x.numpy() for x in planes)


# ---------------------------------------------------------------------------
# predicate_eval against the Pallas kernel
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed,E", [(0, 4096 + 37), (1, 4096 + 37), (2, 1000), (3, 129)])
def test_predicate_eval_matches_pallas_at_the_bench_program(seed, E):
    """bench_kernels' COUNT group ``pt > 20 and |eta| < 2.4`` at K = 8,
    its E = 2^17 cut down to a ragged E: the port's mask equals the Pallas
    kernel's in interpret mode (which pads E to its tile)."""
    program, t, v, w = _bench_inputs(seed, E)
    want = np.asarray(jops.predicate_eval(t, v, w, _jax_program(program), interpret=True))
    got = tops.predicate_eval(t, v, w, program, device="cpu")
    assert got.dtype == torch.int32 and got.shape == (E,)
    np.testing.assert_array_equal(got.numpy(), want)
    assert 0 < int(got.sum()) < E


@pytest.mark.parametrize("name", ["count", "ht", "any", "expr", "empty", "full"])
def test_predicate_eval_batch_is_predicate_eval_per_window(name):
    """The batched mask equals the one-window mask of each window, at a
    ragged E (the kernel's mask epilogue stops at E)."""
    prog = SWEEP[name]
    host = chip_smoke.batch_inputs(np.random.default_rng(5), prog, 3, 300, 4, 128)
    t, v, w = (torch.from_numpy(x) for x in host[:3])
    batch = tpe.predicate_eval_batch(t, v, w, prog)
    assert batch.shape == (3, 300) and batch.dtype == torch.int32
    for b in range(3):
        assert torch.equal(batch[b], tpe.predicate_eval(t[b], v[b], w[b], prog))


# ---------------------------------------------------------------------------
# stream_compact against the JAX oracle
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype,D", [
    ("float32", 4), ("float32", 8), ("float32", 16), ("int32", 4),  # rows of 16k bytes
    ("float32", 1), ("float32", 3), ("int32", 5), ("uint8", 7),      # and of others
])
@pytest.mark.parametrize("mask_kind", ["bool", "int32"])
def test_stream_compact_matches_the_jax_oracle(dtype, D, mask_kind):
    """Rows whose width is a multiple of 16 bytes (the kernel moves them
    in 16-byte units) and rows whose width is not (element by element),
    a ragged E, bool and int32 masks: packed rows and count equal
    ``ref.stream_compact_ref`` of the JAX package, byte for byte."""
    rng = np.random.default_rng(D)
    E = 4096 + 37
    payload = (rng.normal(size=(E, D)) * 100).astype(dtype)
    keep = rng.random(E) < 0.3
    mask = keep if mask_kind == "bool" else np.where(keep, 7, 0).astype(np.int32)
    want, want_n = jref.stream_compact_ref(jnp.asarray(payload), jnp.asarray(mask))
    got, n = tops.stream_compact(payload, mask, device="cpu")
    assert n.dtype == torch.int32 and int(n) == int(want_n) == int(keep.sum())
    assert got.numpy().tobytes() == np.asarray(want).tobytes()


# ---------------------------------------------------------------------------
# the Python of the card path
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("K,want", [(1, 1), (4, 1), (8, 1), (9, 2), (16, 2), (64, 8),
                                    (512, 32)])
def test_mask_lanes_give_an_event_about_eight_slots_a_lane(K, want):
    assert tpe.mask_lanes(K) == want


def _plan(program, B, E, K, shift=0):
    """The mask launch's (tile, mode, shared bytes) for a dense batch held
    ``shift`` floats into its buffers."""
    T, G = program.n_terms, program.n_groups

    def planes(n):
        return torch.zeros(B * n * E * K + shift)[shift:].view(B, n, E, K)

    return tpe.mask_plan((planes(T), planes(G), planes(G)), (T * E * K, G * E * K), E, K,
                         program)[:3]


@pytest.mark.parametrize("E,K,shift,want", [
    (4096 + 37, 8, 0, (256, tpe.MODE_BULK, 32768)),  # ragged E, E*K % 4 == 0: bulk copies
    (1 << 20, 8, 0, (256, tpe.MODE_BULK, 32768)),
    (4097, 1, 0, (512, tpe.MODE_ASYNC4, 8192)),  # E*K % 4 != 0: a plane stride off 16 bytes
    (301, 3, 0, (512, tpe.MODE_ASYNC4, 24576)),
    (1000, 8, 1, (256, tpe.MODE_ASYNC4, 32768)),  # a buffer one float off 16 bytes
    (1, 4, 0, (512, tpe.MODE_BULK, 32768)),
])
def test_mask_launch_plan_at_ragged_e_and_misaligned_strides(E, K, shift, want):
    """bench_kernels' program (2 term planes and 1 group: 4 planes):
    the largest tile whose planes fit 48 KiB, at least 256 events for one
    lane an event; bulk copies only where every base, stride and plane is
    whole 16-byte units, which also makes the ragged last tile's slice
    whole units."""
    program, *_ = _bench_inputs(0, 1)
    assert _plan(program, 1, E, K, shift) == want


def test_mask_launch_reads_device_memory_past_the_shared_memory_limit():
    """At K = 512 even 32 events of the count program's 8 planes pass 200
    KiB: the launch reads its planes from device memory."""
    assert _plan(SWEEP["count"], 2, 40, 512) == (32, tpe.MODE_DIRECT, 0)


@pytest.mark.parametrize("name", ["any", "mass_pair", "dr_same", "expr"])
def test_mask_launch_reads_device_memory_for_groups_that_read_a_few_slots(name):
    """ANY, EXPR and pair groups read a slot or two of most planes: the
    mask launch reads them in place, where a COUNT or HT program at the
    same shape copies its tile."""
    assert _plan(SWEEP[name], 2, 4096, 8)[1:] == (tpe.MODE_DIRECT, 0)
    assert _plan(SWEEP["count"], 2, 4096, 8)[1] == tpe.MODE_BULK
    assert _plan(SWEEP["ht"], 2, 4096, 8)[1] == tpe.MODE_BULK


def test_stage_plan_copies_nothing_where_there_is_nothing_to_copy():
    assert tpe.stage_plan(0, 8, 1, True) == (512, tpe.MODE_DIRECT, 0)
    assert tpe.stage_plan(4, 0, 1, True) == (512, tpe.MODE_DIRECT, 0)


def test_one_workspace_hands_both_compactions_increasing_epochs():
    """``stream_compact`` takes its status words from the workspace that
    ``skim_fused`` uses: on one (device, stream) the two kernels' launches
    draw from one counter, so their epochs strictly increase whichever
    kernel launches; the status words grow and are never cleared between
    launches; another stream has its own workspace and epochs."""
    assert tsc.Workspace is tsf.Workspace
    device, stream, other = torch.device("cpu"), 1 << 40, (1 << 40) + 1
    tsf.Workspace._all.pop((device, stream), None)
    tsf.Workspace._all.pop((device, other), None)
    try:
        E = 1_000_000
        seen = []
        for kernel in ("skim_fused", "stream_compact", "stream_compact", "skim_fused"):
            if kernel == "skim_fused":  # a status word a 512-event tile, a ticket a window
                status, tickets, epoch = tsf.Workspace.reserve(
                    device, stream, 3 * -(-4096 // tsf.EVENT_TILE), 3)
            else:  # a status word a 2048-event tile, one ticket
                status, tickets, epoch = tsf.Workspace.reserve(
                    device, stream, -(-E // tsc.EVENT_TILE), 1)
            seen.append(epoch)
            status[:] = epoch  # what a launch leaves behind
        assert seen == sorted(seen) and len(set(seen)) == 4
        assert status.numel() >= -(-E // tsc.EVENT_TILE) and tickets.numel() >= 3
        status, _, epoch = tsf.Workspace.reserve(device, stream, 1, 1)
        assert epoch == seen[-1] + 1
        assert int(status.max()) == seen[-1]  # nothing cleared between launches
        assert tsf.Workspace.reserve(device, other, 1, 1)[2] == 1
    finally:
        tsf.Workspace._all.pop((device, stream), None)
        tsf.Workspace._all.pop((device, other), None)


def test_workspace_starts_its_epochs_again_at_the_limit():
    """Epochs live in 30 bits of a status word: at the limit the words are
    zeroed (so no old word reads as published) and the epochs restart."""
    device, stream = torch.device("cpu"), (1 << 40) + 2
    tsf.Workspace._all.pop((device, stream), None)
    try:
        status, _, _ = tsf.Workspace.reserve(device, stream, 8, 1)
        status[:] = 123
        tsf.Workspace._all[(device, stream)].epoch = tsf.EPOCH_LIMIT - 1
        status, _, epoch = tsf.Workspace.reserve(device, stream, 8, 1)
        assert epoch == 1 and not status.any()
    finally:
        tsf.Workspace._all.pop((device, stream), None)


def test_predicate_eval_rejects_what_the_kernel_does_not_take():
    """Shapes are checked against the program before the card is
    touched: the one-window check takes (T, E, K), the batch (B, T, E, K)."""
    prog = SWEEP["count"]
    T, G = prog.n_terms, prog.n_groups
    t, v = torch.zeros(T, 64, 4), torch.zeros(G, 64, 4)
    assert tpe._check_inputs("x", t, v, v, prog, window=True) == (1, T, 64, 4)
    assert tpe._check_inputs("x", t[None], v[None], v[None], prog) == (1, T, 64, 4)
    for args, window in (((t[None], v[None], v[None]), True), ((t, v, v), False),
                         ((t[:1], v, v), True), ((t, v[:, :32], v), True),
                         ((t.double(), v, v), True)):
        with pytest.raises(ValueError):
            tpe._check_inputs("x", *args, prog, window=window)

"""The port's mesh skim and its helpers against the JAX package's.

The counterparts of ``tests/test_neardata.py`` (``skim_mask`` against the
host evaluator, the K = 2 overflow case, ``compact_jnp``, the sharded
skim) run both packages on the same inputs, made from numpy seeds, plus
``predicate_eval_ref`` for every group kind.  Every comparison is exact
(bit for bit), except where ``predicate_eval_ref`` meets the JAX padded
route's float32 at a cut's edge: there it is held to the JAX host
evaluator bit for bit (``_assert_masks_agree`` of
``tests/test_torch_kernels.py``).

The sharded skim runs JAX once, in a subprocess with 8 host devices, and
the port in one subprocess per mesh: its ranks are spawned by
``torch.multiprocessing`` and meet over gloo through a ``FileStore``
under ``tmp_path``, so no network port is opened.  The ranks gather their
blocks through the group, and rank 0 writes the global arrays.
"""

import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from repro.core import parse_query as j_parse_query  # noqa: E402
from repro.core.neardata import build_padded_inputs as j_build  # noqa: E402
from repro.core.neardata import compact_jnp as j_compact  # noqa: E402
from repro.core.neardata import compile_query as j_compile  # noqa: E402
from repro.core.neardata import skim_mask as j_skim_mask  # noqa: E402
from repro.data.synth import make_nanoaod_like as j_make_store  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro_torch.core import eval_stage, parse_query  # noqa: E402
from repro_torch.core.neardata import (  # noqa: E402
    build_padded_inputs,
    compact_jnp,
    compile_query,
    skim_mask,
)
from repro_torch.data.synth import make_nanoaod_like  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from tests.test_query import QUERY  # noqa: E402
from tests.test_torch_kernels import (  # noqa: E402
    SWEEP,
    _assert_masks_agree,
    _jax_program,
)

import chip_smoke  # noqa: E402  (the sweep inputs)


def _read(store, q):
    data = {}
    for b in sorted(set(q.filter_branches()) | {"nJet", "nElectron"}):
        br = store.branches[b]
        data[b] = store.read_jagged(b)[0] if br.jagged else store.read_flat(b)
    return data


@pytest.fixture(scope="module")
def setup():
    """tests/test_neardata.py's store and query, in both packages."""
    kw = dict(n_hlt=8, basket_events=1024, seed=3)
    store = make_nanoaod_like(4000, device="cpu", **kw)
    j_store = j_make_store(4000, **kw)
    q, jq = parse_query(QUERY), j_parse_query(QUERY)
    data, j_data = _read(store, q), _read(j_store, jq)
    for b in j_data:
        assert np.asarray(data[b]).tobytes() == np.asarray(j_data[b]).tobytes(), b
    return store, q, data, j_store, jq, j_data


def _both(setup, K, **kw):
    store, q, data, j_store, jq, j_data = setup
    prog = compile_query(q)
    pb = build_padded_inputs(data, prog, store, K=K, device="cpu", **kw)
    jprog = j_compile(jq)
    jpb = j_build(j_data, jprog, j_store, K=K, **kw)
    return prog, pb, jprog, jpb


def test_skim_mask_matches_host_and_jax(setup):
    store, q, data, *_ = setup
    prog, pb, jprog, jpb = _both(setup, 16, payload_branches=["MET_pt"])
    want = np.ones(store.n_events, bool)
    for _, stage in q.stages():
        want &= eval_stage(stage, data, store.n_events)
    got = skim_mask(pb.terms, pb.valid, pb.weights, prog)
    assert got.dtype == torch.bool and got.device.type == "cpu"
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(j_skim_mask(jpb.terms, jpb.valid, jpb.weights, jprog)))
    # numpy inputs go to the card, which is not here
    host = [x.numpy() for x in (pb.terms, pb.valid, pb.weights)]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            skim_mask(*host, prog)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            compact_jnp(pb.payload.numpy(), got.numpy())


def test_padding_overflow_matches_jax(setup):
    """K smaller than the largest multiplicity changes only events with
    more than K objects, and both packages change the same ones."""
    _, _, data, *_ = setup
    masks = {}
    for K in (2, 16):
        prog, pb, jprog, jpb = _both(setup, K)
        got = skim_mask(pb.terms, pb.valid, pb.weights, prog).numpy()
        want = np.asarray(j_skim_mask(jpb.terms, jpb.valid, jpb.weights, jprog))
        np.testing.assert_array_equal(got, want)
        masks[K] = got
    overflow = (data["nJet"] > 2) | (data["nElectron"] > 2)
    np.testing.assert_array_equal(masks[16][~overflow], masks[2][~overflow])
    assert (masks[16] != masks[2]).any()


def test_compact_jnp_matches_jax(setup):
    _, _, data, *_ = setup
    prog, pb, jprog, jpb = _both(setup, 16, payload_branches=["MET_pt"])
    mask = skim_mask(pb.terms, pb.valid, pb.weights, prog)
    packed, count = compact_jnp(pb.payload, mask)
    j_packed, j_count = j_compact(
        jpb.payload, j_skim_mask(jpb.terms, jpb.valid, jpb.weights, jprog))
    assert count.dtype == torch.int32 and count.shape == ()
    assert int(count) == int(j_count) > 0
    assert packed.numpy().tobytes() == np.asarray(j_packed).tobytes()
    k = int(count)
    np.testing.assert_array_equal(packed[:k, 0].numpy(), data["MET_pt"][mask.numpy()])
    assert not packed[k:].any()
    # an int32 mask keeps the same rows
    again, n = compact_jnp(pb.payload, mask.to(torch.int32))
    assert int(n) == k and torch.equal(again, packed)


@pytest.mark.parametrize("name", sorted(SWEEP))
def test_predicate_eval_ref_matches_jax(name):
    prog = SWEEP[name]
    terms, valid, weights, _ = chip_smoke.sweep_inputs(
        np.random.default_rng(5), prog, 2048, 8, 1)
    want = np.asarray(jref.predicate_eval_ref(
        jnp.asarray(terms), jnp.asarray(valid), jnp.asarray(weights),
        _jax_program(prog)))
    t, v, w = (torch.from_numpy(x) for x in (terms, valid, weights))
    got = tref.predicate_eval_ref(t, v, w, prog)
    assert got.dtype == torch.bool and got.shape == (2048,)
    assert torch.equal(got, tref.predicate_mask(prog, t, v, w))
    if name not in ("empty", "full", "expr"):
        assert 0 < want.sum() < len(want)
    _assert_masks_agree(prog, terms, valid, got.numpy(), want)


# ---------------------------------------------------------------------------
# the sharded skim, across ranks
# ---------------------------------------------------------------------------

MESHES = {
    "2x2x2": ((2, 2, 2), ("pod", "data", "model")),
    "4": ((4,), ("data",)),
    "2x2": ((2, 2), ("data", "model")),
    "1": ((1,), ("data",)),
}

JAX_SCRIPT = r"""
import json, sys
import jax
import numpy as np
from jax.sharding import Mesh
from repro.core import parse_query
from repro.core.neardata import compile_query, sharded_skim

tmp = sys.argv[1]
meshes = json.loads(open(f"{tmp}/meshes.json").read())
prog = compile_query(parse_query(json.loads(open(f"{tmp}/query.json").read())))
x = np.load(f"{tmp}/inputs.npz")
out = {}
for key, (shape, names) in meshes.items():
    n = int(np.prod(shape))
    mesh = Mesh(np.array(jax.devices()[:n]).reshape(shape), tuple(names))
    with mesh:
        packed, mask, total = sharded_skim(mesh, prog)(
            x["terms"], x["valid"], x["weights"], x["payload"])
    out[f"packed_{key}"] = np.asarray(packed)
    out[f"mask_{key}"] = np.asarray(mask)
    out[f"total_{key}"] = np.asarray(total)
np.savez(f"{tmp}/jax.npz", **out)
print("JAX_OK")
"""

# the port's side: one process per rank, spawned, over gloo
PORT_SCRIPT = r"""
import json, os, sys
import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def rank_main(rank, n, tmp, key, shape, names):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(f"{tmp}/rdv_{key}", n),
                            rank=rank, world_size=n)
    try:
        from torch.distributed.device_mesh import init_device_mesh

        from repro_torch.core import parse_query
        from repro_torch.core.neardata import compile_query, sharded_skim

        mesh = init_device_mesh("cpu", tuple(shape), mesh_dim_names=tuple(names))
        prog = compile_query(parse_query(json.loads(open(f"{tmp}/query.json").read())))
        x = np.load(f"{tmp}/inputs.npz")
        arrays = [x[k] for k in ("terms", "valid", "weights", "payload")]
        fn = sharded_skim(mesh, prog)
        packed, mask, total = fn(*arrays)
        assert packed.device.type == "cpu" and total.dtype == torch.int32
        # this rank's shard: row-major over the data dimensions present
        shard = 0
        for d, a in enumerate(names):
            if a in ("pod", "data"):
                shard = shard * mesh.size(d) + mesh.get_local_rank(d)
        uneven = ""
        try:
            fn(*(a[:, :-1] for a in arrays[:3]), arrays[3][:-1])
        except ValueError as exc:
            uneven = str(exc)
        gathered = {}
        for name, t in (("packed", packed), ("mask", mask), ("total", total),
                        ("shard", torch.tensor(shard))):
            parts = [torch.empty_like(t) for _ in range(n)]
            dist.all_gather(parts, t.contiguous())
            gathered[name] = [p.numpy() for p in parts]
        if rank == 0:
            n_shards = len(set(int(s) for s in gathered["shard"]))
            first = {}
            replicas_equal = True
            for r, s in enumerate(gathered["shard"]):
                s = int(s)
                if s in first:
                    q = first[s]
                    replicas_equal &= (
                        gathered["packed"][r].tobytes() == gathered["packed"][q].tobytes()
                        and gathered["mask"][r].tobytes() == gathered["mask"][q].tobytes())
                else:
                    first[s] = r
            order = [first[s] for s in range(n_shards)]
            np.savez(f"{tmp}/port_{key}.npz",
                     packed=np.concatenate([gathered["packed"][r] for r in order]),
                     mask=np.concatenate([gathered["mask"][r] for r in order]),
                     totals=np.array([int(t) for t in gathered["total"]]),
                     n_shards=n_shards, replicas_equal=replicas_equal,
                     uneven=uneven)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    tmp, key = sys.argv[1], sys.argv[2]
    shape, names = json.loads(open(f"{tmp}/meshes.json").read())[key]
    mp.spawn(rank_main, args=(int(np.prod(shape)), tmp, key, shape, names),
             nprocs=int(np.prod(shape)), join=True)
    print("PORT_OK")
"""


def _env():
    return dict(os.environ, PYTHONPATH=f"{ROOT / 'src'}{os.pathsep}{ROOT}",
                JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1",
                XLA_FLAGS="--xla_force_host_platform_device_count=8")


@pytest.fixture(scope="module")
def mesh_runs(tmp_path_factory):
    """The sharded skim's inputs (tests/test_neardata.py's: 4096 events,
    seed 5, K = 16, payload MET_pt), JAX's outputs on every mesh, and a
    function that runs the port on one mesh (once; cached)."""
    tmp = tmp_path_factory.mktemp("mesh")
    j_store = j_make_store(4096, n_hlt=8, seed=5)
    jq = j_parse_query(QUERY)
    jprog = j_compile(jq)
    pb = j_build(_read(j_store, jq), jprog, j_store, K=16,
                 payload_branches=["MET_pt"], to_device=False)
    np.savez(tmp / "inputs.npz", terms=pb.terms, valid=pb.valid,
             weights=pb.weights, payload=pb.payload)
    (tmp / "query.json").write_text(json.dumps(QUERY))
    (tmp / "meshes.json").write_text(json.dumps(MESHES))
    (tmp / "port_mesh.py").write_text(PORT_SCRIPT)
    out = subprocess.run([sys.executable, "-c", JAX_SCRIPT, str(tmp)],
                         capture_output=True, text=True, cwd=str(ROOT),
                         env=_env(), timeout=300)
    assert "JAX_OK" in out.stdout, out.stderr[-3000:]
    want = dict(np.load(tmp / "jax.npz"))
    runs = {}

    def port(key):
        if key not in runs:
            out = subprocess.run(
                [sys.executable, str(tmp / "port_mesh.py"), str(tmp), key],
                capture_output=True, text=True, cwd=str(ROOT), env=_env(),
                timeout=300)
            assert "PORT_OK" in out.stdout, out.stderr[-3000:]
            runs[key] = dict(np.load(tmp / f"port_{key}.npz"))
        return runs[key]

    return pb, want, port


@pytest.mark.parametrize("key", list(MESHES))
def test_sharded_skim_matches_jax(mesh_runs, key):
    pb, want, port = mesh_runs
    got = port(key)
    shape, names = MESHES[key]
    n_shards = int(np.prod([s for s, a in zip(shape, names) if a in ("pod", "data")]))
    assert int(got["n_shards"]) == n_shards
    assert bool(got["replicas_equal"])
    assert got["packed"].shape == pb.payload.shape
    assert got["packed"].tobytes() == want[f"packed_{key}"].tobytes()
    assert got["mask"].dtype == np.int32
    assert got["mask"].tobytes() == want[f"mask_{key}"].astype(np.int32).tobytes()
    total = int(want[f"total_{key}"])
    assert (got["totals"] == total).all()
    assert 0 < total == int(got["mask"].sum())


@pytest.mark.parametrize("key", ["2x2x2", "4"])
def test_sharded_skim_refuses_uneven_shards(mesh_runs, key):
    """4095 events over 4 shards: a ValueError naming both, where JAX's
    ``shard_map`` refuses the shapes."""
    got = mesh_runs[2](key)
    msg = str(got["uneven"])
    assert "4095" in msg and "4 shards" in msg, msg


GUARD = textwrap.dedent(
    """
    import sys
    sys.modules["jax"] = None
    sys.modules["repro"] = None
    import numpy as np
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.core import parse_query
    from repro_torch.core.neardata import (
        build_padded_inputs, compact_jnp, compile_query, sharded_skim, skim_mask)
    from repro_torch.data.synth import make_nanoaod_like
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0, world_size=1)
    mesh = init_device_mesh("cpu", (1, 1, 1), mesh_dim_names=("pod", "data", "model"))
    store = make_nanoaod_like(2048, n_hlt=8, device="cpu")
    q = parse_query({"branches": ["MET_*"], "selection": {
        "object": [{"collection": "Electron",
                    "cuts": [{"var": "pt", "op": ">", "value": 20.0}]}],
        "event": [{"type": "cut", "branch": "MET_pt", "op": ">", "value": 15.0}]}})
    prog = compile_query(q)
    data = {b: (store.read_jagged(b)[0] if store.branches[b].jagged
                else store.read_flat(b)) for b in set(q.filter_branches()) | {"nElectron"}}
    pb = build_padded_inputs(data, prog, store, K=8, payload_branches=["MET_pt"],
                             include_index=True, to_device=False)
    packed, mask, total = sharded_skim(mesh, prog)(pb.terms, pb.valid, pb.weights,
                                                   pb.payload)
    t = [torch.from_numpy(x) for x in (pb.terms, pb.valid, pb.weights, pb.payload)]
    want = skim_mask(*t[:3], prog)
    want_packed, want_n = compact_jnp(t[3], want)
    assert torch.equal(mask, want.to(torch.int32))
    assert torch.equal(packed, want_packed) and int(total) == int(want_n) > 0
    dist.destroy_process_group()
    assert "jax" not in {m.split(".")[0] for m, v in sys.modules.items() if v}
    print("ok", int(total))
    """
)


def test_sharded_skim_runs_with_jax_and_the_jax_package_blocked():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, "-c", GUARD], capture_output=True,
                         text=True, timeout=120, env=env, cwd=str(ROOT))
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.startswith("ok ")

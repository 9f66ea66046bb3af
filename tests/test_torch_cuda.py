"""The port's CUDA kernels on the card, held against their plain versions.

This file imports neither JAX nor the JAX package, so it runs on a
machine that has only PyTorch and a card:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

The tests marked ``cuda`` skip without a card.  Every comparison is
exact: the kernels are built without fast math and without FMA
contraction, so they round as the plain versions' separate ops do.
"""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402  (the card checks and the queries)
from repro_torch.core import run_skim  # noqa: E402
from repro_torch.data.synth import make_nanoaod_like  # noqa: E402
from repro_torch.kernels import basket_decode as bd  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels import skim_fused as sf  # noqa: E402


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; the kernels run only there")
    return torch.device("cuda")


def test_cpu_tensors_take_the_plain_version_and_launch_nothing():
    prog = dict(chip_smoke.sweep_programs())["count"]
    host = chip_smoke.sweep_inputs(np.random.default_rng(1), prog, 512, 4, 2)
    t = [torch.from_numpy(x) for x in host]
    planes = torch.from_numpy(
        np.random.default_rng(2).integers(0, 1 << 31, (2, 3, 4)).astype(np.int32))
    firsts = torch.tensor([5, -7], dtype=torch.int32)
    ops.reset_launch_counts()
    got, n = sf.skim_fused(*t, prog)
    want, want_n = ref.skim_fused_ref(*t, prog)
    assert int(n) == int(want_n) and torch.equal(got, want)
    dec = bd.basket_decode(planes, firsts, kind=0, n_bits=3, out_dtype=torch.int32)
    assert torch.equal(dec, ref.basket_decode_ref(planes, firsts, 0, 128, torch.int32))
    assert ops.launch_counts() == {"skim_fused": 0, "basket_decode": 0}


@pytest.mark.cuda
def test_cuda_basket_decode_matches_plain(cuda_device):
    chip_smoke.check_basket_decode(np.random.default_rng(0), cuda_device)


@pytest.mark.cuda
def test_cuda_skim_fused_matches_plain(cuda_device):
    _, edge = chip_smoke.check_skim_fused(np.random.default_rng(0), cuda_device)
    assert edge == 0


@pytest.mark.cuda
def test_cuda_wrappers_reject_what_the_kernels_do_not_take(cuda_device):
    prog = dict(chip_smoke.sweep_programs())["count"]
    host = chip_smoke.sweep_inputs(np.random.default_rng(1), prog, 512, 4, 2)
    t = [torch.from_numpy(x).to(cuda_device) for x in host]
    with pytest.raises(ValueError):
        sf.skim_fused(t[0].double(), *t[1:], prog)
    with pytest.raises(ValueError):
        sf.skim_fused(t[0], t[1][:, :256], *t[2:], prog)
    planes = torch.zeros((1, 2, 4), dtype=torch.int64, device=cuda_device)
    firsts = torch.zeros(1, dtype=torch.int32, device=cuda_device)
    with pytest.raises(ValueError):
        bd.basket_decode(planes, firsts, kind=0, n_bits=2)


@pytest.mark.cuda
@pytest.mark.parametrize("qname", ["quickstart", "zee"])
def test_cuda_main_path_matches_the_host(cuda_device, qname):
    q = {"quickstart": chip_smoke.QUICKSTART_QUERY,
         "zee": chip_smoke.zee_query(20_000)}[qname]
    store = make_nanoaod_like(20_000, n_hlt=16, n_filler=4)
    host = make_nanoaod_like(20_000, n_hlt=16, n_filler=4, device="cpu")
    ops.reset_launch_counts()
    res = run_skim(store, q)
    launches = ops.launch_counts()
    want = run_skim(host, q, device="cpu")
    assert launches["skim_fused"] > 0 and launches["basket_decode"] > 0
    dec = store.decode_backend_stats()
    assert dec["backend"] == "device" and dec["device_baskets"] > 0
    assert dec["fallbacks"] == 0
    assert res.n_passed == want.n_passed > 0
    assert res.output._blobs == want.output._blobs
    assert chip_smoke.fetch_row(res.stats) == chip_smoke.fetch_row(want.stats)
    assert res.extras["cascade_stages"] == want.extras["cascade_stages"]

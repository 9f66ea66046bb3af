"""The port's transfer counters against the card's own trace.

This file imports neither JAX nor the JAX package:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_trace_card.py

A detailed skim's ``query`` span counts the host-to-device copies that
``torch.profiler`` sees on the card over the same skim (``Memcpy HtoD``
of every kind), and at least the bytes of every copy out of page-locked
staging memory, with its windows decoded on its own thread or in a
prefetch worker (``pipeline="threads"``).
"""

import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402  (the quickstart and Z->ee queries)
from repro_torch.core import SkimEngine  # noqa: E402
from repro_torch.data.synth import make_nanoaod_like  # noqa: E402
from repro_torch.obs.trace import Tracer  # noqa: E402

N = 200_000


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; the kernels run only there")
    return torch.device("cuda")


def _pinned_upload_bytes(monkeypatch) -> list:
    """Bytes of each copy from page-locked memory to the card, from here on."""
    seen, copy_ = [], torch.Tensor.copy_

    def counting_copy(self, src, *a, **k):
        if self.is_cuda and isinstance(src, torch.Tensor) and not src.is_cuda \
                and src.is_pinned():
            seen.append(src.numel() * src.element_size())
        return copy_(self, src, *a, **k)

    monkeypatch.setattr(torch.Tensor, "copy_", counting_copy)
    return seen


@pytest.mark.cuda
@pytest.mark.parametrize("pipeline", [True, "threads"])
@pytest.mark.parametrize("device_batch", [None, 4])
@pytest.mark.parametrize("qname", ["quickstart", "zee"])
def test_cuda_query_span_counts_the_profilers_copies(cuda_device, monkeypatch, qname,
                                                     device_batch, pipeline):
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    query = chip_smoke.QUICKSTART_QUERY if qname == "quickstart" else chip_smoke.zee_query(N)
    store = make_nanoaod_like(N, n_hlt=8, n_filler=2, device=cuda_device)
    engine = SkimEngine(store, device_batch=device_batch, device=cuda_device)
    engine.run(query, pipeline=pipeline)  # builds and loads the kernels outside the profile
    torch.cuda.synchronize()
    staged = _pinned_upload_bytes(monkeypatch)
    tracer = Tracer()
    prof = profile(activities=[ProfilerActivity.CUDA])
    with prof:
        res = engine.run(query, tracer=tracer, pipeline=pipeline)
        torch.cuda.synchronize()
    copies = sum(1 for ev in prof.profiler.kineto_results.events()
                 if ev.device_type() == DeviceType.CUDA and ev.name().startswith("Memcpy HtoD"))
    (q,) = [sp for sp in tracer.spans() if sp.kind == "query"]
    assert res.n_passed > 0 and staged
    assert q.attrs["h2d_copies"] == copies > 0
    assert q.attrs["h2d_bytes"] >= sum(staged)
    assert any(sp.kind == "device_wait" for sp in tracer.spans())

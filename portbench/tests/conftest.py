import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT), str(ROOT / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)

from portbench import manifest  # noqa: E402

CELLS = [w["name"] for w in manifest.load()["workloads"]]
# every (configuration, traffic mix) pair the reference is held to the port on
MIXES = sorted({(w["config"], w["traffic"]) for w in manifest.load()["workloads"]})


@pytest.fixture
def card():
    """The first CUDA card; skips the test where there is none."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda", 0)

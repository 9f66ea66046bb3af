"""Build and load the hand-written CUDA kernels.

Each ``csrc/*.cu`` file is compiled by ``nvcc`` into its own shared
library with a plain C interface and loaded with ``ctypes``: no PyTorch
headers, so a build takes seconds.  Libraries go to ``build/`` at the repo
root, named by a hash of the source, of every shared header
(``csrc/*.cuh``) and of the flags, so an edited source or header rebuilds
and an unchanged one loads from disk.  All missing libraries build at once, one ``nvcc`` per
source, started together.

Nothing here runs at import time: the CPU tests import every module, and
a machine without a card may have no ``nvcc`` at all.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

_CSRC = Path(__file__).resolve().parent.parent / "csrc"
SOURCES = {
    "skim_fused": "skim_fused.cu",
    "basket_decode": "basket_decode.cu",
    "predicate_eval": "predicate_eval.cu",
    "stream_compact": "stream_compact.cu",
    "flash_attention": "flash_attention.cu",
}

# sm_90a: the H100's own target.  No fast math (cosf/sinf/sinhf/coshf and
# sqrtf stay the full-precision functions) and no FMA contraction, so
# every float op rounds as the reference's separate ops do.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "--fmad=false", "-shared", "-Xcompiler", "-fPIC",
)

_LIBS: dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()


def build_dir() -> Path:
    return Path(__file__).resolve().parents[3] / "build"


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    path = Path(home) / "bin" / "nvcc"
    if path.exists():
        return str(path)
    raise RuntimeError(
        "nvcc not found (looked on PATH and in $CUDA_HOME/bin): the CUDA "
        "kernels cannot be built"
    )


def lib_path(name: str) -> Path:
    """The library of kernel ``name``, named by the digest of its source,
    of every header in ``csrc/`` (a source may include any of them) and
    of the flags."""
    h = hashlib.sha256((_CSRC / SOURCES[name]).read_bytes())
    for header in sorted(_CSRC.glob("*.cuh")):
        h.update(header.name.encode() + b"\0" + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return build_dir() / f"{name}-{h.hexdigest()[:16]}.so"


def build_all() -> float:
    """Compile every missing library, all ``nvcc`` runs in parallel.
    Returns the seconds spent (0.0 when everything was built already)."""
    with _LOCK:
        todo = [n for n in SOURCES if not lib_path(n).exists()]
        if not todo:
            return 0.0
        t0 = time.perf_counter()
        build_dir().mkdir(parents=True, exist_ok=True)
        nvcc = _nvcc()
        procs = []
        for name in todo:
            final = lib_path(name)
            tmp = final.with_suffix(f".{os.getpid()}.tmp")
            cmd = [nvcc, *NVCC_FLAGS, "-I", str(_CSRC), "-o", str(tmp),
                   str(_CSRC / SOURCES[name])]
            procs.append((name, final, tmp, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            )))
        failures = []
        for name, final, tmp, proc in procs:
            out, err = proc.communicate()
            if proc.returncode:
                failures.append(f"{SOURCES[name]}:\n{out}{err}")
            else:
                os.replace(tmp, final)
        if failures:
            raise RuntimeError("nvcc failed for " + "\n".join(failures))
        return time.perf_counter() - t0


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name`` (built on first use)."""
    lib = _LIBS.get(name)
    if lib is None:
        build_all()
        lib = ctypes.CDLL(str(lib_path(name)))
        _LIBS[name] = lib
    return lib


def ptr(tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(tensor.data_ptr())


def stream_of(device) -> ctypes.c_void_p:
    import torch

    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def check_launch(name: str, rc: int) -> None:
    if rc != 0:
        raise RuntimeError(f"{name}: kernel launch failed with CUDA error {rc}")

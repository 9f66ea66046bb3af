"""Host side of the kernel tier: staging, dispatch and accounting.

The engine's device path calls these entry points; each stages its
inputs, dispatches to a kernel wrapper (the CUDA kernel for a CUDA
tensor, the plain PyTorch version for a CPU tensor) and notes the
dispatch in the same ledger as the JAX package's ``kernels/ops.py``.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.kernels import basket_decode as _bd
from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import predicate_eval as _pe
from repro_torch.kernels import ref as _ref
from repro_torch.kernels import skim_fused as _sf
from repro_torch.kernels import stream_compact as _sc
from repro_torch.kernels.program import Program, compile_query  # re-export

# ---------------------------------------------------------------------------
# dispatch / compile accounting
#
# Every device entry point below notes one "dispatch" per real call and
# one "compile" per unique (entry, program, shape) signature — the same
# currency as the JAX package's ledger, so a run reports the same
# ``device_dispatches`` in both.  The kernels' own launch counters
# (``launch_counts``) are separate: they count launches of hand-written
# kernels only, and show that a run went through them.
# ---------------------------------------------------------------------------

_DISPATCH_STATS = {"dispatches": 0, "compiles": 0, "warmups": 0}
_SEEN_SIGNATURES: set = set()


def reset_dispatch_stats() -> None:
    _DISPATCH_STATS.update(dispatches=0, compiles=0, warmups=0)
    _SEEN_SIGNATURES.clear()


def dispatch_stats() -> dict:
    return dict(_DISPATCH_STATS)


def _note_dispatch(sig, warm: bool = False) -> None:
    if sig not in _SEEN_SIGNATURES:
        _SEEN_SIGNATURES.add(sig)
        _DISPATCH_STATS["compiles"] += 1
    if warm:
        _DISPATCH_STATS["warmups"] += 1
    else:
        _DISPATCH_STATS["dispatches"] += 1


def launch_counts() -> dict:
    """Launches of each hand-written kernel since the last reset."""
    return {**_sf.launches, "basket_decode": _bd.launches, **_pe.launches,
            "stream_compact": _sc.launches, "flash_attention": _fa.launches}


def reset_launch_counts() -> None:
    _bd.launches = 0
    _sc.launches = 0
    _fa.launches = 0
    for counts in (_sf.launches, _pe.launches):
        for name in counts:
            counts[name] = 0


def _tensors(device, *xs, dtype=None) -> list[torch.Tensor]:
    """The inputs of an entry point as tensors: a tensor stays on its own
    device; anything else (numpy, lists) goes to ``device``, which defaults
    to the card (:func:`repro_torch.device.resolve_device`: it raises when
    there is none, naming ``device="cpu"``)."""
    target = None
    out = []
    for x in xs:
        if not isinstance(x, torch.Tensor):
            if target is None:
                target = resolve_device(device)
            x = torch.from_numpy(np.ascontiguousarray(x)).to(target)
        out.append(x if dtype is None else x.to(dtype))
    return out


def load_kernels() -> None:
    """Build (on first use) and load every kernel library."""
    from repro_torch.kernels import _build

    for name in _build.SOURCES:
        _build.load(name)


# ---------------------------------------------------------------------------
# bit-packed survivor masks (host <-> device interchange format)
# ---------------------------------------------------------------------------


def pack_mask(mask: np.ndarray) -> np.ndarray:
    """Bool mask -> little-endian uint32 words over the last axis
    (bit ``j`` of word ``w`` is event ``w*32 + j``); pads to 32."""
    m = np.asarray(mask, dtype=np.uint8)
    pad = (-m.shape[-1]) % 32
    if pad:
        widths = [(0, 0)] * (m.ndim - 1) + [(0, pad)]
        m = np.pad(m, widths)
    packed = np.packbits(m, axis=-1, bitorder="little")
    return np.ascontiguousarray(packed).view("<u4")


def unpack_mask(words: np.ndarray, n: int) -> np.ndarray:
    """Inverse of :func:`pack_mask`: uint32 words -> (..., n) bool."""
    b = np.ascontiguousarray(words).view(np.uint8)
    bits = np.unpackbits(b, axis=-1, bitorder="little")
    return bits[..., :n].astype(bool)


# ---------------------------------------------------------------------------
# basket decode
# ---------------------------------------------------------------------------


def torch_dtype(dtype) -> torch.dtype:
    """numpy dtype -> the torch dtype of the same kind and width."""
    return torch.from_numpy(np.empty(0, dtype=np.dtype(dtype))).dtype


def stage_planes(parts_list) -> tuple[np.ndarray, np.ndarray, int]:
    """Plane words of same-kind ``bitpack_raw_parts`` dicts, padded to the
    batch maximum: (planes (N, B, W) uint32, firsts (N,) uint32, B)."""
    bits_max = max(p["bits"] for p in parts_list)
    w_max = max(p["n_pad"] // 32 for p in parts_list)
    planes = np.zeros((len(parts_list), bits_max, w_max), dtype=np.uint32)
    firsts = np.zeros((len(parts_list),), dtype=np.uint32)
    for i, p in enumerate(parts_list):
        pw = p["planes"].reshape(max(p["bits"], 1), -1)
        planes[i, : pw.shape[0], : pw.shape[1]] = pw
        firsts[i] = p["first"]
    return planes, firsts, bits_max


def basket_decode_batch(parts_list, out_dtype, device=None):
    """Decode a batch of ``bitpack_raw_parts`` dicts of the same kind.

    Pads plane counts and words to the batch maximum
    (:func:`stage_planes`), decodes the batch in one call on ``device`` —
    the CUDA kernel on the card, its plain version on the CPU — and
    returns a list of correctly sized numpy arrays, bit-identical to the
    host codec (``repro_torch.data.codecs.bitpack_decode``).  ``device``
    defaults to the card (:func:`repro_torch.device.resolve_device`: it
    raises when there is none, naming ``device="cpu"``).
    """
    device = resolve_device(device)
    kind = parts_list[0]["kind"]
    assert all(p["kind"] == kind for p in parts_list)
    if kind == 3:  # KIND_RAW_F32: literals — passthrough, nothing to decode
        return [p["raw"].astype(np.dtype(out_dtype)) for p in parts_list]
    planes, firsts, bits_max = stage_planes(parts_list)

    _note_dispatch(("decode", kind, planes.shape, device.type))
    out = _bd.basket_decode(
        torch.from_numpy(planes.view(np.int32)).to(device),
        torch.from_numpy(firsts.view(np.int32)).to(device),
        kind=kind,
        n_bits=bits_max,
        out_dtype=torch_dtype(out_dtype),
    )
    out = out.cpu().numpy()
    return [out[i, : p["n"]] for i, p in enumerate(parts_list)]


# ---------------------------------------------------------------------------
# the predicate alone
# ---------------------------------------------------------------------------


def predicate_eval(terms, valid, weights, program: Program,
                   device=None) -> torch.Tensor:
    """(T,E,K),(G,E,K),(G,E,K) float32 -> (E,) int32 mask, any E (the
    kernel masks its own ragged edge, so nothing is padded).  Tensors stay
    on their device; numpy inputs go to ``device`` (default: the card)."""
    return _pe.predicate_eval(
        *_tensors(device, terms, valid, weights, dtype=torch.float32), program
    )


# ---------------------------------------------------------------------------
# stream compaction
# ---------------------------------------------------------------------------


def stream_compact(payload, mask, device=None):
    """(E, D) payload, (E,) mask -> (packed (E, D) with the rows where
    ``mask`` is nonzero first, in order, then zeros; count () int32).
    Any E, no padding.  Tensors stay on their device; numpy inputs go to
    ``device`` (default: the card).  A numpy mask of another integer type
    than int32 is kept where nonzero."""
    payload, mask = _tensors(device, payload, mask)
    if mask.dtype not in _sc.MASK_DTYPES:
        mask = mask != 0
    return _sc.stream_compact(payload, mask)


# ---------------------------------------------------------------------------
# window-batched cascade stage (DESIGN.md §16)
# ---------------------------------------------------------------------------

CASCADE_BACKENDS = ("cuda", "torch", "host")


def _cascade_sig(program, shape, nb, backend):
    return ("cascade_stage", program, tuple(shape), int(nb), backend == "cuda")


def _stage_device(backend: str, device) -> torch.device:
    if backend not in CASCADE_BACKENDS:
        raise ValueError(f"unknown cascade backend {backend!r}")
    if backend == "host":
        return torch.device("cpu")
    device = torch.device(device)
    if backend == "cuda" and device.type != "cuda":
        raise ValueError("the 'cuda' cascade backend needs a CUDA device")
    return device


def _cascade_stage(terms, valid, weights, packed, seg_ids, program, nb, backend):
    stage = _pe.cascade_stage if backend == "cuda" else _pe.cascade_stage_plain
    return stage(terms, valid, weights, packed, seg_ids, program, nb)


def warm_cascade_stage(program: Program, shape, nb: int, backend="cuda",
                       device="cuda") -> bool:
    """Run the cascade step once on zeros for one shape bucket.

    Called by the executor OUTSIDE its stage timers on the first sight of
    a ``(program, batch shape)`` signature, so the library load and the
    first launch stay out of the measured ``filter`` time.  Returns True
    when a warm-up actually ran.
    """
    sig = _cascade_sig(program, shape, nb, backend)
    if sig in _SEEN_SIGNATURES:
        return False
    device = _stage_device(backend, device)
    Bn, T, E, K = shape
    G = program.n_groups

    def zeros(*s, dtype=torch.float32):
        return torch.zeros(s, dtype=dtype, device=device)

    _cascade_stage(
        zeros(Bn, T, E, K), zeros(Bn, G, E, K), zeros(Bn, G, E, K),
        zeros(Bn, E // 32, dtype=torch.int32), zeros(Bn, E, dtype=torch.int32),
        program, nb, backend,
    )
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    _note_dispatch(sig, warm=True)
    return True


def cascade_stage_step(terms, valid, weights, packed, seg_ids, program: Program,
                       nb: int, backend="cuda", device="cuda"):
    """The batched cascade stage: one device dispatch per (stage,
    window-batch).

    ``terms`` (B,T,E,K) and ``valid``/``weights`` (B,G,E,K) are host
    (numpy) staging buffers, each uploaded in one copy; ``packed``
    (B, E/32) int32 and ``seg_ids`` (B, E) int32 already live on the
    stage's device.  ``backend`` is ``"cuda"`` (the kernel), ``"torch"``
    (its plain version on ``device``) or ``"host"`` (the plain version on
    the CPU).  ``packed`` is updated in place.  Returns ``(packed, out)``
    with ``out`` (B, nb + 1) int32: basket bits, then each window's count
    (:func:`stage_summary_host` reads both in one copy).
    """
    device = _stage_device(backend, device)
    _note_dispatch(_cascade_sig(program, terms.shape, nb, backend))

    def up(x):
        return torch.as_tensor(x, dtype=torch.float32).to(device)

    return _cascade_stage(up(terms), up(valid), up(weights), packed, seg_ids,
                          program, nb, backend)


def stage_summary_host(out) -> tuple[np.ndarray, np.ndarray]:
    """One device-to-host copy of a stage's (B, nb + 1) buffer -> (basket
    bits (B, nb) bool, counts (B,) int64)."""
    host = out.cpu().numpy()
    return host[:, :-1].astype(bool), host[:, -1].astype(np.int64)


# ---------------------------------------------------------------------------
# the fused skim
# ---------------------------------------------------------------------------


def skim_fused(terms, valid, weights, payload, program: Program):
    """One-pass predicate + compaction through the kernel wrapper.
    Returns (packed (E, D) with survivors front-packed globally, count)."""
    return _sf.skim_fused(terms, valid, weights, payload, program)


def fused_skim(terms, valid, weights, payload, program: Program, use_kernel=True):
    """Backend-dispatched one-pass skim (the engine's device path).

    ``use_kernel`` routes to :func:`skim_fused` — the CUDA kernel for
    tensors on the card — otherwise to the plain PyTorch version over the
    same padded layout on the tensors' own device.  Returns (packed (E, D)
    survivors-first, count).
    """
    _note_dispatch(("fused", program, tuple(terms.shape), bool(use_kernel)))
    if use_kernel:
        return skim_fused(terms, valid, weights, payload, program)
    return _ref.skim_fused_ref(terms, valid, weights, payload, program)


def fused_skim_batch(terms, valid, weights, payload, program: Program,
                     use_kernel=True, device=None):
    """Window-batched one-pass skim: one dispatch for a batch of padded
    windows, terms (B,T,E,K), valid/weights (B,G,E,K), payload (B,E,D).
    Returns (packed (B,E,D) with each window's survivors front-packed,
    counts (B,)): per window bit-identical to :func:`fused_skim`.

    ``use_kernel`` routes to the CUDA kernel for tensors on the card (the
    plain version for CPU tensors), otherwise to the plain version on the
    tensors' own device.  Tensors stay on their device; numpy inputs go
    to ``device`` (default: the card).
    """
    terms, valid, weights = _tensors(device, terms, valid, weights,
                                     dtype=torch.float32)
    (payload,) = _tensors(device, payload)
    _note_dispatch(("fused_batch", program, tuple(terms.shape), bool(use_kernel)))
    if use_kernel:
        return _sf.skim_fused_batch(terms, valid, weights, payload, program)
    return _ref.skim_fused_batch_ref(terms, valid, weights, payload, program)


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------


def flash_attention(q, k, v, causal=True, sm_scale=None, device=None):
    """(B, H, S, D) float32 or bfloat16 attention, causal by default, the
    output in q's dtype.  Tensors stay on their device; numpy inputs go
    to ``device`` (default: the card)."""
    q, k, v = _tensors(device, q, k, v)
    return _fa.flash_attention(q, k, v, causal=causal, sm_scale=sm_scale)


__all__ = [
    "Program",
    "basket_decode_batch",
    "cascade_stage_step",
    "compile_query",
    "dispatch_stats",
    "flash_attention",
    "fused_skim",
    "fused_skim_batch",
    "launch_counts",
    "load_kernels",
    "pack_mask",
    "predicate_eval",
    "reset_dispatch_stats",
    "reset_launch_counts",
    "skim_fused",
    "stage_planes",
    "stage_summary_host",
    "stream_compact",
    "unpack_mask",
    "warm_cascade_stage",
]

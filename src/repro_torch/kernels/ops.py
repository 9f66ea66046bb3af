"""Host side of the kernel tier: staging, dispatch and accounting.

The engine's device path calls these entry points; each stages its
inputs, dispatches to a kernel wrapper (the CUDA kernel for a CUDA
tensor, the plain PyTorch version for a CPU tensor) and notes the
dispatch in the same ledger as the JAX package's ``kernels/ops.py``.

Host<->device copies and kernel launches are counted below the wrappers,
in ``_build`` (:func:`transfer_stats`, :func:`launch_counts`, re-exported
here), and the host side of each call is recorded into the tracer
active on the calling thread
(:func:`repro_torch.obs.trace.active`: ``pack``, ``launch``,
``device_wait`` and ``unpack`` spans), a no-op unless a detailed skim
is running there.
"""

from __future__ import annotations

import functools
import threading

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.kernels import _build
from repro_torch.kernels import basket_decode as _bd
from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import predicate_eval as _pe
from repro_torch.kernels import ref as _ref
from repro_torch.kernels import skim_fused as _sf
from repro_torch.kernels import stream_compact as _sc
from repro_torch.kernels._build import (  # re-export
    launch_counts,
    reset_launch_counts,
    reset_transfer_stats,
    to_device,
    to_host,
    transfer_stats,
)
from repro_torch.kernels.program import Program, compile_query  # re-export
from repro_torch.obs.trace import active as _active_tracer

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


# the numpy types JAX narrows when it reads an array with 64-bit types off
# (``jax_enable_x64``, off by default); every other type it keeps
_JAX_NARROWS = {np.dtype(np.float64): np.float32, np.dtype(np.int64): np.int32,
                np.dtype(np.uint64): np.uint32, np.dtype(np.complex128): np.complex64}


def _jax_numpy(x, dtype=None) -> np.ndarray:
    """A non-tensor input as ``jnp.asarray(x, dtype)`` reads it, as a
    contiguous numpy array: cast straight to ``dtype`` (a numpy type)
    where one is given, as numpy casts (a float truncates toward zero, an
    integer wraps); otherwise in its own type, with the 64-bit types
    narrowed to 32 bits, integers wrapping like a C cast
    (:data:`_JAX_NARROWS`)."""
    a = np.asarray(x, dtype)
    return np.ascontiguousarray(a, _JAX_NARROWS.get(a.dtype, a.dtype))


def _as_jax(x, dtype=None) -> torch.Tensor:
    """:func:`_jax_numpy` as a CPU tensor (numpy's bfloat16, from
    ``ml_dtypes``, by its bits)."""
    a = _jax_numpy(x, dtype)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def _numpy_as(t: torch.Tensor, dtype: np.dtype) -> np.ndarray:
    """A tensor's bytes on the host as a numpy array of ``dtype``, a type
    of the same width (one torch cannot hand to numpy included)."""
    return to_host(t.contiguous().view(torch.uint8)).view(dtype)


def _tensors(device, *xs, dtype=None) -> list[torch.Tensor]:
    """The inputs of an entry point as tensors: a tensor stays on its own
    device; anything else (numpy, lists) is read as JAX reads it
    (:func:`_as_jax`) and goes to ``device``, which defaults to the card
    (:func:`repro_torch.device.resolve_device`: it raises when there is
    none, naming ``device="cpu"``).  ``dtype`` (a type of :data:`_NP_OF`)
    casts every input, numpy straight from its own type as
    ``jnp.asarray(x, dtype)`` does."""
    target = None
    np_dtype = None if dtype is None else _NP_OF[dtype]
    out = []
    for x in xs:
        if not isinstance(x, torch.Tensor):
            if target is None:
                target = resolve_device(device)
            x = to_device(_as_jax(x, np_dtype), target)
        out.append(x if dtype is None else x.to(dtype))
    return out


def load_kernels() -> None:
    """Build (on first use) and load every kernel library."""
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


@functools.lru_cache(maxsize=None)
def torch_dtype(dtype) -> torch.dtype:
    """numpy dtype -> the torch dtype of the same kind and width."""
    dtype = np.dtype(dtype)
    if dtype.name == "bfloat16":  # ml_dtypes' type, which torch.from_numpy refuses
        return torch.bfloat16
    return torch.from_numpy(np.empty(0, dtype=dtype)).dtype


# torch dtype -> numpy dtype, for the types a decode round stores
_NP_OF = {torch.int32: np.int32, torch.int16: np.int16, torch.int8: np.int8,
          torch.uint8: np.uint8, torch.bool: np.bool_, torch.float32: np.float32}


def basket_decode_batch(parts_list, out_dtype, device=None):
    """Decode a list of ``bitpack_raw_parts`` dicts of one branch: a round
    of one branch (:func:`basket_decode_round`), so one launch for all of
    its kinds.  Returns a list of correctly sized numpy arrays,
    bit-identical to the host codec
    (``repro_torch.data.codecs.bitpack_decode``).  ``device`` defaults to
    the card (:func:`repro_torch.device.resolve_device`: it raises when
    there is none, naming ``device="cpu"``).
    """
    return basket_decode_round({"": parts_list}, {"": out_dtype}, device)[""]


def _lane_words(W: int) -> int:
    """Words per plane rounded up to 128 lanes: the JAX package's padded
    width, which its dispatch ledger compiles by."""
    return -(-W // 128) * 128


class _Staging(threading.local):
    """One thread's grow-only transfer buffers, by (device, name), its
    counted moves between them and its event on each device.  A buffer is
    reused only by its own thread, and only after that thread's last call
    waited on its event: each user below waits before it returns.  (The
    prefetcher decodes on its own thread while the consumer decodes and
    filters on its.)"""

    def __init__(self):
        self.buffers: dict = {}
        self.events: dict = {}

    def buffer(self, device, name: str, n: int, dtype, pinned: bool = False):
        """The first ``n`` elements of buffer ``name``: page-locked host
        memory when ``pinned``, else memory on ``device``."""
        buf = self.buffers.get((device, name))
        if buf is None or buf.numel() < n:
            size = 1 << max(n - 1, 1 << 13).bit_length()
            buf = (torch.empty(size, dtype=dtype, pin_memory=True) if pinned
                   else torch.empty(size, dtype=dtype, device=device))
            self.buffers[(device, name)] = buf
        return buf[:n]

    def upload(self, device, name: str, host: torch.Tensor) -> torch.Tensor:
        """``host`` (page-locked buffer ``name``) copied, ``non_blocking``
        and counted, into this thread's card buffer ``"<name>, card"``."""
        dev = self.buffer(device, f"{name}, card", host.numel(), host.dtype)
        dev.copy_(host, non_blocking=True)
        _build.note_copy("h2d", host.nbytes)
        return dev

    def readback(self, device, name: str, dev: torch.Tensor) -> torch.Tensor:
        """``dev`` copied, ``non_blocking`` and counted, into this thread's
        page-locked buffer ``name``; read it after :meth:`wait`."""
        host = self.buffer(device, name, dev.numel(), dev.dtype, pinned=True)
        host.copy_(dev, non_blocking=True)
        _build.note_copy("d2h", dev.nbytes)
        return host

    def wait(self, device) -> None:
        """Record this thread's event on the current stream; wait for it,
        under a ``device_wait`` span."""
        with _active_tracer().span("wait", kind="device_wait"):
            event = self.events.get(device)
            if event is None:
                event = self.events[device] = torch.cuda.Event()
            event.record(torch.cuda.current_stream(device))
            event.synchronize()


_STAGING = _Staging()


def plan_round(baskets) -> dict:
    """The flat layout of a decode round of ``(part, torch out dtype)``
    pairs (``bitpack_raw_parts`` dicts of kinds 0-2, n > 0): descriptors
    (N, 8) int32, firsts (N,) uint32, then each basket's planes at an odd
    stride (lane j of the kernel reads bank (j*stride + w) % 32: no
    conflicts), each block padded to 16 bytes; and each basket's output
    at a 16-byte aligned offset.  Returns a dict: ``descs``, ``firsts``,
    ``blocks`` (plane offset, W, stride, n_bits, words), ``stores``
    (output offset, stored torch dtype), ``base`` (first plane word),
    ``n_in`` (int32 words staged), ``out_bytes``."""
    N = len(baskets)
    descs = np.empty((N, _bd.DESC_FIELDS), np.int32)
    firsts = np.empty(N, np.uint32)
    blocks, stores = [], []
    p_words = o_bytes = 0
    for k, (p, tdt) in enumerate(baskets):
        kind, n = p["kind"], p["n"]
        if kind not in (_bd.KIND_INT, _bd.KIND_FLOAT, _bd.KIND_BOOL):
            raise ValueError(f"basket_decode: kind {kind} has no decode")
        W = p["n_pad"] // 32
        words = p["planes"]
        n_bits = min(p["bits"], words.size // W, 32)
        S = W | 1
        store = _bd.stored_dtype(kind, tdt)
        descs[k] = _bd.descriptor(p_words, W, S, n_bits, kind, o_bytes, tdt, n,
                                  padded=True)
        firsts[k] = p["first"]
        blocks.append((p_words, W, S, n_bits, words))
        stores.append((o_bytes, store))
        p_words += (n_bits * S + 3) & ~3
        o_bytes += (n * store.itemsize + 15) & ~15
    base = (9 * N + 3) & ~3
    return {"descs": descs, "firsts": firsts, "blocks": blocks, "stores": stores,
            "base": base, "n_in": base + p_words, "out_bytes": o_bytes}


def fill_round(staged: np.ndarray, layout: dict) -> None:
    """Write a round's :func:`plan_round` layout into ``staged`` (int32,
    at least ``n_in`` words)."""
    N, base = len(layout["descs"]), layout["base"]
    staged[: 8 * N] = layout["descs"].reshape(-1)
    staged[8 * N: 9 * N] = layout["firsts"].view(np.int32)
    for off, W, S, n_bits, words in layout["blocks"]:
        src = words[: n_bits * W].view(np.int32)
        if S == W:
            staged[base + off: base + off + n_bits * W] = src
        else:
            dst = staged[base + off: base + off + n_bits * S].reshape(n_bits, S)
            dst[:, :W] = src.reshape(n_bits, W)


def round_views(staged: torch.Tensor, layout: dict):
    """(descs, firsts, planes): views of a staged round tensor, as
    :func:`repro_torch.kernels.basket_decode.decode_round` takes them."""
    N = len(layout["descs"])
    return (staged[: 8 * N].view(N, _bd.DESC_FIELDS), staged[8 * N: 9 * N],
            staged[layout["base"]: layout["n_in"]])


def basket_decode_round(parts, dtypes, device=None) -> dict:
    """Decode one fetch round: every basket of every branch in one launch.

    Args:
      parts:  {branch: [``bitpack_raw_parts`` dict, ...]} — any kinds.
      dtypes: {branch: numpy dtype} — each branch's output type.
    Returns {branch: [numpy array, ...]} in the order given, bit-identical
    to the host codec.

    Empty baskets and raw literals (kind 3) never reach the device.  The
    rest is noted in the dispatch ledger once per (branch, kind) — the
    JAX package decodes each such group in one call and its ledger counts
    them so — but goes to the device together: one descriptor a basket,
    the firsts and every basket's planes packed into one page-locked
    buffer, one host-to-device copy, one launch of the round kernel
    (:func:`repro_torch.kernels.basket_decode.decode_round`), one copy of
    the packed outputs back into page-locked memory, and one wait on an
    event recorded after it (not a device-wide synchronize: the
    prefetcher decodes on another thread meanwhile).  Types the kernel
    does not store directly are converted on the host after the copy.
    On the CPU the round runs the same staging through the plain version.
    """
    device = resolve_device(device)
    tr = _active_tracer()
    with tr.span("round", kind="pack"):
        out, baskets = _round_baskets(parts, dtypes, device)
        if not baskets:
            return out
        layout = plan_round([(p, tdt) for _n, _i, p, tdt in baskets])
        n_in, o_bytes = layout["n_in"], layout["out_bytes"]
        on_card = device.type == "cuda"
        if on_card:
            host_in = _STAGING.buffer(device, "round in", n_in, torch.int32, pinned=True)
        else:
            host_in = torch.empty(n_in, dtype=torch.int32)
        fill_round(host_in.numpy(), layout)
    if on_card:
        with tr.span("round", kind="launch"):
            dev_in = _STAGING.upload(device, "round in", host_in)
            dev_out = _STAGING.buffer(device, "round out, card", o_bytes, torch.uint8)
            _bd.decode_round(*round_views(dev_in, layout), dev_out)
            host_out = _STAGING.readback(device, "round out", dev_out)
        _STAGING.wait(device)
    else:
        with tr.span("round", kind="launch"):
            host_out = torch.zeros(o_bytes, dtype=torch.uint8)
            _bd.decode_round(*round_views(host_in, layout), host_out)
    with tr.span("round", kind="unpack"):
        raw = host_out.numpy()
        for (name, i, p, tdt), (o, store) in zip(baskets, layout["stores"]):
            vals = np.frombuffer(raw, dtype=_NP_OF[store], count=p["n"], offset=o).copy()
            if store != tdt:
                vals = _ref.finish_decode(torch.from_numpy(vals), p["kind"], tdt).numpy()
            out[name][i] = vals
    return out


def _round_baskets(parts, dtypes, device) -> tuple[dict, list]:
    """A decode round's output lists, with the baskets that need no
    decode filled in, and the rest as ``(branch, index, part, torch
    output dtype)``, noted in the dispatch ledger once per (branch,
    kind)."""
    out = {name: [None] * len(ps) for name, ps in parts.items()}
    baskets = []
    for name, ps in parts.items():
        dtype = np.dtype(dtypes[name])
        kinds: dict[int, list[int]] = {}
        for i, p in enumerate(ps):
            if p["n"] == 0:
                out[name][i] = np.empty(0, dtype=dtype)
            elif p["kind"] == 3:  # KIND_RAW_F32: literals, nothing to decode
                out[name][i] = p["raw"].astype(dtype)
            else:
                kinds.setdefault(p["kind"], []).append(i)
        tdt = torch_dtype(dtype)
        for kind, idxs in sorted(kinds.items()):
            group = [ps[i] for i in idxs]
            shape = (len(group), max(p["bits"] for p in group),
                     _lane_words(max(p["n_pad"] // 32 for p in group)))
            _note_dispatch(("decode", kind, shape, device.type))
            baskets.extend((name, i, ps[i], tdt) for i in idxs)
    return out, baskets


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
    ``device`` (default: the card), read as the JAX package reads them:
    the payload by :func:`_as_jax` (float64 to float32, int64 to int32,
    ...), the mask as ``jnp.asarray(mask, jnp.int32)`` does (0.5 -> 0,
    2.7 -> 2, int64 2^32 -> 0) and put where the payload is.  A mask
    tensor of another type than bool or int32 is kept where nonzero."""
    (payload,) = _tensors(device, payload)
    if not isinstance(mask, torch.Tensor):
        mask = _as_jax(mask, np.int32).to(payload.device)
    elif mask.dtype not in _sc.MASK_DTYPES:
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


class CascadeInputs:
    """A cascade stage's inputs as the batched executor stages them: only
    the windows the stage runs, one buffer for :func:`cascade_stage_step_staged`
    to upload in one copy.

    ``shape`` is the dense batch the inputs stand for, (Bn, T, E, K);
    ``rows`` the batch row of each staged window (distinct, in [0, Bn)).
    The buffer holds the row table (int32, padded to 16 bytes), then each
    staged window's T term planes and its G valid and G weights planes,
    (E, K) float32 each: :attr:`planes` is its (S, T + 2G, E, K) numpy
    view, :meth:`window` one window's three parts.  The planes come
    uninitialised; the filler zeroes what it does not write.  For a stage
    on the card the buffer is this thread's page-locked staging buffer,
    so it stays valid until this thread's next ``CascadeInputs`` on that
    device: stage, then step, in one thread (as the executor does).
    """

    def __init__(self, shape, n_groups: int, rows, device=None):
        Bn, T, E, K = (int(x) for x in shape)
        self.shape = (Bn, T, E, K)
        self.n_groups = G = int(n_groups)
        self.rows = np.asarray(rows, np.int32).reshape(-1)
        S = len(self.rows)
        if len(set(self.rows.tolist())) != S or (S and not (
                0 <= self.rows.min() and self.rows.max() < Bn)):
            raise ValueError(f"staged rows {self.rows.tolist()} are not distinct "
                             f"rows of a batch of {Bn}")
        self.head = (S + 3) & ~3  # the row table, padded to 16 bytes
        n = self.head + S * (T + 2 * G) * E * K
        device = torch.device("cpu" if device is None else device)
        if device.type == "cuda":
            self.host = _STAGING.buffer(device, "cascade in", n, torch.int32, pinned=True)
        else:
            self.host = torch.empty(n, dtype=torch.int32)
        raw = self.host.numpy()
        raw[:S] = self.rows
        self.planes = raw[self.head:].view(np.float32).reshape(S, T + 2 * G, E, K)

    @property
    def nbytes(self) -> int:
        """Bytes one upload moves: the row table and the staged planes."""
        return 4 * self.host.numel()

    def window(self, s: int):
        """Staged window ``s``'s (terms (T,E,K), valid (G,E,K), weights
        (G,E,K)) views into the buffer."""
        T, G = self.shape[1], self.n_groups
        w = self.planes[s]
        return w[:T], w[T:T + G], w[T + G:]

    def views(self, buf: torch.Tensor):
        """(planes (S, T+2G, E, K) float32, rows (S,) int32) of ``buf``,
        this staging's buffer or its copy on a device."""
        S = len(self.rows)
        planes = buf[self.head:].view(torch.float32).view(self.planes.shape)
        return planes, buf[:S]


def _stage_windows(backend: str):
    """The stage over staged windows: the kernel for ``"cuda"``, the plain
    version for the other backends."""
    return (_pe.cascade_stage_windows if backend == "cuda"
            else _pe.cascade_stage_windows_plain)


def warm_cascade_stage(program: Program, shape, nb: int, backend="cuda",
                       device="cuda", kinds=None) -> bool:
    """Run the cascade step once for one shape bucket, on one staged
    window of zeros with no live event.

    Called by the executor OUTSIDE its stage timers before every stage
    step; it runs on the first sight of a ``(program, batch shape)``
    signature, so the library load and the first launch stay out of the
    measured ``filter`` time.  On the card it also puts the program's
    descriptors there (with the plane ``kinds`` the step will pass), on
    every call (a stage of a new plan may share a signature seen before),
    so the step's one upload is its inputs'.
    Returns True when a warm-up actually ran.
    """
    device = _stage_device(backend, device)
    if backend == "cuda":
        index = torch.cuda.current_device() if device.index is None else device.index
        _sf.program_descriptor(program, torch.device("cuda", index), kinds)
    sig = _cascade_sig(program, shape, nb, backend)
    if sig in _SEEN_SIGNATURES:
        return False
    Bn, T, E, K = shape
    G = program.n_groups

    def zeros(*s, dtype=torch.float32):
        return torch.zeros(s, dtype=dtype, device=device)

    _stage_windows(backend)(
        zeros(1, T + 2 * G, E, K), zeros(1, dtype=torch.int32),
        zeros(Bn, E // 32, dtype=torch.int32), zeros(Bn, E, dtype=torch.int32),
        program, nb, kinds=kinds,
    )
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    _note_dispatch(sig, warm=True)
    return True


def cascade_stage_step(terms, valid, weights, packed, seg_ids, program: Program,
                       nb: int, backend=None, device=None):
    """The batched cascade stage in the JAX package's form: one device
    dispatch per (stage, window-batch), every window of the batch staged.

    ``terms`` (B,T,E,K) and ``valid``/``weights`` (B,G,E,K) float32,
    ``packed`` (B, E/32) mask words (uint32 or int32) and ``seg_ids`` (B,
    E) int32, numpy or tensors.  ``device`` (default: the card, raising
    when there is none) and ``backend`` (default ``"cuda"`` on the card,
    ``"host"`` with ``device="cpu"``) say where and how the stage runs, as
    for :func:`cascade_stage_step_staged`; tensors must already be there.
    numpy inputs are staged into a :class:`CascadeInputs` and go up in one
    copy; tensors are read where they are
    (:func:`repro_torch.kernels.predicate_eval.cascade_stage`, the same
    kernel).  A ``packed`` tensor is updated in place, as the JAX package's
    donated buffer is consumed: keep only the returned mask.  A numpy
    ``packed`` is copied.

    Returns ``(packed (B, E/32) int32, basket_alive (B, nb) int32, counts
    (B,) int32)``, the last two views of the one (B, nb + 1) summary
    buffer.  The dispatch ledger notes one dispatch of ``terms.shape``.
    """
    device = resolve_device(device)
    if backend is None:
        backend = "cuda" if device.type == "cuda" else "host"
    device = _stage_device(backend, device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    B, T, E, K = np.shape(terms)
    G = program.n_groups
    groups = (B, G, E, K)
    if T != program.n_terms or {tuple(np.shape(valid)), tuple(np.shape(weights))} != {groups}:
        raise ValueError(
            f"cascade_stage_step: terms {tuple(np.shape(terms))}, valid "
            f"{tuple(np.shape(valid))} and weights {tuple(np.shape(weights))} do not "
            f"match a program of {program.n_terms} terms and {G} groups")
    if not isinstance(packed, torch.Tensor):
        packed = to_device(np.array(packed, np.uint32).view(np.int32), device)
    if not isinstance(seg_ids, torch.Tensor):
        seg_ids = to_device(np.ascontiguousarray(seg_ids, np.int32), device)
    arrays = (terms, valid, weights)
    if any(isinstance(x, torch.Tensor) and x.device != device
           for x in (*arrays, packed, seg_ids)):
        raise ValueError(f"cascade_stage_step: tensors must be on {device}")
    if isinstance(terms, torch.Tensor):
        _note_dispatch(_cascade_sig(program, terms.shape, nb, backend))
        stage = _pe.cascade_stage if backend == "cuda" else _pe.cascade_stage_plain
        packed, out = stage(*arrays, packed, seg_ids, program, nb)
    else:
        inputs = CascadeInputs((B, T, E, K), G, range(B), device)
        inputs.planes[:, :T], inputs.planes[:, T:T + G], inputs.planes[:, T + G:] = arrays
        packed, out = cascade_stage_step_staged(inputs, packed, seg_ids, program, nb,
                                                backend=backend, device=device)
    return packed, out[:, :nb], out[:, nb]


def cascade_stage_step_staged(inputs: CascadeInputs, packed, seg_ids,
                              program: Program, nb: int, backend="cuda",
                              device="cuda", kinds=None):
    """The batched cascade stage: one device dispatch per (stage,
    window-batch), over the windows ``inputs`` stages.

    ``packed`` (Bn, E/32) int32 and ``seg_ids`` (Bn, E) int32 already live
    on the stage's device.  On the card the staged buffer goes up in one
    copy (page-locked memory, ``non_blocking``); then ``backend``
    ``"cuda"`` launches the kernel over the staged windows only
    (:func:`repro_torch.kernels.predicate_eval.cascade_stage_windows`),
    ``"torch"`` runs its plain version on ``device``, and ``"host"`` the
    plain version on the CPU.  ``packed`` is updated in place; rows not
    staged keep their words.  Returns ``(packed, out)`` with ``out`` (Bn, nb
    + 1) int32: basket bits, then each window's count, zeros for rows not
    staged (:func:`stage_summary_host` reads both in one copy).  The
    dispatch ledger notes the dense batch's shape, as the JAX package
    does, whatever number of windows is staged.  ``kinds`` are the planes'
    kinds (``repro_torch.core.neardata.program_kinds``; None: float32).
    """
    device = _stage_device(backend, device)
    _note_dispatch(_cascade_sig(program, inputs.shape, nb, backend))
    stage = _stage_windows(backend)
    tr = _active_tracer()
    if device.type != "cuda":
        with tr.span("stage", kind="launch"):
            return stage(*inputs.views(inputs.host), packed, seg_ids, program, nb,
                         kinds=kinds)
    with tr.span("stage", kind="launch"):
        dev = _STAGING.upload(device, "cascade in", inputs.host)
        result = stage(*inputs.views(dev), packed, seg_ids, program, nb, kinds=kinds)
    _STAGING.wait(device)  # the staging buffer is free for this thread again
    return result


def stage_summary_host(out) -> tuple[np.ndarray, np.ndarray]:
    """One device-to-host copy of a stage's (B, nb + 1) buffer -> (basket
    bits (B, nb) bool, counts (B,) int64)."""
    host = to_host(out)
    with _active_tracer().span("stage summary", kind="unpack"):
        return host[:, :-1].astype(bool), host[:, -1].astype(np.int64)


# ---------------------------------------------------------------------------
# the fused skim
# ---------------------------------------------------------------------------


def skim_fused(terms, valid, weights, payload, program: Program, device=None):
    """One-pass predicate + compaction through the kernel wrapper.
    Returns (packed (E, D) with survivors front-packed globally, count).
    Tensors stay on their device; numpy inputs go to ``device`` (default:
    the card), ``terms``/``valid``/``weights`` as float32 and the payload
    in its own type as JAX reads it (:func:`_as_jax`)."""
    terms, valid, weights = _tensors(device, terms, valid, weights,
                                     dtype=torch.float32)
    (payload,) = _tensors(device, payload)
    return _sf.skim_fused(terms, valid, weights, payload, program)


def fused_skim(terms, valid, weights, payload, program: Program, use_kernel=True,
               device=None, kinds=None):
    """Backend-dispatched one-pass skim (the engine's per-window path).

    ``terms`` (T,E,K), ``valid``/``weights`` (G,E,K) float32, ``payload``
    (E,D) of any type of 1, 2, 4 or 8 bytes, returned in its own type.
    ``use_kernel`` routes to :func:`skim_fused` — the CUDA kernel for
    tensors on the card — otherwise to the plain PyTorch version over the
    same padded layout on the tensors' own device.  Returns (packed (E, D)
    survivors-first, count).

    Tensors stay on their device and give tensors there.  numpy arrays
    (the engine's inputs) go to ``device`` (default: the card), read as
    the JAX package reads them (the payload by :func:`_as_jax`), and give
    (packed numpy (E, D), count int): on the card the kernel's inputs are
    packed into one page-locked buffer and uploaded by one copy, and its
    counts and packed rows come back by one copy into page-locked memory
    and one event wait.

    ``kinds`` (the engine's route: ``repro_torch.core.neardata.
    program_kinds``) says which planes hold an integer branch's int32
    bits; None reads every plane as float32.
    """
    _note_dispatch(("fused", program, tuple(terms.shape), bool(use_kernel)))
    skim = _sf.skim_fused if use_kernel else _ref.skim_fused_ref
    if isinstance(terms, torch.Tensor):
        return skim(terms, valid, weights, payload, program, kinds=kinds)
    device = resolve_device(device)
    if use_kernel and device.type == "cuda":
        return _skim_staged(terms, valid, weights, payload, program, device, kinds)
    payload = _jax_numpy(payload)
    with _active_tracer().span("skim", kind="launch"):
        packed, count = skim(
            *_tensors(device, terms, valid, weights, dtype=torch.float32),
            *_tensors(device, payload), program, kinds=kinds)
    return _numpy_as(packed, payload.dtype), int(to_host(count.reshape(1))[0])


def _skim_staged(terms, valid, weights, payload, program: Program,
                 device, kinds=None) -> tuple[np.ndarray, int]:
    """:func:`fused_skim` of numpy arrays by the kernel: one upload, one
    launch, one readback.  The staged buffer holds terms, valid and
    weights as float32, then the payload's bytes from a 16-byte boundary;
    the rows come back as the payload's bytes and are read in its type."""
    tr = _active_tracer()
    with tr.span("skim", kind="pack"):
        planes = [np.asarray(a, np.float32) for a in (terms, valid, weights)]
        payload = _jax_numpy(payload)
        E, D = payload.shape
        sizes = [a.size for a in planes]
        p_off = (sum(sizes) + 3) & ~3  # int32 words before the payload
        n_in = p_off + (payload.nbytes + 3) // 4
        hdr = _sf.header_words(1)
        host_in = _STAGING.buffer(device, "skim in", n_in, torch.int32, pinned=True)
        staged = host_in.numpy()
        views, o = [], 0
        for a, n in zip(planes, sizes):
            staged[o: o + n] = a.reshape(-1).view(np.int32)  # bits: integer planes too
            views.append((o, n, a.shape))
            o += n
        staged.view(np.uint8)[4 * p_off: 4 * p_off + payload.nbytes] = (
            payload.reshape(-1).view(np.uint8))
    with tr.span("skim", kind="launch"):
        dev_in = _STAGING.upload(device, "skim in", host_in)
        t, v, w = (dev_in[o: o + n].view(torch.float32).view(shape)[None]
                   for o, n, shape in views)
        pl = _sf.view_rows(dev_in[p_off:], 1, E, D, torch_dtype(payload.dtype))
        buf = _sf.launch("skim_fused", t, v, w, pl, program, kinds)
        host = _STAGING.readback(device, "skim out", buf)
    _STAGING.wait(device)
    with tr.span("skim", kind="unpack"):
        raw = host.numpy()
        rows = raw[hdr:].view(np.uint8)[: payload.nbytes].view(payload.dtype)
        return rows.reshape(E, D).copy(), int(raw[0])


def fused_skim_batch(terms, valid, weights, payload, program: Program,
                     use_kernel=True, device=None):
    """Window-batched one-pass skim: one dispatch for a batch of padded
    windows, terms (B,T,E,K), valid/weights (B,G,E,K) float32, payload
    (B,E,D) of any type of 1, 2, 4 or 8 bytes, returned in its own type.
    Returns (packed (B,E,D) with each window's survivors front-packed,
    counts (B,)): per window bit-identical to :func:`fused_skim`.

    ``use_kernel`` routes to the CUDA kernel for tensors on the card (the
    plain version for CPU tensors), otherwise to the plain version on the
    tensors' own device.  Tensors stay on their device; numpy inputs go
    to ``device`` (default: the card), the payload read as JAX reads it
    (:func:`_as_jax`).
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
    """(B, H, S, D) attention in float32, bfloat16 or float16, any S and
    D, causal by default, the output in q's dtype.  Tensors stay on their
    device; numpy inputs go to ``device`` (default: the card), read as
    JAX reads them (:func:`_as_jax`: float64 becomes float32)."""
    q, k, v = _tensors(device, q, k, v)
    return _fa.flash_attention(q, k, v, causal=causal, sm_scale=sm_scale)


__all__ = [
    "CascadeInputs",
    "Program",
    "basket_decode_batch",
    "basket_decode_round",
    "cascade_stage_step",
    "cascade_stage_step_staged",
    "compile_query",
    "dispatch_stats",
    "flash_attention",
    "fused_skim",
    "fused_skim_batch",
    "fill_round",
    "launch_counts",
    "load_kernels",
    "pack_mask",
    "plan_round",
    "predicate_eval",
    "reset_dispatch_stats",
    "reset_launch_counts",
    "reset_transfer_stats",
    "round_views",
    "skim_fused",
    "stage_summary_host",
    "stream_compact",
    "to_device",
    "to_host",
    "transfer_stats",
    "unpack_mask",
    "warm_cascade_stage",
]

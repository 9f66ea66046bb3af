"""Basket codecs.

The paper's storage layer compresses ROOT baskets with LZMA (small, slow) or
LZ4 (larger, fast) and offloads decompression to the BlueField-3 engine.

Accelerator adaptation (DESIGN.md §2/§7): LZ4's byte-granular
match-copy loop is serial and does not map onto wide vector hardware.
We keep the *role* of each codec:

  - ``zlib``    : the LZMA stand-in — high ratio, expensive CPU decode.
  - ``bitpack`` : the LZ4/DPU-engine stand-in — a zigzag-delta /
                  xor-transpose bit-plane codec whose decode is pure vector
                  arithmetic, implemented both in numpy (host) and as a
                  CUDA kernel (``repro_torch.kernels.basket_decode``).
  - ``raw``     : identity (uncompressed baseline).

Bit-plane layout (``bitpack``)
------------------------------
Values are transformed to unsigned 32-bit "codes":

  * integers  : ``zigzag(delta(v))``  — first value stored relative to 0.
  * floats    : ``bitcast_u32(v) XOR bitcast_u32(v_prev)`` — exponent/sign
                bits of consecutive physics values repeat, so the xor stream
                has many leading zeros.
  * bools     : the 0/1 value itself (b == 1 plane).

With ``b = max bit-width`` of the codes, the basket stores ``b`` bit-planes,
each ``ceil(n/32)`` uint32 words: plane ``j`` holds bit ``j`` of every code.
Decoding plane words is a fully vectorized broadcast+shift — no gathers, no
byte shuffles — one warp rebuilds the 32 codes of one word.

Header per basket (little-endian uint32s):
  [0] magic, [1] kind (0=int delta, 1=float xor, 2=bool), [2] n values,
  [3] bit width b, [4] n padded values, [5] first raw value (bitcast).
"""

from __future__ import annotations

import struct
import zlib as _zlib

import numpy as np

_MAGIC = 0x534B4D52  # "SKMR"

KIND_INT = 0
KIND_FLOAT = 1
KIND_BOOL = 2
KIND_RAW_F32 = 3  # incompressible floats stored verbatim (LZ4-style bail-out)

# xor codes needing more than this many bit-planes don't compress enough to
# pay for the unpack — store raw instead, exactly like LZ4 emits literals
# for incompressible input.  Decode of raw mode is a memcpy.
_RAW_BAILOUT_BITS = 24

_HEADER_WORDS = 6
_HEADER = struct.Struct("<6I")


def _zigzag_encode(v: np.ndarray) -> np.ndarray:
    v = v.astype(np.int64)
    return ((v << 1) ^ (v >> 63)).astype(np.uint64).astype(np.uint32)


def _zigzag_decode(u: np.ndarray) -> np.ndarray:
    u = u.astype(np.uint64)
    return ((u >> 1) ^ (-(u & 1)).astype(np.uint64)).astype(np.int64)


def _pack_planes(codes: np.ndarray, bits: int) -> np.ndarray:
    """codes: uint32 (n,) -> uint32 planes (bits * ceil(n/32),).

    Layout: value ``i`` is bit ``i % 32`` of word ``i // 32`` of its plane
    (little-endian within words) — np.packbits(bitorder='little') produces
    exactly this when the bytes are viewed as LE uint32.
    """
    n = codes.shape[0]
    n_pad = ((n + 31) // 32) * 32
    padded = np.zeros(n_pad, dtype=np.uint32)
    padded[:n] = codes
    nb = max(bits, 1)
    planes = np.empty((nb, n_pad // 32), dtype=np.uint32)
    for j in range(nb):
        bits_j = ((padded >> np.uint32(j)) & np.uint32(1)).astype(np.uint8)
        planes[j] = np.packbits(bits_j, bitorder="little").view("<u4")
    return planes.reshape(-1)


def _unpack_planes(planes: np.ndarray, bits: int, n_pad: int) -> np.ndarray:
    """planes: uint32 (bits * n_pad/32,) -> uint32 codes (n_pad,)."""
    words_per_plane = n_pad // 32
    nb = max(bits, 1)
    planes = planes.reshape(nb, words_per_plane)
    byte_mat = np.ascontiguousarray(planes).view(np.uint8).reshape(nb, -1)
    bits_mat = np.unpackbits(byte_mat, axis=1, bitorder="little")  # (nb, n_pad)
    acc = np.zeros(n_pad, dtype=np.uint32)
    for j in range(nb):
        acc |= bits_mat[j].astype(np.uint32) << np.uint32(j)
    return acc


def _codes_for(values: np.ndarray) -> tuple[np.ndarray, int, int]:
    """Transform raw values to uint32 codes; returns (codes, kind, first_bits)."""
    if values.dtype == np.bool_:
        return values.astype(np.uint32), KIND_BOOL, 0
    if np.issubdtype(values.dtype, np.integer):
        v = values.astype(np.int64)
        first = int(v[0]) if v.size else 0
        deltas = np.diff(v, prepend=np.int64(first))
        deltas[0] = 0
        codes = _zigzag_encode(deltas)
        return codes, KIND_INT, np.uint32(np.int64(first) & 0xFFFFFFFF)
    if values.dtype == np.float32:
        u = values.view(np.uint32)
        first = int(u[0]) if u.size else 0
        prev = np.concatenate([[np.uint32(first)], u[:-1]]) if u.size else u
        codes = u ^ prev
        if codes.size:
            codes[0] = 0
        return codes, KIND_FLOAT, np.uint32(first)
    raise TypeError(f"unsupported dtype for bitpack: {values.dtype}")


def _values_from_codes(codes: np.ndarray, kind: int, first: int, dtype) -> np.ndarray:
    if kind == KIND_BOOL:
        return codes.astype(np.bool_)
    if kind == KIND_INT:
        # int32-wide zigzag + cumsum (sources are int32; wrap-exact)
        u = codes
        deltas = ((u >> np.uint32(1)) ^ (-(u & np.uint32(1)).astype(np.int32)).view(np.uint32)).view(np.int32)
        deltas = deltas.copy()
        deltas[0] = np.asarray(first, dtype=np.uint32).view(np.int32)
        return np.cumsum(deltas, dtype=np.int32).astype(dtype)
    if kind == KIND_FLOAT:
        acc = codes.copy()
        acc[0] = np.uint32(first)
        # cumulative xor
        out = np.bitwise_xor.accumulate(acc)
        return out.view(np.float32).astype(dtype)
    raise ValueError(f"bad kind {kind}")


def bitpack_encode(values: np.ndarray) -> bytes:
    values = np.ascontiguousarray(values)
    n = values.shape[0]
    if n == 0:
        kind = (
            KIND_BOOL
            if values.dtype == np.bool_
            else KIND_INT
            if np.issubdtype(values.dtype, np.integer)
            else KIND_FLOAT
        )
        header = np.array([_MAGIC, kind, 0, 1, 32, 0], dtype=np.uint32)
        return header.tobytes() + np.zeros(1, np.uint32).tobytes()
    codes, kind, first = _codes_for(values)
    bits = int(codes.max()).bit_length() if n and codes.max() > 0 else 1
    if kind == KIND_FLOAT and bits > _RAW_BAILOUT_BITS:
        # incompressible float stream: raw literals (decode == memcpy)
        header = np.array([_MAGIC, KIND_RAW_F32, n, 32, n, first], dtype=np.uint32)
        return header.tobytes() + values.astype(np.float32).tobytes()
    n_pad = ((n + 31) // 32) * 32 if n else 32
    planes = _pack_planes(codes if n else np.zeros(1, np.uint32), bits)
    header = np.array([_MAGIC, kind, n, bits, n_pad, first], dtype=np.uint32)
    return header.tobytes() + planes.tobytes()


def bitpack_decode(blob: bytes, dtype) -> np.ndarray:
    header = np.frombuffer(blob[: _HEADER_WORDS * 4], dtype=np.uint32)
    if int(header[0]) != _MAGIC:
        raise ValueError("bad bitpack magic")
    kind, n, bits, n_pad, first = (int(x) for x in header[1:6])
    if n == 0:
        return np.empty(0, dtype=dtype)
    if kind == KIND_RAW_F32:
        return np.frombuffer(blob[_HEADER_WORDS * 4 :], dtype=np.float32).astype(
            dtype, copy=False
        )
    planes = np.frombuffer(blob[_HEADER_WORDS * 4 :], dtype=np.uint32)
    codes = _unpack_planes(planes, bits, n_pad)[:n]
    return _values_from_codes(codes, kind, first, dtype)


def bitpack_raw_parts(blob: bytes) -> dict:
    """Expose header + plane words for the device decode kernel.

    Raw-mode baskets (kind 3) carry ``raw`` float bytes instead of planes —
    the kernel wrapper passes them through (no decode needed).
    """
    _magic, kind, n, bits, n_pad, first = _HEADER.unpack_from(blob)
    body = blob[_HEADER_WORDS * 4 :]
    out = {"kind": kind, "n": n, "bits": bits, "n_pad": n_pad, "first": first}
    if kind == KIND_RAW_F32:
        out["raw"] = np.frombuffer(body, dtype=np.float32)
        out["planes"] = np.zeros(0, np.uint32)
    else:
        out["planes"] = np.frombuffer(body, dtype=np.uint32)
    return out


# ---------------------------------------------------------------------------
# zone-map statistics (computed at encode time, stored in BasketMeta)
# ---------------------------------------------------------------------------


def basket_stats(values: np.ndarray) -> tuple[float | None, float | None, int | None]:
    """Per-basket zone-map statistics: ``(vmin, vmax, n_true)``.

    ``vmin``/``vmax`` are the value bounds as exact float64 embeddings of
    the stored dtype (float32 -> float64 is exact; int32 fits float64
    exactly), so interval analysis over them reproduces the evaluator's
    comparison semantics bit-for-bit.  ``n_true`` is the true-count for
    boolean branches (``None`` otherwise).  Non-finite data (NaN/inf)
    yields ``(None, None, None)`` — unknown stats degrade to "scan", never
    to a wrong prune (DESIGN.md §9).
    """
    values = np.asarray(values)
    if values.size == 0:
        return None, None, None
    if values.dtype == np.bool_:
        n_true = int(values.sum())
        return float(values.min()), float(values.max()), n_true
    lo, hi = float(values.min()), float(values.max())
    if not (np.isfinite(lo) and np.isfinite(hi)):
        return None, None, None
    return lo, hi, None


# ---------------------------------------------------------------------------


def _zlib_encode(values: np.ndarray) -> bytes:
    return _zlib.compress(np.ascontiguousarray(values).tobytes(), level=9)


def _zlib_decode(blob: bytes, dtype) -> np.ndarray:
    return np.frombuffer(_zlib.decompress(blob), dtype=dtype)


def _raw_encode(values: np.ndarray) -> bytes:
    return np.ascontiguousarray(values).tobytes()


def _raw_decode(blob: bytes, dtype) -> np.ndarray:
    return np.frombuffer(blob, dtype=dtype)


CODECS = {
    "bitpack": (bitpack_encode, bitpack_decode),
    "zlib": (_zlib_encode, _zlib_decode),
    "raw": (_raw_encode, _raw_decode),
}


def encode_basket(values: np.ndarray, codec: str) -> bytes:
    return CODECS[codec][0](values)


def decode_basket(blob: bytes, codec: str, dtype) -> np.ndarray:
    return CODECS[codec][1](blob, dtype)


def decode_basket_batch(
    blobs: list, codec: str, dtype, backend: str = "host", device=None
) -> list:
    """Decode a list of one branch's basket blobs in one round
    (:func:`decode_basket_round` with one branch).  Output order matches
    ``blobs``, bit-identical to the host reference for every kind."""
    return decode_basket_round({"": blobs}, codec, {"": dtype}, backend, device)[""]


def decode_basket_round(
    blobs: dict, codec: str, dtypes: dict, backend: str = "host", device=None
) -> dict:
    """Decode a fetch round, ``{branch: [blob, ...]}``, with each branch's
    dtype in ``dtypes`` (DESIGN.md §16).

    ``backend="host"`` (or any codec without a device decode) loops the
    host reference decoder.  ``backend="device"`` with the ``bitpack``
    codec ships the compressed *plane words* — not decoded columns — to
    ``device`` and decodes every branch's baskets there in one call
    (``repro_torch.kernels.ops.basket_decode_round``: one launch of the
    CUDA kernel on the card, its plain PyTorch version on the CPU;
    ``None`` is the card, raising without one).  Output order matches
    ``blobs`` and is bit-identical to the host reference for every kind
    (int zigzag-delta prefix sums are wrap-exact int32, float prefix-xor
    is exact, bools and raw literals are identity).
    """
    if backend != "device" or codec != "bitpack":
        decode = CODECS[codec][1]
        return {name: [decode(blob, dtypes[name]) for blob in bs]
                for name, bs in blobs.items()}
    from repro_torch.kernels import ops
    from repro_torch.obs.trace import active

    with active().span("bitpack_raw_parts", kind="pack"):
        parts = {name: [bitpack_raw_parts(blob) for blob in bs]
                 for name, bs in blobs.items()}
    return ops.basket_decode_round(parts, dtypes, device=device)


# ---------------------------------------------------------------------------
# integrity digests (computed at encode time, stored in BasketMeta)
# ---------------------------------------------------------------------------


def basket_digest(blob: bytes) -> int:
    """Integrity digest of one encoded basket blob (CRC-32, as an
    unsigned 32-bit int).

    Computed once at encode time and carried in
    :class:`~repro_torch.data.store.BasketMeta` / the store manifest
    (``INTEGRITY_VERSION``); the fetch path recomputes it per blob and a
    mismatch raises :class:`~repro_torch.data.store.CorruptBasket` — corrupt
    data is never silently decoded (DESIGN.md §14).  CRC-32 is orders of
    magnitude cheaper than any codec's decode, keeping verification
    overhead under the 2% budget benchmarked by
    ``benchmarks/bench_faults.py``.
    """
    return _zlib.crc32(blob) & 0xFFFFFFFF

"""The ``bitpack`` basket format, a frozen NumPy copy of the port's
``data/codecs.py`` encoder and decoder as they stood when the benchmark was
written.

The benchmark encodes the reference's expected output with it, to hold the
program's output baskets to it byte for byte, decodes a basket that differs
to count the values that differ, and counts a basket's compressed bytes
for the roofline.  Header per basket (little-endian uint32): magic, kind
(0 int delta, 1 float xor, 2 bool, 3 raw float32), n values, bit width,
n padded values, first raw value; then ``bits`` planes of ``n_pad / 32``
words (plane j holds bit j of every code).
"""

from __future__ import annotations

import numpy as np

MAGIC = 0x534B4D52
KIND_INT, KIND_FLOAT, KIND_BOOL, KIND_RAW_F32 = 0, 1, 2, 3
RAW_BAILOUT_BITS = 24
HEADER_WORDS = 6


def _pack_planes(codes: np.ndarray, bits: int) -> np.ndarray:
    n_pad = ((codes.shape[0] + 31) // 32) * 32
    padded = np.zeros(n_pad, dtype=np.uint32)
    padded[: codes.shape[0]] = codes
    nb = max(bits, 1)
    planes = np.empty((nb, n_pad // 32), dtype=np.uint32)
    for j in range(nb):
        bits_j = ((padded >> np.uint32(j)) & np.uint32(1)).astype(np.uint8)
        planes[j] = np.packbits(bits_j, bitorder="little").view("<u4")
    return planes.reshape(-1)


def _unpack_planes(planes: np.ndarray, bits: int, n_pad: int) -> np.ndarray:
    nb = max(bits, 1)
    planes = planes.reshape(nb, n_pad // 32)
    byte_mat = np.ascontiguousarray(planes).view(np.uint8).reshape(nb, -1)
    bits_mat = np.unpackbits(byte_mat, axis=1, bitorder="little")
    acc = np.zeros(n_pad, dtype=np.uint32)
    for j in range(nb):
        acc |= bits_mat[j].astype(np.uint32) << np.uint32(j)
    return acc


def _codes(values: np.ndarray) -> tuple[np.ndarray, int, int]:
    if values.dtype == np.bool_:
        return values.astype(np.uint32), KIND_BOOL, 0
    if np.issubdtype(values.dtype, np.integer):
        v = values.astype(np.int64)
        first = int(v[0])
        deltas = np.diff(v, prepend=np.int64(first))
        deltas[0] = 0
        codes = ((deltas << 1) ^ (deltas >> 63)).astype(np.uint64).astype(np.uint32)
        return codes, KIND_INT, first & 0xFFFFFFFF
    if values.dtype == np.float32:
        u = values.view(np.uint32)
        first = int(u[0])
        codes = u ^ np.concatenate([[np.uint32(first)], u[:-1]])
        codes[0] = 0
        return codes, KIND_FLOAT, first
    raise TypeError(f"bitpack holds no {values.dtype}")


def encode(values: np.ndarray) -> bytes:
    """One basket of ``values`` (bool, integer or float32)."""
    values = np.ascontiguousarray(values)
    n = values.shape[0]
    if n == 0:
        kind = (KIND_BOOL if values.dtype == np.bool_ else
                KIND_INT if np.issubdtype(values.dtype, np.integer) else KIND_FLOAT)
        return (np.array([MAGIC, kind, 0, 1, 32, 0], np.uint32).tobytes()
                + np.zeros(1, np.uint32).tobytes())
    codes, kind, first = _codes(values)
    top = int(codes.max())
    bits = top.bit_length() if top > 0 else 1
    if kind == KIND_FLOAT and bits > RAW_BAILOUT_BITS:
        header = np.array([MAGIC, KIND_RAW_F32, n, 32, n, first], np.uint32)
        return header.tobytes() + values.astype(np.float32).tobytes()
    n_pad = ((n + 31) // 32) * 32
    header = np.array([MAGIC, kind, n, bits, n_pad, first], np.uint32)
    return header.tobytes() + _pack_planes(codes, bits).tobytes()


def decode(blob: bytes, dtype) -> np.ndarray:
    """The values of one basket, as ``dtype``."""
    header = np.frombuffer(blob[: HEADER_WORDS * 4], dtype=np.uint32)
    if int(header[0]) != MAGIC:
        raise ValueError("not a bitpack basket")
    kind, n, bits, n_pad, first = (int(x) for x in header[1:6])
    body = blob[HEADER_WORDS * 4:]
    if n == 0:
        return np.empty(0, dtype=dtype)
    if kind == KIND_RAW_F32:
        return np.frombuffer(body, dtype=np.float32).astype(dtype)
    codes = _unpack_planes(np.frombuffer(body, dtype=np.uint32), bits, n_pad)[:n]
    if kind == KIND_BOOL:
        return codes.astype(np.bool_).astype(dtype)
    if kind == KIND_INT:
        deltas = ((codes >> np.uint32(1))
                  ^ (-(codes & np.uint32(1)).astype(np.int32)).view(np.uint32)).view(np.int32).copy()
        deltas[0] = np.asarray(first, dtype=np.uint32).view(np.int32)
        return np.cumsum(deltas, dtype=np.int32).astype(dtype)
    if kind == KIND_FLOAT:
        acc = codes.copy()
        acc[0] = np.uint32(first)
        return np.bitwise_xor.accumulate(acc).view(np.float32).astype(dtype)
    raise ValueError(f"bad basket kind {kind}")


def baskets(values: np.ndarray, counts: np.ndarray | None, basket_events: int) -> list:
    """The values of each basket of a branch: ``basket_events`` events a
    basket; a jagged branch (``counts`` given) splits its values at the
    events' offsets."""
    n_events = len(values) if counts is None else len(counts)
    if counts is None:
        return [values[s:s + basket_events] for s in range(0, n_events, basket_events)]
    offsets = np.concatenate([[0], np.cumsum(counts, dtype=np.int64)])
    return [values[offsets[s]:offsets[min(s + basket_events, n_events)]]
            for s in range(0, n_events, basket_events)]

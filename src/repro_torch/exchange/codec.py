"""Delta/bit-width id codec for the packed (partition-centric) exchange
(numpy; this package's own copy of the JAX package's ``repro.exchange.codec``).

The pre-partitioned block structure is static across iterations, so the
destination-row index set of every (source block, destination block) pair can
be stored ONCE and only value payloads shipped each round (PCPM,
"Accelerating PageRank using Partition-Centric Processing").  Two encodings of
the same sets live here:

1. **Wire/manifest form** (``pack_ids``/``unpack_ids``): sorted ids become
   first-id + successive deltas, packed at the per-pair minimal bit width
   (deltas of a dense set are mostly 1s and compress hard).  This is what the
   store persists as shards and what the id-byte accounting charges.
2. **Device form** (``pack_uniform``/``unpack_uniform``): absolute ids at a
   uniform width from {4, 8, 16, 32} bits (32/width ids per uint32 word), so
   the packed scatter-combine kernels (``kernels/csrc/packed_scatter_combine*.cu``)
   decode a slot with one shift and one mask -- no gather, no prefix sums.
   Slightly less dense than the wire form; that gap is the price of an
   in-kernel decode.

Everything here is host-side numpy and vectorized (no per-id Python loops).
"""
from __future__ import annotations

import dataclasses

import numpy as np

__all__ = [
    "PackedIds",
    "HEADER_BYTES",
    "pack_ids",
    "unpack_ids",
    "unpack_fields",
    "packed_nbytes",
    "DEVICE_WIDTHS",
    "device_width",
    "pack_uniform",
    "unpack_uniform",
]

# Per-pair stream header on the wire: int32 count + int32 bit width.
HEADER_BYTES = 8

# Uniform widths the device form may use: divisors of 32 so every uint32 word
# holds a whole number of ids and a slot tile maps to a contiguous word tile.
DEVICE_WIDTHS = (4, 8, 16, 32)

_U32 = np.uint64(0xFFFFFFFF)


@dataclasses.dataclass(frozen=True)
class PackedIds:
    """One (src block, dst block) pair's id set in wire form."""

    words: np.ndarray  # uint32, LSB-first packed delta fields
    count: int         # number of ids
    width: int         # bits per delta field (0 for the empty set)
    n_local: int       # id domain [0, n_local)


def pack_ids(ids, n_local: int) -> PackedIds:
    """Pack a strictly-increasing id set from [0, n_local) into delta fields.

    Fields are [ids[0], ids[1]-ids[0], ...]; the width is the minimal bit
    count for the largest field (>= 1 so the all-{0,1}-delta case still
    round-trips).
    """
    ids = np.asarray(ids, dtype=np.int64)
    if ids.ndim != 1:
        raise ValueError(f"ids must be 1-D, got shape {ids.shape}")
    count = int(ids.size)
    if count == 0:
        return PackedIds(np.zeros(0, np.uint32), 0, 0, int(n_local))
    if ids[0] < 0 or ids[-1] >= n_local:
        raise ValueError(f"ids out of [0, {n_local}): [{ids[0]}, {ids[-1]}]")
    fields = np.diff(ids, prepend=np.int64(0))
    if count > 1 and fields[1:].min() <= 0:
        raise ValueError("ids must be strictly increasing")
    width = max(1, int(fields.max()).bit_length())
    n_words = -(-count * width // 32)
    # One guard word absorbs the high-part write of the last field.
    words = np.zeros(n_words + 1, np.uint64)
    off = np.arange(count, dtype=np.int64) * width
    wi = off // 32
    sh = (off % 32).astype(np.uint64)
    f = fields.astype(np.uint64)
    np.bitwise_or.at(words, wi, (f << sh) & _U32)
    np.bitwise_or.at(words, wi + 1, f >> (np.uint64(32) - sh))
    return PackedIds(words[:n_words].astype(np.uint32), count, width, int(n_local))


def unpack_ids(packed: PackedIds) -> np.ndarray:
    """Inverse of :func:`pack_ids`; returns int64 ids, sorted ascending."""
    return unpack_fields(packed.words, packed.count, packed.width)


def unpack_fields(words: np.ndarray, count: int, width: int) -> np.ndarray:
    """Decode ``count`` delta fields of ``width`` bits and cumsum back to ids."""
    if count == 0:
        return np.zeros(0, np.int64)
    w = np.concatenate([np.asarray(words, np.uint64), np.zeros(1, np.uint64)])
    off = np.arange(count, dtype=np.int64) * width
    wi = off // 32
    sh = (off % 32).astype(np.uint64)
    lo = w[wi] >> sh
    hi = w[wi + 1] << (np.uint64(32) - sh)
    mask = np.uint64((1 << width) - 1)
    fields = ((lo | hi) & mask).astype(np.int64)
    return np.cumsum(fields)


def packed_nbytes(packed: PackedIds) -> int:
    """Wire bytes this set costs once per solve (header + packed words)."""
    return HEADER_BYTES + 4 * int(packed.words.size)


def device_width(n_local: int) -> int:
    """Smallest uniform width that can hold every id AND the pad sentinel
    ``n_local`` (the receive scatter's drop slot)."""
    need = max(1, int(n_local).bit_length())
    for w in DEVICE_WIDTHS:
        if w >= need:
            return w
    raise ValueError(f"n_local={n_local} does not fit a 32-bit id")


def pack_uniform(ids: np.ndarray, width: int) -> np.ndarray:
    """Pack absolute ids [..., p] at a uniform ``width`` into uint32 words
    [..., p*width/32].  ``p`` must be a multiple of 32/width (pad with the
    sentinel first) so sets stay word-aligned."""
    if width not in DEVICE_WIDTHS:
        raise ValueError(f"width {width} not in {DEVICE_WIDTHS}")
    ids = np.asarray(ids)
    k = 32 // width
    p = ids.shape[-1]
    if p % k:
        raise ValueError(f"trailing dim {p} not a multiple of {k} ids/word")
    a = ids.astype(np.uint64).reshape(ids.shape[:-1] + (p // k, k))
    if a.size and int(a.max()) >= (1 << width):
        raise ValueError(f"id {int(a.max())} overflows width {width}")
    sh = np.arange(k, dtype=np.uint64) * np.uint64(width)
    return np.bitwise_or.reduce(a << sh, axis=-1).astype(np.uint32)


def unpack_uniform(words: np.ndarray, width: int, p: int) -> np.ndarray:
    """Inverse of :func:`pack_uniform`: uint32 words [..., W] -> int32 ids
    [..., p] (p <= W * 32/width)."""
    k = 32 // width
    w = np.asarray(words, np.uint64)
    sh = np.arange(k, dtype=np.uint64) * np.uint64(width)
    mask = np.uint64((1 << width) - 1)
    out = (w[..., None] >> sh) & mask
    return out.reshape(w.shape[:-1] + (w.shape[-1] * k,))[..., :p].astype(np.int32)

"""XXH64 content checksum (reference: Unsafe/Xxhash.cs:487-612).

The zstd frame checksum is the low 32 bits of XXH64(content, seed=0)
(write: ZstdCompress.cs:5598+, verify: ZstdDecompress.cs:1186-1208).

Two implementations:

* :func:`xxh64` — numpy implementation structured for lane-parallelism:
  the 4 accumulator lanes each fold every 4th 8-byte word, which is the
  same stripe structure a batched device port uses (lanes across many
  streams).
* :func:`xxh64_fast` — dispatches to the ``xxhash`` C module when present
  (oracle/fast path), else falls back to the numpy one.
"""

from __future__ import annotations

import numpy as np

_PRIME64_1 = np.uint64(0x9E3779B185EBCA87)
_PRIME64_2 = np.uint64(0xC2B2AE3D27D4EB4F)
_PRIME64_3 = np.uint64(0x165667B19E3779F9)
_PRIME64_4 = np.uint64(0x85EBCA77C2B2AE63)
_PRIME64_5 = np.uint64(0x27D4EB2F165667C5)

_U64 = np.uint64
_MASK = np.uint64(0xFFFFFFFFFFFFFFFF)


def _rotl(x: np.uint64, r: int) -> np.uint64:
    r = np.uint64(r)
    return ((x << r) | (x >> (np.uint64(64) - r))) & _MASK


def _round(acc: np.uint64, inp: np.uint64) -> np.uint64:
    acc = (acc + inp * _PRIME64_2) & _MASK
    acc = _rotl(acc, 31)
    return (acc * _PRIME64_1) & _MASK


def _merge_round(acc: np.uint64, val: np.uint64) -> np.uint64:
    acc ^= _round(_U64(0), val)
    return ((acc * _PRIME64_1) + _PRIME64_4) & _MASK


def xxh64(data: bytes | np.ndarray, seed: int = 0) -> int:
    """Pure numpy XXH64 (validated against the xxhash C module)."""
    buf = np.frombuffer(bytes(data) if not isinstance(data, np.ndarray) else data.tobytes(), dtype=np.uint8)
    n = len(buf)
    seed = _U64(seed)

    with np.errstate(over="ignore"):
        if n >= 32:
            nstripes = n // 32
            words = buf[: nstripes * 32].view("<u8").reshape(nstripes, 4)
            v = np.array(
                [seed + _PRIME64_1 + _PRIME64_2, seed + _PRIME64_2, seed,
                 seed - _PRIME64_1],
                dtype=np.uint64,
            )
            # Sequential fold over stripes; each step is 4-lane parallel.
            for i in range(nstripes):
                v = (v + words[i] * _PRIME64_2) & _MASK
                v = ((v << _U64(31)) | (v >> _U64(33))) & _MASK
                v = (v * _PRIME64_1) & _MASK
            h = (_rotl(v[0], 1) + _rotl(v[1], 7) + _rotl(v[2], 12) + _rotl(v[3], 18)) & _MASK
            for lane in range(4):
                h = _merge_round(h, v[lane])
            pos = nstripes * 32
        else:
            h = (seed + _PRIME64_5) & _MASK
            pos = 0

        h = (h + _U64(n)) & _MASK

        # Tail: 8-byte, 4-byte, then single bytes.
        while pos + 8 <= n:
            k1 = _round(_U64(0), buf[pos : pos + 8].view("<u8")[0])
            h ^= k1
            h = (_rotl(h, 27) * _PRIME64_1 + _PRIME64_4) & _MASK
            pos += 8
        if pos + 4 <= n:
            h ^= (_U64(buf[pos : pos + 4].view("<u4")[0]) * _PRIME64_1) & _MASK
            h = (_rotl(h, 23) * _PRIME64_2 + _PRIME64_3) & _MASK
            pos += 4
        while pos < n:
            h ^= (_U64(buf[pos]) * _PRIME64_5) & _MASK
            h = (_rotl(h, 11) * _PRIME64_1) & _MASK
            pos += 1

        h ^= h >> _U64(33)
        h = (h * _PRIME64_2) & _MASK
        h ^= h >> _U64(29)
        h = (h * _PRIME64_3) & _MASK
        h ^= h >> _U64(32)
    return int(h)


try:
    import xxhash as _xxhash_c

    def xxh64_fast(data, seed: int = 0) -> int:
        if isinstance(data, np.ndarray):
            data = data.tobytes()
        return _xxhash_c.xxh64_intdigest(data, seed)

except ImportError:  # pragma: no cover
    xxh64_fast = xxh64


def content_checksum(data: bytes | np.ndarray) -> int:
    """Frame checksum: low 32 bits of XXH64(content, 0)."""
    return xxh64_fast(data) & 0xFFFFFFFF

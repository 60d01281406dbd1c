"""End-to-end on-device batch compression (the encode mirror of
decode/device_pipeline.py).

`compress_batch_device(records)` compresses a batch of byte records
wholly on the device: greedy parse, FSE sequence coding (permutation-map
suffix composition), bit packing and frame assembly all run inside one
XLA program per size bucket (ops/device_encode.py).  Outputs are
device-resident uint8 frame rows in device memory — the deployment shape
for record-batch compression feeding on-device producers (checkpoint and
record writers), where D2H bandwidth never enters until the frames ship.

Envelope: records <= 128KB become single-segment single-block frames:
4-stream Huffman literals when they pay (tables built on the host from
device histograms, streams packed on the device) else raw literals; per
lane a fresh, RLE or predefined FSE table for each sequence channel; a raw
block when entropy coding does not pay.  Larger records route to the
host engine, reported in the stats.  Every produced frame is standard
zstd — decodable by libzstd, the host tier, and the device decode plane.

Reference displaced: ZSTD_compressSequences/ZSTD_encodeSequences_body
(ZstdCompressSequences.cs:585) and the block writer
(ZstdCompress.cs:3285); the ratio trade of raw literals vs Huffman is
the classic speed-tier trade, not a format deviation.
"""

from __future__ import annotations

import numpy as np

# records per jit dispatch (fixed so compiled programs are reused)
LANES = 32
_N_BUCKETS = (1 << 12, 1 << 14, 1 << 16, 1 << 17)


def _bucket(n: int) -> int:
    for b in _N_BUCKETS:
        if n <= b:
            return b
    return -1


def compress_batch_device(records, materialize: bool = False,
                          hash_log: int = 15):
    """Compress a batch of records on the device.

    Returns (chunks, host_results) where chunks is a list of
    (record_indices, rows_device [LANES, N+16] uint8, lens [LANES] int32)
    and host_results maps record_idx -> frame bytes for records outside
    the device envelope.  With materialize=True, returns (frames, stats):
    the per-record frame bytes in order plus routing stats.
    """
    import jax
    import jax.numpy as jnp

    from ..ops.device_encode import (encode_frames_device, seq_budget,
                                     word_budget)

    host_results = {}
    by_bucket: dict = {}
    for ri, rec in enumerate(records):
        b = _bucket(len(rec))
        if b < 0:
            from .frame import compress

            host_results[ri] = compress(bytes(rec), 1)
            continue
        by_bucket.setdefault(b, []).append(ri)

    chunks = []
    for N, idxs in sorted(by_bucket.items()):
        S = seq_budget(N)
        W = word_budget(S)
        for c0 in range(0, len(idxs), LANES):
            part = idxs[c0:c0 + LANES]
            blocks = np.zeros((LANES, N), np.uint8)
            nv = np.zeros(LANES, np.int32)
            for k, ri in enumerate(part):
                r = records[ri]
                blocks[k, :len(r)] = np.frombuffer(r, np.uint8)
                nv[k] = len(r)
            rows, lens = encode_frames_device(
                jnp.asarray(blocks), jnp.asarray(nv), S, W, hash_log)
            chunks.append((part, rows, lens))

    if not materialize:
        return chunks, host_results

    frames: list = [None] * len(records)
    for ri, f in host_results.items():
        frames[ri] = f
    for part, rows, lens in chunks:
        h = np.asarray(rows)
        ln = np.asarray(lens)
        for k, ri in enumerate(part):
            frames[ri] = h[k, :ln[k]].tobytes()
    stats = {"device_frames": sum(len(p) for p, _, _ in chunks),
             "host_frames": len(host_results),
             # where the frames were built: the devices holding the rows
             "devices": sorted({str(d) for _, rows, _ in chunks
                                for d in rows.devices()})}
    return frames, stats

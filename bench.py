"""Benchmark entry point (prints ONE JSON line on stdout).

Metric: level-1 encode+decode roundtrip throughput of the host engine on a
Silesia-like mixed corpus; the device decode and encode planes follow on
stderr.  The script needs a GPU and exits non-zero without one.
Baseline: the reference's published single-thread numbers on dickens
(BASELINE.md): compress L1 0.151 GB/s + decompress L1 0.485 GB/s
=> roundtrip 1/(1/0.151 + 1/0.485) = 0.1152 GB/s.

Sub-metrics (encode-only, decode-only, ratio vs libzstd) go to stderr.
"""

import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).parent))

import numpy as np

BASELINE_ROUNDTRIP_GBS = 1.0 / (1.0 / 0.151 + 1.0 / 0.485)  # 0.1152
CORPUS_MB = 8


def make_corpus(n_bytes: int) -> bytes:
    """Deterministic Silesia-like mix: natural text, structured records,
    near-incompressible, and run-heavy segments."""
    r = np.random.default_rng(20260816)
    parts = []
    words = [b"the", b"of", b"and", b"a", b"to", b"in", b"he", b"was", b"that",
             b"it", b"his", b"her", b"with", b"as", b"had", b"for", b"dickens",
             b"compression", b"entropy", b"probability", b"wonderful"]
    probs = r.dirichlet(np.ones(len(words)) * 0.5)
    while sum(map(len, parts)) < n_bytes:
        kind = r.integers(0, 10)
        if kind < 5:  # text
            idx = r.choice(len(words), 40_000, p=probs)
            parts.append(b" ".join(words[i] for i in idx))
        elif kind < 7:  # structured records
            recs = [b'{"id": %d, "status": "ok", "score": %d}' % (i, i * 7 % 997)
                    for i in range(6000)]
            parts.append(b",".join(recs))
        elif kind < 8:  # binary ramps
            parts.append((np.arange(120_000) % 251).astype(np.uint8).tobytes())
        elif kind < 9:  # runs
            parts.append(bytes([int(r.integers(0, 256))]) * 80_000)
        else:  # high entropy
            parts.append(r.integers(0, 256, 150_000, dtype=np.uint8).tobytes())
    return b"".join(parts)[:n_bytes]


def make_real_corpus(n_bytes: int = 8 << 20) -> bytes:
    """Real-file corpus assembled from data shipped in the image, mirroring
    Silesia's mix (no network access to fetch Silesia itself): source code
    (stdlib .py ~ samba), English prose (pydoc topics ~ dickens/webster),
    ELF binary (numpy's umath .so ~ mozilla), and structured records
    (dpkg status ~ nci).  Deterministic for a given image."""
    import pathlib
    import sysconfig

    parts = []
    std = pathlib.Path(sysconfig.get_paths()["stdlib"])
    acc = 0
    for p in sorted(std.glob("*.py")):
        parts.append(p.read_bytes())
        acc += len(parts[-1])
        if acc >= (3 << 20):
            break
    topics = std / "pydoc_data" / "topics.py"
    if topics.exists():
        parts.append(topics.read_bytes())
    status = pathlib.Path("/var/lib/dpkg/status")
    if status.exists():
        parts.append(status.read_bytes()[: 1 << 20])
    import numpy as _np

    so = sorted(pathlib.Path(_np.__file__).parent.rglob("*.so"),
                key=lambda p: -p.stat().st_size)
    if so:
        parts.append(so[0].read_bytes()[: 3 << 20])
    return b"".join(parts)[:n_bytes]


def device_sections(data: bytes) -> None:
    """Device decode and encode planes, end to end, on the GPU.

    Decode: frames (the repo's own encoder, level 3) -> Triton entropy
    kernels -> pointer-jumping LZ executor -> decoded rows in device memory
    (the deployment is record-batch decode feeding on-device consumers;
    outputs never cross back).  Encode: records -> parse + FSE/Huffman
    coding + frame assembly on the device.  Each time is the median of
    plain end-to-end calls that end in block_until_ready, compile excluded.
    Any failure propagates: a device section that cannot run fails bench.py.
    """
    import jax

    from zstdsharp_tpu.decode.frame import Decompressor
    from zstdsharp_tpu.encode.device_pipeline import compress_batch_device
    from zstdsharp_tpu.encode.frame import Compressor

    dev = jax.devices()[0]
    rec_size = 16 << 10
    recs = [data[i : i + rec_size] for i in range(0, 4 << 20, rec_size)]
    payload = sum(map(len, recs))
    frames = Compressor(level=3).wrap_many(recs)
    dec = Decompressor()

    def run_decode():
        outs, lens, host = dec.unwrap_many_device(frames)
        jax.block_until_ready(outs)
        return len(host)

    n_host = run_decode()  # compile
    t = sorted(_timed(run_decode) for _ in range(5))[2]
    print(f"bench: device decode {payload >> 20} MiB batch ({len(frames)} "
          f"frames, {n_host} host-routed): {payload / t / 1e9:.3f} GB/s "
          f"on {dev.device_kind}", file=sys.stderr)

    def run_encode():
        chunks, host = compress_batch_device(recs)
        jax.block_until_ready([rows for _, rows, _ in chunks])
        return sum(int(np.asarray(l).sum()) for _, _, l in chunks), len(host)

    csize, n_host = run_encode()  # compile
    t = sorted(_timed(run_encode) for _ in range(5))[2]
    print(f"bench: device encode {payload >> 20} MiB batch ({len(recs)} "
          f"records -> {csize} bytes, {n_host} host-routed): "
          f"{payload / t / 1e9:.3f} GB/s on {dev.device_kind}",
          file=sys.stderr)


def main() -> None:
    import jax

    if jax.default_backend() != "gpu":
        raise SystemExit("bench.py: the device sections need a GPU, JAX "
                         f"found backend {jax.default_backend()!r}")
    data = make_corpus(CORPUS_MB << 20)
    n = len(data)

    from zstdsharp_tpu.decode.frame import decompress
    from zstdsharp_tpu.encode.frame import compress

    # Warm up (builds the native engine) then measure steady state.
    # Median-of-N with dispersion: a shared/throttled VM makes single-shot
    # (and even best-of-N) numbers unreproducible; the artifact records
    # median plus [min, max] so a regression is distinguishable from noise.
    frame = compress(data, 1)
    enc_times = sorted(_timed(lambda: compress(data, 1)) for _ in range(15))
    out = decompress(frame)
    assert out == data, "roundtrip mismatch"
    dec_times = sorted(_timed(lambda: decompress(frame)) for _ in range(15))

    med_enc, med_dec = enc_times[len(enc_times) // 2], dec_times[len(dec_times) // 2]
    enc_gbs = n / med_enc / 1e9
    dec_gbs = n / med_dec / 1e9
    rt_gbs = n / (med_enc + med_dec) / 1e9
    spread = {
        "encode_gbs": [round(n / enc_times[-1] / 1e9, 4), round(enc_gbs, 4),
                       round(n / enc_times[0] / 1e9, 4)],
        "decode_gbs": [round(n / dec_times[-1] / 1e9, 4), round(dec_gbs, 4),
                       round(n / dec_times[0] / 1e9, 4)],
        "reps": len(enc_times),
    }

    try:  # libzstd is an optional comparison, never on the measured path
        import zstandard
    except ImportError:
        zstandard = None
    ratio_note = f"size ours={len(frame)}"
    if zstandard is not None:
        oracle = len(zstandard.ZstdCompressor(level=1).compress(data))
        ratio_note += f" zstd-L1={oracle} (x{len(frame)/oracle:.3f})"

    print(f"bench: encode {enc_gbs:.4f} GB/s, decode {dec_gbs:.4f} GB/s, "
          f"roundtrip {rt_gbs:.4f} GB/s, {ratio_note}", file=sys.stderr)

    # Real-file corpus (Silesia-style mix from image-shipped files): ratio
    # and speed vs libzstd at the fast and optimal ends.
    if zstandard is not None:
        real = make_real_corpus()
        for lvl in (1, 19):
            f = compress(real, lvl)
            te = min(_timed(lambda: compress(real, lvl)) for _ in range(3 if lvl == 1 else 1))
            zc = zstandard.ZstdCompressor(level=lvl, write_content_size=True)
            fz = zc.compress(real)
            tz = min(_timed(lambda: zc.compress(real)) for _ in range(3 if lvl == 1 else 1))
            assert decompress(f) == real
            print(f"bench: real corpus ({len(real)>>20}MB) L{lvl}: "
                  f"ours {len(f)} @ {len(real)/te/1e6:.1f} MB/s, "
                  f"libzstd {len(fz)} @ {len(real)/tz/1e6:.1f} MB/s "
                  f"(ratio x{len(f)/len(fz):.4f}, speed x{tz/te:.2f})",
                  file=sys.stderr)

    # Dictionary batch path (the 10K-small-records headline config).
    from zstdsharp_tpu.decode.frame import Decompressor
    from zstdsharp_tpu.dictionary import train_dictionary
    from zstdsharp_tpu.encode.frame import Compressor

    recs = [b'{"id": %d, "name": "user%d", "score": %d}' % (i, i, i * 7 % 997)
            for i in range(5000)]
    dic = train_dictionary(recs[:1000], 4096)
    comp = Compressor(level=3)
    comp.load_dictionary(dic)
    frames_d = comp.wrap_many(recs)
    te = min(_timed(lambda: comp.wrap_many(recs)) for _ in range(3))
    dec = Decompressor()
    dec.load_dictionary(dic)
    assert dec.unwrap_many(frames_d) == recs
    td = min(_timed(lambda: dec.unwrap_many(frames_d)) for _ in range(3))
    tot = sum(map(len, recs))
    # path honesty: a silent mass fallback must be visible in the tail
    enc_path = getattr(comp._dict, "last_compress_path", "?")
    dec_path = getattr(dec._dict, "last_decompress_path", "?")
    print(f"bench: dict batch (5K json records) encode {tot/te/1e6:.1f} MB/s, "
          f"decode {tot/td/1e6:.1f} MB/s, size {sum(map(len, frames_d))} "
          f"[enc={enc_path} dec={dec_path}]",
          file=sys.stderr)

    device_sections(data)

    print(json.dumps({
        "metric": "silesia_like_l1_roundtrip_per_chip",
        "value": round(rt_gbs, 6),
        "unit": "GB/s",
        "vs_baseline": round(rt_gbs / BASELINE_ROUNDTRIP_GBS, 6),
        "spread_min_med_max": spread,
    }))


def _timed(fn) -> float:
    t0 = time.perf_counter()
    fn()
    return time.perf_counter() - t0


if __name__ == "__main__":
    main()

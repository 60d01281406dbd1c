#!/usr/bin/env python3
"""Smoke run of the record-batch codec on an NVIDIA GPU.

Drives the main path once through the public entry points, at the size
of a real consumer batch:

  decode   4096 records of 16 KiB (64 MiB: a Kafka consumer batch, whose
           producer batch.size defaults to 16384 and zstd level to 3),
           compressed by the native host encoder at level 3, decoded on
           the device by Decompressor().unwrap_many_device; then a second
           batch of other records (from --seed + 1), so the second time
           includes any recompile a new batch causes (the count of newly
           traced programs is printed), and that batch once more, for the
           time of a call that compiles nothing.  Every row is
           compared byte for byte with its record, and both entropy
           kernels are compared with their numpy mirrors on the first
           batch's own operands.  Then the tests marked `gpu` run.
  encode   compress_batch_device on 1024 of the records (16 MiB), then on
           1024 others; every frame is decoded by the native host decoder
           and compared.
  --chips 4  only the four-card phase: compress_data_parallel at L1 and
           L3 and decompress_data_parallel on 1 GiB over a 1-D ('data',)
           mesh, decompress_data_parallel on the records' frames and
           compress_records_device on 1024 records, each checked against
           its input and by the host decoder.

Records are 16 KiB windows of an in-image corpus (bench.make_real_corpus:
stdlib sources, /var/lib/dpkg/status, a numpy shared object) at offsets
drawn from --seed.

    python chip_smoke.py [--seed N] [--chips 4]

The card's name and power limit come first, then one line per phase; the
last line is {"ok": true, "device": {...}}.  With no GPU, outside a
checkout of the repository, or when any phase fails, the script exits
non-zero and prints no last line.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
REC = 16 << 10


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    raise SystemExit(1)


def log(msg: str) -> None:
    print(msg, flush=True)


def timed(fn):
    t0 = time.perf_counter()
    out = fn()
    return out, time.perf_counter() - t0


def make_records(n: int, seed: int) -> list[bytes]:
    import numpy as np

    from bench import make_real_corpus

    corpus = make_real_corpus()
    offs = np.random.default_rng(seed).integers(0, len(corpus) - REC, n)
    return [corpus[o:o + REC] for o in offs.tolist()]


def card() -> None:
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60)
    if r.returncode != 0 or not r.stdout.strip():
        fail(f"nvidia-smi: {r.stderr.strip()}")
    for line in r.stdout.strip().splitlines():
        log(f"card: {line.strip()}")


def native_engine():
    from zstdsharp_tpu import native

    (lib, dt) = timed(native.get_lib)
    if lib is None or not hasattr(lib, "zt_dplane_batch"):
        fail("native engine did not build or load")
    log(f"native engine: {native.lib_path().relative_to(ROOT)} "
        f"(build+load {dt:.3f} s)")


def decode_phase(records, other):
    """Decode `records`' frames, then `other`'s (a batch of fresh data with
    the same shapes: a recompile would show in the second time)."""
    import jax
    import numpy as np

    from zstdsharp_tpu.decode.device_pipeline import (plan_batch,
                                                      scan_eligibility)
    from zstdsharp_tpu.decode.frame import Decompressor
    from zstdsharp_tpu.encode.frame import Compressor
    from zstdsharp_tpu.ops import device_fse, device_huf

    dec = Decompressor()

    def decode(recs, label):
        frames, t_enc = timed(lambda: Compressor(level=3).wrap_many(recs))
        size = sum(map(len, recs))

        def run():
            outs, lens, host = dec.unwrap_many_device(frames)
            jax.block_until_ready(outs)
            return outs, lens, host

        (outs, lens, host), t = timed(run)
        log(f"decode: {label}: {len(recs)} records, {size} bytes -> "
            f"{sum(map(len, frames))} bytes at L3 (host encode "
            f"{t_enc:.3f} s); unwrap_many_device {t:.3f} s "
            f"({size / t / 1e9:.3f} GB/s), host-routed {len(host)}")
        if host:
            reasons = scan_eligibility(frames)
            for fi in sorted(host)[:20]:
                log(f"  host-routed frame {fi}: {reasons.get(fi, '?')}")
            fail(f"{len(host)} frames left the device plane")
        k = 0
        for out in outs:
            rows = np.asarray(out)
            for row in rows[: len(recs) - k]:
                if row[: lens[k]].tobytes() != recs[k]:
                    fail(f"decode: {label}: record {k} differs")
                k += 1
        if k != len(recs):
            fail(f"decode: {label}: {k} rows for {len(recs)} records")
        log(f"decode: {label}: all {k} records byte-exact")
        return frames

    def programs():
        """Programs the decode plane has traced: both kernels and the
        executor, one per shape bucket."""
        from zstdsharp_tpu.decode import device_pipeline

        return sum(f._cache_size() for c in (
            device_huf._FN_CACHE, device_fse._FN_CACHE,
            device_pipeline._FUSED_CACHE) for f in c.values())

    frames = decode(records, "first call (with compile)")
    n0 = programs()
    decode(other, "second call (other records)")
    log(f"decode: the second call traced {programs() - n0} new programs")
    decode(other, "third call (the same records again)")

    plan = plan_batch(frames)
    if plan.nb is None:
        fail("decode: the Python planner ran, not the native one")
    for name, mod, ops in (("huffman", device_huf, plan.nb.huf_ops()),
                           ("fse", device_fse, plan.nb.fse_ops())):
        got = mod.decode_lanemajor(ops)
        got = [np.asarray(g) for g in (got if isinstance(got, tuple)
                                       else (got,))]
        ref, t_ref = timed(lambda: mod.decode_reference(ops))
        ref = ref if isinstance(ref, tuple) else (ref,)
        n = len(ops["words"])
        # rows from n on are the launch's padding lanes: empty
        if not all(np.array_equal(g[:n], r) and not g[n:].any()
                   for g, r in zip(got, ref)):
            fail(f"{name} kernel differs from its numpy mirror")
        log(f"decode: {name} kernel == numpy mirror on all {n} lanes x "
            f"{got[0].shape[1]} steps, {got[0].shape[0] - n} padding lanes "
            f"empty (mirror {t_ref:.1f} s)")


def gpu_tests():
    import pytest

    rc = pytest.main(["-q", "-m", "gpu", "-p", "no:cacheprovider",
                      str(ROOT / "tests" / "test_device_huf.py"),
                      str(ROOT / "tests" / "test_device_fse.py")])
    if rc != 0:
        fail(f"gpu-marked tests: pytest exit {int(rc)}")
    log("gpu tests: passed")


def encode_phase(records, other):
    """Encode `records`, then `other` (fresh data, the same shapes)."""
    import jax
    import numpy as np

    from zstdsharp_tpu.decode.frame import decompress
    from zstdsharp_tpu.encode.device_pipeline import compress_batch_device
    from zstdsharp_tpu.encode.frame import compress

    def encode(recs, label):
        size = sum(map(len, recs))

        def run():
            chunks, host = compress_batch_device(recs)
            jax.block_until_ready([rows for _, rows, _ in chunks])
            return chunks, host

        (chunks, host), t = timed(run)
        log(f"encode: {label}: {len(recs)} records, {size} bytes; "
            f"compress_batch_device {t:.3f} s ({size / t / 1e9:.3f} GB/s), "
            f"host-routed {len(host)}")
        if host:
            fail(f"encode: {len(host)} records left the device plane")
        frames = [None] * len(recs)
        for part, rows, lens in chunks:
            rows, lens = np.asarray(rows), np.asarray(lens)
            for k, ri in enumerate(part):
                frames[ri] = rows[k, : lens[k]].tobytes()
        for i, (f, r) in enumerate(zip(frames, recs)):
            if decompress(f) != r:
                fail(f"encode: {label}: host decode of frame {i} differs")
        l1 = sum(len(compress(r, 1)) for r in recs)
        log(f"encode: {label}: all {len(frames)} frames host-decoded "
            f"byte-exact; {sum(map(len, frames))} bytes on device vs {l1} "
            "host L1")

    encode(records, "first call (with compile)")
    encode(other, "second call (other records)")


def four_card_phase(records, seed, n_bytes=1 << 30):
    import jax

    from zstdsharp_tpu.decode.frame import decompress
    from zstdsharp_tpu.encode.frame import Compressor
    from zstdsharp_tpu.parallel.pipeline import (compress_data_parallel,
                                                 compress_records_device,
                                                 decompress_data_parallel,
                                                 make_mesh)

    devices = jax.devices()
    if len(devices) < 4:
        fail(f"--chips 4 needs 4 GPUs, JAX sees {len(devices)}")
    mesh = make_mesh(devices[:4])
    cards = sorted(str(d) for d in mesh.devices.flat)

    def on_all_cards(what, held):
        """`held`: the devices that hold a phase's outputs."""
        if sorted(set(held)) != cards:
            fail(f"4 cards: {what} outputs are on {sorted(set(held))}, "
                 f"not on all of {cards}")

    data = b"".join(make_records(n_bytes // REC, seed + 1))
    log(f"4 cards: mesh {cards}, {len(data)} bytes")
    for level in (1, 3):
        tel: dict = {}
        frame, tc = timed(lambda: compress_data_parallel(
            data, mesh, level=level, telemetry=tel))
        out, td = timed(lambda: decompress_data_parallel(frame, mesh))
        if out != data:
            fail(f"4 cards: L{level} sharded roundtrip differs")
        if decompress(frame) != data:
            fail(f"4 cards: L{level} host decode differs")
        log(f"4 cards: L{level} {len(data)} -> {len(frame)} bytes, "
            f"compress {tc:.3f} s, decompress {td:.3f} s, parse shards on "
            f"{tel['shard_devices']}")
        on_all_cards(f"L{level} parse", tel["shard_devices"])
    frames = Compressor(level=3).wrap_many(records)
    tel = {}
    out, td = timed(lambda: decompress_data_parallel(b"".join(frames), mesh,
                                                     telemetry=tel))
    if out != b"".join(records):
        fail("4 cards: record-stream sharded decode differs")
    shards = tel["device_shards"]
    log(f"4 cards: decompress_data_parallel {len(frames)} record frames "
        f"{td:.3f} s, device frames {tel['device_frames']}, host frames "
        f"{tel['host_frames']}, rows held on "
        f"{[(s['devices'], s['frames']) for s in shards]}")
    if tel["host_frames"]:
        fail("4 cards: record frames left the device plane")
    on_all_cards("record decode", [d for s in shards for d in s["devices"]])
    tel = {}
    eframes, te = timed(lambda: compress_records_device(records, mesh,
                                                        telemetry=tel))
    for i, (f, r) in enumerate(zip(eframes, records)):
        if decompress(f) != r:
            fail(f"4 cards: device-encoded frame {i} differs")
    shards = tel["device_shards"]
    log(f"4 cards: compress_records_device {len(records)} records "
        f"{te:.3f} s, host frames {tel['host_frames']}, rows held on "
        f"{[(s['devices'], s['frames']) for s in shards]}; all frames "
        "host-decoded byte-exact")
    if tel["host_frames"]:
        fail("4 cards: records left the device plane")
    on_all_cards("record encode", [d for s in shards for d in s["devices"]])


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--chips", type=int, choices=(1, 4), default=1)
    args = ap.parse_args()
    if not (ROOT / "zstdsharp_tpu" / "__init__.py").is_file():
        fail(f"{ROOT} is not a checkout of the repository")
    sys.path.insert(0, str(ROOT))

    import jax

    if jax.default_backend() != "gpu":
        fail(f"JAX found no GPU (backend {jax.default_backend()!r})")
    card()
    dev = jax.devices()[0]
    log(f"jax {jax.__version__}, device {dev.device_kind}, "
        f"count {len(jax.devices())}")
    native_engine()
    if args.chips == 4:
        four_card_phase(make_records(1024, args.seed), args.seed)
    else:
        records = make_records(4096, args.seed)
        decode_phase(records, make_records(4096, args.seed + 1))
        gpu_tests()
        encode_phase(records[:1024], records[1024:2048])
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}))


if __name__ == "__main__":
    main()

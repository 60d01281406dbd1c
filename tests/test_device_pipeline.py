"""End-to-end device decode: real frames through the Pallas entropy
kernels + the pointer-jumping LZ executor, verified without copying the
payload back (the on-device comparison reduces to one boolean).

`decode_batch_device` is the production consumer of the device decode
plane (bench.py and chip_smoke.py report its throughput).
"""

import numpy as np
import pytest
import zstandard

from zstdsharp_tpu.encode.frame import compress

jax = pytest.importorskip("jax")
jnp = jax.numpy

from zstdsharp_tpu.decode.device_pipeline import (decode_batch_device,
                                                  plan_batch)


def _records(n, size, seed=7):
    r = np.random.default_rng(seed)
    words = [b"alpha", b"bravo", b"charlie", b"delta", b"echo", b"foxtrot",
             b"golf", b"hotel", b"india", b"juliet"]
    out = []
    for k in range(n):
        rec = b" ".join(words[int(i)]
                        for i in r.integers(0, len(words), size // 6 + 2))
        out.append(rec[:size])
    return out


class TestDevicePipeline:
    def test_record_batch_bit_exact(self):
        recs = _records(12, 24_000)
        frames = [compress(x, 5) for x in recs]
        results, stats = decode_batch_device(frames, materialize=True)
        assert stats["device_frames"] == 12
        for got, want in zip(results, recs):
            assert got == want

    def test_batches_in_one_bucket_reuse_compiled_programs(self):
        """Batches whose stream counts and raw pools differ but fall in
        the same buckets run both kernels and the executor without a new
        trace: lanes, the raw pool and host rows are padded on the host."""
        from zstdsharp_tpu.decode import device_pipeline as dp
        from zstdsharp_tpu.ops import device_fse as df
        from zstdsharp_tpu.ops import device_huf as dh

        r = np.random.default_rng(21)
        p = r.dirichlet(np.ones(40) * 0.5)
        text = [w + (97 + r.choice(40, 8_000, p=p)).astype(np.uint8).tobytes()
                for w in _records(6, 8_000, seed=21)]
        noise = r.integers(0, 256, 3_000, dtype=np.uint8).tobytes()

        def traces():
            return [f._cache_size() for c in (dh._FN_CACHE, df._FN_CACHE,
                                              dp._FUSED_CACHE)
                    for f in c.values()]

        seen = []
        for recs in (text + [noise], text[1:] + [noise[:2_000]]):
            frames = [compress(x, 3) for x in recs]
            plan = plan_batch(frames)
            seen.append((plan.nb.n_huf, plan.nb.n_fse))
            results, stats = decode_batch_device(frames, materialize=True)
            assert results == recs and stats["host_frames"] == 0
            seen.append(traces())
        assert seen[0] != seen[2]        # the batches differ in lanes
        assert seen[3] == seen[1]        # and share every compiled program

    def test_no_d2h_verify(self):
        # The consumer-side check runs on device: upload the expectation,
        # compare there, transfer ONE scalar back.
        recs = _records(6, 16_000, seed=9)
        frames = [compress(x, 3) for x in recs]
        outputs, lengths, host_results = decode_batch_device(frames)
        assert not host_results
        out = outputs[0]
        O = out.shape[1]
        want = np.zeros((out.shape[0], O), np.uint8)
        for k, rec in enumerate(recs):
            want[k, :len(rec)] = np.frombuffer(rec, np.uint8)
        ok = jnp.array_equal(out[:len(recs)] *
                             (jnp.arange(O)[None, :] < lengths[:len(recs), None]),
                             jnp.asarray(want[:len(recs)]))
        assert bool(ok)

    def test_mixed_block_types(self):
        # raw (incompressible), RLE, and compressed frames in one batch
        r = np.random.default_rng(3)
        payloads = [r.integers(0, 256, 5_000, dtype=np.uint8).tobytes(),
                    b"Q" * 30_000,
                    _records(1, 20_000)[0],
                    b"z" * 17,
                    r.integers(0, 256, 100, dtype=np.uint8).tobytes()]
        frames = [compress(x, 6) for x in payloads]
        results, stats = decode_batch_device(frames, materialize=True)
        for got, want in zip(results, payloads):
            assert got == want

    def test_oracle_frames(self):
        # frames produced by libzstd decode identically on device
        recs = _records(8, 12_000, seed=21)
        zc = zstandard.ZstdCompressor(level=9, write_content_size=True)
        frames = [zc.compress(x) for x in recs]
        results, stats = decode_batch_device(frames, materialize=True)
        assert stats["device_frames"] == 8
        for got, want in zip(results, recs):
            assert got == want

    def test_multiblock_now_device_planned(self):
        # r4: multi-block frames run as dependent execution rounds on
        # device instead of host-routing (beyond-cap frames still route)
        big = _records(1, 400_000)[0]
        frames = [compress(big, 3), compress(b"tiny", 1)]
        plan = plan_batch(frames)
        assert 0 not in plan.host_routed
        assert len(plan.mb_frames) == 1
        results, stats = decode_batch_device(frames, materialize=True)
        assert results[0] == big
        assert results[1] == b"tiny"
        assert stats["host_frames"] == 0

    def test_levels_and_dfast_shapes(self):
        recs = _records(4, 30_000, seed=13)
        for lvl in (1, 3, 9, 19):
            frames = [compress(x, lvl) for x in recs]
            results, _ = decode_batch_device(frames, materialize=True)
            assert results == recs


def test_fcs_less_frame_routes_to_host():
    """A valid frame WITHOUT a content-size field (standard streaming
    output) must be host-routed, not planned with out_len=-1 (ADVICE r3
    high: parse_frame_header uses -1, not None, as the unknown-FCS
    sentinel)."""
    import io

    from zstdsharp_tpu.decode.frame import parse_frame_header
    from zstdsharp_tpu.parallel.pipeline import (decompress_data_parallel,
                                                 make_mesh)
    from zstdsharp_tpu.streaming import CompressionStream

    rec = _records(1, 9_000, seed=4)[0]
    sink = io.BytesIO()
    cs = CompressionStream(sink, level=1)
    cs.write(rec)
    cs.close()
    frame = sink.getvalue()
    hdr = parse_frame_header(np.frombuffer(frame, np.uint8))
    assert hdr.frame_content_size is None or hdr.frame_content_size < 0

    plan = plan_batch([frame])
    assert plan.host_routed.get(0) == "no content size"

    results, stats = decode_batch_device([frame], materialize=True)
    assert results[0] == rec
    assert stats["host_frames"] == 1

    sized = compress(_records(1, 8_000, seed=5)[0], 1)
    out = decompress_data_parallel(frame + sized, make_mesh())
    assert out == rec + _records(1, 8_000, seed=5)[0]


class TestDeviceIntegrity:
    """ADVICE r3 medium: the device plane must not silently decode
    corrupt frames — cheap structural checks host-route at plan time, and
    materialize=True verifies the stored content checksum."""

    def test_corrupt_raw_block_size_routes_to_host(self):
        data = np.random.default_rng(3).integers(
            0, 256, 5000, dtype=np.uint8).tobytes()  # incompressible -> raw
        frame = bytearray(compress(data, 1))
        hdr_sz = 0
        from zstdsharp_tpu.decode.frame import parse_frame_header
        hdr = parse_frame_header(np.frombuffer(bytes(frame), np.uint8))
        hdr_sz = hdr.header_size
        bh = int.from_bytes(frame[hdr_sz:hdr_sz + 3], "little")
        assert (bh >> 1) & 3 == 0  # raw block
        # shrink the declared block size: content no longer matches
        bad = (bh & 7) | ((bh >> 3) - 1 << 3)
        frame[hdr_sz:hdr_sz + 3] = bad.to_bytes(3, "little")
        plan = plan_batch([bytes(frame)])
        assert "corrupt" in plan.host_routed.get(0, "")

    def test_truncated_frame_routes_to_host(self):
        rec = _records(1, 20_000, seed=11)[0]
        frame = compress(rec, 5)
        plan = plan_batch([frame[:len(frame) - 3]])
        assert 0 in plan.host_routed

    def test_checksum_mismatch_raises(self):
        from zstdsharp_tpu.errors import ZstdError, ZstdErrorCode

        rec = _records(1, 20_000, seed=13)[0]
        frame = bytearray(compress(rec, 5, checksum=True))
        plan = plan_batch([bytes(frame)])
        assert plan.blocks and plan.blocks[0].checksum >= 0
        # flip a bit in the stored checksum (last 4 bytes of the frame)
        frame[-1] ^= 0x40
        with pytest.raises(ZstdError) as ei:
            decode_batch_device([bytes(frame)], materialize=True)
        assert ei.value.code == ZstdErrorCode.checksum_wrong

    def test_checksum_verified_ok(self):
        rec = _records(1, 20_000, seed=17)[0]
        frame = compress(rec, 5, checksum=True)
        results, stats = decode_batch_device([frame], materialize=True)
        assert stats["device_frames"] == 1
        assert results[0] == rec


class TestWidenedEnvelope:
    """VERDICT r3 item 7: 1-stream Huffman sections and dictionary frames
    decode on device (window rows + dict entropy seeding)."""

    def test_single_stream_huffman_on_device(self):
        rng = np.random.default_rng(61)
        words = [b"alpha ", b"bravo ", b"charlie ", b"delta ", b"echo "]
        small = [b"".join(words[int(i)] for i in rng.integers(0, 5, 60))[:300]
                 for _ in range(6)]
        frames = [zstandard.ZstdCompressor(level=19).compress(r)
                  for r in small]
        plan = plan_batch(frames)
        assert not plan.host_routed
        # at least one lane must be a (single-stream) Huffman section
        assert any(b.lit_kind == 1 and b.huf_seg == b.lit_regen
                   for b in plan.blocks)
        res, stats = decode_batch_device(frames, materialize=True)
        assert res == small
        assert stats["host_frames"] == 0

    def test_dictionary_frames_on_device(self):
        from zstdsharp_tpu.dictionary import parse_dictionary

        rng = np.random.default_rng(62)
        words = [b"alpha ", b"bravo ", b"charlie ", b"delta ", b"echo "]
        def rec(n):
            return b"".join(words[int(i)] for i in rng.integers(0, 5, n))
        samples = [rec(40) for _ in range(300)]
        d = zstandard.train_dictionary(8192, samples)
        pd = parse_dictionary(d.as_bytes())
        recs = [samples[i] * 3 for i in range(8)] + [rec(800) for _ in range(4)]
        for lvl in (1, 3, 19):
            c = zstandard.ZstdCompressor(level=lvl, dict_data=d)
            dframes = [c.compress(r) for r in recs]
            plan = plan_batch(dframes, ddict=pd)
            assert not plan.host_routed, (lvl, plan.host_routed)
            res, stats = decode_batch_device(dframes, materialize=True,
                                             ddict=pd)
            assert res == recs, lvl
            assert stats["host_frames"] == 0

    def test_dict_frames_without_dict_route_to_host(self):
        rng = np.random.default_rng(63)
        data = bytes(rng.integers(97, 110, 500, dtype=np.uint8))
        d = zstandard.train_dictionary(
            2048, [data[i:i + 50] for i in range(0, 450, 25)])
        frame = zstandard.ZstdCompressor(level=3, dict_data=d).compress(data)
        from zstdsharp_tpu.decode.device_pipeline import scan_eligibility
        assert scan_eligibility([frame]).get(0) == "dictionary required"
        assert plan_batch([frame]).host_routed.get(0) == "dictionary required"

    def test_unwrap_many_device_with_dict(self):
        from zstdsharp_tpu.decode.frame import Decompressor

        rng = np.random.default_rng(64)
        words = [b"unwrap ", b"many ", b"device ", b"dict "]
        def rec(n):
            return b"".join(words[int(i)] for i in rng.integers(0, 4, n))
        samples = [rec(30) for _ in range(200)]
        d = zstandard.train_dictionary(4096, samples)
        recs = [rec(150) for _ in range(5)]
        c = zstandard.ZstdCompressor(level=3, dict_data=d)
        frames = [c.compress(r) for r in recs]
        dec = Decompressor()
        dec.load_dictionary(d.as_bytes())
        results, stats = decode_batch_device(
            frames, materialize=True, ddict=dec._dict._parsed)
        assert results == recs


class TestMultiBlockDevice:
    """VERDICT r3 item 7: multi-block frames decode as dependent
    execution rounds (repcode/entropy chains resolved at plan time;
    per-round windows slice the device-resident accumulator)."""

    def _recs(self, seed=82):
        rng = np.random.default_rng(seed)
        words = [b"multi ", b"block ", b"frame ", b"round ", b"window "]
        def rec(n):
            return b"".join(words[int(i)] for i in rng.integers(0, 5, n))
        return rec

    def test_mixed_levels_roundtrip(self):
        rec = self._recs()
        recs = [rec(200_000), rec(600_000), rec(30_000)]
        frames = [zstandard.ZstdCompressor(level=l).compress(r)
                  for r, l in zip(recs, (3, 9, 19))]
        c = zstandard.ZstdCompressor(level=5, write_checksum=True)
        recs.append(rec(120_000))
        frames.append(c.compress(recs[-1]))
        plan = plan_batch(frames)
        assert not plan.host_routed
        assert len(plan.mb_frames) == 4
        res, stats = decode_batch_device(frames, materialize=True)
        assert res == recs
        assert stats == {"device_frames": 4, "host_frames": 0,
                         "devices": [str(jax.devices()[0])]}

    def test_corrupt_mb_checksum_raises(self):
        from zstdsharp_tpu.errors import ZstdError

        rec = self._recs(83)
        data = rec(120_000)
        frame = bytearray(zstandard.ZstdCompressor(
            level=5, write_checksum=True).compress(data))
        frame[-1] ^= 0x10
        with pytest.raises(ZstdError):
            decode_batch_device([bytes(frame)], materialize=True)

    def test_dict_multiblock(self):
        from zstdsharp_tpu.dictionary import parse_dictionary

        rec = self._recs(84)
        samples = [rec(40) for _ in range(200)]
        d = zstandard.train_dictionary(8192, samples)
        pd = parse_dictionary(d.as_bytes())
        drecs = [rec(40_000), rec(90_000)]
        dc = zstandard.ZstdCompressor(level=3, dict_data=d)
        dframes = [dc.compress(r) for r in drecs]
        res, stats = decode_batch_device(dframes, materialize=True, ddict=pd)
        assert res == drecs
        assert stats["host_frames"] == 0

    def test_device_resident_mb_rows(self):
        rec = self._recs(85)
        data = rec(150_000)
        frame = zstandard.ZstdCompressor(level=3).compress(data)
        outs, lens, host = decode_batch_device([frame])
        assert 0 in host and not isinstance(host[0], bytes)
        assert np.asarray(host[0]).tobytes() == data


class TestTableLog12HostRoute:
    """ADVICE r4 high: the device Huffman kernel peeks MAXLOG=11 bits, but
    the format allows tableLog 12.  A crafted (valid) tableLog-12 frame
    must be HOST-routed by both planners and decode correctly end-to-end —
    previously dplane_read_weights accepted it and the lane classifier
    silently dropped the weight-12 symbols."""

    def _tlog12_frame(self):
        from zstdsharp_tpu.encode.frame import _write_frame_header, _block_header
        from zstdsharp_tpu.encode.block import _literals_header
        from zstdsharp_tpu.entropy import huffman
        from zstdsharp_tpu import constants as C

        # minimal canonical chain tree of depth 12: weights 1,1,2,3,...,12
        # (Kraft-complete; libzstd accepts it — verified below)
        weights = np.array([1, 1] + list(range(2, 13)), np.uint8)
        ct = huffman.ctable_from_weights(weights, 12)
        rng = np.random.default_rng(5)
        p = 2.0 ** (weights.astype(np.float64) - 1)
        syms = rng.choice(np.arange(len(weights), dtype=np.uint8),
                          size=1200, p=p / p.sum())
        table = huffman.write_ctable(ct)
        stream = huffman.encode_4x(syms, ct)
        assert stream is not None
        body = table + stream
        lits = _literals_header(C.LiteralsBlockType.COMPRESSED, 2,
                                len(syms), len(body)) + body
        block = lits + b"\x00"  # nbSeq = 0
        bh = _block_header(True, C.BlockType.COMPRESSED, len(block))
        fh = _write_frame_header(len(syms), 19, False, True, 0)
        return fh + bh + block, syms.tobytes()

    def test_host_route_and_correct_decode(self):
        frame, content = self._tlog12_frame()
        # the frame is genuinely valid: the oracle decodes it
        assert zstandard.ZstdDecompressor().decompress(
            frame, max_output_size=len(content)) == content
        from zstdsharp_tpu.decode.frame import decompress as host_dec
        assert host_dec(frame) == content
        plan = plan_batch([frame])
        assert 0 in plan.host_routed, "tableLog-12 frame must host-route"
        results, stats = decode_batch_device([frame], materialize=True)
        assert results[0] == content
        assert stats["host_frames"] == 1

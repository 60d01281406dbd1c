"""Device (ops/ + parallel/) tests on the virtual 8-device CPU mesh."""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp

from zstdsharp_tpu.ops.common import (match_lengths, pack_bits_device,
                                      previous_occurrence, u32_at_every_byte,
                                      u64_at_every_byte, hash4)
from zstdsharp_tpu.ops.matcher import candidate_stage, parse_block
from zstdsharp_tpu.entropy.bitstream import pack_bits


def np_u32view(b):
    out = np.zeros(len(b), np.uint32)
    for k in range(4):
        out[: len(b) - k] |= b[k:].astype(np.uint32) << (8 * k)
    return out


class TestCommon:
    def test_u32_view(self, rng):
        b = rng.integers(0, 256, 100, dtype=np.uint8)
        np.testing.assert_array_equal(np.asarray(u32_at_every_byte(jnp.asarray(b))),
                                      np_u32view(b))

    def test_u64_view(self, rng):
        b = rng.integers(0, 256, 64, dtype=np.uint8)
        v = np.asarray(u64_at_every_byte(jnp.asarray(b)))
        assert v[0] == int.from_bytes(b[:8].tobytes(), "little")
        assert v[10] == int.from_bytes(b[10:18].tobytes(), "little")

    def test_previous_occurrence(self):
        h = jnp.asarray(np.array([5, 3, 5, 5, 3, 9], dtype=np.int32))
        prev = np.asarray(previous_occurrence(h))
        np.testing.assert_array_equal(prev, [-1, -1, 0, 2, 1, -1])

    def test_match_lengths_exact(self, rng):
        base = rng.integers(0, 4, 300, dtype=np.uint8)
        b = np.concatenate([base, base[:200], rng.integers(0, 4, 24, dtype=np.uint8)])
        cand = np.full(len(b), -1, np.int32)
        cand[300] = 0  # block[300:] repeats block[0:]
        ml = np.asarray(match_lengths(jnp.asarray(b), jnp.asarray(cand)))
        # exact lcp computed on host
        lcp = 0
        while 300 + lcp < len(b) and b[lcp] == b[300 + lcp]:
            lcp += 1
        assert ml[300] == lcp

    def test_pack_bits_device_matches_host(self, rng):
        nbits = rng.integers(1, 32, 200).astype(np.uint64)
        values = rng.integers(0, 1 << 31, 200).astype(np.uint64) & ((np.uint64(1) << nbits) - np.uint64(1))
        host = pack_bits(values, nbits)
        words, total = pack_bits_device(jnp.asarray(values), jnp.asarray(nbits),
                                        out_words=(len(host) + 7) // 4 + 2)
        dev = np.asarray(words).view(np.uint8)[: (int(total) + 7) // 8].tobytes()
        assert dev == host


class TestCandidateStage:
    def test_candidates_are_most_recent_match(self, rng):
        data = np.frombuffer(b"abcdXabcdYabcdZ" * 40, dtype=np.uint8).copy()
        ps, cand = jax.jit(lambda b: candidate_stage(b, 12))(jnp.asarray(data))
        ps, cand = np.asarray(ps), np.asarray(cand)
        by_pos = np.empty(len(data), np.int32)
        by_pos[ps] = cand
        # every valid candidate shares its first 4 bytes
        for p in range(len(data) - 4):
            c = by_pos[p]
            if c >= 0:
                assert c < p
                assert bytes(data[c : c + 4]) == bytes(data[p : p + 4])

    def test_parse_block_roundtrip_semantics(self, rng):
        data = (b"the quick brown fox " * 100)[:1600]
        block = np.zeros(2048, np.uint8)
        block[: len(data)] = np.frombuffer(data, np.uint8)
        r = parse_block(jnp.asarray(block), jnp.int32(len(data)), 12, 256)
        starts = np.asarray(r["starts"])
        mls = np.asarray(r["mls"])
        offs = np.asarray(r["offs"])
        for k in range(int(r["nseq"])):
            s, m, o = int(starts[k]), int(mls[k]), int(offs[k])
            assert o > 0 and s - o >= 0
            assert data[s : s + m] == data[s - o : s - o + m]


class TestShardedPipeline:
    def test_dp_roundtrip(self, text_corpus):
        import zstandard

        from zstdsharp_tpu.decode.frame import decompress
        from zstdsharp_tpu.parallel.pipeline import compress_data_parallel, make_mesh

        data = text_corpus[:200_000]
        mesh = make_mesh()
        assert mesh.devices.size == 8
        frame = compress_data_parallel(data, mesh, block_size=1 << 14)
        assert decompress(frame) == data
        assert zstandard.ZstdDecompressor().decompress(
            frame, max_output_size=len(data) + 1) == data

    def test_dp_checksum(self, text_corpus):
        from zstdsharp_tpu.decode.frame import decompress
        from zstdsharp_tpu.parallel.pipeline import compress_data_parallel, make_mesh

        data = text_corpus[:50_000]
        frame = compress_data_parallel(data, make_mesh(), checksum=True,
                                       block_size=1 << 14)
        assert decompress(frame) == data

    def test_dp_decode_all_gather(self, text_corpus):
        """Sharded decode assembles payloads with a mesh all_gather
        (SURVEY §2.7): every device ends holding the full decoded stream,
        cross-checked bit-exact against the host-order join inside the
        pipeline; telemetry records the collective time."""
        from zstdsharp_tpu.encode.frame import compress
        from zstdsharp_tpu.parallel.pipeline import (decompress_data_parallel,
                                                     make_mesh)

        chunks = [text_corpus[i * 1500:(i + 1) * 1500] for i in range(8)]
        stream = b"".join(compress(c, 3) for c in chunks)
        tel: dict = {}
        out = decompress_data_parallel(stream, make_mesh(), telemetry=tel)
        assert out == b"".join(chunks)
        assert tel["device_frames"] == 8
        assert "gather_ms" in tel and len(tel["device_shards"]) >= 2
        # each shard's rows are held by its own one device
        held = [s["devices"] for s in tel["device_shards"]]
        assert all(len(h) == 1 for h in held)
        assert len({h[0] for h in held}) == len(held) == 8

    def test_records_device_shards_on_their_devices(self, text_corpus):
        """compress_records_device reports the devices that hold each
        shard's frame rows: two shards, two devices, frames host-decode."""
        from zstdsharp_tpu.decode.frame import decompress
        from zstdsharp_tpu.parallel.pipeline import (compress_records_device,
                                                     make_mesh)

        records = [text_corpus[i * 3000:(i + 1) * 3000] for i in range(4)]
        mesh = make_mesh(jax.devices()[:2])
        tel: dict = {}
        frames = compress_records_device(records, mesh, telemetry=tel)
        assert [decompress(f) for f in frames] == records
        assert tel["host_frames"] == 0
        assert [s["devices"] for s in tel["device_shards"]] == [
            [str(d)] for d in mesh.devices.flat]

    def test_graft_entry(self):
        import __graft_entry__ as g

        fn, args = g.entry()
        out = jax.jit(fn)(*args)
        assert out["nseq"].shape == (4,)
        g.dryrun_multichip(8)


def test_ldm_anchor_mask_matches_serial_gear():
    """Device LDM anchor scan (ZSTD_ldm_gear_feed role): the windowed
    shifted-add formulation equals the serial rolling hash outside the
    warmup region, and anchor density is ~2^-rate_log."""
    import numpy as np

    from zstdsharp_tpu.ops.ldm import (ldm_anchor_mask,
                                       ldm_anchor_mask_reference)

    rng = np.random.default_rng(5)
    src = rng.integers(0, 256, 50_000, dtype=np.uint8)
    ref = ldm_anchor_mask_reference(src, 7)
    dev = np.asarray(ldm_anchor_mask(jnp.asarray(src), 7))
    assert np.array_equal(ref[6:], dev[6:])
    density = dev[6:].mean()
    assert 0.5 / 128 < density < 2.5 / 128


def test_pipeline_rep_carry_across_blocks():
    """Repcodes persist across blocks in the decoder; the DP pipeline's
    selector must carry them (regression: block starting with a
    distance-1 run after a block ending in a real match)."""
    import zstandard

    from zstdsharp_tpu.decode.frame import decompress
    from zstdsharp_tpu.parallel.pipeline import compress_data_parallel, make_mesh

    r = np.random.default_rng(3)
    block0 = b"hello world pattern " * 100 + bytes(
        r.integers(0, 256, 2096, dtype=np.uint8))
    block1 = b"Z" * 2000 + bytes(r.integers(0, 256, 2096, dtype=np.uint8))
    data = (block0 + block1)[:8192]
    frame = compress_data_parallel(data, make_mesh(), block_size=4096)
    assert decompress(frame) == data
    assert zstandard.ZstdDecompressor().decompress(
        frame, max_output_size=len(data) * 2) == data


def test_framewise_raw_gate_mixed_chunk():
    """A chunk whose HEAD is incompressible noise but whose body is text
    must not be raw-gated wholesale (ADVICE r2 #3: the probe used to look
    only at the first 64KB of a multi-MB chunk).  The framewise DP output
    must stay within 2% of the non-DP compressed size."""
    import zstandard

    from zstdsharp_tpu.encode.frame import compress
    from zstdsharp_tpu.parallel.pipeline import (_compress_framewise_parallel,
                                                 make_mesh)

    r = np.random.default_rng(7)
    noise = bytes(r.integers(0, 256, 1 << 16, dtype=np.uint8))
    words = [b"sequence", b"entropy", b"window", b"the", b"of", b"stream"]
    idx = r.choice(len(words), size=620_000)
    text = b" ".join(words[i] for i in idx)[:3_000_000]
    data = noise + text

    dp = _compress_framewise_parallel(data, make_mesh(), 3, False)
    solo = compress(data, 3)
    import io

    rd = zstandard.ZstdDecompressor().stream_reader(
        io.BytesIO(dp), read_across_frames=True)
    assert rd.read() == data
    assert len(dp) <= len(solo) * 1.02

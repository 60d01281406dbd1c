"""Device Huffman literal decoder (ops/device_huf.py) vs real streams.

The numpy mirror is checked against the host decoder on literal streams
from oracle libzstd frames; the Triton kernel (interpret mode on the CPU,
compiled on a GPU) is checked bit-exactly against the mirror over lane
counts, every length bucket up to 4096, empty streams and mixed tables.
"""

import numpy as np
import pytest

from zstdsharp_tpu.decode.frame import parse_frame_header
from zstdsharp_tpu.entropy import huffman
from zstdsharp_tpu.ops import device_huf as dh

jax = pytest.importorskip("jax")


def extract_literal_streams(frame: bytes):
    """(payloads[4], weights, out_sizes[4], expected[4]) per 4-stream block."""
    hdr = parse_frame_header(np.frombuffer(frame, np.uint8))
    p = hdr.header_size
    res = []
    while True:
        bh = int.from_bytes(frame[p : p + 3], "little")
        last, btype, bsize = bh & 1, (bh >> 1) & 3, bh >> 3
        if btype == 2:
            src = frame[p + 3 : p + 3 + bsize]
            b0 = src[0]
            if (b0 & 3) == 2 and ((b0 >> 2) & 3) in (1, 2, 3):
                fmt = (b0 >> 2) & 3
                if fmt == 1:
                    v = int.from_bytes(src[0:3], "little")
                    regen, comp, h = (v >> 4) & 0x3FF, (v >> 14) & 0x3FF, 3
                elif fmt == 2:
                    v = int.from_bytes(src[0:4], "little")
                    regen, comp, h = (v >> 4) & 0x3FFF, (v >> 18) & 0x3FFF, 4
                else:
                    v = int.from_bytes(src[0:5], "little")
                    regen, comp, h = (v >> 4) & 0x3FFFF, (v >> 22) & 0x3FFFF, 5
                payload = src[h : h + comp]
                weights, tlog, whdr = huffman.read_weights(payload)
                body = payload[whdr:]
                sizes = [int.from_bytes(body[i : i + 2], "little")
                         for i in (0, 2, 4)]
                sizes.append(len(body) - 6 - sum(sizes))
                seg = (regen + 3) // 4
                outs = [seg, seg, seg, regen - 3 * seg]
                pls, off = [], 6
                for s in sizes:
                    pls.append(bytes(body[off : off + s]))
                    off += s
                dt = huffman.build_dtable(weights, tlog)
                exp = [np.asarray(huffman.decode_1x(pl_, dt, osz))
                       for pl_, osz in zip(pls, outs)]
                res.append((pls, weights, outs, exp))
        p += 3 + (1 if btype == 1 else bsize)
        if last:
            break
    return res


@pytest.fixture(scope="module")
def small_batch():
    zstandard = pytest.importorskip("zstandard")
    r = np.random.default_rng(7)
    words = [b"lorem", b"ipsum", b"dolor", b"sit", b"amet"]
    data = b" ".join(words[int(i)] for i in r.integers(0, 5, 20000))
    frame = zstandard.ZstdCompressor(level=9).compress(data)
    blocks = extract_literal_streams(frame)
    assert blocks, "corpus produced no 4-stream literal blocks"
    payloads, wts, nsyms, expected = [], [], [], []
    for pls, weights, outs, exp in blocks:
        for s in range(4):
            payloads.append(pls[s])
            wts.append(weights)
            nsyms.append(outs[s])
            expected.append(exp[s])
    return payloads, wts, nsyms, expected


def _check_rows(rows, nsyms, expected):
    for i, exp in enumerate(expected):
        got = np.asarray(rows[i, : nsyms[i]]).astype(np.uint8)
        assert np.array_equal(got, np.asarray(exp).astype(np.uint8)), i


def test_numpy_reference_matches_host_decoder(small_batch):
    payloads, wts, nsyms, expected = small_batch
    _check_rows(dh.decode_reference(dh.prepare_batch(payloads, wts, nsyms)),
                nsyms, expected)


def test_device_kernel_bit_exact(small_batch):
    payloads, wts, nsyms, expected = small_batch
    out = dh.decode_lanemajor(dh.prepare_batch(payloads, wts, nsyms))
    _check_rows(out, nsyms, expected)


def test_mixed_tables_across_lanes(small_batch):
    """Lanes with different Huffman tables decode independently."""
    import zstandard

    payloads, wts, nsyms, expected = map(list, small_batch)
    r = np.random.default_rng(8)
    data2 = bytes(bytearray(r.integers(97, 110, 30000, dtype=np.uint8)))
    for pls, weights, outs, exp in extract_literal_streams(
            zstandard.ZstdCompressor(level=9).compress(data2)):
        payloads += pls
        wts += [weights] * 4
        nsyms += outs
        expected += exp
    out = dh.decode_lanemajor(dh.prepare_batch(payloads, wts, nsyms))
    _check_rows(out, nsyms, expected)


# ---------------------------------------------------------------------------
# Kernel vs mirror over the launch shapes
# ---------------------------------------------------------------------------


def _synth_streams(n_lanes, n_sym, seed, n_tables=3, empty_every=0):
    """n_lanes Huffman streams of n_sym symbols each (the host encoder),
    cycling through n_tables skewed distributions; every empty_every-th
    lane is an empty stream with nothing to decode."""
    r = np.random.default_rng(seed)
    tables = []
    for _ in range(n_tables):
        n_alpha = int(r.integers(3, 200))
        p = r.dirichlet(np.ones(n_alpha) * float(r.uniform(0.2, 2.0)))
        counts = np.maximum((p * 100_000).astype(np.int64), 1)
        ct = huffman.build_ctable(counts, n_alpha - 1, 11)
        nb = ct.nb_bits.astype(np.int64)
        weights = np.where(nb > 0, ct.table_log + 1 - nb, 0).astype(np.uint8)
        tables.append((p, ct, weights))
    payloads, wts, nsyms, expected = [], [], [], []
    for i in range(n_lanes):
        p, ct, weights = tables[i % n_tables]
        if empty_every and i % empty_every == 0:
            payloads.append(b"")
            nsyms.append(0)
            expected.append(np.zeros(0, np.uint8))
        else:
            n = int(r.integers(max(n_sym // 2, 1), n_sym + 1))
            syms = r.choice(len(p), n, p=p).astype(np.uint8)
            payloads.append(huffman.encode_1x(syms, ct))
            nsyms.append(n)
            expected.append(syms)
        wts.append(weights)
    return payloads, wts, nsyms, expected


# (lanes, symbols per stream, tables, empty_every)
KERNEL_CASES = {
    "lanes1": (1, 200, 1, 0),
    "lanes33": (33, 200, 3, 0),
    "lanes128": (128, 100, 2, 0),
    "lanes1000": (1000, 60, 5, 0),
    "T256": (8, 256, 2, 0),
    "T1024": (8, 1024, 2, 0),
    "T4096": (4, 4096, 2, 0),
    "empty": (40, 150, 2, 3),
    "mixed": (64, 300, 16, 0),
}


@pytest.mark.parametrize("case", sorted(KERNEL_CASES))
def test_kernel_matches_mirror(case):
    """Interpret-mode Triton kernel == numpy mirror, every symbol slot
    (zeros past each stream's count included), and both == the symbols
    the host encoder was given."""
    n_lanes, n_sym, n_tab, empty = KERNEL_CASES[case]
    payloads, wts, nsyms, expected = _synth_streams(
        n_lanes, n_sym, seed=len(case), n_tables=n_tab, empty_every=empty)
    ops = dh.prepare_batch(payloads, wts, nsyms)
    ref = dh.decode_reference(ops)
    _check_rows(ref, nsyms, expected)
    out = np.asarray(dh.decode_lanemajor(ops))
    assert out.shape == (dh.lane_bucket(n_lanes), dh.bucket_t(max(nsyms)))
    assert out.dtype == np.uint8
    assert np.array_equal(out[:n_lanes], ref)
    assert not out[n_lanes:].any()


def test_wrapper_refuses_cpu_without_interpret(small_batch):
    """No silent interpreter: off a GPU the compiled kernel is refused."""
    payloads, wts, nsyms, _ = small_batch
    ops = dh.prepare_batch(payloads[:2], wts[:2], nsyms[:2])
    if jax.default_backend() == "gpu":
        pytest.skip("on a GPU the compiled kernel runs")
    with pytest.raises(RuntimeError, match="interpret=True"):
        dh.decode_lanemajor(ops, interpret=False)


def test_wrapper_pads_lanes_and_length():
    """33 streams launch as 64 lanes (two programs) and come back as 64
    rows, the 31 padding rows empty; the length pads to its bucket with
    zeros past each count."""
    assert dh.lane_bucket(1) == dh.LANES_PER_PROGRAM
    assert dh.lane_bucket(33) == 64
    assert dh.lane_bucket(16384) == 16384
    assert [dh.bucket_t(t) for t in (1, 256, 257, 4096)] == [256, 256, 1024,
                                                             4096]
    payloads, wts, nsyms, expected = _synth_streams(33, 300, seed=5)
    out = np.asarray(dh.decode_lanemajor(dh.prepare_batch(payloads, wts,
                                                          nsyms)))
    assert out.shape == (64, 1024)
    assert not out[33:].any()
    _check_rows(out, nsyms, expected)
    for i, n in enumerate(nsyms):
        assert not out[i, n:].any()


def test_lane_counts_in_one_bucket_share_one_program():
    """33 and 60 streams both launch as 64 lanes through one compiled
    kernel, so a consumer batch of a new size does not recompile."""
    payloads, wts, nsyms, expected = _synth_streams(60, 200, seed=11)
    ops = dh.prepare_batch(payloads, wts, nsyms)
    for n in (60, 33):
        sub = {k: (v[:n] if isinstance(v, np.ndarray) else v)
               for k, v in ops.items()}
        out = np.asarray(dh.decode_lanemajor(sub))
        assert out.shape[0] == 64 and not out[n:].any()
        _check_rows(out, nsyms[:n], expected[:n])
    key = (64, ops["words"].shape[1], dh.bucket_t(ops["t_max"]))
    fns = [f for k, f in dh._FN_CACHE.items() if k[:3] == key]
    assert len(fns) == 1 and fns[0]._cache_size() == 1


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["lanes1000", "T4096", "empty", "mixed"])
def test_compiled_kernel_matches_mirror(gpu, case):
    n_lanes, n_sym, n_tab, empty = KERNEL_CASES[case]
    payloads, wts, nsyms, _ = _synth_streams(
        n_lanes, n_sym, seed=len(case), n_tables=n_tab, empty_every=empty)
    ops = dh.prepare_batch(payloads, wts, nsyms)
    out = np.asarray(dh.decode_lanemajor(ops, interpret=False))
    assert np.array_equal(out[:n_lanes], dh.decode_reference(ops))
    assert not out[n_lanes:].any()

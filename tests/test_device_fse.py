"""Device FSE sequence decoder (ops/device_fse.py) vs real frames.

The numpy mirror is checked against the host decoder — repcode resolution
included — on sequence sections extracted from oracle libzstd frames and
from frames built from hand-placed sequences that hit every repcode case;
the Triton kernel (interpret mode on the CPU, compiled on a GPU) is
checked bit-exactly against the mirror over lane counts, every length
bucket up to 4096, empty lanes and mixed tables.
"""

import numpy as np
import pytest

from zstdsharp_tpu import constants as C
from zstdsharp_tpu.decode.block import (EntropyState, decode_literals,
                                        decode_sequence_headers,
                                        decode_sequences)
from zstdsharp_tpu.decode.frame import parse_frame_header
from zstdsharp_tpu.encode.frame import compress
from zstdsharp_tpu.encode.sequences_api import Sequence, compress_sequences
from zstdsharp_tpu.ops import device_fse as df

jax = pytest.importorskip("jax")


class CodedDT:
    """Adapter exposing the per-state CODE (recovered from value bases)."""

    def __init__(self, dt, kind):
        self.table_log = dt.table_log
        self.new_state = np.asarray(dt.new_state)
        self.nb_bits = np.asarray(dt.nb_bits)
        base = np.asarray(dt.base_value, np.int64)
        if kind == "of":
            self.symbol = np.asarray(dt.nb_add_bits, np.int64)  # code == bits
        elif kind == "ll":
            self.symbol = np.searchsorted(np.asarray(C.LL_BASE, np.int64), base)
        else:
            self.symbol = np.searchsorted(np.asarray(C.ML_BASE, np.int64), base)


def extract_seq_sections(frame: bytes):
    hdr = parse_frame_header(np.frombuffer(frame, np.uint8))
    p = hdr.header_size
    out = []
    ent = EntropyState()
    while True:
        bh = int.from_bytes(frame[p : p + 3], "little")
        last, btype, bsize = bh & 1, (bh >> 1) & 3, bh >> 3
        if btype == 2:
            payload = bytes(frame[p + 3 : p + 3 + bsize])
            lits, n = decode_literals(payload, ent)
            rest = payload[n:]
            nbseq, ll, of, ml, consumed = decode_sequence_headers(rest, ent)
            if nbseq > 0:
                seq_payload = rest[consumed:]
                rep_in = list(ent.rep)
                lls, mls, ofs = decode_sequences(seq_payload, nbseq, ll, of,
                                                 ml, ent.rep)
                out.append((seq_payload,
                            (CodedDT(ll, "ll"), CodedDT(of, "of"),
                             CodedDT(ml, "ml")),
                            nbseq, rep_in, (lls, mls, ofs)))
        p += 3 + (1 if btype == 1 else bsize)
        if last:
            break
    return out


@pytest.fixture(scope="module")
def sections():
    zstandard = pytest.importorskip("zstandard")
    r = np.random.default_rng(17)
    words = [b"red", b"green", b"blue", b"cyan", b"magenta"]
    data = b" ".join(words[int(i)] for i in r.integers(0, 5, 500))
    secs = []
    for lvl in (3, 9):
        frame = zstandard.ZstdCompressor(level=lvl,
                                         write_content_size=True).compress(data)
        secs += extract_seq_sections(frame)
    secs = [s for s in secs if len(s[0]) <= 256 * 4]
    assert secs, "no small sequence sections produced"
    return secs


def _batch(secs):
    return df.prepare_batch([s[0] for s in secs], [s[1] for s in secs],
                            [s[2] for s in secs], [s[3] for s in secs])


def _check(rows, secs):
    lls, mls, ofs = (np.asarray(x) for x in rows)
    for i, (_, _, nb, _, (ell, eml, eof)) in enumerate(secs):
        assert np.array_equal(lls[i, :nb], ell.astype(np.int64)), f"sec {i} ll"
        assert np.array_equal(mls[i, :nb], eml.astype(np.int64)), f"sec {i} ml"
        assert np.array_equal(ofs[i, :nb], eof.astype(np.int64)), f"sec {i} of"


def test_numpy_mirror_matches_host_decoder(sections):
    _check(df.decode_reference(_batch(sections)), sections)


def test_device_kernel_bit_exact(sections):
    _check(df.decode_lanemajor(_batch(sections)), sections)


# ---------------------------------------------------------------------------
# Sections built from hand-placed sequences
# ---------------------------------------------------------------------------


def _repcode_sequences(n_seq: int, seed: int):
    """Sequences over an all-'a' buffer (every offset matches) cycling
    through the repcode cases of ZSTD_decodeSequence — rep0/1/2 with
    literals, rep1/rep2/rep0-1 without — each after a fresh offset, so the
    three history entries stay distinct."""
    r = np.random.default_rng(seed)
    reps = [1, 4, 8]
    seqs = []
    pos = 0
    # (history index or "dec", literal length zero?)
    cases = [(0, False), (1, False), (2, False), (1, True), (2, True),
             ("dec", True)]
    for k in range(n_seq):
        ll = 64 if k == 0 else int(r.integers(1, 20))
        if k % 2 == 0:
            off = int(r.integers(2, 60))
            while off in reps or off == reps[0] - 1:
                off = int(r.integers(2, 60))
        else:
            which, ll0 = cases[(k // 2) % len(cases)]
            ll = 0 if ll0 else ll
            off = reps[0] - 1 if which == "dec" else reps[which]
        ml = int(r.integers(3, 40))
        seqs.append(Sequence(offset=off, lit_length=ll, match_length=ml))
        # the history the decoder keeps (compress_sequences' update)
        if off in reps and not (ll == 0 and off == reps[0]):
            value = reps.index(off) + 1 - (ll == 0)
        elif ll == 0 and reps[0] > 1 and off == reps[0] - 1:
            value = 3
        else:
            value = off + 3
        if value > 3:
            reps = [off, reps[0], reps[1]]
        elif value == 1:
            if ll == 0:
                reps = [reps[1], reps[0], reps[2]]
        else:
            idx = value - 1 + (ll == 0)
            reps = [off, reps[0], reps[2] if idx == 1 else reps[1]]
        pos += ll + ml
    seqs.append(Sequence(offset=0, lit_length=5, match_length=0))
    return seqs, pos + 5


def _crafted_sections(n_seq: int, seed: int):
    seqs, n = _repcode_sequences(n_seq, seed)
    frame = compress_sequences(seqs, b"a" * n)
    return extract_seq_sections(frame)


def test_repcode_cases_mirror_and_kernel():
    """Every repcode branch (keep, swap, rotate, decrement, fresh) as the
    host decoder resolves it, in the mirror and in the kernel."""
    secs = _crafted_sections(700, seed=3)
    assert secs
    ops = _batch(secs)
    _check(df.decode_reference(ops), secs)
    _check(df.decode_lanemajor(ops), secs)


def _lane_sections(n_lanes, n_seq, seed, empty_every=0):
    """n_lanes sections: frames of a few levels from the host encoder
    (mixed tables) plus crafted repcode sections of about n_seq sequences,
    cycled; every empty_every-th lane has no sequences."""
    pool = _crafted_sections(n_seq, seed)
    r = np.random.default_rng(seed)
    words = [b"alpha", b"beta", b"gamma", b"delta", b"epsilon", b"zeta"]
    data = b" ".join(words[int(i)] for i in r.integers(0, 6, n_seq))
    for lvl in (1, 5, 12):
        pool += [s for s in extract_seq_sections(compress(data, lvl))
                 if s[2] <= max(n_seq, 16) and len(s[0]) <= df.MAX_W * 4]
    empty = (b"", pool[0][1], 0, [1, 4, 8],
             (np.zeros(0, np.uint32),) * 3)
    return [empty if empty_every and i % empty_every == 0
            else pool[i % len(pool)] for i in range(n_lanes)]


# (lanes, sequences per crafted section, empty_every)
KERNEL_CASES = {
    "lanes1": (1, 100, 0),
    "lanes33": (33, 100, 0),
    "lanes128": (128, 60, 0),
    "lanes1000": (1000, 40, 0),
    "T256": (8, 250, 0),
    "T1024": (8, 1000, 0),
    "T4096": (4, 4000, 0),
    "empty": (40, 100, 3),
}


@pytest.mark.parametrize("case", sorted(KERNEL_CASES))
def test_kernel_matches_mirror(case):
    """Interpret-mode Triton kernel == numpy mirror in every slot (zeros
    past each lane's count included), and both == the host decoder."""
    n_lanes, n_seq, empty = KERNEL_CASES[case]
    secs = _lane_sections(n_lanes, n_seq, seed=len(case), empty_every=empty)
    ops = _batch(secs)
    ref = df.decode_reference(ops)
    _check(ref, secs)
    out = [np.asarray(x) for x in df.decode_lanemajor(ops)]
    T = df.bucket_t(max(s[2] for s in secs))
    for a, b in zip(out, ref):
        assert a.shape == (df.lane_bucket(n_lanes), T)
        assert np.array_equal(a[:n_lanes], b)
        assert not a[n_lanes:].any()


def test_wrapper_refuses_cpu_without_interpret(sections):
    if jax.default_backend() == "gpu":
        pytest.skip("on a GPU the compiled kernel runs")
    with pytest.raises(RuntimeError, match="interpret=True"):
        df.decode_lanemajor(_batch(sections), interpret=False)


def test_wrapper_pads_lanes_and_length(sections):
    """17 lanes launch and come back as 32 (two programs), the padding
    lanes empty; the length pads to its bucket with zeros."""
    secs = (sections * 17)[:17]
    assert df.lane_bucket(17) == 32
    out = [np.asarray(x) for x in df.decode_lanemajor(_batch(secs))]
    T = df.bucket_t(max(s[2] for s in secs))
    assert all(a.shape == (32, T) and not a[17:].any() for a in out)
    _check(out, secs)
    for i, s in enumerate(secs):
        assert not any(a[i, s[2]:].any() for a in out)


def test_lane_counts_in_one_bucket_share_one_program():
    """20 and 29 lanes both launch as 32 through one compiled kernel, so a
    consumer batch of a new size does not recompile."""
    secs = _lane_sections(29, 60, seed=4)
    ops = _batch(secs)
    for n in (29, 20):
        sub = {k: (v[:n] if isinstance(v, np.ndarray) else v)
               for k, v in ops.items()}
        out = [np.asarray(x) for x in df.decode_lanemajor(sub)]
        assert all(a.shape[0] == 32 and not a[n:].any() for a in out)
        _check(out, secs[:n])
    key = (32, ops["words"].shape[1], df.bucket_t(ops["t_max"]))
    fns = [f for k, f in df._FN_CACHE.items() if k[:3] == key]
    assert len(fns) == 1 and fns[0]._cache_size() == 1


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["lanes1000", "T4096", "empty"])
def test_compiled_kernel_matches_mirror(gpu, case):
    n_lanes, n_seq, empty = KERNEL_CASES[case]
    secs = _lane_sections(n_lanes, n_seq, seed=len(case), empty_every=empty)
    ops = _batch(secs)
    out = df.decode_lanemajor(ops, interpret=False)
    for a, b in zip(out, df.decode_reference(ops)):
        a = np.asarray(a)
        assert np.array_equal(a[:n_lanes], b)
        assert not a[n_lanes:].any()

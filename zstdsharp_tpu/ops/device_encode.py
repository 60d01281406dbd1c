"""Device batch encoder: greedy parse -> FSE/Huffman frame composition.

The data-parallel reformulation of the reference's encode hot loops
(ZSTD_encodeSequences_body role, ZstdCompressSequences.cs:585; literals
run raw in v1, displacing HufCompress.cs:1056 with a ratio trade).  The
backward 3-state interleaved FSE encode is inherently sequential per
stream in the reference; here it becomes data-parallel:

1. every FSE state transition ``state -> stateTable[(state >> nb) + dfs]``
   is, for a fixed symbol, a PERMUTATION of the state set (the defining
   FSE property), so the chain of transitions is a composition of small
   permutation maps;
2. ``jax.lax.associative_scan`` suffix-composes the per-sequence maps in
   log depth (mirroring the pointer-jumping trick the decode plane uses
   in ops/execseq.py), yielding every intermediate encoder state at once;
3. emitted (value, nbits) fields — states interleaved with extra bits in
   the exact order of the host bitwriter (encode/block.py:
   encode_sequences_bitstream) — then collapse to the final bitstream via
   the prefix-scan packer ``pack_bits_device`` (ops/common.py).

Frames produced are fully standard single-segment zstd frames (9-byte
header, one compressed or raw block; fresh, RLE or predefined sequence
tables; Huffman or raw literals) — decodable by libzstd and by this
repo's own host and device decoders.  Offsets are always emitted literal-form (off_base = off + 3);
repcode detection is a ratio refinement, not a validity requirement.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from .. import constants as C
from ..entropy import fse
from .common import pack_bits_device
from .matcher import parse_blocks_ptrjump

MINMATCH = 3  # format minimum (the parse emits >= 4)


# ---------------------------------------------------------------------------
# Host-built constants: predefined encode tables + code LUTs
# ---------------------------------------------------------------------------

_CONST_CACHE: dict = {}


def _tables():
    """Predefined FSE encode tables (RFC8878 defaults) + code LUTs, as
    numpy constants closed over by the jitted encoder."""
    if "t" in _CONST_CACHE:
        return _CONST_CACHE["t"]
    ll = fse.build_ctable(C.LL_DEFAULT_NORM, C.MAX_LL, C.LL_DEFAULT_NORM_LOG)
    ml = fse.build_ctable(C.ML_DEFAULT_NORM, C.MAX_ML, C.ML_DEFAULT_NORM_LOG)
    of = fse.build_ctable(C.OF_DEFAULT_NORM, C.DEFAULT_MAX_OFF,
                          C.OF_DEFAULT_NORM_LOG)

    def pack(ct):
        d = {
            "tlog": int(ct.table_log),
            "dnb": np.asarray(ct.delta_nb_bits, np.int64).astype(np.int32),
            "dfs": np.asarray(ct.delta_find_state, np.int32),
            # state numbers relative to table start (u in [0, TS))
            "st": (np.asarray(ct.state_table, np.int64)
                   - (1 << ct.table_log)).astype(np.int32),
        }
        d["maps"], d["nbs"], d["init"] = _symbol_maps(d)
        return d

    # value -> code LUTs (ZSTD_LLcode/ZSTD_MLcode small-value tables)
    ll_lut = (np.searchsorted(C.LL_BASE, np.arange(64), side="right")
              - 1).astype(np.int32)
    mlv = np.arange(128) + MINMATCH
    ml_lut = (np.searchsorted(C.ML_BASE, mlv, side="right") - 1).astype(np.int32)
    t = {
        "ll": pack(ll), "ml": pack(ml), "of": pack(of),
        "ll_lut": ll_lut, "ml_lut": ml_lut,
        "ll_bits": C.LL_BITS.astype(np.int32),
        "ml_bits": C.ML_BITS.astype(np.int32),
    }
    _CONST_CACHE["t"] = t
    return t


def _symbol_maps(stream):
    """[NSYM, TS] next-state permutation + emitted-bit-count tables and
    the [NSYM] init states: the per-symbol FSE transition precomputed
    over every state, so the device builds its scan operands with one
    row-gather instead of in-kernel arithmetic + table probes."""
    tlog = stream["tlog"]
    TS = 1 << tlog
    dnb = stream["dnb"].astype(np.int64)
    dfs = stream["dfs"].astype(np.int64)
    st = stream["st"].astype(np.int64)
    u = np.arange(TS)[None, :]
    val = TS + u
    nb = (val + dnb[:, None]) >> 16
    nxt = st[np.clip((val >> nb) + dfs[:, None], 0, TS - 1)]
    # FSE_initCState2 per symbol (pure function of the table)
    nb0 = (dnb + (1 << 15)) >> 16
    v0 = (nb0 << 16) - dnb
    init = st[np.clip((v0 >> nb0) + dfs, 0, TS - 1)]
    return nxt.astype(np.int32), nb.astype(np.uint8), init.astype(np.int32)


def _highbit(v):
    """floor(log2(v)) for v >= 1 (int32)."""
    return 31 - jax.lax.clz(jnp.maximum(v.astype(jnp.int32), 1))


def _codes_from_values(ll, mlv, ofb, t):
    """ZSTD_seqToCodes:3069 on device: (litLen, matchLen-3, offBase) ->
    (llCode, mlCode, ofCode)."""
    ll_lut = jnp.asarray(t["ll_lut"])
    ml_lut = jnp.asarray(t["ml_lut"])
    ll_code = jnp.where(ll > 63, _highbit(ll) + 19,
                        jnp.take(ll_lut, jnp.clip(ll, 0, 63)))
    ml_code = jnp.where(mlv > 127, _highbit(mlv) + 36,
                        jnp.take(ml_lut, jnp.clip(mlv, 0, 127)))
    of_code = _highbit(ofb)
    return ll_code, ml_code, of_code


# ---------------------------------------------------------------------------
# FSE state chain via permutation-map suffix composition
# ---------------------------------------------------------------------------


def _fse_stream_states(codes, nseq, stream, tables=None):
    """All encoder states of one FSE stream at once.

    codes: int32 [S] code symbols per sequence (garbage beyond nseq).
    `tables` optionally overrides the predefined encode table with a
    per-lane (dnb, dfs, st) triple of the SAME table log (fresh tables
    are normalized to the default logs so every shape stays static; an
    RLE channel is an all-zero dnb — every emission is zero-width).
    Returns (emit_val [S], emit_nb [S], flush_val []) where slot i holds
    the state bits written when encoding symbol i (zero-width for
    i >= nseq-1: the last symbol initializes without emitting), and
    flush_val is the final tableLog-bit state field.
    """
    S = codes.shape[0]
    tlog = stream["tlog"]
    TS = 1 << tlog
    if tables is None:
        sym_maps = jnp.asarray(stream["maps"])
        sym_nbs = jnp.asarray(stream["nbs"])
        sym_init = jnp.asarray(stream["init"])
    else:
        sym_maps, sym_nbs, sym_init = tables

    i = jnp.arange(S, dtype=jnp.int32)
    c = jnp.clip(codes, 0, sym_maps.shape[0] - 1)

    # init state from the LAST real symbol (FSE_initCState2, host-built)
    c_last = c[jnp.clip(nseq - 1, 0, S - 1)]
    u_init = jnp.take(sym_init, c_last)

    # per-symbol permutation map over u in [0, TS): one row-gather from
    # the precomputed [NSYM, TS] transition tables
    u = jnp.arange(TS, dtype=jnp.int32)[None, :]
    nxt = jnp.take(sym_maps, c, axis=0)
    ident = jnp.broadcast_to(u, (S, TS))
    # steps exist only for i <= nseq-2
    maps = jnp.where((i[:, None] <= nseq - 2), nxt, ident).astype(jnp.int32)

    # Suffix composition comp[i] = M_i o M_{i+1} o ... o M_{S-1}, where
    # (A o B)(x) = B[A(x)] and we need u_all[i] = comp[i][u_init].
    # A flat associative_scan costs O(S*TS*log S) gather traffic; the
    # work-efficient two-level form below is O(S*TS): a G-step serial
    # scan composes within chunks (batched across all chunks at once), a
    # log-depth scan composes the NC chunk composites, and one gather per
    # position reads the state off its chunk's trajectory.
    def compose(a, b):
        return jnp.take_along_axis(b, a, axis=-1)

    G = 64
    S_pad = -(-S // G) * G
    NC = S_pad // G
    maps_p = jnp.concatenate(
        [maps, jnp.broadcast_to(u, (S_pad - S, TS))]) if S_pad > S else maps
    mc = maps_p.reshape(NC, G, TS)

    # within-chunk suffix trajectories: wc[c,g][x] = M_g(M_{g+1}(...(x)))
    # (encode runs back-to-front, so the carry — the later maps' composite
    # — is applied first and M_g gathers at its output)
    def step(carry, m_g):
        out = compose(carry, m_g)
        return out, out

    ident_nc = jnp.broadcast_to(u, (NC, TS)).astype(jnp.int32)
    _, wc_rev = jax.lax.scan(step, ident_nc,
                             jnp.flip(mc.swapaxes(0, 1), 0))
    wc = jnp.flip(wc_rev, 0).swapaxes(0, 1)      # [NC, G, TS]

    # chunk-level suffix composites and per-chunk entry states
    cm = wc[:, 0]                                 # [NC, TS]
    ccomp = jax.lax.associative_scan(compose, cm, reverse=True, axis=0)
    # entry[c] = state entering chunk c from the right (chunks c+1..)
    entry = jnp.concatenate([
        jnp.take_along_axis(
            ccomp[1:], jnp.broadcast_to(u_init, (NC - 1, 1)), axis=-1)[:, 0],
        u_init[None]]) if NC > 1 else u_init[None]

    # state AFTER encoding symbol i: u_i = wc[chunk(i), pos(i)][entry];
    # the emission at step i uses the INCOMING state u_{i+1}
    # (u_all[nseq-1] = u_init since maps beyond nseq-2 are identity)
    u_all = jnp.take_along_axis(
        wc, jnp.broadcast_to(entry[:, None, None], (NC, G, 1)),
        axis=-1)[:, :, 0].reshape(S_pad)[:S]
    u_next = jnp.concatenate([u_all[1:], jnp.zeros(1, jnp.int32)])

    emit_val = TS + u_next
    nb = jnp.take(sym_nbs, c * TS + u_next).astype(jnp.int32)
    emit_nb = jnp.where(i <= nseq - 2, nb, 0)

    flush_val = jnp.where(nseq > 0,
                          jnp.take(u_all, jnp.array(0, jnp.int32)), 0)
    return emit_val, emit_nb, flush_val


# ---------------------------------------------------------------------------
# One-block encode (vmapped across the batch)
# ---------------------------------------------------------------------------


def _encode_lane(block, n_valid, parse, W, t, lit_sorted, lit_count,
                 huf, WQ, seq_tables=None):
    """Compose one frame row from a parsed block.  Returns
    (row uint8 [N+16], out_len int32)."""
    N = block.shape[0]
    S = parse["starts"].shape[0]
    starts = parse["starts"]
    mls = parse["mls"]
    offs = parse["offs"]
    nseq = parse["nseq"]
    h_codes, h_nbits, h_desc, h_dlen, h_ok = huf

    i = jnp.arange(S, dtype=jnp.int32)
    real = i < nseq

    # sequence values
    prev_end = jnp.concatenate(
        [jnp.zeros(1, jnp.int32), (starts + mls)[:-1]])
    ll = jnp.where(real, starts - prev_end, 0)
    mlv = jnp.where(real, mls - MINMATCH, 0)
    # repcode detection: after any sequence with offset o the decoder's
    # rep0 is o, so "same offset as the previous sequence, with literals
    # in between" is exactly Offset_Value 1 (rep0) — zero extra bits.
    # (ll == 0 shifts rep semantics; those emit literal-form offsets.)
    prev_off = jnp.concatenate([jnp.zeros(1, jnp.int32), offs[:-1]])
    rep0 = (i > 0) & (offs == prev_off) & (ll > 0)
    ofb = jnp.where(real, jnp.where(rep0, 1, offs + 3), 1)
    ll_code, ml_code, of_code = _codes_from_values(ll, mlv, ofb, t)

    # FSE state chains (per-lane fresh/RLE/predefined tables)
    if seq_tables is not None:
        of_val, of_nb, of_fin = _fse_stream_states(
            of_code, nseq, t["of"], seq_tables["of"][:3])
        ml_val, ml_nb, ml_fin = _fse_stream_states(
            ml_code, nseq, t["ml"], seq_tables["ml"][:3])
        ll_val, ll_nb, ll_fin = _fse_stream_states(
            ll_code, nseq, t["ll"], seq_tables["ll"][:3])
        fl_ll = seq_tables["ll"][3]
        fl_of = seq_tables["of"][3]
        fl_ml = seq_tables["ml"][3]
        modes = seq_tables["mode"]
        tbl_row = seq_tables["tbl"]
        tbl_len = seq_tables["tbl_len"]
    else:
        of_val, of_nb, of_fin = _fse_stream_states(of_code, nseq, t["of"])
        ml_val, ml_nb, ml_fin = _fse_stream_states(ml_code, nseq, t["ml"])
        ll_val, ll_nb, ll_fin = _fse_stream_states(ll_code, nseq, t["ll"])
        fl_ll = jnp.int32(t["ll"]["tlog"])
        fl_of = jnp.int32(t["of"]["tlog"])
        fl_ml = jnp.int32(t["ml"]["tlog"])
        modes = jnp.int32(0)
        tbl_row = jnp.zeros(1, jnp.uint8)
        tbl_len = jnp.int32(0)

    # extras (value masked by the packer to nbits)
    ll_bits = jnp.take(jnp.asarray(t["ll_bits"]), jnp.clip(ll_code, 0, 35))
    ml_bits = jnp.take(jnp.asarray(t["ml_bits"]), jnp.clip(ml_code, 0, 52))
    ext_ll_nb = jnp.where(real, ll_bits, 0)
    ext_ml_nb = jnp.where(real, ml_bits, 0)
    ext_of_nb = jnp.where(real, of_code, 0)

    # field layout: per sequence i (emitted from i=S-1 down to 0):
    #   [of_state, ml_state, ll_state, ll_extra, ml_extra, of_extra]
    # then [ml_flush, of_flush, ll_flush].  Zero-width pads keep offsets
    # exact (encode/block.py:encode_sequences_bitstream order).
    vals6 = jnp.stack([of_val, ml_val, ll_val, ll, mlv, ofb],
                      axis=1)[::-1].reshape(-1)
    nbs6 = jnp.stack([of_nb, ml_nb, ll_nb, ext_ll_nb, ext_ml_nb, ext_of_nb],
                     axis=1)[::-1].reshape(-1)
    tail_vals = jnp.stack([ml_fin, of_fin, ll_fin])
    tail_nbs = jnp.stack([fl_ml, fl_of, fl_ll]).astype(jnp.int32)
    values = jnp.concatenate([vals6, tail_vals]).astype(jnp.uint32)
    nbits = jnp.concatenate([nbs6, tail_nbs]).astype(jnp.uint32)
    nbits = jnp.where(nseq > 0, nbits, 0)

    words, total_bits = pack_bits_device(values, nbits, W)
    bits_len = ((total_bits + 7) >> 3).astype(jnp.int32)
    bits_bytes = ((words[:, None]
                   >> (8 * jnp.arange(4, dtype=jnp.uint32))[None, :])
                  & 0xFF).astype(jnp.uint8).reshape(-1)

    # ---- Huffman literal section (4-stream, device-packed) ----
    L = lit_count
    seg = jnp.maximum((L + 3) >> 2, 1)
    SEGMAX = lit_sorted.shape[0] // 4 + 1
    tq = jnp.arange(SEGMAX, dtype=jnp.int32)[None, :]
    q = jnp.arange(4, dtype=jnp.int32)[:, None]
    seglen = jnp.where(q < 3, seg, L - 3 * seg)      # [4, 1]
    # symbols consumed back-to-front per quarter (encode_1x order)
    srcpos = q * seg + (seglen - 1 - tq)
    valid_q = tq < seglen
    sym = jnp.take(lit_sorted, jnp.clip(srcpos, 0, lit_sorted.shape[0] - 1))
    hv = jnp.take(h_codes, sym)
    hb = jnp.where(valid_q, jnp.take(h_nbits, sym), 0)
    hwords, htotal = jax.vmap(
        lambda v, nb: pack_bits_device(v, nb.astype(jnp.uint32), WQ))(
        hv.astype(jnp.uint32), hb)
    sl = ((htotal + 7) >> 3).astype(jnp.int32)       # [4] stream bytes
    hbytes = ((hwords[:, :, None]
               >> (8 * jnp.arange(4, dtype=jnp.uint32))[None, None, :])
              & 0xFF).astype(jnp.uint8).reshape(4, -1)
    comp_lit = h_dlen + 6 + jnp.sum(sl)
    use_huf = h_ok & (5 + comp_lit < 3 + L) & (nseq > 0)
    lit_sec = jnp.where(use_huf, 5 + comp_lit, 3 + L)

    # section sizes
    body = lit_sec + 2 + 1 + tbl_len + bits_len  # lits+nbseq+modes+tbls+fse
    comp_total = 12 + body                       # frame hdr 9 + block hdr 3
    raw_total = 12 + n_valid.astype(jnp.int32)
    use_raw = (nseq == 0) | (comp_total >= raw_total)
    out_len = jnp.where(use_raw, raw_total, comp_total)

    # frame header: magic | FHD 0xA0 (single-segment, 4-byte FCS) | FCS32
    fcs = n_valid.astype(jnp.uint32)
    hdr9 = jnp.array([0x28, 0xB5, 0x2F, 0xFD, 0xA0, 0, 0, 0, 0],
                     jnp.uint32).at[5:].set(
        (fcs >> (8 * jnp.arange(4, dtype=jnp.uint32))) & 0xFF)
    bsize = jnp.where(use_raw, n_valid.astype(jnp.int32), body)
    btype = jnp.where(use_raw, 0, 2)
    bh = 1 | (btype << 1) | (bsize << 3)
    bh3 = (bh >> (8 * jnp.arange(3))) & 0xFF
    # raw-literal header (type 0, size_format 3)
    lh = (0 | (3 << 2) | (lit_count << 4)).astype(jnp.uint32)
    lh3 = (lh >> (8 * jnp.arange(3, dtype=jnp.uint32))) & 0xFF
    # compressed-literal header (type 2, size_format 3: 18+18-bit sizes);
    # the 40-bit field  2 | 3<<2 | L<<4 | comp_lit<<22  emitted bytewise
    # in u32 (the encode plane is 32-bit throughout)
    Lu = L.astype(jnp.uint32)
    cu = comp_lit.astype(jnp.uint32)
    hh5 = jnp.stack([
        jnp.uint32(2 | (3 << 2)) | ((Lu & 0xF) << 4),
        (Lu >> 4) & 0xFF,
        ((Lu >> 12) & 0x3F) | ((cu & 0x3) << 6),
        (cu >> 2) & 0xFF,
        (cu >> 10) & 0xFF,
    ]).astype(jnp.uint32)

    # byte-position classifier (variable gathers, all minor-dim takes)
    OUT = N + 16
    j = jnp.arange(OUT, dtype=jnp.int32)
    jb = j - 12
    head = jnp.where(j < 9, jnp.take(hdr9, jnp.clip(j, 0, 8)),
                     jnp.take(bh3, jnp.clip(j - 9, 0, 2)))
    raw_byte = jnp.take(block, jnp.clip(jb, 0, N - 1)).astype(jnp.uint32)
    lit_byte = jnp.take(lit_sorted,
                        jnp.clip(jb - 3, 0, N - 1)).astype(jnp.uint32)
    # raw-literal section byte
    raw_sec = jnp.where(jb < 3, jnp.take(lh3, jnp.clip(jb, 0, 2)), lit_byte)
    # huffman section byte: hdr5 | desc | jump | 4 streams
    c_desc = 5
    c_jump = c_desc + h_dlen
    c_s0 = c_jump + 6
    c_s1 = c_s0 + sl[0]
    c_s2 = c_s1 + sl[1]
    c_s3 = c_s2 + sl[2]
    desc_byte = jnp.take(h_desc, jnp.clip(jb - c_desc, 0,
                                          h_desc.shape[0] - 1))
    jump6 = jnp.stack([sl[0] & 0xFF, sl[0] >> 8, sl[1] & 0xFF, sl[1] >> 8,
                       sl[2] & 0xFF, sl[2] >> 8]).astype(jnp.uint32)
    jump_byte = jnp.take(jump6, jnp.clip(jb - c_jump, 0, 5))
    SB = hbytes.shape[1]
    sb = lambda k, c0: jnp.take(hbytes[k], jnp.clip(jb - c0, 0, SB - 1))
    huf_sec = jnp.where(
        jb < c_desc, jnp.take(hh5, jnp.clip(jb, 0, 4)),
        jnp.where(jb < c_jump, desc_byte.astype(jnp.uint32),
        jnp.where(jb < c_s0, jump_byte,
        jnp.where(jb < c_s1, sb(0, c_s0).astype(jnp.uint32),
        jnp.where(jb < c_s2, sb(1, c_s1).astype(jnp.uint32),
        jnp.where(jb < c_s3, sb(2, c_s2).astype(jnp.uint32),
                  sb(3, c_s3).astype(jnp.uint32)))))))
    lit_sec_byte = jnp.where(use_huf, huf_sec, raw_sec)

    bits_byte = jnp.take(bits_bytes,
                         jnp.clip(jb - 3 - tbl_len - lit_sec, 0,
                                  bits_bytes.shape[0] - 1)).astype(jnp.uint32)
    tbl_byte = jnp.take(tbl_row, jnp.clip(jb - 3 - lit_sec, 0,
                                          tbl_row.shape[0] - 1))
    nbseq_b = jnp.where(jb == lit_sec, 128 + (nseq >> 8),
                        nseq & 0xFF).astype(jnp.uint32)
    compressed = jnp.where(
        jb < lit_sec, lit_sec_byte,
        jnp.where(jb < lit_sec + 2, nbseq_b,
            jnp.where(jb == lit_sec + 2, modes.astype(jnp.uint32),
                jnp.where(jb < lit_sec + 3 + tbl_len,
                          tbl_byte.astype(jnp.uint32), bits_byte))))
    tail = jnp.where(use_raw, raw_byte, compressed)
    row = jnp.where(j < 12, head, tail).astype(jnp.uint8)
    row = jnp.where(j < out_len, row, 0)
    return row, out_len


@partial(jax.jit, static_argnames=("S", "hash_log"))
def _parse_phase(blocks, n_valid, S: int, hash_log: int):
    """Phase A: greedy parse + literal compaction + literal histograms.
    Device arrays stay resident for phase B; only the [B, 256] histogram
    crosses to the host (table building is host-scale work, exactly like
    the decode plane's header planning)."""
    from .histogram import histogram_u8

    nv = n_valid.astype(jnp.int32)
    parsed = parse_blocks_ptrjump(blocks, nv, hash_log, S, 8, 8)
    N = blocks.shape[1]

    def lane(blk, nvl, real_mls, covered, nseq):
        idx = jnp.arange(N, dtype=jnp.int32)
        drop = covered | (idx >= nvl)
        key = drop.astype(jnp.uint32) * jnp.uint32(N) + idx.astype(jnp.uint32)
        _, lit_sorted = jax.lax.sort((key, blk), num_keys=1, is_stable=False)
        i = jnp.arange(real_mls.shape[0], dtype=jnp.int32)
        lit_count = (nvl - jnp.sum(jnp.where(i < nseq, real_mls, 0))
                     ).astype(jnp.int32)
        hist = histogram_u8(lit_sorted,
                            mask=jnp.arange(N, dtype=jnp.int32) < lit_count)
        return lit_sorted, lit_count, hist

    lit_sorted, lit_count, lit_hist = jax.vmap(lane)(
        blocks, nv, parsed["mls"], parsed["covered"], parsed["nseq"])

    # sequence-code histograms (compare-reduce, no scatters)
    t = _tables()

    def code_hists(starts, mls_l, offs_l, ns):
        Sl = starts.shape[0]
        i = jnp.arange(Sl, dtype=jnp.int32)
        real = i < ns
        prev_end = jnp.concatenate(
            [jnp.zeros(1, jnp.int32), (starts + mls_l)[:-1]])
        ll = jnp.where(real, starts - prev_end, 0)
        mlv = jnp.where(real, mls_l - MINMATCH, 0)
        prev_off = jnp.concatenate([jnp.zeros(1, jnp.int32), offs_l[:-1]])
        rep0 = (i > 0) & (offs_l == prev_off) & (ll > 0)
        ofb = jnp.where(real, jnp.where(rep0, 1, offs_l + 3), 1)
        llc, mlc, ofc = _codes_from_values(ll, mlv, ofb, t)

        def hist(c, n_sym):
            sym = jax.lax.broadcasted_iota(jnp.int32, (1, n_sym), 1)
            return jnp.sum((c.reshape(-1, 1) == sym) & real.reshape(-1, 1),
                           axis=0, dtype=jnp.int32)

        return hist(llc, 36), hist(ofc, 32), hist(mlc, 53)

    llh, ofh, mlh = jax.vmap(code_hists)(parsed["starts"], parsed["mls"],
                                         parsed["offs"], parsed["nseq"])
    return parsed, lit_sorted, lit_count, lit_hist, (llh, ofh, mlh)


DESC_MAX = 160   # serialized Huffman table descriptor cap


def _build_lit_tables(lit_hist: np.ndarray, lit_count: np.ndarray):
    """Host middle phase: canonical Huffman tables per lane from device
    histograms (HUF_buildCTable/HUF_writeCTable role).  Returns
    (codes [B,256] u32, nbits [B,256] u32, desc [B,DESC_MAX] u8,
    desc_len [B] i32, huf_ok [B] bool)."""
    from ..entropy import huffman

    B = lit_hist.shape[0]
    codes = np.zeros((B, 256), np.uint32)
    nbits = np.zeros((B, 256), np.uint32)
    desc = np.zeros((B, DESC_MAX), np.uint8)
    desc_len = np.zeros(B, np.int32)
    huf_ok = np.zeros(B, bool)
    for b in range(B):
        n = int(lit_count[b])
        counts = lit_hist[b]
        nz = np.nonzero(counts)[0]
        if n < 64 or len(nz) < 2 or int(counts.max()) >= n:
            continue  # raw/RLE territory
        try:
            ct = huffman.build_ctable(counts, int(nz[-1]), 11)
            d = huffman.write_ctable(ct)
        except Exception:
            continue
        if len(d) > DESC_MAX:
            continue
        codes[b, :ct.max_symbol + 1] = ct.code
        nbits[b, :ct.max_symbol + 1] = ct.nb_bits
        desc[b, :len(d)] = np.frombuffer(d, np.uint8)
        desc_len[b] = len(d)
        huf_ok[b] = True
    return codes, nbits, desc, desc_len, huf_ok


TBL_MAX = 128   # per-lane sequence-tables area cap (3 NCounts)


def _build_seq_tables(hists, nseq: np.ndarray, t):
    """Host middle phase: per-lane FSE tables from device code histograms
    (ZSTD_selectEncodingType + FSE_normalizeCount role, restricted to the
    DEFAULT table logs so every device shape stays static).  Per channel:
    fresh FSE (mode 2) when it pays, RLE (mode 1) for single-symbol
    streams, predefined (mode 0) otherwise."""
    from ..entropy import fse

    chans = (("ll", 0, 35), ("of", 1, 31), ("ml", 2, 52))
    B = nseq.shape[0]
    mode = np.zeros((B, 3), np.int32)
    tbl = np.zeros((B, TBL_MAX), np.uint8)
    tbl_len = np.zeros(B, np.int32)
    out = {}
    for name, ci, max_code in chans:
        st_def = t[name]
        nsym = st_def["dnb"].shape[0]
        TS = 1 << st_def["tlog"]
        maps = np.broadcast_to(st_def["maps"], (B, nsym, TS)).copy()
        nbs = np.broadcast_to(st_def["nbs"], (B, nsym, TS)).copy()
        init = np.broadcast_to(st_def["init"], (B, nsym)).copy()
        flush = np.full(B, st_def["tlog"], np.int32)
        out[name] = (maps, nbs, init, flush)
    for b in range(B):
        n = int(nseq[b])
        if n < 32:
            continue
        parts = []
        ok_modes = [0, 0, 0]
        for name, ci, max_code in chans:
            counts = np.asarray(hists[ci][b], np.int64)
            nz = np.nonzero(counts)[0]
            st_def = _tables()[name]
            if len(nz) == 1:
                ok_modes[ci] = 1
                parts.append(bytes([int(nz[0])]))
                out[name][0][b] = 0      # zero-width channel
                out[name][1][b] = 0
                out[name][2][b] = 0
                out[name][3][b] = 0
                continue
            try:
                max_sym = int(nz[-1])
                tlog = st_def["tlog"]
                norm = fse.normalize_count(counts[:max_sym + 1], tlog,
                                           n, max_sym, False)
                hdr = fse.write_ncount(norm, max_sym, tlog)
                ct = fse.build_ctable(norm, max_sym, tlog)
            except Exception:
                continue
            ok_modes[ci] = 2
            parts.append(hdr)
            fresh = {
                "tlog": tlog,
                "dnb": np.asarray(ct.delta_nb_bits, np.int64).astype(
                    np.int32),
                "dfs": np.asarray(ct.delta_find_state, np.int32),
                "st": (np.asarray(ct.state_table, np.int64)
                       - (1 << tlog)).astype(np.int32),
            }
            fm, fn_, fi = _symbol_maps(fresh)
            out[name][0][b, :max_sym + 1] = fm
            out[name][1][b, :max_sym + 1] = fn_
            out[name][2][b, :max_sym + 1] = fi
        area = b"".join(parts)
        if len(area) > TBL_MAX or all(m == 0 for m in ok_modes):
            # roll back to predefined for this lane
            for name, ci, _mc in chans:
                st_def = _tables()[name]
                out[name][0][b] = st_def["maps"]
                out[name][1][b] = st_def["nbs"]
                out[name][2][b] = st_def["init"]
                out[name][3][b] = st_def["tlog"]
            continue
        # channels that stayed predefined emit nothing in the area
        mode[b] = ok_modes
        tbl[b, :len(area)] = np.frombuffer(area, np.uint8)
        tbl_len[b] = len(area)
    mode_byte = (mode[:, 0] << 6) | (mode[:, 1] << 4) | (mode[:, 2] << 2)
    return out, mode_byte.astype(np.int32), tbl, tbl_len


def encode_frames_device(blocks, n_valid, S: int, W: int,
                         hash_log: int = 15, huf_literals: bool = True):
    """Batched device encode: uint8 [B, N] padded records -> zstd frame
    rows uint8 [B, N+16] + lengths int32 [B].

    Two fused XLA programs: phase A (parse + literal compaction +
    histograms), a host-scale table-build step (Huffman literal tables +
    fresh per-lane FSE sequence tables at the default logs), then phase B
    (FSE state chains, Huffman + FSE bit packing, frame assembly)."""
    t = _tables()
    # The whole encode plane is 32-bit: trace with x64 off so Python ints
    # stay int32 and no op widens to 64 bits (the decode kernels do the
    # same).
    with jax.enable_x64(False):
        parsed, lit_sorted, lit_count, lit_hist, code_hists = _parse_phase(
            blocks, n_valid, S, hash_log)
    B, N = blocks.shape
    if huf_literals:
        ch, nh, dh_, dl, ok = _build_lit_tables(
            np.asarray(lit_hist), np.asarray(lit_count))
    else:
        ch = np.zeros((B, 256), np.uint32)
        nh = np.zeros((B, 256), np.uint32)
        dh_ = np.zeros((B, DESC_MAX), np.uint8)
        dl = np.zeros(B, np.int32)
        ok = np.zeros(B, bool)
    hists_np = tuple(np.asarray(h) for h in code_hists)
    seq_t, mode_byte, tbl, tbl_len = _build_seq_tables(
        hists_np, np.asarray(parsed["nseq"]), t)
    sa = []
    for name in ("ll", "of", "ml"):
        dnb, dfs, stt, flush = seq_t[name]
        sa += [jnp.asarray(dnb), jnp.asarray(dfs), jnp.asarray(stt),
               jnp.asarray(flush)]
    SEGMAX = N // 4 + 1
    WQ = (SEGMAX * 11 + 24) // 32 + 2
    with jax.enable_x64(False):
        return _assembly_phase(
            blocks, n_valid.astype(jnp.int32), parsed["starts"],
            parsed["mls"], parsed["offs"], parsed["nseq"], lit_sorted,
            lit_count, jnp.asarray(ch), jnp.asarray(nh), jnp.asarray(dh_),
            jnp.asarray(dl), jnp.asarray(ok), *sa, jnp.asarray(mode_byte),
            jnp.asarray(tbl), jnp.asarray(tbl_len), S, W, WQ)


@partial(jax.jit, static_argnames=("S", "W", "WQ"))
def _assembly_phase(blocks, nv, starts, mls, offs, nseq, lit_sorted,
                    lit_count, h_codes, h_nbits, h_desc, h_dlen, h_ok,
                    ll_dnb, ll_dfs, ll_st, ll_fl,
                    of_dnb, of_dfs, of_st, of_fl,
                    ml_dnb, ml_dfs, ml_st, ml_fl,
                    mode_byte, tbl, tbl_len,
                    S: int, W: int, WQ: int):
    t = _tables()

    def lane(blk, nvl, st, ml, of, ns, ls, lc, hc, hn, hd, hl, hk,
             a1, a2, a3, a4, b1, b2, b3, b4, c1, c2, c3, c4, mb, tb, tl):
        return _encode_lane(
            blk, nvl, {"starts": st, "mls": ml, "offs": of, "nseq": ns},
            W, t, ls, lc, (hc, hn, hd, hl, hk), WQ,
            seq_tables={"ll": (a1, a2, a3, a4), "of": (b1, b2, b3, b4),
                        "ml": (c1, c2, c3, c4), "mode": mb,
                        "tbl": tb, "tbl_len": tl})

    return jax.vmap(lane)(blocks, nv, starts, mls, offs, nseq,
                          lit_sorted, lit_count, h_codes, h_nbits,
                          h_desc, h_dlen, h_ok,
                          ll_dnb, ll_dfs, ll_st, ll_fl,
                          of_dnb, of_dfs, of_st, of_fl,
                          ml_dnb, ml_dfs, ml_st, ml_fl,
                          mode_byte, tbl, tbl_len)



def seq_budget(n: int) -> int:
    """Max sequences the encoder plans for an n-byte block (word-like
    text emits one match per ~6 bytes; the format ceiling is n/4 — /5
    keeps the cap from truncating real parses into literals)."""
    return max(16, n // 5)


def word_budget(s: int) -> int:
    """Bitstream u32 capacity for S sequences: <= 17 state bits + 49
    extra bits per sequence, + 24 flush/end bits."""
    return (66 * s + 24 + 31) // 32 + 2

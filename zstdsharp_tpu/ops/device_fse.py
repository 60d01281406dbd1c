"""Batched FSE sequence decode on the GPU (Pallas, Triton route).

Device plane for the sequence section (ZSTD_decodeSequence:2360 role):
every device-planned block's sequence bitstream decodes in one kernel
launch, one thread per block.  Each step emits one (litLen, matchLen,
offset) triple per lane and runs the three interleaved FSE state machines
plus the repcode history; a program owns LANES_PER_PROGRAM lanes and runs
the whole sequence loop, so nothing carries between programs.

Per-lane state tables are packed to ONE u32 per entry
(code | next_state << 8 | state_bits << 20); the value bases and extra-bit
counts come from the shared LL/ML tables by code, and the offset base is
arithmetic.  Every table lookup is one direct per-lane load; every bit
field is two direct loads from the lane's row of stream words.

Constraints for the device tier (callers fall back to the host engine):
 - table logs <= 9 (the format maximum for LL/ML; OF <= 8 in practice)
 - offset codes <= 30 (windows beyond 1GB stay on the host)
 - sequence bitstream <= MAX_W words
"""

from __future__ import annotations

import numpy as np

from .pallas_gpu import next_pow2, pad_lanes, resolve_interpret, triton_call

NSTATES = 512          # max LL/ML table size (tlog 9)
NSTATES_OF = 256       # max OF table size (tlog 8)
# Device envelope: sequence-stream words per lane (8KB); longer sections
# host-decode (widening it is ROADMAP R2).
MAX_W = 2048
_T_BUCKETS = (256, 1024, 4096, 16384, 32768)
_W_BUCKETS = (64, 256, 512, 768, 1024, 1536, 2048)
LANES_PER_PROGRAM = 16


def bucket_w(w: int) -> int:
    return next(b for b in _W_BUCKETS if b >= max(w, 2))


def bucket_t(t: int) -> int:
    return next(b for b in _T_BUCKETS if b >= max(t, 1))


def lane_bucket(n: int) -> int:
    return next_pow2(n, LANES_PER_PROGRAM)


def shared_tables() -> np.ndarray:
    """[2, 64] int32: LL then ML (base | extra_bits << 20) by code."""
    from .. import constants as C

    out = np.zeros((2, 64), np.int32)
    for row, (base, bits) in enumerate(((C.LL_BASE, C.LL_BITS),
                                        (C.ML_BASE, C.ML_BITS))):
        v = np.asarray(base, np.int64) | (np.asarray(bits, np.int64) << 20)
        out[row, : len(v)] = v
    return out


def _of_base(ofc):
    """Offset value base by code: (1 << c) - 3 for c >= 2, else c."""
    return np.where(ofc > 1, (np.int64(1) << np.minimum(ofc, 30)) - 3, ofc)


# ---------------------------------------------------------------------------
# Host-side preparation (Python mirror of the native planner's packing)
# ---------------------------------------------------------------------------


def pack_table(dt) -> np.ndarray:
    """Pack an FseDTable (symbol/new_state/nb_bits arrays indexed by state)
    into code|ns<<8|sb<<20 u32 entries.

    The device recovers (value base, extra bits) from the shared tables by
    symbol, so `symbol` here is the CODE (llCode/mlCode/ofCode)."""
    size = 1 << dt.table_log
    out = np.zeros(NSTATES, np.int64)
    sym = dt.symbol.astype(np.int64)
    ns = dt.new_state.astype(np.int64)
    sb = dt.nb_bits.astype(np.int64)
    out[:size] = sym | (ns << 8) | (sb << 20)
    return out


class _BitReader:
    """Backward bit reads over lane-major stream words (all lanes at once),
    the same semantics as the kernel's `read`."""

    def __init__(self, words, pos):
        self.words = words.astype(np.int64) & 0xFFFFFFFF
        self.lane = np.arange(words.shape[0])
        self.pos = pos.astype(np.int64).copy()

    def _word(self, k):
        W = self.words.shape[1]
        return np.where((k >= 0) & (k < W),
                        self.words[self.lane, np.clip(k, 0, W - 1)], 0)

    def read(self, nb):
        p0 = self.pos - nb
        k = p0 >> 5
        sh = p0 & 31
        w0, w1 = self._word(k), self._word(k + 1)
        v = np.where(sh == 0, w0,
                     (w0 >> sh) | ((w1 << (32 - sh)) & 0xFFFFFFFF))
        self.pos = p0
        return v & ((np.int64(1) << nb) - 1)


def prepare_batch(payloads, tables, n_seqs, reps) -> dict:
    """Lane-major operands for len(payloads) blocks (the layout the native
    planner fills; see decode_lanemajor).  tables[i] = (ll_dt, of_dt, ml_dt)
    exposing .symbol/.new_state/.nb_bits/.table_log with symbol = code."""
    n = len(payloads)
    assert n > 0
    wmax = max((len(p) + 3) // 4 for p in payloads)
    if wmax > MAX_W:
        raise ValueError(f"sequence stream too long for device tier: {wmax}")
    words = np.zeros((n, bucket_w(wmax)), dtype=np.uint32)
    pos = np.zeros(n, dtype=np.int64)
    for i, p in enumerate(payloads):
        if not p:
            continue
        b = np.frombuffer(p, dtype=np.uint8)
        pad = (-len(b)) % 4
        if pad:
            b = np.concatenate([b, np.zeros(pad, np.uint8)])
        words[i, : len(b) // 4] = b.view("<u4")
        last = p[-1]
        if last == 0:
            raise ValueError("corrupt stream: zero last byte")
        pos[i] = (len(p) - 1) * 8 + int(last).bit_length() - 1

    ll = np.zeros((n, NSTATES), np.int32)
    of = np.zeros((n, NSTATES_OF), np.int32)
    ml = np.zeros((n, NSTATES), np.int32)
    logs = np.zeros((3, n), np.int64)
    for i in range(n):
        ll_dt, of_dt, ml_dt = tables[i]
        if of_dt.table_log > 8:
            raise ValueError("OF table log > 8 unsupported on device tier")
        ll[i] = pack_table(ll_dt)
        of[i] = pack_table(of_dt)[:NSTATES_OF]
        ml[i] = pack_table(ml_dt)
        logs[:, i] = (ll_dt.table_log, of_dt.table_log, ml_dt.table_log)
    # initial states, LL/OF/ML order (native dplane_fse_states)
    words = words.view(np.int32)
    br = _BitReader(words, pos)
    states = [br.read(logs[j]) for j in range(3)]
    st = np.zeros((n, 8), np.int32)
    st[:, 0] = br.pos
    st[:, 1:4] = np.asarray(reps, np.int64).reshape(n, 3)
    st[:, 4:7] = np.stack(states, axis=1)
    nseq = np.asarray(n_seqs, np.int32).reshape(n)
    return dict(words=words, ll=ll, of=of, ml=ml, st=st, n_seq=nseq,
                t_max=int(nseq.max()))


# ---------------------------------------------------------------------------
# numpy mirror (bit-exact with the kernel)
# ---------------------------------------------------------------------------


def decode_reference(ops: dict):
    """Bit-exact numpy mirror of the kernel: (ll, ml, of) int32 arrays of
    shape [NL, bucket_t(t_max)], zero past each lane's sequence count.

    Repcode resolution is collapsed into one rule: compute the new r0 by
    case (push/dec/rotate/swap/keep); the emitted offset is always the new
    r0 (equivalent to ZSTD_decodeSequence:2360's branches)."""
    st = ops["st"].astype(np.int64)
    NL = st.shape[0]
    lane = np.arange(NL)
    br = _BitReader(ops["words"], st[:, 0])
    r0, r1, r2 = st[:, 1].copy(), st[:, 2].copy(), st[:, 3].copy()
    s_ll, s_of, s_ml = st[:, 4].copy(), st[:, 5].copy(), st[:, 6].copy()
    ll_tab = ops["ll"].astype(np.int64)
    of_tab = ops["of"].astype(np.int64)
    ml_tab = ops["ml"].astype(np.int64)
    llp, mlp = shared_tables().astype(np.int64)
    nseq = ops["n_seq"].astype(np.int64)
    T = bucket_t(ops["t_max"])
    lls = np.zeros((NL, T), np.int32)
    mls = np.zeros((NL, T), np.int32)
    ofs = np.zeros((NL, T), np.int32)
    for t in range(int(nseq.max(initial=0))):
        e_ll = ll_tab[lane, np.clip(s_ll, 0, NSTATES - 1)]
        e_of = of_tab[lane, np.clip(s_of, 0, NSTATES_OF - 1)]
        e_ml = ml_tab[lane, np.clip(s_ml, 0, NSTATES - 1)]
        llpk = llp[np.clip(e_ll & 255, 0, 63)]
        mlpk = mlp[np.clip(e_ml & 255, 0, 63)]
        ll_base, ll_bits = llpk & 0xFFFFF, llpk >> 20
        ml_base, ml_bits = mlpk & 0xFFFFF, mlpk >> 20
        ofc = np.clip(e_of & 255, 0, 31)
        ofv = br.read(ofc)
        big = ofc > 1
        ll0 = (ll_base == 0).astype(np.int64)
        idx = 1 + ll0 + ofv           # meaningful when ofc == 1
        caseA = (~big) & (ofc == 0) & (ll0 == 0)
        swap = (~big) & (((ofc == 0) & (ll0 == 1))
                         | ((ofc == 1) & (idx == 1)))
        rot = (~big) & (ofc == 1) & (idx == 2)
        dec = (~big) & (ofc == 1) & (idx == 3)
        r0n = np.select([big, dec, rot, swap],
                        [_of_base(ofc) + ofv, np.maximum(r0 - 1, 1), r2, r1],
                        r0)
        r1n = np.where(caseA, r1, r0)
        r2n = np.where(caseA | swap, r2, r1)
        r0, r1, r2 = r0n, r1n, r2n
        live = t < nseq
        mls[:, t] = np.where(live, ml_base + br.read(ml_bits), 0)
        lls[:, t] = np.where(live, ll_base + br.read(ll_bits), 0)
        ofs[:, t] = np.where(live, r0, 0)
        s_ll = ((e_ll >> 8) & 4095) + br.read((e_ll >> 20) & 31)
        s_ml = ((e_ml >> 8) & 4095) + br.read((e_ml >> 20) & 31)
        s_of = ((e_of >> 8) & 4095) + br.read((e_of >> 20) & 31)
    return lls, mls, ofs


# ---------------------------------------------------------------------------
# Triton kernel
# ---------------------------------------------------------------------------


def _kernel(words_ref, ll_ref, of_ref, ml_ref, shared_ref, st_ref, nseq_ref,
            ll_out, ml_out, of_out, *, W, T, BL):
    import jax
    import jax.numpy as jnp
    from jax.experimental import pallas as pl

    base = pl.program_id(0) * BL
    blk = pl.ds(base, BL)
    lanes = base + jnp.arange(BL, dtype=jnp.int32)
    nseq = nseq_ref[blk]
    zero_l = jnp.zeros((BL,), jnp.int32)

    def word(k):
        w = words_ref[lanes, jnp.clip(k, 0, W - 1)]
        return jnp.where((k >= 0) & (k < W), w, 0)

    def read(pos, nb):
        p0 = pos - nb
        k = p0 >> 5
        sh = p0 & 31
        w0, w1 = word(k), word(k + 1)
        v = jnp.where(sh == 0, w0,
                      jax.lax.shift_right_logical(w0, sh)
                      | jax.lax.shift_left(w1, (32 - sh) & 31))
        mask = jnp.where(nb >= 32, -1,
                         jax.lax.shift_left(1, jnp.minimum(nb, 31)) - 1)
        return p0, v & mask

    def step(t, carry):
        pos, r0, r1, r2, s_ll, s_of, s_ml = carry
        e_ll = ll_ref[lanes, jnp.clip(s_ll, 0, NSTATES - 1)]
        e_of = of_ref[lanes, jnp.clip(s_of, 0, NSTATES_OF - 1)]
        e_ml = ml_ref[lanes, jnp.clip(s_ml, 0, NSTATES - 1)]
        llpk = shared_ref[zero_l, jnp.clip(e_ll & 255, 0, 63)]
        mlpk = shared_ref[zero_l + 1, jnp.clip(e_ml & 255, 0, 63)]
        ll_base, ll_bits = llpk & 0xFFFFF, llpk >> 20
        ml_base, ml_bits = mlpk & 0xFFFFF, mlpk >> 20
        ofc = jnp.clip(e_of & 255, 0, 31)
        of_base = jnp.where(
            ofc > 1, jax.lax.shift_left(1, jnp.minimum(ofc, 30)) - 3, ofc)
        pos, ofv = read(pos, ofc)
        big = ofc > 1
        ll0 = (ll_base == 0).astype(jnp.int32)
        idx = 1 + ll0 + ofv
        small = jnp.logical_not(big)
        caseA = small & (ofc == 0) & (ll0 == 0)
        swap = small & (((ofc == 0) & (ll0 == 1)) | ((ofc == 1) & (idx == 1)))
        rot = small & (ofc == 1) & (idx == 2)
        dec = small & (ofc == 1) & (idx == 3)
        r0n = jnp.where(big, of_base + ofv,
                        jnp.where(dec, jnp.maximum(r0 - 1, 1),
                                  jnp.where(rot, r2,
                                            jnp.where(swap, r1, r0))))
        r1n = jnp.where(caseA, r1, r0)
        r2n = jnp.where(caseA | swap, r2, r1)
        r0, r1, r2 = r0n, r1n, r2n
        live = t < nseq
        pos, mle = read(pos, ml_bits)
        pos, lle = read(pos, ll_bits)
        ll_out[t, blk] = jnp.where(live, ll_base + lle, 0)
        ml_out[t, blk] = jnp.where(live, ml_base + mle, 0)
        of_out[t, blk] = jnp.where(live, r0, 0)
        pos, b_ll = read(pos, (e_ll >> 20) & 31)
        pos, b_ml = read(pos, (e_ml >> 20) & 31)
        pos, b_of = read(pos, (e_of >> 20) & 31)
        return (pos, r0, r1, r2, ((e_ll >> 8) & 4095) + b_ll,
                ((e_of >> 8) & 4095) + b_of, ((e_ml >> 8) & 4095) + b_ml)

    carry = tuple(st_ref[blk, j] for j in range(7))
    n_hi = jnp.max(nseq)
    jax.lax.fori_loop(0, n_hi, step, carry)

    def clear(t, c):
        for ref in (ll_out, ml_out, of_out):
            ref[t, blk] = zero_l
        return c

    jax.lax.fori_loop(n_hi, T, clear, 0)


_FN_CACHE: dict = {}


def _decode_fn(NL: int, W: int, T: int, interpret: bool):
    """Jitted: lane-major operands for NL lanes -> 3 x [NL, T] int32."""
    key = (NL, W, T, interpret)
    got = _FN_CACHE.get(key)
    if got is not None:
        return got
    import functools

    import jax
    import jax.numpy as jnp

    BL = LANES_PER_PROGRAM
    out = jax.ShapeDtypeStruct((T, NL), jnp.int32)
    call = triton_call(
        functools.partial(_kernel, W=W, T=T, BL=BL), grid=(NL // BL,),
        out_shape=(out, out, out), interpret=interpret, name="fse_decode")
    shared = shared_tables()

    def wrap(words, ll, of, ml, st, nseq):
        res = call(words, ll, of, ml, jnp.asarray(shared), st, nseq)
        return tuple(r.T for r in res)

    fn = jax.jit(wrap)
    _FN_CACHE[key] = fn
    return fn


def decode_lanemajor(ops: dict, interpret: bool | None = None):
    """Decode every lane of `ops` (the native planner's lane-major
    operands, or prepare_batch's): words [n, W] i32, ll [n, 512],
    of [n, 256], ml [n, 512], st [n, 8] (resolved initial state: pos, r0,
    r1, r2, ll, of, ml states), n_seq [n], t_max.  Returns (ll, ml, of)
    int32 device arrays of shape [lane_bucket(n), bucket_t(t_max)]; rows
    from n on are empty lanes (n_seq 0, all zeros)."""
    import jax
    import jax.numpy as jnp

    interpret = resolve_interpret(interpret)
    n, W = ops["words"].shape
    if W > MAX_W:
        raise ValueError(f"stream too long for device tier: {W} > {MAX_W}")
    NL = lane_bucket(n)
    fn = _decode_fn(NL, W, bucket_t(ops["t_max"]), interpret)
    with jax.enable_x64(False):
        return fn(*(jnp.asarray(pad_lanes(ops[k], NL)) for k in (
            "words", "ll", "of", "ml", "st", "n_seq")))

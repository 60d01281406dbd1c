"""Batched Huffman literal decode on the GPU (Pallas, Triton route).

The device plane of the decode pipeline (HufDecompress.cs:342 role): every
Huffman literal stream of a batch (four per 4-stream section, one per
1-stream section) decodes in one kernel launch.  One thread owns one
stream and runs its whole symbol loop; a program owns LANES_PER_PROGRAM
streams, so nothing carries between programs and the grid grows with the
batch until it fills the SMs (4096 frames give 16384 streams).

Per symbol a thread
 - peeks 11 bits below its bit position with two direct loads from its
   own row of stream words (the row stays L1-resident as the position
   walks down it);
 - finds the code-length class by comparing the peek with the stream's
   sorted class limits (canonical-arithmetic decode: O(tableLog) compares
   instead of a 2^tableLog table per stream);
 - loads the class's packed (offset, rank base, shift) word, then the
   symbol of the resulting rank from the stream's permutation.

Operands are lane-major, one row per stream, as the native planner packs
them (native/zstdtpu_core.cpp dplane_pack_huf_lane; `prepare_batch` is its
Python mirror).  The planner stores the rank->symbol permutation as 8
bit-planes of 8 words; the jitted wrapper expands them to one symbol per
rank on the device before the launch.

Stream bit semantics match the host reference exactly (native
huf_decode_stream): bit i of a stream is bit (i&7) of byte (i>>3); initial
position is (len-1)*8 + highbit(last byte); peek reads bits [pos-11, pos),
zeros below bit 0.  Output symbols past a stream's count are 0.
"""

from __future__ import annotations

import numpy as np

from .pallas_gpu import next_pow2, pad_lanes, resolve_interpret, triton_call

MAXLOG = 11
# Device envelope: stream words per lane (8KB).  Longer streams host-decode
# into the literal pool; widening it is ROADMAP R2.
MAX_W = 2048
_W_BUCKETS = (64, 256, 512, 768, 1024, 1536, 2048)
_T_BUCKETS = (256, 1024, 4096, 8192, 16384, 32768)
LANES_PER_PROGRAM = 32


def bucket_w(w: int) -> int:
    return next(b for b in _W_BUCKETS if b >= max(w, 2))


def bucket_t(t: int) -> int:
    return next(b for b in _T_BUCKETS if b >= max(t, 1))


def lane_bucket(n: int) -> int:
    """Kernel lane count for n streams: a power of two, whole programs."""
    return next_pow2(n, LANES_PER_PROGRAM)


# ---------------------------------------------------------------------------
# Host-side preparation (Python mirror of the native planner's packing)
# ---------------------------------------------------------------------------


def canonical_from_weights(weights):
    """(tlog, start[], classbase[], perm[]) from zstd Huffman weights.

    zstd X1 layout (HUF_readDTableX1 role): the 2^tlog peek space is filled
    in weight-ascending order (longest codes at low indexes), symbols in
    symbol order within a weight class.  A peek value v in class w decodes
    with nb = tlog+1-w bits to perm[classbase[w] + ((v - start[w]) >> (w-1))].
    """
    weights = np.asarray(weights, dtype=np.int64)
    total = int((1 << weights[weights > 0]).sum() >> 1)
    tlog = max(int(np.log2(total)) if total else 1, 1)
    start = np.zeros(MAXLOG + 2, dtype=np.int64)
    classbase = np.zeros(MAXLOG + 2, dtype=np.int64)
    perm = np.zeros(256, dtype=np.int64)
    pos = 0
    rank = 0
    for w in range(1, tlog + 1):
        start[w] = pos
        classbase[w] = rank
        syms = np.nonzero(weights == w)[0]
        perm[rank : rank + len(syms)] = syms
        rank += len(syms)
        pos += len(syms) << (w - 1)
    start[tlog + 1 :] = pos
    return tlog, start, classbase, perm


def _lane_tables(weights):
    """(limits[16], bases[16], offs[16], shifts[16], planes[64]) of a table."""
    tlog, start, classbase, perm = canonical_from_weights(weights)
    sc = MAXLOG - tlog
    lim = np.full(16, 1 << MAXLOG, np.int64)
    bas = np.zeros(16, np.int64)
    off = np.zeros(16, np.int64)
    shf = np.zeros(16, np.int64)
    for w in range(1, tlog + 1):
        lim[w - 1] = start[w + 1] << sc
        bas[w - 1] = classbase[w]
        off[w - 1] = start[w] << sc
        shf[w - 1] = (w - 1) + sc
    planes = np.zeros((8, 8), np.uint32)
    for rk in range(256):
        s = int(perm[rk])
        for j in range(8):
            if (s >> j) & 1:
                planes[j, rk >> 5] |= np.uint32(1 << (rk & 31))
    return lim, bas, off, shf, planes.reshape(64).view(np.int32)


def prepare_batch(payloads, weights_per_stream, n_syms) -> dict:
    """Lane-major operands for len(payloads) streams (the layout the native
    planner fills; see decode_lanemajor).  weights_per_stream[i] is the
    weight vector of stream i's table (the four streams of a block pass the
    same vector); an empty payload is a lane with nothing to decode."""
    n = len(payloads)
    assert n > 0
    wmax = bucket_w(max((len(p) + 3) // 4 for p in payloads))
    words = np.zeros((n, wmax), dtype=np.uint32)
    pos = np.zeros(n, dtype=np.int32)
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

    tabs = {k: np.zeros((n, 16), np.int32)
            for k in ("limits", "bases", "offs", "shifts")}
    tabs["limits"][:] = 1 << MAXLOG
    planes = np.zeros((n, 64), np.int32)
    cache = {}
    for i in range(n):
        wkey = np.asarray(weights_per_stream[i], np.uint8).tobytes()
        got = cache.get(wkey)
        if got is None:
            got = cache[wkey] = _lane_tables(weights_per_stream[i])
        for k, v in zip(("limits", "bases", "offs", "shifts"), got[:4]):
            tabs[k][i] = v
        planes[i] = got[4]
    nsym = np.asarray(n_syms, np.int32).reshape(n)
    return dict(words=words.view(np.int32), planes=planes, pos=pos,
                n_sym=nsym, t_max=int(nsym.max()), **tabs)


# ---------------------------------------------------------------------------
# Reference (numpy) implementation of the exact device algorithm
# ---------------------------------------------------------------------------


def _expand_planes(planes: np.ndarray) -> np.ndarray:
    """[NL, 64] bit-planes -> [NL, 256] rank -> symbol."""
    r = np.arange(256)
    pl = planes.astype(np.int64) & 0xFFFFFFFF
    perm = np.zeros((planes.shape[0], 256), np.int64)
    for j in range(8):
        perm |= ((pl[:, j * 8 + (r >> 5)] >> (r & 31)) & 1) << j
    return perm


def decode_reference(ops: dict) -> np.ndarray:
    """Bit-exact numpy mirror of the kernel: [NL, bucket_t(t_max)] int32."""
    words = ops["words"].astype(np.int64) & 0xFFFFFFFF
    NL, W = words.shape
    lane = np.arange(NL)
    limits = ops["limits"].astype(np.int64)
    bases = ops["bases"].astype(np.int64)
    offs = ops["offs"].astype(np.int64)
    shifts = ops["shifts"].astype(np.int64)
    perm = _expand_planes(ops["planes"])
    nsym = ops["n_sym"].astype(np.int64)
    pos = ops["pos"].astype(np.int64).copy()
    out = np.zeros((NL, bucket_t(ops["t_max"])), np.int32)

    def word(k):
        return np.where((k >= 0) & (k < W), words[lane, np.clip(k, 0, W - 1)],
                        0)

    for t in range(int(nsym.max(initial=0))):
        p0 = pos - MAXLOG
        k = p0 >> 5
        sh = p0 & 31
        w0, w1 = word(k), word(k + 1)
        v = np.where(sh == 0, w0, (w0 >> sh) | ((w1 << (32 - sh))
                                                & 0xFFFFFFFF))
        v &= (1 << MAXLOG) - 1
        cls = (v[:, None] >= limits).sum(axis=1)
        shf = shifts[lane, cls]
        rank = np.clip(bases[lane, cls] + ((v - offs[lane, cls]) >> shf),
                       0, 255)
        out[:, t] = np.where(t < nsym, perm[lane, rank], 0)
        pos = pos - (MAXLOG - shf)
    return out


# ---------------------------------------------------------------------------
# Triton kernel
# ---------------------------------------------------------------------------


def _kernel(words_ref, lim_ref, cls_ref, perm_ref, pos_ref, nsym_ref,
            out_ref, *, W, T, BL):
    import jax
    import jax.numpy as jnp
    from jax.experimental import pallas as pl

    base = pl.program_id(0) * BL
    blk = pl.ds(base, BL)
    lanes = base + jnp.arange(BL, dtype=jnp.int32)
    lim = lim_ref[blk, :]                      # [BL, 16] class limits
    nsym = nsym_ref[blk]

    def word(k):
        w = words_ref[lanes, jnp.clip(k, 0, W - 1)]
        return jnp.where((k >= 0) & (k < W), w, 0)

    def step(t, pos):
        p0 = pos - MAXLOG
        k = p0 >> 5
        sh = p0 & 31
        w0, w1 = word(k), word(k + 1)
        v = jnp.where(sh == 0, w0,
                      jax.lax.shift_right_logical(w0, sh)
                      | jax.lax.shift_left(w1, (32 - sh) & 31))
        v = v & ((1 << MAXLOG) - 1)
        cls = jnp.sum((v[:, None] >= lim).astype(jnp.int32), axis=1)
        e = cls_ref[lanes, cls]                # off | base << 12 | shf << 20
        shf = e >> 20
        rank = jnp.clip(((e >> 12) & 0xFF) + ((v - (e & 0xFFF)) >> shf),
                        0, 255)
        sym = perm_ref[lanes, rank]
        out_ref[t, blk] = jnp.where(t < nsym, sym, 0).astype(jnp.uint8)
        return pos - (MAXLOG - shf)

    n_hi = jnp.max(nsym)
    jax.lax.fori_loop(0, n_hi, step, pos_ref[blk])

    def clear(t, c):
        out_ref[t, blk] = jnp.zeros((BL,), jnp.uint8)
        return c

    jax.lax.fori_loop(n_hi, T, clear, 0)


_FN_CACHE: dict = {}


def _decode_fn(NL: int, W: int, T: int, interpret: bool):
    """Jitted: lane-major operands for NL lanes -> [NL, T] uint8 symbols."""
    key = (NL, W, T, interpret)
    got = _FN_CACHE.get(key)
    if got is not None:
        return got
    import functools

    import jax
    import jax.numpy as jnp

    BL = LANES_PER_PROGRAM
    call = triton_call(
        functools.partial(_kernel, W=W, T=T, BL=BL), grid=(NL // BL,),
        out_shape=jax.ShapeDtypeStruct((T, NL), jnp.uint8),
        interpret=interpret, name="huf_decode")

    def wrap(words, limits, bases, offs, shifts, planes, pos, nsym):
        cls = offs | (bases << 12) | (shifts << 20)
        r = jnp.arange(256, dtype=jnp.int32)
        perm = jnp.zeros((NL, 256), jnp.int32)
        for j in range(8):
            perm = perm | (((planes[:, j * 8 + (r >> 5)] >> (r & 31)) & 1)
                           << j)
        return call(words, limits, cls, perm, pos, nsym).T

    fn = jax.jit(wrap)
    _FN_CACHE[key] = fn
    return fn


def decode_lanemajor(ops: dict, interpret: bool | None = None):
    """Decode every stream of `ops` (the native planner's lane-major
    operands, or prepare_batch's): words [n, W] i32, limits/bases/offs/
    shifts [n, 16], planes [n, 64], pos [n], n_sym [n], t_max.  Returns an
    [lane_bucket(n), bucket_t(t_max)] uint8 device array, row l = stream
    l's symbols; rows from n on are empty lanes (all zeros)."""
    import jax
    import jax.numpy as jnp

    interpret = resolve_interpret(interpret)
    n, W = ops["words"].shape
    if W > MAX_W:
        raise ValueError(f"stream too long for device tier: {W} > {MAX_W}")
    NL = lane_bucket(n)
    fn = _decode_fn(NL, W, bucket_t(ops["t_max"]), interpret)
    # padding lanes decode nothing: n_sym 0, and class limits above every
    # peek, as an unused class has
    fill = {"limits": 1 << MAXLOG}
    with jax.enable_x64(False):
        return fn(*(jnp.asarray(pad_lanes(ops[k], NL, fill.get(k, 0)))
                    for k in ("words", "limits", "bases", "offs", "shifts",
                              "planes", "pos", "n_sym")))

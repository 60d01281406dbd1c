"""Device match finder: batched greedy LZ parse over independent blocks.

The data-parallel reformulation of the fast strategy (SURVEY.md §7 step 4c):

1. hash every position (elementwise),
2. previous-occurrence candidates via one stable sort (XLA sort, no serial
   hash table),
3. vectorized LCP extension (geometric probing),
4. greedy selection as a `lax.scan` whose step count is bounded by the max
   sequence count, jumping match-to-match instead of byte-to-byte,
5. per-block outputs as fixed-shape padded arrays (static shapes for jit).

Blocks are parsed independently (window reset at block start) which is what
makes both encode and decode embarrassingly data-parallel across lanes,
cores and chips.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from .common import (hash4, match_lengths, previous_occurrence,
                     u32_at_every_byte, u64_at_every_byte)

MIN_MATCH = 4


@partial(jax.jit, static_argnames=("hash_log", "max_seq"))
def parse_block(block: jax.Array, n_valid: jax.Array, hash_log: int = 16,
                max_seq: int | None = None):
    """Greedy parse of one block (uint8 [N]); n_valid <= N marks real bytes.

    Returns dict with padded arrays:
      starts  int32 [max_seq]  match start positions (N = padding)
      mls     int32 [max_seq]  match lengths
      offs    int32 [max_seq]  match distances
      nseq    int32 []         number of real sequences
      covered bool  [N]        positions covered by matches
    """
    n = block.shape[0]
    if max_seq is None:
        max_seq = n // 8
    idx = jnp.arange(n, dtype=jnp.int32)

    v32 = u32_at_every_byte(block)
    h = hash4(v32, hash_log)
    cand = previous_occurrence(h)
    valid = (cand >= 0) & (v32[jnp.maximum(cand, 0)] == v32) & (idx + MIN_MATCH <= n_valid)
    ml = match_lengths(block, jnp.where(valid, cand, -1))
    ml = jnp.minimum(ml, n_valid - idx)
    valid = valid & (ml >= MIN_MATCH)

    # next_valid[i] = smallest j >= i with valid[j]  (reverse cumulative min)
    cand_pos = jnp.where(valid, idx, n)
    next_valid = jax.lax.associative_scan(jnp.minimum, cand_pos, reverse=True)

    ml_pad = jnp.concatenate([ml, jnp.zeros(1, jnp.int32)])
    off_pad = jnp.concatenate([idx - cand, jnp.zeros(1, jnp.int32)])
    nv_pad = jnp.concatenate([next_valid, jnp.full(1, n, jnp.int32)])

    def step(pos, _):
        j = nv_pad[jnp.minimum(pos, n)]
        take = j < n
        mlj = jnp.where(take, ml_pad[j], 0)
        new_pos = jnp.where(take, j + mlj, n)
        return new_pos, (jnp.where(take, j, n), mlj, jnp.where(take, off_pad[j], 0))

    # Initial carry derives from n_valid so its varying-axis type matches the
    # body output under shard_map (scan-vma rule).
    pos0 = jnp.int32(0) + n_valid.astype(jnp.int32) * 0
    _, (starts, mls, offs) = jax.lax.scan(step, pos0, None, length=max_seq)
    nseq = jnp.sum(starts < n).astype(jnp.int32)

    # Covered mask via +-1 scatter and prefix sum.
    delta = jnp.zeros(n + 1, jnp.int32)
    delta = delta.at[jnp.where(starts < n, starts, n)].add(jnp.where(starts < n, 1, 0))
    ends = jnp.minimum(starts + mls, n)
    delta = delta.at[jnp.where(starts < n, ends, n)].add(jnp.where(starts < n, -1, 0))
    covered = jnp.cumsum(delta[:n]) > 0
    return {"starts": starts, "mls": mls, "offs": offs, "nseq": nseq,
            "covered": covered}


parse_blocks = jax.vmap(parse_block, in_axes=(0, 0, None, None))


def candidate_stage(block: jax.Array, hash_log: int = 16):
    """Gather-free candidate generation (the production device stage).

    Instead of probing a hash table (a gather per position), we sort
    (hash, pos, first-8-bytes) with lax.sort carrying payloads and compare
    ADJACENT rows: the stable sort makes the predecessor within an equal-hash
    run exactly the most recent previous occurrence.

    Returns, in sorted order: positions, their candidate positions, and the
    4-byte-match validity.  The host unsorts with one O(n) scatter and runs
    the serial greedy selection (native hybrid_select).
    """
    n = block.shape[0]
    v32 = u32_at_every_byte(block)
    v64 = u64_at_every_byte(block)
    pos = jnp.arange(n, dtype=jnp.uint32)
    # Pack (hash, pos) into ONE sort key so a plain non-stable single-key
    # sort replaces the stable 3-operand one (the sort dominates the stage).
    # Blocks are <= 128KiB (17 position bits), so hash_log <= 15 packs into
    # u32.
    pos_bits = max(int(n - 1).bit_length(), 1)
    if hash_log + pos_bits <= 32:
        h = hash4(v32, hash_log)
        key = (h.astype(jnp.uint32) << pos_bits) | pos
    else:
        h = hash4(v32, hash_log)
        key = (h.astype(jnp.uint64) << 32) | pos.astype(jnp.uint64)
    ks, vs = jax.lax.sort((key, v64), num_keys=1, is_stable=False)
    ps = (ks & ((1 << pos_bits) - 1) if ks.dtype == jnp.uint32
          else ks & jnp.uint64(0xFFFFFFFF)).astype(jnp.int32)
    hshift = pos_bits if ks.dtype == jnp.uint32 else 32
    prev_v = jnp.concatenate([jnp.zeros(1, jnp.uint64), vs[:-1]])
    same_h = jnp.concatenate(
        [jnp.array([False]), (ks[1:] >> hshift) == (ks[:-1] >> hshift)])
    cand = jnp.concatenate([jnp.full(1, -1, jnp.int32), ps[:-1]])
    match4 = ((vs ^ prev_v) & jnp.uint64(0xFFFFFFFF)) == 0
    valid = same_h & (cand >= 0) & match4
    return ps, jnp.where(valid, cand, -1)


def parse_block_stats(block: jax.Array, n_valid: jax.Array, hash_log: int = 16):
    """Parse + code statistics: the per-block device 'forward step' used by
    the sharded pipeline (histograms feed table selection, sizes feed the
    scheduler).  Everything stays on device."""
    r = parse_block(block, n_valid, hash_log)
    n = block.shape[0]
    real = r["starts"] < n
    lit_count = n_valid - jnp.sum(jnp.where(real, r["mls"], 0))
    match_bytes = jnp.sum(jnp.where(real, r["mls"], 0))
    # Offset-code histogram (highbit of offset+3) for FSE table estimation,
    # via compare-reduce (no scatter).
    ob = jnp.where(real, r["offs"] + 3, 1).astype(jnp.uint32)
    of_code = (31 - jnp.clip(jax.lax.clz(ob), 0, 31)).astype(jnp.int32)
    codes = jax.lax.broadcasted_iota(jnp.int32, (1, 32), 1)
    of_hist = jnp.sum((of_code.reshape(-1, 1) == codes) & real.reshape(-1, 1),
                      axis=0, dtype=jnp.int32)
    # Literal byte histogram over uncovered valid positions.
    from .histogram import histogram_u8

    lit_mask = (~r["covered"]) & (jnp.arange(n) < n_valid)
    lit_hist = histogram_u8(block, mask=lit_mask)
    return {**r, "lit_count": lit_count, "match_bytes": match_bytes,
            "of_hist": of_hist, "lit_hist": lit_hist}


@partial(jax.jit, static_argnames=("hash_log", "max_seq", "ml_u64_rounds",
                                   "ml_stride_rounds"))
def parse_block_ptrjump(block: jax.Array, n_valid: jax.Array,
                        hash_log: int = 16, max_seq: int | None = None,
                        ml_u64_rounds: int = 8, ml_stride_rounds: int = 8):
    """Greedy parse with LOG-DEPTH selection (same contract as
    parse_block).

    The serial cursor walk "next match at-or-after pos, jump past it" is
    an orbit of pos=0 under the jump map f(p) = j + ml[j], j = nv[p].
    Pointer-jumping doubles f (f, f^2, f^4, ...) and marks the orbit in
    ceil(log2(max_seq)) rounds of gather+scatter — the same trick the
    decode plane's LZ executor uses (ops/execseq.py) — replacing
    parse_block's max_seq-step lax.scan, which dominates the device
    encoder's runtime.
    """
    n = block.shape[0]
    if max_seq is None:
        max_seq = n // 8
    idx = jnp.arange(n, dtype=jnp.int32)

    v32 = u32_at_every_byte(block)
    h = hash4(v32, hash_log)
    cand = previous_occurrence(h)
    valid = (cand >= 0) & (v32[jnp.maximum(cand, 0)] == v32) & (idx + MIN_MATCH <= n_valid)
    # Capped extension: a match longer than the cap is simply emitted as
    # chained sequences (the cursor re-enters the run) — a deliberate
    # throughput/ratio trade for the device encoder.
    ml = match_lengths(block, jnp.where(valid, cand, -1),
                       u64_rounds=ml_u64_rounds,
                       stride_rounds=ml_stride_rounds)
    ml = jnp.minimum(ml, n_valid - idx)
    valid = valid & (ml >= MIN_MATCH)

    cand_pos = jnp.where(valid, idx, n)
    next_valid = jax.lax.associative_scan(jnp.minimum, cand_pos, reverse=True)

    nv_pad = jnp.concatenate([next_valid, jnp.full(1, n, jnp.int32)])
    ml_pad = jnp.concatenate([ml, jnp.zeros(1, jnp.int32)])

    j = nv_pad                                   # match chosen at cursor p
    f = jnp.where(j < n, jnp.minimum(j + ml_pad[jnp.clip(j, 0, n)], n), n)

    # orbit of cursor 0: R <- R | f^(2^k)(R), doubling f each round
    orbit = jnp.zeros(n + 1, jnp.int32).at[0].set(1)
    fk = f
    levels = max(1, (max_seq + 1).bit_length())
    for _ in range(levels):
        orbit = jnp.maximum(orbit, jnp.zeros(n + 1, jnp.int32)
                            .at[fk].max(orbit, mode="drop"))
        fk = fk[fk]

    # selected match starts = nv of orbit cursors (distinct by progress)
    take = (orbit > 0) & (j < n)
    sel = jnp.zeros(n + 1, jnp.int32).at[jnp.where(take, j, n)].max(
        take.astype(jnp.int32), mode="drop")[:n]
    nseq_all = jnp.sum(sel)
    nseq = jnp.minimum(nseq_all, max_seq).astype(jnp.int32)

    # compact selected positions in order via one sort
    key = jnp.where(sel > 0, idx, n + idx).astype(jnp.int32)
    sorted_idx = jax.lax.sort(key)[:max_seq]
    k = jnp.arange(max_seq, dtype=jnp.int32)
    starts = jnp.where(k < nseq, sorted_idx, n)
    sc = jnp.clip(starts, 0, n - 1)
    mls = jnp.where(k < nseq, ml[sc], 0)
    offs = jnp.where(k < nseq, idx[sc] - cand[sc], 0)

    delta = jnp.zeros(n + 1, jnp.int32)
    delta = delta.at[jnp.where(starts < n, starts, n)].add(
        jnp.where(starts < n, 1, 0))
    ends = jnp.minimum(starts + mls, n)
    delta = delta.at[jnp.where(starts < n, ends, n)].add(
        jnp.where(starts < n, -1, 0))
    covered = jnp.cumsum(delta[:n]) > 0
    return {"starts": starts, "mls": mls, "offs": offs, "nseq": nseq,
            "covered": covered}


parse_blocks_ptrjump = jax.vmap(parse_block_ptrjump,
                                in_axes=(0, 0, None, None, None, None))

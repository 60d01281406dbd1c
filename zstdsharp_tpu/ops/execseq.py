"""On-device LZ sequence execution (ZSTD_execSequence:2187 role).

The serial window dependency of LZ reconstruction is reformulated as a
data-parallel three-stage pipeline (SURVEY.md
§2.2 "parallel prefix over output positions + segmented gather"; see
PAPERS.md "Massively-Parallel Lossless Data Decompression"):

1. **Segment layout** (prefix sums): each sequence contributes a literal
   run then a match run; exclusive scans over (ll, ml) give every run's
   output start, so every output byte's SOURCE is computable
   independently: a literal index, a window byte, or an EARLIER OUTPUT
   position (match body).
2. **Pointer jumping**: match bytes referencing unresolved output
   positions chase their source with log2(out_len) batched gathers —
   round t resolves chains of depth 2^t, so even a fully overlapping
   RLE-style match (offset 1, length 64K) settles in ~16 rounds.
3. **Final gather** from the concatenated (literals ‖ window) pool.

Everything is static-shaped and jit-compiled once per (B, S, L, W, O)
bucket; batching B independent blocks per call is where the device's
parallelism goes.  Overlap semantics (offset < length) fall out byte-exactly because
resolution follows the byte-level definition, not memcpy order.
"""

from __future__ import annotations

import numpy as np

import os

_SEG_MODE = os.environ.get("ZT_EXEC_SEG", "search")


def _mods():
    import jax
    import jax.numpy as jnp

    return jax, jnp


def make_executor(B: int, S: int, L: int, W: int, O: int):
    """Build the jitted executor for one static shape bucket.

    Returns run(lit, window, ll, ml, off, n_seq, last_lit, out_len) ->
    uint8 [B, O] outputs (bytes beyond out_len[b] are zero).
    """
    jax, jnp = _mods()

    def run(lit, window, ll, ml, off, n_seq, last_lit, out_len):
        seq_idx = jnp.arange(S + 1, dtype=jnp.int32)[None, :]
        live = seq_idx < n_seq[:, None]  # [B, S+1]

        # extend by one trailing pseudo-sequence carrying the last literals
        ll_e = jnp.where(live, jnp.pad(ll, ((0, 0), (0, 1))), 0)
        ml_e = jnp.where(live, jnp.pad(ml, ((0, 0), (0, 1))), 0)
        off_e = jnp.where(live, jnp.pad(off, ((0, 0), (0, 1))), 1)
        tail = seq_idx == n_seq[:, None]
        ll_e = jnp.where(tail, last_lit[:, None], ll_e).astype(jnp.int32)
        ml_e = ml_e.astype(jnp.int32)
        off_e = jnp.maximum(off_e.astype(jnp.int32), 1)

        size = ll_e + ml_e
        run_start = jnp.cumsum(size, axis=1) - size       # [B, S+1] excl.
        match_start = run_start + ll_e
        lit_before = jnp.cumsum(ll_e, axis=1) - ll_e      # literal prefix

        # segment id per output byte.  Two interchangeable lowerings
        # (ZT_EXEC_SEG=scatter picks the second):
        #   - vectorized binary search for the last run_start <= pos
        #     (gathers only, log2(S) rounds)
        #   - scatter run-start marks + prefix sum (1 scatter + 1 cumsum)
        pos_row = jnp.arange(O, dtype=jnp.int32)
        pos = pos_row[None, :]
        if _SEG_MODE == "scatter":
            marks = jnp.zeros((B, O + 1), jnp.int32)
            at = jnp.where(live | tail, jnp.minimum(run_start, O), O)
            marks = jax.vmap(lambda m, idx: m.at[idx].add(1))(marks, at)
            seg = jnp.clip(jnp.cumsum(marks[:, :O], axis=1) - 1, 0, S)
        else:
            dead_start = jnp.where(live | tail, run_start, jnp.int32(2**30))
            lo = jnp.zeros((B, O), jnp.int32)
            hi = jnp.full((B, O), S, jnp.int32)  # inclusive range [lo, hi]
            for _ in range(int(np.ceil(np.log2(S + 2))) + 1):
                mid = (lo + hi + 1) >> 1
                v = jnp.take_along_axis(dead_start, mid, axis=1)
                right = v <= pos
                lo = jnp.where(right, mid, lo)
                hi = jnp.where(right, hi, mid - 1)
            seg = jnp.clip(lo, 0, S)

        g = lambda a: jnp.take_along_axis(a, seg, axis=1)
        s_run = g(run_start)
        s_match = g(match_start)
        s_lit0 = g(lit_before)
        s_off = g(off_e)

        in_lit = pos < s_match
        # literal byte -> resolved pool index [0, L)
        lit_ref = -(1 + s_lit0 + (pos - s_run))
        # match byte -> source position.  Self-overlapping matches
        # (offset < span) are collapsed analytically: the whole periodic
        # run reads from the window [start - off, start), so no chain ever
        # walks WITHIN a segment (this is what makes RLE-style runs O(1)
        # instead of O(log run) jump rounds).
        j = pos - s_off
        j = jnp.where(j >= s_match,
                      s_match - s_off + ((pos - s_match) % s_off), j)
        win_ref = -(1 + L + (W + j))                      # j < 0: resolved
        src = jnp.where(in_lit, lit_ref, jnp.where(j >= 0, j, win_ref))
        src = jnp.where(pos < out_len[:, None], src, lit_ref)

        # pointer jumping with early exit: each round, unresolved bytes
        # adopt their source's mapping; chains cross at least one segment
        # boundary per hop, so typical depth is the match-nesting depth.
        def unresolved(state):
            _, any_left = state
            return any_left

        def jump(state):
            s, _ = state
            tgt = jnp.take_along_axis(s, jnp.maximum(s, 0), axis=1)
            s = jnp.where(s >= 0, tgt, s)
            return s, jnp.any(s >= 0)

        src, _ = jax.lax.while_loop(unresolved, jump,
                                    (src, jnp.array(True)))

        pool = jnp.concatenate([lit, window], axis=1)     # [B, L+W]
        idx = jnp.clip(-src - 1, 0, L + W - 1)
        out = jnp.take_along_axis(pool, idx, axis=1)
        return jnp.where(pos < out_len[:, None], out, 0).astype(jnp.uint8)

    return jax.jit(run)


_EXEC_CACHE: dict = {}


def get_executor(B: int, S: int, L: int, W: int, O: int):
    key = (B, S, L, W, O)
    if key not in _EXEC_CACHE:
        _EXEC_CACHE[key] = make_executor(B, S, L, W, O)
    return _EXEC_CACHE[key]

"""Device-side primitives shared by the device kernels.

Everything here is shape-static, jit-friendly jnp code: u32 window views,
multiplicative hashes (ZSTD_hash4, ZstdCompressInternal.cs:340), and the
prefix-scan bit packer (the data-parallel reformulation of BIT_addBits,
SURVEY.md §7).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

HASH4_PRIME = jnp.uint32(2654435761)


def u32_at_every_byte(block: jax.Array) -> jax.Array:
    """Little-endian u32 read at each byte position of a uint8 vector.

    block: uint8 [N] -> uint32 [N] (last 3 lanes wrap-pad with zeros).
    """
    b = block.astype(jnp.uint32)
    z = jnp.zeros(3, dtype=jnp.uint32)
    b0 = b
    b1 = jnp.concatenate([b[1:], z[:1]])
    b2 = jnp.concatenate([b[2:], z[:2]])
    b3 = jnp.concatenate([b[3:], z[:3]])
    return b0 | (b1 << 8) | (b2 << 16) | (b3 << 24)


def hash4(v32: jax.Array, hash_log: int) -> jax.Array:
    """ZSTD-style multiplicative hash into 2^hash_log buckets."""
    return ((v32 * HASH4_PRIME) >> jnp.uint32(32 - hash_log)).astype(jnp.int32)


def previous_occurrence(h: jax.Array, valid: jax.Array | None = None) -> jax.Array:
    """For each position i, the most recent j < i with h[j] == h[i]; -1 if none.

    Device formulation of the fast matcher's hash-table probe: a stable sort
    on (h, i) makes equal-hash runs adjacent so the predecessor within a run
    is the previous occurrence.  O(n log n) on-device, no serial table.
    """
    n = h.shape[0]
    idx = jnp.arange(n, dtype=jnp.int32)
    order = jnp.argsort(h, stable=True).astype(jnp.int32)  # ties keep position order
    h_sorted = h[order]
    prev_sorted = jnp.where(
        jnp.concatenate([jnp.array([False]), h_sorted[1:] == h_sorted[:-1]]),
        jnp.concatenate([jnp.array([-1], dtype=jnp.int32), order[:-1]]),
        jnp.int32(-1),
    )
    prev = jnp.zeros(n, dtype=jnp.int32).at[order].set(prev_sorted)
    if valid is not None:
        prev = jnp.where(valid, prev, -1)
    return prev


def u64_at_every_byte(block: jax.Array) -> jax.Array:
    """Little-endian u64 read at each byte position (zero padding past end)."""
    v32 = u32_at_every_byte(block).astype(jnp.uint64)
    hi = jnp.concatenate([v32[4:], jnp.zeros(4, jnp.uint64)])
    return v32 | (hi << 32)


def _ctz32(x: jax.Array) -> jax.Array:
    """Count trailing zeros of uint32 (32 for x == 0)."""
    low = x & (jnp.uint32(0) - x)
    return jnp.where(x == 0, jnp.int32(32),
                     jnp.int32(31) - jax.lax.clz(low).astype(jnp.int32))


def match_lengths(block: jax.Array, cand: jax.Array,
                  u64_rounds: int = 16, stride_rounds: int = 24) -> jax.Array:
    """Vectorized LCP of block[i:] vs block[cand[i]:] for all i at once.

    O(rounds * N) with no [N, width] intermediates: 8-byte XOR+ctz stepping
    (up to 8*u64_rounds bytes), then exact 64-byte stride jumps for long
    matches (up to +64*stride_rounds), then an 8-byte refinement.  Overreads
    past the valid region are clamped by the caller (clamped reads can only
    mis-estimate into territory the caller's n-idx clamp cuts off, or
    UNDERestimate — both keep every counted byte genuinely equal).

    All arithmetic is uint32 (an 8-byte step = a u32 pair), so the stage
    traces without x64 mode and every lane op stays 32 bits wide.
    """
    n = block.shape[0]
    idx = jnp.arange(n, dtype=jnp.int32)
    v32 = u32_at_every_byte(block)
    cap = n - 1
    j = jnp.maximum(cand, 0)

    def u64_phase(state, rounds):
        def body(_, st):
            length, active = st
            x0 = (v32[jnp.minimum(idx + length, cap)]
                  ^ v32[jnp.minimum(j + length, cap)])
            x1 = (v32[jnp.minimum(idx + length + 4, cap)]
                  ^ v32[jnp.minimum(j + length + 4, cap)])
            step = jnp.where(x0 != 0, _ctz32(x0) >> 3,
                             4 + jnp.minimum(_ctz32(x1) >> 3, 4))
            length = jnp.where(active, length + step, length)
            active = active & (x0 == 0) & (x1 == 0)
            return length, active

        return jax.lax.fori_loop(0, rounds, body, state)

    # Derive the initial carry from varying inputs (shard_map scan-vma rule).
    length = cand * 0
    active = cand >= 0
    length, active = u64_phase((length, active), u64_rounds)

    if stride_rounds:
        def stride_body(_, st):
            length, active = st
            eq = active
            for k in range(0, 64, 4):
                a = v32[jnp.minimum(idx + length + k, cap)]
                b = v32[jnp.minimum(j + length + k, cap)]
                eq = eq & (a == b)
            length = jnp.where(eq, length + 64, length)
            return length, active & eq

        length, active = jax.lax.fori_loop(
            0, stride_rounds, stride_body, (length, active))
        # Refine the sub-64 tail after the last full stride.
        length, active = u64_phase((length, active | (cand >= 0)), 8)

    return jnp.minimum(jnp.where(cand >= 0, length, 0), n - idx)


def pack_bits_device(values: jax.Array, nbits: jax.Array,
                     out_words: int) -> tuple[jax.Array, jax.Array]:
    """Prefix-scan bit packer on device (bitstream.pack_bits equivalent).

    Fields must be <= 31 bits (every zstd field is: huffman codes <= 12,
    FSE states <= 15, extra bits <= 31).  Returns (words uint32[out_words]
    little-endian, total_bits incl. end mark).  Bit ranges are disjoint by
    construction, so scatter-add realizes scatter-OR with no carries.

    Pure uint32: a field at bit offset o spans words o>>5 and (o>>5)+1,
    whose halves are (v << s) in u32 and v >> (32-s) — the latter written
    as two shifts so s = 0 stays defined.  No u64 anywhere (u64 would
    force x64 tracing mode and double every lane op's width).
    """
    nbits32 = nbits.astype(jnp.uint32)
    v = values.astype(jnp.uint32) & ((jnp.uint32(1) << nbits32) - jnp.uint32(1))
    end = jnp.cumsum(nbits32)
    offsets = end - nbits32
    total = (end[-1] if nbits32.shape[0] else jnp.uint32(0)) + jnp.uint32(1)

    widx = (offsets >> 5).astype(jnp.int32)
    s = offsets & jnp.uint32(31)
    w_lo = v << s
    w_hi = (v >> (jnp.uint32(31) - s)) >> jnp.uint32(1)
    words = jnp.zeros(out_words, dtype=jnp.uint32)
    words = words.at[widx].add(w_lo, mode="drop")
    words = words.at[widx + 1].add(w_hi, mode="drop")
    # End mark bit.
    words = words.at[((total - 1) >> 5).astype(jnp.int32)].add(
        jnp.uint32(1) << ((total - 1) & jnp.uint32(31)), mode="drop")
    return words, total

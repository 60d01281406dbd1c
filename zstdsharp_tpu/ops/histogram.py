"""Byte histograms on the device (HIST_count_parallel_wksp role,
Hist.cs:67), as a compare-against-iota + reduce that XLA fuses into one
dense pass.  Whether a scatter-add form is faster on the GPU is an open
question (ROADMAP §3)."""

from __future__ import annotations

import jax
import jax.numpy as jnp


def histogram_u8(data: jax.Array, mask: jax.Array | None = None) -> jax.Array:
    """counts[256] via compare-reduce; `mask` optionally gates positions."""
    syms = jax.lax.broadcasted_iota(jnp.int32, (1, 256), 1)
    d = data.astype(jnp.int32).reshape(-1, 1)
    eq = (d == syms)
    if mask is not None:
        eq = eq & mask.reshape(-1, 1)
    return jnp.sum(eq, axis=0, dtype=jnp.int32)

"""Device LDM anchor scan (ZSTD_ldm_gear_feed, ZstdLdm.cs:84 role).

The gear rolling hash is h_i = 2*h_{i-1} + gear(src_i); the LDM split
predicate tests (h_i & (2^r - 1)) == 0.  Because gear(.)<<k has zero low-k
bits, bit b < r of h_i receives contributions (including carries) only from
the last r bytes:

    h_i mod 2^r  ==  (sum_{k=0}^{r-1} gear(src_{i-k}) << k) mod 2^r

so the serial recurrence collapses to r shifted adds.

Design note: anchor placement is internal to the encoder (only the emitted
sequences reach the wire), so instead of zstd's random 256-entry table --
whose lookup is a per-byte gather -- this framework defines gear()
ARITHMETICALLY:

    gear(b) = (((b + 1) * 0x9E3779B1) mod 2^32) >> 12, masked to r+8 bits

making the whole scan branch-free elementwise arithmetic that XLA fuses into a
single elementwise kernel; the native engine (native/zstdtpu_core.cpp:
ldm_init) computes the same function, so device anchors equal host anchors
bit-for-bit.  Multiplicative hashing gives the ~2^-r split probability the
LDM needs; match QUALITY is unaffected because candidates are verified
byte-for-byte downstream.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

DEFAULT_RATE_LOG = 7   # native ldm_scan default (splits every ~128 bytes)
GEAR_MULT = 0x9E3779B1
GEAR_SHIFT = 12


def _gear_values(b: jax.Array, rate_log: int) -> jax.Array:
    """gear(b) in int32 (values < 2^(rate_log+8): exact through the adds)."""
    v = (b.astype(jnp.uint32) + jnp.uint32(1)) * jnp.uint32(GEAR_MULT)
    v = (v >> GEAR_SHIFT) & jnp.uint32((1 << (rate_log + 8)) - 1)
    return v.astype(jnp.int32)


@partial(jax.jit, static_argnames=("rate_log",))
def ldm_anchor_mask(src: jax.Array, rate_log: int = DEFAULT_RATE_LOG) -> jax.Array:
    """uint8 mask [N]: 1 where position i is an LDM anchor.

    Positions i < rate_log-1 are don't-care (the host hash warms up over
    earlier bytes; the native ldm_scan skips those candidates anyway).
    """
    r = rate_log
    g = _gear_values(src, r)
    acc = g
    for k in range(1, r):
        acc = acc + (jnp.pad(g[: g.shape[0] - k], (k, 0)) << k)
    return ((acc & ((1 << r) - 1)) == 0).astype(jnp.uint8)


def ldm_anchor_mask_reference(src: np.ndarray,
                              rate_log: int = DEFAULT_RATE_LOG) -> np.ndarray:
    """Exact serial reference (the native gear feed), for tests."""
    h = np.uint64(0)
    out = np.zeros(len(src), dtype=np.uint8)
    mask = np.uint64((1 << rate_log) - 1)
    gmask = np.uint64((1 << (rate_log + 8)) - 1)
    m32 = np.uint64((1 << 32) - 1)
    with np.errstate(over="ignore"):
        for i, b in enumerate(src):
            g = (((np.uint64(int(b) + 1) * np.uint64(GEAR_MULT)) & m32)
                 >> np.uint64(GEAR_SHIFT)) & gmask
            h = (h << np.uint64(1)) + g
            out[i] = (h & mask) == 0
    return out

"""Shared plumbing for the decode plane's Pallas kernels (Triton route).

Every kernel wrapper resolves its mode through :func:`resolve_interpret`:
on a GPU it runs the compiled Triton kernel; it runs the Pallas
interpreter only when the caller asks for it (``interpret=True``, or the
process-wide default set by :func:`set_interpret`, which the CPU test
suite turns on in one fixture).  Any other backend without that request
is an error — nothing falls back to the interpreter silently.

The kernels are pure int32 and are traced with x64 off (the package turns
x64 on globally for the codec's 64-bit host-side windows).
"""

from __future__ import annotations

_INTERPRET_DEFAULT = False


def set_interpret(flag: bool) -> None:
    """Process-wide default for wrappers called with ``interpret=None``."""
    global _INTERPRET_DEFAULT
    _INTERPRET_DEFAULT = bool(flag)


def target_platform() -> str:
    """Platform dispatches will land on; honours ``jax.default_device``."""
    import jax

    d = jax.config.jax_default_device
    if d is not None:
        return d.platform
    return jax.default_backend()


def resolve_interpret(interpret: bool | None) -> bool:
    """The interpret flag a wrapper passes to ``pallas_call``."""
    if interpret is None:
        interpret = _INTERPRET_DEFAULT
    if interpret:
        return True
    platform = target_platform()
    if platform != "gpu":
        raise RuntimeError(
            f"the decode-plane kernels compile for a GPU only (backend "
            f"{platform!r}); pass interpret=True to run the Pallas "
            "interpreter instead")
    return False


def triton_call(kernel, *, grid, out_shape, interpret: bool, name: str,
                num_warps: int = 1):
    """``pl.pallas_call`` on the Triton route, whole arrays as refs."""
    from jax.experimental import pallas as pl
    from jax.experimental.pallas import triton as plgpu

    return pl.pallas_call(
        kernel, grid=grid, out_shape=out_shape, interpret=interpret,
        name=name, backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=num_warps,
                                             num_stages=1))


def pad_lanes(a, n_lanes: int, fill: int = 0):
    """A lane-major host operand padded to n_lanes rows of `fill`, so every
    batch whose lane count falls in one bucket reuses one compiled kernel."""
    import numpy as np

    a = np.asarray(a)
    if a.shape[0] == n_lanes:
        return a
    out = np.full((n_lanes,) + a.shape[1:], fill, a.dtype)
    out[: a.shape[0]] = a
    return out


def next_pow2(n: int, floor: int) -> int:
    """Smallest power of two >= max(n, floor) (lane and length buckets)."""
    v = floor
    while v < n:
        v *= 2
    return v

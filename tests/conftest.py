"""Test configuration: JAX runs on a virtual 8-device CPU mesh unless
JAX_PLATFORMS says otherwise, so multi-device sharding paths are exercised
without accelerators (SURVEY.md §4).  On the CPU the decode-plane kernels
run in the Pallas interpreter (the `pallas_interpret` fixture); tests that
need the compiled kernels carry the `gpu` marker and skip elsewhere."""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()

import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs an NVIDIA GPU (compiled kernels); skips "
        "elsewhere; chip_smoke.py runs these on the card")


@pytest.fixture(scope="session", autouse=True)
def pallas_interpret():
    """Off a GPU, the Pallas kernels run in the interpreter: the one place
    the suite asks for it (the kernel wrappers never choose it)."""
    import jax

    from zstdsharp_tpu.ops import pallas_gpu

    on = jax.default_backend() != "gpu"
    pallas_gpu.set_interpret(on)
    yield on
    pallas_gpu.set_interpret(False)


@pytest.fixture
def gpu():
    """Skip unless JAX runs on a GPU (decided at run time, not import)."""
    import jax

    if jax.default_backend() != "gpu":
        pytest.skip("needs a GPU: the compiled Triton kernels have no CPU "
                    "form (their interpret-mode runs are the CPU tests)")


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(1234)


def _gen_sample(rng: np.random.Generator) -> bytes:
    """Seeded pseudo-JSON sample, mirroring the reference's GenerateSample
    fixture (ZstdNetTests.cs:605-613)."""
    n = int(rng.integers(1, 10))
    body = "".join(
        f'{{"type": "object{rng.integers(0, 100)}", "id": {rng.integers(0, 1000)}}},'
        for _ in range(n)
    )
    return body.encode()


@pytest.fixture(scope="session")
def sample_factory():
    r = np.random.default_rng(1234)
    return lambda: _gen_sample(r)


@pytest.fixture(scope="session")
def text_corpus() -> bytes:
    """Deterministic compressible text corpus (~1 MiB), dickens-like mix."""
    r = np.random.default_rng(42)
    words = [
        b"the", b"quick", b"brown", b"fox", b"jumps", b"over", b"lazy", b"dog",
        b"compression", b"entropy", b"zstandard", b"stream", b"block", b"frame",
        b"it", b"was", b"best", b"of", b"times", b"worst", b"wisdom", b"foolishness",
    ]
    probs = r.dirichlet(np.ones(len(words)) * 0.6)
    idx = r.choice(len(words), size=220_000, p=probs)
    return b" ".join(words[i] for i in idx)


@pytest.fixture(scope="session")
def binary_corpus() -> bytes:
    """Mixed-entropy binary corpus (~512 KiB): runs, randoms, structure."""
    r = np.random.default_rng(7)
    parts = []
    for _ in range(64):
        kind = r.integers(0, 4)
        n = int(r.integers(512, 16384))
        if kind == 0:
            parts.append(bytes([int(r.integers(0, 256))]) * n)
        elif kind == 1:
            parts.append(r.integers(0, 256, n, dtype=np.uint8).tobytes())
        elif kind == 2:
            base = r.integers(0, 256, 64, dtype=np.uint8).tobytes()
            parts.append((base * (n // 64 + 1))[:n])
        else:
            ramp = (np.arange(n) % int(r.integers(3, 40))).astype(np.uint8)
            parts.append(ramp.tobytes())
    return b"".join(parts)

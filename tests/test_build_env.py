"""How the package builds and where it keeps its caches: the native engine
is built from the tracked sources under a key, and JAX's persistent
compilation cache goes where JAX_COMPILATION_CACHE_DIR says or to the
fixed `.jax_cache/` at the checkout root."""

import os
import subprocess
import sys
from pathlib import Path

import pytest

from zstdsharp_tpu import native

ROOT = Path(__file__).resolve().parent.parent

_PROBE = """
import sys
sys.path.insert(0, {root!r})
import jax
import zstdsharp_tpu.ops
jax.config.update("jax_persistent_cache_min_compile_time_secs", 0)
jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)
print(jax.config.jax_compilation_cache_dir)
if {compile}:
    import jax.numpy as jnp
    jax.jit(lambda x: jnp.sin(x) * 3 + 1)(jnp.arange(17.0)).block_until_ready()
"""


def _probe(env_dir, compile_=False):
    env = {k: v for k, v in os.environ.items()
           if k != "JAX_COMPILATION_CACHE_DIR"}
    env["JAX_PLATFORMS"] = "cpu"
    if env_dir is not None:
        env["JAX_COMPILATION_CACHE_DIR"] = str(env_dir)
    r = subprocess.run(
        [sys.executable, "-c", _PROBE.format(root=str(ROOT),
                                             compile=compile_)],
        capture_output=True, text=True, env=env, timeout=300)
    assert r.returncode == 0, r.stderr
    return r.stdout.strip().splitlines()[-1]


@pytest.mark.parametrize("where", ["env", "default"])
def test_compile_cache_dir(tmp_path, where):
    if where == "env":
        assert _probe(tmp_path) == str(tmp_path)
    else:
        assert _probe(None) == str(ROOT / ".jax_cache")


def test_compile_cache_lands_in_env_dir(tmp_path):
    """A compiled program is written to the directory the variable names."""
    cache = tmp_path / "cache"
    _probe(cache, compile_=True)
    assert any(cache.iterdir())


def test_build_key_follows_source_and_flags():
    flags = ("-O2", "-shared")
    k = native.build_key([b"int f() { return 1; }"], flags)
    assert k == native.build_key([b"int f() { return 1; }"], flags)
    assert k != native.build_key([b"int f() { return 2; }"], flags)
    assert k != native.build_key([b"int f() { return 1; }"], flags + ("-g",))


def test_loaded_engine_is_the_keyed_build():
    """The library in use was built here, from the tracked source, under
    the key of that source; nothing prebuilt is tracked or loaded."""
    lib = native.get_lib()
    assert lib is not None
    path = native.lib_path()
    assert Path(lib._name) == path
    assert path.parent.parent == native.BUILD_DIR
    assert path.parent.name == native.build_key(
        [(ROOT / "native" / "zstdtpu_core.cpp").read_bytes()],
        native._CORE_FLAGS)
    if (ROOT / ".git").exists():
        r = subprocess.run(["git", "ls-files", "*.so", "**/*.so"], cwd=ROOT,
                           capture_output=True, text=True)
        assert r.returncode == 0 and r.stdout.strip() == ""

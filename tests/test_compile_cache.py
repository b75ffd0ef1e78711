"""Where the persistent compilation cache lands: in JAX_COMPILATION_CACHE_DIR when it
is set, else in the fixed ``.jax_cache`` directory of the checkout. Each case runs in
a fresh interpreter, since the package configures the cache at import."""

import os
import pathlib
import subprocess
import sys

_ROOT = pathlib.Path(__file__).resolve().parents[1]

_PROBE = """
import jax, jax.numpy as jnp
import orthogonalsphericalshellgrids_tpu
jax.config.update("jax_persistent_cache_min_compile_time_secs", 0)
jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)
jax.block_until_ready(jax.jit(lambda x: jnp.sin(x) * {salt})(jnp.ones(7)))
print(jax.config.jax_compilation_cache_dir)
"""


def _run(env_update, salt):
    env = {k: v for k, v in os.environ.items() if k != "JAX_COMPILATION_CACHE_DIR"}
    env.update(env_update, JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "-c", _PROBE.format(salt=salt)], cwd=_ROOT,
                         env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    return out.stdout.strip().splitlines()[-1]


def test_cache_dir_from_environment(tmp_path):
    cache = tmp_path / "cache"
    used = _run({"JAX_COMPILATION_CACHE_DIR": str(cache)}, salt=1.25)
    assert pathlib.Path(used) == cache
    assert cache.is_dir() and any(cache.iterdir())


def test_cache_dir_defaults_into_checkout():
    used = _run({}, salt=2.5)
    cache = _ROOT / ".jax_cache"
    assert pathlib.Path(used) == cache
    assert cache.is_dir() and any(cache.iterdir())
    ignored = (_ROOT / ".gitignore").read_text().split()
    assert ".jax_cache/" in ignored

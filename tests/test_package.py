"""Package-level settings made at import: where the compile cache lives."""

import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_PROBE = ("import jax, rgbd_slam; "
          "print(jax.config.jax_compilation_cache_dir)")


@pytest.mark.parametrize("env_dir", [None, "elsewhere"])
def test_compile_cache_placement(env_dir, tmp_path):
    """JAX_COMPILATION_CACHE_DIR, where set, is the cache and the package sets
    no other; unset, the cache is <checkout>/.jax_cache."""
    env = {k: v for k, v in os.environ.items()
           if k != "JAX_COMPILATION_CACHE_DIR"}
    env.update(JAX_PLATFORMS="cpu", PYTHONPATH=REPO)
    want = os.path.join(REPO, ".jax_cache")
    if env_dir is not None:
        want = str(tmp_path / env_dir)
        env["JAX_COMPILATION_CACHE_DIR"] = want
    out = subprocess.run([sys.executable, "-c", _PROBE], env=env, cwd=tmp_path,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == want

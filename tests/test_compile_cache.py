"""Where the package puts JAX's persistent compile cache: JAX's own
JAX_COMPILATION_CACHE_DIR when set, else a fixed directory inside the
checkout that .gitignore lists."""

import os
import subprocess
import sys

import pytest

import mitsuba3dopplertof_tpu as mi

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_default_dir_is_fixed_inside_checkout():
    d = mi._compile_cache_dir({})
    assert d == os.path.join(REPO, ".jax_cache")
    with open(os.path.join(REPO, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()


@pytest.mark.parametrize("env", [
    {"JAX_COMPILATION_CACHE_DIR": "/elsewhere"},
    {"MI_NO_COMPILE_CACHE": "1"}])
def test_env_leaves_cache_to_jax(env):
    assert mi._compile_cache_dir(env) is None


@pytest.mark.parametrize("set_env", [False, True])
def test_cache_dir_at_import(tmp_path, set_env):
    env = {k: v for k, v in os.environ.items()
           if k not in ("JAX_COMPILATION_CACHE_DIR", "MI_NO_COMPILE_CACHE")}
    env["JAX_PLATFORMS"] = "cpu"
    if set_env:
        env["JAX_COMPILATION_CACHE_DIR"] = str(tmp_path / "cache")
    code = ("import jax, mitsuba3dopplertof_tpu; "
            "print(jax.config.jax_compilation_cache_dir)")
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    want = (str(tmp_path / "cache") if set_env
            else os.path.join(REPO, ".jax_cache"))
    assert out.stdout.strip().splitlines()[-1] == want

"""Miscellaneous utility functions for test suites — fixtures and
decorators with the surface of reference src/python/python/test/util.py,
rebuilt over this package's FileResolver and JAX vectorization.
"""

from __future__ import annotations

import os
from functools import wraps
from inspect import getframeinfo, stack

import numpy as np


def find_resource(fname: str) -> str:
    """Walk up from this file until ``fname`` exists (reference
    test/util.py find_resource)."""
    path = os.path.dirname(os.path.realpath(__file__))
    while True:
        full = os.path.join(path, fname)
        if os.path.exists(full):
            return full
        if path in ("", "/"):
            raise Exception(f'find_resource(): could not find "{fname}"')
        path = os.path.dirname(path)


def fresolver_append_path(func):
    """Decorator: append the calling test file's directory and the project
    root to the file resolver for the duration of the test, restoring it
    afterwards (reference test/util.py fresolver_append_path)."""
    from ..core.fresolver import file_resolver

    par = os.path.dirname
    caller = getframeinfo(stack()[1][0])
    caller_path = par(os.path.realpath(caller.filename))

    def is_root(path):
        if not path:
            return False
        children = set(os.listdir(path))
        return ("mitsuba3dopplertof_tpu" in children
                and "tests" in children) or ".git" in children
    root_path = caller_path
    while not is_root(root_path) and par(root_path) != root_path:
        root_path = par(root_path)

    @wraps(func)
    def f(*args, **kwargs):
        fres = file_resolver()
        before = list(getattr(fres, "paths", []))
        fres.append(caller_path)
        fres.append(root_path)
        try:
            return func(*args, **kwargs)
        finally:
            if hasattr(fres, "paths"):
                fres.paths[:] = before
    return f


def make_tmpfile(request, tmpdir_factory):
    my_dir = tmpdir_factory.mktemp("tmpdir")
    request.addfinalizer(lambda: my_dir.remove(rec=1))
    path_value = str(my_dir.join("tmpfile"))
    open(path_value, "a").close()
    return path_value


try:
    import pytest

    @pytest.fixture
    def tmpfile(request, tmpdir_factory):
        """Fixture creating a temporary file (reference test/util.py)."""
        return make_tmpfile(request, tmpdir_factory)
except ImportError:                                  # pytest-less install
    pass


def check_vectorization(kernel, arg_dims=(), width=125, atol=1e-6):
    """Compare a scalar evaluation of ``kernel`` against its vectorized
    evaluation over a batch (the role of reference test/util.py
    check_vectorization, with JAX vmap standing in for the LLVM/CUDA
    variants). ``kernel`` maps float arrays (n,) or (n,d) -> arrays."""
    import jax
    import jax.numpy as jnp

    rng = np.random.default_rng(0)
    if not arg_dims:
        from inspect import signature
        arg_dims = [1] * len(signature(kernel).parameters)
    args = [rng.random((width, d)).astype(np.float32).squeeze(-1)
            if d == 1 else rng.random((width, d)).astype(np.float32)
            for d in arg_dims]
    batched = np.asarray(kernel(*[jnp.asarray(a) for a in args]))
    one = np.asarray(jax.vmap(kernel)(*[jnp.asarray(a) for a in args]))
    assert np.allclose(batched, one, atol=atol), (batched, one)
    return True


__all__ = ["find_resource", "fresolver_append_path", "tmpfile",
           "make_tmpfile", "check_vectorization"]


def _erf(x):
    # Abramowitz-Stegun 7.1.26 (|eps| < 1.5e-7) — scipy-free
    sign = np.sign(x)
    x = np.abs(x)
    t = 1.0 / (1.0 + 0.3275911 * x)
    y = 1.0 - (((((1.061405429 * t - 1.453152027) * t) + 1.421413741)
                * t - 0.284496736) * t + 0.254829592) * t * np.exp(-x * x)
    return sign * y


def z_test(mean, spp, ref, ref_var):
    """Reference z_test (test_renders.py:160-177): p-values of the
    per-pixel hypothesis 'this render agrees with the reference mean'."""
    ref_var = np.maximum(ref_var, 1e-4)
    z = np.abs(mean - ref) * np.sqrt(spp / ref_var)
    cdf = 0.5 * (1.0 + _erf(z / np.sqrt(2.0)))
    return 2.0 * (1.0 - cdf)


def run_z_test(img, spp, ref, ref_var, significance=0.01):
    """Fraction of pixels accepted at a Šidák-corrected ``significance``;
    returns (fraction, per-pixel alpha, p-values)."""
    p = z_test(img, spp, ref, ref_var)
    n_pix = ref.size
    alpha = 1.0 - (1.0 - significance) ** (1.0 / n_pix)   # Šidák
    passed = np.count_nonzero(p > alpha)
    return passed / n_pix, alpha, p


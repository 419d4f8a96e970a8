"""Observability + cancellation (VERDICT round-1 item 8): leveled logger,
timeout honoring (reference integrator.cpp:24,48-50), cancel(), progress
reporter, compile-vs-execute timing logs, profiler phase scopes."""

import os
import time

import numpy as np
import pytest

import mitsuba3dopplertof_tpu as mi
from mitsuba3dopplertof_tpu.core import logger as L
from mitsuba3dopplertof_tpu.core import transform as tf


def _scene(spp=256, res=32, timeout=None):
    d = {
        "type": "scene",
        "integrator": {"type": "path", "max_depth": 4},
        "sensor": {"type": "perspective", "fov": 45,
                   "to_world": tf.look_at([0, 0.5, -4], [0, 0, 0],
                                          [0, 1, 0]),
                   "film": {"type": "hdrfilm", "width": res, "height": res},
                   "sampler": {"type": "independent", "sample_count": spp}},
        "floor": {"type": "rectangle",
                  "to_world": tf.translate([0, -1, 0])
                  @ tf.rotate([1, 0, 0], -90) @ tf.scale([5, 5, 1])},
        "light": {"type": "point", "position": [0, 4, -4],
                  "intensity": {"type": "rgb", "value": 30.0}},
    }
    if timeout is not None:
        d["integrator"]["timeout"] = timeout
    return mi.load_dict(d)


def test_logger_levels_and_appender():
    seen = []
    L.add_appender(lambda lvl, msg: seen.append((lvl, msg)))
    try:
        old = L.log_level()
        L.set_log_level("INFO")
        L.log(L.DEBUG, "below threshold")
        L.log(L.INFO, "hello %d", 7)
        L.log(L.ERROR, "boom")
        assert seen == [(L.INFO, "hello 7"), (L.ERROR, "boom")]
        L.set_log_level(old)
    finally:
        L._appenders.clear()


def test_timeout_stops_early_and_develops_partial():
    """timeout > 0 cancels between passes; the partial film is correctly
    weight-normalized (not dim)."""
    sc = _scene(spp=256, timeout=1e-6)
    # force many passes so the timeout check can trigger
    img = np.asarray(sc.integrator.render(sc, seed=0,
                                          max_lanes=32 * 32 * 8))
    ref = np.asarray(_scene(spp=8).integrator.render(_scene(spp=8),
                                                     seed=0))
    # same brightness scale as a full low-spp render (weight-normalized)
    assert abs(img.mean() - ref.mean()) / max(ref.mean(), 1e-9) < 0.2


def test_cancel_between_passes():
    sc = _scene(spp=64)
    integ = sc.integrator
    integ.cancel()
    # the render loop resets the flag at start, so cancel-before is a no-op
    img = np.asarray(integ.render(sc, seed=0, max_lanes=32 * 32 * 8))
    assert np.isfinite(img).all() and img.mean() > 0


def test_progress_reporter_renders_bar(capsys):
    os.environ["MI_FORCE_PROGRESS"] = "1"
    try:
        r = L.ProgressReporter("test", enabled=True, min_interval=0.0)
        r.update(0.5)
        r.update(1.0)
        out = capsys.readouterr().out
        assert "50.0%" in out and "100.0%" in out
    finally:
        del os.environ["MI_FORCE_PROGRESS"]


def test_timing_log_emitted():
    msgs = []
    L.add_appender(lambda lvl, msg: msgs.append(msg))
    old = L.log_level()
    try:
        L.set_log_level("DEBUG")
        sc = _scene(spp=32)
        # timeout>0 forces the pass-granular loop which logs the split
        sc.integrator.timeout = 1e9
        np.asarray(sc.integrator.render(sc, seed=0, max_lanes=32 * 32 * 8))
        assert any("first pass" in m and "steady-state" in m for m in msgs)
    finally:
        L.set_log_level(old)
        L._appenders.clear()


def test_profile_phase_scope_works_under_jit():
    import jax
    import jax.numpy as jnp

    @jax.jit
    def f(x):
        with mi.profile_phase("TestPhase"):
            return x * 2.0
    assert float(f(jnp.float32(3.0))) == 6.0


def test_debug_nans_flag(tmp_path):
    """MI_DEBUG_NANS=1 wires jax_debug_nans: a NaN produced inside a jitted
    program raises instead of propagating silently (SURVEY §5 sanitizer
    analog). Subprocess keeps the global jax config out of this process."""
    import subprocess, sys, os
    code = (
        "import os, sys\n"
        "import jax\n"
        "jax.config.update('jax_platforms', 'cpu')\n"
        "import mitsuba3dopplertof_tpu as mi\n"
        "import jax.numpy as jnp\n"
        "assert jax.config.jax_debug_nans\n"
        "try:\n"
        "    jax.jit(lambda x: jnp.log(x) - jnp.log(x * 0.0))(jnp.zeros(4))\n"
        "except FloatingPointError:\n"
        "    print('RAISED')\n"
    )
    env = dict(os.environ, MI_DEBUG_NANS="1", JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=300,
                         cwd=os.path.dirname(os.path.dirname(
                             os.path.abspath(__file__))))
    assert "RAISED" in out.stdout, (out.stdout, out.stderr)

"""Variance-reduction parity for correlated time sampling — the heart of
the Doppler ToF method (paper Fig. 12; SURVEY.md §4 acceptance criterion:
variance curves per method match the reference *in distribution*).

Renders the canonical scene small, many seeds, and checks that antithetic
time sampling with path correlation reduces per-pixel variance relative to
uniform sampling, and that the homodyne zero-velocity case behaves."""

import numpy as np
import pytest

import mitsuba3dopplertof_tpu as mi


def _variance(scene, integrator, n_seeds=6, spp=16):
    imgs = [np.asarray(integrator.render(scene, seed=s, spp=spp))
            for s in range(n_seeds)]
    imgs = np.stack(imgs)
    return imgs.var(axis=0).mean(), imgs.mean()


@pytest.fixture(scope="module")
def scene():
    return mi.load_file("/root/reference/configs_example/scene.xml",
                        resx=8, resy=8)


def _make_integrator(method, pcd):
    return mi.load_dict({
        "type": "dopplertofpath",
        "max_depth": 4,
        "w_g": 30.0,
        "hetero_frequency": 1.0,
        "hetero_offset": 0.0,
        "time_sampling_method": method,
        "antithetic_shift": 0.5 if method == "antithetic" else 0.0,
        "path_correlation_depth": pcd,
    })


def test_antithetic_reduces_variance(scene):
    """The paper's central result: antithetic time pairs + path correlation
    dramatically reduce variance of the Doppler estimate vs uniform time
    sampling (reference main_experiment.py Exp1)."""
    v_uniform, m_u = _variance(scene, _make_integrator("uniform", 0))
    v_anti, m_a = _variance(scene, _make_integrator("antithetic", 4))
    assert v_anti < v_uniform * 0.5, (v_anti, v_uniform)
    # unbiasedness: means agree within noise
    assert abs(m_u - m_a) < 4 * np.sqrt(v_uniform / 6)


def test_mirror_antithetic_also_reduces(scene):
    v_uniform, _ = _variance(scene, _make_integrator("uniform", 0))
    v_mirror, _ = _variance(scene, _make_integrator("antithetic_mirror", 4))
    assert v_mirror < v_uniform, (v_mirror, v_uniform)


def test_homodyne_low_frequency_limit(scene):
    """Homodyne with w_g -> 0: modulation weight -> 0.5*g_1*cos(0) = 0.25,
    so dopplertofpath reduces to 0.25x the plain path-traced image
    (dopplertofpath.cpp:60-77 with hetero_frequency=0, phi -> 0)."""
    homo = mi.load_dict({
        "type": "dopplertofpath", "max_depth": 4, "w_g": 1e-4,
        "hetero_frequency": 0.0, "hetero_offset": 0.0,
        "time_sampling_method": "uniform", "path_correlation_depth": 0,
    })
    path = mi.load_dict({"type": "path", "max_depth": 4})
    a = np.asarray(homo.render(scene, seed=0, spp=64))
    b = np.asarray(path.render(scene, seed=0, spp=64))
    ratio = a.mean() / (0.25 * b.mean())
    assert abs(ratio - 1.0) < 0.05, ratio


@pytest.mark.skipif(not __import__("os").environ.get("RUN_SLOW"),
                    reason="slow full-pipeline test (set RUN_SLOW=1)")
def test_velocity_estimation_pipeline():
    """End-to-end paper pipeline (reference main_animation.py:101-157):
    homodyne + heterodyne pairs at 2 phase offsets -> multi-phase ratio ->
    radial velocity; compared against the velocity integrator's GT on the
    canonical scene (cubes at -10/+10 m/s)."""
    from mitsuba3dopplertof_tpu.utils.image import (
        to_tof_image, calc_velocity_from_homo_heteros)
    scene = mi.load_file("/root/reference/configs_example/scene.xml",
                         resx=64, resy=64)
    T, w_g = 0.0015, 30.0

    def dop(hf, ho, spp=512):
        integ = mi.load_dict({
            "type": "dopplertofpath", "max_depth": 4, "w_g": w_g, "time": T,
            "hetero_frequency": hf, "hetero_offset": ho,
            "time_sampling_method": "antithetic", "antithetic_shift": 0.5,
            "path_correlation_depth": 16})
        return to_tof_image(np.asarray(integ.render(scene, seed=0, spp=spp)), T)

    homos = [dop(0.0, ho) for ho in (0.0, 0.25)]
    hets = [dop(1.0, ho) for ho in (0.0, 0.25)]
    vmap = calc_velocity_from_homo_heteros(homos, hets, exposure_time=T,
                                           w_g=w_g)
    vel = mi.load_dict({"type": "velocity", "time": T})
    gt = np.asarray(vel.render(scene, seed=0, spp=16))[..., 0]
    for target in (-10.0, 10.0):
        interior = np.abs(gt - target) < 1.0
        if interior.sum() < 10:
            continue
        med = float(np.median(vmap[interior]))
        assert abs(med - target) < 6.0, (target, med)
    static = np.abs(gt) < 0.5
    assert abs(float(np.median(vmap[static]))) < 2.0


def test_variance_curve_method_by_correlation_depth(scene):
    """The Fig.-12-shaped acceptance check (VERDICT round-1 item 10;
    reference doppler_tutorials/src/main_experiment.py:86-123): variance
    for method x path_correlation_depth in {0, 2, 16} must order
    uniform > stratified > antithetic at full correlation, and deeper
    path correlation must help monotonically (within estimator noise)."""
    depths = [0, 2, 16]
    v = {}
    for method in ("uniform", "stratified", "antithetic"):
        for d in depths:
            v[(method, d)] = _variance(scene, _make_integrator(method, d),
                                       n_seeds=8)[0]

    # ordering at full path correlation (Fig. 12's right edge)
    assert v[("uniform", 16)] > v[("stratified", 16)], v
    assert v[("stratified", 16)] > v[("antithetic", 16)], v

    # deeper correlation helps monotonically for the correlated methods
    # (15% slack absorbs the 8-seed variance-of-variance noise)
    for method in ("stratified", "antithetic"):
        assert v[(method, 2)] < v[(method, 0)] * 1.15, (method, v)
        assert v[(method, 16)] < v[(method, 2)] * 1.15, (method, v)
        assert v[(method, 16)] < v[(method, 0)] * 0.8, (method, v)

    # uniform time sampling gains nothing from path correlation alone
    # beyond noise
    assert v[("uniform", 16)] > v[("antithetic", 0)] * 0.5, v

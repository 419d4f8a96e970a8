"""Variance-aware golden render tests across variants (the role of
reference src/render/tests/test_renders.py:160-233 with variance refs from
src/integrators/moment.cpp): every render of the canonical scene is
Z-tested per pixel against a stored mean+variance reference with a
Šidák-corrected significance threshold, so the test has calibrated power —
MC noise passes at any seed while a systematic bias of ~1.5x the
single-sample std fails decisively.

References live in tests/data/renders/ (scripts/gen_render_refs.py).
The same Z-test gates the GPU pipeline against the same refs (the
comparison is statistical, so backend-dependent reassociation cannot trip
it while a real lowering bug will): chip_smoke.py runs the hero one, and
the `gpu`-marked tests run on the card with MI_GPU_TESTS=1."""
import os

import numpy as np
import pytest

import mitsuba3dopplertof_tpu as mi
from mitsuba3dopplertof_tpu.test.util import run_z_test

REF_DIR = os.path.join(os.path.dirname(__file__), "data", "renders")
ACCEPT_FRACTION = 0.9975          # reference test_renders.py:230
SPP_BUDGET = int(5e5)


VARIANTS = ["tpu_rgb", "tpu_spectral", "tpu_mono",
            "tpu_rgb_polarized", "tpu_spectral_polarized"]


def _load_ref(variant):
    path = os.path.join(REF_DIR, f"ref_{variant}.npz")
    if not os.path.exists(path):
        pytest.skip(f"missing reference {path} "
                    "(scripts/gen_render_refs.py)")
    d = np.load(path)
    return d["mean"], d["var"], int(d["spp"]), int(d["res"])


@pytest.fixture(autouse=True)
def _restore_variant():
    yield
    mi.set_variant("tpu_rgb")


@pytest.mark.parametrize("variant", VARIANTS)
def test_render_variant(variant):
    ref, var, _, res = _load_ref(variant)
    spp = max(16, SPP_BUDGET // (res * res))
    mi.set_variant(variant)
    scene = mi.load_file("/root/reference/configs_example/scene.xml",
                         resx=res, resy=res)
    img = np.asarray(mi.render(scene, spp=spp, seed=7))
    assert img.shape == ref.shape, (img.shape, ref.shape)
    frac, alpha, p = run_z_test(img, spp, ref, var)
    assert frac >= ACCEPT_FRACTION, (
        f"{variant}: Z-test rejected — {100 * (1 - frac):.3f}% of pixels "
        f"failed (min p={p.min():.2e}, alpha={alpha:.2e})")


def test_z_test_rejects_systematic_bias():
    """Framework power check: a bias of 1.5x the per-sample std at every
    pixel (far below eyeball visibility at these variances) must fail."""
    ref, var, _, res = _load_ref("tpu_rgb")
    spp = max(16, SPP_BUDGET // (res * res))
    rng = np.random.default_rng(0)
    sigma = np.sqrt(np.maximum(var, 1e-4))
    fake = (ref + 1.5 * sigma
            + rng.normal(0, 1, ref.shape) * sigma / np.sqrt(spp))
    frac, _, _ = run_z_test(fake, spp, ref, var)
    assert frac < ACCEPT_FRACTION


def test_z_test_accepts_fresh_realization():
    """And an honest independent MC realization (simulated at the correct
    variance) passes at any seed."""
    ref, var, _, res = _load_ref("tpu_rgb")
    spp = max(16, SPP_BUDGET // (res * res))
    sigma = np.sqrt(np.maximum(var, 1e-4))
    for seed in range(3):
        rng = np.random.default_rng(seed)
        fake = ref + rng.normal(0, 1, ref.shape) * sigma / np.sqrt(spp)
        frac, _, _ = run_z_test(fake, spp, ref, var)
        assert frac >= ACCEPT_FRACTION


@pytest.mark.gpu
def test_render_hero_golden():
    """Scene-scale golden: the bundled hero validation scene (animated
    knot + mirror + textures + envmap + hetero smoke) Z-tested against
    its moment-integrator reference (scripts/gen_render_refs.py --scene
    hero). Runs on the card only: the full-feature scene takes minutes
    per render on the CPU, whose end-to-end coverage lives in
    test_hero_scene.py."""
    path = os.path.join(REF_DIR, "ref_hero_tpu_rgb.npz")
    if not os.path.exists(path):
        pytest.skip("missing ref_hero_tpu_rgb.npz "
                    "(gen_render_refs.py --scene hero)")
    d = np.load(path)
    ref, var, res = d["mean"], d["var"], int(d["res"])
    from mitsuba3dopplertof_tpu.utils.hero_scene import load_hero_scene
    spp = max(16, SPP_BUDGET // (res * res))
    scene = load_hero_scene(res=res, spp=spp)
    img = np.asarray(mi.render(scene, spp=spp, seed=7))
    assert img.shape == ref.shape, (img.shape, ref.shape)
    frac, alpha, p = run_z_test(img, spp, ref, var)
    assert frac >= ACCEPT_FRACTION, (
        f"hero: Z-test rejected — {100 * (1 - frac):.3f}% of pixels "
        f"failed (min p={p.min():.2e}, alpha={alpha:.2e})")

"""Which ray-query path a scene takes on which platform
(render/scene.py ``ray_query_route``): the fused kernel only for small
scenes on the GPU, the XLA path everywhere else and under AD, and the
production route never in interpret mode."""

import functools
import os

import jax
import numpy as np
import pytest

import mitsuba3dopplertof_tpu as mi
from mitsuba3dopplertof_tpu.ops import intersect_kernel as ik
from mitsuba3dopplertof_tpu.render import scene as S

from test_pallas_parity import _rays, _scene

CANONICAL = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "scenes", "canonical_cbox.xml")


@pytest.fixture(scope="module")
def scenes(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("route")
    return {"small": _scene(tmp, "small").compile(),
            "big": _scene(tmp, "big").compile()}


@pytest.mark.parametrize("platform,size,route", [
    ("gpu", "small", "kernel"), ("gpu", "big", "xla"),
    ("cpu", "small", "xla"), ("cpu", "big", "xla")])
def test_route_by_platform_and_size(scenes, platform, size, route):
    sa = scenes[size]
    n_tris = sa.n_static_tris + sa.n_anim_tris
    assert (n_tris <= S.SMALL_SCENE_THRESHOLD) == (size == "small")
    assert S.ray_query_route(sa, platform) == route


def test_route_without_custom_kernel(scenes, monkeypatch):
    monkeypatch.setattr(S, "USE_CUSTOM_KERNEL", False)
    assert S.ray_query_route(scenes["small"], "gpu") == "xla"


def test_query_platform_follows_default_device():
    assert S.query_platform() == jax.default_backend()
    with jax.default_device(jax.devices("cpu")[0]):
        assert S.query_platform() == "cpu"
    with jax.default_device("cpu"):
        assert S.query_platform() == "cpu"


@pytest.mark.parametrize("query", ["closest", "any"])
def test_production_route_never_interprets(scenes, monkeypatch, query):
    """Traced as for the GPU, both queries lower to one Triton pallas_call
    with interpret off."""
    monkeypatch.setattr(S, "query_platform", lambda: "gpu")
    sa = scenes["small"]
    fn = S.ray_intersect if query == "closest" else S.ray_test
    jaxpr = jax.make_jaxpr(lambda r: fn(sa, r))(_rays(600, seed=1))
    calls = [e for e in jaxpr.eqns if e.primitive.name == "pallas_call"]
    assert len(calls) == 1
    assert calls[0].params["interpret"] is False
    assert calls[0].params["backend"] == "triton"


def _interpreting(monkeypatch):
    """Route as on the GPU, run the kernel in interpret mode."""
    monkeypatch.setattr(S, "query_platform", lambda: "gpu")
    monkeypatch.setattr(ik, "closest_hit",
                        functools.partial(ik.closest_hit, interpret=True))
    monkeypatch.setattr(ik, "any_hit",
                        functools.partial(ik.any_hit, interpret=True))


def test_render_through_kernel_route_matches_xla(monkeypatch):
    """A whole canonical-shaped render through the kernel route equals the
    XLA-path render (same RNG streams, same hits)."""
    xla = np.asarray(mi.render(mi.load_file(CANONICAL, resx=8, resy=8),
                               spp=4, seed=2))
    _interpreting(monkeypatch)
    sc = mi.load_file(CANONICAL, resx=8, resy=8)
    assert S.ray_query_route(sc.compile()) == "kernel"
    kern = np.asarray(mi.render(sc, spp=4, seed=2))
    np.testing.assert_allclose(kern, xla, rtol=1e-5,
                               atol=1e-6 * np.abs(xla).max())


def test_ad_render_takes_xla_path(monkeypatch):
    """Gradients trace the XLA path even where the kernel route applies
    (the kernel defines no VJP), and the switch is restored after."""
    _interpreting(monkeypatch)

    def refuse(*a, **k):
        raise AssertionError("kernel traced under AD")
    monkeypatch.setattr(ik, "closest_hit", refuse)
    monkeypatch.setattr(ik, "any_hit", refuse)
    sc = mi.load_file(CANONICAL, resx=4, resy=4)
    loss, grads = mi.render_grad(sc, loss_fn=lambda img: (img ** 2).sum(),
                                 spp=2)
    assert np.isfinite(float(loss))
    assert S.USE_CUSTOM_KERNEL is True
    assert all(np.isfinite(np.asarray(g)).all() for g in grads.values())

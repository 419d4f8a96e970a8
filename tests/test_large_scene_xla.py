"""The GPU's path for scenes above SMALL_SCENE_THRESHOLD: the XLA
closest-hit and any-hit queries through the static BVH and the
per-instance BLAS of ops/bvh.py, against the plain per-triangle scan
(`_intersect_scan`) on the same scenes, payload included."""

import numpy as np
import jax.numpy as jnp
import pytest

import mitsuba3dopplertof_tpu.ops.bvh as B
from mitsuba3dopplertof_tpu.render import scene as S
from mitsuba3dopplertof_tpu.render.scene import _hit_reference

from test_pallas_parity import _assert_hits_match, _rays, _scene

SCENES = {"static": (False, False), "animated": (True, False),
          "all": (True, True)}


def _pair(tmp_path, monkeypatch, scene):
    """The same big scene compiled with acceleration structures over every
    mesh (threshold 8: the 720-triangle mesh and both 12-triangle cubes)
    and with none."""
    monkeypatch.setattr(B, "BVH_THRESHOLD", 8)
    accel = _scene(tmp_path, "big", *SCENES[scene]).compile()
    monkeypatch.setattr(B, "BVH_THRESHOLD", 10 ** 9)
    scan = _scene(tmp_path, "big", *SCENES[scene]).compile()
    assert accel.bvh is not None and scan.bvh is None
    assert all(b is not None for b in accel.anim_blas)
    assert not scan.has_accel
    assert S.ray_query_route(accel, "gpu") == "xla"
    return accel, scan


@pytest.mark.parametrize("scene", sorted(SCENES))
def test_accelerated_closest_hit_matches_scan(tmp_path, monkeypatch, scene):
    accel, scan = _pair(tmp_path, monkeypatch, scene)
    ray = _rays(1000, seed=11)
    ha, hs = _hit_reference(accel, ray), _hit_reference(scan, ray)
    _assert_hits_match(ha, hs, f"bvh {scene}")
    assert (np.asarray(ha.prim) == np.asarray(hs.prim)).mean() > 0.999


@pytest.mark.parametrize("scene", sorted(SCENES))
def test_accelerated_any_hit_matches_scan(tmp_path, monkeypatch, scene):
    accel, scan = _pair(tmp_path, monkeypatch, scene)
    ray = _rays(1000, seed=12)
    active = jnp.asarray(np.random.default_rng(3).random(1000) < 0.8)
    occ_a = np.asarray(S.ray_test(accel, ray, active))
    occ_s = np.asarray(S.ray_test(scan, ray, active))
    assert (occ_a == occ_s).all()
    assert not occ_a[~np.asarray(active)].any()


def test_accelerated_maxt_clamp(tmp_path, monkeypatch):
    """Lanes whose maxt ends before the first surface miss on both paths."""
    accel, scan = _pair(tmp_path, monkeypatch, "all")
    ray = _rays(512, seed=13)
    short = ray._replace(maxt=jnp.full((512,), 1e-3, jnp.float32))
    for sa in (accel, scan):
        assert (np.asarray(_hit_reference(sa, short).prim) == -1).all()
        assert not np.asarray(S.ray_test(sa, short)).any()

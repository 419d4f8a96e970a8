"""Multi-device data-parallel rendering (parallel/render.py): the sharded
render must match the single-device render up to the seeding layout, and be
deterministic (SURVEY.md §2.6: psum film merge, groups never straddle
shards)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

import mitsuba3dopplertof_tpu as mi
from mitsuba3dopplertof_tpu.parallel import render_sharded, make_mesh


@pytest.fixture(scope="module")
def scene():
    return mi.load_file("/root/reference/configs_example/scene.xml",
                        resx=16, resy=16)


def test_sharded_matches_single_device(scene):
    """With identical global lane numbering the 8-way sharded render is
    numerically the single-device render (same RNG streams, same splat)."""
    devices = jax.devices()
    if len(devices) < 8:
        pytest.skip("needs 8 virtual devices")
    integ = scene.integrator
    single = np.asarray(integ.render(scene, spp=8, seed=0,
                                     max_lanes=16 * 16 * 8))
    mesh = make_mesh(devices[:8])
    sharded = np.asarray(render_sharded(integ, scene, mesh=mesh, spp=8,
                                        seed=0))
    assert sharded.shape == single.shape
    assert np.allclose(sharded, single, atol=1e-5), \
        float(np.abs(sharded - single).max())


def test_sharded_deterministic(scene):
    devices = jax.devices()
    if len(devices) < 4:
        pytest.skip("needs 4 virtual devices")
    mesh = make_mesh(devices[:4])
    a = np.asarray(render_sharded(scene.integrator, scene, mesh=mesh,
                                  spp=4, seed=3))
    b = np.asarray(render_sharded(scene.integrator, scene, mesh=mesh,
                                  spp=4, seed=3))
    assert np.array_equal(a, b)


# ---------------------------------------------------------------------------
# Feature parity (VERDICT round-1 item 4): the sharded path shares the full
# single-device sampling body, so aperture draws, AOVs and arbitrary film
# heights must match the single-device render exactly.
# ---------------------------------------------------------------------------

from mitsuba3dopplertof_tpu.core import transform as tf


def _thinlens_scene(H):
    return mi.load_dict({
        "type": "scene",
        "integrator": {"type": "path", "max_depth": 3},
        "sensor": {"type": "thinlens", "fov": 45,
                   "aperture_radius": 0.2, "focus_distance": 4.0,
                   "to_world": tf.look_at([0, 0.5, -4], [0, 0, 0],
                                          [0, 1, 0]),
                   "film": {"type": "hdrfilm", "width": 16, "height": H},
                   "sampler": {"type": "independent", "sample_count": 8}},
        "floor": {"type": "rectangle",
                  "to_world": tf.translate([0, -1, 0])
                  @ tf.rotate([1, 0, 0], -90) @ tf.scale([5, 5, 1])},
        "box": {"type": "cube",
                "to_world": tf.translate([0, 0, 1]) @ tf.scale([0.5] * 3)},
        "light": {"type": "point", "position": [0, 4, -4],
                  "intensity": {"type": "rgb", "value": 30.0}},
    })


def test_sharded_thinlens_aperture_matches(scene):
    """Aperture draws (needs_aperture_sample) work sharded — the round-1
    path silently pinned ap=0.5 (no DOF) and drifted RNG streams."""
    devices = jax.devices()
    if len(devices) < 8:
        pytest.skip("needs 8 virtual devices")
    sc = _thinlens_scene(16)
    single = np.asarray(sc.integrator.render(sc, spp=8, seed=0,
                                             max_lanes=16 * 16 * 8))
    sharded = np.asarray(render_sharded(sc.integrator, sc,
                                        mesh=make_mesh(devices[:8]),
                                        spp=8, seed=0))
    assert np.allclose(sharded, single, atol=1e-5), \
        float(np.abs(sharded - single).max())


def test_sharded_arbitrary_height(scene):
    """H not divisible by the device count: padded rows render inactive and
    the output still equals single-device."""
    devices = jax.devices()
    if len(devices) < 8:
        pytest.skip("needs 8 virtual devices")
    sc = _thinlens_scene(13)        # 13 % 8 != 0
    single = np.asarray(sc.integrator.render(sc, spp=8, seed=0,
                                             max_lanes=16 * 13 * 8))
    sharded = np.asarray(render_sharded(sc.integrator, sc,
                                        mesh=make_mesh(devices[:8]),
                                        spp=8, seed=0))
    assert sharded.shape == single.shape
    assert np.allclose(sharded, single, atol=1e-5), \
        float(np.abs(sharded - single).max())


def test_sharded_aov_channels(scene):
    """AOV integrators produce their extra channels under shard_map."""
    devices = jax.devices()
    if len(devices) < 8:
        pytest.skip("needs 8 virtual devices")
    sc = mi.load_dict({
        "type": "scene",
        "integrator": {"type": "aov", "aovs": "dd:depth,nn:sh_normal",
                       "integrator": {"type": "path", "max_depth": 2}},
        "sensor": {"type": "perspective", "fov": 45,
                   "to_world": tf.look_at([0, 0.5, -4], [0, 0, 0],
                                          [0, 1, 0]),
                   "film": {"type": "hdrfilm", "width": 16, "height": 16},
                   "sampler": {"type": "independent", "sample_count": 8}},
        "floor": {"type": "rectangle",
                  "to_world": tf.translate([0, -1, 0])
                  @ tf.rotate([1, 0, 0], -90) @ tf.scale([5, 5, 1])},
        "light": {"type": "point", "position": [0, 4, -4],
                  "intensity": {"type": "rgb", "value": 30.0}},
    })
    single = np.asarray(sc.integrator.render(sc, spp=8, seed=0,
                                             max_lanes=16 * 16 * 8))
    sharded = np.asarray(render_sharded(sc.integrator, sc,
                                        mesh=make_mesh(devices[:8]),
                                        spp=8, seed=0))
    assert sharded.shape == single.shape      # rgb + 4 AOV channels
    assert single.shape[-1] >= 7
    assert np.allclose(sharded, single, atol=1e-5), \
        float(np.abs(sharded - single).max())


def test_sharded_binned_nondividing_height(tmp_path):
    """VERDICT round-2 weak #8: sharding a large scene (2160 triangles)
    with a film height that does not divide the device count. Must equal
    the single-device render."""
    devices = jax.devices()
    if len(devices) < 8:
        pytest.skip("needs 8 virtual devices")
    from test_pallas_parity import _grid_mesh_obj
    obj = _grid_mesh_obj(tmp_path, "sph2k", 36, 30)     # 2160 triangles
    H = 18                       # not divisible by 8
    sc = mi.load_dict({
        "type": "scene",
        "integrator": {"type": "path", "max_depth": 2},
        "sensor": {"type": "perspective", "fov": 45,
                   "to_world": tf.look_at([0, 0.5, -4], [0, 0, 0],
                                          [0, 1, 0]),
                   "film": {"type": "hdrfilm", "width": 16, "height": H},
                   "sampler": {"type": "independent", "sample_count": 4}},
        "mesh": {"type": "obj", "filename": str(obj)},
        "floor": {"type": "rectangle",
                  "to_world": tf.translate([0, -1.2, 0])
                  @ tf.rotate([1, 0, 0], -90) @ tf.scale([6, 6, 1])},
        "light": {"type": "point", "position": [0, 4, -4],
                  "intensity": {"type": "rgb", "value": 40.0}},
    })
    single = np.asarray(sc.integrator.render(sc, spp=4, seed=0,
                                             max_lanes=16 * H * 4))
    sharded = np.asarray(render_sharded(sc.integrator, sc,
                                        mesh=make_mesh(devices[:8]),
                                        spp=4, seed=0))
    assert sharded.shape == single.shape
    assert np.allclose(sharded, single, atol=1e-5), \
        float(np.abs(sharded - single).max())

"""Stackless wavefront BVH (ops/bvh.py) — the analog of the
reference's Embree/OptiX acceleration (scene_embree.inl, scene_optix.inl)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

import mitsuba3dopplertof_tpu as mi
from mitsuba3dopplertof_tpu.core.vec import Vec3
from mitsuba3dopplertof_tpu.ops.bvh import build_bvh, bvh_closest, bvh_any


def _soup(T, seed=0):
    rng = np.random.default_rng(seed)
    v0 = rng.uniform(-1, 1, (T, 3))
    e1 = rng.uniform(-0.1, 0.1, (T, 3))
    e2 = rng.uniform(-0.1, 0.1, (T, 3))
    cols = {}
    for i, c in enumerate("xyz"):
        cols["v0" + c] = jnp.asarray(v0[:, i], jnp.float32)
        cols["e1" + c] = jnp.asarray(e1[:, i], jnp.float32)
        cols["e2" + c] = jnp.asarray(e2[:, i], jnp.float32)
    bvh = build_bvh([v0[:, 0], v0[:, 1], v0[:, 2]],
                    [e1[:, 0], e1[:, 1], e1[:, 2]],
                    [e2[:, 0], e2[:, 1], e2[:, 2]])
    return v0, e1, e2, cols, bvh


def _brute(v0, e1, e2, o, d, N):
    ox, oy, oz = [np.asarray(getattr(o, c), np.float64) for c in "xyz"]
    dx, dy, dz = [np.asarray(getattr(d, c), np.float64) for c in "xyz"]
    D = np.stack([dx, dy, dz], 1)
    O = np.stack([ox, oy, oz], 1)
    best_t = np.full(N, np.inf)
    best_i = np.full(N, -1)
    for ti in range(v0.shape[0]):
        pv = np.cross(D, e2[ti])
        det = pv @ e1[ti]
        inv = np.where(np.abs(det) > 1e-12,
                       1 / np.where(np.abs(det) > 1e-12, det, 1), 0)
        tv = O - v0[ti]
        u = (tv * pv).sum(1) * inv
        qv = np.cross(tv, e1[ti])
        v = (D * qv).sum(1) * inv
        t = (qv @ e2[ti]) * inv
        ok = ((np.abs(det) > 1e-12) & (u >= 0) & (v >= 0) & (u + v <= 1)
              & (t > 1e-5) & (t < best_t))
        best_t = np.where(ok, t, best_t)
        best_i = np.where(ok, ti, best_i)
    return best_t, best_i


def test_bvh_matches_brute_force():
    T, N = 3000, 2048
    v0, e1, e2, cols, bvh = _soup(T)
    rng = np.random.default_rng(1)
    o = Vec3(jnp.asarray(rng.uniform(-2, -1.5, N), jnp.float32),
             jnp.asarray(rng.uniform(-1, 1, N), jnp.float32),
             jnp.asarray(rng.uniform(-1, 1, N), jnp.float32))
    dirs = rng.normal(size=(N, 3))
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    d = Vec3(jnp.asarray(np.abs(dirs[:, 0]), jnp.float32),
             jnp.asarray(dirs[:, 1], jnp.float32),
             jnp.asarray(dirs[:, 2], jnp.float32))
    maxt = jnp.full((N,), np.inf, jnp.float32)
    bt0 = jnp.full((N,), np.inf, jnp.float32)
    bi0 = jnp.full((N,), -1, jnp.int32)
    t_b, i_b = jax.jit(
        lambda o, d: bvh_closest(bvh, cols, o, d, maxt, (bt0, bi0)))(o, d)
    bt_ref, bi_ref = _brute(v0, e1, e2, o, d, N)
    assert (np.asarray(i_b) == bi_ref).all()
    occ = jax.jit(lambda o, d: bvh_any(bvh, cols, o, d, maxt))(o, d)
    assert (np.asarray(occ) == (bi_ref >= 0)).all()


def test_animated_blas_matches_scan(tmp_path):
    """A >threshold ANIMATED mesh routes through its object-space BLAS
    (the analog of the reference's motion IAS over a GAS,
    optix/shapes.h:232-258) and hits exactly match the scanned oracle."""
    import mitsuba3dopplertof_tpu.ops.bvh as B
    from mitsuba3dopplertof_tpu.core import transform as tf
    from mitsuba3dopplertof_tpu.core.transform import AnimatedTransform
    from mitsuba3dopplertof_tpu.render.scene import _hit_reference
    from mitsuba3dopplertof_tpu.render.types import Ray

    nu, nv = 96, 48           # 9216 triangles > BVH_THRESHOLD
    lines = []
    for j in range(nv + 1):
        for i in range(nu):
            th, ph = np.pi * j / nv, 2 * np.pi * i / nu
            lines.append(f"v {np.sin(th)*np.cos(ph):.6f} {np.cos(th):.6f} "
                         f"{np.sin(th)*np.sin(ph):.6f}")

    def vid(i, j):
        return j * nu + (i % nu) + 1
    for j in range(nv):
        for i in range(nu):
            a, b, c, d = vid(i, j), vid(i+1, j), vid(i+1, j+1), vid(i, j+1)
            lines.append(f"f {a} {b} {c}")
            lines.append(f"f {a} {c} {d}")
    obj = tmp_path / "sphere.obj"
    obj.write_text("\n".join(lines))

    def make():
        return mi.load_dict({
            "type": "scene",
            "mesh": {"type": "obj", "filename": str(obj),
                     "to_world": AnimatedTransform([
                         (0.0, tf.translate([0, 0, 0])),
                         (1.0, tf.translate([0.8, 0, 0]))])},
            "light": {"type": "point", "position": [0, 3, -3],
                      "intensity": {"type": "rgb", "value": 20.0}},
            "sensor": {"type": "perspective", "fov": 45,
                       "shutter_open": 0.0, "shutter_close": 1.0,
                       "to_world": tf.look_at([0, 0, -4], [0, 0, 0],
                                              [0, 1, 0]),
                       "film": {"type": "hdrfilm", "width": 16,
                                "height": 16},
                       "sampler": {"type": "independent",
                                   "sample_count": 4}},
            "integrator": {"type": "path", "max_depth": 3},
        })

    sc = make()
    sa = sc.compile()
    assert sa.anim_blas and sa.anim_blas[0] is not None

    # direct hit parity: BLAS vs scan on randomized timed rays
    rng = np.random.default_rng(2)
    N = 512
    o = rng.uniform(-2, 2, (N, 3)); o[:, 2] -= 4.0
    tgt = rng.uniform(-1.2, 1.2, (N, 3))
    dd = tgt - o
    dd /= np.linalg.norm(dd, axis=1, keepdims=True)
    f32 = lambda a: jnp.asarray(a, jnp.float32)
    ray = Ray(Vec3(f32(o[:, 0]), f32(o[:, 1]), f32(o[:, 2])),
              Vec3(f32(dd[:, 0]), f32(dd[:, 1]), f32(dd[:, 2])),
              f32(rng.uniform(0, 1, N)), f32(np.full(N, np.inf)))
    h_blas = _hit_reference(sa, ray)

    old = B.BVH_THRESHOLD
    try:
        B.BVH_THRESHOLD = 10 ** 9
        sa2 = make().compile()
        assert not sa2.has_accel
        h_scan = _hit_reference(sa2, ray)
    finally:
        B.BVH_THRESHOLD = old
    assert (np.asarray(h_blas.prim) == np.asarray(h_scan.prim)).all()
    np.testing.assert_allclose(np.asarray(h_blas.t), np.asarray(h_scan.t),
                               rtol=1e-5)


def test_bvh_render_matches_scan(tmp_path):
    """End-to-end: a >threshold mesh renders identically through the BVH
    and the linear-scan path."""
    import mitsuba3dopplertof_tpu.ops.bvh as B
    from mitsuba3dopplertof_tpu.core import transform as tf
    nu, nv = 96, 48           # 9216 triangles
    lines = []
    for j in range(nv + 1):
        for i in range(nu):
            th, ph = np.pi * j / nv, 2 * np.pi * i / nu
            lines.append(f"v {np.sin(th)*np.cos(ph):.6f} {np.cos(th):.6f} "
                         f"{np.sin(th)*np.sin(ph):.6f}")
    def vid(i, j):
        return j * nu + (i % nu) + 1
    for j in range(nv):
        for i in range(nu):
            a, b, c, d = vid(i, j), vid(i+1, j), vid(i+1, j+1), vid(i, j+1)
            lines.append(f"f {a} {b} {c}")
            lines.append(f"f {a} {c} {d}")
    obj = tmp_path / "sphere.obj"
    obj.write_text("\n".join(lines))

    def make():
        return mi.load_dict({
            "type": "scene",
            "mesh": {"type": "obj", "filename": str(obj)},
            "light": {"type": "point", "position": [0, 3, -3],
                      "intensity": {"type": "rgb", "value": 20.0}},
            "sensor": {"type": "perspective", "fov": 45,
                       "to_world": tf.look_at([0, 0, -4], [0, 0, 0],
                                              [0, 1, 0]),
                       "film": {"type": "hdrfilm", "width": 16,
                                "height": 16},
                       "sampler": {"type": "independent",
                                   "sample_count": 4}},
            "integrator": {"type": "path", "max_depth": 3},
        })

    sc = make()
    assert sc.compile().bvh is not None
    a = np.asarray(sc.integrator.render(sc, seed=0, spp=4))
    old = B.BVH_THRESHOLD
    try:
        B.BVH_THRESHOLD = 10 ** 9
        sc2 = make()
        assert sc2.compile().bvh is None
        b = np.asarray(sc2.integrator.render(sc2, seed=0, spp=4))
    finally:
        B.BVH_THRESHOLD = old
    assert np.abs(a - b).max() == 0.0

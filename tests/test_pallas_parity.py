"""Parity of the GPU small-scene kernel with the XLA oracle.

The GPU path for small scenes (`ops.intersect_kernel.closest_hit` /
`any_hit`, Pallas on the Triton route) is the analog of the reference's
OptiX hitgroups (scene_optix.inl:552-570). On the CPU the renderer routes
around it, so these tests run the kernel *directly* in Pallas interpret
mode against the scanned XLA oracle (`render.scene._hit_reference`, the
"scalar variant" of SURVEY.md §4): slot numbering, sphere handling,
animated-instance transforms, padding and the payload are all compared.
The compiled kernel is compared on the card by the `gpu`-marked test at
the end and by chip_smoke.py.

Intent mirrors reference src/render/tests/test_renders.py:130-233 (every
backend combination regression-tested against a slower oracle).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

import mitsuba3dopplertof_tpu as mi
from mitsuba3dopplertof_tpu.core import transform as tf
from mitsuba3dopplertof_tpu.core.transform import AnimatedTransform
from mitsuba3dopplertof_tpu.core.vec import Vec3
from mitsuba3dopplertof_tpu.render.types import Ray
from mitsuba3dopplertof_tpu.render import scene as S
from mitsuba3dopplertof_tpu.render.scene import _hit_reference
from mitsuba3dopplertof_tpu.ops import intersect_kernel as ik


def _grid_mesh_obj(tmp_path, name, nu, nv, radius=1.0):
    """UV-sphere OBJ with 2*nu*nv triangles (with normals + uvs)."""
    lines = []
    for j in range(nv + 1):
        for i in range(nu):
            th, ph = np.pi * j / nv, 2 * np.pi * i / nu
            x = radius * np.sin(th) * np.cos(ph)
            y = radius * np.cos(th)
            z = radius * np.sin(th) * np.sin(ph)
            lines.append(f"v {x:.6f} {y:.6f} {z:.6f}")
            lines.append(f"vn {x:.6f} {y:.6f} {z:.6f}")
            lines.append(f"vt {i/nu:.6f} {j/nv:.6f}")

    def vid(i, j):
        return j * nu + (i % nu) + 1

    for j in range(nv):
        for i in range(nu):
            a, b, c, d = vid(i, j), vid(i + 1, j), vid(i + 1, j + 1), vid(i, j + 1)
            lines.append(f"f {a}/{a}/{a} {b}/{b}/{b} {c}/{c}/{c}")
            lines.append(f"f {a}/{a}/{a} {c}/{c}/{c} {d}/{d}/{d}")
    p = tmp_path / f"{name}.obj"
    p.write_text("\n".join(lines))
    return str(p)


def _anim(m_from, m_to, t0=0.0, t1=1.0):
    return AnimatedTransform([(t0, m_from), (t1, m_to)])


def _scene(tmp_path, n_static="small", animated=True, spheres=True):
    d = {
        "type": "scene",
        "integrator": {"type": "path", "max_depth": 2},
        "sensor": {"type": "perspective", "fov": 45,
                   "to_world": tf.look_at([0, 0, -6], [0, 0, 0], [0, 1, 0]),
                   "film": {"type": "hdrfilm", "width": 8, "height": 8},
                   "sampler": {"type": "independent", "sample_count": 1}},
        "light": {"type": "point", "position": [0, 4, -4],
                  "intensity": {"type": "rgb", "value": 10.0}},
        # two static rectangles at different depths
        "floor": {"type": "rectangle",
                  "to_world": tf.translate([0, -2, 0]) @ tf.rotate([1, 0, 0], -90)
                  @ tf.scale([4, 4, 1])},
        "back": {"type": "rectangle", "to_world": tf.translate([0, 0, 4])
                 @ tf.scale([4, 4, 1])},
    }
    if n_static == "big":
        # 720 triangles: above SMALL_SCENE_THRESHOLD (XLA path on the GPU)
        d["bigmesh"] = {"type": "obj",
                        "filename": _grid_mesh_obj(tmp_path, "uvs", 24, 15),
                        "to_world": tf.translate([2.0, 0.5, 1.0])
                        @ tf.scale([0.8, 0.8, 0.8])}
    if animated:
        d["mover"] = {"type": "cube",
                      "to_world": _anim(
                          tf.translate([-1.5, 0, 1]) @ tf.scale([0.5] * 3)
                          @ tf.rotate([0, 1, 0], 10),
                          tf.translate([-1.5, 1.0, 1]) @ tf.scale([0.5] * 3)
                          @ tf.rotate([0, 1, 0], 55))}
        d["mover2"] = {"type": "cube",
                       "to_world": _anim(
                           tf.translate([1.2, -0.5, 0]) @ tf.scale([0.4] * 3),
                           tf.translate([1.2, -0.5, 2]) @ tf.scale([0.4] * 3),
                           t0=0.2, t1=0.8)}
    if spheres:
        d["ball"] = {"type": "sphere", "center": [0.0, 1.5, 1.0],
                     "radius": 0.6}
        d["movingball"] = {"type": "sphere",
                           "to_world": _anim(
                               tf.translate([0.5, -1.0, 0.5])
                               @ tf.scale([0.45] * 3),
                               tf.translate([-0.5, -1.0, 0.5])
                               @ tf.scale([0.45] * 3))}
    return mi.load_dict(d)


def _rays(n, seed, finite_frac=0.25):
    """Random rays from a shell around the scene, random times in [0,1]."""
    rng = np.random.default_rng(seed)
    o = rng.uniform(-3.0, 3.0, (n, 3))
    o[:, 2] -= 5.0
    target = rng.uniform(-2.0, 2.0, (n, 3))
    dd = target - o
    dd /= np.linalg.norm(dd, axis=1, keepdims=True)
    maxt = np.full(n, np.inf, np.float32)
    k = int(n * finite_frac)
    maxt[:k] = rng.uniform(3.0, 9.0, k)
    time = rng.uniform(0.0, 1.0, n)
    f32 = lambda a: jnp.asarray(a, jnp.float32)
    return Ray(Vec3(f32(o[:, 0]), f32(o[:, 1]), f32(o[:, 2])),
               Vec3(f32(dd[:, 0]), f32(dd[:, 1]), f32(dd[:, 2])),
               f32(time), f32(maxt))


def _assert_hits_match(hp, hr, label, rtol=2e-4):
    hp = jax.tree_util.tree_map(np.asarray, hp)
    hr = jax.tree_util.tree_map(np.asarray, hr)
    both_miss = (hp.prim < 0) & (hr.prim < 0)
    # near-ties between two primitives may legitimately resolve differently
    # (different summation order); tolerate them only when t agrees
    t_close = np.isclose(hp.t, hr.t, rtol=rtol, atol=1e-5) | both_miss
    assert t_close.mean() == 1.0, (
        f"{label}: t mismatch on {(~t_close).sum()} lanes; "
        f"worst {np.nanmax(np.abs(np.where(np.isfinite(hp.t), hp.t, 0) - np.where(np.isfinite(hr.t), hr.t, 0)))}")
    same_prim = (hp.prim == hr.prim)
    # where the same primitive wins, every payload field must agree
    m = same_prim & ~both_miss
    assert (hp.inst[m] == hr.inst[m]).all(), label
    for f in ("u", "v", "uv_u", "uv_v"):
        a, b = getattr(hp, f)[m], getattr(hr, f)[m]
        assert np.allclose(a, b, rtol=1e-3, atol=1e-4), (label, f)
    # normals: compare directions (unnormalized magnitudes may differ by
    # the det factor between inv-transpose conventions)
    for pre in ("gn", "ns"):
        ap = np.stack([getattr(hp, pre + c)[m] for c in "xyz"], -1)
        ar = np.stack([getattr(hr, pre + c)[m] for c in "xyz"], -1)
        ap /= np.maximum(np.linalg.norm(ap, axis=-1, keepdims=True), 1e-20)
        ar /= np.maximum(np.linalg.norm(ar, axis=-1, keepdims=True), 1e-20)
        cos = (ap * ar).sum(-1)
        assert (cos > 1.0 - 1e-4).all(), (label, pre, cos.min())
    # prim mismatches allowed only at genuine near-ties
    bad = ~same_prim & ~both_miss
    if bad.any():
        assert np.isclose(hp.t[bad], hr.t[bad], rtol=1e-3).all(), (
            label, "prim mismatch at non-tie", bad.sum())


def _closest(sa, ray):
    return ik.closest_hit(sa, ray, interpret=True)


def _any(sa, ray):
    return ik.any_hit(sa, ray, interpret=True)


@pytest.mark.parametrize("animated,spheres", [
    (False, False), (True, False), (False, True), (True, True)])
def test_unrolled_kernel_matches_oracle(tmp_path, animated, spheres):
    """closest_hit / any_hit == _hit_reference, all payloads."""
    sa = _scene(tmp_path, "small", animated, spheres).compile()
    assert sa.n_static_tris + sa.n_anim_tris <= S.SMALL_SCENE_THRESHOLD
    ray = _rays(1024, seed=7)
    hp = _closest(sa, ray)
    hr = _hit_reference(sa, ray)
    _assert_hits_match(hp, hr, f"kernel anim={animated} sph={spheres}")
    occ_p = np.asarray(_any(sa, ray))
    occ_r = np.asarray(hr.prim) >= 0
    assert (occ_p == occ_r).all()


SCENES = {"static": (False, False), "animated": (True, False),
          "spheres": (False, True), "all": (True, True)}


@pytest.mark.parametrize("n", [ik.BLOCK, 777])
@pytest.mark.parametrize("scene", sorted(SCENES))
@pytest.mark.parametrize("query", ["closest", "any"])
def test_kernel_query_matches_oracle(tmp_path, query, scene, n):
    """Each query on each scene kind, with a wavefront that fills whole
    blocks and one that needs padding lanes (maxt = -1)."""
    sa = _scene(tmp_path, "small", *SCENES[scene]).compile()
    ray = _rays(n, seed=n)
    hr = _hit_reference(sa, ray)
    if query == "closest":
        hp = _closest(sa, ray)
        assert hp.t.shape == (n,)
        _assert_hits_match(hp, hr, f"{scene} n={n}")
        assert (np.asarray(hp.prim) == np.asarray(hr.prim)).mean() > 0.99
    else:
        occ = np.asarray(_any(sa, ray))
        assert occ.shape == (n,) and occ.dtype == bool
        assert (occ == (np.asarray(hr.prim) >= 0)).all()


def test_maxt_and_time_clamp_semantics(tmp_path):
    """Rays beyond maxt miss; ray time clamps to the keyframe window
    (reference transform.h:461-466 clamp)."""
    sa = _scene(tmp_path, "small", animated=True, spheres=False).compile()
    n = 256
    rng = np.random.default_rng(5)
    f32 = lambda a: jnp.asarray(a, jnp.float32)
    o = np.tile(np.array([[-1.5, 0.0, -6.0]]), (n, 1))
    d = np.tile(np.array([[0.0, 0.0, 1.0]]), (n, 1))
    times = rng.uniform(-1.0, 2.0, n)       # outside [0,1] must clamp
    ray = Ray(Vec3(f32(o[:, 0]), f32(o[:, 1]), f32(o[:, 2])),
              Vec3(f32(d[:, 0]), f32(d[:, 1]), f32(d[:, 2])),
              f32(times), f32(np.full(n, np.inf)))
    hp = _closest(sa, ray)
    hr = _hit_reference(sa, ray)
    _assert_hits_match(hp, hr, "time clamp")
    # maxt shorter than the first hit -> miss on both paths
    short = ray._replace(maxt=f32(np.full(n, 1e-3)))
    assert (np.asarray(_closest(sa, short).prim) == -1).all()
    assert not np.asarray(_any(sa, short)).any()


@pytest.mark.parametrize("spheres", [False, True])
def test_scene_tables_layout(tmp_path, spheres):
    """Flat record tables: one record per triangle in global slot order,
    one per animated instance and per sphere (at least one of each)."""
    sa = _scene(tmp_path, "small", animated=True, spheres=spheres).compile()
    tri, inst, sph = ik.scene_tables(sa)
    n_tri = sa.n_static_tris + sa.n_anim_tris
    assert tri.shape == (n_tri * ik.TRI_REC,)
    assert inst.shape == (len(sa.anim_ranges) * ik.INST_REC,)
    assert sph.shape == (max(sa.n_spheres, 1) * ik.SPH_REC,)
    rec = np.asarray(tri).reshape(n_tri, ik.TRI_REC)
    # the first animated record carries its instance id and object-space
    # vertex of the animated table
    a0 = sa.n_static_tris
    assert rec[a0, 24] == float(np.asarray(sa.a_inst)[0])
    assert rec[a0, 0] == float(np.asarray(sa.a_v0x)[0])


@pytest.mark.gpu
def test_compiled_kernel_matches_oracle_on_gpu(tmp_path):
    """The kernel as compiled for the card (no interpret mode) against the
    XLA oracle on the same card."""
    sa = _scene(tmp_path, "small", animated=True, spheres=True).compile()
    ray = _rays(1 << 16, seed=21)
    hp = jax.jit(lambda sa, r: ik.closest_hit(sa, r))(sa, ray)
    hr = jax.jit(_hit_reference)(sa, ray)
    _assert_hits_match(hp, hr, "compiled")
    occ = np.asarray(jax.jit(lambda sa, r: ik.any_hit(sa, r))(sa, ray))
    assert (occ == (np.asarray(hr.prim) >= 0)).all()

"""Fused small-scene ray queries for the GPU (Pallas, Triton route).

Brute force over every triangle, animated instance and analytic sphere of
a small scene, one program per block of ``BLOCK`` rays. The ray and its
running closest hit stay in registers for the whole primitive loop, and
the primitive records are uniform scalar loads that all threads of a block
share through the L1 cache. The plain XLA version of the same query
(render/scene.py ``_hit_reference``) writes each lane's best t and index
back to device memory after every triangle instead.

The output is the fat ``HitRecord`` payload of the XLA path: after the loop
each lane gathers its winning triangle's record once and interpolates
normals and uv there. Animated instances enter object space through the
per-lane inverse of the clamped keyframe lerp (reference
transform.h:458-466) and their normals leave it through the inverse
transpose (reference instance.cpp:155-250).

Entry points (reference scene.cpp:125-167):
  * ``closest_hit`` — closest hit, full payload
  * ``any_hit``     — boolean occlusion
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from ..render.types import HitRecord, SPH_SLOT_BASE

BLOCK = 512            # rays per program (a power of two, as Triton needs)
NUM_WARPS = 4

# flat record layouts (floats)
#  triangle: v0, e1, e2 (0:9), n0, n1, n2 (9:18), uv0, uv1, uv2 (18:24), inst
#  animated instance: m0 (3x4, 0:12), m1 (12:24), t0, t1
#  sphere: m0 (0:12), m1 (12:24), t0, t1, inst
TRI_REC = 25
INST_REC = 26
SPH_REC = 27
_TRI_COLS = ("v0x", "v0y", "v0z", "e1x", "e1y", "e1z", "e2x", "e2y", "e2z",
             "n0x", "n0y", "n0z", "n1x", "n1y", "n1z", "n2x", "n2y", "n2z",
             "uv0u", "uv0v", "uv1u", "uv1v", "uv2u", "uv2v")


def _lerp_weight(tw0, tw1, time):
    span = tw1 - tw0
    return jnp.clip((time - tw0) / jnp.where(span != 0.0, span, 1.0),
                    0.0, 1.0)


def _affine_inverse(c):
    """Inverse of a row-major 3x4 affine matrix given as 12 values.
    Returns (inverse 3x3 as 9 values, inverse translation as 3)."""
    a00, a01, a02, t0, a10, a11, a12, t1, a20, a21, a22, t2 = c
    c00 = a11 * a22 - a12 * a21
    c01 = a02 * a21 - a01 * a22
    c02 = a01 * a12 - a02 * a11
    c10 = a12 * a20 - a10 * a22
    c11 = a00 * a22 - a02 * a20
    c12 = a02 * a10 - a00 * a12
    c20 = a10 * a21 - a11 * a20
    c21 = a01 * a20 - a00 * a21
    c22 = a00 * a11 - a01 * a10
    inv = 1.0 / (a00 * c00 + a01 * c10 + a02 * c20)
    i = (c00 * inv, c01 * inv, c02 * inv, c10 * inv, c11 * inv, c12 * inv,
         c20 * inv, c21 * inv, c22 * inv)
    it = (-(i[0] * t0 + i[1] * t1 + i[2] * t2),
          -(i[3] * t0 + i[4] * t1 + i[5] * t2),
          -(i[6] * t0 + i[7] * t1 + i[8] * t2))
    return i, it


def _lerped_inverse(ref, base, time):
    """Per-lane inverse of the keyframe lerp stored at ``ref[base:]``."""
    m0 = [ref[base + j] for j in range(12)]
    m1 = [ref[base + 12 + j] for j in range(12)]
    uu = _lerp_weight(ref[base + 24], ref[base + 25], time)
    return _affine_inverse([a * (1.0 - uu) + b * uu for a, b in zip(m0, m1)])


def _to_object(i3, it3, o, d):
    ox, oy, oz = o
    dx, dy, dz = d
    return ((i3[0] * ox + i3[1] * oy + i3[2] * oz + it3[0],
             i3[3] * ox + i3[4] * oy + i3[5] * oz + it3[1],
             i3[6] * ox + i3[7] * oy + i3[8] * oz + it3[2]),
            (i3[0] * dx + i3[1] * dy + i3[2] * dz,
             i3[3] * dx + i3[4] * dy + i3[5] * dz,
             i3[6] * dx + i3[7] * dy + i3[8] * dz))


def _inv_transpose(i3, x, y, z):
    return (i3[0] * x + i3[3] * y + i3[6] * z,
            i3[1] * x + i3[4] * y + i3[7] * z,
            i3[2] * x + i3[5] * y + i3[8] * z)


def _moller(r, o, d):
    """Möller-Trumbore against one triangle record ``r`` (v0, e1, e2)."""
    v0x, v0y, v0z, e1x, e1y, e1z, e2x, e2y, e2z = r
    ox, oy, oz = o
    dx, dy, dz = d
    px = dy * e2z - dz * e2y
    py = dz * e2x - dx * e2z
    pz = dx * e2y - dy * e2x
    det = e1x * px + e1y * py + e1z * pz
    ok = jnp.abs(det) > 1e-12
    inv = 1.0 / jnp.where(ok, det, 1.0)
    tx = ox - v0x
    ty = oy - v0y
    tz = oz - v0z
    u = (tx * px + ty * py + tz * pz) * inv
    qx = ty * e1z - tz * e1y
    qy = tz * e1x - tx * e1z
    qz = tx * e1y - ty * e1x
    v = (dx * qx + dy * qy + dz * qz) * inv
    t = (e2x * qx + e2y * qy + e2z * qz) * inv
    ok = ok & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0) & (t > 0.0)
    return t, u, v, ok


def _sphere(o, d):
    """Nearest positive root of the object-space unit sphere (reference
    src/shapes/sphere.cpp ray_intersect_preliminary)."""
    ox, oy, oz = o
    dx, dy, dz = d
    a = dx * dx + dy * dy + dz * dz
    b = 2.0 * (ox * dx + oy * dy + oz * dz)
    c = ox * ox + oy * oy + oz * oz - 1.0
    disc = b * b - 4.0 * a * c
    sq = jnp.sqrt(jnp.maximum(disc, 0.0))
    q = -0.5 * (b + jnp.where(b >= 0.0, sq, -sq))
    t0 = q / jnp.where(a != 0.0, a, 1.0)
    t1 = c / jnp.where(q != 0.0, q, 1.0)
    tn = jnp.minimum(t0, t1)
    t = jnp.where(tn > 0.0, tn, jnp.maximum(t0, t1))
    return t, (disc >= 0.0) & (t > 0.0)


def _kernel(tri_ref, inst_ref, sph_ref, ox_ref, oy_ref, oz_ref,
            dx_ref, dy_ref, dz_ref, time_ref, maxt_ref, *out_refs,
            n_static, anim_ranges, sphere_animated, any_hit):
    o = (ox_ref[...], oy_ref[...], oz_ref[...])
    d = (dx_ref[...], dy_ref[...], dz_ref[...])
    time = time_ref[...]
    maxt = maxt_ref[...]
    zero = jnp.zeros_like(maxt)

    # carry: best t, best slot, and (closest hit) its barycentrics
    carry = (jnp.full_like(maxt, jnp.inf),
             jnp.full(maxt.shape, -1, jnp.int32))
    if not any_hit:
        carry += (zero, zero)

    def triangles(lo, hi, o_, d_, carry):
        def body(i, c):
            t, u, v, ok = _moller(
                [tri_ref[i * TRI_REC + j] for j in range(9)], o_, d_)
            hit = ok & (t < maxt) & (t < c[0])
            out = (jnp.where(hit, t, c[0]), jnp.where(hit, i, c[1]))
            if not any_hit:
                out += (jnp.where(hit, u, c[2]), jnp.where(hit, v, c[3]))
            return out
        return jax.lax.fori_loop(lo, hi, body, carry)

    carry = triangles(0, n_static, o, d, carry)
    for a, (_, start, count) in enumerate(anim_ranges):
        i3, it3 = _lerped_inverse(inst_ref, a * INST_REC, time)
        o_a, d_a = _to_object(i3, it3, o, d)
        carry = triangles(n_static + start, n_static + start + count,
                          o_a, d_a, carry)

    # analytic spheres, each with its own payload kept where it wins
    bt, bp = carry[0], carry[1]
    sg = [zero, zero, zero]
    s_uv = [zero, zero]
    s_inst = jnp.full(maxt.shape, -1, jnp.int32)
    for s, animated in enumerate(sphere_animated):
        base = s * SPH_REC
        if animated:
            i3, it3 = _lerped_inverse(sph_ref, base, time)
        else:
            i3, it3 = _affine_inverse([sph_ref[base + j] for j in range(12)])
        o_s, d_s = _to_object(i3, it3, o, d)
        t, ok = _sphere(o_s, d_s)
        hit = ok & (t < maxt) & (t < bt)
        bt = jnp.where(hit, t, bt)
        bp = jnp.where(hit, SPH_SLOT_BASE + s, bp)
        if not any_hit:
            # object-space normal = hit point; to world by inverse transpose
            pn = [oc + t * dc for oc, dc in zip(o_s, d_s)]
            wn = _inv_transpose(i3, *pn)
            sg = [jnp.where(hit, w, g) for w, g in zip(wn, sg)]
            u = jnp.arctan2(pn[1], pn[0]) * 0.15915494309189535
            u = jnp.where(u < 0.0, u + 1.0, u)
            v = jnp.arccos(jnp.clip(pn[2], -1.0, 1.0)) * 0.3183098861837907
            s_uv = [jnp.where(hit, u, s_uv[0]), jnp.where(hit, v, s_uv[1])]
            s_inst = jnp.where(hit, sph_ref[base + 26].astype(jnp.int32),
                               s_inst)

    if any_hit:
        out_refs[0][...] = (bp >= 0).astype(jnp.int32)
        return

    # triangle payload from the winner's record, gathered once per lane
    bu, bv = carry[2], carry[3]
    is_sph = bp >= SPH_SLOT_BASE
    slot = jnp.where((bp >= 0) & ~is_sph, bp, 0) * TRI_REC
    r = [tri_ref[slot + j] for j in range(TRI_REC)]
    w = 1.0 - bu - bv
    e1, e2 = r[3:6], r[6:9]
    g = [e1[1] * e2[2] - e1[2] * e2[1],
         e1[2] * e2[0] - e1[0] * e2[2],
         e1[0] * e2[1] - e1[1] * e2[0]]
    n = [w * r[9 + k] + bu * r[12 + k] + bv * r[15 + k] for k in range(3)]
    uv = [w * r[18 + k] + bu * r[20 + k] + bv * r[22 + k] for k in range(2)]
    for a, (_, start, count) in enumerate(anim_ranges):
        m = (bp >= n_static + start) & (bp < n_static + start + count)
        i3, _ = _lerped_inverse(inst_ref, a * INST_REC, time)
        g = [jnp.where(m, x, y) for x, y in zip(_inv_transpose(i3, *g), g)]
        n = [jnp.where(m, x, y) for x, y in zip(_inv_transpose(i3, *n), n)]

    inst = jnp.where(is_sph, s_inst, r[24].astype(jnp.int32))
    outs = (bt, bp, jnp.where(bp >= 0, inst, -1),
            jnp.where(is_sph, 0.0, bu), jnp.where(is_sph, 0.0, bv),
            *[jnp.where(is_sph, x, y) for x, y in zip(sg, g)],
            *[jnp.where(is_sph, x, y) for x, y in zip(sg, n)],
            *[jnp.where(is_sph, x, y) for x, y in zip(s_uv, uv)])
    for ref, val in zip(out_refs, outs):
        ref[...] = val


@functools.lru_cache(maxsize=64)
def _call(n_pad: int, n_static: int, anim_ranges, sphere_animated,
          any_hit: bool, interpret: bool):
    kernel = functools.partial(
        _kernel, n_static=n_static, anim_ranges=anim_ranges,
        sphere_animated=sphere_animated, any_hit=any_hit)
    lanes = pl.BlockSpec((BLOCK,), lambda i: (i,))
    whole = pl.BlockSpec()            # primitive tables: the whole array
    f32, i32 = jnp.float32, jnp.int32
    dtypes = [i32] if any_hit else [f32, i32, i32] + [f32] * 10
    return pl.pallas_call(
        kernel,
        grid=(n_pad // BLOCK,),
        in_specs=[whole] * 3 + [lanes] * 8,
        out_specs=[lanes] * len(dtypes),
        out_shape=[jax.ShapeDtypeStruct((n_pad,), dt) for dt in dtypes],
        compiler_params=plgpu.CompilerParams(num_warps=NUM_WARPS,
                                             num_stages=1),
        interpret=interpret,
        name="closest_hit" if not any_hit else "any_hit",
    )


def scene_tables(sa):
    """Flat triangle, animated-instance and sphere record tables of a
    scene, in global slot order (static triangles, then animated)."""
    def tri_table(prefix, n):
        if n == 0:
            return jnp.zeros((0, TRI_REC), jnp.float32)
        cols = [sa.tri(prefix, c)[:n] for c in _TRI_COLS]
        cols.append(sa.tri(prefix, "inst")[:n].astype(jnp.float32))
        return jnp.stack(cols, axis=-1)

    tri = jnp.concatenate([tri_table("s", sa.n_static_tris),
                           tri_table("a", sa.n_anim_tris)], axis=0)
    if tri.shape[0] == 0:
        tri = jnp.zeros((1, TRI_REC), jnp.float32)
    inst = jnp.stack([jnp.concatenate([
        sa.inst_m0c[:, i], sa.inst_m1c[:, i],
        sa.inst_t0[i][None], sa.inst_t1[i][None]])
        for i, _, _ in sa.anim_ranges]) if sa.anim_ranges else \
        jnp.zeros((1, INST_REC), jnp.float32)
    sph = jnp.concatenate([
        sa.sph_m0c.T, sa.sph_m1c.T, sa.sph_t0[:, None], sa.sph_t1[:, None],
        sa.sph_inst[:, None].astype(jnp.float32)], axis=1) \
        if sa.n_spheres else jnp.zeros((1, SPH_REC), jnp.float32)
    return tri.reshape(-1), inst.reshape(-1), sph.reshape(-1)


def _run(sa, ray, any_hit: bool, interpret: bool):
    n = ray.o.x.shape[0]
    n_pad = -(-n // BLOCK) * BLOCK

    def pad(x, fill=0.0):
        if n_pad == n:
            return x
        return jnp.concatenate([x, jnp.full((n_pad - n,), fill, x.dtype)])

    fn = _call(n_pad, sa.n_static_tris, tuple(sa.anim_ranges),
               tuple(bool(a) for a in sa.sphere_animated[:sa.n_spheres]),
               any_hit, interpret)
    # padding lanes get maxt = -1: no primitive can be closer
    outs = fn(*scene_tables(sa), pad(ray.o.x), pad(ray.o.y), pad(ray.o.z),
              pad(ray.d.x), pad(ray.d.y), pad(ray.d.z), pad(ray.time),
              pad(ray.maxt, fill=-1.0))
    return [x[:n] for x in outs]


def closest_hit(sa, ray, interpret: bool = False) -> HitRecord:
    return HitRecord(*_run(sa, ray, any_hit=False, interpret=interpret))


def any_hit(sa, ray, interpret: bool = False):
    (occ,) = _run(sa, ray, any_hit=True, interpret=interpret)
    return occ > 0


__all__ = ["closest_hit", "any_hit", "scene_tables", "BLOCK"]

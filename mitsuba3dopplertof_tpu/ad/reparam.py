"""Warped-area ray reparameterization for visibility/silhouette gradients.

Implements "Unbiased Warped-Area Sampling for Differentiable Rendering"
(Bangaru, Li, Durand, SIGGRAPH'20) following the reference's estimator
(reference src/python/python/ad/reparam.py:10-123 `_sample_warp_field`,
:126-409 `_ReparameterizeOp`) — but JAX-native: instead of a Dr.Jit
CustomOp with hand-written forward/backward replay loops, the estimator is
expressed with stop-gradient algebra so that

  * the PRIMAL value is exactly (ray.d, det=1)  — identity, zero variance;
  * the TANGENT carries the warp field V_theta (direction derivative) and
    its divergence (the Jacobian determinant derivative),

and plain ``jax.grad`` / ``jax.jvp`` through the render pass produce the
boundary terms. The auxiliary-ray loop is a static Python unroll
(``num_rays`` is small), matching the reference's unrolled wavefront mode.

Per auxiliary ray (reference reparam.py:78-123):
  * direction from a von Mises-Fisher lobe around ray.d (kappa);
  * an intersection whose position FOLLOWS the intersected shape —
    barycentrics and primitive held fixed, position recomputed from the
    attached geometry tables (the analog of RayFlags.FollowShape,
    reference interaction.h:515);
  * harmonic weight w from the shape's boundary test B (edge proximity:
    mesh.cpp:835-859, sphere.cpp:570) and the inverse vMF density, with
    the analytic tangential weight gradient dZ.
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

from ..core.vec import (Vec3, dot, cross, normalize, where3,
                        coordinate_system, cmat_lerp, cmat_apply_point,
                        cmat_apply_vector)
from ..render.types import Ray
from ..render.scene import _hit_reference, gather_small

sg = jax.lax.stop_gradient


def _sg3(v: Vec3) -> Vec3:
    return Vec3(sg(v.x), sg(v.y), sg(v.z))


def square_to_von_mises_fisher(sx, sy, kappa: float):
    """vMF sample around +z (reference include/mitsuba/core/warp.h
    square_to_von_mises_fisher): z via inverse CDF, azimuth uniform.
    Uses the expm1 formulation so inv-density in the weight matches."""
    # cos(theta) = 1 + log((1-sy) + sy e^{-2k}) / k — this convention makes
    # the unnormalized density at the sample exactly (1-sy) + sy e^{-2k},
    # i.e. inv_vmf_density = 1/(sy e^{-2k} + (1-sy)) as in reference
    # reparam.py:111 (the weight formula and the sampler MUST pair up)
    expm2k = np.float32(np.exp(-2.0 * kappa))
    z = 1.0 + jnp.log((1.0 - sy) + sy * expm2k) / np.float32(kappa)
    r = jnp.sqrt(jnp.maximum(1.0 - z * z, 0.0))
    phi = (2.0 * np.pi) * sx
    return Vec3(r * jnp.cos(phi), r * jnp.sin(phi), z)


def _followshape_position(sa, hit, time, ray_o=None, ray_d=None) -> Vec3:
    """Attached hit position at FIXED (prim, barycentrics): recomputed from
    the (differentiable) triangle tables and instance keyframe matrices —
    the analog of RayFlags.FollowShape (reference interaction.h:515).
    Sphere hits follow their instance matrix EXACTLY for any affine motion
    (rotation/scale/translation): the detached world hit point is pulled
    into object space through the detached inverse matrix and pushed back
    through the attached one, so the tangent is dM applied at the fixed
    object point. Requires ``ray_o``/``ray_d`` (the ray that produced
    ``hit``) when the scene has spheres."""
    from ..render.types import SPH_SLOT_BASE as _SPH_SLOT_BASE
    prim = sg(hit.prim)
    u = sg(hit.u)
    v = sg(hit.v)
    is_anim = prim >= sa.n_static_tris
    is_sph = prim >= _SPH_SLOT_BASE

    s_idx = jnp.clip(prim, 0, max(sa.n_static_tris - 1, 0))
    a_idx = jnp.clip(prim - sa.n_static_tris, 0,
                     max(sa.n_anim_tris - 1, 0))

    def tri_p(pre, idx):
        v0 = Vec3(sa.tri(pre, "v0x")[idx], sa.tri(pre, "v0y")[idx],
                  sa.tri(pre, "v0z")[idx])
        e1 = Vec3(sa.tri(pre, "e1x")[idx], sa.tri(pre, "e1y")[idx],
                  sa.tri(pre, "e1z")[idx])
        e2 = Vec3(sa.tri(pre, "e2x")[idx], sa.tri(pre, "e2y")[idx],
                  sa.tri(pre, "e2z")[idx])
        return v0 + e1 * u + e2 * v

    p = tri_p("s", s_idx)
    if sa.n_anim_tris > 0:
        p_obj = tri_p("a", a_idx)
        # transform by the attached keyframe lerp at the ray's time
        inst = sg(jnp.maximum(hit.inst, 0))
        c0 = tuple(sa.inst_m0c[j, inst] for j in range(12))
        c1 = tuple(sa.inst_m1c[j, inst] for j in range(12))
        t0 = sg(sa.inst_t0)[inst]
        t1 = sg(sa.inst_t1)[inst]
        span = t1 - t0
        uu = jnp.clip((time - t0) / jnp.where(span != 0.0, span, 1.0),
                      0.0, 1.0)
        c_t = cmat_lerp(c0, c1, uu)
        p = where3(is_anim & ~is_sph, cmat_apply_point(c_t, p_obj), p)
    if sa.n_spheres > 0:
        assert ray_o is not None and ray_d is not None, \
            "sphere follow-shape needs the originating ray"
        s_slot = jnp.clip(prim - _SPH_SLOT_BASE, 0, sa.n_spheres - 1)
        c0s = tuple(sa.sph_m0c[j, s_slot] for j in range(12))
        c1s = tuple(sa.sph_m1c[j, s_slot] for j in range(12))
        t0s = sg(sa.sph_t0)[s_slot]
        t1s = sg(sa.sph_t1)[s_slot]
        span_s = t1s - t0s
        us = jnp.clip((time - t0s) / jnp.where(span_s != 0.0, span_s, 1.0),
                      0.0, 1.0)
        c_ts = cmat_lerp(c0s, c1s, us)
        # detached world hit point -> object space via the detached
        # adjugate inverse -> back through the ATTACHED matrix
        t_hit = sg(jnp.where(jnp.isfinite(hit.t), hit.t, 0.0))
        pw = _sg3(ray_o) + _sg3(ray_d) * t_hit
        cd = tuple(sg(c) for c in c_ts)
        a00, a01, a02, b0, a10, a11, a12, b1, a20, a21, a22, b2 = cd
        i00 = a11 * a22 - a12 * a21
        i01 = a02 * a21 - a01 * a22
        i02 = a01 * a12 - a02 * a11
        i10 = a12 * a20 - a10 * a22
        i11 = a00 * a22 - a02 * a20
        i12 = a02 * a10 - a00 * a12
        i20 = a10 * a21 - a11 * a20
        i21 = a01 * a20 - a00 * a21
        i22 = a00 * a11 - a01 * a10
        det = a00 * i00 + a01 * i10 + a02 * i20
        inv = 1.0 / jnp.where(jnp.abs(det) > 1e-30, det, 1.0)
        rx = pw.x - b0
        ry = pw.y - b1
        rz = pw.z - b2
        q = Vec3((i00 * rx + i01 * ry + i02 * rz) * inv,
                 (i10 * rx + i11 * ry + i12 * rz) * inv,
                 (i20 * rx + i21 * ry + i22 * rz) * inv)
        p = where3(is_sph, cmat_apply_point(c_ts, q), p)
    return p


def _boundary_test(sa, hit, d: Vec3) -> jnp.ndarray:
    """Silhouette-proximity measure B in [0, ~1]: 0 on a visibility
    boundary. Meshes: barycentric distance to the nearest edge scaled so
    the barycenter is 1 (the flat-shading branch of mesh.cpp:835-852);
    spheres: |dot(n, -d)| (sphere.cpp:570)."""
    from ..render.types import SPH_SLOT_BASE as _SPH_SLOT_BASE
    u, v = hit.u, hit.v
    w = 1.0 - u - v
    b_mesh = 3.0 * jnp.minimum(jnp.minimum(u, v), w)
    is_sph = hit.prim >= _SPH_SLOT_BASE
    if sa.n_spheres > 0:
        n = normalize(Vec3(hit.gnx, hit.gny, hit.gnz))
        b_sph = jnp.abs(-(n.x * d.x + n.y * d.y + n.z * d.z))
        return jnp.where(is_sph, b_sph, b_mesh)
    return b_mesh


def reparameterize_ray(sa, sampler, state, ray: Ray, active,
                       num_rays: int = 8, kappa: float = 1e5,
                       exponent: float = 3.0, antithetic: bool = False):
    """Returns ``(d_new: Vec3, det, state)``. Primal: (ray.d, 1). Tangents:
    the warp field direction derivative and the divergence (Jacobian)
    derivative (reference reparam.py:410-462 reparameterize_ray)."""
    d0 = _sg3(ray.d)
    o0 = ray.o                      # may carry gradients (follow-shape si)
    fs, ft = coordinate_system(d0)
    n = ray.time.shape[0]
    f32 = jnp.float32

    Z = jnp.zeros((n,), f32)
    dZ = Vec3.zeros((n,))
    V = Vec3.zeros((n,))
    div_lhs = jnp.zeros((n,), f32)

    prev = None
    for i in range(num_rays):
        if antithetic and (i & 1) == 1 and prev is not None:
            sx, sy = prev
            flip = True
        else:
            s2, state = sampler.next_2d(state, active)
            sx, sy = s2[0], s2[1]
            prev = (sx, sy)
            flip = False
        om = square_to_von_mises_fisher(sx, sy, kappa)
        if flip:
            om = Vec3(-om.x, -om.y, om.z)
        aux_d = fs * om.x + ft * om.y + d0 * om.z

        aux_ray = Ray(_sg3(o0), _sg3(aux_d), ray.time,
                      jnp.full((n,), np.inf, f32))
        hit = _hit_reference(sa, aux_ray)
        hit_ok = hit.prim >= 0

        # attached direction following the intersected shape
        p_follow = _followshape_position(sa, hit, ray.time,
                                         ray_o=aux_ray.o, ray_d=aux_ray.d)
        V_direct = normalize(p_follow - o0)
        V_direct = where3(hit_ok, V_direct, Vec3(aux_d.x, aux_d.y, aux_d.z))

        # ---- detached harmonic weight + analytic tangential gradient ----
        B = jnp.where(hit_ok, sg(_boundary_test(sa, hit, aux_d)), 1.0)
        expm2k = np.float32(np.exp(-2.0 * kappa))
        inv_vmf = 1.0 / (sg(sy) * expm2k + (1.0 - sg(sy)))
        w_denom = inv_vmf - 1.0 + B
        w_denom_rcp = jnp.where(w_denom > 1e-4, 1.0 / w_denom, 0.0)
        wgt = jnp.power(w_denom_rcp, np.float32(exponent)) * inv_vmf
        tmp1 = jnp.clip(inv_vmf * wgt * w_denom_rcp
                        * np.float32(kappa * exponent), -1e10, 1e10)
        d_w_omega = (fs * sg(om.x) + ft * sg(om.y)) * tmp1

        Z = Z + wgt
        dZ = dZ + d_w_omega
        V = V + V_direct * wgt
        div_lhs = div_lhs + dot(d_w_omega, V_direct)

    inv_Z = 1.0 / jnp.maximum(sg(Z), 1e-8)
    V_theta = V * inv_Z
    divergence = (div_lhs - dot(V_theta, dZ)) * inv_Z

    # primal-identity via stop-gradient zeroing: value is exactly
    # (ray.d, 1); tangents carry (dV_theta, d divergence)
    V_zero = V_theta - _sg3(V_theta)
    div_zero = divergence - sg(divergence)
    act = jnp.asarray(active)
    # base direction detached, as in the reference (_ReparameterizeOp.eval
    # stores dr.detach(ray)); the tangent is the perpendicular projection
    # of dV_theta
    d_new = normalize(d0 + where3(act, V_zero, Vec3.zeros((n,))))
    det = 1.0 + jnp.where(act, div_zero, 0.0)
    return d_new, det, state


__all__ = ["reparameterize_ray", "square_to_von_mises_fisher"]

"""Adjoint particle tracer (reference src/integrators/ptracer.cpp).

Traces light paths from the emitters and connects every vertex to the
sensor. Connections land in arbitrary pixels, so this integrator uses a
real scatter-add into the film (the one place the renderer needs one; the
camera-path integrators stay scatter-free).

Emitter support: point, spot, directional, rectangle/sphere/mesh area,
constant and envmap environments (environments emit from the scene
bounding sphere, reference constant.cpp/envmap.cpp sample_ray). Sensor:
perspective pinhole with the reference's importance
W = (1/A)/cos^3(theta)/dist^2 (reference perspective.cpp
sample_direction + importance():384).

Under tpu_rgb_polarized the light path carries a full Stokes vector with
exact photon-order Mueller factors at polarizing interactions
(conductors, dielectrics, polarizer/retarder elements, measured pBRDFs
— polarized.light_bounce_mueller), matching the reference's polarized
adjoint transport; Malus's-law and camera-path agreement tests in
tests/test_polarized.py::test_ptracer_mueller_malus_law. The film
records S0 (basis-rotation invariant, so no final sensor rotation).
"""

from __future__ import annotations

import math
import os

import numpy as np
import jax
import jax.numpy as jnp

from ..core.properties import Properties, register_plugin
from ..core.vec import Vec3, dot, normalize, where3, vmax, cross
from ..core import warp
from ..render.scene import ray_intersect, ray_test, gather_small
from ..render.types import Ray, SHADOW_EPSILON
from ..bsdfs import eval_pdf_sample as bsdf_eval_pdf_sample
from ..emitters import (EMITTER_POINT, EMITTER_AREA_RECT, EMITTER_CONSTANT,
                        EMITTER_AREA_MESH, EMITTER_DIRECTIONAL, EMITTER_SPOT,
                        EMITTER_ENVMAP, EMITTER_AREA_SPHERE,
                        EMITTER_PROJECTOR, EMITTER_DIRECTIONALAREA,
                        E_POS, E_INTENSITY, E_AREA, E_CUTOFF, E_BEAM,
                        envmap_eval)
from ..films import develop, block_splat_scatter
from . import SamplingIntegrator, DEFAULT_MAX_LANES

# emitter types with a finite (non-delta) emitting surface: these have a
# direct emitter->sensor connection term (the reference's
# sample_visible_emitters, ptracer.cpp:80-81); delta emitters (point, spot,
# directional) evaluate to zero through a pinhole and contribute only via
# bounces, matching Endpoint::eval == 0 in the reference.
_SURFACE_EMITTERS = (EMITTER_AREA_RECT, EMITTER_AREA_SPHERE,
                     EMITTER_AREA_MESH, EMITTER_CONSTANT, EMITTER_ENVMAP)


@register_plugin("integrator", "ptracer")
class PTracerIntegrator(SamplingIntegrator):
    """Particle tracer; ``samples per pixel`` means light paths per pixel
    (reference ptracer.cpp sample-count semantics)."""

    def __init__(self, props: Properties):
        super().__init__(props)
        md = props.get_int("max_depth", -1)
        self.max_depth = 2 ** 31 if md == -1 else md
        self.rr_depth = props.get_int("rr_depth", 5)
        # gates the direct emitter->sensor connection (the reference's
        # sample_visible_emitters call, ptracer.cpp:80-81)
        self.hide_emitters = props.get_bool("hide_emitters", False)

    @property
    def loop_iterations(self):
        return min(self.max_depth, 32)

    spectral_mode = "hero"

    def render(self, scene, sensor=None, seed: int = 0, spp: int = 0,
               *_ptracer_args_guard, **_ptracer_kw_guard):
        return self._render_impl(scene, sensor=sensor, seed=seed, spp=spp,
                                 *_ptracer_args_guard, **_ptracer_kw_guard)

    def _render_impl(self, scene, sensor=None, seed: int = 0, spp: int = 0,
               develop_film: bool = True, max_lanes: int = DEFAULT_MAX_LANES,
               **_):
        if sensor is None:
            sensor = scene.sensor
        film = sensor.film
        sampler = sensor.sampler
        if spp:
            sampler.set_sample_count(spp)
        spp = sampler.sample_count
        W, H = film.crop_size

        n_total = W * H * spp
        n_pass = min(n_total, max_lanes)
        # keep passes equal-sized
        n_passes = -(-n_total // n_pass)
        n_pass = -(-n_total // n_passes)

        sampler.set_samples_per_wavefront(1)
        sampler.sample_count = 1
        state = sampler.seed(seed, n_pass)
        sa = scene.compile()

        sp = sensor.device_params()
        kind = getattr(sp, "kind", None)
        if kind not in (0, 1, 2):
            raise RuntimeError(
                "ptracer: only perspective, thinlens and orthographic/"
                f"distant sensors are supported (got sensor kind {kind!r});"
                " use a camera-path integrator for meters/batch sensors")
        # thinlens: one lens sample per light path; the splat maps vertices
        # to film through the sampled lens point (reference thinlens.cpp
        # sample_direction) — the (1/A)/cos^3/d^2 importance is unchanged,
        # evaluated from the lens point (the 1/(pi R^2) aperture pdf
        # cancels the aperture area in the lens importance)
        lens = sensor.device_lens_params() if kind == 1 else None
        tan_x, tan_y = sp.tan_half_x, sp.tan_half_y
        pp_ox, pp_oy = sp.pp_ox, sp.pp_oy
        A_rect = 4.0 * tan_x * tan_y
        cam = sp.m
        if kind == 2:
            # orthographic/distant: the to_world columns carry the film
            # extent; connections travel along the fixed view axis and the
            # importance is 1/(film world area) with no cos/dist falloff
            # (reference orthographic.cpp sample_direction)
            s0sq = cam[0] ** 2 + cam[4] ** 2 + cam[8] ** 2
            s1sq = cam[1] ** 2 + cam[5] ** 2 + cam[9] ** 2
            s2 = math.sqrt(cam[2] ** 2 + cam[6] ** 2 + cam[10] ** 2)
            view = (cam[2] / s2, cam[6] / s2, cam[10] / s2)
            A_ortho = 4.0 * math.sqrt(s0sq * s1sq)

        integrator = self

        @jax.jit
        def light_pass(sa, block, state):
            n = n_pass
            active = jnp.ones((n,), bool)

            # ---- sample an emitter ray (reference sample_emitter_ray,
            # ptracer.cpp; masked multi-type dispatch over the emitter
            # table, the pattern of emitters.sample_direction) ------------
            s_sel, state = sampler.next_1d(state, active)
            pos2, state = sampler.next_2d(state, active)
            dir2, state = sampler.next_2d(state, active)
            s_tri, state = sampler.next_1d(state, active)
            if lens is not None:
                ap_r, focus_d = lens
                ap2, state = sampler.next_2d(state, active)
                from ..core.warp import disk_concentric_c
                lpx, lpy = disk_concentric_c(ap2[0], ap2[1])
                lpx = lpx * ap_r
                lpy = lpy * ap_r
            else:
                lpx = lpy = jnp.zeros((n,), jnp.float32)
            if sa.spectral:
                # hero-wavelength sampling (one draw -> 3 rotated
                # wavelengths; integrator.cpp:497-499)
                from ..core.cie import LAMBDA_MIN, LAMBDA_RANGE
                wls, state = sampler.next_1d(state, active)

                def hero(k):
                    u = wls + k * (1.0 / 3.0)
                    u = u - jnp.floor(u)
                    return LAMBDA_MIN + u * LAMBDA_RANGE
                wavelengths = Vec3(hero(0), hero(1), hero(2))
            else:
                wavelengths = None
            ne = max(sa.n_emitters, 1)
            idx = jnp.minimum((s_sel * ne).astype(jnp.int32), ne - 1)

            def epar(j):
                return gather_small(sa.emitter_params[j], idx)

            def erow(j):
                return gather_small(sa.emitter_m[j], idx)

            from ..core.vec import coordinate_system

            def frame_dir(nv, lv):
                t1, t2 = coordinate_system(nv)
                return t1 * lv.x + t2 * lv.y + nv * lv.z

            etype = gather_small(sa.emitter_type, idx)
            # rgb intensity, or the emission SPD at the hero wavelengths
            # under tpu_spectral (srgb.cpp emission upsampling)
            from ..emitters import _lane_intensity
            rad = _lane_intensity(epar, wavelengths)
            zero = jnp.zeros((n,), jnp.float32)
            z3 = Vec3(zero, zero, zero)
            no = zero > 1.0
            # cosine-hemisphere local direction shared by all surface types
            loc = warp.cosine_hemisphere_c(dir2[0], dir2[1])
            # world-space aperture point (== camera origin for a pinhole)
            lens_w = Vec3(cam[0] * lpx + cam[1] * lpy + cam[3],
                          cam[4] * lpx + cam[5] * lpy + cam[7],
                          cam[8] * lpx + cam[9] * lpy + cam[11])
            R_b = jnp.asarray(sa.bsphere_radius, jnp.float32)
            C_b = sa.bsphere_center
            area_b = 4.0 * math.pi * R_b * R_b

            # candidate tuple per type:
            # (o, d, emit_n, w=L/p(o)/p(d)*cos, direct=L_cam/p(o), surface?)
            best = None
            for tid in sa.emitter_types_present:
                if tid == EMITTER_POINT:
                    d_c = warp.uniform_sphere_c(dir2[0], dir2[1])
                    o_c = Vec3(epar(E_POS), epar(E_POS + 1), epar(E_POS + 2))
                    cand = (o_c, d_c, d_c, rad * (4.0 * math.pi), z3, no)
                elif tid == EMITTER_SPOT:
                    # uniform cone within the cutoff; radiant intensity
                    # follows the falloff curve (reference spot.cpp
                    # sample_ray): w = I*falloff / (1/(2pi(1-cos_cutoff)))
                    o_c = Vec3(epar(E_POS), epar(E_POS + 1), epar(E_POS + 2))
                    axis = Vec3(epar(9), epar(10), epar(11))
                    cc = epar(E_CUTOFF)
                    cb = epar(E_BEAM)
                    cos_t = (1.0 - dir2[1]) + dir2[1] * cc
                    sin_t = jnp.sqrt(jnp.maximum(1.0 - cos_t * cos_t, 0.0))
                    phi = 2.0 * math.pi * dir2[0]
                    t1a, t2a = coordinate_system(axis)
                    d_c = (t1a * (jnp.cos(phi) * sin_t)
                           + t2a * (jnp.sin(phi) * sin_t) + axis * cos_t)
                    fall = jnp.clip((cos_t - cc)
                                    / jnp.maximum(cb - cc, 1e-6), 0.0, 1.0)
                    w_c = rad * (fall * 2.0 * math.pi * (1.0 - cc))
                    cand = (o_c, d_c, d_c, w_c, z3, no)
                elif tid == EMITTER_DIRECTIONAL:
                    # disk covering the scene bsphere, pushed back to its
                    # far side (reference directional.cpp sample_ray);
                    # w = irradiance * pi * r^2 (pos pdf 1/(pi r^2))
                    dl = Vec3(epar(E_POS), epar(E_POS + 1), epar(E_POS + 2))
                    t1a, t2a = coordinate_system(dl)
                    px, py = warp.disk_concentric_c(pos2[0], pos2[1])
                    o_c = Vec3(C_b[0] - dl.x * R_b, C_b[1] - dl.y * R_b,
                               C_b[2] - dl.z * R_b)
                    o_c = o_c + (t1a * px + t2a * py) * R_b
                    w_c = rad * (math.pi * R_b * R_b)
                    cand = (o_c, dl, dl, w_c, z3, no)
                elif tid == EMITTER_AREA_RECT:
                    # uniform position (pdf 1/A), cosine direction
                    lx = 2.0 * pos2[0] - 1.0
                    ly = 2.0 * pos2[1] - 1.0
                    o_c = Vec3(erow(0) * lx + erow(1) * ly + erow(3),
                               erow(4) * lx + erow(5) * ly + erow(7),
                               erow(8) * lx + erow(9) * ly + erow(11))
                    nrm = normalize(
                        Vec3(erow(4) * erow(9) - erow(8) * erow(5),
                             erow(8) * erow(1) - erow(0) * erow(9),
                             erow(0) * erow(5) - erow(4) * erow(1)))
                    A = epar(E_AREA)
                    rad_loc = rad
                    if int(sa.n_textures) > 0:
                        # textured radiance at the sampled rect point
                        from ..emitters import E_RAD_TEX
                        from ..textures import eval_texture
                        texid = epar(E_RAD_TEX).astype(jnp.int32)
                        tx = eval_texture(sa, jnp.maximum(texid, 0),
                                          0.5 * (lx + 1.0),
                                          0.5 * (ly + 1.0),
                                          wavelengths=wavelengths)
                        rad_loc = where3(texid >= 0, tx, rad)
                    cand = (o_c, frame_dir(nrm, loc), nrm,
                            rad_loc * (A * math.pi), rad_loc * A, ~no)
                elif tid == EMITTER_AREA_SPHERE:
                    # uniform surface position on the analytic sphere
                    c_c = Vec3(epar(E_POS), epar(E_POS + 1), epar(E_POS + 2))
                    r_s = epar(E_CUTOFF)
                    nsp = warp.uniform_sphere_c(pos2[0], pos2[1])
                    o_c = c_c + nsp * r_s
                    A = 4.0 * math.pi * r_s * r_s
                    rad_loc = rad
                    if int(sa.n_textures) > 0:
                        # textured radiance at the sampled sphere point:
                        # object-space spherical uv (sphere.cpp convention),
                        # same as the camera-path hit/NEE evals
                        from ..emitters import E_RAD_TEX
                        from ..textures import eval_texture
                        from ..core.vec import cmat_inverse, cmat_apply_point
                        texid = epar(E_RAD_TEX).astype(jnp.int32)
                        cm = tuple(erow(j) for j in range(12))
                        pn = cmat_apply_point(cmat_inverse(cm), o_c)
                        phi_s = jnp.arctan2(pn.y, pn.x)
                        su_t = phi_s * (0.5 / math.pi)
                        su_t = jnp.where(su_t < 0.0, su_t + 1.0, su_t)
                        sv_t = jnp.arccos(
                            jnp.clip(pn.z, -1.0, 1.0)) * (1.0 / math.pi)
                        tx = eval_texture(sa, jnp.maximum(texid, 0),
                                          su_t, sv_t,
                                          wavelengths=wavelengths)
                        rad_loc = where3(texid >= 0, tx, rad)
                    cand = (o_c, frame_dir(nsp, loc), nsp,
                            rad_loc * (A * math.pi), rad_loc * A, ~no)
                elif tid == EMITTER_AREA_MESH:
                    # triangle-CDF area sampling (reference
                    # Mesh::sample_position); animated emitter meshes are
                    # sampled at their t=0 keyframe (ptracer paths carry
                    # time 0)
                    o_m, n_m, invp = z3, z3, zero
                    uv_mu = zero
                    uv_mv = zero
                    su = jnp.sqrt(jnp.clip(pos2[0], 0.0, 1.0))
                    b0 = 1.0 - su
                    b1 = pos2[1] * su
                    for (ei, start, cnt, cdf_off, anim, ii) in sa.mesh_em_meta:
                        cdf = sa.em_tri_cdf[cdf_off:cdf_off + cnt]
                        k = jnp.clip(
                            jnp.searchsorted(cdf, s_tri, side="right"),
                            0, cnt - 1).astype(jnp.int32)
                        tri = start + k
                        pre = "a" if anim else "s"
                        v0 = Vec3(sa.tri(pre, "v0x")[tri],
                                  sa.tri(pre, "v0y")[tri],
                                  sa.tri(pre, "v0z")[tri])
                        e1 = Vec3(sa.tri(pre, "e1x")[tri],
                                  sa.tri(pre, "e1y")[tri],
                                  sa.tri(pre, "e1z")[tri])
                        e2 = Vec3(sa.tri(pre, "e2x")[tri],
                                  sa.tri(pre, "e2y")[tri],
                                  sa.tri(pre, "e2z")[tri])
                        pe = v0 + e1 * b0 + e2 * b1
                        if anim:
                            from ..core.vec import (cmat_lerp,
                                                    cmat_apply_point,
                                                    cmat_apply_vector)
                            c_t = cmat_lerp(sa.inst_cmat(0, ii),
                                            sa.inst_cmat(1, ii),
                                            jnp.zeros((), jnp.float32))
                            pe = cmat_apply_point(c_t, pe)
                            e1 = cmat_apply_vector(c_t, e1)
                            e2 = cmat_apply_vector(c_t, e2)
                        cr = cross(e1, e2)
                        cr_len = jnp.sqrt(jnp.maximum(dot(cr, cr), 1e-30))
                        ne_v = cr * (1.0 / cr_len)
                        if anim:
                            prob = cdf[k] - jnp.where(
                                k > 0, cdf[jnp.maximum(k - 1, 0)], 0.0)
                            ip = 0.5 * cr_len / jnp.maximum(prob, 1e-20)
                        else:
                            ip = epar(E_AREA)
                        mask = idx == ei
                        o_m = where3(mask, pe, o_m)
                        n_m = where3(mask, ne_v, n_m)
                        invp = jnp.where(mask, ip, invp)
                        if int(sa.n_textures) > 0:
                            uvw = 1.0 - b0 - b1
                            ue = (sa.tri(pre, "uv0u")[tri] * uvw
                                  + sa.tri(pre, "uv1u")[tri] * b0
                                  + sa.tri(pre, "uv2u")[tri] * b1)
                            ve = (sa.tri(pre, "uv0v")[tri] * uvw
                                  + sa.tri(pre, "uv1v")[tri] * b0
                                  + sa.tri(pre, "uv2v")[tri] * b1)
                            uv_mu = jnp.where(mask, ue, uv_mu)
                            uv_mv = jnp.where(mask, ve, uv_mv)
                    rad_loc = rad
                    if int(sa.n_textures) > 0:
                        from ..emitters import E_RAD_TEX
                        from ..textures import eval_texture
                        texid = epar(E_RAD_TEX).astype(jnp.int32)
                        tx = eval_texture(sa, jnp.maximum(texid, 0),
                                          uv_mu, uv_mv,
                                          wavelengths=wavelengths)
                        rad_loc = where3(texid >= 0, tx, rad)
                    cand = (o_m, frame_dir(n_m, loc), n_m,
                            rad_loc * (invp * math.pi), rad_loc * invp, ~no)
                elif tid == EMITTER_PROJECTOR:
                    # delta position; direction uniform over the image
                    # plane at z=1 in projector space (pdf_A = 1/(4 th^2));
                    # pdf_w = pdf_A * r^3 (dw = dA cos/r^2, cos = 1/r), so
                    # w = I(u,v) * A_p / r^3 (reference projector.cpp
                    # sample_ray; square frustum as in the NEE eval)
                    o_c = Vec3(epar(E_POS), epar(E_POS + 1), epar(E_POS + 2))
                    th = epar(E_CUTOFF)
                    lx = (1.0 - 2.0 * dir2[0]) * th
                    ly = (1.0 - 2.0 * dir2[1]) * th
                    r2 = 1.0 + lx * lx + ly * ly
                    inv_r = jax.lax.rsqrt(r2)
                    d_c = Vec3(
                        (erow(0) * lx + erow(1) * ly + erow(2)) * inv_r,
                        (erow(4) * lx + erow(5) * ly + erow(6)) * inv_r,
                        (erow(8) * lx + erow(9) * ly + erow(10)) * inv_r)
                    base = rad
                    if int(sa.n_textures) > 0:
                        from ..textures import eval_texture
                        texid = epar(E_BEAM).astype(jnp.int32)
                        tx = eval_texture(sa, jnp.maximum(texid, 0),
                                          dir2[0], dir2[1],
                                          wavelengths=wavelengths)
                        base = where3(texid >= 0, tx, base)
                    A_p = 4.0 * th * th
                    w_c = base * (A_p * inv_r * inv_r * inv_r)
                    cand = (o_c, d_c, d_c, w_c, z3, no)
                elif tid == EMITTER_DIRECTIONALAREA:
                    # collimated area source: uniform rect position, exact
                    # normal direction (delta), w = L * A (reference
                    # directionalarea.cpp sample_ray; rect shapes)
                    lx = 2.0 * pos2[0] - 1.0
                    ly = 2.0 * pos2[1] - 1.0
                    o_c = Vec3(erow(0) * lx + erow(1) * ly + erow(3),
                               erow(4) * lx + erow(5) * ly + erow(7),
                               erow(8) * lx + erow(9) * ly + erow(11))
                    nrm = normalize(
                        Vec3(erow(4) * erow(9) - erow(8) * erow(5),
                             erow(8) * erow(1) - erow(0) * erow(9),
                             erow(0) * erow(5) - erow(4) * erow(1)))
                    w_c = rad * epar(E_AREA)
                    cand = (o_c, nrm, nrm, w_c, z3, no)
                elif tid in (EMITTER_CONSTANT, EMITTER_ENVMAP):
                    # environment: emit inward from the scene bounding
                    # sphere (reference constant.cpp:59-76 sample_ray);
                    # pos pdf 1/(4 pi R^2), cosine direction about the
                    # inward normal
                    outn = warp.uniform_sphere_c(pos2[0], pos2[1])
                    o_c = Vec3(C_b[0] + outn.x * R_b, C_b[1] + outn.y * R_b,
                               C_b[2] + outn.z * R_b)
                    n_in = Vec3(-outn.x, -outn.y, -outn.z)
                    d_c = frame_dir(n_in, loc)
                    if tid == EMITTER_ENVMAP:
                        # radiance carried along d = env texel seen looking
                        # back along the ray; toward the camera = the texel
                        # the camera sees looking at this proxy point
                        L_ray = envmap_eval(sa, Vec3(-d_c.x, -d_c.y, -d_c.z),
                                            wavelengths=wavelengths)
                        if kind == 2:
                            # all ortho pixels look along the view axis
                            v_cam = Vec3(jnp.full((n,), view[0]),
                                         jnp.full((n,), view[1]),
                                         jnp.full((n,), view[2]))
                        else:
                            v_cam = normalize(o_c - lens_w)
                        L_cam = envmap_eval(sa, v_cam,
                                            wavelengths=wavelengths)
                    else:
                        L_ray = L_cam = rad
                    cand = (o_c, d_c, n_in, L_ray * (area_b * math.pi),
                            L_cam * area_b, ~no)
                else:
                    raise NotImplementedError(
                        f"ptracer: emitter type {tid} not supported")
                if best is None:
                    best = cand
                else:
                    m = etype == tid
                    best = (where3(m, cand[0], best[0]),
                            where3(m, cand[1], best[1]),
                            where3(m, cand[2], best[2]),
                            where3(m, cand[3], best[3]),
                            where3(m, cand[4], best[4]),
                            jnp.where(m, cand[5], best[5]))

            o, d, emit_n, w_emit, direct_base, has_direct = best
            throughput = w_emit * float(ne)

            time = jnp.zeros((n,), jnp.float32)
            # offset away from the emitting surface
            o = o + emit_n * 1e-4
            ray = Ray(o, d, time, jnp.full((n,), jnp.inf, jnp.float32))

            def connect(block, p, n_s, contrib, active_c, is_surface,
                        wi_local, lane_bsdf, tex_refl, tex_mask):
                """Connect a vertex to the aperture point and splat."""
                # camera-space position of the vertex
                rx = p.x - cam[3]
                ry = p.y - cam[7]
                rz = p.z - cam[11]
                cx = cam[0] * rx + cam[4] * ry + cam[8] * rz
                cy = cam[1] * rx + cam[5] * ry + cam[9] * rz
                cz = cam[2] * rx + cam[6] * ry + cam[10] * rz
                ok = active_c & (cz > 1e-4)
                czs = jnp.maximum(cz, 1e-8)
                if kind == 2:
                    # parallel projection: lateral position IS the film
                    # coordinate; importance 1/A_world, no cos/dist terms
                    sx = 0.5 * (1.0 - cx / s0sq)
                    sy = 0.5 * (1.0 - cy / s1sq)
                    ok = ok & (sx >= 0) & (sx < 1) & (sy >= 0) & (sy < 1)
                    dist = jnp.maximum(cz / s2, 1e-6)
                    wgt = jnp.full((n,), 1.0 / A_ortho, jnp.float32)
                    to_cam = Vec3(jnp.full((n,), -view[0]),
                                  jnp.full((n,), -view[1]),
                                  jnp.full((n,), -view[2]))
                    sh_o = p + n_s * jnp.where(dot(n_s, to_cam) >= 0,
                                               1e-4, -1e-4)
                    shadow = Ray(sh_o, to_cam, time,
                                 dist * (1.0 - SHADOW_EPSILON))
                    occ = ray_test(sa, shadow, ok)
                    ok = ok & ~occ
                    val = contrib * wgt
                    if wavelengths is not None:
                        from ..core.cie import hero_to_srgb
                        val = hero_to_srgb(val, wavelengths)
                    px = jnp.clip((sx * W).astype(jnp.int32), 0, W - 1)
                    py = jnp.clip((sy * H).astype(jnp.int32), 0, H - 1)
                    return block_splat_scatter(
                        block, px, py, [val.x, val.y, val.z], ok, W, H)
                if lens is not None:
                    # film coordinate through the lens: intersect the
                    # vertex->lens ray with the focus plane, then invert
                    # the central projection (thinlens.cpp sample_ray)
                    dcx = lpx / focus_d + (cx - lpx) / czs
                    dcy = lpy / focus_d + (cy - lpy) / czs
                else:
                    dcx = cx / czs
                    dcy = cy / czs
                sx = 0.5 * (1.0 - dcx / tan_x) - pp_ox
                sy = 0.5 * (1.0 - dcy / tan_y) - pp_oy
                ok = ok & (sx >= 0) & (sx < 1) & (sy >= 0) & (sy < 1)
                ex = cx - lpx
                ey = cy - lpy
                dist2 = ex * ex + ey * ey + cz * cz
                dist = jnp.sqrt(jnp.maximum(dist2, 1e-20))
                ct = cz / dist
                importance = (1.0 / A_rect) / jnp.maximum(ct * ct * ct, 1e-8)
                wgt = importance / jnp.maximum(dist2, 1e-20)
                # visibility
                to_cam = (lens_w - p) * (1.0 / dist)
                sh_o = p + n_s * jnp.where(dot(n_s, to_cam) >= 0, 1e-4, -1e-4)
                shadow = Ray(sh_o, to_cam, time,
                             dist * (1.0 - SHADOW_EPSILON))
                occ = ray_test(sa, shadow, ok)
                ok = ok & ~occ
                val = contrib * wgt
                if wavelengths is not None:
                    # film stores sRGB: per-lane MC spectral->sRGB, linear
                    # so pre-splat conversion == develop-time conversion
                    from ..core.cie import hero_to_srgb
                    val = hero_to_srgb(val, wavelengths)
                px = jnp.clip((sx * W).astype(jnp.int32), 0, W - 1)
                py = jnp.clip((sy * H).astype(jnp.int32), 0, H - 1)
                return block_splat_scatter(
                    block, px, py, [val.x, val.y, val.z], ok, W, H)

            # direct emitter->sensor connection for surface emitters
            # (reference sample_visible_emitters, ptracer.cpp:80-81):
            # contribution = L_toward_camera * cos(theta_emitter) / p(pos)
            def emitter_direct(block):
                if kind == 2:
                    dd = Vec3(jnp.full((n,), -view[0]),
                              jnp.full((n,), -view[1]),
                              jnp.full((n,), -view[2]))
                else:
                    dd = normalize(lens_w - o)
                cos_e = dot(emit_n, dd)
                contrib = (direct_base * jnp.maximum(cos_e, 0.0)
                           * float(ne))
                return connect(block, o, emit_n, contrib,
                               active & has_direct & (cos_e > 0), False,
                               None, None, None, None)

            if (any(t in sa.emitter_types_present for t in _SURFACE_EMITTERS)
                    and not self.hide_emitters and self.max_depth != 0):
                block = emitter_direct(block)

            bsdf_flags = jnp.asarray(np.asarray(sa.bsdf_flags_host, np.int32))

            # tpu_rgb_polarized: carry the light path's Stokes vector
            # (emitters are unpolarized, so the full Mueller throughput
            # collapses to its first column) and apply exact photon-order
            # Mueller factors at polarizing interactions — the light-
            # tracing mirror of _path_loop_polarized (reference ptracer
            # in polarized variants). Zero extra cost in scalar variants.
            polarized = bool(getattr(sa, "polarized", False))
            if polarized:
                from ..core import mueller as mu
                from .polarized import (light_bounce_mueller,
                                        _POLARIZING_TYPES)
                polarizing_present = [t for t in sa.bsdf_types_present
                                      if t in _POLARIZING_TYPES]
                S0 = (throughput, z3, z3, z3)
            else:
                S0 = None

            def bounce(depth_i, carry):
                block, state, ray, throughput, S, active = carry
                si = ray_intersect(sa, ray, active)
                act = active & si.valid
                lane_bsdf = gather_small(sa.inst_bsdf, jnp.maximum(si.inst, 0))

                # direction to camera in local frame for the bsdf eval
                if kind == 2:
                    to_cam = Vec3(jnp.full((n,), -view[0]),
                                  jnp.full((n,), -view[1]),
                                  jnp.full((n,), -view[2]))
                else:
                    to_cam = normalize(lens_w - si.p)
                wo_cam = si.to_local(to_cam)

                s1, state = sampler.next_1d(state, act)
                s2, state = sampler.next_2d(state, act)
                if sa.n_textures > 0:
                    from ..bsdfs import P_REFL_TEX
                    from ..textures import eval_texture
                    lane_tex = gather_small(
                        sa.bsdf_params[P_REFL_TEX],
                        lane_bsdf).astype(jnp.int32)
                    tex_mask = lane_tex >= 0
                    tex_refl = eval_texture(sa, lane_tex, si.uv_u, si.uv_v,
                                            p=si.p, b_u=si.b_u, b_v=si.b_v,
                                            prim=si.prim,
                                            wavelengths=wavelengths)
                else:
                    tex_mask = tex_refl = None
                bs = bsdf_eval_pdf_sample(sa, lane_bsdf, si.wi, wo_cam,
                                          s1, s2[0], s2[1],
                                          tex_refl, tex_mask,
                                          wavelengths=wavelengths)

                # splat vertex -> camera (bs.val_nee = f * cos(wo_cam))
                if polarized:
                    # contribution = row 0 of the connection Mueller
                    # applied to the path Stokes (S0 at the film is
                    # basis-rotation invariant, so no sensor rotation)
                    lane_type = gather_small(sa.bsdf_type, lane_bsdf)
                    M_c = light_bounce_mueller(sa, si, bs, lane_bsdf,
                                               lane_type, bs.val_nee,
                                               polarizing_present,
                                               out_local=wo_cam,
                                               wavelengths=wavelengths)
                    conn_val = (M_c[0] * S[0] + M_c[1] * S[1]
                                + M_c[2] * S[2] + M_c[3] * S[3])
                else:
                    conn_val = throughput * bs.val_nee
                block = connect(block, si.p, si.n, conn_val,
                                act, True, si.wi, lane_bsdf, tex_refl,
                                tex_mask)

                # continue the light path
                wo_world = si.to_world(bs.wo)
                new_ray = si.spawn_ray(wo_world)
                throughput = where3(act, throughput * bs.weight, throughput)
                if polarized:
                    wgt_b = where3(act, bs.weight, Vec3.ones((n,)))
                    M_b = light_bounce_mueller(sa, si, bs, lane_bsdf,
                                               lane_type, wgt_b,
                                               polarizing_present,
                                               wavelengths=wavelengths)
                    S_new = mu.mm_apply_stokes(M_b, S)
                    S = tuple(where3(act, S_new[i], S[i]) for i in range(4))
                # russian roulette after rr_depth bounces (ptracer.cpp
                # rr_depth semantics; before that, paths always continue)
                tm = vmax(throughput)
                rr, state = sampler.next_1d(state, act)
                rr_on = depth_i >= integrator.rr_depth
                rr_p = jnp.where(rr_on, jnp.minimum(tm, 0.95), 1.0)
                cont = rr < rr_p
                rr_scale = jnp.where(act, 1.0 / jnp.maximum(rr_p, 1e-8), 1.0)
                throughput = throughput * rr_scale
                if polarized:
                    S = tuple(s * rr_scale for s in S)
                active = act & cont & (tm > 0.0)
                ray = Ray(where3(active, new_ray.o, ray.o),
                          where3(active, wo_world, ray.d),
                          ray.time, new_ray.maxt)
                return block, state, ray, throughput, S, active

            carry = (block, state, ray, throughput, S0, active)
            from . import bounce_loop
            carry = bounce_loop(bounce, carry, integrator.loop_iterations)
            return carry[0], carry[1]

        block = jnp.zeros((4, H, W), jnp.float32)
        if n_passes > 1 and not os.environ.get("MI_NO_FUSED_PASSES"):
            # fuse the pass loop into one device dispatch with a traced
            # fori bound, mirroring the camera path's multi-pass fusion
            # (integrators/__init__.py _get_multi_pass_fn)
            raw = light_pass.__wrapped__ if hasattr(light_pass, "__wrapped__") \
                else light_pass

            def run_passes(sa_, blk, st, n):
                def body(_, carry):
                    b, s = carry
                    b, s = raw(sa_, b, s)
                    return b, sampler.advance(s)
                return jax.lax.fori_loop(0, n, body, (blk, st))

            block, state = jax.jit(run_passes)(sa, block, state,
                                               jnp.int32(n_passes))
        else:
            for p in range(n_passes):
                block, state = light_pass(sa, block, state)
                state = sampler.advance(state)

        # normalization: light-path splats average W*H/(paths) per pixel
        scale = float(W * H) / float(n_pass * n_passes)
        img = block[:3] * scale
        out = jnp.moveaxis(img, 0, -1)
        if develop_film:
            return out
        return block


__all__ = ["PTracerIntegrator"]

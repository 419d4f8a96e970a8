"""Emitter plugins + device-side sampling.

Reference inventory: src/emitters/{point,area,constant,envmap,directional,
spot,projector,directionalarea}.cpp. Device-side sampling follows the masked
type-dispatch pattern (see bsdfs/__init__.py) over an emitter parameter
table; scene-level uniform emitter selection replicates
reference src/render/scene.cpp:170-188 (sample_emitter) exactly, including
the sample-reuse rescaling.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import jax.numpy as jnp

import jax

from ..core.properties import Properties, register_plugin
from ..core.vec import Vec3, dot, cross, normalize, where3
from ..render.types import DirectionSample

EMITTER_POINT = 0
EMITTER_AREA_RECT = 1     # area emitter on a rectangle shape
EMITTER_CONSTANT = 2
EMITTER_AREA_MESH = 3     # area emitter on an arbitrary mesh (CDF-sampled)
EMITTER_DIRECTIONAL = 4
EMITTER_SPOT = 5
EMITTER_AREA_SPHERE = 9   # area emitter on an analytic sphere (cone-sampled)

N_EMITTER_PARAMS = 16
# param columns
E_POS = 0          # point: position / directional: direction
E_INTENSITY = 3    # point: rgb intensity / area: rgb radiance / constant: rgb
E_AREA = 6         # area: total world-space surface area
E_CUTOFF = 7       # spot: cos cutoff / sphere: world radius
E_BEAM = 8         # spot: cos beam width
E_RAD_TEX = 8      # area (rect/mesh): radiance texture id (-1 = constant)
                   # — slot shared with E_BEAM (spot-only)


def _get_rgb(props, key, default):
    v = props.get(key, default)
    from ..spectra import Spectrum
    from ..textures import Texture
    if isinstance(v, (Spectrum, Texture)):
        return np.asarray(v.mean_rgb())
    if isinstance(v, dict):
        v = v.get("value")
    a = np.asarray(v, dtype=np.float64).reshape(-1)
    if a.size == 1:
        a = np.repeat(a, 3)
    return a[:3]


class Emitter:
    type_id = EMITTER_POINT
    is_environment = False
    delta = True

    def __init__(self, props: Properties):
        self.id = props.id
        self.shape = None       # set for area emitters during assembly
        self.inst_index = -1    # instance index of the host shape

    def params_row(self) -> np.ndarray:
        return np.zeros(N_EMITTER_PARAMS)


@register_plugin("emitter", "point")
class PointEmitter(Emitter):
    """reference src/emitters/point.cpp — intensity / dist^2, delta."""
    type_id = EMITTER_POINT
    delta = True

    def __init__(self, props: Properties):
        super().__init__(props)
        if props.has_property("position"):
            self.position = props.get_vector("position")
        else:
            m = props.get_transform("to_world", np.eye(4))
            self.position = m[:3, 3]
        self.intensity = _get_rgb(props, "intensity", [1.0, 1.0, 1.0])

    def params_row(self):
        p = np.zeros(N_EMITTER_PARAMS)
        p[E_POS:E_POS + 3] = self.position
        p[E_INTENSITY:E_INTENSITY + 3] = self.intensity
        return p


@register_plugin("emitter", "area")
class AreaEmitter(Emitter):
    """reference src/emitters/area.cpp — radiance over the host shape;
    a nested texture makes the radiance spatially varying, evaluated at
    the surface uv on hits and at NEE sample points for every emitter
    shape incl. analytic spheres (object-space spherical uv,
    tests/test_textured_emitter.py)."""
    type_id = EMITTER_AREA_RECT
    delta = False

    def __init__(self, props: Properties):
        super().__init__(props)
        from ..textures import Texture
        self.irradiance_tex = None       # compile assigns tex_index
        self.tex_index = -1
        for key, v in props.objects():
            if isinstance(v, Texture):
                self.irradiance_tex = v
        self.radiance = _get_rgb(props, "radiance", [1.0, 1.0, 1.0])

    def params_row(self):
        p = np.zeros(N_EMITTER_PARAMS)
        p[E_INTENSITY:E_INTENSITY + 3] = self.radiance
        p[E_RAD_TEX] = float(self.tex_index)
        return p


@register_plugin("emitter", "constant")
class ConstantEmitter(Emitter):
    """reference src/emitters/constant.cpp — uniform environment radiance."""
    type_id = EMITTER_CONSTANT
    is_environment = True
    delta = False

    def __init__(self, props: Properties):
        super().__init__(props)
        self.radiance = _get_rgb(props, "radiance", [1.0, 1.0, 1.0])

    def params_row(self):
        p = np.zeros(N_EMITTER_PARAMS)
        p[E_INTENSITY:E_INTENSITY + 3] = self.radiance
        return p


# ---------------------------------------------------------------------------
# Device-side sampling (operates on the compiled emitter tables in SceneData)
# ---------------------------------------------------------------------------

def sample_emitter_index(n_emitters: int, sample_x):
    """reference scene.cpp:170-188 — uniform pick + sample reuse."""
    if n_emitters == 1:
        return jnp.zeros(sample_x.shape, dtype=jnp.int32), jnp.float32(1.0), sample_x
    scaled = sample_x * float(n_emitters)
    index = jnp.minimum(scaled.astype(jnp.int32), n_emitters - 1)
    return index, jnp.float32(n_emitters), scaled - index.astype(scaled.dtype)


def sample_direction(sa, ref_p: Vec3, ref_time, s_x, s_y,
                     wavelengths=None):
    """Emitter sample_direction over the table, masked multi-type,
    component-wise (see core/vec.py for the layout rationale).

    Returns (DirectionSample, spec: Vec3) BEFORE visibility testing; the pdf
    includes the discrete emitter-selection probability.

    ``wavelengths`` (tpu_spectral): Vec3 of per-lane hero wavelengths; the
    radiance is then the emission SPD scale·S(coeffs)·D65/∫D65·ȳ stored at
    params rows 12:16 instead of the rgb intensity (srgb.cpp emission).
    """
    n = ref_p.x.shape[0]
    n_emitters = int(sa.n_emitters)
    dtype = ref_p.x.dtype

    if n_emitters == 0:
        z = jnp.zeros((n,), dtype)
        z3 = Vec3(z, z, z)
        ds = DirectionSample(z3, z3, z3, z, z, z > 1.0,
                             jnp.full((n,), -1, jnp.int32))
        return ds, z3

    index, emitter_weight, s_x = sample_emitter_index(n_emitters, s_x)

    from ..render.scene import gather_small

    def param(j):
        return gather_small(sa.emitter_params[j], index)

    def mrow(j):
        return gather_small(sa.emitter_m[j], index)

    inten = _lane_intensity(param, wavelengths)
    lane_type = gather_small(sa.emitter_type, index)

    best = None
    for tid in sa.emitter_types_present:
        if tid == EMITTER_POINT:
            p = Vec3(param(E_POS), param(E_POS + 1), param(E_POS + 2))
            d = p - ref_p
            dist2 = jnp.maximum(dot(d, d), 1e-20)
            inv_dist = jax.lax.rsqrt(dist2)
            dist = dist2 * inv_dist
            dirn = d * inv_dist
            inv2 = inv_dist * inv_dist
            spec = inten * inv2
            z = jnp.zeros((n,), dtype)
            ds = DirectionSample(p, Vec3(z, z, z), dirn, dist,
                                 jnp.ones((n,), dtype),
                                 jnp.ones((n,), bool), index)
        elif tid == EMITTER_AREA_RECT:
            lx = 2.0 * s_x - 1.0
            ly = 2.0 * s_y - 1.0
            p = Vec3(mrow(0) * lx + mrow(1) * ly + mrow(3),
                     mrow(4) * lx + mrow(5) * ly + mrow(7),
                     mrow(8) * lx + mrow(9) * ly + mrow(11))
            col0 = Vec3(mrow(0), mrow(4), mrow(8))
            col1 = Vec3(mrow(1), mrow(5), mrow(9))
            nrm = normalize(cross(col0, col1))
            d = p - ref_p
            dist2 = jnp.maximum(dot(d, d), 1e-20)
            dist = jnp.sqrt(dist2)
            dirn = d * (1.0 / dist)
            area = param(E_AREA)
            cos_theta = -dot(dirn, nrm)
            pdf = jnp.where(cos_theta > 1e-6,
                            dist2 / (jnp.abs(cos_theta) * area), 0.0)
            w = jnp.where(pdf > 0.0, 1.0 / jnp.maximum(pdf, 1e-20), 0.0)
            inten_r = inten
            if int(sa.n_textures) > 0:
                # textured radiance at the sampled rect point (uv follows
                # the rectangle mesh's [0,1]^2 parameterization)
                texid = param(E_RAD_TEX).astype(jnp.int32)
                from ..textures import eval_texture
                tx = eval_texture(sa, jnp.maximum(texid, 0),
                                  0.5 * (lx + 1.0), 0.5 * (ly + 1.0),
                                  wavelengths=wavelengths)
                inten_r = where3(texid >= 0, tx, inten)
            spec = inten_r * w
            ds = DirectionSample(p, nrm, dirn, dist, pdf,
                                 jnp.zeros((n,), bool), index)
        elif tid == EMITTER_DIRECTIONAL:
            # delta direction: sample at "infinity" = 2*bsphere radius away
            dl = Vec3(param(E_POS), param(E_POS + 1), param(E_POS + 2))
            dirn = Vec3(-dl.x, -dl.y, -dl.z)
            radius = jnp.asarray(sa.bsphere_radius, dtype)
            dist = jnp.full((n,), 2.0, dtype) * radius
            p = ref_p + dirn * dist
            spec = inten
            ds = DirectionSample(p, dl, dirn, dist,
                                 jnp.ones((n,), dtype),
                                 jnp.ones((n,), bool), index)
        elif tid == EMITTER_SPOT:
            pos = Vec3(param(E_POS), param(E_POS + 1), param(E_POS + 2))
            axis = Vec3(param(9), param(10), param(11))
            d = pos - ref_p
            dist2 = jnp.maximum(dot(d, d), 1e-20)
            inv_dist = jax.lax.rsqrt(dist2)
            dist = dist2 * inv_dist
            dirn = d * inv_dist
            # falloff (reference spot.cpp falloff_curve): 1 inside beam,
            # smooth to 0 at cutoff
            cos_a = -dot(dirn, axis)
            cc = param(E_CUTOFF)
            cb = param(E_BEAM)
            fall = jnp.clip((cos_a - cc) / jnp.maximum(cb - cc, 1e-6), 0.0, 1.0)
            inv2 = inv_dist * inv_dist * fall
            spec = inten * inv2
            z = jnp.zeros((n,), dtype)
            ds = DirectionSample(pos, Vec3(z, z, z), dirn, dist,
                                 jnp.where(cos_a > cc, 1.0, 0.0),
                                 jnp.ones((n,), bool), index)
        elif tid == EMITTER_PROJECTOR:
            pos = Vec3(param(E_POS), param(E_POS + 1), param(E_POS + 2))
            d = pos - ref_p
            dist2 = jnp.maximum(dot(d, d), 1e-20)
            inv_dist = jax.lax.rsqrt(dist2)
            dist = dist2 * inv_dist
            dirn = d * inv_dist
            # direction from projector to the point, in projector space
            m00, m01, m02 = mrow(0), mrow(1), mrow(2)
            m10, m11, m12 = mrow(4), mrow(5), mrow(6)
            m20, m21, m22 = mrow(8), mrow(9), mrow(10)
            lx = -(m00 * dirn.x + m10 * dirn.y + m20 * dirn.z)
            ly = -(m01 * dirn.x + m11 * dirn.y + m21 * dirn.z)
            lz = -(m02 * dirn.x + m12 * dirn.y + m22 * dirn.z)
            th = param(E_CUTOFF)
            inside = (lz > 1e-6)
            u = 0.5 * (1.0 - lx / jnp.maximum(lz, 1e-6) / th)
            v = 0.5 * (1.0 - ly / jnp.maximum(lz, 1e-6) / th)
            inside = inside & (u >= 0) & (u < 1) & (v >= 0) & (v < 1)
            texid = param(E_BEAM).astype(jnp.int32)
            base = inten
            if int(sa.n_textures) > 0:
                from ..textures import eval_texture
                tx = eval_texture(sa, jnp.maximum(texid, 0), u, v)
                has_tex = texid >= 0
                base = where3(has_tex, tx, base)
            inv2 = inv_dist * inv_dist * jnp.where(inside, 1.0, 0.0)
            spec = base * inv2
            z = jnp.zeros((n,), dtype)
            ds = DirectionSample(pos, Vec3(z, z, z), dirn, dist,
                                 jnp.where(inside, 1.0, 0.0),
                                 jnp.ones((n,), bool), index)
        elif tid == EMITTER_AREA_SPHERE:
            # exact solid-angle cone sampling toward the sphere (reference
            # src/shapes/sphere.cpp sample_direction): uniform in the cone
            # subtended by the sphere, pdf = 1/(2*pi*(1-cos_theta_max))
            c = Vec3(param(E_POS), param(E_POS + 1), param(E_POS + 2))
            r = param(E_CUTOFF)
            if int(sa.n_spheres) > 0:
                # animated sphere emitters (param 9 = sphere-table slot):
                # re-center the cone at the keyframe-lerped position at the
                # ray's own time (extension; reference instance.cpp:48)
                slot = param(9).astype(jnp.int32)
                s_anim = slot >= 0
                sl = jnp.maximum(slot, 0)
                t0s = gather_small(sa.sph_t0, sl)
                t1s = gather_small(sa.sph_t1, sl)
                span_s = t1s - t0s
                uu = jnp.clip((ref_time - t0s)
                              / jnp.where(span_s != 0.0, span_s, 1.0),
                              0.0, 1.0)

                def lerp_c(j):
                    return ((1.0 - uu) * gather_small(sa.sph_m0c[j], sl)
                            + uu * gather_small(sa.sph_m1c[j], sl))
                c_t = Vec3(lerp_c(3), lerp_c(7), lerp_c(11))
                l0, l4, l8 = lerp_c(0), lerp_c(4), lerp_c(8)
                r_t = jnp.sqrt(l0 * l0 + l4 * l4 + l8 * l8)
                c = where3(s_anim, c_t, c)
                r = jnp.where(s_anim, r_t, r)
            dc = c - ref_p
            dc2 = jnp.maximum(dot(dc, dc), 1e-20)
            inv_dc = jax.lax.rsqrt(dc2)
            dc_len = dc2 * inv_dc
            dcn = dc * inv_dc
            outside = dc_len > r * (1.0 + 1e-4)
            sin2_max = jnp.clip(r * r / dc2, 0.0, 1.0)
            cos_max = jnp.sqrt(jnp.maximum(1.0 - sin2_max, 0.0))
            # cone direction around dcn
            cos_t = (1.0 - s_y) + s_y * cos_max
            sin_t = jnp.sqrt(jnp.maximum(1.0 - cos_t * cos_t, 0.0))
            phi = 2.0 * np.pi * s_x
            from ..core.vec import coordinate_system as _cs
            bx, by = _cs(dcn)
            dirn = (bx * (jnp.cos(phi) * sin_t) + by * (jnp.sin(phi) * sin_t)
                    + dcn * cos_t)
            # distance to the near sphere surface along dirn
            under = r * r - dc2 * (1.0 - cos_t * cos_t)
            dist = dc_len * cos_t - jnp.sqrt(jnp.maximum(under, 0.0))
            dist = jnp.maximum(dist, 1e-6)
            p = ref_p + dirn * dist
            nrm = (p - c) * (1.0 / jnp.maximum(r, 1e-9))
            pdf = jnp.where(
                outside,
                1.0 / jnp.maximum(2.0 * np.pi * (1.0 - cos_max), 1e-12), 0.0)
            w = jnp.where(pdf > 0.0, 1.0 / jnp.maximum(pdf, 1e-20), 0.0)
            inten_s = inten
            if int(sa.n_textures) > 0:
                # textured sphere radiance at the sampled point: object-space
                # spherical uv (reference sphere.cpp uv convention), matching
                # the hit path so both MIS strategies see the same texture
                from ..core.vec import cmat_inverse, cmat_apply_point
                texid = param(E_RAD_TEX).astype(jnp.int32)
                cm = tuple(mrow(j) for j in range(12))
                if int(sa.n_spheres) > 0:
                    cm_a = tuple(lerp_c(j) for j in range(12))
                    cm = tuple(jnp.where(s_anim, ca, cs)
                               for ca, cs in zip(cm_a, cm))
                pn = cmat_apply_point(cmat_inverse(cm), p)
                phi_s = jnp.arctan2(pn.y, pn.x)
                su = phi_s * (0.5 / np.pi)
                su = jnp.where(su < 0.0, su + 1.0, su)
                sv = jnp.arccos(jnp.clip(pn.z, -1.0, 1.0)) * (1.0 / np.pi)
                from ..textures import eval_texture
                tx = eval_texture(sa, jnp.maximum(texid, 0), su, sv,
                                  wavelengths=wavelengths)
                inten_s = where3(texid >= 0, tx, inten)
            spec = inten_s * w
            ds = DirectionSample(p, nrm, dirn, dist, pdf,
                                 jnp.zeros((n,), bool), index)
        elif tid == EMITTER_AREA_MESH:
            # triangle-CDF area sampling over the host mesh (reference
            # Mesh::sample_position, mesh.cpp build_pmf). Animated emitter
            # shapes sample their OBJECT-space CDF and transform the point
            # by the per-lane keyframe-lerped matrix at the ray's time; the
            # pdf uses the exact world-space triangle area at that time
            # (extension beyond the reference, instance.cpp:48).
            z = jnp.zeros((n,), dtype)
            p = Vec3(z, z, z)
            nrm = Vec3(z, z, z)
            pdf = z
            em_uv_u = z
            em_uv_v = z
            # sqrt warp for uniform barycentrics (re-uses s_x low bits + s_y)
            su = jnp.sqrt(jnp.clip((s_x * 4096.0) % 1.0, 0.0, 1.0))
            b0 = 1.0 - su
            b1 = s_y * su
            for (ei, start, cnt, cdf_off, anim, ii) in sa.mesh_em_meta:
                cdf = sa.em_tri_cdf[cdf_off:cdf_off + cnt]
                k = jnp.clip(jnp.searchsorted(cdf, s_x, side="right"),
                             0, cnt - 1).astype(jnp.int32)
                tri = start + k
                pre = "a" if anim else "s"
                v0 = Vec3(sa.tri(pre, "v0x")[tri], sa.tri(pre, "v0y")[tri],
                          sa.tri(pre, "v0z")[tri])
                e1 = Vec3(sa.tri(pre, "e1x")[tri], sa.tri(pre, "e1y")[tri],
                          sa.tri(pre, "e1z")[tri])
                e2 = Vec3(sa.tri(pre, "e2x")[tri], sa.tri(pre, "e2y")[tri],
                          sa.tri(pre, "e2z")[tri])
                pe = v0 + e1 * b0 + e2 * b1
                if anim:
                    from ..core.vec import (cmat_lerp, cmat_apply_point,
                                            cmat_apply_vector)
                    c0 = sa.inst_cmat(0, ii)
                    c1 = sa.inst_cmat(1, ii)
                    t0a, t1a = sa.inst_t0[ii], sa.inst_t1[ii]
                    span = t1a - t0a
                    uu = jnp.clip((ref_time - t0a)
                                  / jnp.where(span != 0.0, span, 1.0),
                                  0.0, 1.0)
                    c_t = cmat_lerp(c0, c1, uu)
                    pe = cmat_apply_point(c_t, pe)
                    e1 = cmat_apply_vector(c_t, e1)
                    e2 = cmat_apply_vector(c_t, e2)
                cr = cross(e1, e2)
                cr_len = jnp.sqrt(jnp.maximum(dot(cr, cr), 1e-30))
                ne = cr * (1.0 / cr_len)
                if anim:
                    # p(tri) · uniform-in-tri / world_area(tri, t)
                    prob = cdf[k] - jnp.where(k > 0, cdf[jnp.maximum(k - 1, 0)],
                                              0.0)
                    inv_area = prob / jnp.maximum(0.5 * cr_len, 1e-20)
                else:
                    inv_area = 1.0 / jnp.maximum(param(E_AREA), 1e-20)
                d = pe - ref_p
                dist2 = jnp.maximum(dot(d, d), 1e-20)
                dirn = d * jax.lax.rsqrt(dist2)
                # two-sided mesh emitters emit from the front only (area.cpp)
                cos_theta = -dot(dirn, ne)
                pe_pdf = jnp.where(cos_theta > 1e-6,
                                   dist2 * inv_area
                                   / jnp.maximum(cos_theta, 1e-6), 0.0)
                mask = index == ei
                p = where3(mask, pe, p)
                nrm = where3(mask, ne, nrm)
                pdf = jnp.where(mask, pe_pdf, pdf)
                if int(sa.n_textures) > 0:
                    uvw = 1.0 - b0 - b1
                    ue = (sa.tri(pre, "uv0u")[tri] * uvw
                          + sa.tri(pre, "uv1u")[tri] * b0
                          + sa.tri(pre, "uv2u")[tri] * b1)
                    ve = (sa.tri(pre, "uv0v")[tri] * uvw
                          + sa.tri(pre, "uv1v")[tri] * b0
                          + sa.tri(pre, "uv2v")[tri] * b1)
                    em_uv_u = jnp.where(mask, ue, em_uv_u)
                    em_uv_v = jnp.where(mask, ve, em_uv_v)
            d = p - ref_p
            dist2 = jnp.maximum(dot(d, d), 1e-20)
            dist = jnp.sqrt(dist2)
            dirn = d * (1.0 / dist)
            w = jnp.where(pdf > 0.0, 1.0 / jnp.maximum(pdf, 1e-20), 0.0)
            inten_m = inten
            if int(sa.n_textures) > 0:
                texid = param(E_RAD_TEX).astype(jnp.int32)
                from ..textures import eval_texture
                tx = eval_texture(sa, jnp.maximum(texid, 0), em_uv_u,
                                  em_uv_v, wavelengths=wavelengths)
                inten_m = where3(texid >= 0, tx, inten)
            spec = inten_m * w
            ds = DirectionSample(p, nrm, dirn, dist, pdf,
                                 jnp.zeros((n,), bool), index)
        elif tid == EMITTER_ENVMAP:
            ds, spec = envmap_sample_direction(sa, ref_p, s_x, s_y,
                                               wavelengths=wavelengths)
            ds = ds._replace(emitter=index)
        elif tid == EMITTER_DIRECTIONALAREA:
            # delta-direction area emitter: NEE cannot sample it
            # (reference directionalarea.cpp — sample_direction degenerate;
            # transport it with ptracer)
            z = jnp.zeros((n,), dtype)
            z3v = Vec3(z, z, z)
            ds = DirectionSample(z3v, z3v, z3v, z, z, jnp.ones((n,), bool),
                                 index)
            spec = z3v
        elif tid == EMITTER_CONSTANT:
            from ..core import warp as _warp
            dirn = _warp.uniform_sphere_c(s_x, s_y)
            radius = jnp.asarray(sa.bsphere_radius, dtype)
            dist = jnp.full((n,), 2.0, dtype) * radius
            p = ref_p + dirn * dist
            pdf = jnp.full((n,), 1.0 / (4.0 * np.pi), dtype)
            w = 4.0 * np.pi
            spec = inten * w
            ds = DirectionSample(p, -dirn, dirn, dist, pdf,
                                 jnp.zeros((n,), bool), index)
        else:
            raise NotImplementedError(f"Emitter type {tid} NEE not implemented")

        if best is None:
            best = (ds, spec)
        else:
            m = lane_type == tid
            pds, pspec = best
            best = (DirectionSample(
                where3(m, ds.p, pds.p), where3(m, ds.n, pds.n),
                where3(m, ds.d, pds.d), jnp.where(m, ds.dist, pds.dist),
                jnp.where(m, ds.pdf, pds.pdf),
                jnp.where(m, ds.delta, pds.delta),
                jnp.where(m, ds.emitter, pds.emitter)),
                where3(m, spec, pspec))

    ds, spec = best
    # discrete selection probability (reference scene.cpp:259-263); with a
    # single emitter the reference's inlined path leaves pdf/spec untouched
    if n_emitters > 1:
        ds = ds._replace(pdf=ds.pdf * (1.0 / float(n_emitters)))
        spec = spec * float(n_emitters)
    return ds, spec


def _lane_intensity(param, wavelengths):
    """Per-lane emitter radiance/intensity triplet: the rgb columns
    (tpu_rgb) or the emission SPD at 3 hero wavelengths (tpu_spectral;
    scale·S(coeffs)·D65/∫D65·ȳ with coeffs at rows 12:15, scale at 15)."""
    if wavelengths is None:
        return Vec3(param(E_INTENSITY), param(E_INTENSITY + 1),
                    param(E_INTENSITY + 2))
    from ..core.cie import eval_emission_spectrum, d65_y_norm
    c0, c1, c2, scale = param(12), param(13), param(14), param(15)
    inv_n = 1.0 / d65_y_norm()
    return Vec3(eval_emission_spectrum(c0, c1, c2, scale, wavelengths.x, inv_n),
                eval_emission_spectrum(c0, c1, c2, scale, wavelengths.y, inv_n),
                eval_emission_spectrum(c0, c1, c2, scale, wavelengths.z, inv_n))


def pdf_direction(sa, ds: DirectionSample, prim=None, time=None):
    """pdf of sampling direction ds via NEE — for MIS on emitter hits
    (reference scene.cpp:296-303 pdf_emitter_direction). Delta emitters
    return 0.

    ``prim``/``time`` (optional): hit primitive slot and ray time — needed
    for exact pdfs of ANIMATED area emitters (per-triangle world area and
    keyframe-lerped sphere center at the hit time)."""
    n_emitters = int(sa.n_emitters)
    if n_emitters == 0:
        return jnp.zeros(ds.dist.shape, ds.dist.dtype)
    from ..render.scene import gather_small
    idx = jnp.maximum(ds.emitter, 0)
    lane_type = gather_small(sa.emitter_type, idx)
    pdf = jnp.zeros(ds.dist.shape, ds.dist.dtype)
    for tid in sa.emitter_types_present:
        if tid in (EMITTER_AREA_RECT, EMITTER_AREA_MESH):
            area = gather_small(sa.emitter_params[E_AREA], idx)
            dist2 = ds.dist * ds.dist
            cos_theta = -dot(ds.d, ds.n)
            p = jnp.where(cos_theta > 1e-6,
                          dist2 / (jnp.abs(cos_theta)
                                   * jnp.maximum(area, 1e-20)), 0.0)
            if prim is not None and time is not None:
                # animated mesh emitters: pdf w.r.t. the hit triangle's
                # world area at the ray time (matches sample_direction)
                for (ei, start, cnt, cdf_off, anim, ii) in sa.mesh_em_meta:
                    if not anim:
                        continue
                    from ..core.vec import cmat_lerp, cmat_apply_vector
                    loc = prim - sa.n_static_tris - start
                    m = ((ds.emitter == ei) & (loc >= 0) & (loc < cnt))
                    locc = jnp.clip(loc, 0, cnt - 1)
                    tri = start + locc
                    e1 = Vec3(sa.tri("a", "e1x")[tri],
                              sa.tri("a", "e1y")[tri],
                              sa.tri("a", "e1z")[tri])
                    e2 = Vec3(sa.tri("a", "e2x")[tri],
                              sa.tri("a", "e2y")[tri],
                              sa.tri("a", "e2z")[tri])
                    t0a, t1a = sa.inst_t0[ii], sa.inst_t1[ii]
                    span = t1a - t0a
                    uu = jnp.clip((time - t0a)
                                  / jnp.where(span != 0.0, span, 1.0),
                                  0.0, 1.0)
                    c_t = cmat_lerp(sa.inst_cmat(0, ii),
                                    sa.inst_cmat(1, ii), uu)
                    cr = cross(cmat_apply_vector(c_t, e1),
                               cmat_apply_vector(c_t, e2))
                    tri_area = 0.5 * jnp.sqrt(jnp.maximum(dot(cr, cr),
                                                          1e-30))
                    cdf = sa.em_tri_cdf[cdf_off:cdf_off + cnt]
                    prob = cdf[locc] - jnp.where(
                        locc > 0, cdf[jnp.maximum(locc - 1, 0)], 0.0)
                    p_anim = jnp.where(
                        cos_theta > 1e-6,
                        dist2 * prob / (jnp.abs(cos_theta)
                                        * jnp.maximum(tri_area, 1e-20)), 0.0)
                    p = jnp.where(m, p_anim, p)
        elif tid == EMITTER_AREA_SPHERE:
            # cone pdf reconstructed from the reference point
            cx = gather_small(sa.emitter_params[E_POS], idx)
            cy = gather_small(sa.emitter_params[E_POS + 1], idx)
            cz = gather_small(sa.emitter_params[E_POS + 2], idx)
            r = gather_small(sa.emitter_params[E_CUTOFF], idx)
            if time is not None and int(sa.n_spheres) > 0:
                slot = gather_small(sa.emitter_params[9],
                                    idx).astype(jnp.int32)
                s_anim = slot >= 0
                sl = jnp.maximum(slot, 0)
                t0s = gather_small(sa.sph_t0, sl)
                t1s = gather_small(sa.sph_t1, sl)
                span_s = t1s - t0s
                uu = jnp.clip((time - t0s)
                              / jnp.where(span_s != 0.0, span_s, 1.0),
                              0.0, 1.0)

                def lerp_c(j):
                    return ((1.0 - uu) * gather_small(sa.sph_m0c[j], sl)
                            + uu * gather_small(sa.sph_m1c[j], sl))
                cx = jnp.where(s_anim, lerp_c(3), cx)
                cy = jnp.where(s_anim, lerp_c(7), cy)
                cz = jnp.where(s_anim, lerp_c(11), cz)
                l0, l4, l8 = lerp_c(0), lerp_c(4), lerp_c(8)
                r = jnp.where(s_anim,
                              jnp.sqrt(l0 * l0 + l4 * l4 + l8 * l8), r)
            ref = ds.p - ds.d * ds.dist
            dcx, dcy, dcz = cx - ref.x, cy - ref.y, cz - ref.z
            dc2 = jnp.maximum(dcx * dcx + dcy * dcy + dcz * dcz, 1e-20)
            sin2_max = jnp.clip(r * r / dc2, 0.0, 1.0)
            cos_max = jnp.sqrt(jnp.maximum(1.0 - sin2_max, 0.0))
            outside = dc2 > (r * r) * (1.0 + 1e-4)
            p = jnp.where(
                outside,
                1.0 / jnp.maximum(2.0 * np.pi * (1.0 - cos_max), 1e-12), 0.0)
        elif tid == EMITTER_CONSTANT:
            p = jnp.full(ds.dist.shape, 1.0 / (4.0 * np.pi), ds.dist.dtype)
        elif tid == EMITTER_ENVMAP:
            p = envmap_pdf_direction(sa, ds.d)
        else:  # delta emitters
            p = jnp.zeros(ds.dist.shape, ds.dist.dtype)
        pdf = jnp.where(lane_type == tid, p, pdf)
    pdf = jnp.where(ds.emitter >= 0, pdf, 0.0)
    return pdf * (1.0 / float(n_emitters))


def eval_emitter_hit(sa, si_n: Vec3, towards: Vec3, lane_emitter,
                     wavelengths=None, uv_u=None, uv_v=None):
    """Radiance of an emitter hit by a ray (reference area.cpp eval:82-90):
    area emitters emit radiance from the front side only. ``towards`` is the
    direction from the surface toward the viewer (-ray.d). ``uv_u/uv_v``
    (optional): hit uv — textured area emitters (rect/mesh/sphere) evaluate
    their radiance texture there (sphere hits carry object-space spherical
    uv; the NEE sampler computes the same uv at its sampled point)."""
    from ..render.scene import gather_small
    idx = jnp.maximum(lane_emitter, 0)

    def param(j):
        return gather_small(sa.emitter_params[j], idx)

    front = dot(si_n, towards) > 0.0
    ok = (lane_emitter >= 0) & front
    if EMITTER_DIRECTIONALAREA in sa.emitter_types_present:
        # delta-direction emission: a regular ray hit sees zero radiance
        # (reference directionalarea.cpp eval)
        lane_type = gather_small(sa.emitter_type, idx)
        ok = ok & (lane_type != EMITTER_DIRECTIONALAREA)
    inten = _lane_intensity(param, wavelengths)
    if uv_u is not None and int(sa.n_textures) > 0:
        lane_type = gather_small(sa.emitter_type, idx)
        texid = param(E_RAD_TEX).astype(jnp.int32)
        use_tex = ((texid >= 0)
                   & ((lane_type == EMITTER_AREA_RECT)
                      | (lane_type == EMITTER_AREA_MESH)
                      | (lane_type == EMITTER_AREA_SPHERE)))
        from ..textures import eval_texture
        tx = eval_texture(sa, jnp.maximum(texid, 0), uv_u, uv_v,
                          wavelengths=wavelengths)
        inten = where3(use_tex, tx, inten)
    w = jnp.where(ok, 1.0, 0.0)
    return inten * w


__all__ = [
    "Emitter", "PointEmitter", "AreaEmitter", "ConstantEmitter",
    "sample_emitter_index", "sample_direction", "pdf_direction",
    "eval_emitter_hit", "N_EMITTER_PARAMS",
    "EMITTER_POINT", "EMITTER_AREA_RECT", "EMITTER_CONSTANT",
    "EMITTER_AREA_SPHERE",
    "E_POS", "E_INTENSITY", "E_AREA",
]


@register_plugin("emitter", "directional")
class DirectionalEmitter(Emitter):
    """reference src/emitters/directional.cpp — delta directional light."""
    type_id = EMITTER_DIRECTIONAL
    delta = True

    def __init__(self, props: Properties):
        super().__init__(props)
        if props.has_property("direction"):
            d = props.get_vector("direction")
        else:
            m = props.get_transform("to_world", np.eye(4))
            d = m[:3, 2]
        self.direction = d / np.linalg.norm(d)
        self.irradiance = _get_rgb(props, "irradiance", [1.0, 1.0, 1.0])

    def params_row(self):
        p = np.zeros(N_EMITTER_PARAMS)
        p[E_POS:E_POS + 3] = self.direction
        p[E_INTENSITY:E_INTENSITY + 3] = self.irradiance
        return p


@register_plugin("emitter", "spot")
class SpotEmitter(Emitter):
    """reference src/emitters/spot.cpp — point light with angular falloff."""
    type_id = EMITTER_SPOT
    delta = True

    def __init__(self, props: Properties):
        super().__init__(props)
        m = props.get_transform("to_world", np.eye(4))
        self.position = m[:3, 3]
        self.direction = m[:3, 2] / np.linalg.norm(m[:3, 2])
        self.intensity = _get_rgb(props, "intensity", [1.0, 1.0, 1.0])
        cutoff = props.get_float("cutoff_angle", 20.0)
        beam = props.get_float("beam_width", cutoff * 0.75)
        self.cos_cutoff = float(np.cos(np.radians(cutoff)))
        self.cos_beam = float(np.cos(np.radians(beam)))

    def params_row(self):
        p = np.zeros(N_EMITTER_PARAMS)
        p[E_POS:E_POS + 3] = self.position
        p[E_INTENSITY:E_INTENSITY + 3] = self.intensity
        p[E_CUTOFF] = self.cos_cutoff
        p[E_BEAM] = self.cos_beam
        p[9:12] = self.direction
        return p


EMITTER_ENVMAP = 6


@register_plugin("emitter", "envmap")
class EnvmapEmitter(Emitter):
    """Image-based environment light (reference src/emitters/envmap.cpp).

    Direction convention matches the reference: in emitter space,
    u = atan2(d.x, -d.z)/(2pi) (wrapped), v = acos(d.y)/pi. Importance
    sampling uses a flattened luminance*sin(theta) CDF over all texels
    (the functional equivalent of the reference's Hierarchical2D warp,
    include/mitsuba/core/distr_2d.h:344)."""
    type_id = EMITTER_ENVMAP
    is_environment = True
    delta = False

    def __init__(self, props: Properties):
        super().__init__(props)
        self.scale = props.get_float("scale", 1.0)
        if props.has_property("filename"):
            from ..io.bitmap import read_exr
            from ..core.fresolver import resolve_filename
            filename = resolve_filename(props.get_string("filename"))
            if filename.lower().endswith(".exr"):
                ch = read_exr(filename)
                names = ("R", "G", "B") if "R" in ch else tuple(sorted(ch))[:3]
                img = np.stack([ch[n] for n in names], axis=-1)
            else:
                import imageio.v3 as iio
                img = np.asarray(iio.imread(filename), np.float32)
                if img.dtype == np.uint8 or img.max() > 64:
                    img = img / 255.0
                if img.ndim == 2:
                    img = np.stack([img] * 3, axis=-1)
                img = img[..., :3]
            self.image = np.asarray(img, np.float32) * self.scale
        else:
            rad = _get_rgb(props, "radiance", [1.0, 1.0, 1.0])
            self.image = np.tile(np.asarray(rad, np.float32)[None, None, :],
                                 (2, 4, 1)) * self.scale
        m = props.get_transform("to_world", np.eye(4))
        self.to_world = m
        # flattened pdf over texels: luminance * sin(theta)
        h, w, _ = self.image.shape
        lum = (0.2126 * self.image[..., 0] + 0.7152 * self.image[..., 1]
               + 0.0722 * self.image[..., 2])
        theta = (np.arange(h) + 0.5) / h * np.pi
        weights = lum * np.sin(theta)[:, None]
        total = weights.sum()
        self.texel_pdf = (weights / max(total, 1e-20)).astype(np.float32)
        self.texel_cdf = np.cumsum(self.texel_pdf.reshape(-1)).astype(
            np.float32)
        self.texel_alias, self.texel_aprob = build_alias(
            self.texel_pdf.reshape(-1))

    @property
    def radiance(self):
        return self.image.reshape(-1, 3).mean(axis=0)

    def params_row(self):
        p = np.zeros(N_EMITTER_PARAMS)
        p[E_INTENSITY:E_INTENSITY + 3] = self.radiance
        return p


def _env_spectral(sa, flat, wavelengths):
    """Per-texel emission spectrum at the hero wavelengths (the envmap
    analog of the texture atlas's rgb2spec path): radiance =
    peak * S(coeffs) * D65 / (integral D65 * ybar)."""
    from ..core.cie import eval_emission_spectrum, d65_y_norm
    c0 = sa.env_coeff[0][flat]
    c1 = sa.env_coeff[1][flat]
    c2 = sa.env_coeff[2][flat]
    pk = sa.env_coeff[3][flat]
    inv_n = 1.0 / d65_y_norm()
    return Vec3(
        eval_emission_spectrum(c0, c1, c2, pk, wavelengths.x, inv_n),
        eval_emission_spectrum(c0, c1, c2, pk, wavelengths.y, inv_n),
        eval_emission_spectrum(c0, c1, c2, pk, wavelengths.z, inv_n))


def envmap_eval(sa, d: Vec3, wavelengths=None):
    """Environment radiance for directions (miss rays / NEE eval);
    ``wavelengths`` (tpu_spectral): per-texel emission spectra instead of
    the rgb channels."""
    # to emitter space
    m = sa.env_rot          # (9,) row-major inverse rotation
    ex = m[0] * d.x + m[1] * d.y + m[2] * d.z
    ey = m[3] * d.x + m[4] * d.y + m[5] * d.z
    ez = m[6] * d.x + m[7] * d.y + m[8] * d.z
    u = jnp.arctan2(ex, -ez) * (0.5 / np.pi)
    u = jnp.where(u < 0.0, u + 1.0, u)
    v = jnp.arccos(jnp.clip(ey, -1.0, 1.0)) * (1.0 / np.pi)
    H, W = sa.env_shape
    xi = jnp.clip((u * W).astype(jnp.int32), 0, W - 1)
    yi = jnp.clip((v * H).astype(jnp.int32), 0, H - 1)
    flat = yi * W + xi
    if wavelengths is not None and sa.spectral:
        return _env_spectral(sa, flat, wavelengths)
    return Vec3(sa.env_img_r[flat], sa.env_img_g[flat], sa.env_img_b[flat])


def build_alias(p: np.ndarray):
    """Vose alias table for the discrete pmf ``p`` (host-side, O(n)).
    Sampling is then exact with TWO gathers (prob + alias) instead of a
    log2(n)-round binary search over the CDF (a dependent chain of
    gathers per lane)."""
    n = p.size
    scaled = p.astype(np.float64) * n
    alias = np.arange(n, dtype=np.int32)
    prob = np.ones(n, np.float32)
    small = [i for i in range(n) if scaled[i] < 1.0]
    large = [i for i in range(n) if scaled[i] >= 1.0]
    while small and large:
        s = small.pop()
        l = large.pop()
        prob[s] = scaled[s]
        alias[s] = l
        scaled[l] = scaled[l] - (1.0 - scaled[s])
        (small if scaled[l] < 1.0 else large).append(l)
    for i in small + large:
        prob[i] = 1.0
    return alias, prob


def envmap_sample_direction(sa, ref_p: Vec3, s_x, s_y,
                            wavelengths=None):
    """Importance-sample the envmap texel pmf via its alias table (exact,
    O(1) — see build_alias); returns (DirectionSample, spec=L/pdf)."""
    H, W = sa.env_shape
    n = ref_p.x.shape[0]
    dtype = ref_p.x.dtype
    N = H * W
    j = jnp.clip((s_x * N).astype(jnp.int32), 0, N - 1)
    # an extra decorrelated uniform for the alias threshold, derived the
    # same way as the in-texel jitters below
    t = (s_y * 15485863.0) % 1.0
    idx = jnp.where(t < sa.env_aprob[j], j, sa.env_alias[j]).astype(jnp.int32)
    yi = idx // W
    xi = idx - yi * W
    # jitter within the texel using s_y split into two halves
    ju = (s_y * 7919.0) % 1.0
    jv = (s_y * 104729.0) % 1.0
    u = (xi.astype(dtype) + ju) / W
    v = (yi.astype(dtype) + jv) / H
    theta = v * np.pi
    # exact inverse of the eval/pdf uv convention u = atan2(ex,-ez)/2pi
    # (a -pi phase here would sample texels 180 deg in yaw away from the
    # direction handed back — wrong radiance AND broken MIS)
    phi = u * 2.0 * np.pi
    st = jnp.sin(theta)
    # emitter space direction (inverse of uv mapping): x = sin(t)sin(p)...
    ex = st * jnp.sin(phi)
    ey = jnp.cos(theta)
    ez = -st * jnp.cos(phi)
    m = sa.env_rot_fwd
    d = Vec3(m[0] * ex + m[1] * ey + m[2] * ez,
             m[3] * ex + m[4] * ey + m[5] * ez,
             m[6] * ex + m[7] * ey + m[8] * ez)
    texel_pdf = sa.env_pdf[idx]
    # solid-angle pdf: p(texel) * (W*H) / (2 pi^2 sin(theta))
    pdf = texel_pdf * (W * H) / jnp.maximum(
        2.0 * np.pi * np.pi * st, 1e-8)
    if wavelengths is not None and sa.spectral:
        L = _env_spectral(sa, idx, wavelengths)
    else:
        L = Vec3(sa.env_img_r[idx], sa.env_img_g[idx], sa.env_img_b[idx])
    w = jnp.where(pdf > 0.0, 1.0 / jnp.maximum(pdf, 1e-20), 0.0)
    spec = L * w
    radius = jnp.asarray(sa.bsphere_radius, dtype)
    dist = jnp.full((n,), 2.0, dtype) * radius
    ds = DirectionSample(ref_p + d * dist, -d, d, dist, pdf,
                         jnp.zeros((n,), bool), jnp.zeros((n,), jnp.int32))
    return ds, spec


def envmap_pdf_direction(sa, d: Vec3):
    m = sa.env_rot
    ex = m[0] * d.x + m[1] * d.y + m[2] * d.z
    ey = m[3] * d.x + m[4] * d.y + m[5] * d.z
    ez = m[6] * d.x + m[7] * d.y + m[8] * d.z
    u = jnp.arctan2(ex, -ez) * (0.5 / np.pi)
    u = jnp.where(u < 0.0, u + 1.0, u)
    v = jnp.arccos(jnp.clip(ey, -1.0, 1.0)) * (1.0 / np.pi)
    H, W = sa.env_shape
    xi = jnp.clip((u * W).astype(jnp.int32), 0, W - 1)
    yi = jnp.clip((v * H).astype(jnp.int32), 0, H - 1)
    flat = yi * W + xi
    st = jnp.sin(v * np.pi)
    return sa.env_pdf[flat] * (W * H) / jnp.maximum(
        2.0 * np.pi * np.pi * st, 1e-8)


EMITTER_PROJECTOR = 7
EMITTER_DIRECTIONALAREA = 8


@register_plugin("emitter", "projector")
class ProjectorEmitter(Emitter):
    """reference src/emitters/projector.cpp — textured spot light projecting
    an image through a perspective frustum (delta position)."""
    type_id = EMITTER_PROJECTOR
    delta = True

    def __init__(self, props: Properties):
        super().__init__(props)
        m = props.get_transform("to_world", np.eye(4))
        self.position = m[:3, 3]
        self.to_world = m
        self.scale = props.get_float("scale", 1.0)
        fov = props.get_float("fov", 45.0)
        import math as _m
        self.tan_half = _m.tan(_m.radians(fov) * 0.5)
        self.irradiance_tex = None
        from ..textures import Texture
        for key, v in props.objects():
            if isinstance(v, Texture):
                self.irradiance_tex = v
        if props.has_property("irradiance"):
            self.irradiance = _get_rgb(props, "irradiance", [1, 1, 1])
        elif self.irradiance_tex is not None:
            self.irradiance = np.asarray(self.irradiance_tex.mean_rgb())
        else:
            self.irradiance = np.ones(3)
        self.tex_index = -1   # assigned at compile when texture-driven

    def params_row(self):
        p = np.zeros(N_EMITTER_PARAMS)
        p[E_POS:E_POS + 3] = self.position
        p[E_INTENSITY:E_INTENSITY + 3] = self.irradiance * self.scale
        p[E_CUTOFF] = self.tan_half
        p[E_BEAM] = float(self.tex_index)
        # rotation rows for frustum projection
        R = np.linalg.inv(self.to_world[:3, :3])
        p[9] = R[0, 0]
        # remaining rotation lives in emitter_m (the shared 3x4 slot)
        return p


@register_plugin("emitter", "directionalarea")
class DirectionalAreaEmitter(AreaEmitter):
    """reference src/emitters/directionalarea.cpp — area emitter radiating
    only along its surface normal (delta in direction). NEE cannot sample
    it; it contributes when hit... in practice it is used as a collimated
    source via ptracer-style transport. v1: treated as a delta emitter that
    NEE skips; direct hits emit radiance along the normal only."""
    type_id = EMITTER_DIRECTIONALAREA
    delta = True

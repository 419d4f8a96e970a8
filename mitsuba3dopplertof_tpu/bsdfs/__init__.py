"""BSDF plugins and the wavefront dispatch.

The reference dispatches BSDFs through Dr.Jit vcalls over a pointer registry
(reference include/mitsuba/render/bsdf.h:266, used at
src/integrators/dopplertofpath.cpp:210). Here: each BSDF
instance compiles to one row of a parameter table (type id + f32 params);
``eval_pdf_sample`` evaluates every type *present in the scene* over the full
wavefront and blends with masks — with <=4 distinct types per scene this is
pure VPU work that XLA fuses into the bounce loop, with no divergence.

All directions are in the local shading frame (z = normal), matching the
reference's convention.
"""

from __future__ import annotations

from typing import NamedTuple

import math
import numpy as np
import jax.numpy as jnp

from ..core.properties import Properties, register_plugin
from ..core.math import INV_PI
from ..core import warp

# type ids (table column 0)
BSDF_DIFFUSE = 0
BSDF_NULL = 1
BSDF_CONDUCTOR = 2
BSDF_DIELECTRIC = 3
BSDF_ROUGHCONDUCTOR = 4
BSDF_PLASTIC = 5
BSDF_ROUGHPLASTIC = 6
BSDF_ROUGHDIELECTRIC = 7
BSDF_THINDIELECTRIC = 8
BSDF_BLEND = 9
BSDF_MASK = 10

N_BSDF_PARAMS = 24
# param columns (meaning depends on type; diffuse uses 0:3 + TWOSIDED)
P_REFL = 0            # rgb reflectance / specular reflectance
P_TWOSIDED = 3        # 1.0 if wrapped in `twosided`
P_ETA = 4             # ior / eta (dielectric); rgb eta (conductor 4:7)
P_K = 7               # rgb k (conductor 7:10)
P_ALPHA = 10          # roughness alpha
P_SPEC_TRANS = 11     # rgb transmittance 11:14 (dielectric)
P_MF_DIST = 12        # roughconductor: 1.0 = beckmann, 0.0 = ggx
P_REFL_TEX = 14       # texture id driving the reflectance (-1 = constant)

# lobe flags (static per row, mirrors reference BSDFFlags)
FLAG_SMOOTH = 1       # has a smooth (non-delta) lobe => NEE applies
FLAG_DELTA = 2        # sampling may return a delta lobe
FLAG_NULL = 4         # null transmission lobe


class BSDF:
    """Host-side plugin base: compiles to (type_id, flags, params row)."""
    type_id = BSDF_DIFFUSE
    flags = FLAG_SMOOTH

    def __init__(self, props: Properties):
        self.id = props.id
        self.two_sided = False

    def params_row(self) -> np.ndarray:
        return np.zeros(N_BSDF_PARAMS, dtype=np.float64)


def _get_rgb(props, key, default):
    v = props.get(key, default)
    from ..textures import Texture
    from ..spectra import Spectrum
    if isinstance(v, (Texture, Spectrum)):
        return np.asarray(v.mean_rgb())
    if isinstance(v, dict):   # {'type':'rgb','value':[...]} from the parser
        v = v.get("value")
    a = np.asarray(v, dtype=np.float64).reshape(-1)
    if a.size == 1:
        a = np.repeat(a, 3)
    return a[:3]


def _get_texture(props, key):
    """Return the Texture object if the property is texture-driven."""
    from ..textures import Texture
    if props.has_property(key):
        v = props.get(key)
        if isinstance(v, Texture):
            return v
    return None


@register_plugin("bsdf", "diffuse")
class Diffuse(BSDF):
    """Lambertian (reference src/bsdfs/diffuse.cpp)."""
    type_id = BSDF_DIFFUSE
    flags = FLAG_SMOOTH

    def __init__(self, props: Properties):
        super().__init__(props)
        self.reflectance = _get_rgb(props, "reflectance", [0.5, 0.5, 0.5])
        self.reflectance_tex = _get_texture(props, "reflectance")
        self.tex_index = -1   # assigned at scene compile

    def params_row(self):
        p = np.zeros(N_BSDF_PARAMS)
        p[P_REFL:P_REFL + 3] = self.reflectance
        p[P_TWOSIDED] = 1.0 if self.two_sided else 0.0
        p[P_REFL_TEX] = float(self.tex_index)
        return p


@register_plugin("bsdf", "twosided")
class TwoSided(BSDF):
    """Adapter making the nested BSDF two-sided
    (reference src/bsdfs/twosided.cpp). Compiles to the nested row with the
    TWOSIDED flag set rather than a separate dispatch case."""

    def __init__(self, props: Properties):
        super().__init__(props)
        nested = None
        for key, v in props.objects():
            if isinstance(v, BSDF):
                nested = v
        if nested is None:
            raise RuntimeError("twosided: requires a nested BSDF")
        self.nested = nested
        self.nested.two_sided = True
        self.type_id = nested.type_id
        self.flags = nested.flags
        self.two_sided = True

    def params_row(self):
        row = self.nested.params_row()
        row[P_TWOSIDED] = 1.0
        return row


@register_plugin("bsdf", "null")
class Null(BSDF):
    """Pass-through (reference src/bsdfs/null.cpp)."""
    type_id = BSDF_NULL
    flags = FLAG_NULL | FLAG_DELTA

    def __init__(self, props: Properties):
        super().__init__(props)

    def params_row(self):
        return np.zeros(N_BSDF_PARAMS)


# ---------------------------------------------------------------------------
# Device-side dispatch (component-wise: directions are Vec3, colors are Vec3)
# ---------------------------------------------------------------------------

from ..core.vec import Vec3, where3  # noqa: E402


class BSDFSampleResult(NamedTuple):
    val_nee: Vec3             # f(wi, wo_nee) * cos(wo_nee)   (rgb)
    pdf_nee: jnp.ndarray      # (N,)
    wo: Vec3                  # sampled direction (local)
    weight: Vec3              # f*cos/pdf for the sampled direction (rgb)
    pdf: jnp.ndarray          # (N,)
    eta: jnp.ndarray          # (N,)
    sampled_delta: jnp.ndarray  # (N,) bool
    sampled_null: jnp.ndarray   # (N,) bool


def _diffuse_eval_pdf_sample(param, wi: Vec3, wo_nee: Vec3, s1, s2x, s2y,
                             tex_refl=None, tex_mask=None):
    """Reference src/bsdfs/diffuse.cpp eval/pdf/sample; `s1` is drawn by the
    caller but unused (lobe selection only matters for multi-lobe types).
    ``param(j)``: per-lane (N,) column accessor; ``tex_refl``/``tex_mask``
    override the reflectance for texture-driven lanes."""
    refl = Vec3(param(P_REFL), param(P_REFL + 1), param(P_REFL + 2))
    if tex_refl is not None:
        refl = where3(tex_mask, tex_refl, refl)
    two_sided = param(P_TWOSIDED) > 0.5
    sgn = jnp.where(two_sided & (wi.z < 0.0), -1.0, 1.0)
    cos_i = wi.z * sgn
    cos_o_nee = wo_nee.z * sgn

    front = (cos_i > 0.0) & (cos_o_nee > 0.0)
    fcos = jnp.where(front, INV_PI * cos_o_nee, 0.0)
    val_nee = refl * fcos
    pdf_nee = fcos

    wo_local = warp.cosine_hemisphere_c(s2x, s2y)
    ok = cos_i > 0.0
    pdf = jnp.where(ok, INV_PI * wo_local.z, 0.0)
    wo = Vec3(wo_local.x, wo_local.y, wo_local.z * sgn)
    zero = jnp.zeros_like(pdf)
    weight = where3(ok, refl, Vec3(zero, zero, zero))
    false_ = zero > 1.0
    return BSDFSampleResult(val_nee, pdf_nee, wo, weight, pdf,
                            jnp.ones_like(pdf), false_, false_)


def _null_eval_pdf_sample(param, wi: Vec3, wo_nee: Vec3, s1, s2x, s2y):
    z = jnp.zeros_like(wi.z)
    ones = jnp.ones_like(wi.z)
    true_ = ones > 0.0
    # transmittance tint (0 row = plain null; polarizer/retarder set P_REFL)
    tx = param(P_REFL)
    ty = param(P_REFL + 1)
    tz = param(P_REFL + 2)
    w = Vec3(jnp.where(tx > 0.0, tx, 1.0), jnp.where(ty > 0.0, ty, 1.0),
             jnp.where(tz > 0.0, tz, 1.0))
    return BSDFSampleResult(
        Vec3(z, z, z), z, -wi, w, ones,
        ones, true_, true_)


_DISPATCH = {
    BSDF_DIFFUSE: _diffuse_eval_pdf_sample,
    BSDF_NULL: _null_eval_pdf_sample,
}


def remap_wrapper_rows(sa, lane_bsdf, s1):
    """mask/blendbsdf lanes stochastically remap to a nested row; rescales
    and returns the lobe-selection sample for the nested BSDF."""
    from ..render.scene import gather_small
    lane_type = gather_small(sa.bsdf_type, lane_bsdf)
    is_wrap = (lane_type == BSDF_MASK) | (lane_type == BSDF_BLEND)
    mix = gather_small(sa.bsdf_params[P_MIX], lane_bsdf)
    n0 = gather_small(sa.bsdf_params[P_NESTED0], lane_bsdf).astype(jnp.int32)
    n1 = gather_small(sa.bsdf_params[P_NESTED1], lane_bsdf).astype(jnp.int32)
    pick1 = s1 < mix
    remapped = jnp.where(pick1, n1, n0)
    new_bsdf = jnp.where(is_wrap, remapped, lane_bsdf)
    # rescale the selection sample for the nested lobe choice
    s1_re = jnp.where(pick1, s1 / jnp.maximum(mix, 1e-8),
                      (s1 - mix) / jnp.maximum(1.0 - mix, 1e-8))
    new_s1 = jnp.where(is_wrap, jnp.clip(s1_re, 0.0, 0.999999), s1)
    return new_bsdf, new_s1


def eval_pdf_sample(sa, lane_bsdf, wi: Vec3, wo_nee: Vec3,
                    s1, s2x, s2y, tex_refl=None, tex_mask=None,
                    wavelengths=None) -> BSDFSampleResult:
    """Masked multi-type dispatch of BSDF::eval_pdf_sample
    (reference src/render/bsdf.cpp:168). Evaluates each type present in the
    scene over the whole wavefront and mask-selects — pure fused VPU work,
    the equivalent of the reference's vcall over the BSDFPtr registry.
    """
    from ..render.scene import gather_small
    if BSDF_MASK in sa.bsdf_types_present or BSDF_BLEND in sa.bsdf_types_present:
        lane_bsdf, s1 = remap_wrapper_rows(sa, lane_bsdf, s1)

    lane_type = gather_small(sa.bsdf_type, lane_bsdf)

    def param(j):
        return gather_small(sa.bsdf_params[j], lane_bsdf)

    if wavelengths is not None:
        # tpu_spectral: diffuse P_REFL columns hold sigmoid-upsampling
        # coefficients (core/cie.py); evaluate the reflectance spectrum at
        # the lane's 3 hero wavelengths and feed it through the existing
        # texture-override slot. Textured lanes arrive ALREADY spectral:
        # eval_texture sampled the per-texel coefficient atlas at the same
        # wavelengths (textures/__init__.py TEX_BITMAP).
        from ..core.cie import eval_reflectance_spectrum as _ers
        c0, c1, c2 = param(P_REFL), param(P_REFL + 1), param(P_REFL + 2)
        srefl = Vec3(_ers(c0, c1, c2, wavelengths.x),
                     _ers(c0, c1, c2, wavelengths.y),
                     _ers(c0, c1, c2, wavelengths.z))
        is_up = jnp.zeros_like(lane_type, dtype=bool)
        for t in SPECTRAL_UPSAMPLED_TYPES:
            is_up = is_up | (lane_type == t)
        if tex_refl is not None:
            srefl = where3(tex_mask, tex_refl, srefl)
            tex_mask = tex_mask | is_up
        else:
            tex_mask = is_up
        tex_refl = srefl

    result = None
    for tid in sa.bsdf_types_present:
        if tid in (BSDF_MASK, BSDF_BLEND):
            continue      # remapped above; no lanes carry these types now
        if tid == BSDF_MEASURED:
            from .measured_impl import measured_eval_pdf_sample
            m_idx = param(P_MEASURED_IDX).astype(jnp.int32)
            r = None
            for k, tbl in enumerate(sa.measured):
                rk = measured_eval_pdf_sample(tbl, wi, wo_nee, s2x, s2y,
                                              wavelengths)
                if r is None:
                    r = rk
                else:
                    mk = m_idx == k
                    r = BSDFSampleResult(*(
                        where3(mk, a, b) if isinstance(a, Vec3)
                        else jnp.where(mk, a, b)
                        for a, b in zip(rk, r)))
            if result is None:
                result = r
            else:
                m = lane_type == tid
                result = BSDFSampleResult(*(
                    where3(m, a, b) if isinstance(a, Vec3)
                    else jnp.where(m, a, b)
                    for a, b in zip(r, result)))
            continue
        if tid == BSDF_MEASURED_POL:
            from .measured_polarized_impl import pbsdf_eval_pdf_sample
            m_idx = param(P_MEASURED_IDX).astype(jnp.int32)
            alpha = param(P_ALPHA_SAMPLE)
            r = None
            for k, (tbl, wls) in enumerate(zip(sa.measured_pol,
                                               sa.measured_pol_wls)):
                rk = pbsdf_eval_pdf_sample(tbl, alpha, wi, wo_nee,
                                           s1, s2x, s2y, wavelengths=wls)
                if r is None:
                    r = rk
                else:
                    mk = m_idx == k
                    r = BSDFSampleResult(*(
                        where3(mk, a, b) if isinstance(a, Vec3)
                        else jnp.where(mk, a, b)
                        for a, b in zip(rk, r)))
            if result is None:
                result = r
            else:
                m = lane_type == tid
                result = BSDFSampleResult(*(
                    where3(m, a, b) if isinstance(a, Vec3)
                    else jnp.where(m, a, b)
                    for a, b in zip(r, result)))
            continue
        fn = _DISPATCH.get(int(tid))
        if fn is None:
            raise NotImplementedError(f"BSDF type id {tid} not implemented")
        if tid in SPECTRAL_UPSAMPLED_TYPES and tex_refl is not None:
            # these types take the reflectance-spectrum/texture override
            # (diffuse albedo / plastic diffuse / principled base color)
            r = fn(param, wi, wo_nee, s1, s2x, s2y, tex_refl, tex_mask)
        elif (tid in (BSDF_CONDUCTOR, BSDF_ROUGHCONDUCTOR)
                and wavelengths is not None
                and getattr(sa, "ior_spectra", None)):
            # tpu_spectral: named-material conductors interpolate real
            # eta(lambda)/k(lambda) at the lane's hero wavelengths — the
            # rgb channels carry the 3 wavelengths (ior_data.py; replaces
            # the rgb-tint approximation)
            import numpy as _np
            ior_host = jnp.asarray(_np.asarray(sa.bsdf_ior_host, _np.int32))
            lane_ior = gather_small(ior_host, lane_bsdf)
            lam3 = (wavelengths.x, wavelengths.y, wavelengths.z)

            def param_spec(j, _p=param):
                base = _p(j)
                if P_ETA <= j < P_ETA + 3 or P_K <= j < P_K + 3:
                    which_k = j >= P_K
                    lam = lam3[j - (P_K if which_k else P_ETA)]
                    out = base
                    for e_i, (wls_t, eta_t, k_t) in enumerate(
                            sa.ior_spectra):
                        tab = k_t if which_k else eta_t
                        v = jnp.interp(lam,
                                       jnp.asarray(wls_t, jnp.float32),
                                       jnp.asarray(tab, jnp.float32))
                        out = jnp.where(lane_ior == e_i, v, out)
                    return out
                return base
            r = fn(param_spec, wi, wo_nee, s1, s2x, s2y)
        else:
            r = fn(param, wi, wo_nee, s1, s2x, s2y)
        if result is None:
            result = r
        else:
            m = lane_type == tid
            result = BSDFSampleResult(
                where3(m, r.val_nee, result.val_nee),
                jnp.where(m, r.pdf_nee, result.pdf_nee),
                where3(m, r.wo, result.wo),
                where3(m, r.weight, result.weight),
                jnp.where(m, r.pdf, result.pdf),
                jnp.where(m, r.eta, result.eta),
                jnp.where(m, r.sampled_delta, result.sampled_delta),
                jnp.where(m, r.sampled_null, result.sampled_null),
            )
    return result


__all__ = [
    "BSDF", "Diffuse", "TwoSided", "Null", "BSDFSampleResult",
    "eval_pdf_sample", "N_BSDF_PARAMS",
    "FLAG_SMOOTH", "FLAG_DELTA", "FLAG_NULL",
    "BSDF_DIFFUSE", "BSDF_NULL",
]


# ---------------------------------------------------------------------------
# Specular / microfacet BSDFs
# ---------------------------------------------------------------------------

from ..core.fresnel import (fresnel_dielectric, fresnel_conductor, reflect,
                            refract)
from ..core import microfacet as mf

# named IORs (reference src/render/ior.h subset)
IOR_NAMES = {
    "vacuum": 1.0, "air": 1.000277, "water": 1.3330, "water ice": 1.31,
    "fused quartz": 1.458, "pyrex": 1.470, "acrylic glass": 1.49,
    "polypropylene": 1.49, "bk7": 1.5046, "sodium chloride": 1.544,
    "amber": 1.55, "pet": 1.5750, "diamond": 2.419, "bromine": 1.661,
}

# approximate RGB (eta, k) for common conductors at sRGB primaries
# (public tabulated values, same sources the reference's spectra distill to)
CONDUCTOR_IOR = {
    "none": ((0.0, 0.0, 0.0), (1.0, 1.0, 1.0)),
    "Au": ((0.1431, 0.3749, 1.4424), (3.9831, 2.3857, 1.6032)),
    "Ag": ((0.1553, 0.1163, 0.1380), (4.8283, 3.1222, 2.1457)),
    "Al": ((1.6574, 0.8803, 0.5212), (9.2238, 6.2696, 4.8370)),
    "Cu": ((0.2004, 0.9240, 1.1022), (3.9129, 2.4528, 2.1421)),
    "Cr": ((4.3617, 2.9113, 1.6539), (5.1931, 4.2223, 3.7471)),
    "Ni": ((2.3672, 1.6633, 1.4670), (4.4988, 3.0501, 2.3454)),
    "W": ((4.3707, 3.3002, 2.9982), (3.5006, 2.6048, 2.2731)),
    "TiN": ((1.6484, 1.1465, 1.3831), (3.3684, 2.1214, 1.9460)),
}


def _parse_ior(props, key, default):
    v = props.get(key, default)
    if isinstance(v, str):
        if v not in IOR_NAMES:
            raise RuntimeError(f"Unknown IOR material '{v}'")
        return IOR_NAMES[v]
    if isinstance(v, dict):
        v = v.get("value")
        if isinstance(v, (list, tuple)):
            v = v[0]
    return float(v)


@register_plugin("bsdf", "conductor")
class Conductor(BSDF):
    """Smooth conductor (reference src/bsdfs/conductor.cpp): perfect mirror
    with complex-ior Fresnel weight."""
    type_id = BSDF_CONDUCTOR
    flags = FLAG_DELTA

    def __init__(self, props: Properties):
        super().__init__(props)
        mat = props.get_string("material", "none")
        eta_d, k_d = CONDUCTOR_IOR.get(mat, CONDUCTOR_IOR["none"])
        # tpu_spectral: named materials without explicit eta/k overrides
        # interpolate real eta(lambda)/k(lambda) spectra (ior_data.py,
        # the analog of reference complex_ior_from_file, ior.h:139-144)
        from .ior_data import CONDUCTOR_SPECTRA
        self.material = (mat if (mat in CONDUCTOR_SPECTRA
                                 and not props.has_property("eta")
                                 and not props.has_property("k"))
                         else None)
        self.eta = _get_rgb(props, "eta", list(eta_d))
        self.k = _get_rgb(props, "k", list(k_d))
        self.specular_reflectance = _get_rgb(
            props, "specular_reflectance", [1.0, 1.0, 1.0])

    def params_row(self):
        p = np.zeros(N_BSDF_PARAMS)
        p[P_REFL:P_REFL + 3] = self.specular_reflectance
        p[P_TWOSIDED] = 1.0 if self.two_sided else 0.0
        p[P_ETA:P_ETA + 3] = self.eta
        p[P_K:P_K + 3] = self.k
        return p


@register_plugin("bsdf", "roughconductor")
class RoughConductor(Conductor):
    """GGX microfacet conductor (reference src/bsdfs/roughconductor.cpp,
    visible-normal sampling)."""
    type_id = BSDF_ROUGHCONDUCTOR
    flags = FLAG_SMOOTH

    def __init__(self, props: Properties):
        super().__init__(props)
        dist = props.get_string("distribution", "ggx")
        if dist not in ("ggx", "beckmann"):
            raise RuntimeError(
                f"roughconductor: unknown distribution '{dist}'")
        self.distribution = dist
        alpha = props.get_float("alpha", 0.1)
        self.alpha_u = props.get_float("alpha_u", alpha)
        self.alpha_v = props.get_float("alpha_v", alpha)

    def params_row(self):
        p = super().params_row()
        p[P_ALPHA] = self.alpha_u
        p[P_ALPHA + 1] = self.alpha_v
        p[P_MF_DIST] = 1.0 if self.distribution == "beckmann" else 0.0
        return p


@register_plugin("bsdf", "dielectric")
class Dielectric(BSDF):
    """Smooth dielectric (reference src/bsdfs/dielectric.cpp)."""
    type_id = BSDF_DIELECTRIC
    flags = FLAG_DELTA

    def __init__(self, props: Properties):
        super().__init__(props)
        int_ior = _parse_ior(props, "int_ior", "bk7")
        ext_ior = _parse_ior(props, "ext_ior", "air")
        self.eta = int_ior / ext_ior
        self.specular_reflectance = _get_rgb(
            props, "specular_reflectance", [1.0, 1.0, 1.0])
        self.specular_transmittance = _get_rgb(
            props, "specular_transmittance", [1.0, 1.0, 1.0])

    def params_row(self):
        p = np.zeros(N_BSDF_PARAMS)
        p[P_REFL:P_REFL + 3] = self.specular_reflectance
        p[P_ETA] = self.eta
        p[P_SPEC_TRANS:P_SPEC_TRANS + 3] = self.specular_transmittance
        return p


@register_plugin("bsdf", "thindielectric")
class ThinDielectric(Dielectric):
    """Thin dielectric slab (reference src/bsdfs/thindielectric.cpp)."""
    type_id = BSDF_THINDIELECTRIC
    flags = FLAG_DELTA | FLAG_NULL


@register_plugin("bsdf", "plastic")
class Plastic(BSDF):
    """Smooth plastic: delta dielectric coat over a diffuse base
    (reference src/bsdfs/plastic.cpp)."""
    type_id = BSDF_PLASTIC
    flags = FLAG_SMOOTH | FLAG_DELTA

    def __init__(self, props: Properties):
        super().__init__(props)
        int_ior = _parse_ior(props, "int_ior", "polypropylene")
        ext_ior = _parse_ior(props, "ext_ior", "air")
        self.eta = int_ior / ext_ior
        self.diffuse_reflectance = _get_rgb(
            props, "diffuse_reflectance", [0.5, 0.5, 0.5])
        self.specular_reflectance = _get_rgb(
            props, "specular_reflectance", [1.0, 1.0, 1.0])
        self.nonlinear = props.get_bool("nonlinear", False)
        # internal diffuse Fresnel reflectance (reference plastic.cpp
        # precomputes fdr_int via quadrature; polynomial fit (Egan&Hilgeman
        # via d'Eon) is accurate to ~1e-3 for eta in [1, 3])
        e = self.eta
        self.fdr_int = fdr_approx(1.0 / e)
        self.fdr_ext = fdr_approx(e)
        # average specular sampling weight
        self.spec_weight_avg = float(np.mean(self.specular_reflectance))
        self.diff_weight_avg = float(np.mean(self.diffuse_reflectance))

    def params_row(self):
        p = np.zeros(N_BSDF_PARAMS)
        p[P_REFL:P_REFL + 3] = self.diffuse_reflectance
        p[P_TWOSIDED] = 1.0 if self.two_sided else 0.0
        p[P_ETA] = self.eta
        p[P_K] = self.fdr_int
        p[P_K + 1] = 1.0 if self.nonlinear else 0.0
        p[P_SPEC_TRANS:P_SPEC_TRANS + 3] = self.specular_reflectance
        # probability of picking the specular component (reference
        # plastic.cpp m_specular_sampling_weight)
        sw = self.spec_weight_avg / max(
            self.spec_weight_avg + self.diff_weight_avg, 1e-6)
        p[P_ALPHA + 1] = sw
        return p


def fdr_approx(eta: float) -> float:
    """Average Fresnel diffuse reflectance (d'Eon's rational fit)."""
    if eta < 1.0:
        return float(-0.4399 + 0.7099 / eta - 0.3319 / eta ** 2
                     + 0.0636 / eta ** 3)
    return float(-1.4399 / eta ** 2 + 0.7099 / eta + 0.6681 + 0.0636 * eta)


def _conductor_eval_pdf_sample(param, wi: Vec3, wo_nee: Vec3, s1, s2x, s2y):
    """Delta mirror (reference conductor.cpp): NEE impossible."""
    z = jnp.zeros_like(wi.z)
    ok = wi.z > 0.0
    wo = reflect(wi)
    F = Vec3(
        fresnel_conductor(wi.z, param(P_ETA), param(P_K)),
        fresnel_conductor(wi.z, param(P_ETA + 1), param(P_K + 1)),
        fresnel_conductor(wi.z, param(P_ETA + 2), param(P_K + 2)))
    refl = Vec3(param(P_REFL), param(P_REFL + 1), param(P_REFL + 2))
    weight = where3(ok, F * refl, Vec3(z, z, z))
    pdf = jnp.where(ok, 1.0, 0.0)
    true_ = jnp.ones_like(ok)
    return BSDFSampleResult(Vec3(z, z, z), z, wo, weight, pdf,
                            jnp.ones_like(z), true_, ~true_)


def _roughconductor_eval_pdf_sample(param, wi, wo_nee, s1, s2x, s2y):
    """Microfacet conductor (reference roughconductor.cpp): GGX with VNDF
    sampling (the reference default), or Beckmann with classic D*cos
    sampling on lanes whose row sets P_MF_DIST (the reference's
    sample_visible=false mode — same estimator, different variance)."""
    ax = param(P_ALPHA)
    ay = param(P_ALPHA + 1)
    is_beck = param(P_MF_DIST) > 0.5
    refl = Vec3(param(P_REFL), param(P_REFL + 1), param(P_REFL + 2))

    def F_of(cos_im):
        return Vec3(
            fresnel_conductor(cos_im, param(P_ETA), param(P_K)),
            fresnel_conductor(cos_im, param(P_ETA + 1), param(P_K + 1)),
            fresnel_conductor(cos_im, param(P_ETA + 2), param(P_K + 2)))

    cos_i = wi.z
    ok = cos_i > 0.0

    # --- NEE eval/pdf for wo_nee
    cos_o = wo_nee.z
    both = ok & (cos_o > 0.0)
    from ..core.vec import normalize as _norm
    h = _norm(wi + wo_nee)
    D = jnp.where(is_beck, mf.beckmann_D(h, ax, ay), mf.ggx_D(h, ax, ay))
    G = jnp.where(is_beck, mf.beckmann_G(wi, wo_nee, h, ax, ay),
                  mf.ggx_G(wi, wo_nee, h, ax, ay))
    val_scalar = jnp.where(both, D * G / jnp.maximum(4.0 * cos_i, 1e-12), 0.0)
    F = F_of(dot(wi, h))
    val_nee = F * refl * val_scalar
    # NOTE: microfacet brdf * cos_o = D F G / (4 cos_i): the cos_o cancels.
    pdf_m_nee = jnp.where(is_beck, mf.beckmann_pdf(h, ax, ay),
                          mf.ggx_pdf_visible(wi, h, ax, ay))
    pdf_nee = jnp.where(
        both,
        pdf_m_nee / jnp.maximum(4.0 * jnp.abs(dot(wo_nee, h)), 1e-12),
        0.0)

    # --- sample
    m_g, pdf_g = mf.ggx_sample_vndf(wi, ax, ay, s2x, s2y)
    m_b, pdf_b = mf.beckmann_sample(ax, ay, s2x, s2y)
    m = where3(is_beck, m_b, m_g)
    pdf_m = jnp.where(is_beck, pdf_b, pdf_g)
    wo = Vec3(2.0 * dot(wi, m) * m.x - wi.x,
              2.0 * dot(wi, m) * m.y - wi.y,
              2.0 * dot(wi, m) * m.z - wi.z)
    valid = ok & (wo.z > 0.0) & (pdf_m > 0.0)
    pdf = jnp.where(valid, pdf_m / jnp.maximum(4.0 * jnp.abs(dot(wo, m)), 1e-12), 0.0)
    # weight = f*cos/pdf: VNDF identity F*G2/G1 for GGX; Walter's
    # F*G*|wi.m|/(cos_i*m.z) for classic Beckmann sampling
    g2 = mf.ggx_G(wi, wo, m, ax, ay)
    g1 = mf.ggx_smith_g1(wi, m, ax, ay)
    w_ggx = g2 / jnp.maximum(g1, 1e-12)
    w_beck = (mf.beckmann_G(wi, wo, m, ax, ay) * jnp.abs(dot(wi, m))
              / jnp.maximum(cos_i * m.z, 1e-12))
    wscale = jnp.where(valid, jnp.where(is_beck, w_beck, w_ggx), 0.0)
    Fs = F_of(dot(wi, m))
    weight = Fs * refl * wscale
    z = jnp.zeros_like(cos_i)
    false_ = z > 1.0
    return BSDFSampleResult(val_nee, pdf_nee, wo, weight, pdf,
                            jnp.ones_like(z), false_, false_)


def _dielectric_eval_pdf_sample(param, wi, wo_nee, s1, s2x, s2y):
    """Smooth dielectric (reference dielectric.cpp): pick reflect/refract by
    Fresnel; radiance-transport eta^2 factor on refraction."""
    eta = param(P_ETA)
    F, cos_t, eta_it, eta_ti = fresnel_dielectric(wi.z, eta)
    # NOTE: eta is per-lane here; fresnel_dielectric handles array eta except
    # the index_matched special case which only triggers for python floats.
    pick_reflect = s1 <= F
    wo_r = reflect(wi)
    wo_t = refract(wi, cos_t, eta_ti)
    wo = where3(pick_reflect, wo_r, wo_t)
    pdf = jnp.where(pick_reflect, F, 1.0 - F)
    refl = Vec3(param(P_REFL), param(P_REFL + 1), param(P_REFL + 2))
    trans = Vec3(param(P_SPEC_TRANS), param(P_SPEC_TRANS + 1),
                 param(P_SPEC_TRANS + 2))
    # radiance transport: transmitted importance scales by eta_ti^2
    factor = eta_ti * eta_ti
    weight = where3(pick_reflect, refl, trans * factor)
    out_eta = jnp.where(pick_reflect, jnp.ones_like(F), eta_it)
    z = jnp.zeros_like(F)
    true_ = jnp.ones_like(pick_reflect)
    return BSDFSampleResult(Vec3(z, z, z), z, wo, weight, pdf,
                            out_eta, true_, ~true_)


def _thindielectric_eval_pdf_sample(param, wi, wo_nee, s1, s2x, s2y):
    """Thin slab (reference thindielectric.cpp): interaction with both
    interfaces folded in; transmission leaves direction unchanged."""
    eta = param(P_ETA)
    F, _, _, _ = fresnel_dielectric(jnp.abs(wi.z), eta)
    # account for internal bounces: R' = R + TRT + ... = 2R/(1+R)
    R = jnp.minimum(2.0 * F / (1.0 + F), 1.0)
    T = 1.0 - R
    pick_reflect = s1 <= R
    wo = where3(pick_reflect, reflect(wi), -wi)
    pdf = jnp.where(pick_reflect, R, T)
    refl = Vec3(param(P_REFL), param(P_REFL + 1), param(P_REFL + 2))
    trans = Vec3(param(P_SPEC_TRANS), param(P_SPEC_TRANS + 1),
                 param(P_SPEC_TRANS + 2))
    weight = where3(pick_reflect, refl, trans)
    z = jnp.zeros_like(F)
    true_ = jnp.ones_like(pick_reflect)
    return BSDFSampleResult(Vec3(z, z, z), z, wo, weight, pdf,
                            jnp.ones_like(F), true_, ~true_)


def _plastic_eval_pdf_sample(param, wi, wo_nee, s1, s2x, s2y,
                             tex_refl=None, tex_mask=None):
    """Smooth plastic (reference plastic.cpp): delta specular + diffuse with
    internal-scattering compensation."""
    eta = param(P_ETA)
    fdr_int = param(P_K)
    nonlinear = param(P_K + 1) > 0.5
    spec_prob_w = param(P_ALPHA + 1)
    diff = Vec3(param(P_REFL), param(P_REFL + 1), param(P_REFL + 2))
    if tex_refl is not None:     # spectral upsampling / texture override
        diff = where3(tex_mask, tex_refl, diff)
    spec = Vec3(param(P_SPEC_TRANS), param(P_SPEC_TRANS + 1),
                param(P_SPEC_TRANS + 2))
    two_sided = param(P_TWOSIDED) > 0.5
    sgn = jnp.where(two_sided & (wi.z < 0.0), -1.0, 1.0)
    cos_i = wi.z * sgn
    ok = cos_i > 0.0

    F_i, _, _, eta_ti = fresnel_dielectric(cos_i, eta)
    inv_eta_2 = eta_ti * eta_ti

    # probability of the specular component (reference plastic.cpp:sample)
    prob_spec = F_i * spec_prob_w / jnp.maximum(
        F_i * spec_prob_w + (1.0 - F_i) * (1.0 - spec_prob_w), 1e-12)

    # --- diffuse eval for NEE (specular lobe is delta -> contributes 0)
    cos_o_nee = wo_nee.z * sgn
    both = ok & (cos_o_nee > 0.0)
    F_o_nee, _, _, _ = fresnel_dielectric(cos_o_nee, eta)

    def diffuse_term(cos_o, F_o):
        scale = (1.0 - F_i) * (1.0 - F_o) * inv_eta_2 * INV_PI * cos_o
        denom_lin = 1.0 - fdr_int
        d = Vec3(
            diff.x / jnp.where(nonlinear, 1.0 - diff.x * fdr_int, denom_lin),
            diff.y / jnp.where(nonlinear, 1.0 - diff.y * fdr_int, denom_lin),
            diff.z / jnp.where(nonlinear, 1.0 - diff.z * fdr_int, denom_lin))
        return d * scale

    val_nee = where3(both, diffuse_term(cos_o_nee, F_o_nee),
                     Vec3(jnp.zeros_like(F_i), jnp.zeros_like(F_i),
                          jnp.zeros_like(F_i)))
    pdf_nee = jnp.where(both,
                        (1.0 - prob_spec) * INV_PI * cos_o_nee, 0.0)

    # --- sample
    pick_spec = s1 < prob_spec
    wo_d = warp.cosine_hemisphere_c(s2x, s2y)
    wo = where3(pick_spec, reflect(Vec3(wi.x, wi.y, cos_i)), wo_d)
    F_o_s, _, _, _ = fresnel_dielectric(wo.z, eta)
    pdf_d = (1.0 - prob_spec) * INV_PI * wo.z
    pdf = jnp.where(pick_spec, prob_spec, pdf_d)
    w_spec = spec * (F_i / jnp.maximum(prob_spec, 1e-12))
    w_diff_v = diffuse_term(wo.z, F_o_s)
    w_diff = w_diff_v * (1.0 / jnp.maximum(pdf_d, 1e-12))
    weight = where3(pick_spec, w_spec, w_diff)
    weight = where3(ok, weight, Vec3(jnp.zeros_like(F_i),
                                     jnp.zeros_like(F_i),
                                     jnp.zeros_like(F_i)))
    pdf = jnp.where(ok, pdf, 0.0)
    wo = Vec3(wo.x, wo.y, wo.z * sgn)
    return BSDFSampleResult(val_nee, pdf_nee, wo, weight, pdf,
                            jnp.ones_like(F_i), pick_spec,
                            jnp.zeros_like(pick_spec))


_DISPATCH[BSDF_CONDUCTOR] = _conductor_eval_pdf_sample
_DISPATCH[BSDF_ROUGHCONDUCTOR] = _roughconductor_eval_pdf_sample
_DISPATCH[BSDF_DIELECTRIC] = _dielectric_eval_pdf_sample
_DISPATCH[BSDF_THINDIELECTRIC] = _thindielectric_eval_pdf_sample
_DISPATCH[BSDF_PLASTIC] = _plastic_eval_pdf_sample

from ..core.vec import dot  # noqa: E402


@register_plugin("bsdf", "roughplastic")
class RoughPlastic(Plastic):
    """GGX rough plastic (reference src/bsdfs/roughplastic.cpp): microfacet
    specular coat + diffuse base with internal scattering."""
    type_id = BSDF_ROUGHPLASTIC
    flags = FLAG_SMOOTH

    def __init__(self, props: Properties):
        props.mark_queried("distribution")
        alpha = props.get_float("alpha", 0.1)
        super().__init__(props)
        self.alpha = alpha

    def params_row(self):
        p = super().params_row()
        p[P_ALPHA] = self.alpha
        return p


@register_plugin("bsdf", "roughdielectric")
class RoughDielectric(Dielectric):
    """GGX rough dielectric (reference src/bsdfs/roughdielectric.cpp)."""
    type_id = BSDF_ROUGHDIELECTRIC
    flags = FLAG_SMOOTH

    def __init__(self, props: Properties):
        props.mark_queried("distribution")
        alpha = props.get_float("alpha", 0.1)
        super().__init__(props)
        self.alpha = alpha

    def params_row(self):
        p = super().params_row()
        p[P_ALPHA] = self.alpha
        return p


def _roughplastic_eval_pdf_sample(param, wi, wo_nee, s1, s2x, s2y,
                                  tex_refl=None, tex_mask=None):
    """reference roughplastic.cpp: GGX specular + internally-scattered
    diffuse; both lobes are smooth so NEE evaluates both."""
    eta = param(P_ETA)
    fdr_int = param(P_K)
    nonlinear = param(P_K + 1) > 0.5
    spec_prob_w = param(P_ALPHA + 1)
    alpha = param(P_ALPHA)
    diff = Vec3(param(P_REFL), param(P_REFL + 1), param(P_REFL + 2))
    if tex_refl is not None:     # spectral upsampling / texture override
        diff = where3(tex_mask, tex_refl, diff)
    spec = Vec3(param(P_SPEC_TRANS), param(P_SPEC_TRANS + 1),
                param(P_SPEC_TRANS + 2))
    two_sided = param(P_TWOSIDED) > 0.5
    sgn = jnp.where(two_sided & (wi.z < 0.0), -1.0, 1.0)
    wi_l = Vec3(wi.x, wi.y, wi.z * sgn)
    cos_i = wi_l.z
    ok = cos_i > 0.0

    F_i, _, _, eta_ti = fresnel_dielectric(cos_i, eta)
    inv_eta_2 = eta_ti * eta_ti
    prob_spec = F_i * spec_prob_w / jnp.maximum(
        F_i * spec_prob_w + (1.0 - F_i) * (1.0 - spec_prob_w), 1e-12)
    prob_diff = 1.0 - prob_spec

    def diffuse_term(cos_o, F_o):
        scale = (1.0 - F_i) * (1.0 - F_o) * inv_eta_2 * INV_PI * cos_o
        denom_lin = 1.0 - fdr_int
        return Vec3(
            diff.x / jnp.where(nonlinear, 1.0 - diff.x * fdr_int, denom_lin),
            diff.y / jnp.where(nonlinear, 1.0 - diff.y * fdr_int, denom_lin),
            diff.z / jnp.where(nonlinear, 1.0 - diff.z * fdr_int, denom_lin),
        ) * scale

    def eval_both(wo):
        cos_o = wo.z
        both = ok & (cos_o > 0.0)
        from ..core.vec import normalize as _norm
        h = _norm(wi_l + wo)
        D = mf.ggx_D(h, alpha, alpha)
        G = mf.ggx_G(wi_l, wo, h, alpha, alpha)
        F_h, _, _, _ = fresnel_dielectric(dot(wi_l, h), eta)
        spec_scalar = jnp.where(both,
                                F_h * D * G / jnp.maximum(4.0 * cos_i, 1e-12),
                                0.0)
        F_o, _, _, _ = fresnel_dielectric(cos_o, eta)
        val = spec * spec_scalar + where3(
            both, diffuse_term(cos_o, F_o),
            Vec3(jnp.zeros_like(cos_o), jnp.zeros_like(cos_o),
                 jnp.zeros_like(cos_o)))
        pdf_spec = jnp.where(both, mf.ggx_pdf_visible(wi_l, h, alpha, alpha)
                             / jnp.maximum(4.0 * jnp.abs(dot(wo, h)), 1e-12),
                             0.0)
        pdf = prob_spec * pdf_spec + prob_diff * jnp.where(
            both, INV_PI * cos_o, 0.0)
        return val, pdf

    wo_nee_l = Vec3(wo_nee.x, wo_nee.y, wo_nee.z * sgn)
    val_nee, pdf_nee = eval_both(wo_nee_l)

    pick_spec = s1 < prob_spec
    m, _ = mf.ggx_sample_vndf(wi_l, alpha, alpha, s2x, s2y)
    wo_spec = Vec3(2.0 * dot(wi_l, m) * m.x - wi_l.x,
                   2.0 * dot(wi_l, m) * m.y - wi_l.y,
                   2.0 * dot(wi_l, m) * m.z - wi_l.z)
    wo_diff = warp.cosine_hemisphere_c(s2x, s2y)
    wo = where3(pick_spec, wo_spec, wo_diff)
    val_s, pdf_s = eval_both(wo)
    valid = ok & (wo.z > 0.0) & (pdf_s > 1e-12)
    inv_pdf = jnp.where(valid, 1.0 / jnp.maximum(pdf_s, 1e-12), 0.0)
    weight = val_s * inv_pdf
    pdf_out = jnp.where(valid, pdf_s, 0.0)
    z = jnp.zeros_like(cos_i)
    false_ = z > 1.0
    return BSDFSampleResult(val_nee, pdf_nee,
                            Vec3(wo.x, wo.y, wo.z * sgn), weight, pdf_out,
                            jnp.ones_like(z), false_, false_)


def _roughdielectric_eval_pdf_sample(param, wi, wo_nee, s1, s2x, s2y):
    """reference roughdielectric.cpp: GGX reflection + refraction with VNDF
    sampling; weight via the G2/G1 identity."""
    eta = param(P_ETA)
    alpha = param(P_ALPHA)
    refl_c = Vec3(param(P_REFL), param(P_REFL + 1), param(P_REFL + 2))
    trans_c = Vec3(param(P_SPEC_TRANS), param(P_SPEC_TRANS + 1),
                   param(P_SPEC_TRANS + 2))

    out_side = wi.z >= 0.0
    sgn = jnp.where(out_side, 1.0, -1.0)
    wi_u = Vec3(wi.x, wi.y, wi.z * sgn)      # upper hemisphere frame

    # ---------------- sampling ----------------
    m_u, pdf_m = mf.ggx_sample_vndf(wi_u, alpha, alpha, s2x, s2y)
    cos_im = dot(wi_u, m_u)
    F, cos_t, eta_it, eta_ti = fresnel_dielectric(cos_im * sgn * sgn, eta)
    # fresnel with signed cos w.r.t. outside: use cos_im and side
    F, cos_t, eta_it, eta_ti = fresnel_dielectric(
        jnp.where(out_side, cos_im, -cos_im), eta)
    pick_reflect = s1 <= F

    # reflect about m (in upper frame)
    wo_r = Vec3(2.0 * cos_im * m_u.x - wi_u.x,
                2.0 * cos_im * m_u.y - wi_u.y,
                2.0 * cos_im * m_u.z - wi_u.z)
    # refract through m: standard formula in the m frame
    c = cos_im
    scale = eta_ti
    # refracted direction (upper frame): -eta_ti*wi + (eta_ti*c - cos_t')*m
    cos_tm = jnp.sqrt(jnp.maximum(1.0 - scale * scale * (1.0 - c * c), 0.0))
    wo_t = Vec3(-scale * wi_u.x + (scale * c - cos_tm) * m_u.x,
                -scale * wi_u.y + (scale * c - cos_tm) * m_u.y,
                -scale * wi_u.z + (scale * c - cos_tm) * m_u.z)
    wo_u = where3(pick_reflect, wo_r, wo_t)
    valid_r = pick_reflect & (wo_u.z > 0.0)
    valid_t = (~pick_reflect) & (wo_u.z < 0.0)
    valid = valid_r | valid_t

    # G2 with the UNflipped wo: smith_g1's sign rule dot(v,m)*v.z>0 holds
    # for refracted directions (dot<0, v.z<0) as in the reference
    # microfacet.h; flipping wo.z broke it for ~3% of the transmission
    # population (weight forced to 0 -> energy loss)
    g2 = mf.ggx_G(wi_u, wo_u, m_u, alpha, alpha)
    g1 = mf.ggx_smith_g1(wi_u, m_u, alpha, alpha)
    wscale = jnp.where(valid, g2 / jnp.maximum(g1, 1e-12), 0.0)
    factor = jnp.where(pick_reflect, 1.0, eta_ti * eta_ti)
    weight = where3(pick_reflect, refl_c, trans_c) * (wscale * factor)
    # transmission Jacobian: |wo.m| * eta_o^2 / (eta_i (wi.m) + eta_o (wo.m))^2
    wo_m = dot(wo_u, m_u)
    denom_t = (cos_im + eta_it * wo_m)
    jac_t = jnp.abs(wo_m) * (eta_it * eta_it) / jnp.maximum(
        denom_t * denom_t, 1e-12)
    pdf = jnp.where(pick_reflect,
                    F * pdf_m / jnp.maximum(4.0 * jnp.abs(cos_im), 1e-12),
                    (1.0 - F) * pdf_m * jac_t)
    pdf = jnp.where(valid, pdf, 0.0)

    # ---------------- NEE eval/pdf ----------------
    wo_nee_u = Vec3(wo_nee.x, wo_nee.y, wo_nee.z * sgn)
    same_hemi = wo_nee_u.z > 0.0
    from ..core.vec import normalize as _norm
    h_r = _norm(wi_u + wo_nee_u)
    # reflection contribution
    D_r = mf.ggx_D(h_r, alpha, alpha)
    G_r = mf.ggx_G(wi_u, wo_nee_u, h_r, alpha, alpha)
    F_r, _, _, _ = fresnel_dielectric(
        jnp.where(out_side, dot(wi_u, h_r), -dot(wi_u, h_r)), eta)
    refl_scalar = jnp.where(same_hemi & (wi_u.z > 0.0),
                            F_r * D_r * G_r
                            / jnp.maximum(4.0 * wi_u.z, 1e-12), 0.0)
    pdf_nee_r = jnp.where(same_hemi,
                          F_r * mf.ggx_pdf_visible(wi_u, h_r, alpha, alpha)
                          / jnp.maximum(4.0 * jnp.abs(dot(wo_nee_u, h_r)),
                                        1e-12),
                          0.0)
    # transmission lobe (reference roughdielectric.cpp eval/pdf, wo on the
    # far side): half vector m = normalize(wi + eta_rel * wo) flipped
    # upward; refraction Jacobian dwh/dwo = eta^2 |wo.m| / (wi.m +
    # eta wo.m)^2; radiance solid-angle compression 1/eta^2 cancels the
    # eta^2 of the reference's eval numerator
    h_t = _norm(Vec3(wi_u.x + eta_it * wo_nee_u.x,
                     wi_u.y + eta_it * wo_nee_u.y,
                     wi_u.z + eta_it * wo_nee_u.z))
    h_t = where3(h_t.z < 0.0, Vec3(-h_t.x, -h_t.y, -h_t.z), h_t)
    wi_m = dot(wi_u, h_t)
    wo_m = dot(wo_nee_u, h_t)
    # a transmissive configuration has wi/wo on opposite sides of the facet
    t_ok = (~same_hemi) & (wi_u.z > 0.0) & (wi_m > 0.0) & (wo_m < 0.0)
    F_t, _, _, _ = fresnel_dielectric(
        jnp.where(out_side, wi_m, -wi_m), eta)
    D_t = mf.ggx_D(h_t, alpha, alpha)
    # unflipped wo for the same reason as the sampled-weight G2 above
    G_t = mf.ggx_G(wi_u, wo_nee_u, h_t, alpha, alpha)
    denom_nee = wi_m + eta_it * wo_m
    inv_d2 = 1.0 / jnp.maximum(denom_nee * denom_nee, 1e-12)
    trans_scalar = jnp.where(
        t_ok,
        (1.0 - F_t) * D_t * G_t * jnp.abs(wi_m * wo_m) * inv_d2
        / jnp.maximum(wi_u.z, 1e-12),
        0.0)
    dwh_dwo = (eta_it * eta_it) * jnp.abs(wo_m) * inv_d2
    pdf_nee_t = jnp.where(
        t_ok,
        (1.0 - F_t) * mf.ggx_pdf_visible(wi_u, h_t, alpha, alpha) * dwh_dwo,
        0.0)
    val_nee = refl_c * refl_scalar + trans_c * trans_scalar
    pdf_nee = pdf_nee_r + pdf_nee_t

    z = jnp.zeros_like(F)
    false_ = z > 1.0
    out_eta = jnp.where(pick_reflect, jnp.ones_like(F), eta_it)
    return BSDFSampleResult(val_nee, pdf_nee,
                            Vec3(wo_u.x, wo_u.y, wo_u.z * sgn),
                            weight, pdf, out_eta, false_, false_)


_DISPATCH[BSDF_ROUGHPLASTIC] = _roughplastic_eval_pdf_sample
_DISPATCH[BSDF_ROUGHDIELECTRIC] = _roughdielectric_eval_pdf_sample


# ---------------------------------------------------------------------------
# Wrapper BSDFs: mask / blendbsdf dispatch by stochastic row remapping —
# before type dispatch, wrapped lanes remap their bsdf row to one of the
# nested rows with the appropriate probability (selection is independent of
# wo, so the estimator stays unbiased; the analog of the reference's
# nested vcall, src/bsdfs/{mask,blendbsdf}.cpp).
# ---------------------------------------------------------------------------

P_NESTED0 = 4      # wrapper rows: nested row indices + mix weight
P_NESTED1 = 5
P_MIX = 6


@register_plugin("bsdf", "mask")
class Mask(BSDF):
    """Opacity mask (reference src/bsdfs/mask.cpp): with prob. opacity act
    as the nested BSDF, else pass through (null)."""
    type_id = BSDF_MASK
    flags = FLAG_SMOOTH | FLAG_NULL | FLAG_DELTA

    def __init__(self, props: Properties):
        super().__init__(props)
        self.nested_bsdf = None
        for key, v in props.objects():
            if isinstance(v, BSDF):
                self.nested_bsdf = v
        if self.nested_bsdf is None:
            raise RuntimeError("mask: requires a nested BSDF")
        op = props.get("opacity", 0.5)
        if isinstance(op, dict):
            op = float(np.mean(op.get("value")))
        from ..textures import Texture
        if isinstance(op, Texture):
            op = float(np.mean(op.mean_rgb()))
        self.opacity = float(op)
        self.flags = self.nested_bsdf.flags | FLAG_NULL | FLAG_DELTA
        self.nested_index = -1      # filled at compile
        self.null_index = -1

    def params_row(self):
        p = np.zeros(N_BSDF_PARAMS)
        p[P_NESTED0] = float(self.nested_index)
        p[P_NESTED1] = float(self.null_index)
        p[P_MIX] = 1.0 - self.opacity    # prob of choosing row1 (null)
        return p


@register_plugin("bsdf", "blendbsdf")
class BlendBSDF(BSDF):
    """Blend of two BSDFs (reference src/bsdfs/blendbsdf.cpp)."""
    type_id = BSDF_BLEND
    flags = FLAG_SMOOTH

    def __init__(self, props: Properties):
        super().__init__(props)
        nested = [v for _, v in props.objects() if isinstance(v, BSDF)]
        if len(nested) != 2:
            raise RuntimeError("blendbsdf: requires exactly two nested BSDFs")
        self.nested = nested
        w = props.get("weight", 0.5)
        if isinstance(w, dict):
            w = float(np.mean(w.get("value")))
        from ..textures import Texture
        if isinstance(w, Texture):
            w = float(np.mean(w.mean_rgb()))
        self.weight = float(w)
        self.flags = nested[0].flags | nested[1].flags
        self.nested_indices = (-1, -1)

    def params_row(self):
        p = np.zeros(N_BSDF_PARAMS)
        p[P_NESTED0] = float(self.nested_indices[0])
        p[P_NESTED1] = float(self.nested_indices[1])
        p[P_MIX] = self.weight      # prob of choosing row1
        return p


@register_plugin("bsdf", "pplastic")
class PPlastic(RoughPlastic):
    """Polarized plastic (reference src/bsdfs/pplastic.cpp): GGX rough
    specular coat + diffuse base — the reference builds its microfacet
    distribution from ``alpha`` (pplastic.cpp:170-175), NOT a smooth delta
    coat. Lobe shapes/sampling therefore match roughplastic in every
    variant; under tpu_rgb_polarized the specular lobe currently uses the
    depolarizer fallback with exact lobe weights (the reference evaluates
    per-facet polarized Fresnel; exact Mueller here covers
    conductor/roughconductor/dielectric, integrators/polarized.py:43-50)."""


BSDF_POLARIZER = 12
BSDF_RETARDER = 13
BSDF_CIRCULAR = 14
P_POL_THETA = 4     # element rotation angle (radians) for polarizer/retarder
P_POL_DELTA = 5     # retarder phase difference (radians)


@register_plugin("bsdf", "polarizer")
class Polarizer(Null):
    """Linear polarizer (reference src/bsdfs/polarizer.cpp). In tpu_rgb
    (unpolarized) the delta transmission is attenuated by the Malus average
    0.5; under tpu_rgb_polarized the exact rotated linear-polarizer Mueller
    matrix is applied (integrators/polarized.py)."""

    type_id = BSDF_POLARIZER

    def __init__(self, props: Properties):
        super().__init__(props)
        self.theta = math.radians(props.get_float("theta", 0.0))
        t = props.get_float("transmittance", 1.0)
        self.transmittance = (t, t, t)

    def params_row(self):
        p = np.zeros(N_BSDF_PARAMS)
        p[P_REFL:P_REFL + 3] = self.transmittance
        p[P_POL_THETA] = self.theta
        return p


@register_plugin("bsdf", "retarder")
class Retarder(Null):
    """Wave retarder (reference src/bsdfs/retarder.cpp); identity on
    intensity, phase shift between fast/slow axes in polarized mode."""

    type_id = BSDF_RETARDER

    def __init__(self, props: Properties):
        super().__init__(props)
        self.theta = math.radians(props.get_float("theta", 0.0))
        self.delta = math.radians(props.get_float("delta", 90.0))

    def params_row(self):
        p = np.zeros(N_BSDF_PARAMS)
        p[P_REFL:P_REFL + 3] = 1.0
        p[P_POL_THETA] = self.theta
        p[P_POL_DELTA] = self.delta
        return p


@register_plugin("bsdf", "circular")
class CircularPolarizer(Polarizer):
    """Circular polarizer (reference src/bsdfs/circular.cpp)."""

    type_id = BSDF_CIRCULAR


BSDF_MEASURED = 15
P_MEASURED_IDX = 17   # index into SceneArrays.measured (table tuple)


@register_plugin("bsdf", "measured")
class Measured(BSDF):
    """Data-driven BRDF in the RGL tensor format (reference
    src/bsdfs/measured.cpp; Dupuy & Jakob adaptive parameterization).
    Sampling/eval run through the vectorized histogram warps of
    measured_impl.py. Works in tpu_rgb (3 representative wavelengths) and
    tpu_spectral (per-lane hero wavelengths)."""

    type_id = BSDF_MEASURED
    flags = FLAG_SMOOTH

    def __init__(self, props: Properties):
        super().__init__(props)
        from ..io.tensor_file import read_tensor_file
        from .measured_impl import build_tables
        from ..core.fresolver import resolve_filename
        fname = resolve_filename(props.get_string("filename"))
        self.tables = build_tables(read_tensor_file(fname))
        self.measured_index = -1     # assigned at scene compile

    def params_row(self):
        p = np.zeros(N_BSDF_PARAMS)
        p[P_MEASURED_IDX] = float(self.measured_index)
        return p


BSDF_MEASURED_POL = 16
P_ALPHA_SAMPLE = 16   # measured_polarized: GGX alpha for importance sampling


@register_plugin("bsdf", "measured_polarized")
class MeasuredPolarized(BSDF):
    """Measured polarized pBRDF (reference src/bsdfs/measured_polarized.cpp;
    Baek et al. 2020 KAIST dataset). Full 4x4 Mueller evaluation via 4-D
    interpolation over (phi_d, theta_d, theta_h, wavelength) with the
    reflection-plane Stokes-basis rotations (measured_polarized_impl.py);
    scalar variants use the M00 intensity. Sampling: cosine/GGX mixture
    with the user's alpha_sample."""

    type_id = BSDF_MEASURED_POL
    flags = FLAG_SMOOTH

    def __init__(self, props: Properties):
        super().__init__(props)
        from ..io.tensor_file import read_tensor_file
        from .measured_polarized_impl import build_pbsdf_tables
        from ..core.fresolver import resolve_filename
        fname = resolve_filename(props.get_string("filename"))
        self.alpha_sample = props.get_float("alpha_sample", 0.1)
        # reference: non-spectral modes may pin a single wavelength
        self.wavelength = props.get_float("wavelength", -1.0)
        self.tables = build_pbsdf_tables(read_tensor_file(fname))
        self.measured_index = -1     # assigned at scene compile

    def params_row(self):
        p = np.zeros(N_BSDF_PARAMS)
        p[P_MEASURED_IDX] = float(self.measured_index)
        p[P_ALPHA_SAMPLE] = self.alpha_sample
        return p

    def pol_wavelengths(self):
        from .measured_polarized_impl import RGB_WAVELENGTHS
        if self.wavelength > 0.0:
            return (self.wavelength,) * 3
        return RGB_WAVELENGTHS


BSDF_PRINCIPLED = 11
P_METALLIC = 7       # principled: metallic at the conductor-k slot
P_SPECTUNE = 8       # principled: spec_tint weight (slot reused)
P_PR_SHEEN = 9       # principled: sheen weight
P_PR_SHEENTINT = 11  # principled: sheen_tint
P_PR_FLAT = 12       # principled: flatness (fake subsurface blend)
P_PR_CC = 13         # principled: clearcoat weight
P_PR_AX = 5          # principled: GGX alpha_x (anisotropic-corrected)
P_PR_AY = 6          # principled: GGX alpha_y
P_PR_CCGLOSS = 18    # principled: clearcoat_gloss
P_PR_STRANS = 19     # principled: spec_trans (BRDF<->BSDF blend)
P_PR_DSRATE = 20     # principled: diffuse_reflectance_sampling_rate
P_PR_SSRATE = 21     # principled: main_specular_sampling_rate
P_PR_CSRATE = 22     # principled: clearcoat_sampling_rate
P_PR_ROUGH = 23      # principled: raw roughness (retro/fake-ss term)
BSDF_PRINCIPLED_THIN = 17


@register_plugin("bsdf", "principled")
class Principled(BSDF):
    """Principled BSDF (reference src/bsdfs/principled.cpp, Burley 2012 /
    2015): diffuse + retro-reflection + fake subsurface (flatness), sheen
    with tint, anisotropic GGX main specular with metallic/spec_tint
    Schlick blend, GTR1 clearcoat, and the rough-dielectric transmission
    lobe (spec_trans) with the eta<->specular one-to-one mapping
    (principled.cpp:224-239)."""
    type_id = BSDF_PRINCIPLED
    flags = FLAG_SMOOTH
    thin = False

    def __init__(self, props: Properties):
        super().__init__(props)
        self.base_color = _get_rgb(props, "base_color", [0.5, 0.5, 0.5])
        self.reflectance_tex = _get_texture(props, "base_color")
        self.tex_index = -1
        self.roughness = props.get_float("roughness", 0.5)
        self.metallic = props.get_float("metallic", 0.0)
        self.anisotropic = props.get_float("anisotropic", 0.0)
        self.spec_tint = props.get_float("spec_tint", 0.0)
        self.sheen = props.get_float("sheen", 0.0)
        self.sheen_tint = props.get_float("sheen_tint", 0.0)
        self.flatness = props.get_float("flatness", 0.0)
        self.clearcoat = props.get_float("clearcoat", 0.0)
        self.clearcoat_gloss = props.get_float("clearcoat_gloss", 0.0)
        self.spec_trans = props.get_float("spec_trans", 0.0)
        self.diff_srate = props.get_float(
            "diffuse_reflectance_sampling_rate", 1.0)
        self.spec_srate = props.get_float(
            "main_specular_sampling_rate", 1.0)
        self.cc_srate = props.get_float("clearcoat_sampling_rate", 1.0)
        # eta and specular are one-to-one (principled.cpp:222-239)
        if props.has_property("eta") and props.has_property("specular"):
            raise ValueError(
                "principled: specify either 'eta' or 'specular', not both")
        if props.has_property("eta"):
            eta = props.get_float("eta")
            if self.spec_trans > 0.0 and eta == 1.0:
                eta = 1.001        # eta=1 implausible for transmission
        elif self.thin:
            eta = 1.5              # thin: eta default, no specular mapping
        else:
            spec = props.get_float("specular", 0.5)
            if self.spec_trans > 0.0 and spec == 0.0:
                spec = 1e-3
            eta = 2.0 / (1.0 - np.sqrt(0.08 * spec)) - 1.0
        self.eta = float(eta)

    def params_row(self):
        r2 = self.roughness * self.roughness
        if self.anisotropic > 0.0:
            aspect = float(np.sqrt(1.0 - 0.9 * self.anisotropic))
            ax, ay = max(1e-3, r2 / aspect), max(1e-3, r2 * aspect)
        else:
            ax = ay = max(1e-3, r2)
        p = np.zeros(N_BSDF_PARAMS)
        p[P_REFL:P_REFL + 3] = self.base_color
        p[P_TWOSIDED] = 1.0 if self.two_sided else 0.0
        p[P_ETA] = self.eta
        p[P_PR_AX] = ax
        p[P_PR_AY] = ay
        p[P_METALLIC] = self.metallic
        p[P_SPECTUNE] = self.spec_tint
        p[P_PR_SHEEN] = self.sheen
        p[P_ALPHA] = max(r2, 1e-3)
        p[P_PR_SHEENTINT] = self.sheen_tint
        p[P_PR_FLAT] = self.flatness
        p[P_PR_CC] = self.clearcoat
        p[P_PR_CCGLOSS] = self.clearcoat_gloss
        p[P_PR_STRANS] = self.spec_trans
        p[P_PR_DSRATE] = self.diff_srate
        p[P_PR_SSRATE] = self.spec_srate
        p[P_PR_CSRATE] = self.cc_srate
        p[P_PR_ROUGH] = self.roughness
        p[P_REFL_TEX] = float(self.tex_index)
        return p


@register_plugin("bsdf", "principledthin")
class PrincipledThin(Principled):
    """reference src/bsdfs/principledthin.cpp — thin-sheet variant: lobes
    are GGX specular reflect, specular "transmission" (reflect-and-flip
    with Burley-2015 scaled roughness, :360-380), diffuse reflect
    (+retro/fake-ss/sheen) and diffuse transmit (diff_trans in [0,2]).
    No metallic/clearcoat; thin_fresnel blend; intrinsically two-sided."""
    type_id = BSDF_PRINCIPLED_THIN
    thin = True

    def __init__(self, props: Properties):
        self.diff_trans = props.get_float("diff_trans", 0.0)
        self.dt_srate = props.get_float(
            "diffuse_transmittance_sampling_rate", 1.0)
        self.sr_srate = props.get_float(
            "specular_reflectance_sampling_rate", 1.0)
        self.st_srate = props.get_float(
            "specular_transmittance_sampling_rate", 1.0)
        super().__init__(props)

    def params_row(self):
        p = super().params_row()
        # thin slot reuse: clearcoat slot = diff_trans, gloss = its srate,
        # csrate slot = spec_trans srate, ssrate slot = spec_refl srate
        p[P_PR_CC] = self.diff_trans
        p[P_PR_CCGLOSS] = self.dt_srate
        p[P_PR_SSRATE] = self.sr_srate
        p[P_PR_CSRATE] = self.st_srate
        p[P_TWOSIDED] = 0.0          # symmetric natively (impl mulsigns)
        return p


def _principled_dispatch(param, wi, wo_nee, s1, s2x, s2y,
                         tex_refl=None, tex_mask=None):
    import sys
    from .principled_impl import principled_eval_pdf_sample
    return principled_eval_pdf_sample(sys.modules[__name__], param, wi,
                                      wo_nee, s1, s2x, s2y, tex_refl,
                                      tex_mask)


def _principledthin_dispatch(param, wi, wo_nee, s1, s2x, s2y,
                             tex_refl=None, tex_mask=None):
    import sys
    from .principled_impl import principledthin_eval_pdf_sample
    return principledthin_eval_pdf_sample(sys.modules[__name__], param, wi,
                                          wo_nee, s1, s2x, s2y, tex_refl,
                                          tex_mask)


_DISPATCH[BSDF_PRINCIPLED] = _principled_dispatch
_DISPATCH[BSDF_PRINCIPLED_THIN] = _principledthin_dispatch

# types whose P_REFL triple is a reflectance color that the tpu_spectral
# variant upsamples to sigmoid-polynomial coefficients at scene compile
# (diffuse albedo, plastic diffuse reflectance, principled base color) and
# whose eval accepts the (tex_refl, tex_mask) override
SPECTRAL_UPSAMPLED_TYPES = (BSDF_DIFFUSE, BSDF_PLASTIC, BSDF_ROUGHPLASTIC,
                            BSDF_PRINCIPLED, BSDF_PRINCIPLED_THIN)


def _polarizer_like_dispatch(factor):
    """Null-style delta transmission scaled by factor x P_REFL transmittance
    (reference polarizer.cpp unpolarized branch: 0.5 * transmittance)."""

    def fn(param, wi, wo_nee, s1, s2x, s2y):
        z = jnp.zeros_like(wi.z)
        ones = jnp.ones_like(wi.z)
        true_ = ones > 0.0
        w = Vec3(param(P_REFL) * factor, param(P_REFL + 1) * factor,
                 param(P_REFL + 2) * factor)
        return BSDFSampleResult(Vec3(z, z, z), z, -wi, w, ones,
                                ones, true_, true_)
    return fn


_DISPATCH[BSDF_POLARIZER] = _polarizer_like_dispatch(0.5)
_DISPATCH[BSDF_RETARDER] = _polarizer_like_dispatch(1.0)
_DISPATCH[BSDF_CIRCULAR] = _polarizer_like_dispatch(0.5)


P_NMAP_TEX = 15   # normal-map texture id (-1 = none); applies to any row


@register_plugin("bsdf", "normalmap")
class NormalMap(BSDF):
    """Normal mapping adapter (reference src/bsdfs/normalmap.cpp): perturbs
    the shading frame by a tangent-space normal texture, then behaves as the
    nested BSDF. Compiles to the nested row + a normal-map texture id; the
    frame perturbation happens in the integrator right after the surface
    interaction."""

    def __init__(self, props: Properties):
        super().__init__(props)
        from ..textures import Texture
        self.nested = None
        self.normalmap_tex = None
        for key, v in props.objects():
            if isinstance(v, BSDF):
                self.nested = v
            elif isinstance(v, Texture):
                self.normalmap_tex = v
        if self.nested is None or self.normalmap_tex is None:
            raise RuntimeError("normalmap: requires a nested BSDF and a "
                               "normal texture")
        self.type_id = self.nested.type_id
        self.flags = self.nested.flags
        self.nmap_index = -1    # texture row, assigned at compile
        # forward texture-driven reflectance of the nested bsdf
        self.reflectance_tex = getattr(self.nested, "reflectance_tex", None)

    def params_row(self):
        row = self.nested.params_row()
        row[P_NMAP_TEX] = float(self.nmap_index)
        return row


P_BMAP_SCALE = 16   # >0: the P_NMAP_TEX texture is a HEIGHT map (bumpmap)


@register_plugin("bsdf", "bumpmap")
class BumpMap(BSDF):
    """Bump mapping adapter (reference src/bsdfs/bumpmap.cpp): the shading
    frame is perturbed by the height texture's uv gradients (evaluated by
    central differences at interaction time, integrators._apply_normal_maps)
    before the nested BSDF runs."""

    def __init__(self, props: Properties):
        super().__init__(props)
        from ..textures import Texture
        self.nested = None
        self.normalmap_tex = None    # compile assigns nmap_index through this
        for key, v in props.objects():
            if isinstance(v, BSDF):
                self.nested = v
            elif isinstance(v, Texture):
                self.normalmap_tex = v
        self.scale = props.get_float("scale", 1.0)
        if self.nested is None:
            raise RuntimeError("bumpmap: requires a nested BSDF")
        if self.normalmap_tex is None:
            raise RuntimeError("bumpmap: requires a height texture")
        self.type_id = self.nested.type_id
        self.flags = self.nested.flags
        self.nmap_index = -1
        self.reflectance_tex = getattr(self.nested, "reflectance_tex", None)

    def params_row(self):
        row = self.nested.params_row()
        row[P_NMAP_TEX] = float(self.nmap_index)
        row[P_BMAP_SCALE] = self.scale
        return row

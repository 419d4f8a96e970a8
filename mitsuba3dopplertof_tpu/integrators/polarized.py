"""Polarized light transport (the tpu_rgb_polarized variant) + the `stokes`
integrator.

The reference's polarized variants promote Spectrum to a Mueller matrix and
thread basis rotations through every BSDF interaction (reference
src/integrators/path.cpp:222,235 `to_world_mueller`, stokes.cpp:88-131).
Here: the wavefront bounce loop below mirrors the scalar
`_path_loop` draw-for-draw (identical sampler stream consumption) while
additionally carrying a 4x4 Mueller throughput in SoA form (16 Vec3 columns).

Per-bounce Mueller factors:
  * diffuse and remaining rough fallbacks — ideal depolarizer of the
    scalar weight (exact for diffuse per mueller.h:37);
  * rough conductor — exact Fresnel Mueller at the sampled micro-normal
    (roughconductor.cpp polarized branch);
  * null — scaled identity (transmission preserves the state);
  * smooth conductor / dielectric / thindielectric — exact Fresnel Mueller
    matrices with in/out Stokes-basis rotations (conductor.cpp:273-297,
    dielectric.cpp polarized branch), normalized so the (0,0) element equals
    the validated scalar weight;
  * polarizer / retarder / circular — the rotated ideal-element matrices
    with the tilted-axis correction (polarizer.cpp:polarized branch,
    Korger et al. 2013).

Emitters are unpolarized: their Stokes vector is (I, 0, 0, 0), so emission
pickup only reads the first column of the throughput matrix.
"""

from __future__ import annotations

import math

import numpy as np
import jax
import jax.numpy as jnp

from ..core.vec import Vec3, dot, cross, normalize, where3, vmax
from ..core.properties import Properties, register_plugin
from ..core import mueller as mu
from ..render.scene import SceneArrays, ray_intersect, ray_test, gather_small
from ..render.types import Ray, DirectionSample
from ..bsdfs import (eval_pdf_sample as bsdf_eval_pdf_sample, FLAG_SMOOTH,
                     BSDF_NULL, BSDF_CONDUCTOR, BSDF_ROUGHCONDUCTOR,
                     BSDF_DIELECTRIC, BSDF_THINDIELECTRIC, BSDF_POLARIZER,
                     BSDF_RETARDER, BSDF_CIRCULAR, BSDF_MEASURED_POL,
                     P_REFL, P_ETA, P_K, P_POL_THETA, P_POL_DELTA,
                     P_MEASURED_IDX)
from .. import emitters as em_mod

_POLARIZING_TYPES = (BSDF_CONDUCTOR, BSDF_ROUGHCONDUCTOR, BSDF_DIELECTRIC,
                     BSDF_THINDIELECTRIC, BSDF_POLARIZER, BSDF_RETARDER,
                     BSDF_CIRCULAR, BSDF_MEASURED_POL)


def _mis_weight(pdf_a, pdf_b):
    a2 = pdf_a * pdf_a
    w = a2 / jnp.maximum(a2 + pdf_b * pdf_b, 1e-30)
    return jnp.where(pdf_a > 0.0, w, 0.0)


def _safe_axis(v: Vec3, fallback: Vec3) -> Vec3:
    l2 = dot(v, v)
    ok = l2 > 1e-12
    inv = jax.lax.rsqrt(jnp.where(ok, l2, 1.0))
    return where3(ok, v * inv, fallback)


def _to_world_mueller(si, M, in_fwd_l: Vec3, out_fwd_l: Vec3):
    """interaction.h:387-409 — re-express a local-frame Mueller matrix in
    the world-frame implicit Stokes bases."""
    in_fw_w = si.to_world(in_fwd_l)
    out_fw_w = si.to_world(out_fwd_l)
    in_b_cur = si.to_world(mu.stokes_basis(in_fwd_l))
    in_b_tgt = mu.stokes_basis(in_fw_w)
    out_b_cur = si.to_world(mu.stokes_basis(out_fwd_l))
    out_b_tgt = mu.stokes_basis(out_fw_w)
    return mu.rotate_mueller_basis(M, in_fw_w, in_b_cur, in_b_tgt,
                                   out_fw_w, out_b_cur, out_b_tgt)


def _renormalize(M, scalar_weight: Vec3):
    """Scale M so its (0,0) element equals the scalar bounce weight.

    Basis rotations keep M[0][0] invariant, so for conductors this
    reproduces `M * absorber(reflectance)` exactly (conductor.cpp:296) and
    for dielectrics it folds the pdf division and the eta^2 radiance factor
    of the validated scalar path in automatically."""
    m00 = M[0]
    safe = Vec3(jnp.where(jnp.abs(m00.x) > 1e-12, m00.x, 1.0),
                jnp.where(jnp.abs(m00.y) > 1e-12, m00.y, 1.0),
                jnp.where(jnp.abs(m00.z) > 1e-12, m00.z, 1.0))
    scale = Vec3(scalar_weight.x / safe.x, scalar_weight.y / safe.y,
                 scalar_weight.z / safe.z)
    ok = (jnp.abs(m00.x) > 1e-12)
    scale = where3(ok, scale, Vec3(jnp.zeros_like(scale.x),
                                   jnp.zeros_like(scale.x),
                                   jnp.zeros_like(scale.x)))
    return mu.mm_scale(M, scale)


def _specular_bounce_mueller(si, bs, eta_re: Vec3, eta_im: Vec3,
                             rough: bool = False):
    """Fresnel Mueller of the sampled specular event in LOCAL frame with
    the plane-of-incidence basis rotations (conductor.cpp:273-295 /
    dielectric.cpp polarized branch; roughconductor.cpp uses the sampled
    micro-normal as the reflection plane), before world-frame conversion.
    Radiance transport: light arrives along -wo_hat, leaves along wi_hat."""
    wo_hat = bs.wo
    wi_hat = si.wi
    z = jnp.zeros_like(wo_hat.z)
    if rough:
        # micro-normal m = half vector; Fresnel at cos(wo_hat, m)
        n = normalize(wo_hat + wi_hat)
        cos_o = wo_hat.x * n.x + wo_hat.y * n.y + wo_hat.z * n.z
        selected_t = jnp.zeros_like(cos_o, bool)
    else:
        n = Vec3(z, z, jnp.ones_like(z))
        cos_o = wo_hat.z
        selected_t = (wo_hat.z * wi_hat.z) < 0.0   # refraction branch

    # reflection matrix at |eta| (complex for conductors)
    R = mu.specular_reflection_mueller(
        cos_o, (eta_re.x, eta_re.y, eta_re.z), (eta_im.x, eta_im.y, eta_im.z))
    # transmission (real eta only; rgb-uniform eta for dielectrics)
    T = mu.specular_transmission_mueller(cos_o, eta_re.x)
    T = tuple(mu._v(getattr(e, "x", e)) if not isinstance(e, Vec3) else e
              for e in T)
    M = mu.mm_where(selected_t, T, R)

    fb_in = mu.stokes_basis(-wo_hat)
    fb_out = mu.stokes_basis(wi_hat)
    s_axis_in = _safe_axis(cross(n, -wo_hat), fb_in)
    s_axis_out = _safe_axis(cross(n, wi_hat), fb_out)
    return mu.rotate_mueller_basis(M, -wo_hat, s_axis_in, fb_in,
                                   wi_hat, s_axis_out, fb_out)



def _measured_pol_mueller(sa, lane_bsdf, si, wo_local: Vec3):
    """4x4 Mueller of measured pBRDF lanes at (si.wi, wo_local), local
    implicit Stokes bases (measured_polarized_impl.pbsdf_eval_mueller),
    dispatched over the scene's pbsdf tables."""
    from ..bsdfs.measured_polarized_impl import pbsdf_eval_mueller
    from ..render.scene import gather_small
    m_idx = gather_small(sa.bsdf_params[P_MEASURED_IDX],
                         lane_bsdf).astype(jnp.int32)
    M = None
    for k, (tbl, wls) in enumerate(zip(sa.measured_pol,
                                       sa.measured_pol_wls)):
        Mk = pbsdf_eval_mueller(tbl, si.wi, wo_local, wavelengths=wls)
        M = Mk if M is None else mu.mm_where(m_idx == k, Mk, M)
    if M is None:
        z = jnp.zeros_like(wo_local.z)
        M = mu.mm_identity(z)
    return M


def _element_bounce_mueller(si, theta, delta, kind: int):
    """Rotated ideal polarizer/retarder/circular Mueller in LOCAL frame
    (polarizer.cpp polarized branch; tilted-polarizer effective axes of
    Korger et al. 2013). Transmission element: forward = si.wi."""
    forward = si.wi
    st, ct = jnp.sin(theta), jnp.cos(theta)
    z = jnp.zeros_like(theta)
    a_axis = Vec3(st, ct, z)
    eff_a = _safe_axis(a_axis - forward * dot(a_axis, forward),
                       mu.stokes_basis(forward))
    eff_t = cross(forward, eff_a)
    if kind == BSDF_POLARIZER:
        M = mu.linear_polarizer(1.0, like=theta)
    elif kind == BSDF_RETARDER:
        M = mu.linear_retarder(delta)
    else:
        M = mu.right_circular_polarizer(theta)
    return mu.rotate_mueller_basis_collinear(M, forward, eff_t,
                                             mu.stokes_basis(forward))


def rayleigh_scatter_mueller(d_in: Vec3, d_out: Vec3):
    """Rayleigh scattering Mueller matrix (reference rayleigh.cpp
    polarized phase; Chandrasekhar): built in the scattering-plane frame
    (x-axes perpendicular to the plane on both sides), rotated to the
    world implicit Stokes bases, normalized so M[0][0] == 1 (the
    direction weight — exact inverse-CDF sampling cancels the scalar
    phase). 90-degree scattering of unpolarized light is fully linearly
    polarized perpendicular to the scattering plane."""
    c = dot(d_in, d_out)
    npl = cross(d_in, d_out)
    fb_in = mu.stokes_basis(d_in)
    fb_out = mu.stokes_basis(d_out)
    e_in = _safe_axis(npl, fb_in)
    e_out = _safe_axis(npl, fb_out)
    a = 1.0 + c * c
    inv_a = 1.0 / jnp.maximum(a, 1e-12)
    b = (1.0 - c * c) * inv_a
    d2 = 2.0 * c * inv_a
    z = jnp.zeros_like(c)
    one = jnp.ones_like(c)

    def v(x):
        return Vec3(x, x, x)
    M = (v(one), v(b),  v(z),  v(z),
         v(b),  v(one), v(z),  v(z),
         v(z),  v(z),  v(d2), v(z),
         v(z),  v(z),  v(z),  v(d2))
    return mu.rotate_mueller_basis(M, d_in, e_in, fb_in,
                                   d_out, e_out, fb_out)


def conductor_eta_k(sa, lane_bsdf, wavelengths=None):
    """Per-lane conductor eta/k triplets: the rgb table columns, or — for
    named-material conductors under the spectral variants — the tabulated
    eta(lambda)/k(lambda) interpolated at the lane's hero wavelengths
    (the Mueller-side mirror of bsdfs.eval_pdf_sample's param_spec)."""
    e_re = Vec3(gather_small(sa.bsdf_params[P_ETA], lane_bsdf),
                gather_small(sa.bsdf_params[P_ETA + 1], lane_bsdf),
                gather_small(sa.bsdf_params[P_ETA + 2], lane_bsdf))
    e_im = Vec3(gather_small(sa.bsdf_params[P_K], lane_bsdf),
                gather_small(sa.bsdf_params[P_K + 1], lane_bsdf),
                gather_small(sa.bsdf_params[P_K + 2], lane_bsdf))
    if wavelengths is not None and getattr(sa, "ior_spectra", None):
        ior_host = jnp.asarray(np.asarray(sa.bsdf_ior_host, np.int32))
        lane_ior = gather_small(ior_host, lane_bsdf)
        lam3 = (wavelengths.x, wavelengths.y, wavelengths.z)

        def interp(tab_idx, base):
            outs = []
            for c, lam in enumerate(lam3):
                out = getattr(base, "xyz"[c])
                for e_i, (wls_t, eta_t, k_t) in enumerate(sa.ior_spectra):
                    tab = (eta_t, k_t)[tab_idx]
                    v = jnp.interp(lam, jnp.asarray(wls_t, jnp.float32),
                                   jnp.asarray(tab, jnp.float32))
                    out = jnp.where(lane_ior == e_i, v, out)
                outs.append(out)
            return Vec3(*outs)
        e_re = interp(0, e_re)
        e_im = interp(1, e_im)
    return e_re, e_im


def camera_nee_stokes_add(sa, si, bs, wo_nee, lane_bsdf, lane_type, T_mm,
                          v_nee, wavelengths=None):
    """Stokes contribution of an NEE connection in camera order: exact
    Mueller for rough-conductor and measured-pBRDF lanes (their polarized
    eval exists for arbitrary direction pairs), ideal-depolarizing
    otherwise — diffuse connections depolarize exactly; delta lobes have
    v_nee = 0 (shared by _path_loop_polarized and the polarized volpath)."""
    S_add = tuple(Vec3(T_mm[4 * i].x * v_nee.x,
                       T_mm[4 * i].y * v_nee.y,
                       T_mm[4 * i].z * v_nee.z)
                  for i in range(4))
    if BSDF_ROUGHCONDUCTOR in sa.bsdf_types_present:
        e_re, e_im = conductor_eta_k(sa, lane_bsdf, wavelengths)
        bs_nee = bs._replace(wo=wo_nee)
        M_nee = _specular_bounce_mueller(si, bs_nee, e_re, e_im, rough=True)
        M_nee = _to_world_mueller(si, M_nee, -wo_nee, si.wi)
        M_nee = _renormalize(M_nee, v_nee)
        TM = mu.mm_mul(T_mm, M_nee)
        is_rc = lane_type == BSDF_ROUGHCONDUCTOR
        S_add = tuple(where3(is_rc,
                             Vec3(TM[4 * i].x, TM[4 * i].y, TM[4 * i].z),
                             S_add[i])
                      for i in range(4))
    if BSDF_MEASURED_POL in sa.bsdf_types_present:
        M_nee = _measured_pol_mueller(sa, lane_bsdf, si, wo_nee)
        M_nee = _to_world_mueller(si, M_nee, -wo_nee, si.wi)
        M_nee = _renormalize(M_nee, v_nee)
        TM = mu.mm_mul(T_mm, M_nee)
        is_mp = lane_type == BSDF_MEASURED_POL
        S_add = tuple(where3(is_mp,
                             Vec3(TM[4 * i].x, TM[4 * i].y, TM[4 * i].z),
                             S_add[i])
                      for i in range(4))
    return S_add


def camera_bounce_mueller(sa, si, bs, lane_bsdf, lane_type, wgt,
                          polarizing_present, wavelengths=None):
    """Mueller factor of a sampled bounce in CAMERA order — radiance
    arrives along -bs.wo and leaves along si.wi — world-frame implicit
    bases, renormalized so M[0][0] equals the scalar weight ``wgt``
    (shared by _path_loop_polarized and the polarized volpath)."""
    z = jnp.zeros_like(wgt.x)
    zero3 = Vec3(z, z, z)
    M = mu.depolarizer(wgt)
    null_like = lane_type == BSDF_NULL
    M = mu.mm_where(null_like, mu.mm_scale(mu.mm_identity(z), wgt), M)
    for tid in polarizing_present:
        if tid in (BSDF_CONDUCTOR, BSDF_ROUGHCONDUCTOR, BSDF_DIELECTRIC,
                   BSDF_THINDIELECTRIC):
            if tid in (BSDF_CONDUCTOR, BSDF_ROUGHCONDUCTOR):
                e_re, e_im = conductor_eta_k(sa, lane_bsdf, wavelengths)
            else:
                er = gather_small(sa.bsdf_params[P_ETA], lane_bsdf)
                e_re = Vec3(er, er, er)
                e_im = zero3
            M_t = _specular_bounce_mueller(
                si, bs, e_re, e_im, rough=(tid == BSDF_ROUGHCONDUCTOR))
            M_t = _to_world_mueller(si, M_t, -bs.wo, si.wi)
            M_t = _renormalize(M_t, wgt)
        elif tid == BSDF_MEASURED_POL:
            M_t = _measured_pol_mueller(sa, lane_bsdf, si, bs.wo)
            M_t = _to_world_mueller(si, M_t, -bs.wo, si.wi)
            M_t = _renormalize(M_t, wgt)
        else:
            theta = gather_small(sa.bsdf_params[P_POL_THETA], lane_bsdf)
            delta = gather_small(sa.bsdf_params[P_POL_DELTA], lane_bsdf)
            M_t = _element_bounce_mueller(si, theta, delta, int(tid))
            M_t = _to_world_mueller(si, M_t, si.wi, si.wi)
            M_t = _renormalize(M_t, wgt)
        M = mu.mm_where(lane_type == tid, M_t, M)
    return M


def light_bounce_mueller(sa, si, bs, lane_bsdf, lane_type, wgt,
                         polarizing_present, out_local=None,
                         wavelengths=None):
    """Mueller factor of an interaction in PHOTON order — light arrives
    along -si.wi and leaves along ``out_local`` (default: the sampled
    bs.wo) — world-frame implicit bases, renormalized so M[0][0] equals
    the scalar weight ``wgt``. The adjoint mirror of the camera-path
    factors above: the same physical matrices with the in/out roles
    swapped (used by the polarized light tracer, ptracer.py). measured
    pBRDF tables are evaluated at the swapped direction pair (their
    non-reciprocal adjoint correction is not modeled)."""
    wo = bs.wo if out_local is None else out_local
    z = jnp.zeros_like(wo.z)
    M = mu.depolarizer(wgt)
    null_like = lane_type == BSDF_NULL
    M = mu.mm_where(null_like, mu.mm_scale(mu.mm_identity(z), wgt), M)
    neg_wi = Vec3(-si.wi.x, -si.wi.y, -si.wi.z)
    for tid in polarizing_present:
        if tid in (BSDF_CONDUCTOR, BSDF_ROUGHCONDUCTOR, BSDF_DIELECTRIC,
                   BSDF_THINDIELECTRIC):
            if tid in (BSDF_CONDUCTOR, BSDF_ROUGHCONDUCTOR):
                e_re, e_im = conductor_eta_k(sa, lane_bsdf, wavelengths)
            else:
                er = gather_small(sa.bsdf_params[P_ETA], lane_bsdf)
                e_re = Vec3(er, er, er)
                e_im = Vec3(z, z, z)
            M_t = _specular_bounce_mueller(
                si._replace(wi=wo), bs._replace(wo=si.wi), e_re, e_im,
                rough=(tid == BSDF_ROUGHCONDUCTOR))
            M_t = _to_world_mueller(si, M_t, neg_wi, wo)
        elif tid == BSDF_MEASURED_POL:
            M_t = _measured_pol_mueller(sa, lane_bsdf, si._replace(wi=wo),
                                        si.wi)
            M_t = _to_world_mueller(si, M_t, neg_wi, wo)
        else:
            theta = gather_small(sa.bsdf_params[P_POL_THETA], lane_bsdf)
            delta = gather_small(sa.bsdf_params[P_POL_DELTA], lane_bsdf)
            M_t = _element_bounce_mueller(si._replace(wi=neg_wi), theta,
                                          delta, int(tid))
            M_t = _to_world_mueller(si, M_t, neg_wi, neg_wi)
        M_t = _renormalize(M_t, wgt)
        M = mu.mm_where(lane_type == tid, M_t, M)
    return M


def _path_loop_polarized(integrator, sa: SceneArrays, sampler, state,
                         ray: Ray, active, modulation_weight=None,
                         use_correlate=False, wavelengths=None):
    """Mueller-throughput mirror of `_path_loop` (same sampler draws).

    Returns (stokes: 4-tuple of Vec3 aligned with stokes_basis(-ray.d),
    valid, state)."""
    n = ray.o.x.shape[0]
    f32 = jnp.float32
    z = jnp.zeros((n,), f32)
    zero3 = Vec3(z, z, z)

    throughput = Vec3.ones((n,))
    T_mm = mu.mm_identity(z)                 # Mueller throughput
    S_res = (zero3, zero3, zero3, zero3)     # accumulated Stokes
    path_length = jnp.zeros((n,), f32)
    eta = jnp.ones((n,), f32)
    depth = jnp.zeros((n,), jnp.uint32)
    has_env = sa.has_environment and not integrator.hide_emitters
    valid_ray = jnp.full((n,), bool(has_env))
    env_r, env_g, env_b = sa.env_radiance

    prev_p = ray.o
    prev_bsdf_pdf = jnp.ones((n,), f32)
    prev_bsdf_delta = jnp.ones((n,), bool)
    active = jnp.asarray(active)

    bsdf_flags = jnp.asarray(np.asarray(sa.bsdf_flags_host, np.int32))
    pcd = jnp.uint32(integrator.path_correlation_depth)

    def weight_fn(t, pl):
        if modulation_weight is None:
            return 1.0
        return modulation_weight(t, pl)

    def draw_1d(state, active, correlate):
        if use_correlate:
            return sampler.next_1d_correlate(state, active, correlate)
        return sampler.next_1d(state, active)

    def draw_2d(state, active, correlate):
        if use_correlate:
            return sampler.next_2d_correlate(state, active, correlate)
        return sampler.next_2d(state, active)

    any_emission = (sa.n_emitters > 0) or has_env
    polarizing_present = [t for t in sa.bsdf_types_present
                          if t in _POLARIZING_TYPES]

    def add_emission(S_res, T_mm, v: Vec3):
        # emitters are unpolarized: S_emit = (v,0,0,0); contribution only
        # reads the first column of the Mueller throughput
        return tuple(S_res[i] + Vec3(T_mm[4 * i].x * v.x,
                                     T_mm[4 * i].y * v.y,
                                     T_mm[4 * i].z * v.z)
                     for i in range(4))

    def bounce(_, carry):
        (state, ray, throughput, T_flat, S_res, path_length, eta, depth,
         valid_ray, prev_p, prev_bsdf_pdf, prev_bsdf_delta, active) = carry
        T_mm = tuple(T_flat)
        correlate = (depth + 1) < pcd

        si = ray_intersect(sa, ray, active)
        path_length = path_length + jnp.where(si.valid, si.t * eta, 0.0)

        lane_emitter = jnp.where(
            si.valid, gather_small(sa.inst_emitter,
                                   jnp.maximum(si.inst, 0)), -1)
        if any_emission:
            if sa.n_emitters > 0:
                em_val = em_mod.eval_emitter_hit(sa, si.sh_n, -ray.d,
                                                 lane_emitter,
                                                 wavelengths=wavelengths,
                                                 uv_u=si.uv_u,
                                                 uv_v=si.uv_v)
            else:
                em_val = Vec3.zeros((n,))
            if has_env:
                miss_env = (~si.valid) & active
                if sa.env_kind == "envmap":
                    env_val = em_mod.envmap_eval(
                        sa, ray.d, wavelengths=wavelengths)
                else:
                    env_val = Vec3.full((n,), env_r, env_g, env_b)
                em_val = where3(miss_env, env_val, em_val)
                emit_mask = active & ((lane_emitter >= 0) | miss_env)
            else:
                emit_mask = active & (lane_emitter >= 0)

            d_seg = si.p - prev_p
            dist = jnp.sqrt(jnp.maximum(dot(d_seg, d_seg), 1e-20))
            ds_hit = DirectionSample(
                p=si.p, n=si.sh_n, d=d_seg * (1.0 / dist), dist=dist,
                pdf=jnp.zeros((n,), f32), delta=jnp.zeros((n,), bool),
                emitter=lane_emitter)
            if sa.n_emitters > 0:
                em_pdf = jnp.where(prev_bsdf_delta, 0.0,
                                   em_mod.pdf_direction(sa, ds_hit, prim=si.prim, time=ray.time))
            else:
                em_pdf = jnp.zeros((n,), f32)
            if has_env:
                if sa.env_kind == "envmap":
                    env_pdf = em_mod.envmap_pdf_direction(sa, ray.d)
                else:
                    env_pdf = jnp.full((n,), 1.0 / (4.0 * np.pi), f32)
                env_pdf = env_pdf * (1.0 / max(sa.n_emitters, 1))
                em_pdf = jnp.where(miss_env & ~prev_bsdf_delta, env_pdf,
                                   em_pdf)
            mis_bsdf = _mis_weight(prev_bsdf_pdf, em_pdf)
            lw = weight_fn(ray.time, path_length)
            scale = jnp.where(emit_mask, mis_bsdf * lw, 0.0)
            S_res = add_emission(S_res, T_mm, em_val * scale)

        active_next = ((depth + 1) < jnp.uint32(
            min(integrator.max_depth, 2 ** 31 - 1))) & si.valid & active

        lane_bsdf = gather_small(sa.inst_bsdf, jnp.maximum(si.inst, 0))
        lane_type = gather_small(sa.bsdf_type, lane_bsdf)
        smooth = (gather_small(bsdf_flags, lane_bsdf) & FLAG_SMOOTH) != 0

        active_em = active_next & smooth
        nee, state = draw_2d(state, active, correlate)
        if sa.n_emitters > 0:
            ds, em_weight = em_mod.sample_direction(
                sa, si.p, ray.time, nee[0], nee[1],
                wavelengths=wavelengths)
            active_em = active_em & (ds.pdf != 0.0)
            shadow_ray = si.spawn_ray_to(ds.p)
            occluded = ray_test(sa, shadow_ray, active_em)
            nee_ok = active_em & ~occluded
            wo_nee = si.to_local(ds.d)
        else:
            ds = DirectionSample(zero3, zero3, zero3, z, z, z > 1.0,
                                 jnp.full((n,), -1, jnp.int32))
            em_weight = zero3
            wo_nee = zero3
            nee_ok = active_em & False

        s1, state = draw_1d(state, active, correlate)
        s2, state = draw_2d(state, active, correlate)

        if sa.n_textures > 0:
            from ..bsdfs import P_REFL_TEX
            from ..textures import eval_texture
            lane_tex = gather_small(
                sa.bsdf_params[P_REFL_TEX], lane_bsdf).astype(jnp.int32)
            tex_mask = lane_tex >= 0
            tex_refl = eval_texture(sa, lane_tex, si.uv_u, si.uv_v, p=si.p, b_u=si.b_u, b_v=si.b_v, prim=si.prim, wavelengths=wavelengths)
        else:
            tex_mask = tex_refl = None
        bs = bsdf_eval_pdf_sample(sa, lane_bsdf, si.wi, wo_nee,
                                  s1, s2[0], s2[1], tex_refl, tex_mask,
                                  wavelengths=wavelengths)

        # NEE: diffuse connections depolarize (exact); rough-conductor
        # connections apply the Fresnel Mueller at the NEE half-vector
        # (roughconductor.cpp polarized eval); delta lobes have val_nee = 0
        if sa.n_emitters > 0:
            mis_em = jnp.where(ds.delta, 1.0, _mis_weight(ds.pdf, bs.pdf_nee))
            lw = weight_fn(ray.time, path_length + ds.dist)
            scale = jnp.where(nee_ok, mis_em * lw, 0.0)
            v_nee = bs.val_nee * em_weight * scale
            S_add = camera_nee_stokes_add(sa, si, bs, wo_nee, lane_bsdf,
                                          lane_type, T_mm, v_nee,
                                          wavelengths=wavelengths)
            S_res = tuple(S_res[i] + S_add[i] for i in range(4))

        # ---------------- Mueller bounce factor --------------------------
        wgt = where3(active_next, bs.weight, Vec3.ones((n,)))
        M_bounce = camera_bounce_mueller(sa, si, bs, lane_bsdf, lane_type,
                                         wgt, polarizing_present,
                                         wavelengths=wavelengths)

        T_new = mu.mm_mul(T_mm, M_bounce)
        T_mm = mu.mm_where(active_next, T_new, T_mm)

        wo_world = si.to_world(bs.wo)
        new_ray = si.spawn_ray(wo_world)

        throughput = where3(active_next, throughput * bs.weight, throughput)
        eta = eta * jnp.where(active_next, bs.eta, 1.0)
        valid_ray = valid_ray | (active & si.valid & ~bs.sampled_null)

        prev_p = where3(si.valid, si.p, prev_p)
        prev_bsdf_pdf = jnp.where(active_next, bs.pdf, prev_bsdf_pdf)
        prev_bsdf_delta = jnp.where(active_next, bs.sampled_delta,
                                    prev_bsdf_delta)

        depth = depth + jnp.where(si.valid & active, 1, 0).astype(jnp.uint32)

        throughput_max = vmax(throughput)
        rr_prob = jnp.minimum(throughput_max * eta * eta, 0.95)
        rr_active = depth >= jnp.uint32(integrator.rr_depth)
        rr_draw, state = draw_1d(state, active, correlate)
        rr_continue = rr_draw < rr_prob
        rr_scale = jnp.where(rr_active, 1.0 / jnp.maximum(rr_prob, 1e-8), 1.0)
        throughput = throughput * rr_scale
        T_mm = mu.mm_scale(T_mm, rr_scale)

        active = (active_next & (~rr_active | rr_continue)
                  & (throughput_max != 0.0))

        ray = Ray(where3(active_next, new_ray.o, ray.o),
                  where3(active_next, wo_world, ray.d),
                  ray.time, new_ray.maxt)
        return (state, ray, throughput, tuple(T_mm), S_res, path_length,
                eta, depth, valid_ray, prev_p, prev_bsdf_pdf,
                prev_bsdf_delta, active)

    carry = (state, ray, throughput, tuple(T_mm), S_res, path_length, eta,
             depth, valid_ray, prev_p, prev_bsdf_pdf, prev_bsdf_delta,
             active)
    from . import bounce_loop
    carry = bounce_loop(bounce, carry, integrator.loop_iterations)
    (state, ray, throughput, T_flat, S_res, path_length, eta, depth,
     valid_ray, prev_p, prev_bsdf_pdf, prev_bsdf_delta, active) = carry

    S_out = tuple(where3(valid_ray, s, zero3) for s in S_res)
    return S_out, valid_ray, state


from . import Integrator as _Integrator


@register_plugin("integrator", "stokes")
class StokesIntegrator(_Integrator):
    """Stokes-vector integrator (reference src/integrators/stokes.cpp):
    wraps a sampling integrator; S0 lands in the rgb image and the full
    Stokes vector (S0..S3 x RGB) in 12 AOV channels after one final
    rotation aligning the Stokes frame with the sensor's horizontal axis
    (stokes.cpp:99-109)."""

    spectral_mode = "hero"       # tpu_spectral_polarized: hero triplets
    is_doppler = False

    def __init__(self, props: Properties):
        super().__init__(props)
        nested = [o for _, o in props.objects()
                  if hasattr(o, "sample_stokes")]
        if len(nested) != 1:
            from . import Integrator as _I
            others = [type(o).__name__ for _, o in props.objects()
                      if isinstance(o, _I)]
            if others:
                raise RuntimeError(
                    f"stokes: nested integrator {others[0]} does not "
                    "support Stokes output (implemented for path / "
                    "dopplertofpath / volpath)")
            raise RuntimeError("stokes: specify exactly one nested "
                               "path-style integrator")
        self.nested = nested[0]
        self.is_doppler = self.nested.is_doppler
        # forwarded orchestration knobs
        for k in ("time_sampling_method", "antithetic_shift",
                  "use_stratified_sampling_for_each_interval",
                  "path_correlation_depth", "samples_per_pass"):
            setattr(self, k, getattr(self.nested, k))
        self._sensor_up = (0.0, 1.0, 0.0)

    def aov_names(self):
        return [f"S{i}.{c}" for i in range(4) for c in "RGB"]

    def set_sensor(self, sensor):
        m = (np.asarray(sensor.to_world, np.float64)
             if hasattr(sensor, "to_world") else np.eye(4))
        up = m[:3, :3] @ np.array([0.0, 1.0, 0.0])
        self._sensor_up = tuple(float(x) for x in up)

    def sample(self, sa, sampler, state, ray, active, wavelengths=None):
        import mitsuba3dopplertof_tpu as mi
        if not getattr(sa, "polarized", False):
            raise RuntimeError("stokes: only available under the polarized "
                               "variants (mi.set_variant("
                               "'tpu_rgb_polarized' or "
                               "'tpu_spectral_polarized'))")
        S, valid, state = self.nested.sample_stokes(sa, sampler, state, ray,
                                                    active,
                                                    wavelengths=wavelengths)
        # rotate into the sensor basis (stokes.cpp:99-109)
        ux, uy, uz = self._sensor_up
        n = ray.d.x.shape[0]
        up = Vec3(jnp.full((n,), ux, jnp.float32),
                  jnp.full((n,), uy, jnp.float32),
                  jnp.full((n,), uz, jnp.float32))
        fwd = -ray.d
        cur = mu.stokes_basis(fwd)
        tgt = _safe_axis(cross(ray.d, up), cur)
        R = mu.rotate_stokes_basis(fwd, cur, tgt)
        S = mu.mm_apply_stokes(R, S)
        S_aov = S
        if wavelengths is not None:
            # tpu_spectral_polarized: each Stokes component carries hero-
            # wavelength samples; the AOVs convert to sRGB here (linear in
            # the samples), while the returned spec stays raw — the render
            # dispatch applies the same conversion to it
            from ..core.cie import hero_to_srgb
            S_aov = tuple(hero_to_srgb(s_i, wavelengths) for s_i in S)
        aovs = []
        for i in range(4):
            aovs += [S_aov[i].x, S_aov[i].y, S_aov[i].z]
        return S[0], valid, state, aovs

def _install_render_plumbing():
    """Give StokesIntegrator the SamplingIntegrator orchestration methods
    without inheriting its Properties parsing."""
    from . import SamplingIntegrator
    for name in ("render", "_get_pass_fn", "_get_multi_pass_fn"):
        setattr(StokesIntegrator, name,
                getattr(SamplingIntegrator, name))


_install_render_plumbing()

__all__ = ["StokesIntegrator", "_path_loop_polarized"]

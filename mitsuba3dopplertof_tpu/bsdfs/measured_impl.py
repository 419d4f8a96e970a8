"""Data-driven measured BRDF (reference src/bsdfs/measured.cpp, the
Dupuy & Jakob adaptive-parameterization RGL format).

The reference samples micro-normals through parameterized `Marginal2D`
warps (reference include/mitsuba/core/distr_2d.h) — marginal/conditional
CDF inversion over a unit-square density, multilinearly interpolated over
incident-direction (and wavelength) parameters. Here:
the CDF tables are precomputed on the host per parameter slice, and the
per-lane warp runs a fixed-depth *vectorized binary search* whose CDF
values are corner-blended on the fly (2^K gathers per probe), so every
lane follows the same uniform control flow — no per-lane divergence.

The warp density is piecewise constant per grid cell (a histogram over
the same nodes the reference interpolates bilinearly). Sampling, invert
and the reported pdfs are exactly self-consistent, so the estimator stays
unbiased; the difference from the reference's bilinear warp vanishes with
grid resolution. Field lookups (ndf / sigma / spectra) use bilinear node
interpolation like the reference.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import jax
import jax.numpy as jnp

from ..core.vec import Vec3


class WarpTables(NamedTuple):
    """Histogram warp over (*param_dims, ry, rx) node data."""
    cw: jnp.ndarray         # (P*T, (ry-1)*(rx-1)) cell weights
    cond_cdf: jnp.ndarray   # (P*T, ry-1, rx-1) per-row inclusive cdf
    marg_cdf: jnp.ndarray   # (P*T, ry-1) inclusive cdf of row masses
    total: jnp.ndarray      # (P*T,)
    ry: int
    rx: int


jax.tree_util.register_pytree_node(
    WarpTables,
    lambda w: ((w.cw, w.cond_cdf, w.marg_cdf, w.total), (w.ry, w.rx)),
    lambda aux, ch: WarpTables(*ch, ry=aux[0], rx=aux[1]))


class MeasuredTables(NamedTuple):
    phi_i: jnp.ndarray        # (P,)
    theta_i: jnp.ndarray      # (T,)
    wavelengths: jnp.ndarray  # (W,)
    vndf: WarpTables
    luminance: WarpTables
    ndf: jnp.ndarray          # (ry, rx) raw nodes
    sigma: jnp.ndarray        # (ry, rx)
    spectra: jnp.ndarray      # (P, T, W, rs, rs) raw nodes
    isotropic: bool
    jacobian: bool


jax.tree_util.register_pytree_node(
    MeasuredTables,
    lambda t: ((t.phi_i, t.theta_i, t.wavelengths, t.vndf, t.luminance,
                t.ndf, t.sigma, t.spectra), (t.isotropic, t.jacobian)),
    lambda aux, ch: MeasuredTables(*ch, isotropic=aux[0], jacobian=aux[1]))


def _build_warp(data: np.ndarray) -> WarpTables:
    """data: (P, T, ry, rx) node values -> histogram CDF tables."""
    P, T, ry, rx = data.shape
    cells = 0.25 * (data[..., :-1, :-1] + data[..., :-1, 1:]
                    + data[..., 1:, :-1] + data[..., 1:, 1:])
    cells = np.maximum(cells, 0.0)
    cond = np.cumsum(cells, axis=-1)                      # (P,T,ry-1,rx-1)
    row = cond[..., -1]
    marg = np.cumsum(row, axis=-1)                        # (P,T,ry-1)
    total = np.maximum(marg[..., -1], 1e-12)
    f = jnp.float32
    return WarpTables(
        cw=jnp.asarray(cells.reshape(P * T, -1), f),
        cond_cdf=jnp.asarray(cond.reshape(P * T, ry - 1, rx - 1), f),
        marg_cdf=jnp.asarray(marg.reshape(P * T, ry - 1), f),
        total=jnp.asarray(total.reshape(P * T), f),
        ry=ry, rx=rx)


def build_tables(fields) -> MeasuredTables:
    """From the raw tensor-file fields (measured.cpp:40-160)."""
    phi_i = np.asarray(fields["phi_i"], np.float64)
    theta_i = np.asarray(fields["theta_i"], np.float64)
    wav = np.asarray(fields["wavelengths"], np.float64)
    vndf = np.asarray(fields["vndf"], np.float64)
    lum = np.asarray(fields["luminance"], np.float64)
    isotropic = phi_i.shape[0] <= 2
    jac = bool(np.asarray(fields["jacobian"]).ravel()[0])
    return MeasuredTables(
        phi_i=jnp.asarray(phi_i, jnp.float32),
        theta_i=jnp.asarray(theta_i, jnp.float32),
        wavelengths=jnp.asarray(wav, jnp.float32),
        vndf=_build_warp(vndf),
        luminance=_build_warp(lum),
        ndf=jnp.asarray(fields["ndf"], jnp.float32),
        sigma=jnp.asarray(fields["sigma"], jnp.float32),
        spectra=jnp.asarray(fields["spectra"], jnp.float32),
        isotropic=isotropic, jacobian=jac)


# ---------------------------------------------------------------------------
# parameter interpolation helpers
# ---------------------------------------------------------------------------

def _param_weight(coords: jnp.ndarray, value):
    """Locate `value` in the sorted coordinate array: (index, lerp weight).
    Handles 1-entry arrays (no interpolation)."""
    n = int(coords.shape[0])
    if n == 1:
        z = jnp.zeros_like(value)
        return z.astype(jnp.int32), z
    idx = jnp.clip(jnp.searchsorted(coords, value, side="right") - 1,
                   0, n - 2).astype(jnp.int32)
    c0 = jnp.take(coords, idx)
    c1 = jnp.take(coords, idx + 1)
    w = jnp.clip((value - c0) / jnp.maximum(c1 - c0, 1e-9), 0.0, 1.0)
    return idx, w


def _corner_ids(tbl: MeasuredTables, phi_i, theta_i):
    """4 param-corner slice ids + weights for (phi_i, theta_i)."""
    P = int(tbl.phi_i.shape[0])
    T = int(tbl.theta_i.shape[0])
    pi_, pw = _param_weight(tbl.phi_i, phi_i)
    ti_, tw = _param_weight(tbl.theta_i, theta_i)
    ids, wts = [], []
    for dp in (0, 1):
        for dt in (0, 1):
            p = jnp.minimum(pi_ + dp, P - 1)
            t = jnp.minimum(ti_ + dt, T - 1)
            ids.append(p * T + t)
            wts.append((pw if dp else (1.0 - pw)) * (tw if dt else (1.0 - tw)))
    return ids, wts


def _blend(arrs_flat, ids, wts, inner, j):
    """Corner-blended gather: sum_k w_k * A[ids_k * inner + j]."""
    acc = 0.0
    for i, w in zip(ids, wts):
        acc = acc + w * jnp.take(arrs_flat, i * inner + j, mode="clip")
    return acc


# ---------------------------------------------------------------------------
# histogram warp: sample / invert (vectorized binary search)
# ---------------------------------------------------------------------------

def _bsearch(cdf_at, n, target):
    """Smallest j in [0, n) with cdf_at(j) >= target (cdf inclusive)."""
    lo = jnp.zeros_like(target, jnp.int32)
    hi = jnp.full_like(lo, n - 1)
    for _ in range(max(1, math.ceil(math.log2(max(n, 2))))):
        mid = (lo + hi) // 2
        c = cdf_at(mid)
        go_hi = c < target
        lo = jnp.where(go_hi, jnp.minimum(mid + 1, n - 1), lo)
        hi = jnp.where(go_hi, hi, mid)
    return hi


def warp_sample(w: WarpTables, ids, wts, ux, uy):
    """(ux, uy) uniform -> (x, y) distributed per the table density;
    returns (x, y, density) with density w.r.t. the unit square."""
    ny, nx = w.ry - 1, w.rx - 1
    total = sum(wt * jnp.take(w.total, i) for i, wt in zip(ids, wts))
    ty = uy * total

    def marg_at(j):
        return _blend(w.marg_cdf.reshape(-1), ids, wts, ny, j)

    j = _bsearch(marg_at, ny, ty)
    cdf_jm1 = jnp.where(j > 0, marg_at(jnp.maximum(j - 1, 0)), 0.0)
    row_mass = jnp.maximum(marg_at(j) - cdf_jm1, 1e-12)
    fy = jnp.clip((ty - cdf_jm1) / row_mass, 0.0, 1.0)
    y = (j.astype(jnp.float32) + fy) / ny

    tx = ux * row_mass
    cond_flat = w.cond_cdf.reshape(-1)

    def cond_at(i):
        return _blend(cond_flat, ids, wts, ny * nx, j * nx + i)

    i = _bsearch(cond_at, nx, tx)
    ccdf_im1 = jnp.where(i > 0, cond_at(jnp.maximum(i - 1, 0)), 0.0)
    cell = jnp.maximum(cond_at(i) - ccdf_im1, 1e-12)
    fx = jnp.clip((tx - ccdf_im1) / cell, 0.0, 1.0)
    x = (i.astype(jnp.float32) + fx) / nx

    dens = cell * (nx * ny) / total
    return x, y, dens


def warp_invert(w: WarpTables, ids, wts, x, y):
    """Inverse of warp_sample: (x, y) -> (ux, uy, density)."""
    ny, nx = w.ry - 1, w.rx - 1
    total = sum(wt * jnp.take(w.total, i) for i, wt in zip(ids, wts))
    j = jnp.clip((y * ny).astype(jnp.int32), 0, ny - 1)
    fy = y * ny - j.astype(jnp.float32)
    i = jnp.clip((x * nx).astype(jnp.int32), 0, nx - 1)
    fx = x * nx - i.astype(jnp.float32)

    def marg_at(jj):
        return _blend(w.marg_cdf.reshape(-1), ids, wts, ny, jj)

    cond_flat = w.cond_cdf.reshape(-1)

    def cond_at(ii):
        return _blend(cond_flat, ids, wts, ny * nx, j * nx + ii)

    cdf_jm1 = jnp.where(j > 0, marg_at(jnp.maximum(j - 1, 0)), 0.0)
    row_mass = jnp.maximum(marg_at(j) - cdf_jm1, 1e-12)
    ccdf_im1 = jnp.where(i > 0, cond_at(jnp.maximum(i - 1, 0)), 0.0)
    cell = jnp.maximum(cond_at(i) - ccdf_im1, 1e-12)
    uy = (cdf_jm1 + fy * row_mass) / jnp.maximum(total, 1e-12)
    ux = (ccdf_im1 + fx * cell) / row_mass
    dens = cell * (nx * ny) / jnp.maximum(total, 1e-12)
    return ux, uy, dens


# ---------------------------------------------------------------------------
# raw bilinear field lookups
# ---------------------------------------------------------------------------

def eval_grid2d(grid: jnp.ndarray, x, y):
    """Bilinear node interpolation of a (ry, rx) grid on [0,1]^2."""
    ry, rx = int(grid.shape[0]), int(grid.shape[1])
    gx = jnp.clip(x, 0.0, 1.0) * (rx - 1)
    gy = jnp.clip(y, 0.0, 1.0) * (ry - 1)
    x0 = jnp.clip(gx.astype(jnp.int32), 0, rx - 2)
    y0 = jnp.clip(gy.astype(jnp.int32), 0, ry - 2)
    tx = gx - x0
    ty = gy - y0
    flat = grid.reshape(-1)

    def at(yy, xx):
        return jnp.take(flat, yy * rx + xx, mode="clip")
    v0 = at(y0, x0) * (1 - tx) + at(y0, x0 + 1) * tx
    v1 = at(y0 + 1, x0) * (1 - tx) + at(y0 + 1, x0 + 1) * tx
    return v0 * (1 - ty) + v1 * ty


def eval_spectra(tbl: MeasuredTables, ids, wts, lam, x, y):
    """spectra(phi_i, theta_i, lambda, y, x) with multilinear parameter
    blending (the reference's Warp2D3.eval)."""
    P, T, W, rs_y, rs_x = (int(s) for s in tbl.spectra.shape)
    li, lw = _param_weight(tbl.wavelengths, lam)
    flat = tbl.spectra.reshape(P * T, W, rs_y * rs_x)

    gx = jnp.clip(x, 0.0, 1.0) * (rs_x - 1)
    gy = jnp.clip(y, 0.0, 1.0) * (rs_y - 1)
    x0 = jnp.clip(gx.astype(jnp.int32), 0, rs_x - 2)
    y0 = jnp.clip(gy.astype(jnp.int32), 0, rs_y - 2)
    tx = gx - x0
    ty = gy - y0

    def node(pt, wl, yy, xx):
        lin = (pt * W + wl) * (rs_y * rs_x) + yy * rs_x + xx
        return jnp.take(flat.reshape(-1), lin, mode="clip")

    acc = 0.0
    for pt, pw in zip(ids, wts):
        for dl in (0, 1):
            wl = jnp.minimum(li + dl, W - 1)
            ww = pw * (lw if dl else (1.0 - lw))
            v0 = (node(pt, wl, y0, x0) * (1 - tx)
                  + node(pt, wl, y0, x0 + 1) * tx)
            v1 = (node(pt, wl, y0 + 1, x0) * (1 - tx)
                  + node(pt, wl, y0 + 1, x0 + 1) * tx)
            acc = acc + ww * (v0 * (1 - ty) + v1 * ty)
    return acc


# ---------------------------------------------------------------------------
# the measured BSDF itself (measured.cpp:173-385)
# ---------------------------------------------------------------------------

def _elevation(d: Vec3):
    """Numerically stable acos(d.z) (measured.cpp:166-170)."""
    dist = jnp.sqrt(d.x * d.x + d.y * d.y + (d.z - 1.0) ** 2)
    return 2.0 * jnp.arcsin(jnp.clip(0.5 * dist, 0.0, 1.0))


def _u2theta(u):
    return u * u * (math.pi / 2.0)


def _u2phi(u):
    return (2.0 * u - 1.0) * math.pi


def _theta2u(theta):
    return jnp.sqrt(jnp.maximum(theta * (2.0 / math.pi), 0.0))


def _phi2u(phi):
    return (phi + math.pi) * (0.5 / math.pi)


# representative wavelengths for the 3 channels in tpu_rgb mode
RGB_WAVELENGTHS = (611.0, 549.0, 465.0)


def _spectrum3(tbl, ids, wts, x, y, wavelengths):
    if wavelengths is None:
        lams = [jnp.full_like(x, l) for l in RGB_WAVELENGTHS]
    else:
        lams = [wavelengths.x, wavelengths.y, wavelengths.z]
    return Vec3(*(eval_spectra(tbl, ids, wts, l, x, y) for l in lams))


def _fr_common(tbl: MeasuredTables, wi: Vec3, wo: Vec3, wavelengths):
    """f_r(wi, wo) + the sampling pdf of wo (measured.cpp eval/pdf)."""
    active = (wi.z > 0.0) & (wo.z > 0.0)
    hx, hy, hz = wi.x + wo.x, wi.y + wo.y, wi.z + wo.z
    hl = jnp.sqrt(jnp.maximum(hx * hx + hy * hy + hz * hz, 1e-18))
    m = Vec3(hx / hl, hy / hl, hz / hl)

    theta_i = _elevation(wi)
    phi_i = jnp.arctan2(wi.y, wi.x)
    theta_m = _elevation(m)
    phi_m = jnp.arctan2(m.y, m.x)

    u_wi_x = _theta2u(theta_i)
    u_wi_y = _phi2u(phi_i)
    phi_rel = phi_m - phi_i if tbl.isotropic else phi_m
    um_x = _theta2u(theta_m)
    um_y = _phi2u(phi_rel)
    um_y = um_y - jnp.floor(um_y)

    ids, wts = _corner_ids(tbl, phi_i, theta_i)
    sx, sy, vndf_pdf = warp_invert(tbl.vndf, ids, wts, um_x, um_y)

    spec = _spectrum3(tbl, ids, wts, sx, sy, wavelengths)
    if tbl.jacobian:
        nd = eval_grid2d(tbl.ndf, um_x, um_y)
        sg = eval_grid2d(tbl.sigma, u_wi_x, u_wi_y)
        spec = spec * (nd / jnp.maximum(4.0 * sg, 1e-12))

    # pdf of the sampled wo (measured.cpp pdf():354-365)
    sin_m = jnp.sqrt(jnp.maximum(1.0 - m.z * m.z, 0.0))
    dot_wim = wi.x * m.x + wi.y * m.y + wi.z * m.z
    jacobian = jnp.maximum(2.0 * math.pi ** 2 * um_x * sin_m, 1e-6) \
        * 4.0 * dot_wim
    # luminance warp density at (sx, sy): the pdf of the pre-warp sample
    lum_dens = _lum_density(tbl, ids, wts, sx, sy)
    pdf = vndf_pdf * lum_dens / jacobian
    zero = jnp.zeros_like(pdf)
    spec = Vec3(jnp.where(active, spec.x, 0.0),
                jnp.where(active, spec.y, 0.0),
                jnp.where(active, spec.z, 0.0))
    return spec, jnp.where(active, pdf, zero), active


def _lum_density(tbl, ids, wts, x, y):
    """Normalized histogram density of the luminance warp at (x, y)."""
    w = tbl.luminance
    ny, nx = w.ry - 1, w.rx - 1
    total = sum(wt * jnp.take(w.total, i) for i, wt in zip(ids, wts))
    j = jnp.clip((y * ny).astype(jnp.int32), 0, ny - 1)
    i = jnp.clip((x * nx).astype(jnp.int32), 0, nx - 1)
    cell = _blend(w.cw.reshape(-1), ids, wts, ny * nx, j * nx + i)
    return cell * (nx * ny) / jnp.maximum(total, 1e-12)


def measured_eval_pdf_sample(tbl: MeasuredTables, wi: Vec3, wo_nee: Vec3,
                             s2x, s2y, wavelengths=None):
    """The masked-dispatch entry: NEE eval/pdf for wo_nee + a sampled
    direction with weight (measured.cpp sample():174-276). Returns the
    same record fields as the analytic BSDFs."""
    from . import BSDFSampleResult

    # ---- NEE eval/pdf ------------------------------------------------
    # the RGL spectra already include the cosine foreshortening (the
    # reference's BSDF::eval convention returns f_r * cos_theta_o)
    val_nee, pdf_nee, _ = _fr_common(tbl, wi, wo_nee, wavelengths)

    # ---- sampling (luminance warp then VNDF warp) -------------------------
    active = wi.z > 0.0
    theta_i = _elevation(wi)
    phi_i = jnp.arctan2(wi.y, wi.x)
    ids, wts = _corner_ids(tbl, phi_i, theta_i)

    # note the reference swaps the 2D sample components (measured.cpp:205)
    lx, ly, lum_dens = warp_sample(tbl.luminance, ids, wts, s2y, s2x)
    um_x, um_y, vndf_pdf = warp_sample(tbl.vndf, ids, wts, lx, ly)

    phi_m = _u2phi(um_y)
    theta_m = _u2theta(um_x)
    if tbl.isotropic:
        phi_m = phi_m + phi_i
    sin_t = jnp.sin(theta_m)
    cos_t = jnp.cos(theta_m)
    m = Vec3(jnp.cos(phi_m) * sin_t, jnp.sin(phi_m) * sin_t, cos_t)

    dot_wim = wi.x * m.x + wi.y * m.y + wi.z * m.z
    jac = jnp.maximum(2.0 * math.pi ** 2 * um_x * sin_t, 1e-6) \
        * 4.0 * dot_wim
    two_dot = 2.0 * dot_wim
    wo = Vec3(m.x * two_dot - wi.x, m.y * two_dot - wi.y,
              m.z * two_dot - wi.z)
    pdf = vndf_pdf * lum_dens / jac

    # NOTE: warp_sample's (lx, ly) are the vndf-warp input coords == the
    # spectra lookup coordinates (the reference's `sample`)
    spec = _spectrum3(tbl, ids, wts, lx, ly, wavelengths)
    if tbl.jacobian:
        u_wi_x = _theta2u(theta_i)
        u_wi_y = _phi2u(phi_i)
        nd = eval_grid2d(tbl.ndf, um_x, um_y)
        sg = eval_grid2d(tbl.sigma, u_wi_x, u_wi_y)
        spec = spec * (nd / jnp.maximum(4.0 * sg, 1e-12))

    ok = active & (wo.z > 0.0) & (pdf > 0.0)
    inv_pdf = jnp.where(ok, 1.0 / jnp.maximum(pdf, 1e-18), 0.0)
    weight = Vec3(spec.x * inv_pdf, spec.y * inv_pdf, spec.z * inv_pdf)
    zero = jnp.zeros_like(pdf)
    false_ = zero > 1.0
    return BSDFSampleResult(
        val_nee=val_nee, pdf_nee=pdf_nee, wo=wo, weight=weight,
        pdf=jnp.where(ok, pdf, 0.0), eta=jnp.ones_like(pdf),
        sampled_delta=false_, sampled_null=false_)


__all__ = ["MeasuredTables", "build_tables", "measured_eval_pdf_sample",
           "warp_sample", "warp_invert", "eval_grid2d", "eval_spectra"]

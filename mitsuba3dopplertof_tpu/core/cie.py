"""CIE colorimetry + spectral upsampling for the spectral variant.

The reference's spectral variants carry 4 wavelengths per lane, convert
samples to XYZ with tabulated CIE curves (reference src/core/spectrum.cpp)
and upsample RGB reflectances with the Jakob & Hanika sigmoid-polynomial
model (ext/rgb2spec). This module re-implements both from their published
descriptions:

  * analytic CIE 1931 CMF fits (Wyman, Sloan & Shirley 2013, multi-lobe
    Gaussians) — no tables needed, jit-friendly;
  * sigmoid-polynomial reflectance upsampling S(lambda) =
    sigmoid(c2 x^2 + c1 x + c0), coefficients fitted per RGB at scene
    compile time with a small Gauss-Newton solve (the JH'19 method, fitted
    here directly rather than read from a precomputed .coeff table).

Wavelengths in nanometers over [360, 830] (MI_WAVELENGTH_MIN/MAX).
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp

LAMBDA_MIN = 360.0
LAMBDA_MAX = 830.0
LAMBDA_RANGE = LAMBDA_MAX - LAMBDA_MIN

# RGB <-> XYZ built from the sRGB primaries adapted to THIS module's
# analytic D65 whitepoint, so a flat unit spectrum maps exactly to rgb
# (1,1,1) and back — the self-consistency the reflectance fit relies on
# (the textbook matrix assumes tabulated D65, which differs by a few
# percent from the Planck-6504K approximation used here).
_PRIMARIES_XY = np.array([[0.64, 0.33], [0.30, 0.60], [0.15, 0.06]])
_MAT_CACHE = {}


def _matrices():
    if "xyz2rgb" not in _MAT_CACHE:
        lam = np.linspace(LAMBDA_MIN, LAMBDA_MAX, 2048)
        import jax.numpy as _jnp
        cm = np.stack([np.asarray(cie_xbar(_jnp.asarray(lam))),
                       np.asarray(cie_ybar(_jnp.asarray(lam))),
                       np.asarray(cie_zbar(_jnp.asarray(lam)))])
        d = np.asarray(d65_spd(_jnp.asarray(lam)))
        W = np.trapezoid(cm * d[None, :], lam, axis=1)
        W = W / W[1]                                   # whitepoint, Y = 1
        # columns: primaries' XYZ directions scaled so M @ (1,1,1) = W
        xyY = _PRIMARIES_XY
        P = np.stack([xyY[:, 0] / xyY[:, 1],
                      np.ones(3),
                      (1.0 - xyY[:, 0] - xyY[:, 1]) / xyY[:, 1]])  # (3 XYZ, 3 prim)
        scale = np.linalg.solve(P, W)
        rgb2xyz = P * scale[None, :]
        _MAT_CACHE["rgb2xyz"] = rgb2xyz
        _MAT_CACHE["xyz2rgb"] = np.linalg.inv(rgb2xyz)
    return _MAT_CACHE["xyz2rgb"], _MAT_CACHE["rgb2xyz"]


class _LazyMat:
    def __init__(self, key):
        self.key = key

    def __getitem__(self, k):
        return _matrices()[0 if self.key == "xyz2rgb" else 1][k]

    def __array__(self, dtype=None):
        m = _matrices()[0 if self.key == "xyz2rgb" else 1]
        return m.astype(dtype) if dtype else m

    @property
    def T(self):
        return np.asarray(self).T


_XYZ_TO_SRGB = _LazyMat("xyz2rgb")
_SRGB_TO_XYZ = _LazyMat("rgb2xyz")


def _g(x, mu, s1, s2):
    """Piecewise Gaussian of Wyman et al."""
    s = jnp.where(x < mu, s1, s2)
    t = (x - mu) / s
    return jnp.exp(-0.5 * t * t)


def cie_xbar(lam):
    return (1.056 * _g(lam, 599.8, 37.9, 31.0)
            + 0.362 * _g(lam, 442.0, 16.0, 26.7)
            - 0.065 * _g(lam, 501.1, 20.4, 26.2))


def cie_ybar(lam):
    return (0.821 * _g(lam, 568.8, 46.9, 40.5)
            + 0.286 * _g(lam, 530.9, 16.3, 31.1))


def cie_zbar(lam):
    return (1.217 * _g(lam, 437.0, 11.8, 36.0)
            + 0.681 * _g(lam, 459.0, 26.0, 13.8))


def d65_spd(lam):
    """Approximate D65 SPD: Planck at 6504K with a gentle correction,
    normalized to ~1 at 560nm (the exact tabulated D65 differs by a few
    percent in the blue; adequate for the v1 spectral variant)."""
    h = 6.62607015e-34
    c = 2.99792458e8
    kb = 1.380649e-23
    T = 6504.0
    lm = lam * 1e-9
    planck = (1.0 / (lm ** 5)) / (jnp.exp(h * c / (lm * kb * T)) - 1.0)
    lm560 = 560e-9
    p560 = (1.0 / (lm560 ** 5)) / (np.exp(h * c / (lm560 * kb * T)) - 1.0)
    return planck / p560


# normalization so an SPD-1 (flat) emitter integrates to luminance 1 under
# uniform wavelength sampling with pdf 1/RANGE
_Y_INT = None


def y_integral() -> float:
    global _Y_INT
    if _Y_INT is None:
        lam = np.linspace(LAMBDA_MIN, LAMBDA_MAX, 2048)
        _Y_INT = float(np.trapezoid(np.asarray(cie_ybar(jnp.asarray(lam))),
                                    lam))
    return _Y_INT


def xyz_weights(lam):
    """CMF weights for MC spectral-to-XYZ conversion (per sample):
    contribution = value * cmf(lambda) / pdf; caller divides by Y integral."""
    return cie_xbar(lam), cie_ybar(lam), cie_zbar(lam)


def xyz_to_srgb_np(xyz: np.ndarray) -> np.ndarray:
    return xyz @ _XYZ_TO_SRGB.T


def srgb_to_xyz_np(rgb: np.ndarray) -> np.ndarray:
    return rgb @ _SRGB_TO_XYZ.T


# ---------------------------------------------------------------------------
# Sigmoid-polynomial reflectance upsampling (JH'19 method, self-fitted)
# ---------------------------------------------------------------------------

def _sigmoid(x):
    return 0.5 + x / (2.0 * np.sqrt(1.0 + x * x))


def _spectrum_np(coeffs, lam):
    x = (lam - LAMBDA_MIN) / LAMBDA_RANGE * 2.0 - 1.0   # [-1, 1]
    p = coeffs[2] * x * x + coeffs[1] * x + coeffs[0]
    return _sigmoid(p)


_FIT_LAM = np.linspace(LAMBDA_MIN, LAMBDA_MAX, 128)
_FIT_X = None
_FIT_D65 = None


def _fit_tables():
    global _FIT_X, _FIT_D65
    if _FIT_X is None:
        lam = jnp.asarray(_FIT_LAM)
        cm = np.stack([np.asarray(cie_xbar(lam)), np.asarray(cie_ybar(lam)),
                       np.asarray(cie_zbar(lam))], axis=0)   # (3, L)
        d65 = np.asarray(d65_spd(lam))
        # rgb of a spectrum S under D65: RGB = M * ∫ S * D65 * cmf / ∫ D65*ybar
        norm = np.trapezoid(d65 * cm[1], _FIT_LAM)
        _FIT_X = (cm * d65[None, :]) / norm                  # (3, L)
        _FIT_D65 = d65
    return _FIT_X


def rgb_of_coeffs(coeffs: np.ndarray) -> np.ndarray:
    X = _fit_tables()
    S = _spectrum_np(coeffs, _FIT_LAM)
    xyz = np.trapezoid(X * S[None, :], _FIT_LAM, axis=1)
    return xyz_to_srgb_np(xyz)


def fit_reflectance_coeffs(rgb, iters: int = 60) -> np.ndarray:
    """Fit sigmoid-polynomial coefficients reproducing ``rgb`` under D65
    illumination (Gauss-Newton on the 3-vector residual)."""
    rgb = np.clip(np.asarray(rgb, np.float64), 1e-4, 0.9999)
    # init: flat spectrum at the luminance level
    y = float(srgb_to_xyz_np(rgb)[1])
    y = min(max(y, 1e-3), 0.999)
    c = np.array([np.arctanh(2.0 * y - 1.0) if 0 < y < 1 else 0.0, 0.0, 0.0])

    def residual(c):
        return rgb_of_coeffs(c) - rgb

    # Phase 1: smoothness prior (penalize slope/curvature) steers the
    # solver into the maximally-smooth metamer's basin (the rgb2spec
    # objective) instead of a box-like extremum that zeroes the spectrum
    # outside the CMF support. Phase 2: unregularized polish from there
    # recovers an exact match while staying in the smooth basin.
    def run(c, w_smooth, iters):
        def res(cc):
            return np.concatenate([residual(cc), w_smooth * cc])

        lam_reg = 1e-6
        r = res(c)
        for _ in range(iters):
            J = np.zeros((6, 3))
            eps = 1e-4
            for j in range(3):
                cp = c.copy()
                cp[j] += eps
                J[:, j] = (res(cp) - r) / eps
            try:
                step = np.linalg.solve(J.T @ J + lam_reg * np.eye(3),
                                       -J.T @ r)
            except np.linalg.LinAlgError:
                break
            c_new = c + step
            r_new = res(c_new)
            if np.linalg.norm(r_new) < np.linalg.norm(r):
                c, r = c_new, r_new
                lam_reg = max(lam_reg * 0.5, 1e-8)
            else:
                lam_reg *= 4.0
            if np.linalg.norm(r[:3]) < 1e-6:
                break
        return c

    c = run(c, np.array([0.0, 3e-3, 3e-3]), iters)
    c = run(c, np.zeros(3), 20)
    return c.astype(np.float32)


# ---------------------------------------------------------------------------
# Per-texel upsampling: batched fit + cached coefficient lattice
# (the role of the reference's precomputed rgb2spec tables, ext/rgb2spec +
# src/core/srgb.cpp — fitted here from our own CIE model, trilinearly
# interpolated per texel at scene compile)
# ---------------------------------------------------------------------------

def fit_reflectance_coeffs_batch(rgbs: np.ndarray, iters: int = 60
                                 ) -> np.ndarray:
    """Vectorized Gauss-Newton over N colors at once (same two-phase
    smoothness-prior schedule as `fit_reflectance_coeffs`). Returns
    (N, 3) float32 coefficients."""
    rgbs = np.clip(np.asarray(rgbs, np.float64), 1e-4, 0.9999)
    n = rgbs.shape[0]
    X = _fit_tables()                                   # (3, L)
    lam = _FIT_LAM
    xg = (lam - LAMBDA_MIN) / LAMBDA_RANGE * 2.0 - 1.0  # (L,)
    basis = np.stack([np.ones_like(xg), xg, xg * xg], axis=0)   # (3, L)
    M = np.asarray(_XYZ_TO_SRGB, np.float64)   # the package's own D65 fit
    XM = M @ X                                          # (3, L): d srgb / dS

    y = (rgbs @ np.asarray(_SRGB_TO_XYZ, np.float64).T)[:, 1]
    y = np.clip(y, 1e-3, 0.999)
    c = np.zeros((n, 3))
    c[:, 0] = np.arctanh(2.0 * y - 1.0)

    def gn(c, w_smooth, iters):
        lam_reg = np.full(n, 1e-6)
        W = np.diag([w_smooth[0], w_smooth[1], w_smooth[2]])
        for _ in range(iters):
            p = c @ basis                               # (N, L)
            den = (1.0 + p * p)
            S = 0.5 + p / (2.0 * np.sqrt(den))
            dS = 0.5 / den ** 1.5                       # dS/dp (N, L)
            r = (np.trapezoid(X[None] * S[:, None, :], lam, axis=2) @ M.T
                 - rgbs)                                # (N, 3)
            # J[n, i, j] = ∫ XM[i] * dS * basis[j]
            w = dS[:, None, :] * basis[None, :, :]      # (N, 3, L)
            J = np.trapezoid(XM[None, :, None, :] * w[:, None, :, :],
                             lam, axis=3)               # (N, 3i, 3j)
            # normal equations of the augmented residual [r; W c]
            A = (np.einsum("nki,nkj->nij", J, J) + W.T @ W
                 + lam_reg[:, None, None] * np.eye(3))
            b = -np.einsum("nki,nk->ni", J, r) - c @ (W.T @ W)
            try:
                step = np.linalg.solve(A, b[..., None])[..., 0]
            except np.linalg.LinAlgError:
                break
            c_new = c + step
            r_new = (np.trapezoid(
                X[None] * (0.5 + (c_new @ basis)
                           / (2.0 * np.sqrt(1.0 + (c_new @ basis) ** 2))
                           )[:, None, :], lam, axis=2) @ M.T - rgbs)
            better = (np.linalg.norm(r_new, axis=1)
                      + np.linalg.norm(c_new * w_smooth, axis=1)
                      < np.linalg.norm(r, axis=1)
                      + np.linalg.norm(c * w_smooth, axis=1))
            c = np.where(better[:, None], c_new, c)
            lam_reg = np.where(better, np.maximum(lam_reg * 0.5, 1e-8),
                               lam_reg * 4.0)
        return c

    c = gn(c, np.array([0.0, 3e-3, 3e-3]), iters)
    c = gn(c, np.zeros(3), 20)
    return c.astype(np.float32)


_LATTICE = None
_LATTICE_N = 32


def coeff_lattice(n: int = _LATTICE_N) -> np.ndarray:
    """(n, n, n, 3) sigmoid-polynomial coefficients over the sRGB cube,
    fitted once and cached on disk (~the reference's .coeff table file)."""
    global _LATTICE
    if _LATTICE is not None and _LATTICE.shape[0] == n:
        return _LATTICE
    import os
    from .fresolver import cache_dir as _cache_dir
    cache_dir = _cache_dir()
    path = os.path.join(cache_dir, f"rgb2spec_{n}.npz")
    if os.path.exists(path):
        _LATTICE = np.load(path)["lattice"]
        return _LATTICE
    g = np.linspace(0.0, 1.0, n)
    r, gg, b = np.meshgrid(g, g, g, indexing="ij")
    rgbs = np.stack([r, gg, b], axis=-1).reshape(-1, 3)
    # chunked: the batched Jacobian is (N, 3, 3, L) — keep N bounded
    coeffs = np.concatenate(
        [fit_reflectance_coeffs_batch(rgbs[i:i + 2048])
         for i in range(0, rgbs.shape[0], 2048)], axis=0)
    _LATTICE = coeffs.reshape(n, n, n, 3)
    os.makedirs(cache_dir, exist_ok=True)
    np.savez_compressed(path, lattice=_LATTICE)
    return _LATTICE


def upsample_rgb_array(rgb: np.ndarray) -> np.ndarray:
    """Trilinear lattice interpolation: (N, 3) rgb -> (N, 3) coefficients.
    The per-texel path of the spectral variant (reference srgb.cpp +
    rgb2spec table lookup)."""
    lat = coeff_lattice()
    n = lat.shape[0]
    q = np.clip(np.asarray(rgb, np.float64), 0.0, 1.0) * (n - 1)
    i0 = np.clip(q.astype(np.int32), 0, n - 2)
    t = q - i0
    out = np.zeros((rgb.shape[0], 3))
    for dr in (0, 1):
        for dg in (0, 1):
            for db in (0, 1):
                w = ((t[:, 0] if dr else 1 - t[:, 0])
                     * (t[:, 1] if dg else 1 - t[:, 1])
                     * (t[:, 2] if db else 1 - t[:, 2]))
                out += w[:, None] * lat[i0[:, 0] + dr, i0[:, 1] + dg,
                                        i0[:, 2] + db]
    return out.astype(np.float32)


_D65_Y_NORM = None


def d65_y_norm() -> float:
    """∫ D65(λ)·ȳ(λ) dλ — the luminance normalization used both by the
    reflectance fit and by emission spectra so a directly-viewed emitter
    reproduces its RGB exactly after the XYZ→sRGB develop step."""
    global _D65_Y_NORM
    if _D65_Y_NORM is None:
        # pure numpy so this is safe to call inside an active jax trace
        lam = np.linspace(LAMBDA_MIN, LAMBDA_MAX, 2048)

        def g(x, mu, s1, s2):
            sd = np.where(x < mu, s1, s2)
            return np.exp(-0.5 * ((x - mu) / sd) ** 2)

        y = (0.821 * g(lam, 568.8, 46.9, 40.5)
             + 0.286 * g(lam, 530.9, 16.3, 31.1))
        h, c, kb, T = 6.62607015e-34, 2.99792458e8, 1.380649e-23, 6504.0
        lm = lam * 1e-9
        planck = (1.0 / lm ** 5) / (np.exp(h * c / (lm * kb * T)) - 1.0)
        lm560 = 560e-9
        p560 = (1.0 / lm560 ** 5) / (np.exp(h * c / (lm560 * kb * T)) - 1.0)
        d = planck / p560
        _D65_Y_NORM = float(np.trapezoid(d * y, lam))
    return _D65_Y_NORM


def eval_emission_spectrum(c0, c1, c2, scale, lam, inv_norm):
    """Device-side emission SPD: scale · S(coeffs, λ) · D65(λ) / ∫D65·ȳ
    (reference srgb.cpp emission semantics: chromaticity spectrum × D65,
    luminance restored by ``scale``). ``inv_norm`` = 1/d65_y_norm()."""
    return (scale * eval_reflectance_spectrum(c0, c1, c2, lam)
            * d65_spd(lam) * inv_norm)


def eval_reflectance_spectrum(c0, c1, c2, lam):
    """Device-side sigmoid-polynomial evaluation (per-lane wavelengths)."""
    x = (lam - LAMBDA_MIN) / LAMBDA_RANGE * 2.0 - 1.0
    p = c2 * x * x + c1 * x + c0
    return 0.5 + p / (2.0 * jnp.sqrt(1.0 + p * p))


__all__ = ["LAMBDA_MIN", "LAMBDA_MAX", "LAMBDA_RANGE",
           "cie_xbar", "cie_ybar", "cie_zbar", "d65_spd", "xyz_weights",
           "y_integral", "fit_reflectance_coeffs", "rgb_of_coeffs",
           "eval_reflectance_spectrum", "eval_emission_spectrum", "d65_y_norm",
           "xyz_to_srgb_np", "srgb_to_xyz_np", "hero_to_srgb"]


def hero_to_srgb(spec, wavelengths):
    """MC estimate of linear sRGB from 3 hero-wavelength radiance samples
    riding the Vec3 channels: XYZ = (range/3) * sum_i v_i * cmf(lambda_i)
    (each hero wavelength has pdf 1/range), then XYZ->sRGB. Linear in the
    samples, so converting before a film splat == converting at develop."""
    from .vec import Vec3
    K = LAMBDA_RANGE / 3.0
    xs = [xyz_weights(l) for l in
          (wavelengths.x, wavelengths.y, wavelengths.z)]
    vals = (spec.x, spec.y, spec.z)
    X = K * sum(v * c[0] for v, c in zip(vals, xs))
    Y = K * sum(v * c[1] for v, c in zip(vals, xs))
    Z = K * sum(v * c[2] for v, c in zip(vals, xs))
    M = _XYZ_TO_SRGB
    return Vec3(M[0, 0] * X + M[0, 1] * Y + M[0, 2] * Z,
                M[1, 0] * X + M[1, 1] * Y + M[1, 2] * Z,
                M[2, 0] * X + M[2, 1] * Y + M[2, 2] * Z)

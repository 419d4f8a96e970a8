"""AOV-guided denoiser (the analog of the reference's
OptixDenoiser wrapper, reference src/render/optixdenoiser.cpp:20-120).

The reference delegates to OptiX's pretrained AI denoiser — unavailable
off-NVIDIA. This equivalent keeps the same API surface
(``Denoiser(input_size, albedo=, normals=, temporal=)(noisy, albedo=,
normals=, flow=)``) and implements a cross/joint-bilateral filter guided
by the same auxiliary AOVs, expressed as a dense shift-and-accumulate over
a (2r+1)^2 window — pure vectorized jnp, so XLA fuses the whole filter
into a handful of elementwise kernels (no gathers). Temporal mode warps
the previous output by the flow AOV and blends it in, mirroring the
reference's temporal model-kind switch (optixdenoiser.cpp:35-38).

This is a principled classical denoiser (SURE-style parameters left to the
caller), not a learned one; for equal-API drop-in use that is exactly the
role the reference class plays in pipelines.
"""

from __future__ import annotations

from functools import partial
from typing import Optional

import numpy as np

__all__ = ["Denoiser", "joint_bilateral"]


def _shift2d(img, dy: int, dx: int):
    """Edge-replicated spatial shift of (H, W, C)."""
    import jax.numpy as jnp
    H, W = img.shape[:2]
    ys = jnp.clip(jnp.arange(H) + dy, 0, H - 1)
    xs = jnp.clip(jnp.arange(W) + dx, 0, W - 1)
    return img[ys][:, xs]


def joint_bilateral(noisy, albedo=None, normals=None, radius: int = 3,
                    sigma_space: float = 1.6, sigma_color: float = 0.35,
                    sigma_albedo: float = 0.08, sigma_normal: float = 0.25):
    """Cross-bilateral filter of ``noisy`` (H, W, 3) guided by optional
    albedo / normal AOVs of the same shape. Returns the filtered image."""
    import jax.numpy as jnp

    noisy = jnp.asarray(noisy, jnp.float32)
    acc = jnp.zeros_like(noisy)
    wacc = jnp.zeros(noisy.shape[:2] + (1,), jnp.float32)
    inv2 = {
        "s": 1.0 / (2.0 * sigma_space ** 2),
        "c": 1.0 / (2.0 * sigma_color ** 2),
        "a": 1.0 / (2.0 * sigma_albedo ** 2),
        "n": 1.0 / (2.0 * sigma_normal ** 2),
    }
    # luminance for the range kernel: robust to chroma noise
    def lum(x):
        return (0.2126 * x[..., 0] + 0.7152 * x[..., 1]
                + 0.0722 * x[..., 2])[..., None]

    base_l = lum(noisy)
    for dy in range(-radius, radius + 1):
        for dx in range(-radius, radius + 1):
            sh = partial(_shift2d, dy=dy, dx=dx)
            logw = -(dy * dy + dx * dx) * inv2["s"]
            dl = sh(base_l) - base_l
            logw = logw - dl * dl * inv2["c"]
            if albedo is not None:
                da = sh(albedo) - albedo
                logw = logw - jnp.sum(da * da, -1, keepdims=True) * inv2["a"]
            if normals is not None:
                dn = jnp.sum(sh(normals) * normals, -1, keepdims=True)
                logw = logw - (1.0 - jnp.clip(dn, -1.0, 1.0)) * inv2["n"]
            w = jnp.exp(logw)
            acc = acc + w * sh(noisy)
            wacc = wacc + w
    return acc / jnp.maximum(wacc, 1e-12)


class Denoiser:
    """API-compatible stand-in for the reference OptixDenoiser
    (optixdenoiser.cpp:20): construct with the input size and which guide
    AOVs will be supplied; call with the noisy image (+AOVs). Temporal mode
    additionally takes the previous denoised output and a flow AOV
    (pixel-space motion vectors) and blends the warped history in."""

    def __init__(self, input_size, albedo: bool = False,
                 normals: bool = False, temporal: bool = False,
                 radius: int = 3, history_weight: float = 0.8):
        if normals and not albedo:
            raise RuntimeError(
                "The denoiser cannot use normals to guide its process "
                "without also providing albedo information!")   # :26-28
        self.input_size = tuple(input_size)
        self.use_albedo = albedo
        self.use_normals = normals
        self.temporal = temporal
        self.radius = radius
        self.history_weight = history_weight
        self._prev = None

    def __call__(self, noisy, albedo=None, normals=None, flow=None,
                 denoise_alpha: bool = False, **sigmas):
        import jax.numpy as jnp

        noisy = jnp.asarray(noisy, jnp.float32)
        H, W = noisy.shape[:2]
        if (W, H) != self.input_size and (H, W) != self.input_size:
            raise ValueError(
                f"input {noisy.shape[:2]} != configured {self.input_size}")
        alpha = None
        rgb = noisy
        if noisy.shape[-1] == 4:
            alpha = noisy[..., 3:]
            rgb = noisy[..., :3]
        if self.use_albedo and albedo is None:
            raise RuntimeError("albedo AOV required but not provided")
        if self.use_normals and normals is None:
            raise RuntimeError("normals AOV required but not provided")
        out = joint_bilateral(
            rgb,
            jnp.asarray(albedo, jnp.float32) if self.use_albedo else None,
            jnp.asarray(normals, jnp.float32) if self.use_normals else None,
            radius=self.radius, **sigmas)

        if self.temporal and self._prev is not None and flow is not None:
            warped = self._warp(self._prev, jnp.asarray(flow, jnp.float32))
            out = (self.history_weight * warped
                   + (1.0 - self.history_weight) * out)
        if self.temporal:
            self._prev = out
        if alpha is not None:
            a = (joint_bilateral(jnp.repeat(alpha, 3, -1),
                                 radius=self.radius)[..., :1]
                 if denoise_alpha else alpha)
            out = jnp.concatenate([out, a], axis=-1)
        return out

    @staticmethod
    def _warp(img, flow):
        """Backward-warp by integer-rounded flow (history reprojection)."""
        import jax.numpy as jnp
        H, W = img.shape[:2]
        yy, xx = jnp.meshgrid(jnp.arange(H), jnp.arange(W), indexing="ij")
        sy = jnp.clip(jnp.round(yy - flow[..., 1]).astype(jnp.int32),
                      0, H - 1)
        sx = jnp.clip(jnp.round(xx - flow[..., 0]).astype(jnp.int32),
                      0, W - 1)
        return img[sy, sx]

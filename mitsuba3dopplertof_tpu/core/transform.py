"""4x4 affine transforms and 2-keyframe animated transforms.

Host-side construction uses numpy; device-side evaluation (per-lane time
lerp + affine inverse) uses jnp so it stays inside the jitted wavefront.

Reference semantics:
  * ``Transform4f`` ops        — reference include/mitsuba/core/transform.h
  * ``AnimatedTransform.eval`` — clamped component-wise matrix lerp between
    the two keyframes (reference transform.h:458-466, deliberately replacing
    upstream's scale/quat/translate decomposition).
"""

from __future__ import annotations

import functools
import math
from typing import List, Tuple

import numpy as np
import jax.numpy as jnp
from jax import lax


# ---------------------------------------------------------------------------
# Host-side matrix builders (numpy, used by the scene front-end)
# ---------------------------------------------------------------------------

def identity() -> np.ndarray:
    return np.eye(4, dtype=np.float64)


def translate(v) -> np.ndarray:
    m = identity()
    m[:3, 3] = v
    return m


def scale(v) -> np.ndarray:
    m = identity()
    v = np.broadcast_to(np.asarray(v, dtype=np.float64), (3,))
    m[0, 0], m[1, 1], m[2, 2] = v
    return m


def rotate(axis, angle_deg: float) -> np.ndarray:
    """Rotation about ``axis`` by ``angle_deg`` degrees (right-handed)."""
    axis = np.asarray(axis, dtype=np.float64)
    axis = axis / np.linalg.norm(axis)
    a = math.radians(angle_deg)
    c, s = math.cos(a), math.sin(a)
    x, y, z = axis
    r = np.array([
        [c + x * x * (1 - c), x * y * (1 - c) - z * s, x * z * (1 - c) + y * s],
        [y * x * (1 - c) + z * s, c + y * y * (1 - c), y * z * (1 - c) - x * s],
        [z * x * (1 - c) - y * s, z * y * (1 - c) + x * s, c + z * z * (1 - c)],
    ])
    m = identity()
    m[:3, :3] = r
    return m


def look_at(origin, target, up) -> np.ndarray:
    """Mitsuba's look_at: camera-space +Z points at the target, +X is left
    (matches reference transform.h Transform4f::look_at)."""
    origin = np.asarray(origin, dtype=np.float64)
    target = np.asarray(target, dtype=np.float64)
    up = np.asarray(up, dtype=np.float64)
    d = target - origin
    d = d / np.linalg.norm(d)
    left = np.cross(up / np.linalg.norm(up), d)
    left = left / np.linalg.norm(left)
    new_up = np.cross(d, left)
    m = identity()
    m[:3, 0] = left
    m[:3, 1] = new_up
    m[:3, 2] = d
    m[:3, 3] = origin
    return m


def perspective(fov_x_deg: float, near: float, far: float) -> np.ndarray:
    """Projective transform mapping the view frustum so x/y are scaled by
    1/tan(fov/2) at z (reference transform.h Transform4f::perspective)."""
    recip = 1.0 / (far - near)
    cot = 1.0 / math.tan(math.radians(fov_x_deg) / 2.0)
    m = np.zeros((4, 4), dtype=np.float64)
    m[0, 0] = cot
    m[1, 1] = cot
    m[2, 2] = far * recip
    m[2, 3] = -near * far * recip
    m[3, 2] = 1.0
    return m


# ---------------------------------------------------------------------------
# Device-side transform application (jnp, batched over lanes)
# ---------------------------------------------------------------------------

# device matrix products run at full f32 precision: the GPU's default for
# f32 matmuls may be TF32 (about three decimal digits)
_mm = functools.partial(jnp.matmul, precision=lax.Precision.HIGHEST)


def transform_point(m, p):
    """Apply affine 4x4 ``m`` (shape (...,4,4)) to points ``p`` (...,3)."""
    return _mm(m[..., :3, :3], p[..., None])[..., 0] + m[..., :3, 3]


def transform_vector(m, v):
    return _mm(m[..., :3, :3], v[..., None])[..., 0]


def transform_normal(m_inv, n):
    """Normals transform by the inverse transpose: pass the *inverse* matrix."""
    return _mm(jnp.swapaxes(m_inv[..., :3, :3], -1, -2), n[..., None])[..., 0]


def affine_inverse(m):
    """Closed-form inverse of an affine 4x4 (batched). Inverts the 3x3 block
    by adjugate and back-solves the translation — ~40 flops per lane,
    cheap enough to run per-ray for animated instances."""
    a = m[..., :3, :3]
    t = m[..., :3, 3]
    # adjugate
    c00 = a[..., 1, 1] * a[..., 2, 2] - a[..., 1, 2] * a[..., 2, 1]
    c01 = a[..., 0, 2] * a[..., 2, 1] - a[..., 0, 1] * a[..., 2, 2]
    c02 = a[..., 0, 1] * a[..., 1, 2] - a[..., 0, 2] * a[..., 1, 1]
    c10 = a[..., 1, 2] * a[..., 2, 0] - a[..., 1, 0] * a[..., 2, 2]
    c11 = a[..., 0, 0] * a[..., 2, 2] - a[..., 0, 2] * a[..., 2, 0]
    c12 = a[..., 0, 2] * a[..., 1, 0] - a[..., 0, 0] * a[..., 1, 2]
    c20 = a[..., 1, 0] * a[..., 2, 1] - a[..., 1, 1] * a[..., 2, 0]
    c21 = a[..., 0, 1] * a[..., 2, 0] - a[..., 0, 0] * a[..., 2, 1]
    c22 = a[..., 0, 0] * a[..., 1, 1] - a[..., 0, 1] * a[..., 1, 0]
    det = a[..., 0, 0] * c00 + a[..., 0, 1] * c10 + a[..., 0, 2] * c20
    inv_det = 1.0 / det
    inv3 = jnp.stack([
        jnp.stack([c00, c01, c02], axis=-1),
        jnp.stack([c10, c11, c12], axis=-1),
        jnp.stack([c20, c21, c22], axis=-1),
    ], axis=-2) * inv_det[..., None, None]
    new_t = -_mm(inv3, t[..., None])[..., 0]
    bottom = jnp.broadcast_to(
        jnp.array([0.0, 0.0, 0.0, 1.0], dtype=m.dtype), m[..., :1, :4].shape)
    top = jnp.concatenate([inv3, new_t[..., None]], axis=-1)
    return jnp.concatenate([top, bottom], axis=-2)


def animated_lerp(m0, m1, t0, t1, time):
    """Clamped component-wise matrix lerp (reference transform.h:458-466).

    ``m0``/``m1`` are (4,4); ``time`` is per-lane (...,). Returns (...,4,4).
    ``t0``/``t1`` may be traced scalars.
    """
    span = t1 - t0
    denom = jnp.where(span != 0.0, span, 1.0)
    u = jnp.clip((time - t0) / denom, 0.0, 1.0)
    return m0 * (1.0 - u[..., None, None]) + m1 * u[..., None, None]


class AnimatedTransform:
    """Host-side container: list of (time, 4x4 matrix) keyframes.

    Matches the fork's behavior: with <2 keyframes it's static; with >=2 only
    the first two keyframes participate in the lerp (reference
    transform.h:461-466 uses m_keyframes[0] and m_keyframes[1]).
    """

    def __init__(self, keyframes: List[Tuple[float, np.ndarray]] = None,
                 static_matrix: np.ndarray = None):
        self.keyframes = sorted(keyframes or [], key=lambda kv: kv[0])
        self.static_matrix = (
            static_matrix if static_matrix is not None else identity())

    @property
    def animated(self) -> bool:
        return len(self.keyframes) >= 2

    def matrices(self) -> Tuple[np.ndarray, np.ndarray, float, float]:
        """Return (m0, m1, t0, t1); static transforms repeat their matrix."""
        if not self.animated:
            m = (self.keyframes[0][1] if self.keyframes
                 else self.static_matrix)
            return m, m, 0.0, 1.0
        (t0, m0), (t1, m1) = self.keyframes[0], self.keyframes[1]
        return m0, m1, float(t0), float(t1)

    def eval(self, time: float) -> np.ndarray:
        m0, m1, t0, t1 = self.matrices()
        if not self.animated:
            return m0
        u = min(max((time - t0) / (t1 - t0), 0.0), 1.0)
        return m0 * (1.0 - u) + m1 * u

    def get_min_time(self) -> float:
        return min((t for t, _ in self.keyframes), default=0.0)

    def get_max_time(self) -> float:
        return max((t for t, _ in self.keyframes), default=0.0)


class Transform4f:
    """Chainable transform builder matching the reference Python API's
    ``mi.ScalarTransform4f`` (reference include/mitsuba/core/transform.h
    factories + python bindings): ``Transform4f().translate(a).rotate(ax,
    deg).scale(s)`` composes on the RIGHT, i.e. equals
    ``translate(a) @ rotate(ax, deg) @ scale(s)``. Instances convert to a
    plain (4,4) ndarray via ``np.asarray`` so they drop into any
    ``to_world`` slot (Properties.get_transform)."""

    def __init__(self, matrix=None):
        self.matrix = (identity() if matrix is None
                       else np.asarray(matrix, np.float64).reshape(4, 4))

    # -- chainable right-composition ---------------------------------------
    def _compose(self, m):
        return Transform4f(self.matrix @ m)

    def translate(self, v):
        return self._compose(translate(v))

    def scale(self, v):
        return self._compose(scale(v))

    def rotate(self, axis, angle):
        return self._compose(rotate(axis, angle))

    def look_at(self, origin, target, up):
        return self._compose(look_at(origin, target, up))

    def perspective(self, fov, near, far):
        return self._compose(perspective(fov, near, far))

    # -- application --------------------------------------------------------
    def transform_affine(self, p):
        """Apply to a 3-point (list/array)."""
        p = np.asarray(p, np.float64).reshape(3)
        return self.matrix[:3, :3] @ p + self.matrix[:3, 3]

    def inverse(self):
        return Transform4f(np.linalg.inv(self.matrix))

    def __matmul__(self, other):
        if isinstance(other, Transform4f):
            return Transform4f(self.matrix @ other.matrix)
        other = np.asarray(other, np.float64)
        if other.shape == (4, 4):
            return Transform4f(self.matrix @ other)
        return self.transform_affine(other)

    def __array__(self, dtype=None, copy=None):
        m = self.matrix
        return m.astype(dtype) if dtype is not None else m

    def __repr__(self):
        return f"Transform4f(\n{self.matrix})"


class _Transform4fMeta:
    """The reference spells factories on the CLASS (``T.translate(v)``)
    while instances chain (``T.translate(v).rotate(...)``). Plain Python
    can't overload classmethod-vs-method by call site, so the public
    ``ScalarTransform4f`` object is this tiny factory whose methods start
    a chain from the identity; calling it wraps/creates an instance."""

    def __call__(self, matrix=None):
        return Transform4f(matrix)

    def __getattr__(self, name):
        if name.startswith("_"):
            raise AttributeError(name)
        return getattr(Transform4f(), name)


ScalarTransform4f = _Transform4fMeta()


__all__ = [
    "identity", "translate", "scale", "rotate", "look_at", "perspective",
    "transform_point", "transform_vector", "transform_normal",
    "affine_inverse", "animated_lerp", "AnimatedTransform",
    "Transform4f", "ScalarTransform4f",
]

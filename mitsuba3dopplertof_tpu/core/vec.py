"""Component-wise 3-vector math — the wavefront's data layout.

A Vec3 is three independent (N,) arrays (structure of arrays), so every
renderer-hot op (dot/cross/normalize/transform) is plain elementwise math
on densely packed lanes that XLA fuses, with unit-stride loads per
component.

Vec3 is a pytree (NamedTuple), so it flows through jit/scan/vmap/shard_map.
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp


class Vec3(NamedTuple):
    x: jnp.ndarray
    y: jnp.ndarray
    z: jnp.ndarray

    # -- arithmetic ---------------------------------------------------------
    def __add__(self, o):
        if isinstance(o, Vec3):
            return Vec3(self.x + o.x, self.y + o.y, self.z + o.z)
        return Vec3(self.x + o, self.y + o, self.z + o)

    def __sub__(self, o):
        if isinstance(o, Vec3):
            return Vec3(self.x - o.x, self.y - o.y, self.z - o.z)
        return Vec3(self.x - o, self.y - o, self.z - o)

    def __mul__(self, o):
        if isinstance(o, Vec3):
            return Vec3(self.x * o.x, self.y * o.y, self.z * o.z)
        return Vec3(self.x * o, self.y * o, self.z * o)

    __rmul__ = __mul__

    def __truediv__(self, o):
        if isinstance(o, Vec3):
            return Vec3(self.x / o.x, self.y / o.y, self.z / o.z)
        return Vec3(self.x / o, self.y / o, self.z / o)

    def __neg__(self):
        return Vec3(-self.x, -self.y, -self.z)

    # -- constructors -------------------------------------------------------
    @staticmethod
    def full(n, vx, vy, vz, dtype=jnp.float32):
        return Vec3(jnp.full(n, vx, dtype), jnp.full(n, vy, dtype),
                    jnp.full(n, vz, dtype))

    @staticmethod
    def zeros(n, dtype=jnp.float32):
        z = jnp.zeros(n, dtype)
        return Vec3(z, z, z)

    @staticmethod
    def ones(n, dtype=jnp.float32):
        o = jnp.ones(n, dtype)
        return Vec3(o, o, o)

    @staticmethod
    def from_rows(arr):
        """From a (..., 3) numpy/jnp array (host boundary only)."""
        return Vec3(jnp.asarray(arr[..., 0]), jnp.asarray(arr[..., 1]),
                    jnp.asarray(arr[..., 2]))

    def stack(self):
        """Back to (..., 3) (host boundary only — avoid in hot code)."""
        return jnp.stack([self.x, self.y, self.z], axis=-1)


def dot(a: Vec3, b: Vec3):
    return a.x * b.x + a.y * b.y + a.z * b.z


def cross(a: Vec3, b: Vec3) -> Vec3:
    return Vec3(a.y * b.z - a.z * b.y,
                a.z * b.x - a.x * b.z,
                a.x * b.y - a.y * b.x)


def norm(a: Vec3):
    return jnp.sqrt(jnp.maximum(dot(a, a), 0.0))


def normalize(a: Vec3) -> Vec3:
    inv = jax_rsqrt(jnp.maximum(dot(a, a), 1e-30))
    return a * inv


def jax_rsqrt(x):
    import jax
    return jax.lax.rsqrt(x)


def where3(m, a: Vec3, b: Vec3) -> Vec3:
    return Vec3(jnp.where(m, a.x, b.x), jnp.where(m, a.y, b.y),
                jnp.where(m, a.z, b.z))


def vmax(a: Vec3):
    return jnp.maximum(a.x, jnp.maximum(a.y, a.z))


def lerp3(a: Vec3, b: Vec3, t) -> Vec3:
    return a * (1.0 - t) + b * t


def fma3(a: Vec3, b, c: Vec3) -> Vec3:
    """a * b + c where b is a scalar array or Vec3."""
    return a * b + c


# ---------------------------------------------------------------------------
# Component-wise affine transforms. A "cmat" is a tuple of 12 entries
# (m00..m03, m10..m13, m20..m23); each entry may be a python float, a scalar
# array, or an (N,) array — broadcasting handles all cases with zero padding
# waste (vs. the 16->128 lane pad of (N,4,4) matrices).
# ---------------------------------------------------------------------------

def cmat_from_numpy(m):
    m = [float(m[i, j]) for i in range(3) for j in range(4)]
    return tuple(m)


def cmat_lerp(c0, c1, t):
    """Clamped keyframe lerp with per-lane t in [0,1]."""
    return tuple(a * (1.0 - t) + b * t for a, b in zip(c0, c1))


def cmat_apply_point(c, p: Vec3) -> Vec3:
    return Vec3(c[0] * p.x + c[1] * p.y + c[2] * p.z + c[3],
                c[4] * p.x + c[5] * p.y + c[6] * p.z + c[7],
                c[8] * p.x + c[9] * p.y + c[10] * p.z + c[11])


def cmat_apply_vector(c, v: Vec3) -> Vec3:
    return Vec3(c[0] * v.x + c[1] * v.y + c[2] * v.z,
                c[4] * v.x + c[5] * v.y + c[6] * v.z,
                c[8] * v.x + c[9] * v.y + c[10] * v.z)


def cmat_apply_transpose_vector(c, v: Vec3) -> Vec3:
    """Apply the transpose of the 3x3 block (normal transform uses the
    transpose of the inverse)."""
    return Vec3(c[0] * v.x + c[4] * v.y + c[8] * v.z,
                c[1] * v.x + c[5] * v.y + c[9] * v.z,
                c[2] * v.x + c[6] * v.y + c[10] * v.z)


def cmat_inverse(c):
    """Closed-form affine inverse, component-wise (batched over lanes)."""
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
    det = a00 * c00 + a01 * c10 + a02 * c20
    inv = 1.0 / det
    i00, i01, i02 = c00 * inv, c01 * inv, c02 * inv
    i10, i11, i12 = c10 * inv, c11 * inv, c12 * inv
    i20, i21, i22 = c20 * inv, c21 * inv, c22 * inv
    nt0 = -(i00 * t0 + i01 * t1 + i02 * t2)
    nt1 = -(i10 * t0 + i11 * t1 + i12 * t2)
    nt2 = -(i20 * t0 + i21 * t1 + i22 * t2)
    return (i00, i01, i02, nt0, i10, i11, i12, nt1, i20, i21, i22, nt2)


def coordinate_system(n: Vec3):
    """Duff et al. orthonormal basis (see core/math.py), component-wise."""
    sign = jnp.where(n.z >= 0.0, 1.0, -1.0)
    a = -1.0 / (sign + n.z)
    b = n.x * n.y * a
    s = Vec3(1.0 + sign * n.x * n.x * a, sign * b, -sign * n.x)
    t = Vec3(b, sign + n.y * n.y * a, -n.y)
    return s, t


__all__ = [
    "Vec3", "dot", "cross", "norm", "normalize", "where3", "vmax", "lerp3",
    "fma3", "cmat_from_numpy", "cmat_lerp", "cmat_apply_point",
    "cmat_apply_vector", "cmat_apply_transpose_vector", "cmat_inverse",
    "coordinate_system",
]

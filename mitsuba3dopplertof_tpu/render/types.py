"""Wavefront record types (component-wise SoA layout).

Equivalents of the reference's Ray3f / SurfaceInteraction3f /
DirectionSample3f Dr.Jit structs (reference include/mitsuba/core/ray.h,
include/mitsuba/render/interaction.h). Every field is an (N,) array, one
component per array (see core/vec.py).
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp

from ..core.vec import Vec3, dot, norm

# Epsilons matching reference include/mitsuba/core/math.h:18-22
RAY_EPSILON = float(1.5e3 * 2.0 ** -24)       # ~8.94e-5
SHADOW_EPSILON = RAY_EPSILON * 10.0


class Ray(NamedTuple):
    o: Vec3
    d: Vec3
    time: jnp.ndarray       # (N,)
    maxt: jnp.ndarray       # (N,)


class SurfaceInteraction(NamedTuple):
    """Surface interaction record. ``valid`` replaces si.is_valid()."""
    valid: jnp.ndarray      # (N,) bool
    t: jnp.ndarray          # (N,)
    p: Vec3                 # world position
    n: Vec3                 # geometric normal (world)
    sh_n: Vec3              # shading normal (frame z)
    sh_s: Vec3              # frame tangent
    sh_t: Vec3              # frame bitangent
    uv_u: jnp.ndarray
    uv_v: jnp.ndarray
    wi: Vec3                # incident dir in local frame
    inst: jnp.ndarray       # (N,) int32 instance (-1 = miss)
    prim: jnp.ndarray       # (N,) int32 triangle index
    time: jnp.ndarray
    b_u: jnp.ndarray = None  # barycentric u (mesh_attribute interpolation)
    b_v: jnp.ndarray = None

    def to_local(self, v: Vec3) -> Vec3:
        return Vec3(dot(v, self.sh_s), dot(v, self.sh_t), dot(v, self.sh_n))

    def to_world(self, v: Vec3) -> Vec3:
        return self.sh_s * v.x + self.sh_t * v.y + self.sh_n * v.z

    # -- ray spawning (reference interaction.h:136-167) --------------------
    def _offset_p(self, d: Vec3) -> Vec3:
        mx = jnp.maximum(jnp.abs(self.p.x),
                         jnp.maximum(jnp.abs(self.p.y), jnp.abs(self.p.z)))
        mag = (1.0 + mx) * RAY_EPSILON
        mag = jnp.where(dot(self.n, d) >= 0.0, mag, -mag)
        return self.p + self.n * mag

    def spawn_ray(self, d: Vec3) -> Ray:
        return Ray(self._offset_p(d), d, self.time,
                   jnp.full(self.t.shape, jnp.inf, self.t.dtype))

    def spawn_ray_to(self, target: Vec3) -> Ray:
        o = self._offset_p(target - self.p)
        d = target - o
        dist = norm(d)
        d = d * (1.0 / jnp.maximum(dist, 1e-20))
        return Ray(o, d, self.time, dist * (1.0 - SHADOW_EPSILON))


# prim slots at or above this are analytic spheres (slot - base = sphere)
SPH_SLOT_BASE = 1 << 28


class HitRecord(NamedTuple):
    """Closest-hit payload of a ray query: everything build_si needs,
    already in world space, so shading does no per-lane gathers."""
    t: jnp.ndarray        # (N,) inf on miss
    prim: jnp.ndarray     # (N,) int32 global primitive slot (-1 miss)
    inst: jnp.ndarray     # (N,) int32 instance id (-1 miss)
    u: jnp.ndarray        # barycentrics of the hit (0 on spheres)
    v: jnp.ndarray
    gnx: jnp.ndarray      # geometric normal, world space, unnormalized
    gny: jnp.ndarray
    gnz: jnp.ndarray
    nsx: jnp.ndarray      # shading normal, world space, unnormalized
    nsy: jnp.ndarray
    nsz: jnp.ndarray
    uv_u: jnp.ndarray
    uv_v: jnp.ndarray


class DirectionSample(NamedTuple):
    """NEE sample record (reference include/mitsuba/render/records.h)."""
    p: Vec3
    n: Vec3
    d: Vec3
    dist: jnp.ndarray
    pdf: jnp.ndarray
    delta: jnp.ndarray
    emitter: jnp.ndarray    # (N,) int32 emitter index (-1 = none)


__all__ = ["Ray", "SurfaceInteraction", "DirectionSample", "HitRecord",
           "SPH_SLOT_BASE", "RAY_EPSILON", "SHADOW_EPSILON"]

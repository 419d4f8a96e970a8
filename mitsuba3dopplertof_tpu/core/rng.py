"""Counter-exact PCG32 / TEA / Kensler RNG primitives in pure uint32 jnp.

Rebuild of the reference RNG stack:
  * ``sample_tea_32``      — reference include/mitsuba/core/random.h:77
  * ``PCG32``              — drjit PCG32 (O'Neill pcg32), stateful streams used by
                             reference src/render/sampler.cpp:115-135 and
                             src/samplers/correlated.cpp:38-64
  * ``permute_kensler``    — reference include/mitsuba/core/random.h:235

Design: JAX has no mutable RNG objects, so PCG32 state is an explicit
(state_hi, state_lo, inc_hi, inc_lo) uint32 pytree threaded functionally
through the render loop.  All 64-bit arithmetic is emulated with 32-bit limbs
(16-bit partial products for the multiply) so the kernels never require
jax_enable_x64 and stay in native 32-bit integer arithmetic.

The implementation is *bitwise exact* vs. the reference: seeding a lane with
TEA(seed, lane) and drawing floats produces the identical sequence the
reference's wavefront produces, which makes golden-image comparison at equal
(seed, spp) meaningful.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp

U32 = jnp.uint32
_MASK16 = jnp.uint32(0xFFFF)

# PCG32 multiplier 0x5851F42D4C957F2D as (hi, lo) 32-bit limbs
_PCG32_MULT_HI = jnp.uint32(0x5851F42D)
_PCG32_MULT_LO = jnp.uint32(0x4C957F2D)
# PCG32_DEFAULT_STREAM = 0xDA3E39CB94B95BDB
PCG32_DEFAULT_STREAM = (0xDA3E39CB, 0x94B95BDB)


def _u32(x):
    return jnp.asarray(x, dtype=U32)


# ---------------------------------------------------------------------------
# 64-bit helpers on (hi, lo) uint32 limb pairs
# ---------------------------------------------------------------------------

def _mul32_wide(a, b):
    """Full 32x32 -> 64 bit product as (hi, lo) uint32."""
    a0 = a & _MASK16
    a1 = a >> 16
    b0 = b & _MASK16
    b1 = b >> 16
    # partial products, each fits in 32 bits
    p00 = a0 * b0
    p01 = a0 * b1
    p10 = a1 * b0
    p11 = a1 * b1
    # low 32 bits: p00 + ((p01 + p10) << 16), tracking carries
    mid = p01 + p10                       # may wrap: wrap adds 2^32 -> 2^48 = carry 0x10000 into hi
    mid_carry = jnp.where(mid < p01, jnp.uint32(0x10000), jnp.uint32(0))
    mid_lo = mid << 16
    lo = p00 + mid_lo
    lo_carry = jnp.where(lo < p00, jnp.uint32(1), jnp.uint32(0))
    hi = p11 + (mid >> 16) + mid_carry + lo_carry
    return hi, lo


def _add64(ahi, alo, bhi, blo):
    lo = alo + blo
    carry = jnp.where(lo < alo, jnp.uint32(1), jnp.uint32(0))
    hi = ahi + bhi + carry
    return hi, lo


def _mul64(ahi, alo, bhi, blo):
    """(a * b) mod 2^64 on limb pairs."""
    hi, lo = _mul32_wide(alo, blo)
    hi = hi + alo * bhi + ahi * blo
    return hi, lo


# ---------------------------------------------------------------------------
# TEA (Tiny Encryption Algorithm) hash — reference random.h:77
# ---------------------------------------------------------------------------

def sample_tea_32(v0, v1, rounds: int = 4) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Returns two uniformly distributed 32-bit integers from two inputs."""
    v0 = _u32(v0)
    v1 = _u32(v1)
    s = jnp.uint32(0)
    for _ in range(rounds):
        s = s + jnp.uint32(0x9E3779B9)
        v0 = v0 + (((v1 << 4) + jnp.uint32(0xA341316C)) ^ (v1 + s)
                   ^ ((v1 >> 5) + jnp.uint32(0xC8013EA4)))
        v1 = v1 + (((v0 << 4) + jnp.uint32(0xAD90777D)) ^ (v0 + s)
                   ^ ((v0 >> 5) + jnp.uint32(0x7E95761E)))
    return v0, v1


def sample_tea_f32(v0, v1, rounds: int = 4) -> jnp.ndarray:
    """Single uniform float in [0, 1) from TEA."""
    x, _ = sample_tea_32(v0, v1, rounds)
    return _bits_to_unit_float(x)


def _bits_to_unit_float(bits_u32) -> jnp.ndarray:
    """Map the top 23 random bits onto [0, 1) exactly like drjit:
    reinterpret (0x3F800000 | bits >> 9) as float and subtract 1."""
    f = jax.lax.bitcast_convert_type(
        jnp.uint32(0x3F800000) | (bits_u32 >> 9), jnp.float32)
    return f - jnp.float32(1.0)


# ---------------------------------------------------------------------------
# PCG32 — functional port of O'Neill's pcg32 as used by drjit / the reference
# ---------------------------------------------------------------------------

class PCG32State(NamedTuple):
    """Per-lane PCG32 stream state (all uint32 arrays of equal shape)."""
    state_hi: jnp.ndarray
    state_lo: jnp.ndarray
    inc_hi: jnp.ndarray
    inc_lo: jnp.ndarray


def _pcg32_step(s: PCG32State) -> PCG32State:
    hi, lo = _mul64(s.state_hi, s.state_lo, _PCG32_MULT_HI, _PCG32_MULT_LO)
    hi, lo = _add64(hi, lo, s.inc_hi, s.inc_lo)
    return PCG32State(hi, lo, s.inc_hi, s.inc_lo)


def pcg32_seed(initstate_hi, initstate_lo, initseq_hi, initseq_lo) -> PCG32State:
    """pcg32 seed(): state=0; inc=(initseq<<1)|1; step(); state+=initstate; step()."""
    initstate_hi = _u32(initstate_hi)
    initstate_lo = _u32(initstate_lo)
    initseq_hi = _u32(initseq_hi)
    initseq_lo = _u32(initseq_lo)
    inc_hi = (initseq_hi << 1) | (initseq_lo >> 31)
    inc_lo = (initseq_lo << 1) | jnp.uint32(1)
    z = jnp.zeros_like(inc_lo)
    s = PCG32State(z, z, inc_hi, inc_lo)
    s = _pcg32_step(s)
    hi, lo = _add64(s.state_hi, s.state_lo, initstate_hi, initstate_lo)
    s = PCG32State(hi, lo, s.inc_hi, s.inc_lo)
    return _pcg32_step(s)


def pcg32_seed_wavefront(seed_value, stream_index, seed_offset: int = 0) -> PCG32State:
    """Replicates ``PCG32Sampler::seed`` (reference sampler.cpp:115-135) /
    ``CorrelatedSampler::seed`` (correlated.cpp:44-59):
    ``(v0, v1) = sample_tea_32(seed_value + seed_offset, stream_index)`` then
    ``rng.seed(/*size*/ 1, /*initstate*/ v0, /*initseq*/ v1)`` — the 32-bit
    TEA words are zero-extended to the 64-bit pcg32 seed arguments.
    """
    v0, v1 = sample_tea_32(_u32(seed_value) + jnp.uint32(seed_offset),
                           _u32(stream_index))
    zero = jnp.zeros_like(v0)
    return pcg32_seed(zero, v0, zero, v1)


def pcg32_next_u32(s: PCG32State, active=None) -> Tuple[jnp.ndarray, PCG32State]:
    """Draw a uint32; state advances only where ``active`` (matching drjit's
    masked next_uint32, which the reference relies on for lockstep replay)."""
    old_hi, old_lo = s.state_hi, s.state_lo
    ns = _pcg32_step(s)
    if active is not None:
        ns = PCG32State(
            jnp.where(active, ns.state_hi, old_hi),
            jnp.where(active, ns.state_lo, old_lo),
            s.inc_hi, s.inc_lo)
    # xorshifted = uint32(((oldstate >> 18) ^ oldstate) >> 27)
    x_hi = old_hi >> 18
    x_lo = (old_lo >> 18) | (old_hi << 14)
    x_hi = x_hi ^ old_hi
    x_lo = x_lo ^ old_lo
    xorshifted = (x_lo >> 27) | (x_hi << 5)
    rot = old_hi >> 27  # oldstate >> 59
    out = (xorshifted >> rot) | (xorshifted << ((jnp.uint32(0) - rot) & jnp.uint32(31)))
    return out, ns


def pcg32_next_f32(s: PCG32State, active=None) -> Tuple[jnp.ndarray, PCG32State]:
    bits, ns = pcg32_next_u32(s, active)
    return _bits_to_unit_float(bits), ns


# ---------------------------------------------------------------------------
# Kensler hash-based permutation — reference random.h:235
# ---------------------------------------------------------------------------

def permute_kensler(index, sample_count: int, seed, active=None) -> jnp.ndarray:
    """Pseudorandom permutation of [0, sample_count). ``sample_count`` static."""
    if sample_count == 1:
        return jnp.zeros_like(_u32(index))
    index = _u32(index)
    seed = _u32(seed)
    if active is None:
        active = jnp.ones(jnp.shape(index), dtype=bool)
    else:
        active = jnp.broadcast_to(active, jnp.shape(index))

    w = sample_count - 1
    w |= w >> 1
    w |= w >> 2
    w |= w >> 4
    w |= w >> 8
    w |= w >> 16
    w = jnp.uint32(w)
    n = jnp.uint32(sample_count)

    def body(idx):
        tmp = idx
        tmp ^= seed
        tmp *= jnp.uint32(0xE170893D)
        tmp ^= seed >> 16
        tmp ^= (tmp & w) >> 4
        tmp ^= seed >> 8
        tmp *= jnp.uint32(0x0929EB3F)
        tmp ^= seed >> 23
        tmp ^= (tmp & w) >> 1
        tmp *= jnp.uint32(1) | (seed >> 27)
        tmp *= jnp.uint32(0x6935FA69)
        tmp ^= (tmp & w) >> 11
        tmp *= jnp.uint32(0x74DCB303)
        tmp ^= (tmp & w) >> 2
        tmp *= jnp.uint32(0x9E501CC3)
        tmp ^= (tmp & w) >> 2
        tmp *= jnp.uint32(0xC860A3DF)
        tmp &= w
        tmp ^= tmp >> 5
        return tmp

    def cond_fn(carry):
        _, act = carry
        return jnp.any(act)

    def body_fn(carry):
        idx, act = carry
        idx = jnp.where(act, body(idx), idx)
        act = act & (idx >= n)
        return idx, act

    index, _ = jax.lax.while_loop(cond_fn, body_fn, (index, active))
    return (index + seed) % n


__all__ = [
    "PCG32State", "PCG32_DEFAULT_STREAM",
    "pcg32_seed", "pcg32_seed_wavefront", "pcg32_next_u32", "pcg32_next_f32",
    "sample_tea_32", "sample_tea_f32", "permute_kensler",
]

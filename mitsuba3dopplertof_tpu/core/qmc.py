"""Quasi-Monte-Carlo low-discrepancy point utilities.

General radical-inverse machinery matching the role of the reference's
RadicalInverse class (include/mitsuba/core/qmc.h:19-183,
src/core/qmc.cpp:34-180): per-prime-base radical inverses, optional
Faure or seeded-random digit scrambling, plus the specialised base-2
bit-reversal (`radical_inverse_2`, qmc.h:189-210) and scrambled Sobol'
second dimension (`sobol_2`, qmc.h:217-232).

Design notes: all evaluators are vectorised jnp functions of an
index array; the digit loop is a *Python* loop over a static digit count
(unrolled at trace time — bases and table sizes are compile-time
constants), so everything jits with static shapes. Permutation tables are
(base,)-sized constants folded into the executable; the per-base digit
extraction uses float reciprocal-multiply exactly like the reference's
`divisor`-based integer division, but on the VPU.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

__all__ = ["primes", "RadicalInverse", "radical_inverse_2", "sobol_2"]


@functools.lru_cache(maxsize=8)
def primes(n_max: int) -> np.ndarray:
    """All primes <= n_max (Eratosthenes), ascending."""
    if n_max < 2:
        return np.zeros((0,), np.int64)
    sieve = np.ones(n_max + 1, bool)
    sieve[:2] = False
    for i in range(2, int(n_max ** 0.5) + 1):
        if sieve[i]:
            sieve[i * i:: i] = False
    return np.nonzero(sieve)[0].astype(np.int64)


def _faure_permutation(base: int) -> np.ndarray:
    """Faure's recursive digit permutation for one base (qmc.cpp:98-131
    semantics: identity-free, nested-composable permutations)."""
    if base == 2:
        return np.array([0, 1], np.int64)
    if base % 2 == 0:
        # even b: 2*perm(b/2) and 2*perm(b/2)+1 interleaved by half
        p = _faure_permutation(base // 2)
        return np.concatenate([2 * p, 2 * p + 1])
    # odd b: insert (b-1)/2 at the middle, shift others up
    p = _faure_permutation(base - 1)
    k = (base - 1) // 2
    q = p + (p >= k)
    return np.concatenate([q[: base // 2], [k], q[base // 2:]])


class RadicalInverse:
    """Radical inverse in the first `len(primes(max_base))` prime bases.

    scramble == -1 selects deterministic Faure permutations; any other
    value builds per-base random digit permutations from a seeded
    generator (reference qmc.cpp:60-96).
    """

    def __init__(self, max_base: int = 8161, scramble: int = -1):
        self._primes = primes(max_base)
        self._scramble = int(scramble)
        self._perms: dict[int, np.ndarray] = {}
        if scramble != -1:
            rng = np.random.default_rng(np.uint64(scramble))
            for b in self._primes.tolist():
                p = np.arange(b, dtype=np.int64)
                rng.shuffle(p)
                self._perms[b] = p

    @property
    def scramble(self) -> int:
        return self._scramble

    @property
    def base_count(self) -> int:
        return int(self._primes.shape[0])

    def base(self, index: int) -> int:
        return int(self._primes[index])

    def permutation(self, index: int) -> np.ndarray:
        b = self.base(index)
        if self._scramble == -1:
            return _faure_permutation(b)
        return self._perms[b]

    def _digits(self, base: int) -> int:
        # enough base-b digits to exhaust a 32-bit index
        d, cap = 0, 1
        while cap < (1 << 32):
            cap *= base
            d += 1
        return d

    def eval(self, base_index: int, index) -> jnp.ndarray:
        """Unscrambled radical inverse of `index` (uint32 array) in prime
        base `base_index` (qmc.h:54-92)."""
        b = self.base(base_index)
        n = self._digits(b)
        idx = jnp.asarray(index, jnp.uint32)
        value = jnp.zeros(idx.shape, jnp.float32)
        factor = 1.0
        # Horner-free digit accumulation: value += digit * b^-(k+1)
        for _ in range(n):
            digit = (idx % b).astype(jnp.float32)
            factor = factor / b
            value = value + digit * factor
            idx = idx // b
        return value

    def eval_scrambled(self, base_index: int, index) -> jnp.ndarray:
        """Scrambled radical inverse (qmc.h:102-156): each digit is mapped
        through the base's permutation; the trailing infinite run of
        permuted zeros sums to perm[0]/(b-1) * b^-n (geometric tail)."""
        b = self.base(base_index)
        perm = jnp.asarray(self.permutation(base_index))
        n = self._digits(b)
        idx = jnp.asarray(index, jnp.uint32)
        value = jnp.zeros(idx.shape, jnp.float32)
        factor = 1.0
        for _ in range(n):
            digit = perm[(idx % b).astype(jnp.int32)].astype(jnp.float32)
            factor = factor / b
            value = value + digit * factor
            idx = idx // b
        # compensate the permuted-zero tail beyond the n extracted digits
        tail = float(np.asarray(self.permutation(base_index))[0]) / (b - 1)
        value = value + tail * factor
        return jnp.minimum(value, 1.0 - 1e-7)


def radical_inverse_2(index, scramble=0) -> jnp.ndarray:
    """Base-2 radical inverse via bit reversal with XOR scramble
    (qmc.h:189-210): reverse the 32 bits, lay them in a float mantissa."""
    v = jnp.asarray(index, jnp.uint32)
    v = ((v >> 16) | (v << 16)) & jnp.uint32(0xFFFFFFFF)
    v = ((v & jnp.uint32(0x00FF00FF)) << 8) | ((v & jnp.uint32(0xFF00FF00)) >> 8)
    v = ((v & jnp.uint32(0x0F0F0F0F)) << 4) | ((v & jnp.uint32(0xF0F0F0F0)) >> 4)
    v = ((v & jnp.uint32(0x33333333)) << 2) | ((v & jnp.uint32(0xCCCCCCCC)) >> 2)
    v = ((v & jnp.uint32(0x55555555)) << 1) | ((v & jnp.uint32(0xAAAAAAAA)) >> 1)
    v = v ^ jnp.asarray(scramble, jnp.uint32)
    # place the top 23 reversed bits in a [1,2) float's mantissa, subtract 1
    bits = (v >> 9) | jnp.uint32(0x3F800000)
    return jax.lax.bitcast_convert_type(bits, jnp.float32) - 1.0


def sobol_2(index, scramble=0) -> jnp.ndarray:
    """Sobol' sequence second dimension with XOR scramble (qmc.h:217-232).

    The direction-number recurrence is unrolled over the 32 static bits
    (the reference uses a dr::Loop; a static unroll jits to pure
    vector ops with no loop-carried control flow).
    """
    idx = jnp.asarray(index, jnp.uint32)
    result = jnp.broadcast_to(jnp.asarray(scramble, jnp.uint32), idx.shape)
    v = 1 << 31
    for bit in range(32):
        take = (idx >> bit) & jnp.uint32(1)
        result = result ^ (take * jnp.uint32(v))
        # v_{k+1} = v_k ^ (v_k >> 1)  (second Sobol' dimension)
        v = (v ^ (v >> 1)) & 0xFFFFFFFF
    # reference float path returns scramble / 2^32 (qmc.h:232)
    return result.astype(jnp.float32) * jnp.float32(2.0 ** -32)

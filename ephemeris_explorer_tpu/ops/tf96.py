"""Triple-f32 ("tf96", ~72-bit) element-wise arithmetic.

The 3-limb force (ops/nbody_modes.pairwise_accel_limbs) removes the
position-difference rounding but still evaluates r^2, rsqrt and the mu
products in TWO-float arithmetic (~2^-47), and a Newton-refined rsqrt carries
a small systematic bias at that level.  A biased force error integrates
QUADRATICALLY in a second-order multistep, which is what dominates the
century-scale moon drift (docs/ACCURACY.md).  This module provides the
~72-bit pair math for the full-precision force path
(:func:`..ops.nbody_full3.pairwise_accel_full3`): every op keeps three f32
limbs, built from the same error-free transforms as :mod:`.eft` (raw f32 ops
are exactly rounded IEEE on every supported device).

A tf96 value is a tuple of three same-shaped f32 arrays (a pytree), limbs in
decreasing magnitude.  Not a general-purpose number type: just the ops the
pair force needs (add, mul, sqr, rsqrt, reductions, f64 lifts).
"""

from __future__ import annotations

import jax.numpy as jnp

from . import eft
from .eft import TwoFloat, quick_two_sum, two_prod, two_sqr, two_sum

K = 3


def renorm(*limbs) -> tuple:
    """Fold an (approximately magnitude-sorted) limb list into 3 limbs.

    Two bottom-up two_sum distillation sweeps concentrate the mass in the
    leading limbs; residual terms beyond the third are O(2^-72) of the head
    and fold into the last limb.  Branch-free, element-wise.
    """
    x = list(limbs)
    n = len(x)
    for _ in range(2):
        for i in range(n - 2, -1, -1):
            x[i], x[i + 1] = two_sum(x[i], x[i + 1])
    tail = x[K - 1] if n >= K else x[-1]
    for t in x[K:]:
        tail = tail + t
    out = x[: K - 1] + [tail]
    while len(out) < K:
        out.append(jnp.zeros_like(out[0]))
    # final compression pass so limbs are non-overlapping
    s1, s2 = quick_two_sum(out[1], out[2])
    s0, s1 = quick_two_sum(out[0], s1)
    s1, s2 = two_sum(s1, s2)
    return (s0, s1, s2)


def from_float(x) -> tuple:
    x = jnp.asarray(x, jnp.float32)
    z = jnp.zeros_like(x)
    return (x, z, z)


def from_two(x: TwoFloat) -> tuple:
    return (x.hi, x.lo, jnp.zeros_like(x.hi))


def from_f64(x) -> tuple:
    """Exact 3-limb lift of an f64 array (53 < 72 bits)."""
    return eft.f64_limbs(x, 3)


def to_f64(a: tuple):
    """Round to f64: sum low-to-high."""
    return a[2].astype(jnp.float64) + a[1].astype(jnp.float64) + a[0].astype(
        jnp.float64
    )


def neg(a: tuple) -> tuple:
    return tuple(-l for l in a)


def where(cond, a: tuple, b: tuple) -> tuple:
    return tuple(jnp.where(cond, x, y) for x, y in zip(a, b))


def scale_pow2(a: tuple, c: float) -> tuple:
    """Exact scaling by a power of two."""
    cf = jnp.float32(c)
    return tuple(l * cf for l in a)


def add(a: tuple, b: tuple) -> tuple:
    return renorm(a[0], b[0], a[1], b[1], a[2], b[2])


def mul(a: tuple, b: tuple) -> tuple:
    """a * b to ~2^-70 relative: exact products for the 2^0 and 2^-24 terms,
    plain f32 for the 2^-48 terms (their rounding is O(2^-72))."""
    p0, e0 = two_prod(a[0], b[0])
    p1, e1 = two_prod(a[0], b[1])
    p2, e2 = two_prod(a[1], b[0])
    o2 = a[1] * b[1] + (a[0] * b[2] + a[2] * b[0])
    o3 = a[1] * b[2] + a[2] * b[1]
    return renorm(p0, p1, p2, e0, o2, e1, e2, o3)


def sqr(a: tuple) -> tuple:
    p0, e0 = two_sqr(a[0])
    p1, e1 = two_prod(a[0], a[1])
    o2 = a[1] * a[1] + 2.0 * (a[0] * a[2])
    o3 = 2.0 * (a[1] * a[2])
    return renorm(p0, 2.0 * p1, e0, o2, 2.0 * e1, o3)


def rsqrt(x: tuple) -> tuple:
    """1/sqrt(x) to ~2^-70: f32 seed, one TwoFloat Newton (-> ~47 bits), one
    tf96 Newton (-> arithmetic precision)."""
    y0 = jnp.float32(1.0) / jnp.sqrt(x[0])
    # TwoFloat refinement on the two leading limbs
    x_tf = TwoFloat(x[0], x[1])
    y0sq = TwoFloat(*two_sqr(y0))
    xy2 = eft.mul(x_tf, y0sq)
    corr = eft.add_float(eft.mul_float(xy2, jnp.float32(-0.5)), jnp.float32(1.5))
    y1 = eft.mul(TwoFloat(y0, jnp.zeros_like(y0)), corr)
    # full tf96 refinement
    y1_3 = from_two(y1)
    t = mul(x, sqr(y1_3))
    corr3 = add(from_float(1.5), scale_pow2(t, -0.5))
    return mul(y1_3, corr3)


def tree_sum(a: tuple, axis: int) -> tuple:
    """Binary-tree tf96 reduction along `axis` (any length; odd tails fold)."""
    limbs = a
    while limbs[0].shape[axis] > 1:
        n = limbs[0].shape[axis]
        m = n // 2
        lo = tuple(jnp.take(l, jnp.arange(m), axis=axis) for l in limbs)
        hi = tuple(jnp.take(l, jnp.arange(m, 2 * m), axis=axis) for l in limbs)
        s = add(lo, hi)
        if n % 2:
            tail = tuple(jnp.take(l, jnp.arange(2 * m, n), axis=axis) for l in limbs)
            first = tuple(jnp.take(l, jnp.arange(1), axis=axis) for l in s)
            rest = tuple(jnp.take(l, jnp.arange(1, m), axis=axis) for l in s)
            merged = add(first, tail)
            s = tuple(
                jnp.concatenate([f, r], axis=axis) for f, r in zip(merged, rest)
            )
        limbs = s
    return tuple(jnp.squeeze(l, axis=axis) for l in limbs)

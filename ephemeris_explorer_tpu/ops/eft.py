"""Error-free transforms and two-float ("double-word") arithmetic.

The reference integrates in f64 and its own convergence suite
re-implements the state in double-double ("Double<T>",
``ephemeris/tests/solar_system_convergence.rs:12-110``) as evidence that
accumulation precision is the limiting factor.  This module provides the
precision ladder for the rebuild:

* ``TwoFloat`` over f32  -> ~49-bit "df64" arithmetic (the f32 force rungs
  and the expansion state's sums)
* ``TwoFloat`` over f64  -> ~106-bit "dd128" arithmetic, CPU truth runs

All ops are branch-free element-wise JAX ops built from the
classical error-free transforms (Knuth two-sum, Dekker split/two-product),
written so that XLA's FMA contraction cannot break correctness (split-based
products are exact at <=half-precision widths).

CAUTION (measured, round 2): XLA:CPU evaluates PURE-SCALAR f32 sub-DAGs
with different rounding than the identical chain on arrays — a Dekker
split of an f32[] scalar coefficient loses its low word under jit
(~2^-25 instead of ~2^-48 relative error; optimization barriers do not
help; eager mode and array operands are exact).  Rule: never feed a
"dirty" f32 scalar (one whose Dekker split is inexact) into these ops
under jit — pre-broadcast coefficients to arrays (see
integrators/multistep._wsum_cascade) or use exactly-splittable constants
(+-0.5, 1.5, +-2^k are safe).

``TwoFloat`` is a NamedTuple and therefore a pytree: it nests freely inside
``lax.scan`` carries and ``vmap``.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp


class TwoFloat(NamedTuple):
    """An unevaluated sum hi + lo with |lo| <= ulp(hi)/2."""

    hi: jax.Array
    lo: jax.Array

    @property
    def dtype(self):
        return self.hi.dtype

    @property
    def shape(self):
        return self.hi.shape

    def __neg__(self) -> "TwoFloat":
        return TwoFloat(-self.hi, -self.lo)

    def __add__(self, o):
        return add(self, o)

    def __sub__(self, o):
        return sub(self, o)

    def __mul__(self, o):
        return mul(self, o)

    def astype(self, dtype) -> "TwoFloat":
        return TwoFloat(self.hi.astype(dtype), self.lo.astype(dtype))


def _as_tf(x) -> TwoFloat:
    if isinstance(x, TwoFloat):
        return x
    x = jnp.asarray(x)
    return TwoFloat(x, jnp.zeros_like(x))


def from_float(x) -> TwoFloat:
    return _as_tf(x)


def from_f64(x, dtype=jnp.float32) -> TwoFloat:
    """Split host f64 values into an exact (hi, lo) pair of `dtype`."""
    import numpy as np

    x = np.asarray(x, dtype=np.float64)
    hi = x.astype(dtype)
    lo = (x - hi.astype(np.float64)).astype(dtype)
    return TwoFloat(jnp.asarray(hi), jnp.asarray(lo))


def to_f64(x: TwoFloat):
    """Recombine to host f64 (exact: hi and lo both convert exactly)."""
    import numpy as np

    return np.asarray(x.hi, dtype=np.float64) + np.asarray(x.lo, dtype=np.float64)


def f64_limbs(x, k: int) -> tuple:
    """Split traced f64 ``x`` into ``k`` f32 limbs, leading limb first.

    Each limb is x's remainder rounded to f32 precision IN f64
    (``reduce_precision``) and subtracted in f64; three limbs hold any
    binary64 exactly.  The obvious ``x - f64(f32(x))`` is a convert round
    trip that XLA:GPU folds to ``x - x`` (excess precision is allowed by
    default there), which zeroes every limb after the first.
    """
    limbs = []
    for _ in range(k - 1):
        head = jax.lax.reduce_precision(x, exponent_bits=8, mantissa_bits=23)
        limbs.append(head.astype(jnp.float32))
        x = x - head
    limbs.append(x.astype(jnp.float32))
    return tuple(limbs)


# ----------------------------------------------------------------------------
# Error-free transforms
# ----------------------------------------------------------------------------

def two_sum(a, b):
    """s + err == a + b exactly (Knuth/Moller, 6 flops, no branch)."""
    s = a + b
    bb = s - a
    err = (a - (s - bb)) + (b - bb)
    return s, err


def quick_two_sum(a, b):
    """s + err == a + b exactly, REQUIRES |a| >= |b| (3 flops)."""
    s = a + b
    err = b - (s - a)
    return s, err


def _split_const(dtype):
    # Dekker splitter: 2^ceil(p/2) + 1 where p = mantissa bits (24 / 53).
    if jnp.dtype(dtype) == jnp.float32:
        return jnp.float32(4097.0)  # 2^12 + 1
    return 134217729.0  # 2^27 + 1


def split(a):
    """Split a into hi + lo halves, each with <= p/2 mantissa bits (exact)."""
    c = _split_const(a.dtype) * a
    hi = c - (c - a)
    lo = a - hi
    return hi, lo


def two_prod(a, b):
    """p + err == a * b exactly (Dekker, FMA-free; safe under FMA contraction)."""
    p = a * b
    a_hi, a_lo = split(a)
    b_hi, b_lo = split(b)
    err = ((a_hi * b_hi - p) + a_hi * b_lo + a_lo * b_hi) + a_lo * b_lo
    return p, err


# ----------------------------------------------------------------------------
# TwoFloat arithmetic (Bailey/Hida QD-style, "accurate" variants)
# ----------------------------------------------------------------------------

def add(x, y) -> TwoFloat:
    x, y = _as_tf(x), _as_tf(y)
    s, e = two_sum(x.hi, y.hi)
    t, f = two_sum(x.lo, y.lo)
    e = e + t
    s, e = quick_two_sum(s, e)
    e = e + f
    return TwoFloat(*quick_two_sum(s, e))


def add_float(x: TwoFloat, b) -> TwoFloat:
    """TwoFloat + plain float (cheaper than full add)."""
    b = jnp.asarray(b, x.hi.dtype)
    s, e = two_sum(x.hi, b)
    e = e + x.lo
    return TwoFloat(*quick_two_sum(s, e))


def sub(x, y) -> TwoFloat:
    y = _as_tf(y)
    return add(x, TwoFloat(-y.hi, -y.lo))


def mul(x, y) -> TwoFloat:
    x, y = _as_tf(x), _as_tf(y)
    p, e = two_prod(x.hi, y.hi)
    e = e + (x.hi * y.lo + x.lo * y.hi)
    return TwoFloat(*quick_two_sum(p, e))


def mul_float(x: TwoFloat, b) -> TwoFloat:
    """TwoFloat * plain float.

    CAUTION: a Python-float ``b`` is coerced to x's dtype; for f32 under
    jit that makes it a "dirty" scalar whose Dekker split XLA:CPU can
    mis-round (module docstring) — pass exactly-splittable or array
    operands in f32 kernel code.  (f64 / array operands are always safe.)
    """
    b = jnp.asarray(b, x.hi.dtype)
    p, e = two_prod(x.hi, b)
    e = e + x.lo * b
    return TwoFloat(*quick_two_sum(p, e))


def float_mul(a, b) -> TwoFloat:
    """Exact product of two plain floats as a TwoFloat."""
    return TwoFloat(*two_prod(a, b))


def div(x, y) -> TwoFloat:
    x, y = _as_tf(x), _as_tf(y)
    q1 = x.hi / y.hi
    r = sub(x, mul_float(y, q1))
    q2 = r.hi / y.hi
    r = sub(r, mul_float(y, q2))
    q3 = r.hi / y.hi
    s, e = quick_two_sum(q1, q2)
    return add_float(TwoFloat(s, e), q3)


def recip(y: TwoFloat) -> TwoFloat:
    one = jnp.ones_like(y.hi)
    return div(TwoFloat(one, jnp.zeros_like(one)), y)


def sqrt(x: TwoFloat) -> TwoFloat:
    """TwoFloat square root via one Karp-Markstein refinement."""
    r = jax.lax.rsqrt(x.hi)
    h = mul_float(x, 0.5)
    s = x.hi * r  # ~ sqrt(x)
    e = sub(x, float_mul(s, s))
    s2 = e.hi * (r * 0.5)
    return add_float(TwoFloat(s, jnp.zeros_like(s)), s2)


def rsqrt(x: TwoFloat) -> TwoFloat:
    """TwoFloat reciprocal square root: Newton refinement of base rsqrt.

    One refinement in TwoFloat arithmetic doubles the ~p-bit seed to ~2p bits,
    which is exactly the TwoFloat working precision.
    """
    y0 = jax.lax.rsqrt(x.hi)
    y0_tf = TwoFloat(y0, jnp.zeros_like(y0))
    # y1 = y0 * (1.5 - 0.5 * x * y0^2)
    xy2 = mul(x, float_mul(y0, y0))
    corr = add_float(mul_float(xy2, -0.5), jnp.asarray(1.5, x.hi.dtype))
    y1 = mul(y0_tf, corr)
    # second refinement (in TwoFloat) for full 2p accuracy
    xy2 = mul(x, mul(y1, y1))
    corr = add_float(mul_float(xy2, -0.5), jnp.asarray(1.5, x.hi.dtype))
    return mul(y1, corr)


def zeros_like(x: TwoFloat) -> TwoFloat:
    return TwoFloat(jnp.zeros_like(x.hi), jnp.zeros_like(x.lo))


def where(cond, x: TwoFloat, y: TwoFloat) -> TwoFloat:
    return TwoFloat(jnp.where(cond, x.hi, y.hi), jnp.where(cond, x.lo, y.lo))


def scale_pow2(x: TwoFloat, k) -> TwoFloat:
    """Exact scaling by a power of two."""
    return TwoFloat(x.hi * k, x.lo * k)


def add_sloppy(x: TwoFloat, y: TwoFloat) -> TwoFloat:
    """Cheaper two-float add (11 flops): error ~3 ulp^2 instead of ~1.

    Right for reductions over similar-magnitude terms (e.g. per-pair force
    contributions) where the accurate variant's extra error pass buys nothing.
    """
    s, e = two_sum(x.hi, y.hi)
    e = e + (x.lo + y.lo)
    return TwoFloat(*quick_two_sum(s, e))


def two_sqr(a):
    """p + err == a * a exactly (~10 flops: one split, fewer cross terms)."""
    p = a * a
    hi, lo = split(a)
    err = ((hi * hi - p) + 2.0 * (hi * lo)) + lo * lo
    return p, err


def sqr(x: TwoFloat) -> TwoFloat:
    """x * x with the squaring shortcut (~16 flops vs mul's ~22)."""
    p, e = two_sqr(x.hi)
    e = e + 2.0 * (x.hi * x.lo)
    return TwoFloat(*quick_two_sum(p, e))


def two_prod_presplit(a, a_hi, a_lo, b, b_hi, b_lo):
    """two_prod with both operands' Dekker splits supplied (shared splits)."""
    p = a * b
    err = ((a_hi * b_hi - p) + a_hi * b_lo + a_lo * b_hi) + a_lo * b_lo
    return p, err


def mul_presplit(x: TwoFloat, xs, y: TwoFloat, ys) -> TwoFloat:
    """x * y where xs/ys are the precomputed splits of x.hi / y.hi."""
    p, e = two_prod_presplit(x.hi, xs[0], xs[1], y.hi, ys[0], ys[1])
    e = e + (x.hi * y.lo + x.lo * y.hi)
    return TwoFloat(*quick_two_sum(p, e))

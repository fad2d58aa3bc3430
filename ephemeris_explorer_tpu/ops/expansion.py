"""Fixed-size floating-point expansions over exact f32 arithmetic.

Raw f32 ops are exactly rounded IEEE arithmetic on every supported device,
so extended precision is built directly on f32: a value is an unevaluated
sum of ``K`` f32 limbs (Shewchuk/QD-style expansion), giving ~24*K
significant bits (K=4 -> ~2^-96, far beyond f64).

Only the handful of operations the long-horizon integrator state needs are
provided:

* :func:`renorm`       - Priest renormalisation (quick-two-sum sweep)
* :func:`add`          - expansion + expansion
* :func:`scale_pow2i`  - exact scaling by small +-2^k integers (the ELM2
  alpha coefficients are all in {+-1, +-2})
* :func:`from_f64` / :func:`to_f64` - exact lifts of f64 values

Everything is element-wise jnp, vmappable and scan-friendly; an expansion is
a tuple of K same-shaped f32 arrays (a pytree).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from .eft import f64_limbs, two_sum

K = 4  # limbs


def zeros(shape) -> tuple:
    z = jnp.zeros(shape, jnp.float32)
    return (z,) * K


def renorm(*limbs) -> tuple:
    """Renormalise a limb list to K non-overlapping-ish limbs.

    Two bottom-up two_sum sweeps (distillation cascade) push the mass into
    the leading limbs; terms beyond K are folded into the last limb (they are
    O(ulp^K) of the head by then).  Branch-free and element-wise.
    """
    x = list(limbs)
    n = len(x)
    for _ in range(3):
        for i in range(n - 2, -1, -1):
            x[i], x[i + 1] = two_sum(x[i], x[i + 1])
    tail = x[K - 1] if n >= K else x[-1]
    for t in x[K:]:
        tail = tail + t
    out = x[: K - 1] + [tail]
    while len(out) < K:
        out.append(jnp.zeros_like(out[0]))
    return tuple(out[:K])


def add(a: tuple, b: tuple) -> tuple:
    """Expansion + expansion -> K-limb expansion.

    Limbs are interleaved (a0 b0 a1 b1 ...) so the distillation sweeps see a
    near-sorted sequence."""
    merged = []
    for x, y in zip(a, b):
        merged.append(x)
        merged.append(y)
    return renorm(*merged)


def from_two(hi, lo) -> tuple:
    z = jnp.zeros_like(hi)
    return (hi, lo, z, z)


def from_f64_host(x) -> tuple:
    """EXACT host-side limb split of IEEE f64 (numpy) values: three f32
    limbs represent any binary64 exactly, and f32 transfers are exact, so
    the device state starts bit-for-bit at the host's initial conditions
    (an initial-condition error of even a few micrometres shifts a close
    moon's semi-major axis into a secular along-track drift,
    docs/ACCURACY.md)."""
    import numpy as np

    x = np.asarray(x, np.float64)
    limbs = []
    for _ in range(K - 1):
        l = x.astype(np.float32)
        limbs.append(l)
        x = x - l.astype(np.float64)
    limbs.append(x.astype(np.float32))  # zero for f64 input (3 limbs exact)
    return tuple(jnp.asarray(l) for l in limbs)


def from_f64(x) -> tuple:
    """Exact lift of an f64 array into f32 limbs."""
    a0, a1, a2 = f64_limbs(x, 3)
    return (a0, a1, a2, jnp.zeros_like(a2))


def to_f64(a: tuple):
    """Round an expansion to f64: sum low-to-high."""
    out = a[-1].astype(jnp.float64)
    for x in a[-2::-1]:
        out = out + x.astype(jnp.float64)
    return out


def hi_lo(a: tuple):
    """The two leading limbs - a ready-made df64 pair."""
    return a[0], a[1]


def scale_pow2i(a: tuple, c: float) -> tuple:
    """Exact scaling by +-2^k (the ELM2 alpha coefficients): per-limb."""
    cf = jnp.float32(c)
    return tuple(x * cf for x in a)


def neg(a: tuple) -> tuple:
    return tuple(-x for x in a)

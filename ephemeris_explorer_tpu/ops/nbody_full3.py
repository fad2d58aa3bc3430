"""Full 3-limb pairwise gravity: the highest-precision force path.

Same reference semantics as :func:`.nbody.pairwise_accel`
(``ephemeris/src/propagators/nbody.rs:16-39``: zero softening, mu-weighted
inverse-cube), but EVERY pair operation — the position difference, r^2, the
reciprocal square root, the mu product and the row reduction — runs in
triple-f32 (:mod:`.tf96`, ~2^-70) arithmetic, so the f64 result is unbiased
to well below its own representation.  This removes the ~2^-47 systematic
component of the two-float pipeline (a biased force error grows
quadratically through a second-order multistep; see docs/ACCURACY.md).

Intended for the ACCURACY configurations (N <= a few hundred): the dense
(N, N) tf96 intermediates are fine at that scale and XLA fuses the whole
thing.  Large N stays on the native-f64 force (ops/nbody.py).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from . import tf96
from .eft import two_sum


def pairwise_accel_full3(l0, l1, l2, mu) -> jax.Array:
    """Accelerations from 3-limb f32 positions, full tf96 pair math.

    l0/l1/l2: (N, 3) f32 position limbs (leading limbs of the integrator's
    f32 expansion state, :mod:`..ops.expansion`).
    mu: (N,) f64 gravitational parameters.
    Returns f64 (N, 3) accelerations.
    """
    n = l0.shape[0]
    mu3 = tf96.from_f64(jnp.asarray(mu))
    mu3 = tuple(m[None, :] for m in mu3)  # (1, N): source weights
    eye = jnp.eye(n, dtype=bool)

    # error-free pair differences d[c][i, j] = p_j - p_i, folded to 3 limbs
    d = []
    for c in range(3):
        a0, a1, a2 = l0[:, c], l1[:, c], l2[:, c]
        s0, e0 = two_sum(a0[None, :], -a0[:, None])
        s1, e1 = two_sum(a1[None, :], -a1[:, None])
        s2 = a2[None, :] - a2[:, None]
        d.append(tf96.renorm(s0, s1, e0, e1, s2))

    r2 = tf96.add(tf96.add(tf96.sqr(d[0]), tf96.sqr(d[1])), tf96.sqr(d[2]))
    r2 = tf96.where(eye, tf96.from_float(jnp.ones((n, n), jnp.float32)), r2)

    # Per-pair exact power-of-two normalisation: u^3 spans ~1e-9..1e-29
    # (km^-3) across the solar system, so its tf96 tail limbs (value * 2^-48
    # .. 2^-70) would underflow f32 normals and silently degrade to two-limb
    # precision.  Compute rsqrt in a [0.5, 2) space and fold the 2^-3k scale
    # in AFTER the mu and displacement products, where magnitudes are sane.
    _, e = jnp.frexp(r2[0])
    k = e // 2
    one = jnp.ones_like(r2[0])
    s2 = jnp.ldexp(one, -2 * k)
    s3 = jnp.ldexp(one, -3 * k)
    r2n = tuple(l * s2 for l in r2)       # exact: power-of-two scaling

    un = tf96.rsqrt(r2n)                   # ~1
    u3n = tf96.mul(tf96.sqr(un), un)       # = r^-3 * 2^{3k}
    wn = tf96.mul(u3n, mu3)
    zero = jnp.zeros((n, n), jnp.float32)
    wn = tf96.where(eye, (zero, zero, zero), wn)

    acc = []
    for c in range(3):
        term = tf96.mul(wn, d[c])          # (N, N), scaled by 2^{3k}
        term = tuple(l * s3 for l in term)  # exact de-scaling
        acc.append(tf96.to_f64(tf96.tree_sum(term, axis=1)))
    return jnp.stack(acc, axis=-1)

"""Pairwise Newtonian gravity: the O(N^2) hot kernel.

Reference semantics (``ephemeris/src/propagators/nbody.rs:16-39`` via the
``particular`` crate's ``AccelerationPaired``): zero softening, mu-weighted
inverse-cube,

    a_i = sum_{j != i}  mu_j * (r_j - r_i) / |r_j - r_i|^3

with state in km, km/s and mu in km^3/s^2.

Instead of the reference's scalar i<j pair loop, :func:`pairwise_accel`
builds the full (N, N, 3) antisymmetric displacement tensor and reduces it;
XLA fuses this into a few loop kernels in native f64.  It is the plain
reference every other force is checked against.  :func:`pairwise_accel_auto`
is the production entry: it sends large systems on a GPU to the hand-written
Pallas kernel (ops/pallas_nbody.py).  A row-tiled variant bounds the
scratch memory for very large N.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def pairwise_accel(pos: jax.Array, mu: jax.Array) -> jax.Array:
    """Accelerations of N massive bodies.

    pos: (N, 3) positions [km]; mu: (N,) gravitational parameters [km^3/s^2].
    Returns (N, 3) accelerations [km/s^2].
    """
    n = pos.shape[0]
    d = pos[None, :, :] - pos[:, None, :]          # d[i, j] = r_j - r_i
    r2 = jnp.sum(d * d, axis=-1)                   # (N, N)
    eye = jnp.eye(n, dtype=bool)
    r2 = jnp.where(eye, 1.0, r2)
    inv_r = jax.lax.rsqrt(r2)
    inv_r3 = jnp.where(eye, 0.0, inv_r * inv_r * inv_r)
    w = mu[None, :] * inv_r3                       # (N, N): weight of j on i
    # multiply+sum, not einsum: XLA fuses it with the weight chain
    return (d * w[:, :, None]).sum(axis=1)


# From this many bodies on, the Pallas kernel beats XLA's fusion of
# pairwise_accel on the GPU: the two tie at N=3584 and XLA's rate falls
# 3.8x by N=4096, the kernel's does not (H100, PERF.md).
PALLAS_MIN_BODIES = 4096


def pairwise_accel_auto(pos: jax.Array, mu: jax.Array) -> jax.Array:
    """:func:`pairwise_accel` through the faster kernel for the lowering
    platform: the Pallas kernel on a GPU from ``PALLAS_MIN_BODIES`` bodies
    on, XLA's fusion everywhere else.  The choice is made when the program
    is lowered, so a CPU-committed trace on a GPU host takes the XLA path.
    """
    if pos.shape[0] < PALLAS_MIN_BODIES:
        return pairwise_accel(pos, mu)
    from . import pallas_nbody

    return jax.lax.platform_dependent(
        pos, mu, cuda=pallas_nbody.pairwise_accel, default=pairwise_accel
    )


def accel_at(pos: jax.Array, mu: jax.Array, at: jax.Array) -> jax.Array:
    """Acceleration felt by massless probes at `at` (..., 3) from N bodies.

    Mirrors ``particular``'s ``AccelerationAt`` used by the spacecraft context
    (ephemeris_explorer/src/dynamics/spacecraft.rs:71-74): zero softening.
    """
    d = pos - at[..., None, :]                     # (..., N, 3)
    r2 = jnp.sum(d * d, axis=-1)
    inv_r = jax.lax.rsqrt(r2)
    inv_r3 = inv_r * inv_r * inv_r
    return jnp.sum(d * (mu * inv_r3)[..., None], axis=-2)


def pairwise_accel_tiled(pos: jax.Array, mu: jax.Array, tile: int = 512) -> jax.Array:
    """Row-tiled variant: processes `tile` receivers at a time via lax.map.

    Same math as :func:`pairwise_accel` with O(tile * N) peak memory instead
    of O(N^2); preferable for very large N where the (N, N, 3) displacement
    tensor would not fit in HBM comfortably.
    """
    n = pos.shape[0]
    assert n % tile == 0, "N must be divisible by tile"
    idx = jnp.arange(n)

    def row_block(start):
        p_i = jax.lax.dynamic_slice_in_dim(pos, start, tile)      # (tile, 3)
        d = pos[None, :, :] - p_i[:, None, :]                      # (tile, N, 3)
        r2 = jnp.sum(d * d, axis=-1)
        self_mask = idx[None, :] == (start + jnp.arange(tile))[:, None]
        r2 = jnp.where(self_mask, 1.0, r2)
        inv_r = jax.lax.rsqrt(r2)
        inv_r3 = jnp.where(self_mask, 0.0, inv_r * inv_r * inv_r)
        w = mu[None, :] * inv_r3
        return jnp.einsum("ij,ijc->ic", w, d)

    starts = jnp.arange(0, n, tile)
    blocks = jax.lax.map(row_block, starts)                        # (n/tile, tile, 3)
    return blocks.reshape(n, 3)


def pairwise_accel_dd(pos, mu: jax.Array):
    """O(N^2) pairwise acceleration in double-double (TwoFloat over f64).

    The truth-grade force: every stage of the pair chain — displacement,
    r^2, rsqrt, mu product, accumulation — runs in ~2^-106 double-double
    arithmetic (ops/eft.py over f64), so the result is the correctly-
    rounded-for-all-practical-purposes real-number force of the f64 model
    inputs.  Intended to MEASURE
    the plain-f64-force truth's own rounding envelope (the reference's
    Double<T> convergence fixture, solar_system_convergence.rs:12-110,
    compensates only the state — its forces are plain f64, like the round-2
    `dd` truth here).

    pos: TwoFloat of (N, 3) f64; mu: (N,) plain f64 (model inputs, exact).
    Returns a TwoFloat of (N, 3).  CPU-oriented (small N); O(N^2) temps.

    .. warning:: MEASURED HAZARD on XLA:CPU (this jaxlib): (1) jitting this
       function flat — or inside a plain scan body — compiles for >60 min
       / >28 GB RSS (LLVM-side pathology; only scan-wrapped *startup*-sized
       graphs compile), and (2) the code XLA:CPU does emit for the full
       composition silently loses the compensation of the PRODUCT chains:
       end-to-end force comes out ~1e-15 relative (plain-f64 grade) vs the
       f128 oracle, although every EFT primitive compiles exactly in
       isolation.  The production truth path therefore lives in
       ephemeris_explorer_tpu/truth_np.py (pure numpy, verified ~3e-19,
       f128-oracle-limited); this jnp variant is kept for backends where
       the emitted arithmetic can be re-validated first.
    """
    from . import eft
    from .eft import TwoFloat

    n = pos.hi.shape[0]
    # component-major (N, N) pair arrays: a stride-3 minor axis defeats
    # XLA:CPU vectorization of the long EFT chains (measured ~16x slower)
    dc = []
    for c in range(3):
        pj = TwoFloat(pos.hi[None, :, c], pos.lo[None, :, c])
        pi = TwoFloat(pos.hi[:, c, None], pos.lo[:, c, None])
        dc.append(eft.sub(pj, pi))                       # (N, N)
    r2 = eft.add(eft.add(eft.sqr(dc[0]), eft.sqr(dc[1])), eft.sqr(dc[2]))
    eye = jnp.eye(n, dtype=bool)
    one = jnp.ones_like(r2.hi)
    r2 = eft.where(eye, TwoFloat(one, jnp.zeros_like(one)), r2)
    u = eft.rsqrt(r2)
    u3 = eft.mul(eft.sqr(u), u)                          # 1/r^3
    w = eft.mul_float(u3, mu[None, :])                   # (N, N)
    zero = jnp.zeros_like(w.hi)
    w = eft.where(eye, TwoFloat(zero, zero), w)

    # dd accumulation over sources: pad j to a power of two and tree-reduce
    # with the accurate add (per-pair terms can cancel between near pairs)
    def tree_sum(x):
        m = 1
        while m < x.hi.shape[1]:
            m *= 2
        pad = m - x.hi.shape[1]
        hi = jnp.pad(x.hi, ((0, 0), (0, pad)))
        lo = jnp.pad(x.lo, ((0, 0), (0, pad)))
        while hi.shape[1] > 1:
            half = hi.shape[1] // 2
            s = eft.add(
                TwoFloat(hi[:, :half], lo[:, :half]),
                TwoFloat(hi[:, half:], lo[:, half:]),
            )
            hi, lo = s.hi, s.lo
        return TwoFloat(hi[:, 0], lo[:, 0])

    comps = [tree_sum(eft.mul(w, c)) for c in dc]        # 3 x (N,)
    return TwoFloat(
        jnp.stack([c.hi for c in comps], axis=-1),
        jnp.stack([c.lo for c in comps], axis=-1),
    )


def energy(pos: jax.Array, vel: jax.Array, mu: jax.Array) -> jax.Array:
    """Specific total energy sum(mu_i v_i^2)/2 - sum_{i<j} mu_i mu_j / r_ij.

    (Up to the gravitational constant; useful as a conservation diagnostic.)
    """
    n = pos.shape[0]
    ke = 0.5 * jnp.sum(mu * jnp.sum(vel * vel, axis=-1))
    d = pos[None, :, :] - pos[:, None, :]
    r = jnp.sqrt(jnp.sum(d * d, axis=-1))
    iu = jnp.triu_indices(n, k=1)
    pe = -jnp.sum((mu[:, None] * mu[None, :])[iu] / r[iu])
    return ke + pe

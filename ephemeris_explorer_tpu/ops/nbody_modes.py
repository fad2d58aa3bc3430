"""The force precision ladder around the native-f64 force, in plain jnp.

:func:`.nbody.pairwise_accel` (native f64, ~2^-53) is the production force.
The rungs here trade accuracy against cost in either direction, all with
the reference semantics of ``ephemeris/src/propagators/nbody.rs:16-39``
(zero softening, mu-weighted inverse cube) and all elementwise over dense
(N, N) pair arrays that XLA fuses:

* :func:`pairwise_accel_f32` - plain f32 pair math (~1e-6 relative; the
  close-pair difference cancels to ~1e-3 in the worst geometry);
* :func:`pairwise_accel_mixed` - error-free f32 pair differences from
  split (hi, lo) positions, f32 weight chain: ~1e-6 for EVERY geometry;
* :func:`pairwise_accel_split` - f32 weak tail plus each body's K strongest
  attractors in f64 (~1e-9 on dominated hierarchies);
* :func:`pairwise_accel_limbs` - 3-limb f32 positions with error-free pair
  differences and a two-float (~2^-48) pair chain: the force of the
  ``extended3`` engine, whose state carries more than f64 holds.

Every f32 product here is an elementwise multiply and sum, never a dot, so
no tensor-core TF32 rounding enters.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from . import eft
from .eft import TwoFloat


def _sqr_presplit(x: TwoFloat, xs) -> TwoFloat:
    """x*x with a precomputed split of x.hi (shared with other products)."""
    p = x.hi * x.hi
    err = ((xs[0] * xs[0] - p) + 2.0 * (xs[0] * xs[1])) + xs[1] * xs[1]
    err = err + 2.0 * (x.hi * x.lo)
    return TwoFloat(*eft.quick_two_sum(p, err))


def _dd_tree_sum(x: TwoFloat, axis: int = -1) -> TwoFloat:
    """Binary-tree two-float reduction along `axis`, zero-padded to a power
    of two (zero terms add exactly)."""
    n = x.hi.shape[axis]
    m = 1 << max(n - 1, 0).bit_length()
    hi, lo = x.hi, x.lo
    if m != n:
        pad = [(0, 0)] * hi.ndim
        pad[axis] = (0, m - n)
        hi, lo = jnp.pad(hi, pad), jnp.pad(lo, pad)
    while hi.shape[axis] > 1:
        h = hi.shape[axis] // 2
        a = TwoFloat(jax.lax.slice_in_dim(hi, 0, h, axis=axis),
                     jax.lax.slice_in_dim(lo, 0, h, axis=axis))
        b = TwoFloat(jax.lax.slice_in_dim(hi, h, 2 * h, axis=axis),
                     jax.lax.slice_in_dim(lo, h, 2 * h, axis=axis))
        s = eft.add_sloppy(a, b)
        hi, lo = s.hi, s.lo
    return TwoFloat(hi, lo)


def _rsqrt_df(x: TwoFloat) -> TwoFloat:
    """Two-float rsqrt: f32 seed + one Newton refinement in two-float.

    The refinement takes the 24-bit seed to ~47 bits.  It exploits the
    seed's zero low part: y0^2 is a single errorless square and y0 * corr
    a float-by-TwoFloat product.

    The plain Newton step y0*(1.5 - s/2) with s = x*y0^2 lands at
    y_true*(1 - 1.5 d^2) for seed error d — a SYSTEMATIC undershoot
    (~2^-49 mean) that integrates QUADRATICALLY through a second-order
    multistep (docs/ACCURACY.md).  Folding the next Taylor term of
    (1+(s-1))^-1/2, +(3/8)(s-1)^2, into corr.lo costs 3 f32 ops and
    measures 22x less bias (-2^-49.3 -> -2^-53.7).
    """
    y0 = jax.lax.rsqrt(x.hi)
    y0sq = TwoFloat(*eft.two_sqr(y0))
    xy2 = eft.mul(x, y0sq)
    # s - 1: (s.hi - 1) is EXACT in f32 (Sterbenz, s within [0.5, 2]); s.lo
    # is the same order as s - 1 (~2^-23) so it must fold in, but plain
    # addition suffices — the correction only needs t to f32 accuracy
    t = (xy2.hi - jnp.float32(1.0)) + xy2.lo
    corr = eft.add_float(eft.mul_float(xy2, jnp.float32(-0.5)), jnp.float32(1.5))
    corr = TwoFloat(corr.hi, corr.lo + jnp.float32(0.375) * t * t)
    y = TwoFloat(*eft.two_prod(y0, corr.hi))
    return TwoFloat(*eft.quick_two_sum(y.hi, y.lo + y0 * corr.lo))


def split_f64(x):
    """Split an f64 array into exact-sum (hi, lo) f32 parts (~2^-48)."""
    return eft.f64_limbs(x, 2)


# ---------------------------------------------------------------------------
# 3-limb positions, two-float pair chain (the extended3 force)
# ---------------------------------------------------------------------------


@jax.jit
def pairwise_accel_limbs(l0, l1, l2, mu) -> jax.Array:
    """O(N^2) acceleration from 3-limb f32 positions, returned in f64.

    With two-limb inputs the pair displacement d = p_j - p_i inherits the
    POSITION rounding (~|p| 2^-48), which for close pairs (Phobos-Mars:
    |d|/|p| ~ 5e-5) is a ~1e-10 RELATIVE error on d.  Differencing three
    limbs with error-free transforms makes d accurate to ~2^-48 of |d|.

    l0/l1/l2: (N, 3) f32 limb arrays (leading limbs of an f32 expansion);
    mu: (N,) f64.
    """
    n = l0.shape[0]
    eye = jnp.eye(n, dtype=bool)
    d = []
    for c in range(3):
        s0, e0 = eft.two_sum(l0[None, :, c], -l0[:, None, c])
        s1, e1 = eft.two_sum(l1[None, :, c], -l1[:, None, c])
        s2 = l2[None, :, c] - l2[:, None, c]
        dd = eft.add_sloppy(TwoFloat(s0, e0), TwoFloat(s1, e1))
        d.append(eft.add_float(dd, s2))                      # (N, N)

    # share the Dekker splits of d.hi between the r^2 squares and the final
    # w*d products; the three squares are non-negative, so sloppy adds lose
    # nothing
    d_splits = [eft.split(dc.hi) for dc in d]
    r2 = eft.add_sloppy(
        eft.add_sloppy(
            _sqr_presplit(d[0], d_splits[0]), _sqr_presplit(d[1], d_splits[1])
        ),
        _sqr_presplit(d[2], d_splits[2]),
    )
    one = jnp.ones_like(r2.hi)
    r2 = eft.where(eye, TwoFloat(one, jnp.zeros_like(one)), r2)

    mu_hi, mu_lo = split_f64(mu)
    mu2 = TwoFloat(mu_hi[None, :], mu_lo[None, :])
    u = _rsqrt_df(r2)                                        # 1/r
    # w = (u^2 * mu) * u, NOT (u^2 * u) * mu: u^3 alone spans down to
    # ~5e-30 km^-3 for the most distant solar-system pairs and the dd
    # correction terms of its final mul land f32-SUBNORMAL, which a
    # flush-to-zero device drops (the Sun->Pluto term degraded to 1.2e-9
    # relative).  Folding mu in FIRST keeps every intermediate normal.
    w = eft.mul(eft.mul(eft.sqr(u), mu2), u)
    zero = jnp.zeros_like(w.hi)
    w = eft.where(eye, TwoFloat(zero, zero), w)
    w_split = eft.split(w.hi)

    out = []
    for c in range(3):
        term = eft.mul_presplit(w, w_split, d[c], d_splits[c])
        s = _dd_tree_sum(term, axis=1)                      # (N, 1)
        out.append(s.hi[:, 0].astype(jnp.float64) + s.lo[:, 0].astype(jnp.float64))
    return jnp.stack(out, axis=-1)


# ---------------------------------------------------------------------------
# f32 and mixed rungs
# ---------------------------------------------------------------------------


def _f32_weights(d, mu32, skip):
    """mu_j / r^3 in f32 with one Newton refinement of the rsqrt seed."""
    r2 = d[0] * d[0] + d[1] * d[1] + d[2] * d[2]
    r2 = jnp.where(skip, jnp.float32(1.0), r2)
    u = jax.lax.rsqrt(r2)
    u = u * (jnp.float32(1.5) - jnp.float32(0.5) * r2 * u * u)
    return jnp.where(skip, jnp.float32(0.0), mu32[None, :] * (u * u * u))


def _f32_sum(w, d):
    return jnp.stack([jnp.sum(w * dc, axis=1) for dc in d], axis=-1)


@jax.jit
def pairwise_accel_f32(pos, mu) -> jax.Array:
    """Plain f32 pair math: (N, 3) f32 positions, (N,) f32 mu, f32 out."""
    d = [pos[None, :, c] - pos[:, None, c] for c in range(3)]
    eye = jnp.eye(pos.shape[0], dtype=bool)
    return _f32_sum(_f32_weights(d, mu, eye), d)


@jax.jit
def pairwise_accel_mixed(pos_hi, pos_lo, mu) -> jax.Array:
    """Mixed precision: (N, 3) split f32 positions (:func:`split_f64`),
    (N,) f32 mu, f32 out.

    Rounding positions to f32 costs |p| * 2^-24 absolute, which for close
    pairs (|d|/|p| ~ 5e-5) is a ~1e-3 RELATIVE error on d.  Here d is the
    f32 rounding of the EXACT (hi + lo) difference (one error-free two_sum
    per component), so every pair keeps ~2^-24 of |d| and the force holds
    ~1e-6 relative for every geometry.
    """
    d = []
    for c in range(3):
        s, e = eft.two_sum(pos_hi[None, :, c], -pos_hi[:, None, c])
        d.append(s + (e + (pos_lo[None, :, c] - pos_lo[:, None, c])))
    eye = jnp.eye(pos_hi.shape[0], dtype=bool)
    return _f32_sum(_f32_weights(d, mu, eye), d)


# ---------------------------------------------------------------------------
# Magnitude-split mode (~1e-9 for hierarchical systems)
# ---------------------------------------------------------------------------
#
# Plain f32 pair math for the weak tail, f64 for each body's K strongest
# attractors.  The selection criterion is the f32 ERROR model: rounding the
# positions to f32 perturbs each pair difference by ~|p| * 2^-24 ABSOLUTE,
# so the induced acceleration error is ~mu_j / r^3 * |p| * 2^-24 - the
# pairs that hurt are the largest-WEIGHT (mu_j / r^3) pairs: close pairs
# and dominant attractors.  Removing the top-K weights per row from the f32
# sum (an int8 exclusion mask) and adding them back from a gathered (N, K)
# f64 computation deletes both failure modes; a masked pair contributes to
# exactly one of the two passes.
#
# Error floor: the surviving weak tail's per-pair f32 roundings.  For a
# dominated hierarchy (a solar system) that is ~2^-24 of a small fraction of
# the total: measured ~1e-9.  For an unstructured random cloud the floor is
# ~2^-24 relative (~5e-8).  The strong set moves on orbital timescales;
# refresh it per chunk (strong_pair_indices), not per step.


def _masked_f32(pos, mu, skip, rows):
    """f32 sum over the pairs not excluded by ``skip`` (NL, N) bool, which
    must exclude each receiver's own (global) column."""
    p = pos.astype(jnp.float32)
    r = rows.astype(jnp.float32)
    d = [p[None, :, c] - r[:, None, c] for c in range(3)]
    return _f32_sum(_f32_weights(d, mu.astype(jnp.float32), skip), d)


@jax.jit
def pairwise_accel_f32_masked(pos, mu, mask) -> jax.Array:
    """The f32 rung with per-pair exclusions: ``mask[i, j] != 0`` pairs
    contribute zero.  pos (N, 3), mu (N,), mask (N, N) int8; the self
    pairs are excluded whether or not the mask carries them.  f32 out."""
    eye = jnp.eye(pos.shape[0], dtype=bool)
    return _masked_f32(pos, mu, (mask != 0) | eye, pos)


@jax.jit
def pairwise_accel_f32_masked_rows(pos, mu, mask, rows) -> jax.Array:
    """Rectangular (row-shardable) masked f32 sum: pos (N, 3) ALL sources,
    rows (NL, 3) local receivers, mask (NL, N) with the GLOBAL self column
    (:func:`strong_pair_mask_rows`).  Per-row arithmetic equals the square
    form's."""
    return _masked_f32(pos, mu, mask != 0, rows)


@partial(jax.jit, static_argnames=("k",))
def strong_pair_indices(pos, mu, k: int = 16):
    """Per-row top-k columns by weight mu_j / r_ij^3 - the f32 error
    criterion (see the section comment).  pos (N, 3), mu (N,); returns
    (N, k) int32 column indices, self excluded.  O(N^2) scratch: run per
    chunk, not per step."""
    # k == n would let top_k select the -inf self entry, so idx would
    # contain i itself and the f64 correction would divide by r2 == 0
    assert k < pos.shape[0], f"strong set k={k} must be < n={pos.shape[0]}"
    return strong_pair_indices_rows(pos, pos, mu, jnp.int32(0), k=k)


def strong_pair_mask(idx, n: int):
    """(N, N) int8 exclusion table: 1 at each (i, idx[i, k]) AND the self
    diagonal."""
    return strong_pair_mask_rows(idx, n, jnp.int32(0))


@partial(jax.jit, static_argnames=("k",))
def strong_pair_indices_rows(pos, rows, mu, row0, k: int = 16):
    """Rectangular `strong_pair_indices`: top-k GLOBAL columns for the
    local receiver rows.  pos (N, 3) all sources, rows (NL, 3) local
    receivers at global offset ``row0`` (traced scalar), mu (N,).
    Row-independent, so a row decomposition matches the square result
    bitwise."""
    assert k < pos.shape[0]
    p = pos.astype(jnp.float32)
    r = rows.astype(jnp.float32)
    d = p[None, :, :] - r[:, None, :]                       # (NL, N, 3)
    r2 = jnp.sum(d * d, axis=-1)
    nl = r.shape[0]
    self_ = (
        jnp.arange(pos.shape[0], dtype=jnp.int32)[None, :]
        == (row0 + jnp.arange(nl, dtype=jnp.int32))[:, None]
    )
    r2 = jnp.where(self_, jnp.float32(1.0), r2)
    s = mu.astype(jnp.float32)[None, :] * jax.lax.rsqrt(r2) ** 3
    s = jnp.where(self_, jnp.float32(-jnp.inf), s)
    _, idx = jax.lax.top_k(s, k)
    return idx.astype(jnp.int32)


def strong_pair_mask_rows(idx, n: int, row0):
    """Rectangular `strong_pair_mask`: (NL, N) exclusion table for local
    rows, self diagonal at the GLOBAL column row0 + i."""
    rows = jnp.arange(idx.shape[0], dtype=idx.dtype)[:, None]
    m = jnp.zeros((idx.shape[0], n), jnp.int8).at[rows, idx].set(jnp.int8(1))
    return m.at[rows[:, 0], row0 + rows[:, 0]].set(jnp.int8(1))


def _strong_correction(pos, mu, idx, rows=None):
    """f64 acceleration from each receiver's strong set: gathered (NL, K)
    pair math.  ``rows`` (NL, 3) selects the rectangular form, with ``idx``
    holding GLOBAL source columns into ``pos``."""
    rows = pos if rows is None else rows
    d = pos[idx] - rows[:, None, :]                          # (NL, K, 3)
    r2 = jnp.sum(d * d, axis=-1)
    w = mu[idx] / (r2 * jnp.sqrt(r2))                        # mu_j / r^3
    return jnp.sum(w[..., None] * d, axis=1)


@jax.jit
def pairwise_accel_split(pos, mu, idx, mask) -> jax.Array:
    """Magnitude-split O(N^2) acceleration: f64 (N, 3) positions in, f64
    (N, 3) accelerations out.  idx/mask from strong_pair_indices /
    strong_pair_mask on a recent snapshot (refresh per chunk)."""
    a32 = pairwise_accel_f32_masked(pos, mu, mask)
    return _strong_correction(pos, mu, idx) + a32.astype(pos.dtype)


@jax.jit
def pairwise_accel_split_rows(pos, rows, mu, idx, mask) -> jax.Array:
    """Rectangular (row-shardable) magnitude-split acceleration: pos (N, 3)
    ALL bodies, rows (NL, 3) local receivers, idx (NL, K) GLOBAL strong
    columns (`strong_pair_indices_rows`), mask (NL, N) with the global
    diagonal (`strong_pair_mask_rows`).  Returns (NL, 3) f64."""
    a32 = pairwise_accel_f32_masked_rows(pos, mu, mask, rows)
    return _strong_correction(pos, mu, idx, rows=rows) + a32.astype(pos.dtype)

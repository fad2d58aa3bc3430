"""The force precision ladder (ops/nbody_modes.py) against f64 and exact
references, and the native-f64 force against a numpy direct sum."""

from fractions import Fraction

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from ephemeris_explorer_tpu.ops import eft, nbody
from ephemeris_explorer_tpu.ops import expansion as ex
from ephemeris_explorer_tpu.ops.nbody_modes import (
    _rsqrt_df,
    _strong_correction,
    pairwise_accel_f32,
    pairwise_accel_f32_masked,
    pairwise_accel_f32_masked_rows,
    pairwise_accel_limbs,
    pairwise_accel_mixed,
    pairwise_accel_split,
    split_f64,
    strong_pair_indices,
    strong_pair_indices_rows,
    strong_pair_mask,
    strong_pair_mask_rows,
)


def _f32(x):
    return jnp.asarray(x, jnp.float64).astype(jnp.float32)


# ---------------------------------------------------------------------------
# native f64 force vs a numpy direct sum
# ---------------------------------------------------------------------------


def _geometry(kind: str, n: int):
    rng = np.random.default_rng(n)
    if kind == "cloud":
        return rng.normal(size=(n, 3)) * 1e6, rng.uniform(1e3, 1e5, n)
    if kind == "hierarchy":
        pos, mu = _hierarchy(max(n, 10), seed=n)
        return np.asarray(pos)[:n], np.asarray(mu)[:n]
    # close pair far from the origin (Phobos-Mars-like separation)
    pos = rng.normal(size=(n, 3)) * 1e8 + 4e8
    pos[1 % n] = pos[0] + np.array([9377.0, 1234.5678901, -17.25])
    return pos, rng.uniform(1e3, 4.3e4, n)


@pytest.mark.parametrize("kind", ["cloud", "hierarchy", "close_pair"])
@pytest.mark.parametrize("n", [2, 7, 32, 100])
def test_pairwise_accel_matches_numpy_direct_sum(n, kind):
    """Native f64 jnp force == the numpy f64 direct sum to rounding: the
    per-body error is bounded by a few ulps of sum_j |term_j|."""
    pos, mu = _geometry(kind, n)
    got = np.asarray(jax.jit(nbody.pairwise_accel)(jnp.asarray(pos), jnp.asarray(mu)))
    d = pos[None, :, :] - pos[:, None, :]
    r2 = np.sum(d * d, axis=-1)
    np.fill_diagonal(r2, 1.0)
    w = mu[None, :] / (r2 * np.sqrt(r2))
    np.fill_diagonal(w, 0.0)
    ref = np.sum(d * w[..., None], axis=1)
    scale = np.sum(np.linalg.norm(d, axis=-1) * w, axis=1)
    err = np.linalg.norm(got - ref, axis=1)
    assert np.all(err <= 1e-14 * scale), np.max(err / scale)


# ---------------------------------------------------------------------------
# 3-limb force (extended3)
# ---------------------------------------------------------------------------


def test_three_limb_close_pair_accuracy():
    """Error-free differencing: the close-pair force sees a sub-f64 third
    limb that no f64 force can represent, to ~1e-11 of the exact value."""
    # a Mars+Phobos-like close pair far from the origin, padded to 8 bodies
    n = 8
    pos = np.zeros((n, 3))
    pos[:, 0] = np.linspace(1e8, 4e8, n)
    pos[1] = pos[0] + np.array([9377.0, 1234.5678901, 0.0])  # "Phobos"
    mu = np.full(n, 1e3)
    mu[0] = 4.28e4

    # positions carry MORE than f64 precision (expansion state): a third
    # limb holds a sub-f64 offset
    jpos = jnp.asarray(pos)
    limbs = list(ex.from_f64(jpos))
    delta = np.zeros((n, 3))
    delta[1, 1] = 3.1415e-9  # ~3 micrometre offset on "Phobos"
    limbs[2] = jnp.asarray(np.asarray(limbs[2], dtype=np.float64) + delta,
                           jnp.float32)
    out3 = np.asarray(pairwise_accel_limbs(*limbs[:3], jnp.asarray(mu)))

    # exact rational reference for the close-pair row, from the LIMBS
    def limb_pos(i):
        return [
            sum(Fraction(float(np.asarray(l, dtype=np.float64)[i][k])) for l in limbs[:3])
            for k in range(3)
        ]

    def exact_accel(i):
        acc = [Fraction(0)] * 3
        pi = limb_pos(i)
        for j in range(n):
            if j == i:
                continue
            pj = limb_pos(j)
            d = [a - b for a, b in zip(pj, pi)]
            r2 = sum(x * x for x in d)
            inv_r3 = Fraction(float(float(r2) ** -1.5))  # f64 rounding fine here
            for k in range(3):
                acc[k] += Fraction(float(mu[j])) * d[k] * inv_r3
        return np.array([float(a) for a in acc])

    truth = exact_accel(1)
    rel3 = np.max(np.abs(out3[1] - truth)) / np.max(np.abs(truth))
    assert rel3 < 1e-11, rel3

    # the f64 force cannot see the third-limb offset at all
    out2 = np.asarray(nbody.pairwise_accel(jpos, jnp.asarray(mu)))
    rel2 = np.max(np.abs(out2[1] - truth)) / np.max(np.abs(truth))
    assert rel3 < rel2


def test_rsqrt_df_bias_envelope():
    """The two-float rsqrt must stay UNBIASED to ~2^-53.

    One plain Newton refinement from the f32 seed lands at
    y_true*(1 - 1.5 d^2) — a systematic ~2^-49 undershoot that integrates
    QUADRATICALLY through a second-order multistep (docs/ACCURACY.md).
    _rsqrt_df folds the next Taylor term, +(3/8)(s-1)^2, into the
    correction; this pins both the mean (bias) and max error.
    """
    rng = np.random.default_rng(0)
    x = np.exp(rng.uniform(np.log(1e-8), np.log(1e8), size=200_000))
    xh, xl = split_f64(jnp.asarray(x))
    y = jax.jit(_rsqrt_df)(eft.TwoFloat(xh, xl))
    yv = np.asarray(y.hi, np.float64) + np.asarray(y.lo, np.float64)
    truth = 1.0 / np.sqrt(np.asarray(x, np.longdouble))
    rel = (np.asarray(yv, np.longdouble) - truth) / truth
    # measured: bias -2^-53.6, max 2^-46.4 (pre-fix: bias -2^-49.3)
    assert abs(float(rel.mean())) < 2.0**-52, float(rel.mean())
    assert float(np.max(np.abs(rel))) < 2.0**-45, float(np.max(np.abs(rel)))


def test_distant_pair_weight_chain():
    """Sun->Pluto-class force terms must keep full two-float precision.

    u^3 = r^-3 spans down to ~5e-30 km^-3 for the most distant physical
    pairs; the dd correction terms of a final (u^2*u)*mu multiply land
    f32-SUBNORMAL and flush on a flush-to-zero device.  The force
    reassociates as (u^2*mu)*u.  Two nets here: (1) the force on the
    geometry; (2) an explicit flush-to-zero emulation of both
    associations, pinning WHY the order matters.
    """
    n = 8
    pos = np.zeros((n, 3))
    pos[1] = [4.4e9, 3.7e9, -1.2e9]  # "Pluto", ~5.9e9 km from "Sun"
    pos[2:] = np.linspace(1e8, 2e9, 6)[:, None] * np.array([1.0, 0.3, -0.2])
    mu = np.full(n, 1e3)
    mu[0], mu[1] = 1.327e11, 8.7e2
    jpos = jnp.asarray(pos)

    def exact_accel(i):
        acc = [Fraction(0)] * 3
        pi = [Fraction(pos[i][k]) for k in range(3)]
        for j in range(n):
            if j == i:
                continue
            pj = [Fraction(pos[j][k]) for k in range(3)]
            d = [a - b for a, b in zip(pj, pi)]
            r2 = sum(v * v for v in d)
            inv_r3 = Fraction(float(np.longdouble(float(r2)) ** np.longdouble(-1.5)))
            for k in range(3):
                acc[k] += Fraction(mu[j]) * d[k] * inv_r3
        return np.array([float(a) for a in acc])

    truth = exact_accel(1)
    limbs = ex.from_f64(jpos)
    out3 = np.asarray(pairwise_accel_limbs(*limbs[:3], jnp.asarray(mu)))
    scale = np.max(np.abs(truth))
    assert np.max(np.abs(out3[1] - truth)) / scale < 1e-13

    # --- flush-to-zero emulation of the weight chain -----------------------
    def ftz(x):
        v = np.asarray(x)
        out = np.where(np.abs(v) < np.float32(2.0**-126), np.float32(0), v)
        return jnp.asarray(out)

    def ftz2(x):
        return eft.TwoFloat(ftz(x.hi), ftz(x.lo))

    d = pos[0] - pos[1]
    r2 = float(d @ d)
    r2h, r2l = split_f64(jnp.asarray([r2]))
    u = ftz2(_rsqrt_df(eft.TwoFloat(r2h, r2l)))
    muh, mul_ = split_f64(jnp.asarray([mu[0]]))
    mu_tf = eft.TwoFloat(muh, mul_)
    u2 = ftz2(eft.sqr(u))
    w_ship = ftz2(eft.mul(ftz2(eft.mul(u2, mu_tf)), u))      # (u^2*mu)*u
    w_naive = ftz2(eft.mul(ftz2(eft.mul(u2, u)), mu_tf))     # (u^2*u)*mu
    w_true = np.longdouble(mu[0]) * np.longdouble(r2) ** np.longdouble(-1.5)

    def rel(w):
        v = np.asarray(w.hi, np.float64) + np.asarray(w.lo, np.float64)
        return abs(float((np.longdouble(v[0]) - w_true) / w_true))

    assert rel(w_ship) < 1e-12, rel(w_ship)    # survives the flush
    assert rel(w_naive) > 1e-10, rel(w_naive)  # loses the lo words to FTZ


# ---------------------------------------------------------------------------
# f32 and mixed rungs
# ---------------------------------------------------------------------------


def test_f32_fast_mode_error_envelope():
    """The f32 rung tracks the f64 force to ~1e-6 relative."""
    n = 64
    rng = np.random.default_rng(21)
    pos = rng.normal(size=(n, 3)) * 1.0e6
    mu = rng.uniform(1.0e3, 1.0e5, size=n)
    ref = np.asarray(nbody.pairwise_accel(jnp.asarray(pos), jnp.asarray(mu)))
    fast = np.asarray(pairwise_accel_f32(_f32(pos), _f32(mu)))
    rel = np.abs(fast - ref).max() / np.abs(ref).max()
    assert rel < 1e-5, rel
    assert rel > 1e-9  # sanity: it IS single precision


def test_mixed_mode_error_envelope():
    """The mixed rung (error-free pair differences + f32 weight chain)
    holds ~1e-6 relative PER-PAIR error even for a very close pair, where
    the plain-f32 rung's position-rounding cancellation costs orders of
    magnitude more."""
    n = 16
    rng = np.random.default_rng(29)
    pos = rng.normal(size=(n, 3)) * 1.0e6
    # a Phobos-Mars-like close pair: separation ~5e-5 of the position
    # scale, deliberately NOT ulp-aligned
    pos[1] = pos[0] + np.array([40.1234567, 19.7654321, -9.87654321])
    mu = rng.uniform(1.0e3, 1.0e5, size=n)
    mu[0] = 1.0e7  # heavy primary so the close pair dominates body 1's force

    ref = np.asarray(nbody.pairwise_accel(jnp.asarray(pos), jnp.asarray(mu)))
    ph, plo = split_f64(jnp.asarray(pos))
    mixed = np.asarray(pairwise_accel_mixed(ph, plo, _f32(mu)))
    fast = np.asarray(pairwise_accel_f32(_f32(pos), _f32(mu)))

    mag = np.linalg.norm(ref, axis=1)
    rel_mixed = np.linalg.norm(mixed - ref, axis=1) / mag
    rel_fast = np.linalg.norm(fast - ref, axis=1) / mag
    assert rel_mixed.max() < 3e-6, rel_mixed.max()
    assert rel_fast[1] > 30 * rel_mixed[1], (rel_fast[1], rel_mixed[1])
    assert rel_mixed.max() > 1e-9  # sanity: it IS an f32 chain


# ---------------------------------------------------------------------------
# Magnitude-split mode (f32 weak tail + f64 strong set)
# ---------------------------------------------------------------------------


def _hierarchy(n=16, seed=7):
    """Sun + 3 planets + close moon pairs + light far bodies: the dominated
    geometry the split mode is built for."""
    rng = np.random.default_rng(seed)
    AU = 1.5e11
    pos = [np.zeros(3)]
    mu = [1.33e20]
    for i in range(3):
        pp = rng.normal(size=3)
        pp = pp / np.linalg.norm(pp) * AU * (0.7 + i)
        pos.append(pp)
        mu.append(3e14 * (i + 1))
        for m in range(2):
            off = rng.normal(size=3)
            off = off / np.linalg.norm(off) * 4e8 * (1 + 0.002 * m)
            pos.append(pp + off)
            mu.append(5e12)
    while len(pos) < n:
        pos.append(rng.normal(size=3) * AU * 2)
        mu.append(1e10)
    return jnp.asarray(np.array(pos)), jnp.asarray(np.array(mu))


def _rel_err(a, ref):
    a, ref = np.asarray(a), np.asarray(ref)
    return np.linalg.norm(a - ref, axis=1) / np.linalg.norm(ref, axis=1)


def test_split_mode_exact_when_all_strong():
    """K = N-1 masks every pair out of the f32 sum: the split mode must
    reduce to the pure-f64 gathered computation."""
    rng = np.random.default_rng(3)
    n = 16
    pos = jnp.asarray(rng.normal(size=(n, 3)) * 1e6)
    mu = jnp.asarray(rng.uniform(1e3, 1e5, size=n))
    idx = strong_pair_indices(pos, mu, k=n - 1)
    mask = strong_pair_mask(idx, n)
    a = pairwise_accel_split(pos, mu, idx, mask)
    assert _rel_err(a, nbody.pairwise_accel(pos, mu)).max() < 1e-14


def test_split_mode_hierarchy_envelope():
    """The mode's target regime: for a dominated hierarchy the split mode
    lands at ~1e-9 vs the plain f32 rung's close-pair-wrecked ~3e-5."""
    pos, mu = _hierarchy()
    ref = nbody.pairwise_accel(pos, mu)
    idx = strong_pair_indices(pos, mu, k=6)
    mask = strong_pair_mask(idx, 16)
    split = _rel_err(pairwise_accel_split(pos, mu, idx, mask), ref)
    plain = _rel_err(pairwise_accel_f32(_f32(pos), _f32(mu)), ref)
    assert split.max() < 2e-9, split.max()          # measured 3.6e-10
    assert plain.max() > 1e3 * split.max()          # measured 3.1e-5
    assert split.max() > 1e-12                      # sanity: f32 tail


def test_split_mode_random_cloud_envelope():
    """No-structure worst case: the floor is ~2^-24 relative — still
    strictly better than the unsplit f32 rung on the same cloud."""
    rng = np.random.default_rng(11)
    n = 64
    pos = jnp.asarray(rng.normal(size=(n, 3)) * 1e6)
    mu = jnp.asarray(rng.uniform(1e3, 1e5, size=n))
    ref = nbody.pairwise_accel(pos, mu)
    idx = strong_pair_indices(pos, mu, k=8)
    mask = strong_pair_mask(idx, n)
    split = _rel_err(pairwise_accel_split(pos, mu, idx, mask), ref)
    plain = _rel_err(pairwise_accel_f32(_f32(pos), _f32(mu)), ref)
    assert split.max() < 4e-7, split.max()
    assert split.max() < plain.max()


def test_strong_pair_selection_invariants():
    """idx excludes self, mask marks exactly idx plus the self diagonal,
    and the selection is by weight mu_j/r^3: a close moon sibling must
    out-rank the sun for the moon row even though the sun dominates the
    CONTRIBUTION magnitude."""
    pos, mu = _hierarchy()
    k = 5
    idx = np.asarray(strong_pair_indices(pos, mu, k=k))
    n = pos.shape[0]
    assert idx.shape == (n, k)
    for i in range(n):
        assert i not in idx[i]
        assert len(set(idx[i].tolist())) == k
    mask = np.asarray(strong_pair_mask(jnp.asarray(idx), n))
    assert mask.sum() == n * k + n
    assert np.diagonal(mask).all()
    rows = np.repeat(np.arange(n), k)
    assert mask[rows, idx.reshape(-1)].all()
    # rows 2,3 are the first planet's moon pair: each moon's top-k must
    # contain its sibling AND the sun (the dominant attractor)
    assert 3 in idx[2] and 2 in idx[3]
    assert 0 in idx[2] and 0 in idx[3]


def test_split_rows_slices_match_square():
    """The rectangular (row-shardable) split-mode pieces are BITWISE the
    corresponding row slices of the square composition — the invariant
    the sharded wrapper is built on."""
    rng = np.random.default_rng(5)
    n, k, nl = 32, 4, 8
    pos = jnp.asarray(np.concatenate([
        rng.normal(size=(n // 2, 3)) * 1e6,
        rng.normal(size=(n // 2, 3)) * 1e6 + 3e7,
    ]))
    mu = jnp.asarray(rng.uniform(1e3, 1e5, n))

    idx = strong_pair_indices(pos, mu, k=k)
    mask = strong_pair_mask(idx, n)
    for shard in range(n // nl):
        r0 = shard * nl
        rows = pos[r0:r0 + nl]
        idx_r = strong_pair_indices_rows(pos, rows, mu, jnp.int32(r0), k=k)
        np.testing.assert_array_equal(
            np.asarray(idx_r), np.asarray(idx[r0:r0 + nl]))
        mask_r = strong_pair_mask_rows(idx_r, n, jnp.int32(r0))
        np.testing.assert_array_equal(
            np.asarray(mask_r), np.asarray(mask[r0:r0 + nl]))

    m_sq = np.asarray(pairwise_accel_f32_masked(pos, mu, mask))
    c_sq = np.asarray(_strong_correction(pos, mu, idx))
    for shard in range(n // nl):
        r0 = shard * nl
        m_r = pairwise_accel_f32_masked_rows(
            pos, mu, mask[r0:r0 + nl], pos[r0:r0 + nl])
        np.testing.assert_array_equal(np.asarray(m_r), m_sq[r0:r0 + nl])
        c_r = _strong_correction(pos, mu, idx[r0:r0 + nl], rows=pos[r0:r0 + nl])
        np.testing.assert_array_equal(np.asarray(c_r), c_sq[r0:r0 + nl])

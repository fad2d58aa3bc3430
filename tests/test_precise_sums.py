"""Gates for the pair-precision beta sums (the ROADMAP "TwoFloat ddys ring +
pair-precision beta sums" rung, round 4).

The ELM2 beta rows cancel ~29x (QT12 c_dy), so a base-precision dot loses
~29 ulps of the increment per step.  `multistep._wsum_precise` forms each
term with exact f32 two_prods (weights pre-split host-side into three f32
limbs) and accumulates in the 4-limb expansion (~2^-60 relative).

CI caveat (documented in integrators/multistep._wsum_precise): XLA:CPU
re-rounds fused f32 EFT compositions (every primitive alone compiles exactly; the fused composition
loses the low word at ~2e-14 relative).  The CPU gates below therefore bound
at 1e-12 — still far below the f64 dot's cancellation-amplified error under
an adversarial weight row — and the EAGER path is gated at the design level.
"""

import jax
import jax.numpy as jnp
import numpy as np

from ephemeris_explorer_tpu.integrators import get, multistep as ms
from ephemeris_explorer_tpu.ops import expansion as ex


def _ring(n=64, seed=0, period=136.0):
    """Realistic smooth acceleration ring (12, n) split into f32 pairs."""
    rng = np.random.default_rng(seed)
    base = rng.uniform(0.5, 2.0, (1, n)) * 1e-3
    f64 = base * np.cos(
        2 * np.pi * np.arange(12)[:, None] / period + rng.uniform(0, 6.28, (1, n))
    )
    hi = f64.astype(np.float32)
    lo = (f64 - hi.astype(np.float64)).astype(np.float32)
    return f64, hi, lo


def _oracle(w, hi, lo):
    vals = hi.astype(np.float128) + lo.astype(np.float128)
    w128 = np.array([np.float128(x) for x in w])[:, None]
    return np.sum(w128 * vals, axis=0)


def test_split3_exact():
    rng = np.random.default_rng(1)
    for w in rng.uniform(-1e9, 1e9, 50):
        c0, c1, c2 = ms._split3_host(float(w))
        back = np.float128(c0) + np.float128(c1) + np.float128(c2)
        assert float(back) == float(w)
        # three f32 limbs represent any binary64 with |c2| capturing the tail
        assert abs(np.float64(np.float128(w) - back)) <= abs(w) * 2**-70


def test_prescale_single_rounding():
    tab = get("QuinlanTremaine12")
    w = ms._prescale_f128(tab.c_dy, 600.0 * 600.0, float(tab.beta_d))
    for c, wi in zip(tab.c_dy, w):
        exact = np.float128(float(c)) * np.float128(360000.0) / np.float128(
            float(tab.beta_d)
        )
        # one f64 rounding of the f128 product
        assert wi == float(np.float64(exact))


def test_two_sum_reduce_error_free():
    """root + sum(errs) must equal sum(vals) EXACTLY (as reals): both sides
    correctly rounded with math.fsum must agree bitwise.  Eager only — the
    error-free property is what the cascaded _wsum_precise reduction builds
    on (jitted XLA:CPU folds it; documented hazard, routed around)."""
    import math

    rng = np.random.default_rng(7)
    for m in (1, 2, 3, 5, 12, 47, 58):
        for dtype in (np.float32, np.float64):
            # cancellation-heavy, mixed magnitudes
            vals = (
                rng.uniform(-1.0, 1.0, (m, 4))
                * np.logspace(-6, 6, m)[:, None]
            ).astype(dtype)
            root, errs = ms._two_sum_reduce(jnp.asarray(vals))
            # the reduce captures exactly m-1 error terms (one per two_sum)
            assert sum(int(e.shape[0]) for e in errs) == m - 1
            for col in range(vals.shape[1]):
                lhs = math.fsum(
                    [float(np.asarray(root)[col])]
                    + [float(np.asarray(e)[i, col]) for e in errs
                       for i in range(e.shape[0])]
                )
                rhs = math.fsum(float(v) for v in vals[:, col])
                assert lhs == rhs, (m, dtype, col, lhs, rhs)


def test_wsum_precise_eager_design_grade():
    """Eager (and GPU-jitted; see module docstring) accuracy: ~2^-60."""
    tab = get("QuinlanTremaine12")
    w = ms._prescale_f128(tab.c_dy, 600.0 * 600.0, float(tab.beta_d))
    _, hi, lo = _ring()
    out = ms._wsum_precise(w, jnp.asarray(hi), jnp.asarray(lo))
    got = sum(np.asarray(l, dtype=np.float128) for l in out)
    oracle = _oracle(w, hi, lo)
    rel = float(np.max(np.abs((got - oracle) / oracle)))
    assert rel < 1e-17, rel


def test_wsum_precise_jit_beats_cancellation():
    """Under jit (XLA:CPU re-rounds fused EFT chains; see module docstring)
    the result must still be orders below the cancellation-amplified
    grade of a ~2^-48 pair dot (~2^-48 * 29 ~ 1e-13)."""
    tab = get("QuinlanTremaine12")
    w = ms._prescale_f128(tab.c_dy, 600.0 * 600.0, float(tab.beta_d))
    _, hi, lo = _ring()
    out = jax.jit(lambda a, b: ms._wsum_precise(w, a, b))(
        jnp.asarray(hi), jnp.asarray(lo)
    )
    got = sum(np.asarray(l, dtype=np.float128) for l in out)
    oracle = _oracle(w, hi, lo)
    rel = float(np.max(np.abs((got - oracle) / oracle)))
    assert rel < 1e-12, rel


def test_elm2_step_q_precise_sums_consistent():
    """precise_sums=True must agree with the f64-dot path to the f64 dot's
    own accuracy (~1e-13 of the increment) over a short scan, and produce a
    structurally identical carry."""
    from ephemeris_explorer_tpu.ops import nbody

    tab = get("QuinlanTremaine12")
    rng = np.random.default_rng(3)
    n = 8
    pos = rng.uniform(-1.5e8, 1.5e8, (n, 3))
    vel = rng.uniform(-20, 20, (n, 3))
    mu = jnp.asarray(rng.uniform(1e4, 1e8, n))
    h = 600.0

    def accel(t, y):
        return nbody.pairwise_accel(y, mu)

    c0 = ms.elm2_init_q(tab, accel, 0.0, jnp.asarray(pos), jnp.asarray(vel), h)
    ca = cb = c0
    for _ in range(5):
        ca = ms.elm2_step_q(tab, accel, h, ca)
        cb = ms.elm2_step_q(tab, accel, h, cb, precise_sums=True)
    ya = sum(np.asarray(l, np.float64) for l in ca.ys)[0]
    yb = sum(np.asarray(l, np.float64) for l in cb.ys)[0]
    # identical trajectories at the f64-dot noise level (the paths differ
    # only in sub-2^-48-of-increment rounding)
    np.testing.assert_allclose(yb, ya, rtol=0, atol=1e-6)  # km: mm-level
    va = np.asarray(ca.dy)
    vb = np.asarray(cb.dy)
    np.testing.assert_allclose(vb, va, rtol=0, atol=1e-9)


def test_velocity_precise_consistent():
    from ephemeris_explorer_tpu.ops import nbody

    tab = get("QuinlanTremaine12")
    rng = np.random.default_rng(4)
    n = 8
    pos = rng.uniform(-1.5e8, 1.5e8, (n, 3))
    vel = rng.uniform(-20, 20, (n, 3))
    mu = jnp.asarray(rng.uniform(1e4, 1e8, n))
    h = 600.0

    def accel(t, y):
        return nbody.pairwise_accel(y, mu)

    c = ms.elm2_init_q(tab, accel, 0.0, jnp.asarray(pos), jnp.asarray(vel), h)
    v_plain = np.asarray(ms.elm2_velocity_q(tab, c, h))
    v_prec = np.asarray(ms.elm2_velocity_q(tab, c, h, precise_sums=True))
    np.testing.assert_allclose(v_prec, v_plain, rtol=0, atol=1e-9)

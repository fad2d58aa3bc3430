"""f32-expansion arithmetic property tests (vs exact Fraction arithmetic)."""

from fractions import Fraction

import jax.numpy as jnp
import numpy as np

from ephemeris_explorer_tpu.ops import expansion as ex


def _exact(a):
    return sum(Fraction(float(x)) for x in a)


def test_from_to_f64_exact():
    rng = np.random.default_rng(0)
    v = jnp.asarray(rng.normal(size=100) * 10.0 ** rng.integers(-8, 8, 100))
    e = ex.from_f64(v)
    back = np.asarray(ex.to_f64(e))
    np.testing.assert_array_equal(back, np.asarray(v))


def test_add_precision():
    """Expansion adds keep ~2^-90 relative accuracy across mixed magnitudes."""
    rng = np.random.default_rng(1)
    worst = 0.0
    for trial in range(200):
        vals = [float(rng.normal() * 10.0 ** rng.integers(-6, 9)) for _ in range(6)]
        acc = ex.from_f64(jnp.asarray(vals[0]))
        exact = Fraction(vals[0])
        for v in vals[1:]:
            acc = ex.add(acc, ex.from_f64(jnp.asarray(v)))
            exact += Fraction(v)
        got = _exact([float(np.asarray(l)) for l in acc])
        scale = max(abs(exact), Fraction(1, 10**30))
        rel = abs(got - exact) / scale
        worst = max(worst, float(rel))
    assert worst < 2.0**-80, worst


def test_scale_pow2_exact():
    rng = np.random.default_rng(2)
    v = jnp.asarray(rng.normal(size=50) * 1e8)
    e = ex.from_f64(v)
    for c in (1.0, -1.0, 2.0, -2.0):
        s = ex.scale_pow2i(e, c)
        np.testing.assert_array_equal(np.asarray(ex.to_f64(s)), np.asarray(v) * c)


def test_elm2_alpha_sum_accuracy():
    """The QT12 position combination (big cancellation) in expansions."""
    from ephemeris_explorer_tpu.integrators import get

    tab = get("QuinlanTremaine12")
    rng = np.random.default_rng(3)
    # 12 nearby positions ~ 1.5e8 km with ~2 km spacing
    ys = 1.5e8 + np.cumsum(rng.normal(size=12) * 2.0)
    exact = sum(Fraction(c) * Fraction(y) for c, y in zip(tab.c_y, ys))
    acc = None
    for c, y in zip(tab.c_y, ys):
        if c == 0.0:
            continue
        term = ex.scale_pow2i(ex.from_f64(jnp.asarray(y)), c)
        acc = term if acc is None else ex.add(acc, term)
    got = _exact([float(np.asarray(l)) for l in acc])
    rel = abs(got - exact) / Fraction(ys[0])
    # per-step state rounding must be far below f64 (2^-53)
    assert float(rel) < 2.0**-85, float(rel)


def test_from_f64_host_exact():
    """Host limb split represents any binary64 exactly (3 f32 limbs).

    The extended engines start from these limbs: f32 transfers are exact,
    so the device state starts bit-for-bit at the host's initial
    conditions (a um-scale initial-position error becomes a secular
    along-track moon drift, docs/ACCURACY.md).
    """
    rng = np.random.default_rng(7)
    # heliocentric-position-like magnitudes with full mantissas
    v = rng.normal(size=(64, 3)) * 10.0 ** rng.integers(3, 10, (64, 3))
    limbs = ex.from_f64_host(v)
    assert all(np.asarray(l).dtype == np.float32 for l in limbs)
    recon = np.zeros_like(v)
    for l in limbs[::-1]:
        recon = recon + np.asarray(l, np.float64)
    np.testing.assert_array_equal(recon, v)
    # the 4th limb must be identically zero for f64 input
    np.testing.assert_array_equal(np.asarray(limbs[-1]), 0.0)


def test_elm2_init_q_y0_limbs_plumbing():
    """elm2_init_q(y0_limbs=...) equals the from_f64 lift on CPU (where the
    device transfer is lossless), proving the limb path feeds the starter."""
    import jax

    from ephemeris_explorer_tpu.integrators import get, multistep
    from ephemeris_explorer_tpu.ops import nbody

    rng = np.random.default_rng(3)
    n = 4
    pos = rng.normal(size=(n, 3)) * 1.0e8
    vel = rng.normal(size=(n, 3)) * 10.0
    mu = np.abs(rng.normal(size=n)) * 1.0e9
    mu_j = jnp.asarray(mu)
    accel = lambda t, y: nbody.pairwise_accel(y, mu_j)  # noqa: E731
    tab = get("QuinlanTremaine12")
    c_a = multistep.elm2_init_q(tab, accel, 0.0, jnp.asarray(pos), jnp.asarray(vel), 600.0)
    c_b = multistep.elm2_init_q(
        tab, accel, 0.0, None, jnp.asarray(vel), 600.0,
        y0_limbs=ex.from_f64_host(pos),
    )
    for la, lb in zip(c_a.ys, c_b.ys):
        np.testing.assert_array_equal(np.asarray(la), np.asarray(lb))
    np.testing.assert_array_equal(np.asarray(c_a.dy), np.asarray(c_b.dy))

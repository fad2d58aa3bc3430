"""Explicit linear multistep integrators (Adams-Bashforth, Quinlan-Tremaine,
Stormer-Cowell) as scan-friendly pure functions.

Rebuilds ``integration/src/multistep`` (first_order.rs, second_order/mod.rs,
second_order/cowell.rs): the ring buffer of past states becomes a dense
``(ORDER, ...)`` array in the scan carry, most-recent first; the weighted sums
become fused broadcast-reductions, and the startup phase (``mod.rs:202-224``:
ORDER full steps of the starter method, each split into ``substeps``
sub-steps) is an unrolled traced loop.

Semantics mirrored from the reference:

* ELM2 position update  y_{n+1} = sum_j(-alpha[j+1] y_{n-j})
                                 + h^2/beta_d * sum_j(beta[j+1] ddy_{n-j})
  over j = 0..ORDER-1                         (second_order/mod.rs:91-131)
* Cowell velocity  dy_{n+1} = (y_{n+1}-y_n)/h
                              + h/cbeta_d * sum_j(cbeta[j] ddy_{n+1-j})
  over j = 0..ORDER-1                         (second_order/cowell.rs:19-53)
* ELM1 update  y_{n+1} = sum_j(-alpha[j+1] y_{n-j})
                         + h/beta_d * sum_j(beta[j+1] dy_{n-j})
                                              (first_order.rs:80-119)
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import jax
import jax.numpy as jnp

from .fixed import erk_step, eval_accel, srkn_step
from .methods import ELMTableau, get


class ELM2Carry(NamedTuple):
    t: jax.Array      # current time (seconds, f64 scalar)
    ys: jax.Array     # (ORDER, ...) positions, most recent first: [y_n, ...]
    ddys: jax.Array   # (ORDER, ...) accelerations at those positions
    dy: jax.Array     # current velocity

    @property
    def y(self) -> jax.Array:
        return self.ys[0]


def _starter_full_step(tab: ELMTableau, accel, t, y, dy, h, ddy_cache):
    """One full startup step = `tab.substeps` sub-steps of the starter method.

    Returns (t, y, dy, ddy_cache).  The FSAL acceleration cache is threaded
    through all sub-steps of the whole startup phase, matching the persistent
    integrator instance in the reference (multistep/mod.rs:46-108).
    """
    starter = get(tab.starter)
    hs = h / tab.substeps
    if tab.kind == "elm2":
        for _ in range(tab.substeps):
            if starter.fsal and ddy_cache is None:
                ddy_cache = accel(t, y)
            t, y, dy, ddy_cache = srkn_step(starter, accel, t, y, dy, hs, ddy_cache)
    else:
        # first-order starter (RK4) on the state pytree y; dy unused
        def f(ti, yi):
            return accel(ti, yi)

        for _ in range(tab.substeps):
            t, y, _ = erk_step(starter, f, t, y, hs)
    return t, y, dy, ddy_cache


def elm2_startup_scan(tab: ELMTableau, accel, t0, y0, dy0, h):
    """ORDER starter full-steps as nested scans, emitting (y_k, ddy_k) per step.

    Returns (t, dy, ys_fwd, ddys_fwd) with ys_fwd[k] = y_{k+1} in FORWARD
    order (k = 0..ORDER-1).  Keeps the compiled graph small: one starter
    sub-step is traced once instead of ORDER * substeps times.
    """
    starter = get(tab.starter)
    hs = h / tab.substeps
    assert tab.kind == "elm2"
    t0 = jnp.asarray(t0, jnp.float64)

    if starter.fsal:
        ddy0 = eval_accel(accel, t0, y0, dy0)

        def substep(c, _):
            t, y, dy, ddy = c
            t, y, dy, ddy = srkn_step(starter, accel, t, y, dy, hs, ddy)
            return (t, y, dy, ddy), None

        def fullstep(c, _):
            c, _ = jax.lax.scan(substep, c, None, length=tab.substeps)
            t, y, dy, ddy = c
            # for FSAL SRKN starters the carried ddy IS accel(t, y) at the
            # full-step boundary (last stage has drift weight 0), so the
            # reference's explicit re-eval (advance_with) is free here
            return c, (y, ddy)

        init = (t0, y0, dy0, ddy0)
    else:

        def substep(c, _):
            t, y, dy, ddy = c
            t, y, dy, ddy = srkn_step(starter, accel, t, y, dy, hs, None)
            return (t, y, dy, ddy), None

        def fullstep(c, _):
            c, _ = jax.lax.scan(substep, c, None, length=tab.substeps)
            t, y, dy, ddy = c
            return c, (y, eval_accel(accel, t, y, dy))

        init = (t0, y0, dy0, eval_accel(accel, t0, y0, dy0))

    (t, y, dy, _), (ys, ddys) = jax.lax.scan(fullstep, init, None, length=tab.order)
    return t, dy, ys, ddys


def elm2_init(tab: ELMTableau, accel, t0, y0, dy0, h) -> ELM2Carry:
    """Startup: run ORDER full steps of the starter, recording (y_k, ddy_k).

    After this the carry holds [y_ORDER .. y_1] / [ddy_ORDER .. ddy_1] and the
    first call to :func:`elm2_step` computes y_{ORDER+1}, exactly like the
    reference's `advance_with` bookkeeping (multistep/mod.rs:202-224).
    """
    t, dy, ys, ddys = elm2_startup_scan(tab, accel, t0, y0, dy0, h)
    return ELM2Carry(t=t, ys=ys[::-1], ddys=ddys[::-1], dy=dy)


def elm2_step(
    tab: ELMTableau, accel, h, carry: ELM2Carry, with_velocity: bool = True
) -> ELM2Carry:
    """One fixed multistep step (one force evaluation).

    ``with_velocity=False`` skips the Cowell velocity reconstruction and
    leaves ``dy`` stale: the position update never reads it (the alpha sum
    and force depend on positions only), so pure-Newtonian scans can defer
    velocity to :func:`elm2_velocity` at sample/chunk boundaries.  Do NOT
    use it with a velocity-dependent RHS.
    """
    c_y = jnp.asarray(tab.c_y, carry.ys.dtype)
    c_dy = jnp.asarray(tab.c_dy, carry.ys.dtype)
    cb = jnp.asarray(tab.cowell_beta_n, carry.ys.dtype)

    def wsum(coeffs, stack):
        shape = (-1,) + (1,) * (stack.ndim - 1)
        return jnp.sum(coeffs.reshape(shape) * stack, axis=0)

    assert with_velocity or not getattr(accel, "needs_velocity", False), (
        "with_velocity=False requires a velocity-independent force"
    )
    sum1 = wsum(c_y, carry.ys)
    sum2 = wsum(c_dy, carry.ddys)
    y_new = sum1 + sum2 * (h * h / tab.beta_d)
    t_new = carry.t + h

    # a needs_velocity RHS sees the carry velocity (one step stale; fine for
    # ~1e-8-scale perturbation terms, see ops/perturbations.py)
    ddy_new = eval_accel(accel, t_new, y_new, carry.dy)

    ddys_new = jnp.concatenate([ddy_new[None], carry.ddys[: tab.order - 1]])
    if with_velocity:
        vel_sum = wsum(cb, ddys_new)
        dy_new = (y_new - carry.ys[0]) / h + vel_sum * (h / tab.cowell_beta_d)
    else:
        dy_new = carry.dy

    ys_new = jnp.concatenate([y_new[None], carry.ys[: tab.order - 1]])
    return ELM2Carry(t=t_new, ys=ys_new, ddys=ddys_new, dy=dy_new)


def elm2_velocity(tab: ELMTableau, carry: ELM2Carry, h) -> jax.Array:
    """Cowell velocity at the carry's current step, from positions + forces.

    Identical to what :func:`elm2_step` stores when ``with_velocity=True``:
    dy_n = (y_n - y_{n-1})/h + h/beta_d * sum_j beta_j ddy_{n-j}.
    """
    cb = jnp.asarray(tab.cowell_beta_n, carry.ys.dtype)
    shape = (-1,) + (1,) * (carry.ddys.ndim - 1)
    vel_sum = jnp.sum(cb.reshape(shape) * carry.ddys, axis=0)
    return (carry.ys[0] - carry.ys[1]) / h + vel_sum * (h / tab.cowell_beta_d)


def elm2_scan(tab: ELMTableau, accel, carry: ELM2Carry, h, n_steps: int,
              emit: Callable | None = None):
    """Scan `n_steps` multistep steps; optionally emit `emit(carry)` per step."""

    def body(c, _):
        c = elm2_step(tab, accel, h, c)
        return c, (emit(c) if emit is not None else None)

    return jax.lax.scan(body, carry, None, length=n_steps)


# ---------------------------------------------------------------------------
# First-order multistep (Adams-Bashforth)
# ---------------------------------------------------------------------------


class ELM1Carry(NamedTuple):
    t: jax.Array
    ys: jax.Array    # (ORDER, ...) states, most recent first
    dys: jax.Array   # (ORDER, ...) derivatives

    @property
    def y(self) -> jax.Array:
        return self.ys[0]


def elm1_init(tab: ELMTableau, f, t0, y0, h) -> ELM1Carry:
    starter = get(tab.starter)
    hs = h / tab.substeps
    t0 = jnp.asarray(t0, jnp.float64)

    def substep(c, _):
        t, y = c
        t, y, _ = erk_step(starter, f, t, y, hs)
        return (t, y), None

    def fullstep(c, _):
        c, _ = jax.lax.scan(substep, c, None, length=tab.substeps)
        t, y = c
        return c, (y, f(t, y))

    (t, y), (ys, dys) = jax.lax.scan(fullstep, (t0, y0), None, length=tab.order)
    return ELM1Carry(t=t, ys=ys[::-1], dys=dys[::-1])


def elm1_step(tab: ELMTableau, f, h, carry: ELM1Carry) -> ELM1Carry:
    c_y = jnp.asarray(tab.c_y, carry.ys.dtype)
    c_dy = jnp.asarray(tab.c_dy, carry.ys.dtype)
    shape = (-1,) + (1,) * (carry.ys.ndim - 1)
    sum1 = jnp.sum(c_y.reshape(shape) * carry.ys, axis=0)
    sum2 = jnp.sum(c_dy.reshape(shape) * carry.dys, axis=0)
    y_new = sum1 + sum2 * (h / tab.beta_d)
    t_new = carry.t + h
    dy_new = f(t_new, y_new)
    return ELM1Carry(
        t=t_new,
        ys=jnp.concatenate([y_new[None], carry.ys[: tab.order - 1]]),
        dys=jnp.concatenate([dy_new[None], carry.dys[: tab.order - 1]]),
    )


# ---------------------------------------------------------------------------
# Compensated-state (two-float) variant
# ---------------------------------------------------------------------------
#
# The reference's convergence suite integrates with a double-double state
# ("Double<T>", solar_system_convergence.rs:12-172) because plain-f64
# accumulation error dominates truncation for fast moons (Phobos' 7.6 h
# period at 10-minute steps).  This variant keeps positions/velocities as
# TwoFloat pairs (double-double over f64) while evaluating the O(N^2)
# force in base precision - the state update is O(N * ORDER) so the extra
# arithmetic is free next to the force evaluation.

from ..ops import eft
from ..ops.eft import TwoFloat


class ELM2CarryC(NamedTuple):
    t: jax.Array
    ys: TwoFloat       # (ORDER, ...) positions
    ddys: jax.Array    # (ORDER, ...) accelerations (base precision)
    dy: TwoFloat       # current velocity


def _dd_wsum(coeffs, stack: TwoFloat) -> TwoFloat:
    """sum_j coeffs[j] * stack[j] in two-float arithmetic (exact int coeffs)."""
    acc = eft.mul_float(TwoFloat(stack.hi[0], stack.lo[0]), coeffs[0])
    for j in range(1, len(coeffs)):
        if coeffs[j] == 0.0:
            continue
        acc = eft.add(acc, eft.mul_float(TwoFloat(stack.hi[j], stack.lo[j]), coeffs[j]))
    return acc


def _f64_wsum(coeffs, stack):
    shape = (-1,) + (1,) * (stack.ndim - 1)
    return jnp.sum(jnp.asarray(coeffs, stack.dtype).reshape(shape) * stack, axis=0)


def _srkn_step_c(tab, accel, t, y: TwoFloat, dy: TwoFloat, h, ddy0):
    """Symplectic kick-drift step on a two-float state (startup helper)."""
    ddy = None
    for s in range(tab.stages):
        if s == 0 and tab.fsal and ddy0 is not None:
            ddy = ddy0
        else:
            ddy = eval_accel(accel, t + h * tab.c[s], y.hi, dy.hi)
        if tab.b[s] != 0.0:
            dy = eft.add(dy, eft.from_float(ddy * (h * tab.b[s])))
        if tab.a[s] != 0.0:
            y = eft.add(y, eft.mul_float(dy, jnp.asarray(h * tab.a[s], y.hi.dtype)))
    return t + h, y, dy, ddy


def elm2_init_c(tab: ELMTableau, accel, t0, y0, dy0, h) -> ELM2CarryC:
    """Compensated startup (starter sub-steps on the two-float state)."""
    starter = get(tab.starter)
    hs = h / tab.substeps
    t0 = jnp.asarray(t0, jnp.float64)
    y = eft.from_float(jnp.asarray(y0))
    dy = eft.from_float(jnp.asarray(dy0))
    ddy0 = eval_accel(accel, t0, y.hi, dy.hi) if starter.fsal else None

    def substep(c, _):
        t, y, dy, ddy = c
        t, y, dy, ddy = _srkn_step_c(starter, accel, t, y, dy, hs, ddy if starter.fsal else None)
        return (t, y, dy, ddy), None

    def fullstep(c, _):
        c, _ = jax.lax.scan(substep, c, None, length=tab.substeps)
        t, y, dy, ddy = c
        a = ddy if starter.fsal else eval_accel(accel, t, y.hi, dy.hi)
        return c, (y, a)

    init = (t0, y, dy, ddy0 if ddy0 is not None else eval_accel(accel, t0, y.hi, dy.hi))
    (t, y, dy, _), (ys, ddys) = jax.lax.scan(fullstep, init, None, length=tab.order)
    return ELM2CarryC(
        t=t,
        ys=TwoFloat(ys.hi[::-1], ys.lo[::-1]),
        ddys=ddys[::-1],
        dy=dy,
    )


def elm2_step_c(tab: ELMTableau, accel, h, carry: ELM2CarryC) -> ELM2CarryC:
    """One multistep step on the two-float state (one force evaluation)."""
    sum1 = _dd_wsum(tab.c_y, carry.ys)
    sum2 = _f64_wsum(tab.c_dy, carry.ddys)
    y_new = eft.add(sum1, eft.from_float(sum2 * (h * h / tab.beta_d)))
    t_new = carry.t + h

    ddy_new = eval_accel(accel, t_new, y_new.hi, carry.dy.hi)

    ddys_new = jnp.concatenate([ddy_new[None], carry.ddys[: tab.order - 1]])
    vel_sum = _f64_wsum(tab.cowell_beta_n, ddys_new)
    y_prev = TwoFloat(carry.ys.hi[0], carry.ys.lo[0])
    dy_new = eft.add(
        eft.mul_float(eft.sub(y_new, y_prev), jnp.asarray(1.0 / h, y_new.hi.dtype)),
        eft.from_float(vel_sum * (h / tab.cowell_beta_d)),
    )

    ys_new = TwoFloat(
        jnp.concatenate([y_new.hi[None], carry.ys.hi[: tab.order - 1]]),
        jnp.concatenate([y_new.lo[None], carry.ys.lo[: tab.order - 1]]),
    )
    return ELM2CarryC(t=t_new, ys=ys_new, ddys=ddys_new, dy=dy_new)


# ---------------------------------------------------------------------------
# dd-force truth variant: double-double state AND double-double forces
# ---------------------------------------------------------------------------
#
# The ELM2CarryC truth above compensates only the STATE; its forces are
# plain f64, exactly like the reference's Double<T> convergence fixture
# (solar_system_convergence.rs:12-172).  At century scale the f64 force
# rounding (~2^-53 relative per eval) is itself a noise floor of a few km
# on fast moons.  This variant evaluates the force in double-double too
# (ops/nbody.pairwise_accel_dd) and keeps the acceleration ring as TwoFloat
# pairs, making the truth's own rounding envelope ~2^-106 — good enough to
# MEASURE the f64-force truth's envelope rather than assert it.
# Coefficients stay the engines' f64 values (exact TwoFloat-by-float
# products), so coefficient-representation differences cancel in every
# truth-vs-candidate comparison.
#
# MEASURED HAZARD: do NOT run this variant jit-compiled on XLA:CPU — the
# flat dd-force graph takes >60 min / >28 GB to compile, and the code that
# IS emitted silently degrades the product-chain compensation to plain-f64
# grade (~1e-15 rel vs a float128 oracle; every EFT primitive alone
# compiles exactly).  The production truth path is the pure-numpy mirror in
# ephemeris_explorer_tpu/truth_np.py (verified ~3e-19, f128-limited); the
# jnp variant here is retained as the algorithm-of-record for backends
# whose emitted arithmetic is re-validated first (tests/test_truth_np.py
# pins the update chain bitwise against the numpy twin).


class ELM2CarryDD(NamedTuple):
    t: jax.Array
    ys: TwoFloat       # (ORDER, ...) dd positions
    ddys: TwoFloat     # (ORDER, ...) dd accelerations
    dy: TwoFloat       # dd velocity


def _srkn_step_cf(tab, accel_dd, t, y: TwoFloat, dy: TwoFloat, h, ddy0):
    """Symplectic kick-drift startup step, dd state + dd force."""
    ddy = None
    for s in range(tab.stages):
        if s == 0 and tab.fsal and ddy0 is not None:
            ddy = ddy0
        else:
            ddy = accel_dd(t + h * tab.c[s], y)
        if tab.b[s] != 0.0:
            dy = eft.add(dy, eft.mul_float(ddy, jnp.asarray(h * tab.b[s], y.hi.dtype)))
        if tab.a[s] != 0.0:
            y = eft.add(y, eft.mul_float(dy, jnp.asarray(h * tab.a[s], y.hi.dtype)))
    return t + h, y, dy, ddy


def elm2_init_cf(tab: ELMTableau, accel_dd, t0, y0, dy0, h) -> ELM2CarryDD:
    """dd-force startup.  ``accel_dd(t, y: TwoFloat) -> TwoFloat``."""
    starter = get(tab.starter)
    hs = h / tab.substeps
    t0 = jnp.asarray(t0, jnp.float64)
    y = eft.from_float(jnp.asarray(y0))
    dy = eft.from_float(jnp.asarray(dy0))
    ddy0 = accel_dd(t0, y) if starter.fsal else None

    def substep(c, _):
        t, y, dy, ddy = c
        t, y, dy, ddy = _srkn_step_cf(
            starter, accel_dd, t, y, dy, hs, ddy if starter.fsal else None
        )
        return (t, y, dy, ddy), None

    def fullstep(c, _):
        c, _ = jax.lax.scan(substep, c, None, length=tab.substeps)
        t, y, dy, ddy = c
        a = ddy if starter.fsal else accel_dd(t, y)
        return c, (y, a)

    init = (t0, y, dy, ddy0 if ddy0 is not None else accel_dd(t0, y))
    (t, y, dy, _), (ys, ddys) = jax.lax.scan(fullstep, init, None, length=tab.order)
    rev = lambda p: TwoFloat(p.hi[::-1], p.lo[::-1])  # noqa: E731
    return ELM2CarryDD(t=t, ys=rev(ys), ddys=rev(ddys), dy=dy)


def _dd_wsum_tf(coeffs, stack: TwoFloat) -> TwoFloat:
    """sum_j coeffs[j] * stack[j] with a TwoFloat stack (f64 coeff values)."""
    acc = None
    for j in range(len(coeffs)):
        c = float(coeffs[j])
        if c == 0.0:
            continue
        term = eft.mul_float(
            TwoFloat(stack.hi[j], stack.lo[j]), jnp.asarray(c, stack.hi.dtype)
        )
        acc = term if acc is None else eft.add(acc, term)
    return acc


def elm2_step_cf(tab: ELMTableau, accel_dd, h, carry: ELM2CarryDD) -> ELM2CarryDD:
    """One multistep step, dd state + dd force ring (one force evaluation)."""
    sum1 = _dd_wsum(tab.c_y, carry.ys)
    sum2 = _dd_wsum_tf(tab.c_dy, carry.ddys)
    h2b = jnp.asarray(h * h / tab.beta_d, sum2.hi.dtype)
    y_new = eft.add(sum1, eft.mul_float(sum2, h2b))
    t_new = carry.t + h

    ddy_new = accel_dd(t_new, y_new)

    cat = lambda new, ring: jnp.concatenate([new[None], ring[: tab.order - 1]])  # noqa: E731
    ddys_new = TwoFloat(
        cat(ddy_new.hi, carry.ddys.hi), cat(ddy_new.lo, carry.ddys.lo)
    )
    vel_sum = _dd_wsum_tf(tab.cowell_beta_n, ddys_new)
    y_prev = TwoFloat(carry.ys.hi[0], carry.ys.lo[0])
    dy_new = eft.add(
        eft.mul_float(eft.sub(y_new, y_prev), jnp.asarray(1.0 / h, y_new.hi.dtype)),
        eft.mul_float(vel_sum, jnp.asarray(h / tab.cowell_beta_d, y_new.hi.dtype)),
    )
    ys_new = TwoFloat(cat(y_new.hi, carry.ys.hi), cat(y_new.lo, carry.ys.lo))
    return ELM2CarryDD(t=t_new, ys=ys_new, ddys=ddys_new, dy=dy_new)


# ---------------------------------------------------------------------------
# Expansion-state variant (quad-f32 limbs): beyond-f64 position state
# ---------------------------------------------------------------------------
#
# A plain f64 state rounds every position update at 2^-53 of the
# heliocentric radius, which on fast moons accumulates into a ~0.1 km
# error over 60 days (docs/ACCURACY.md).  Here the position state is a
# 4-limb f32 expansion (ops/expansion.py, ~2^-90): the ELM2 alpha
# combination uses exact +-2^k scalings and expansion adds, and only the
# tiny h^2-increment passes through base precision.

from ..ops import expansion as ex


class ELM2CarryQ(NamedTuple):
    t: jax.Array
    ys: tuple          # K-tuple of (ORDER, ..., 3) f32 limb arrays
    ddys: jax.Array    # (ORDER, ..., 3) base-precision accelerations
    dy: jax.Array      # base-precision velocity


def _exp_wsum_alpha(c_y, ys: tuple) -> tuple:
    """sum_j c_y[j] * ys[j] with c_y in {+-1, +-2} (exact scalings)."""
    acc = None
    order = ys[0].shape[0]
    for j in range(order):
        c = float(c_y[j])
        if c == 0.0:
            continue
        term = ex.scale_pow2i(tuple(l[j] for l in ys), c)
        acc = term if acc is None else ex.add(acc, term)
    return acc


def _srkn_step_q(tab, accel_q, t, y: tuple, dy, h, ddy0):
    """Symplectic kick-drift startup step: y as f32 expansion, dy in base f64.

    The drift increment dy*(h*A) is computed in base precision (relative
    2^-48 of a ~km-scale increment) and expansion-added, so the POSITION
    never gets rounded to base precision - that rounding (0.5 m/step) was
    measured to dominate the year-scale drift via startup period errors.

    ``accel_q(t, y_expansion, dy)`` evaluates the force directly from the
    expansion position (limb-aware when the caller has a limb kernel).
    """
    ddy = None
    for s in range(tab.stages):
        if s == 0 and tab.fsal and ddy0 is not None:
            ddy = ddy0
        else:
            ddy = accel_q(t + h * tab.c[s], y, dy)
        if tab.b[s] != 0.0:
            dy = dy + ddy * (h * tab.b[s])
        if tab.a[s] != 0.0:
            y = ex.add(y, ex.from_f64(dy * (h * tab.a[s])))
    return t + h, y, dy, ddy


def elm2_init_q(
    tab: ELMTableau, accel, t0, y0, dy0, h, accel_limbs=None, y0_limbs=None
) -> ELM2CarryQ:
    """Expansion-state startup: starter sub-steps with expansion positions.

    ``y0_limbs`` (a K-tuple of f32 limb arrays, e.g. from
    :func:`ops.expansion.from_f64_host`) supplies the initial position
    EXACTLY.  Without it the startup lifts ``y0`` with ``ex.from_f64``,
    which is exact only where the device holds real binary64 values.
    Callers whose initial state originates in host f64 should always pass
    ``y0_limbs``.

    When ``accel_limbs(t, (l0, l1, l2)[, dy])`` is given (the same limb
    kernel the main scan uses), every startup force evaluation sees the
    three leading limbs instead of the f64-rounded position.  Rounding the
    position before the force costs ~1e-10 relative pair-force error on
    close moon pairs (0.5 mm of 1e8-km coordinates against ~1e4-km
    separations); through the ~ORDER*substeps startup evaluations that
    seeds a period error of the same relative size, which is exactly the
    measured 5.6 m/yr linear phase drift of the fastest moons vs the
    2^-106 ddf truth (docs/ACCURACY.md).  Limb-aware startup removes it.
    """
    starter = get(tab.starter)
    hs = h / tab.substeps
    t0 = jnp.asarray(t0, jnp.float64)
    if y0_limbs is not None:
        y = tuple(jnp.asarray(l, jnp.float32) for l in y0_limbs)
    else:
        y = ex.from_f64(jnp.asarray(y0))
    dy = jnp.asarray(dy0)

    if accel_limbs is not None:
        if getattr(accel_limbs, "needs_velocity", False):
            def accel_q(t, y_exp, dy):
                return accel_limbs(t, (y_exp[0], y_exp[1], y_exp[2]), dy)
        else:
            def accel_q(t, y_exp, dy):
                return accel_limbs(t, (y_exp[0], y_exp[1], y_exp[2]))
    else:
        def accel_q(t, y_exp, dy):
            return eval_accel(accel, t, ex.to_f64(y_exp), dy)

    ddy0 = accel_q(t0, y, dy) if starter.fsal else None

    def substep(c, _):
        t, y, dy, ddy = c
        t, y, dy, ddy = _srkn_step_q(
            starter, accel_q, t, y, dy, hs, ddy if starter.fsal else None
        )
        return (t, y, dy, ddy), None

    def fullstep(c, _):
        c, _ = jax.lax.scan(substep, c, None, length=tab.substeps)
        t, y, dy, ddy = c
        a = ddy if starter.fsal else accel_q(t, y, dy)
        return c, (y, a)

    init = (
        t0, y, dy,
        ddy0 if ddy0 is not None else accel_q(t0, y, dy),
    )
    (t, y, dy, _), (ys, ddys) = jax.lax.scan(fullstep, init, None, length=tab.order)
    return ELM2CarryQ(
        t=t,
        ys=tuple(l[::-1] for l in ys),
        ddys=ddys[::-1],
        dy=dy,
    )


def _split3_host(w: float):
    """Exact host-side split of one f64 value into three f32 limbs."""
    import numpy as np

    c0 = np.float32(w)
    r = w - float(c0)
    c1 = np.float32(r)
    c2 = np.float32(r - float(c1))
    return float(c0), float(c1), float(c2)


def _prescale_f128(coeffs, num: float, den: float) -> list:
    """w_j = coeffs[j] * num / den with ONE f64 rounding each (f128 host math).

    Folding the h^2/beta_d (or h/cowell_beta_d) factor into the weights
    host-side removes the post-sum TwoFloat multiply from the device chain
    — the weighted sum below then produces the INCREMENT directly.
    """
    import numpy as np

    n128, d128 = np.float128(num), np.float128(den)
    return [float(np.float64(np.float128(float(c)) * n128 / d128)) for c in coeffs]


def _dekker_split_f32_host(v: float):
    """Host twin of eft.split for f32 (splitter 2^12 + 1), exact."""
    import numpy as np

    a = np.float32(v)
    c = np.float32(4097.0) * a
    hi = c - (c - a)
    lo = a - hi
    return float(hi), float(lo)


def _two_sum_reduce(vals):
    """Error-free tree sum along axis 0: (root, error terms).

    ``root + sum(errs) == sum(vals)`` EXACTLY — every two_sum rounding is
    captured in ``errs`` (a list of arrays totalling M-1 entries for M
    inputs).  Each tree level is ONE vectorised two_sum on a halved array
    (6 fused elementwise ops), so the whole reduce dispatches ~6*log2(M)
    ops instead of M sequential compensated adds.

    CAUTION: jitted on XLA:CPU the fused composition folds the error terms
    to their algebraic zero (measured: exact standalone, 7e-6 relative
    once fused after the two_prod chain; ``lax.optimization_barrier``
    does NOT survive CPU fusion codegen).  :func:`_wsum_precise` routes
    such platforms to native f64 instead.
    """
    errs = []
    cur = vals
    while cur.shape[0] > 1:
        half = cur.shape[0] // 2
        s, e = eft.two_sum(cur[:half], cur[half : 2 * half])
        errs.append(e)
        cur = (
            jnp.concatenate([s, cur[2 * half :]], axis=0)
            if cur.shape[0] % 2
            else s
        )
    return cur[0], errs


def _wsum_dot(ws, dd_hi, dd_lo) -> tuple:
    """Native-f64 twin of :func:`_wsum_cascade`: one correctly-rounded f64
    product + sum per term (~2^-53 * cond ~ 1e-14 relative here), split
    back into f32 limbs."""
    import numpy as np

    # needs REAL float64 — with x64 disabled these ops silently run in f32
    # and the grade collapses to ~1e-7
    assert jax.config.x64_enabled, (
        "_wsum_dot requires jax_enable_x64 (the package enables it on import)"
    )
    bshape = (len(ws),) + (1,) * (dd_hi.ndim - 1)
    w64 = jnp.asarray(np.array(ws, np.float64).reshape(bshape))
    r = jnp.sum(
        w64 * (dd_hi.astype(jnp.float64) + dd_lo.astype(jnp.float64)), axis=0
    )
    l0, l1, l2 = eft.f64_limbs(r, 3)
    return (l0, l1, l2, jnp.zeros_like(l0))


def _wsum_cascade(ws, dd_hi, dd_lo) -> tuple:
    """sum_j ws[j] * (dd_hi[j] + dd_lo[j]) through exact f32 EFTs.

    Each term is formed with exact f32 two_prods (weights pre-split into
    three f32 limbs host-side) and the terms accumulate through a CASCADED
    error-free reduction, so cancellation does NOT amplify rounding.  It
    splits the sum by magnitude class and uses :func:`_two_sum_reduce`
    (6 ops/level):

      level 1: exact tree sum of the leading products p       (~|term|)
      level 2: exact tree sum of {level-1 roundings, pe, q, r}    (~2^-24)
      level 3: exact tree sum of {level-2 roundings, s}           (~2^-48)
      level 4: plain f32 sum of the level-3 roundings             (~2^-62)

    Levels 1-3 are error-free transforms, so the ONLY rounding in the
    whole reduction is level 4's, at ~2^-80 of the largest term,
    independent of cancellation.  The roots combine with two more
    two_sums into a 4-limb expansion.

    The weight limbs are broadcast to full arrays (never f32 scalars):
    XLA:CPU re-rounds pure-scalar f32 sub-DAGs (measured hazard, see the
    ops/eft.py module docstring).
    """
    import numpy as np

    bshape = (len(ws),) + (1,) * (dd_hi.ndim - 1)
    limbs = [_split3_host(w) for w in ws]

    def const(vals):
        return jnp.asarray(np.array(vals, np.float32).reshape(bshape))

    b0 = const([l[0] for l in limbs])
    b1 = const([l[1] for l in limbs])
    b2 = const([l[2] for l in limbs])
    b0h, b0l = (
        const(v) for v in zip(*(_dekker_split_f32_host(l[0]) for l in limbs))
    )
    b1h, b1l = (
        const(v) for v in zip(*(_dekker_split_f32_host(l[1]) for l in limbs))
    )

    hi_h, hi_l = eft.split(dd_hi)
    lo_h, lo_l = eft.split(dd_lo)
    p, pe = eft.two_prod_presplit(dd_hi, hi_h, hi_l, b0, b0h, b0l)
    q, qe = eft.two_prod_presplit(dd_lo, lo_h, lo_l, b0, b0h, b0l)
    r, re = eft.two_prod_presplit(dd_hi, hi_h, hi_l, b1, b1h, b1l)
    s = qe + re + dd_lo * b1 + dd_hi * b2

    s1, e1 = _two_sum_reduce(p)
    s2, e2 = _two_sum_reduce(jnp.concatenate([*e1, pe, q, r], axis=0))
    s3, e3 = _two_sum_reduce(jnp.concatenate([*e2, s], axis=0))
    s4 = (
        jnp.sum(jnp.concatenate(e3, axis=0), axis=0)
        if e3
        else jnp.zeros_like(s3)
    )

    h1, t1 = eft.two_sum(s1, s2)
    h2, t2 = eft.two_sum(t1, s3)
    return (h1, h2, t2 + s4, jnp.zeros_like(h1))


def _wsum_precise(weights, dd_hi, dd_lo) -> tuple:
    """sum_j weights[j] * (dd_hi[j] + dd_lo[j]) as a 4-limb f32 expansion.

    The beta rows cancel ~29x (QT12 c_dy: sum(|w_j f|)/|sum w_j f|), so a
    dot in base precision loses ~29 ulps of the RESULT per step.  Eager
    calls use the exact cascade (:func:`_wsum_cascade`).  Traces route per
    LOWERING platform (``lax.platform_dependent`` resolves at lowering
    time, so a CPU-committed trace on a GPU host still gets the CPU
    branch): XLA:CPU folds the cascade's error-free trees into plain f32
    sums (measured 8.4e-19 eager vs 6.6e-6 jitted, with or without
    optimization barriers), so CPU traces use the native-f64 dot
    (:func:`_wsum_dot`).
    """
    import numpy as np

    idx = [j for j, w in enumerate(weights) if w != 0.0]
    if len(idx) != len(weights):
        dd_hi = dd_hi[np.array(idx)]
        dd_lo = dd_lo[np.array(idx)]
    ws = [weights[j] for j in idx]

    if isinstance(dd_hi, jax.core.Tracer):
        return jax.lax.platform_dependent(
            cpu=lambda: _wsum_dot(ws, dd_hi, dd_lo),
            default=lambda: _wsum_cascade(ws, dd_hi, dd_lo),
        )
    return _wsum_cascade(ws, dd_hi, dd_lo)


def _split_pair(x) -> TwoFloat:
    """Split an f64 array into an (hi, lo) f32 pair (rounds at ~2^-48)."""
    return TwoFloat(*eft.f64_limbs(x, 2))


def elm2_step_q(
    tab: ELMTableau,
    accel,
    h,
    carry: ELM2CarryQ,
    accel_limbs=None,
    with_velocity: bool = True,
    precise_sums: bool = False,
) -> ELM2CarryQ:
    """One multistep step on the expansion state (one force evaluation).

    `accel(t, y_f64)` is evaluated at the base-precision rounding of the
    expansion position.  When `accel_limbs(t, (l0, l1, l2))` is given (the
    3-limb force), the force sees error-free position differences -
    the remaining noise source for close moon pairs at century scale.

    ``with_velocity=False`` defers the Cowell velocity (an 8-limb expansion
    renorm + a 12-term f64 weighted sum per step) to :func:`elm2_velocity_q` at sample boundaries;
    the position update never reads ``dy``.  Requires a velocity-independent
    force.

    ``precise_sums=True`` computes the beta sum with :func:`_wsum_precise`
    over the (hi, lo) pair view of the acceleration ring instead of an
    f64 dot.  The pair split of a native-f64 ring rounds at ~2^-48, so on
    native-f64 devices the flag does not beat the f64 dot.  Requires a
    concrete (non-traced) ``h``.
    """
    assert all(abs(c) in (0.0, 1.0, 2.0) for c in tab.c_y), tab.name
    sum1 = _exp_wsum_alpha(tab.c_y, carry.ys)
    if precise_sums:
        w = _prescale_f128(tab.c_dy, float(h) * float(h), float(tab.beta_d))
        dd = _split_pair(carry.ddys)
        y_new = ex.add(sum1, _wsum_precise(w, dd.hi, dd.lo))
    else:
        sum2 = _f64_wsum(tab.c_dy, carry.ddys)
        y_new = ex.add(sum1, ex.from_f64(sum2 * (h * h / tab.beta_d)))
    t_new = carry.t + h

    needs_vel = getattr(accel_limbs, "needs_velocity", False) or (
        accel_limbs is None and getattr(accel, "needs_velocity", False)
    )
    assert with_velocity or not needs_vel, (
        "with_velocity=False requires a velocity-independent force"
    )
    if accel_limbs is not None:
        if getattr(accel_limbs, "needs_velocity", False):
            ddy_new = accel_limbs(t_new, (y_new[0], y_new[1], y_new[2]), carry.dy)
        else:
            ddy_new = accel_limbs(t_new, (y_new[0], y_new[1], y_new[2]))
    else:
        ddy_new = eval_accel(accel, t_new, ex.to_f64(y_new), carry.dy)

    ddys_new = jnp.concatenate([ddy_new[None], carry.ddys[: tab.order - 1]])
    if with_velocity:
        diff = ex.to_f64(ex.add(y_new, ex.neg(tuple(l[0] for l in carry.ys)))) / h
        if precise_sums:
            wv = _prescale_f128(tab.cowell_beta_n, float(h), float(tab.cowell_beta_d))
            ddv = _split_pair(ddys_new)
            dy_new = diff + ex.to_f64(_wsum_precise(wv, ddv.hi, ddv.lo))
        else:
            vel_sum = _f64_wsum(tab.cowell_beta_n, ddys_new)
            dy_new = diff + vel_sum * (h / tab.cowell_beta_d)
    else:
        dy_new = carry.dy

    ys_new = tuple(
        jnp.concatenate([nl[None], ol[: tab.order - 1]])
        for nl, ol in zip(y_new, carry.ys)
    )
    return ELM2CarryQ(t=t_new, ys=ys_new, ddys=ddys_new, dy=dy_new)


def elm2_velocity_q(
    tab: ELMTableau, carry: ELM2CarryQ, h, precise_sums: bool = False
) -> jax.Array:
    """Cowell velocity from an expansion carry (see :func:`elm2_velocity`)."""
    y_now = tuple(l[0] for l in carry.ys)
    y_prev = tuple(l[1] for l in carry.ys)
    diff = ex.to_f64(ex.add(y_now, ex.neg(y_prev))) / h
    if precise_sums:
        wv = _prescale_f128(tab.cowell_beta_n, float(h), float(tab.cowell_beta_d))
        ddv = _split_pair(carry.ddys)
        return diff + ex.to_f64(_wsum_precise(wv, ddv.hi, ddv.lo))
    vel_sum = _f64_wsum(tab.cowell_beta_n, carry.ddys)
    return diff + vel_sum * (h / tab.cowell_beta_d)

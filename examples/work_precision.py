#!/usr/bin/env python3
"""Work-precision validation harness.

Rebuilds ``integration/examples/plot_work_precision.rs``: integrate a
two-body Kepler orbit with every named method and report position error
against the analytic solution versus step size / function evaluations.
Emits CSV to stdout (no plotting dependencies).

Run:  python examples/work_precision.py [--orbit eccentric|circular]
"""

from __future__ import annotations

import argparse
import math
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import jax

# validation harness: CPU by default (override with --platform gpu)
if "--platform" in sys.argv:
    _plat = sys.argv[sys.argv.index("--platform") + 1]
else:
    _plat = "cpu"
if _plat != "default":
    jax.config.update("jax_platforms", _plat)
jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp
import numpy as np

from ephemeris_explorer_tpu.integrators import adaptive, fixed, get, multistep
from ephemeris_explorer_tpu.ops import nbody

MU = 398600.4355070226  # km^3/s^2


class KeplerOrbit:
    """Analytic two-body propagation via eccentric-anomaly Kepler solve."""

    def __init__(self, a: float, e: float):
        self.a, self.e = a, e
        self.n = math.sqrt(MU / a**3)

    def state(self, t: float):
        m = self.n * t
        ecc = self.e
        # Newton solve E - e sin E = M
        E = m if ecc < 0.8 else math.pi
        for _ in range(50):
            f = E - ecc * math.sin(E) - m
            E -= f / (1 - ecc * math.cos(E))
        a = self.a
        x = a * (math.cos(E) - ecc)
        y = a * math.sqrt(1 - ecc**2) * math.sin(E)
        r = a * (1 - ecc * math.cos(E))
        vx = -a * self.n * math.sin(E) * a / r
        vy = a * self.n * math.sqrt(1 - ecc**2) * math.cos(E) * a / r
        return np.array([x, y, 0.0]), np.array([vx, vy, 0.0])

    @property
    def period(self) -> float:
        return 2 * math.pi / self.n


def run_fixed(name: str, orbit: KeplerOrbit, steps: int):
    tab = get(name)
    pos0, vel0 = orbit.state(0.0)
    mu = jnp.asarray([MU, 1e-12])
    y0 = jnp.asarray([np.zeros(3), pos0])
    dy0 = jnp.asarray([np.zeros(3), vel0])
    h = orbit.period / steps
    accel = lambda t, y: nbody.pairwise_accel(y, mu)

    kind = type(tab).__name__
    if kind == "ELMTableau":
        carry = multistep.elm2_init(tab, accel, 0.0, y0, dy0, h)

        def body(c, _):
            return multistep.elm2_step(tab, accel, h, c), None

        carry, _ = jax.lax.scan(body, carry, None, length=steps - tab.order)
        yf = np.asarray(carry.ys[0][1])
        evals = tab.order * tab.substeps * get(tab.starter).stages + (steps - tab.order)
    elif kind == "SRKNTableau":
        ddy0 = accel(0.0, y0)

        def body(c, _):
            t, y, dy, ddy = c
            t, y, dy, ddy = fixed.srkn_step(tab, accel, t, y, dy, h, ddy if tab.fsal else None)
            return (t, y, dy, ddy), None

        (t, y, dy, _), _ = jax.lax.scan(body, (jnp.float64(0), y0, dy0, ddy0), None, length=steps)
        yf = np.asarray(y[1])
        per = tab.stages - (1 if tab.fsal else 0)
        evals = steps * per + 1
    else:  # ERK on first-order state
        f = lambda t, y: (y[1], nbody.pairwise_accel(y[0], mu))

        def body(c, _):
            t, (y, dy) = c
            t, (y, dy), _ = fixed.erk_step(tab, f, t, (y, dy), h)
            return (t, (y, dy)), None

        (t, (y, dy)), _ = jax.lax.scan(body, (jnp.float64(0), (y0, dy0)), None, length=steps)
        yf = np.asarray(y[1])
        evals = steps * tab.stages

    truth, _ = orbit.state(orbit.period)
    return float(np.linalg.norm(yf - truth)), evals


def run_adaptive(name: str, orbit: KeplerOrbit, tol: float):
    tab = get(name)
    pos0, vel0 = orbit.state(0.0)
    mu = jnp.asarray([MU, 1e-12])
    y0 = (jnp.asarray([np.zeros(3), pos0]), jnp.asarray([np.zeros(3), vel0]))
    params = adaptive.AdaptiveParams(h_init=10.0, tol_pos=tol, tol_vel=tol, n_max=10**7)
    norm = adaptive.abs_tol_norm(tol, tol)
    kind = type(tab).__name__
    if kind == "ERKTableau":
        f = lambda t, y: (y[1], nbody.pairwise_accel(y[0], mu))
    else:  # Nystrom kinds take (t, y[, dy])
        if kind == "ERKNTableau":
            f = lambda t, y: nbody.pairwise_accel(y, mu)
        else:
            f = lambda t, y, dy: nbody.pairwise_accel(y, mu)
    st = adaptive.init_state(tab, f, 0.0, y0, params)
    step = jax.jit(lambda s: adaptive.advance(tab, f, params, norm, s, orbit.period))
    while True:
        st, h, status = step(st)
        if int(status) != adaptive.OK:
            break
    yf = np.asarray(st.y[0][1])
    truth, _ = orbit.state(orbit.period)
    return float(np.linalg.norm(yf - truth)), int(st.n) * tab.stages


FIXED = ["RK4", "BlanesMoan6B", "BlanesMoan11B", "BlanesMoan14A", "ForestRuth",
         "McLachlanO4", "McLachlanSS17", "Pefrl", "Ruth",
         "QuinlanTremaine12", "Stormer13"]
ADAPTIVE = ["CashKarp45", "DormandPrince54", "DormandPrince87", "Fehlberg45",
            "Tsitouras75", "Verner87", "Verner98", "Tsitouras75Nystrom", "Fine45"]


def main() -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--orbit", choices=["circular", "eccentric"], default="eccentric")
    p.add_argument("--platform", default="cpu")
    p.add_argument("--quick", action="store_true")
    args = p.parse_args()
    orbit = KeplerOrbit(a=10000.0, e=0.0 if args.orbit == "circular" else 0.3)

    print("method,kind,param,evals,pos_error_km")
    step_counts = [200, 800] if args.quick else [100, 200, 400, 800, 1600, 3200]
    for name in FIXED:
        for steps in step_counts:
            err, evals = run_fixed(name, orbit, steps)
            print(f"{name},fixed,{steps},{evals},{err:.6e}", flush=True)
    tols = [1e-3, 1e-9] if args.quick else [1e-3, 1e-6, 1e-9, 1e-12]
    for name in ADAPTIVE:
        for tol in tols:
            err, evals = run_adaptive(name, orbit, tol)
            print(f"{name},adaptive,{tol},{evals},{err:.6e}", flush=True)


if __name__ == "__main__":
    main()

#!/usr/bin/env python3
"""Throughput benchmarks on one device.

Default: prints ONE JSON line for the headline metric — body-steps/sec on a
synthetic 4096-body cluster, QT12 (one O(N^2) force evaluation per step),
native f64, through the production force (``ops/nbody.pairwise_accel_auto``).

``--all`` runs every config below, one JSON line each; ``--config NAME``
runs one:

  n4096_f64         headline: plain f64 state + the production force
  fss_generation    full_solar_system ephemeris GENERATION (integration +
                    sampling + least-squares fit), sim-days/sec
  fleet64           64 batched spacecraft with flight-plan burns vs the
                    interpolated context, 300-day missions (vmapped)
  ensemble16x4096   16 initial conditions x 4096 bodies in one scan
  n4096_f32_fast    f32 force rung (~1e-6 relative)
  n4096_mixed       mixed force rung (error-free pair differences, f32 chain)
  n4096_split       magnitude-split force rung (f32 tail + f64 strong pairs)

Every result names the device it ran on (JAX platform, device kind and
count; for a GPU also the card name and power limit from nvidia-smi).
"""

import argparse
import json
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

N_BODIES = 4096
STEPS_PER_CHUNK = 400
GROUPS = 2            # timed groups; the spread across groups is reported
CHUNKS_PER_GROUP = 3  # chunks queued back-to-back per group (one sync each)

REPO = Path(__file__).resolve().parent


def _cluster(n, seed=0):
    rng = np.random.default_rng(seed)
    pos = rng.normal(size=(n, 3)) * 1.0e6
    vel = rng.normal(size=(n, 3)) * 1.0
    mu = rng.uniform(1.0e3, 1.0e5, size=n)
    return pos, vel, mu


def device_info() -> dict:
    import jax

    dev = jax.devices()[0]
    info = {
        "platform": dev.platform,
        "device_kind": dev.device_kind,
        "device_count": len(jax.devices()),
    }
    if dev.platform == "gpu" and shutil.which("nvidia-smi"):
        info["card"] = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            check=True, capture_output=True, text=True,
        ).stdout.strip().splitlines()[0]
    return info


def _grouped(advance, state, work_per_call: float, calls: int = CHUNKS_PER_GROUP):
    """Time GROUPS groups of ``calls`` queued ``advance`` calls, one
    ``block_until_ready`` per group.  Returns (rate, spread_pct, state)."""
    import jax

    rates = []
    t_all = time.perf_counter()
    for _ in range(GROUPS):
        t0 = time.perf_counter()
        for _ in range(calls):
            state = advance(state)
        jax.block_until_ready(state)
        rates.append(work_per_call * calls / (time.perf_counter() - t0))
    value = work_per_call * calls * GROUPS / (time.perf_counter() - t_all)
    spread = 100.0 * (max(rates) - min(rates)) / (sum(rates) / len(rates))
    return value, spread, state


def bench_headline() -> dict:
    import jax
    import jax.numpy as jnp

    from ephemeris_explorer_tpu.integrators import get
    from ephemeris_explorer_tpu.integrators.multistep import (
        elm2_init, elm2_step, elm2_velocity,
    )
    from ephemeris_explorer_tpu.ops import nbody

    pos, vel, mu = _cluster(N_BODIES)
    tab = get("QuinlanTremaine12")
    mu_dev = jnp.asarray(mu)
    h = 600.0

    def accel(t, y):
        return nbody.pairwise_accel_auto(y, mu_dev)

    @jax.jit
    def chunk(carry):
        def body(c, _):
            return elm2_step(tab, accel, h, c, with_velocity=False), None

        c, _ = jax.lax.scan(body, carry, None, length=STEPS_PER_CHUNK)
        return c._replace(dy=elm2_velocity(tab, c, h))

    init = jax.jit(lambda p, v: elm2_init(tab, accel, 0.0, p, v, h))
    carry = jax.block_until_ready(chunk(init(jnp.asarray(pos), jnp.asarray(vel))))
    value, spread, carry = _grouped(chunk, carry, N_BODIES * STEPS_PER_CHUNK)
    assert np.isfinite(np.asarray(carry.ys[0])).all(), "non-finite state"
    return {
        "metric": f"body-steps/sec (N={N_BODIES}, QT12 f64)",
        "value": round(value, 1),
        "unit": "body-steps/s",
        "groups": GROUPS,
        "spread_pct": round(spread, 2),
    }


def bench_fss_generation() -> dict:
    """full_solar_system ephemeris generation incl. sampling + LSQ fit."""
    from ephemeris_explorer_tpu import Duration
    from ephemeris_explorer_tpu.ephemeris import generate_ephemeris
    from ephemeris_explorer_tpu.io.scene import load_scene

    sc = load_scene(REPO / "systems" / "full_solar_system_2433282.5")
    span = Duration.from_years(1.0)
    # warm: compile all chunk shapes (the package-canonical chunking that
    # every Universe generation reuses)
    generate_ephemeris(sc.state, sc.settings, span)
    t0 = time.perf_counter()
    eph = generate_ephemeris(sc.state, sc.settings, span)
    elapsed = time.perf_counter() - t0
    assert eph["Earth"].segment_count > 0
    return {
        "metric": "full_solar_system generation incl. fit (32 bodies, dt 10 min, warm)",
        "value": round(span.as_seconds() / 86400.0 / elapsed, 1),
        "unit": "sim-days/s",
    }


def _fleet_ships(sc, eph, n_ships: int, mission_days: float):
    """Synthetic heliocentric fleet around Earth's orbit with one burn each."""
    from ephemeris_explorer_tpu.ftime import Duration, Epoch
    from ephemeris_explorer_tpu.io.scene import Ship, ShipBurn

    rng = np.random.default_rng(42)
    t0 = sc.state.epoch.as_offset_seconds() + 86400.0
    ep, ev = eph["Earth"].state_vector(t0)
    ships = []
    for k in range(n_ships):
        offset = rng.normal(size=3) * 5.0e5 + np.array([2.0e6, 0.0, 0.0])
        dv = 1.0 + rng.normal(size=3) * 1e-3
        burns = [
            ShipBurn(
                start=Epoch.from_offset_seconds(t0 + 10 * 86400.0 + k * 3600.0),
                duration=Duration.from_seconds(600.0),
                acceleration=np.array([2e-3, 0.0, 0.0]),
                reference="Sun",
            )
        ]
        ships.append(
            Ship(
                name=f"fleet-{k}",
                integrator="Verner87",
                tolerance=1e-3,
                start=Epoch.from_offset_seconds(t0),
                end=Epoch.from_offset_seconds(t0 + mission_days * 86400.0),
                position=ep + offset,
                velocity=ev * dv,
                burns=burns,
            )
        )
    return ships


def bench_fleet64() -> dict:
    from ephemeris_explorer_tpu import Duration
    from ephemeris_explorer_tpu.ephemeris import generate_ephemeris
    from ephemeris_explorer_tpu.io.scene import load_scene
    from ephemeris_explorer_tpu.spacecraft import propagate_ships

    sc = load_scene(REPO / "systems" / "full_solar_system_2433282.5")
    eph = generate_ephemeris(sc.state, sc.settings, Duration.from_days(320.0))
    ships = _fleet_ships(sc, eph, 64, 300.0)
    out = propagate_ships(eph, ships, max_knots=8192)   # warm (compile)
    spans = [tr.end_s - tr.start_s for tr in out.values()]
    assert min(spans) > 290 * 86400.0, "fleet did not cover its missions"

    # propagate_ships returns host trajectories, so each call is complete
    def run(_):
        propagate_ships(eph, ships, max_knots=8192)
        return None

    value, spread, _ = _grouped(run, None, 64 * 300.0, calls=4)
    return {
        "metric": "64-ship fleet, 300-day missions w/ burns vs interpolated context (warm)",
        "value": round(value, 1),
        "unit": "ship-days/s",
        "groups": GROUPS,
        "spread_pct": round(spread, 2),
    }


def bench_ensemble() -> dict:
    from ephemeris_explorer_tpu.integrators import get
    from ephemeris_explorer_tpu.parallel import sharding as sh

    e, steps = 16, 50
    tab = get("QuinlanTremaine12")
    h = 600.0
    mu = _cluster(N_BODIES)[2]
    pos = np.stack([_cluster(N_BODIES, seed=i)[0] for i in range(e)])
    vel = np.stack([_cluster(N_BODIES, seed=i)[1] for i in range(e)])

    carry = sh.init_fused_ensemble_carry(tab, mu, 0.0, pos, vel, h)
    run = sh.make_fused_ensemble_scan(tab, mu, h, steps)
    value, spread, carry = _grouped(run, run(carry), e * N_BODIES * steps, calls=2)
    assert np.isfinite(np.asarray(carry.ys[0])).all(), "non-finite state"
    return {
        "metric": f"ensemble body-steps/sec ({e} ICs x {N_BODIES} bodies, QT12 f64)",
        "value": round(value, 1),
        "unit": "body-steps/s",
        "groups": GROUPS,
        "spread_pct": round(spread, 2),
    }


def _force_rung(name: str, make_scan, init) -> dict:
    """Time a force rung inside a scan (the state advances by a negligible
    fraction of the force, so every step re-evaluates the force)."""
    scan = make_scan()
    state = scan(init)
    value, spread, _ = _grouped(scan, state, N_BODIES * STEPS_PER_CHUNK)
    return {
        "metric": f"{name} force evals/sec x bodies (N={N_BODIES})",
        "value": round(value, 1),
        "unit": "body-steps/s",
        "groups": GROUPS,
        "spread_pct": round(spread, 2),
    }


def bench_f32_fast() -> dict:
    """The single-precision rung (visualization grade, ~1e-6 relative)."""
    import jax
    import jax.numpy as jnp

    from ephemeris_explorer_tpu.ops.nbody_modes import pairwise_accel_f32

    pos, _, mu = _cluster(N_BODIES)
    mu32 = jnp.asarray(mu, jnp.float32)

    def make_scan():
        @jax.jit
        def scan(p):
            def body(c, _):
                return c + pairwise_accel_f32(c, mu32) * jnp.float32(1e-30), None

            return jax.lax.scan(body, p, None, length=STEPS_PER_CHUNK)[0]

        return scan

    return _force_rung("f32 (~1e-6 rel)", make_scan, jnp.asarray(pos, jnp.float32))


def bench_mixed() -> dict:
    """The mixed rung: error-free pair differences + f32 weight chain,
    ~1e-6 relative for every pair geometry."""
    import jax
    import jax.numpy as jnp

    from ephemeris_explorer_tpu.ops.nbody_modes import pairwise_accel_mixed, split_f64

    pos, _, mu = _cluster(N_BODIES)
    mu32 = jnp.asarray(mu, jnp.float32)

    def make_scan():
        @jax.jit
        def scan(c):
            def body(c, _):
                a = pairwise_accel_mixed(c[0], c[1], mu32)
                return (c[0] + a * jnp.float32(1e-30), c[1]), None

            return jax.lax.scan(body, c, None, length=STEPS_PER_CHUNK)[0]

        return scan

    return _force_rung(
        "mixed (~1e-6 rel, all geometries)", make_scan, split_f64(jnp.asarray(pos))
    )


def bench_split() -> dict:
    """The magnitude-split rung: f32 weak tail + f64 top-K strong pairs
    (~1e-9 for dominated hierarchies, ~1e-7 random clouds).  The strong
    set refreshes once per chunk, as in engine use."""
    import jax
    import jax.numpy as jnp

    from ephemeris_explorer_tpu.ops.nbody_modes import (
        pairwise_accel_split,
        strong_pair_indices,
        strong_pair_mask,
    )

    pos, _, mu = _cluster(N_BODIES)
    mu64 = jnp.asarray(mu)

    def make_scan():
        @jax.jit
        def scan(p):
            idx = strong_pair_indices(p, mu64, k=16)
            mask = strong_pair_mask(idx, N_BODIES)

            def body(c, _):
                return c + pairwise_accel_split(c, mu64, idx, mask) * 1e-30, None

            return jax.lax.scan(body, p, None, length=STEPS_PER_CHUNK)[0]

        return scan

    return _force_rung("split (K=16)", make_scan, jnp.asarray(pos))


ALL_BENCHES = {
    "n4096_f64": bench_headline,
    "fss_generation": bench_fss_generation,
    "fleet64": bench_fleet64,
    "ensemble16x4096": bench_ensemble,
    "n4096_f32_fast": bench_f32_fast,
    "n4096_mixed": bench_mixed,
    "n4096_split": bench_split,
}


def main() -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--all", action="store_true", help="run every config")
    p.add_argument("--config", choices=sorted(ALL_BENCHES), default=None)
    args = p.parse_args()

    names = list(ALL_BENCHES) if args.all else [args.config or "n4096_f64"]
    device = device_info()
    for name in names:
        result = ALL_BENCHES[name]()
        print(json.dumps({"config": name, **result, "device": device}), flush=True)


if __name__ == "__main__":
    sys.path.insert(0, str(REPO))
    main()

"""Accuracy audit: regenerate the docs/ACCURACY.md tables from scratch.

Truth is a double-double QT12 integration on the host CPU — "dd" (TwoFloat
over real f64 state, f64 force: the reference's ``Double<T>`` convergence
fixture, solar_system_convergence.rs:12-110) or "ddf" (dd state AND dd
force, the independent numpy/C++ stepper in truth_np.py /
ddtruth_native.py).  Candidate engines run on the process default device
(the GPU when present) and are compared against the truth at every
checkpoint.

Modes
-----
ref64       plain f64 state (elm2_step) — the Rust reference's numerics
            (same IEEE f64 multistep arithmetic)
expansion   quad-f32 expansion state + f64 force (elm2_step_q)
expansion3  expansion state + 3-limb force (error-free pair deltas)
expansionF  expansion state + FULL 3-limb force (3-limb r^2/rsqrt/mu chain)

Examples
--------
CI-sized (also the pytest gate, tests/test_accuracy_gate.py)::

    python tools/accuracy_audit.py --scene full_solar_system_2433282.5 \
        --days 60 --checkpoints 2 --modes ref64,expansion

The ACCURACY.md century table (hours of CPU truth)::

    python tools/accuracy_audit.py --years 100 --checkpoints 10 \
        --modes expansion,expansion3,expansionF --csv docs/accuracy_100y.csv

The 76-year REAL-JPL oracle (integrates full_solar_system from the bundled
1950-01-01 Horizons snapshot and compares Sun/Earth/Moon against the bundled
real 2026 snapshot systems/sun_earth_moon_2461041.5)::

    python tools/accuracy_audit.py --oracle --modes expansion
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

import jax
import jax.numpy as jnp
import numpy as np

from ephemeris_explorer_tpu import Duration, Epoch  # noqa: E402
from ephemeris_explorer_tpu.integrators import get, multistep  # noqa: E402
from ephemeris_explorer_tpu.io import scene  # noqa: E402
from ephemeris_explorer_tpu.ops import expansion as ex  # noqa: E402
from ephemeris_explorer_tpu.ops import nbody  # noqa: E402

# Sun + planet(-barycenter)s: the "planets only" rows of the table.
PLANETS = {
    "Sun", "Mercury", "Venus", "Earth", "Mars", "Jupiter", "Saturn",
    "Uranus", "Neptune", "Pluto", "JupiterBarycenter", "SaturnBarycenter",
    "UranusBarycenter", "NeptuneBarycenter", "PlutoBarycenter",
}


def _dd_seed_carry(tab, mu, t0, pos, vel, h):
    """Seed an expansion-engine carry from the ddf truth's OWN startup ring.

    Bisection instrument for the linear worst-moon phase drift: the dd-force
    numpy startup (2^-106) is converted limb-exactly into the engine's
    4-limb expansion carry.  If an engine run from this seed still drifts,
    the drift lives in the main-scan recursion arithmetic; if it vanishes,
    the seed was the startup.
    """
    from ephemeris_explorer_tpu import truth_np as tn

    mu_np = np.asarray(mu, np.float64)
    c = tn.elm2_init(
        tab, mu_np, float(t0), np.asarray(pos, np.float64),
        np.asarray(vel, np.float64), h,
    )

    def dd_to_limbs(hi, lo):
        # sequential limb extraction in dd arithmetic: exact until the
        # residual falls below ~2^-96 of the value
        v = tn.TF(np.asarray(hi, np.float64), np.asarray(lo, np.float64))
        limbs = []
        for _ in range(ex.K):
            l = v.hi.astype(np.float32)
            limbs.append(jnp.asarray(l))
            v = tn.sub(v, tn.from_float(l.astype(np.float64)))
        return tuple(limbs)

    return multistep.ELM2CarryQ(
        t=jnp.asarray(c.t, jnp.float64),
        ys=dd_to_limbs(c.ys.hi, c.ys.lo),
        ddys=jnp.asarray(c.ddys.hi + c.ddys.lo),
        dy=jnp.asarray(c.dy.hi + c.dy.lo),
    )


def _chunk_runner(
    mode: str, tab, mu, t0, pos, vel, h, chunk_steps: int, device, pert_specs=(),
    dd_startup: bool = False, precise_sums: bool = False,
):
    """(carry, step_chunk, extract_pos) for one engine mode."""
    mu_host = np.asarray(mu, np.float64)
    pos_host = np.asarray(pos, np.float64)
    vel_host = np.asarray(vel, np.float64)
    mu = jax.device_put(jnp.asarray(mu), device)

    if pert_specs:
        from ephemeris_explorer_tpu.ops import perturbations as _perts

        pert = _perts.build(tuple(pert_specs))

        def accel(t, y, dy):
            return nbody.pairwise_accel(y, mu) + pert(t, y, dy, mu)

        accel.needs_velocity = True
    else:

        def accel(t, y):
            return nbody.pairwise_accel(y, mu)

    accel_limbs = None
    if mode == "expansion3":
        from ephemeris_explorer_tpu.ops.nbody_modes import pairwise_accel_limbs

        def accel_limbs(t, limbs):
            return pairwise_accel_limbs(limbs[0], limbs[1], limbs[2], mu)
    elif mode == "expansionF":
        from ephemeris_explorer_tpu.ops.nbody_full3 import pairwise_accel_full3

        def accel_limbs(t, limbs):
            return pairwise_accel_full3(limbs[0], limbs[1], limbs[2], mu)

    with jax.default_device(device):
        t0 = jnp.asarray(t0, jnp.float64)
        pos = jnp.asarray(pos)
        vel = jnp.asarray(vel)
        if mode == "dd":
            carry = multistep.elm2_init_c(tab, accel, t0, pos, vel, h)
            step = lambda c: multistep.elm2_step_c(tab, accel, h, c)  # noqa: E731
            extract = lambda c: np.asarray(c.ys.hi[0]) + np.asarray(c.ys.lo[0])  # noqa: E731
        elif mode == "ddf":
            # dd state AND dd force: the truth-grade variant that measures
            # the `dd` truth's own f64-force rounding envelope.  Runs in PURE
            # NUMPY (truth_np), startup included: XLA:CPU cannot compile the
            # flat jitted dd-force graph in practical time/memory AND the
            # compiled composition silently degrades the dd force to f64
            # grade (~1e-15 rel vs the f128 oracle; numpy holds ~3e-19 —
            # see the truth_np module docstring for both measurements).
            from ephemeris_explorer_tpu import ddtruth_native, truth_np

            mu_np = np.asarray(mu, dtype=np.float64)
            carry = truth_np.elm2_init(
                tab, mu_np, float(t0), np.asarray(pos, np.float64),
                np.asarray(vel, np.float64), h,
            )
            extract = lambda c: c.ys.hi[0] + c.ys.lo[0]  # noqa: E731

            if ddtruth_native.available():
                # bit-identical compiled stepper (load-time bitwise gate +
                # tests/test_ddtruth_native.py); same trajectory, ~minutes
                # instead of hours for the century truth
                def run_chunk_np(c):
                    return ddtruth_native.run_chunk(tab, mu_np, h, c, chunk_steps)
            else:
                def run_chunk_np(c):
                    for _ in range(chunk_steps):
                        c = truth_np.elm2_step(tab, mu_np, h, c)
                    return c

            return carry, run_chunk_np, extract
        elif mode == "ref64":
            carry = multistep.elm2_init(tab, accel, t0, pos, vel, h)
            step = lambda c: multistep.elm2_step(tab, accel, h, c)  # noqa: E731
            extract = lambda c: np.asarray(c.ys[0])  # noqa: E731
        elif mode in ("expansion", "expansion3", "expansionF"):
            # limb-aware startup (same force the main scan uses): without it
            # the starter's f64-rounded positions seed moon phase drift
            # (see elm2_init_q docstring / docs/ACCURACY.md)
            if dd_startup:
                carry = _dd_seed_carry(tab, mu_host, t0, pos_host, vel_host, h)
            else:
                carry = multistep.elm2_init_q(
                    tab, accel, t0, pos, vel, h, accel_limbs=accel_limbs,
                    y0_limbs=ex.from_f64_host(pos_host),
                )
            step = lambda c: multistep.elm2_step_q(  # noqa: E731
                tab, accel, h, c, accel_limbs=accel_limbs,
                precise_sums=precise_sums,
            )
            extract = lambda c: sum(  # noqa: E731
                np.asarray(l[0], dtype=np.float64) for l in c.ys
            )
        else:
            raise ValueError(mode)

    @jax.jit
    def run_chunk(c):
        def body(c, _):
            return step(c), None

        c, _ = jax.lax.scan(body, c, None, length=chunk_steps)
        return c

    return carry, run_chunk, extract


def audit(
    scene_name: str,
    total_steps: int,
    checkpoints: int,
    modes: list[str],
    dt: float | None = None,
    verbose: bool = True,
    truth: str = "dd",
    traj_cache: str | None = None,
    dd_startup: bool = False,
    precise_sums: bool = False,
) -> dict:
    """Integrate truth + candidate modes; return per-checkpoint max errors.

    ``truth`` picks the oracle: "dd" (double-double state, plain-f64 force —
    the reference's Double<T> recipe) or "ddf" (dd state AND dd force,
    ~2^-106 throughout; measures the dd truth's own force-rounding floor).
    ``traj_cache``: directory to persist each mode's checkpoint trajectory
    (.npy keyed by scene/dt/steps/checkpoints/mode) — the CPU truth runs
    cost hours at multi-year spans; caching lets later comparisons reuse
    them.
    Returns {mode: [(sim_days, max_err_km_all, max_err_km_planets), ...]}.
    """
    sc = scene.load_scene(REPO / "systems" / scene_name)
    state = sc.state
    h = float(dt if dt is not None else sc.settings.dt.as_seconds())
    tab = get("QuinlanTremaine12")
    names = [b.name for b in state.bodies]
    planet_rows = np.array([n in PLANETS for n in names])

    chunk = max((total_steps - tab.order) // checkpoints, 1)
    n_chunks = (total_steps - tab.order) // chunk

    cpu = jax.devices("cpu")[0]
    default = jax.devices()[0]

    runs = {}
    for mode in [truth] + modes:
        cache_f = None
        if traj_cache:
            from pathlib import Path as _P

            seed_tag = "+ddstart" if (dd_startup and mode.startswith("expansion")) else ""
            if precise_sums and mode.startswith("expansion"):
                seed_tag += "+psums"
            key = f"{scene_name}_h{h:g}_s{total_steps}_c{checkpoints}_{mode}{seed_tag}.npy"
            cache_f = _P(traj_cache) / key
            if cache_f.exists():
                runs[mode] = np.load(cache_f)
                if verbose:
                    print(f"  [{mode}] loaded from cache {cache_f}", file=sys.stderr)
                continue
        device = cpu if mode in ("dd", "ddf") else default
        t_start = time.time()
        carry, run_chunk, extract = _chunk_runner(
            mode, tab, state.mus(), state.epoch.as_offset_seconds(),
            state.positions(), state.velocities(), h, chunk, device,
            dd_startup=dd_startup, precise_sums=precise_sums,
        )
        traj = []
        for k in range(n_chunks):
            carry = run_chunk(carry)
            traj.append(extract(carry))
            if verbose:
                el = time.time() - t_start
                print(
                    f"  [{mode}] checkpoint {k + 1}/{n_chunks} "
                    f"({(tab.order + (k + 1) * chunk) * abs(h) / 86400.0:.1f} d, "
                    f"{el:.1f} s elapsed)",
                    file=sys.stderr,
                )
        runs[mode] = np.stack(traj)  # (n_chunks, N, 3)
        if cache_f is not None:
            cache_f.parent.mkdir(parents=True, exist_ok=True)
            np.save(cache_f, runs[mode])

    truth_traj = runs.pop(truth)
    out = {}
    per_body = {}
    for mode, traj in runs.items():
        rows = []
        for k in range(truth_traj.shape[0]):
            err = np.linalg.norm(traj[k] - truth_traj[k], axis=-1)  # (N,)
            days = (tab.order + (k + 1) * chunk) * abs(h) / 86400.0
            rows.append(
                (days, float(np.max(err)), float(np.max(err[planet_rows])))
            )
        out[mode] = rows
        # per-body error at EVERY checkpoint (km), worst-last ordering by the
        # final checkpoint — names the body behind each max_all_km figure
        final_err = np.linalg.norm(traj[-1] - truth_traj[-1], axis=-1)
        series = np.linalg.norm(traj - truth_traj, axis=-1)  # (K, N)
        order = np.argsort(final_err)
        per_body[mode] = [
            (names[i], [float(series[k, i]) for k in range(series.shape[0])])
            for i in order
        ]
    out["__per_body__"] = per_body
    return out


def oracle_76y(
    mode: str, dt: float = 600.0, verbose: bool = True, pn: bool = False
) -> dict:
    """Integrate full_solar_system 1950 -> JD 2461041.5 (27,759 d) and compare
    Sun/Earth/Moon against the bundled REAL Horizons snapshot at that epoch.

    This is an external-data gate like jpl_comparison.rs:56-117, but offline:
    both endpoint snapshots ship with the reference.  The residual is
    dominated by the Newtonian point-mass model (relativistic precession,
    asteroids), not by integrator roundoff — expect O(1e3..1e4 km) on Earth.
    """
    sc = scene.load_scene(REPO / "systems" / "full_solar_system_2433282.5")
    target = scene.load_state(
        REPO / "systems" / "sun_earth_moon_2461041.5" / "state.json"
    )
    state = sc.state
    span_s = target.epoch.as_offset_seconds() - state.epoch.as_offset_seconds()
    total_steps = int(round(span_s / dt))
    assert abs(total_steps * dt - span_s) < 1e-6, "dt must divide the span"

    tab = get("QuinlanTremaine12")
    device = jax.devices()[0]
    n_chunks = 16
    chunk = (total_steps - tab.order) // n_chunks
    rem = (total_steps - tab.order) - chunk * n_chunks

    pert_specs = ()
    if pn:
        from ephemeris_explorer_tpu.ops import perturbations as _perts

        names_all = [b.name for b in state.bodies]
        pert_specs = (_perts.spec_schwarzschild(names_all.index("Sun")),)

    carry, run_chunk, extract = _chunk_runner(
        mode, tab, state.mus(), state.epoch.as_offset_seconds(),
        state.positions(), state.velocities(), dt, chunk, device,
        pert_specs=pert_specs,
    )
    t_start = time.time()
    for k in range(n_chunks):
        carry = run_chunk(carry)
        if verbose:
            print(
                f"  [{mode}] {k + 1}/{n_chunks} ({time.time() - t_start:.1f} s)",
                file=sys.stderr,
            )
    if rem:
        _, run_rem, extract = _chunk_runner(
            mode, tab, state.mus(), 0.0, state.positions(), state.velocities(),
            dt, rem, device,
        )
        carry = run_rem(carry)
    final = extract(carry)

    names = [b.name for b in state.bodies]
    errs = {}
    for tb in target.bodies:
        i = names.index(tb.name)
        errs[tb.name] = float(np.linalg.norm(final[i] - tb.position))
    # geocentric lunar error: the Moon's SSB error is dominated by the shared
    # Earth-orbit drift; relative to Earth is the meaningful lunar metric
    tgt = {b.name: b.position for b in target.bodies}
    if "Moon" in tgt and "Earth" in tgt:
        rel_ours = final[names.index("Moon")] - final[names.index("Earth")]
        rel_jpl = tgt["Moon"] - tgt["Earth"]
        errs["Moon-Earth"] = float(np.linalg.norm(rel_ours - rel_jpl))
    return errs


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--scene", default="full_solar_system_2433282.5")
    p.add_argument("--years", type=float, default=None)
    p.add_argument("--days", type=float, default=None)
    p.add_argument("--dt", type=float, default=None, help="step seconds (default: scene dt)")
    p.add_argument("--checkpoints", type=int, default=4)
    p.add_argument("--modes", default="ref64,expansion")
    p.add_argument(
        "--truth", choices=("dd", "ddf"), default="dd",
        help="dd: dd state + f64 force (reference recipe); ddf: dd force too",
    )
    p.add_argument(
        "--traj-cache", default=None,
        help="directory to persist/reuse per-mode checkpoint trajectories",
    )
    p.add_argument(
        "--precise-sums", action="store_true",
        help="expansion modes: pair-precision beta sums over the (hi, lo) "
        "acceleration-ring view (multistep._wsum_precise) instead of the "
        "f64 dot",
    )
    p.add_argument(
        "--dd-startup", action="store_true",
        help="seed expansion engines from the ddf truth's dd startup ring "
        "(drift-bisection instrument: startup vs recursion)",
    )
    p.add_argument(
        "--worst", type=int, default=0,
        help="print the N worst bodies' per-checkpoint error series per mode",
    )
    p.add_argument("--csv", default=None)
    p.add_argument("--json", dest="json_out", default=None)
    p.add_argument("--oracle", action="store_true", help="76-year real-JPL endpoint check")
    p.add_argument(
        "--pn", action="store_true",
        help="add the 1PN Schwarzschild term (Sun) — beyond-reference physics",
    )
    args = p.parse_args(argv)
    modes = args.modes.split(",")

    if args.oracle:
        for mode in modes:
            errs = oracle_76y(mode, dt=float(args.dt or 600.0), pn=args.pn)
            tag = " +1PN" if args.pn else ""
            print(f"oracle 1950->2026 (76.0 y, REAL JPL endpoints), mode={mode}{tag}:")
            for name, e in errs.items():
                print(f"  {name:8s} {e:12.1f} km")
        return 0

    if args.days is None and args.years is None:
        args.years = 1.0
    span_s = (args.years * 365.25 * 86400.0) if args.years else args.days * 86400.0
    sc = scene.load_scene(REPO / "systems" / args.scene)
    h = float(args.dt if args.dt is not None else sc.settings.dt.as_seconds())
    total_steps = int(round(span_s / h))

    res = audit(
        args.scene, total_steps, args.checkpoints, modes, dt=args.dt,
        truth=args.truth, traj_cache=args.traj_cache,
        dd_startup=args.dd_startup, precise_sums=args.precise_sums,
    )

    per_body = res.pop("__per_body__", {})
    tdesc = "dd128(QT12,cpu)" if args.truth == "dd" else "dd128+ddforce(QT12,cpu)"
    print(f"# scene={args.scene} dt={h:.0f}s steps={total_steps} "
          f"truth={tdesc}")
    print(f"{'mode':12s} {'sim_days':>9s} {'max_all_km':>12s} {'max_planets_km':>14s}")
    rows_csv = []
    for mode, rows in res.items():
        for days, e_all, e_pl in rows:
            print(f"{mode:12s} {days:9.1f} {e_all:12.6f} {e_pl:14.6f}")
            rows_csv.append((mode, days, e_all, e_pl))
    if args.worst:
        for mode, ranked in per_body.items():
            print(f"# worst {args.worst} bodies, mode={mode} "
                  f"(km at each checkpoint, worst last):")
            for name, series in ranked[-args.worst:]:
                svals = " ".join(f"{v:.6f}" for v in series)
                print(f"  {name:24s} {svals}")
    if args.csv:
        with open(args.csv, "w") as f:
            f.write("mode,sim_days,max_all_km,max_planets_km\n")
            for r in rows_csv:
                f.write(f"{r[0]},{r[1]:.2f},{r[2]:.9f},{r[3]:.9f}\n")
    if args.json_out:
        with open(args.json_out, "w") as f:
            json.dump({m: r for m, r in res.items()}, f)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

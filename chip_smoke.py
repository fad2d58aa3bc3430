#!/usr/bin/env python3
"""Smoke test of the engine on one NVIDIA GPU: the quickest proof that the
system still starts, runs its main path and gives right answers on the card.

    python chip_smoke.py               # phases a-g on one card
    python chip_smoke.py --four-cards  # the multi-card path only, 4 cards

Phases (one process, one card):

  a  device: card name and power limit (nvidia-smi) beside JAX's device_kind
  b  session: full_solar_system, generate +-2 y (QT12, dt 10 min), spawn every
     bundled ship, ship_segments, export_state; cold and warm wall times;
     1-64 ship batches on the card vs the host CPU
  c  accuracy: tools/accuracy_audit at 60 days against the independent
     double-double numpy/C++ truth
  d  large N: QT12 at N=4096 (elm2_init + a scanned elm2_step chunk) on
     the production force (ops/nbody.pairwise_accel_auto); first force vs
     a numpy f64 direct sum
  e  fleet: 64 ships x 300 days on the card vs the host CPU backend
  f  error-free transforms compiled for the card vs exact IEEE references
  g  the hand-written Pallas force kernel vs XLA's plain version

Every phase raises on a failed check; the last stdout line is the JSON
contract line.  Exits non-zero without printing it when JAX finds no GPU.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent
SCENE = "full_solar_system_2433282.5"
N_LARGE = 4096
CHUNK = 400


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
    ).stdout.strip().splitlines()
    return out[0].strip()


class Log:
    """Prints phase results; every line that carries a time names the card."""

    def __init__(self, card: str, kind: str):
        self.tag = f"[{card} | {kind}]"

    def __call__(self, msg: str, timed: bool = False) -> None:
        print(f"{msg}  {self.tag}" if timed else msg, flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def timed(fn, *args):
    import jax

    t0 = time.perf_counter()
    out = jax.block_until_ready(fn(*args))
    return out, time.perf_counter() - t0


def _cluster(n: int, seed: int = 0):
    rng = np.random.default_rng(seed)
    return (
        rng.normal(size=(n, 3)) * 1.0e6,
        rng.normal(size=(n, 3)),
        rng.uniform(1.0e3, 1.0e5, size=n),
    )


def fleet_ships(eph, t0: float, n_ships: int, mission_days: float, seed: int = 42):
    """Heliocentric fleet near Earth's orbit, one Sun-frame burn each."""
    from ephemeris_explorer_tpu.ftime import Duration, Epoch
    from ephemeris_explorer_tpu.io.scene import Ship, ShipBurn

    rng = np.random.default_rng(seed)
    ep, ev = eph["Earth"].state_vector(t0)
    ships = []
    for k in range(n_ships):
        offset = rng.normal(size=3) * 5.0e5 + np.array([2.0e6, 0.0, 0.0])
        dv = 1.0 + rng.normal(size=3) * 1e-3
        burn = ShipBurn(
            start=Epoch.from_offset_seconds(t0 + 10 * 86400.0 + k * 3600.0),
            duration=Duration.from_seconds(600.0),
            acceleration=np.array([2e-3, 0.0, 0.0]),
            reference="Sun",
        )
        ships.append(Ship(
            name=f"fleet-{k}", integrator="Verner87", tolerance=1e-3,
            start=Epoch.from_offset_seconds(t0),
            end=Epoch.from_offset_seconds(t0 + mission_days * 86400.0),
            position=ep + offset, velocity=ev * dv, burns=[burn],
        ))
    return ships


def fleet_args(eph, ships):
    """The batch driver's operands (pack, timelines, t0, p0, v0, end)."""
    from ephemeris_explorer_tpu.spacecraft import build_timeline, stack_timelines

    index = {nm: i for i, nm in enumerate(eph.names)}
    return (
        eph.pack(),
        stack_timelines([build_timeline(s.burns, index) for s in ships]),
        np.asarray([s.start.as_offset_seconds() for s in ships]),
        np.stack([s.position for s in ships]),
        np.stack([s.velocity for s in ships]),
        np.asarray([s.end.as_offset_seconds() for s in ships]),
    )


def fleet_driver(ships):
    """The jitted batch driver: it runs where its operands are committed."""
    import jax

    from ephemeris_explorer_tpu.integrators.methods import get as get_method
    from ephemeris_explorer_tpu.spacecraft import propagate_batch, ship_params

    tab, params = get_method(ships[0].integrator), ship_params(ships[0])
    return jax.jit(lambda *a: propagate_batch(tab, *a, params, max_knots=8192))


def last_positions(r) -> np.ndarray:
    """Final knot of every ship of a batch result."""
    count = np.asarray(r.count)
    return np.asarray(r.pos)[np.arange(len(count)), count - 1]


# ---------------------------------------------------------------------------
# b. the interactive session
# ---------------------------------------------------------------------------


def phase_session(log: Log) -> None:
    import jax

    from ephemeris_explorer_tpu import Duration
    from ephemeris_explorer_tpu.api import Universe
    from ephemeris_explorer_tpu.ephemeris import generate_ephemeris

    scene_dir = REPO / "systems" / SCENE
    two_years = Duration.from_years(2.0)
    unis = []
    for label in ("cold", "warm"):
        uni = Universe.load(scene_dir)
        t0 = time.perf_counter()
        uni.generate(two_years, backward_span=two_years)
        t_gen = time.perf_counter() - t0
        t0 = time.perf_counter()
        entries = [uni.spawn_ship(s) for s in uni.scene.ships]
        t_spawn = time.perf_counter() - t0
        log(f"b session {label}: generate +-2 y {t_gen:.3f} s, "
            f"spawn {len(entries)} ships {t_spawn:.3f} s", timed=True)
        unis.append(uni)
    uni = unis[-1]
    span_d = (uni.ephemeris.end - uni.ephemeris.start).as_seconds() / 86400.0
    check(span_d > 4 * 365.0 - 30.0, f"ephemeris spans only {span_d:.1f} d")
    eph_start = uni.ephemeris.start.as_offset_seconds()
    eph_end = uni.ephemeris.end.as_offset_seconds()
    for ship in uni.scene.ships:
        name = ship.name
        tr = uni.ships[name].trajectory
        if not eph_start <= ship.start.as_offset_seconds() < eph_end:
            # a ship that departs outside the generated span has no context
            check(tr is None or len(tr.ts) == 0, f"{name}: propagated without context")
            log(f"b ship {name!r}: departs {ship.start}, outside the ephemeris; "
                "not propagated")
            continue
        segs = uni.ship_segments(name)
        check(len(tr.ts) > 1 and np.isfinite(tr.pos).all(), f"{name}: no finite trajectory")
        log(f"b ship {name!r}: {len(segs)} segments, "
            f"{len(uni.ships[name].transitions)} SOI transitions, "
            f"{(tr.end_s - tr.start_s) / 86400.0:.1f} d, propagated on "
            f"{jax.default_backend()}")
    snap = uni.export_state(uni.ephemeris.end)
    pos = np.stack([b.position for b in snap.bodies])
    check(np.isfinite(pos).all() and len(snap.bodies) == 32, "export_state")
    log(f"b export_state at {snap.epoch}: {len(snap.bodies)} bodies")

    # the same 60-day forward generation on the host CPU backend: the card's
    # ephemeris must agree to the f64 chaos envelope (ref64 vs the dd truth
    # is ~0.1 km at 60 d, docs/ACCURACY.md)
    sc = uni.scene
    with jax.default_device(jax.devices("cpu")[0]):
        host = generate_ephemeris(sc.state, sc.settings, Duration.from_days(60.0))
    t_cmp = sc.state.epoch.as_offset_seconds() + 30.0 * 86400.0
    diff = np.abs(host.positions(t_cmp) - uni.ephemeris.positions(t_cmp)).max()
    log(f"b card vs host ephemeris at +30 d: max |dr| = {diff:.3e} km (limit 1 km)")
    check(diff < 1.0, "card ephemeris departs from the host's")

    # small ship batches on the card and on the host (operands committed
    # to each device): the evidence for spacecraft.py sending every batch
    # to the default device
    eph = generate_ephemeris(sc.state, sc.settings, Duration.from_days(320.0))
    t0s = sc.state.epoch.as_offset_seconds() + 86400.0
    for n in (1, 4, 16, 64):
        ships = fleet_ships(eph, t0s, n, 300.0)
        fn, args = fleet_driver(ships), fleet_args(eph, ships)
        row = []
        for dev in (jax.devices()[0], jax.devices("cpu")[0]):
            placed = jax.device_put(args, dev)
            timed(fn, *placed)
            row.append(timed(fn, *placed)[1])
        log(f"b {n:2d} ships x 300 d: card {row[0]:.4f} s, "
            f"host {row[1]:.4f} s", timed=True)


# ---------------------------------------------------------------------------
# c. accuracy against the double-double truth
# ---------------------------------------------------------------------------


def phase_accuracy(log: Log) -> None:
    sys.path.insert(0, str(REPO / "tools"))
    from accuracy_audit import audit

    modes = ["ref64", "expansion", "expansionF"]
    res = audit(SCENE, total_steps=8640, checkpoints=1, modes=modes,
                truth="ddf", verbose=False)
    for mode in modes:
        days, err_all, err_pl = res[mode][-1]
        log(f"c {mode:10s} vs ddf truth at {days:.1f} d: worst body "
            f"{err_all * 1e6:.3f} mm, planets {err_pl * 1e6:.3f} mm")
    check(0.010 < res["ref64"][-1][1] < 1.0, "ref64 outside 10 m - 1 km")
    for mode in ("expansion", "expansionF"):
        check(res[mode][-1][1] < 0.010, f"{mode} misses the 10 m gate")


# ---------------------------------------------------------------------------
# d. large N
# ---------------------------------------------------------------------------


def direct_sum(pos: np.ndarray, mu: np.ndarray, block: int = 256):
    """numpy f64 direct sum and the per-body sum of |terms| (its
    rounding scale)."""
    n = pos.shape[0]
    acc = np.zeros_like(pos)
    scale = np.zeros(n)
    for i0 in range(0, n, block):
        d = pos[None, :, :] - pos[i0:i0 + block, None, :]
        r2 = np.sum(d * d, axis=-1)
        rows = np.arange(i0, min(i0 + block, n))
        r2[rows - i0, rows] = 1.0
        w = mu[None, :] / (r2 * np.sqrt(r2))
        w[rows - i0, rows] = 0.0
        acc[i0:i0 + block] = np.sum(d * w[..., None], axis=1)
        scale[i0:i0 + block] = np.sum(
            np.linalg.norm(d, axis=-1) * w, axis=1)
    return acc, scale


def make_chunk(accel_fn, mu, n_steps: int):
    import jax
    import jax.numpy as jnp

    from ephemeris_explorer_tpu.integrators import get
    from ephemeris_explorer_tpu.integrators.multistep import (
        elm2_init, elm2_step, elm2_velocity,
    )

    tab = get("QuinlanTremaine12")
    mu_dev = jnp.asarray(mu)
    h = 600.0

    def accel(t, y):
        return accel_fn(y, mu_dev)

    @jax.jit
    def chunk(carry):
        def body(c, _):
            return elm2_step(tab, accel, h, c, with_velocity=False), None

        c, _ = jax.lax.scan(body, carry, None, length=n_steps)
        return c._replace(dy=elm2_velocity(tab, c, h))

    init = jax.jit(lambda p, v: elm2_init(tab, accel, 0.0, p, v, h))
    return init, chunk


def chunk_rate(accel_fn, n: int, reps: int = 3):
    """(body-steps/s, final carry, compiled chunk) for a QT12 chunk."""
    import jax.numpy as jnp

    pos, vel, mu = _cluster(n)
    init, chunk = make_chunk(accel_fn, mu, CHUNK)
    carry, _ = timed(init, jnp.asarray(pos), jnp.asarray(vel))
    carry, _ = timed(chunk, carry)  # compile + warm
    best = float("inf")
    for _ in range(reps):
        carry, dt = timed(chunk, carry)
        best = min(best, dt)
    check(np.isfinite(np.asarray(carry.ys[0])).all(), f"N={n}: non-finite state")
    return n * CHUNK / best, carry, chunk


def phase_large_n(log: Log) -> None:
    import jax
    import jax.numpy as jnp

    from ephemeris_explorer_tpu.ops import nbody

    pos, _, mu = _cluster(N_LARGE)
    force = jax.jit(nbody.pairwise_accel).lower(jnp.asarray(pos), jnp.asarray(mu)).compile()
    hlo = force.as_text()
    log(f"d XLA force N={N_LARGE} alone: {hlo.count(' fusion(')} fusions, "
        f"(N, N) f64 buffer in optimized HLO: {f'f64[{N_LARGE},{N_LARGE}' in hlo}, "
        f"memory_analysis: {force.memory_analysis()}")
    ref, scale = direct_sum(pos, mu)
    # the first force evaluation of the chunk below (the production force
    # picks the Pallas kernel at this N on a GPU) and XLA's plain version
    for label, fn in (("production", nbody.pairwise_accel_auto), ("XLA", force)):
        a = np.asarray(fn(jnp.asarray(pos), jnp.asarray(mu)))
        err = np.linalg.norm(a - ref, axis=1)
        rel = float(np.max(err / scale))
        rel_net = float(np.max(err / np.linalg.norm(ref, axis=1)))
        log(f"d {label} force N={N_LARGE} vs numpy f64: max |da|/sum|terms| = "
            f"{rel:.3e}, max |da|/|a| = {rel_net:.3e} (limit 1e-12 each)")
        check(max(rel, rel_net) < 1e-12,
              f"large-N {label} force departs from the numpy direct sum")

    rate, carry, chunk = chunk_rate(nbody.pairwise_accel_auto, N_LARGE)
    log(f"d QT12 N={N_LARGE} chunk of {CHUNK} steps, production force: "
        f"{rate:.1f} body-steps/s", timed=True)
    mem = chunk.lower(carry).compile().memory_analysis()
    log(f"d chunk memory_analysis: {mem}")
    # the multistep update alone: the same chunk with a negligible force
    r_upd = chunk_rate(lambda y, mu: y * 1e-30, N_LARGE)[0]
    t_step = N_LARGE / r_upd
    ring = 12 * N_LARGE * 3 * 8          # one (ORDER, N, 3) f64 ring
    log(f"d update-only chunk N={N_LARGE}: {t_step * 1e6:.3f} us/step, "
        f"{4 * ring / t_step / 1e9:.1f} GB/s for the two rings read+written",
        timed=True)


# ---------------------------------------------------------------------------
# e. fleet on the card vs the host
# ---------------------------------------------------------------------------


def phase_fleet(log: Log) -> None:
    import jax

    from ephemeris_explorer_tpu import Duration
    from ephemeris_explorer_tpu.ephemeris import generate_ephemeris
    from ephemeris_explorer_tpu.io.scene import load_scene
    from ephemeris_explorer_tpu.spacecraft import propagate_ships

    sc = load_scene(REPO / "systems" / SCENE)
    eph = generate_ephemeris(sc.state, sc.settings, Duration.from_days(320.0))
    ships = fleet_ships(eph, sc.state.epoch.as_offset_seconds() + 86400.0, 64, 300.0)
    card = propagate_ships(eph, ships, max_knots=8192)
    t0 = time.perf_counter()
    card = propagate_ships(eph, ships, max_knots=8192)
    t_card = time.perf_counter() - t0
    host = fleet_driver(ships)(*jax.device_put(fleet_args(eph, ships), jax.devices("cpu")[0]))
    trajs = [card[s.name] for s in ships]
    check(min(tr.end_s - tr.start_s for tr in trajs) > 290 * 86400.0,
          "fleet did not cover its missions")
    dr = np.linalg.norm(np.stack([tr.pos[-1] for tr in trajs]) - last_positions(host), axis=1)
    log(f"e fleet 64 x 300 d: card {64 * 300.0 / t_card:.1f} ship-days/s, "
        f"max |dr| card vs host at mission end {dr.max():.3e} km (limit 0.1 km)",
        timed=True)
    # adaptive control (tol 1e-3 per step) on the card's rsqrt/FMA rounding
    # may accept different steps than the host, so the two runs agree to
    # the accumulated local-error budget, not to the bit; measured 2.3 m,
    # the limit is ~40x that
    check(dr.max() < 0.1, "card fleet departs from the host fleet")


# ---------------------------------------------------------------------------
# f. error-free transforms on the card
# ---------------------------------------------------------------------------


def phase_eft(log: Log, n: int = 1 << 20) -> None:
    """Bitwise check of the f32 (and f64) error-free transforms as compiled
    for the card against exact IEEE references; raises unless all exact
    (the extended precisions are built on them)."""
    import jax
    import jax.numpy as jnp

    from ephemeris_explorer_tpu.integrators import get, multistep
    from ephemeris_explorer_tpu.ops import eft
    from ephemeris_explorer_tpu.ops import expansion as ex

    rng = np.random.default_rng(7)

    def draw(dtype, spread):
        return (rng.uniform(0.5, 1.0, n) * np.exp2(rng.integers(-spread, spread, n))
                * rng.choice([-1.0, 1.0], n)).astype(dtype)

    cpu = jax.devices("cpu")[0]
    results = {}
    for dtype, spread in ((np.float32, 10), (np.float64, 20)):
        a, b = draw(dtype, spread), draw(dtype, spread)
        tag = np.dtype(dtype).name
        cases = {
            "two_sum": (eft.two_sum, (a, b)),
            "two_prod": (eft.two_prod, (a, b)),
            "split": (eft.split, (a,)),
        }
        for name, (fn, args) in cases.items():
            with jax.default_device(cpu):          # per-op, unfused: exact IEEE
                want = [np.asarray(x) for x in fn(*args)]
            got = jax.jit(fn)(*map(jnp.asarray, args))
            results[f"{name}/{tag}"] = all(
                np.array_equal(np.asarray(g), w) for g, w in zip(got, want))

    # f64 -> f32 limb splits (the extended state's lift and the pair view
    # of the force ring) against numpy's exact conversions
    from ephemeris_explorer_tpu.ops import tf96

    x = draw(np.float64, 30) * 1.0e8
    want = ex.from_f64_host(x)
    got = jax.jit(ex.from_f64)(jnp.asarray(x))
    results["expansion.from_f64"] = all(
        np.array_equal(np.asarray(g), np.asarray(w)) for g, w in zip(got, want))
    got = jax.jit(tf96.from_f64)(jnp.asarray(x))
    results["tf96.from_f64"] = all(
        np.array_equal(np.asarray(g), np.asarray(w)) for g, w in zip(got, want[:3]))
    got = jax.jit(multistep._split_pair)(jnp.asarray(x))
    results["split_pair"] = all(
        np.array_equal(np.asarray(g), np.asarray(w)) for g, w in zip(got, want[:2]))

    # 4-limb expansion add (the extended state's update)
    xa = tuple(draw(np.float32, 10) * np.float32(2.0 ** (-24 * k)) for k in range(4))
    xb = tuple(draw(np.float32, 10) * np.float32(2.0 ** (-24 * k)) for k in range(4))
    with jax.default_device(cpu):
        want = [np.asarray(x) for x in ex.add(xa, xb)]
    got = jax.jit(ex.add)(tuple(map(jnp.asarray, xa)), tuple(map(jnp.asarray, xb)))
    results["expansion.add/float32"] = all(
        np.array_equal(np.asarray(g), w) for g, w in zip(got, want))

    # the precise beta-sum cascade: eager per-op on the host is the exact
    # reference (each op compiles alone, nothing fuses)
    tab = get("QuinlanTremaine12")
    w = multistep._prescale_f128(tab.c_dy, 600.0 ** 2, float(tab.beta_d))
    ws = [x for x in w if x != 0.0]
    ring = np.stack([draw(np.float64, 3)[: n // 16] * 1e-6 for _ in ws])
    ring = ring.reshape(len(ws), -1, 4)
    pair = multistep._split_pair(jnp.asarray(ring))
    hi, lo = np.asarray(pair.hi), np.asarray(pair.lo)
    with jax.default_device(cpu):
        want = multistep._wsum_cascade(ws, jnp.asarray(hi), jnp.asarray(lo))
    got = jax.jit(lambda h_, l_: multistep._wsum_cascade(ws, h_, l_))(
        jnp.asarray(hi), jnp.asarray(lo))
    results["wsum_cascade/float32"] = all(
        np.array_equal(np.asarray(g), np.asarray(w_)) for g, w_ in zip(got, want))

    for name, ok in results.items():
        log(f"f {name:22s} {'bitwise exact' if ok else 'NOT exact'} on {n} inputs")
    exact = all(results.values())
    log(f"f verdict: error-free transforms {'exact' if exact else 'NOT exact'} "
        "as compiled for the card")
    check(exact, "error-free transforms not exact on the card: "
          + ", ".join(k for k, ok in results.items() if not ok))


# ---------------------------------------------------------------------------
# g. hand-written kernels vs their plain references
# ---------------------------------------------------------------------------


def phase_kernels(log: Log) -> None:
    import jax
    import jax.numpy as jnp

    from ephemeris_explorer_tpu.ops import nbody, pallas_nbody

    log(f"g production force: Pallas kernel from N={nbody.PALLAS_MIN_BODIES} on")
    for n in (N_LARGE, 32):
        pos, _, mu = _cluster(n, seed=3)
        ref = np.asarray(jax.jit(nbody.pairwise_accel)(jnp.asarray(pos), jnp.asarray(mu)))
        got = np.asarray(pallas_nbody.pairwise_accel(jnp.asarray(pos), jnp.asarray(mu)))
        rel = float(np.max(np.abs(got - ref)) / np.max(np.abs(ref)))
        log(f"g pallas_nbody.pairwise_accel N={n} vs nbody.pairwise_accel "
            f"(both f64): max |da|/max|a| = {rel:.3e} (limit 1e-13)")
        check(rel < 1e-13, f"Pallas force N={n} departs from the XLA force")
        r_xla = chunk_rate(nbody.pairwise_accel, n)[0]
        r_pl = chunk_rate(pallas_nbody.pairwise_accel, n)[0]
        log(f"g QT12 chunk N={n}: XLA force {r_xla:.1f}, Pallas force "
            f"{r_pl:.1f} body-steps/s", timed=True)


# ---------------------------------------------------------------------------
# four cards
# ---------------------------------------------------------------------------


def phase_four_cards(log: Log) -> None:
    import jax
    import jax.numpy as jnp

    from ephemeris_explorer_tpu import Duration
    from ephemeris_explorer_tpu.ephemeris import generate_ephemeris
    from ephemeris_explorer_tpu.integrators import get
    from ephemeris_explorer_tpu.integrators.multistep import elm2_init, elm2_step
    from ephemeris_explorer_tpu.io.scene import load_scene
    from ephemeris_explorer_tpu.ops import nbody
    from ephemeris_explorer_tpu.parallel import sharding as sh
    from ephemeris_explorer_tpu.spacecraft import ship_params

    check(len(jax.devices()) >= 4, "--four-cards needs 4 devices")
    tab = get("QuinlanTremaine12")
    h = 600.0
    e, n = 8, 1024
    pos = np.stack([_cluster(n, seed=i)[0] for i in range(e)])
    vel = np.stack([_cluster(n, seed=i)[1] for i in range(e)])
    mu = _cluster(n)[2]
    mu_j = jnp.asarray(mu)

    def accel(t, y):
        return nbody.pairwise_accel(y, mu_j)

    one = jax.devices()[0]
    with jax.default_device(one):
        ref = jax.jit(jax.vmap(
            lambda p, v: elm2_step(tab, accel, h, elm2_init(tab, accel, 0.0, p, v, h))
        ))(jnp.asarray(pos), jnp.asarray(vel))
    for data, model in ((1, 1), (4, 1), (2, 2), (1, 4)):
        mesh = sh.make_mesh(data=data, model=model)
        carry = sh.init_ensemble_carry(mesh, tab, mu, 0.0, pos, vel, h)
        step = sh.make_sharded_ensemble_step(mesh, tab, mu, h)
        out, dt = timed(step, carry)
        out, dt = timed(step, carry)
        d = np.abs(np.asarray(out.ys[0]) - np.asarray(ref.ys[0])).max()
        s = np.abs(np.asarray(ref.ys[0])).max()
        log(f"4 ensemble step {e}x{n} mesh (data={data}, model={model}): "
            f"max |dy|/max|y| vs one card {d / s:.3e} (limit 1e-12), "
            f"{dt * 1e3:.3f} ms/step", timed=True)
        check(d / s < 1e-12, f"sharded ensemble step ({data}, {model})")

    mesh = sh.make_mesh(data=1, model=4)
    p, _, m = _cluster(N_LARGE)
    rows = jax.NamedSharding(mesh, jax.P("model", None))
    ps = jax.device_put(jnp.asarray(p), rows)
    ms = jax.device_put(jnp.asarray(m), jax.NamedSharding(mesh, jax.P("model")))
    force4 = jax.jit(lambda x, y: sh.pairwise_accel_rowsharded(mesh, x, y))
    a4, dt = timed(force4, ps, ms)
    a4, dt = timed(force4, ps, ms)
    with jax.default_device(one):
        force1 = jax.jit(nbody.pairwise_accel)
        a1, _ = timed(force1, jnp.asarray(p), jnp.asarray(m))
        a1, dt1 = timed(force1, jnp.asarray(p), jnp.asarray(m))
    rel = float(np.max(np.abs(np.asarray(a4) - np.asarray(a1))) / np.max(np.abs(np.asarray(a1))))
    log(f"4 rowsharded force N={N_LARGE} over 4 cards vs one card: "
        f"max |da|/max|a| {rel:.3e} (limit 1e-13), {dt * 1e3:.3f} ms "
        f"(one card {dt1 * 1e3:.3f} ms)", timed=True)
    check(rel < 1e-13, "row-sharded force")

    sc = load_scene(REPO / "systems" / SCENE)
    with jax.default_device(one):
        eph = generate_ephemeris(sc.state, sc.settings, Duration.from_days(320.0))
    ships = fleet_ships(eph, sc.state.epoch.as_offset_seconds() + 86400.0, 64, 300.0)
    args = fleet_args(eph, ships)
    mesh = sh.make_mesh(data=4, model=1)
    fn, place = sh.make_sharded_fleet_propagator(
        mesh, ships[0].integrator, ship_params(ships[0]), max_knots=8192)
    placed = place(*args)
    res, _ = timed(fn, *placed)
    res, dt = timed(fn, *placed)
    fleet1, args1 = fleet_driver(ships), jax.device_put(args, one)
    ref_f, _ = timed(fleet1, *args1)
    ref_f, dt1 = timed(fleet1, *args1)
    same_counts = bool(np.array_equal(np.asarray(res.count), np.asarray(ref_f.count)))
    dr = float(np.max(np.linalg.norm(last_positions(res) - last_positions(ref_f), axis=1)))
    log(f"4 fleet 64 ships x 300 d over 4 cards: {64 * 300.0 / dt:.1f} ship-days/s "
        f"(one card {64 * 300.0 / dt1:.1f}), knot counts equal {same_counts}, "
        f"max |dr| vs one card {dr:.3e} km (limit 0.1 km)", timed=True)
    # each card compiles the driver for a 16-ship batch, not 64, so XLA may
    # fuse and round differently; adaptive control (tol 1e-3 km per step)
    # then carries rounding-level differences to the accumulated local-error
    # budget, as in phase e (measured: 1.8 m after 300 d with equal knot
    # counts; the limit is ~50x that)
    check(same_counts, "sharded fleet took other steps than one card")
    check(dr < 0.1, "sharded fleet departs from one card")


def contract_line(devices) -> str:
    """The last stdout line: success and the device as JAX reports it."""
    return json.dumps({"ok": True, "device": {
        "platform": devices[0].platform,
        "kind": devices[0].device_kind,
        "count": len(devices),
    }})


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument(
        "--four-cards", action="store_true",
        help="run only the multi-card path (needs 4 GPUs) and its comparisons",
    )
    args = p.parse_args(argv)

    import jax

    devices = jax.devices()
    if devices[0].platform != "gpu":
        print(f"chip_smoke: no GPU (JAX platform {devices[0].platform!r})",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    import ephemeris_explorer_tpu  # noqa: F401  (enables x64)

    card = card_line()
    log = Log(card, devices[0].device_kind)
    log(f"a card: {card}; JAX: {devices[0].platform} {devices[0].device_kind} "
        f"x{len(devices)}, jax {jax.__version__}")
    t_start = time.perf_counter()
    if args.four_cards:
        phase_four_cards(log)
    else:
        phase_eft(log)
        phase_kernels(log)
        phase_large_n(log)
        phase_session(log)
        phase_fleet(log)
        phase_accuracy(log)
    log(f"chip_smoke total {time.perf_counter() - t_start:.1f} s", timed=True)
    print(contract_line(devices))
    return 0


if __name__ == "__main__":
    sys.exit(main())

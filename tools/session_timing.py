"""Warm interactive-session timing.

Times the interactive session step by step, so session numbers regenerate
from one command instead of an ad-hoc transcript:

  1. generate 400 d of full_solar_system        (Universe.generate)
  2. spawn + propagate the bundled scene ships  (spawn_scene_ships)
  3. edit a late burn -> incremental replan     (Universe.edit_burn)
  4. tolerance edit -> full replan              (params change restarts
                                                 from scratch,
                                                 flight_plan.rs:264-303)
  5. extend the context 100 d                   (Universe.extend)

Fleet treatment (round-5): the whole session runs ``--runs`` times in one
process — run 0 pays the in-process compiles (on top of the persistent
cache; prime with tools/prime_cache.py for a fully-warm run 0) and is
recorded but EXCLUDED from the published statistics; the published table
is per-step median and min–max spread over the remaining runs.  This is
the same discipline as bench.py's grouped runs: a single run's session
numbers carry the run-to-run jitter of the generate/extend steps, which
medians over >=4 runs pin down.

Usage:
    python tools/session_timing.py [--runs 5] [--json session_timing.json]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

from ephemeris_explorer_tpu import Duration  # noqa: E402
from ephemeris_explorer_tpu.api import Universe  # noqa: E402
from ephemeris_explorer_tpu.io.scene import load_scene  # noqa: E402


def run_session(scene_path: Path, days: float) -> list[tuple[str, float]]:
    """One full interactive session; returns [(step label, seconds)]."""
    steps: list[tuple[str, float]] = []

    def timed(label: str, fn):
        t0 = time.perf_counter()
        out = fn()
        steps.append((label, time.perf_counter() - t0))
        print(f"  {label}: {steps[-1][1]:.1f} s", file=sys.stderr, flush=True)
        return out

    sc = load_scene(scene_path)
    uni = Universe(sc)

    timed(f"generate {days:g} d", lambda: uni.generate(Duration.from_days(days)))
    timed("spawn + propagate scene ships", uni.spawn_scene_ships)

    # Incremental replan: nudge the LATEST burn of a propagated ship by one
    # minute — the restart epoch is the last event common to old/new plans,
    # so every knot before the burn is kept (flight_plan.rs:264-303).
    propagated = [
        (n, e) for n, e in uni.ships.items()
        if e.trajectory is not None and len(e.trajectory.ts)
    ]
    if not propagated:
        raise SystemExit("no propagated ship in this scene/span")
    with_burns = [(n, e) for n, e in propagated if e.plan.burns]
    if with_burns:
        name, entry = max(
            with_burns,
            key=lambda kv: max(
                b.start.as_offset_seconds() for b in kv[1].plan.burns.values()
            ),
        )
        bid, burn = max(
            entry.plan.burns.items(), key=lambda kv: kv[1].start.as_offset_seconds()
        )
        timed(
            "edit burn + incremental replan",
            lambda: uni.edit_burn(
                name, bid, start=burn.start + Duration.from_minutes(1.0)
            ),
        )
    else:
        # burn-less scene (sun_earth_moon): ADD a late burn instead — the
        # replan is still incremental (knots before the new burn are kept)
        from ephemeris_explorer_tpu.api import Burn

        name, entry = propagated[0]
        mid = entry.ship.start + Duration.from_seconds(
            0.75 * (entry.plan.end.as_offset_seconds()
                    - entry.ship.start.as_offset_seconds())
        )
        timed(
            "add burn + incremental replan",
            lambda: uni.add_burn(
                name,
                Burn(start=mid, duration=Duration.from_minutes(5.0),
                     acceleration=[1e-6, 0.0, 0.0]),
            ),
        )

    # Full replan: a tolerance change invalidates every knot (the restart
    # logic treats method/params changes as restart-from-scratch).
    def tol_edit():
        entry = uni.ships[name]
        entry.plan.params = dataclasses.replace(
            entry.plan.params, tol_pos=3e-4, tol_vel=3e-4
        )
        return uni.replan(name)

    timed("tolerance edit + full replan", tol_edit)
    timed("extend 100 d", lambda: uni.extend(Duration.from_days(100.0)))
    return steps


def main() -> None:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--scene", default="full_solar_system_2433282.5")
    p.add_argument("--days", type=float, default=400.0)
    p.add_argument("--runs", type=int, default=5,
                   help="total sessions; run 0 is the in-process warm-up "
                   "and is excluded from the published statistics")
    p.add_argument("--json", dest="json_out", default=None)
    args = p.parse_args()

    scene_path = REPO / "systems" / args.scene
    all_runs: list[list[tuple[str, float]]] = []
    for r in range(args.runs):
        tag = "warm-up" if r == 0 else f"run {r}"
        print(f"-- session {tag} --", file=sys.stderr, flush=True)
        all_runs.append(run_session(scene_path, args.days))

    labels = [label for label, _ in all_runs[0]]
    warm = all_runs[1:] if len(all_runs) > 1 else all_runs
    import statistics

    def col(label):
        return [dict(run)[label] for run in warm]

    print("\n| step | median s | spread (min–max) |\n|---|---|---|")
    rows = {}
    for label in labels:
        vals = col(label)
        med = statistics.median(vals)
        rows[label] = {
            "median_s": round(med, 2),
            "min_s": round(min(vals), 2),
            "max_s": round(max(vals), 2),
        }
        print(f"| {label} | {med:.1f} | {min(vals):.1f}–{max(vals):.1f} |")
    totals = [sum(dt for _, dt in run) for run in warm]
    med_total = statistics.median(totals)
    print(
        f"| whole session | {med_total:.1f} | "
        f"{min(totals):.1f}–{max(totals):.1f} |"
    )

    payload = {
        "scene": args.scene,
        "runs_recorded": len(warm),
        "steps": rows,
        "whole_session_s": {
            "median_s": round(med_total, 2),
            "min_s": round(min(totals), 2),
            "max_s": round(max(totals), 2),
            "per_run_s": [round(t, 2) for t in totals],
        },
        "warmup_run_s": {
            label: round(dt, 2) for label, dt in all_runs[0]
        } if len(all_runs) > 1 else None,
        "all_runs": [
            {label: round(dt, 2) for label, dt in run} for run in warm
        ],
    }
    print(json.dumps(payload))
    if args.json_out:
        Path(args.json_out).write_text(json.dumps(payload, indent=2) + "\n")


if __name__ == "__main__":
    main()

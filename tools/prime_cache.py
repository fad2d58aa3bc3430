"""Prime the persistent compile cache with the canonical shape set.

Every novel jitted shape is a fresh compile.  The package bounds the shape
universe (ephemeris.CHUNK_STEPS + the pow2/1.5x tail-bucket ladder, pow2
fleet widths, dynamic adaptive params), so a fresh checkout can pay those
compiles ONCE, deliberately, instead of mid-session:

    python tools/prime_cache.py                 # common set (~10 min cold)
    python tools/prime_cache.py --min-tail 16   # every ladder shape
    python tools/prime_cache.py --list          # show what would compile

What gets compiled (each entry lands in JAX's persistent cache: the
directory ``JAX_COMPILATION_CACHE_DIR`` names, else ``.jax_cache/`` in the
checkout — see ephemeris_explorer_tpu/__init__.py):

* the generation scan + grouped-fit executable for CHUNK_STEPS and every
  tail-bucket ladder shape >= --min-tail (both the startup-chunk and the
  continue-chunk program variants), for the scene's body count and the
  production precision ("auto");
* the batched adaptive replan drivers (spacecraft._jitted_propagate_batch)
  at the interactive fleet widths (--widths, pow2-padded), for the default
  ship method/knot budget, on the default device — these are the
  spawn/replan latency paths.

Reference UX being matched: instant app start from bundled data
(ephemeris_explorer/src/load/mod.rs:66-84).
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--scene", default="full_solar_system_2433282.5")
    p.add_argument(
        "--min-tail", type=int, default=512,
        help="prime ladder shapes >= this many steps (512 covers every "
        "multi-hour tail; 16 primes the full ladder)",
    )
    p.add_argument(
        "--widths", default="1,2,4",
        help="fleet batch widths to prime the replan driver at "
        "(pow2-padded)",
    )
    p.add_argument("--method", default="Verner87", help="ship integrator")
    p.add_argument("--list", action="store_true", help="print the shape set and exit")
    args = p.parse_args(argv)

    from ephemeris_explorer_tpu.ephemeris import (
        CHUNK_STEPS,
        NBodyPropagator,
        bucket_ladder,
        generate_ephemeris,
    )
    from ephemeris_explorer_tpu.ftime import Duration
    from ephemeris_explorer_tpu.integrators import get
    from ephemeris_explorer_tpu.io import scene

    sc = scene.load_scene(REPO / "systems" / args.scene)
    tab = get("QuinlanTremaine12")
    ladder = [
        b for b in bucket_ladder(CHUNK_STEPS, min_n=tab.order + 1)
        if b >= args.min_tail
    ]
    widths = sorted({int(w) for w in args.widths.split(",") if w})

    if args.list:
        print(f"generation chunk shapes ({args.scene}): {ladder}")
        print(f"replan driver widths ({args.method}): {widths}")
        return 0

    t_all = time.time()

    # -- generation scan + fit executables --------------------------------
    # One propagator primes the CONTINUE-chunk program per ladder shape;
    # a fresh propagator's first call primes the STARTUP variant (the same
    # split generate_ephemeris's chunk loop dispatches).
    print(f"[prime] generation shapes {ladder} (scene={args.scene})", flush=True)
    prop = NBodyPropagator(sc.state, sc.settings)
    for i, b in enumerate(ladder):
        t0 = time.time()
        prop.step_chunk(b)  # first iteration also primes the startup variant
        print(f"  chunk {b}: {time.time() - t0:.1f} s", flush=True)
    if ladder and ladder[-1] == CHUNK_STEPS:
        # startup variant of the FULL chunk (a >=90-day initial generation
        # dispatches this shape first)
        t0 = time.time()
        NBodyPropagator(sc.state, sc.settings).step_chunk(CHUNK_STEPS)
        print(f"  startup chunk {CHUNK_STEPS}: {time.time() - t0:.1f} s", flush=True)

    # -- replan drivers ----------------------------------------------------
    # Inert ships (end == start) compile the full segment-bounded adaptive
    # driver at each padded width without integrating anything.
    from ephemeris_explorer_tpu.io.scene import Ship
    from ephemeris_explorer_tpu.spacecraft import propagate_ships

    # 40 d: short spans commit ZERO complete spline segments for slow
    # bodies (the Sun's segment interval alone exceeds 3 days), leaving no
    # commonly-covered epoch to seed the ships from
    print("[prime] context for replan drivers (40 d)", flush=True)
    eph = generate_ephemeris(sc.state, sc.settings, Duration.from_days(40.0))
    t0s = sc.state.epoch
    sv = eph[eph.names[0]].state_vector(
        t0s.as_offset_seconds() + 20.0 * 86400.0
    )
    assert sv is not None, "context covers no common epoch"
    e0, v0 = sv
    for w in widths:
        ships = [
            Ship(
                name=f"prime-{k}",
                integrator=args.method,
                tolerance=1e-3,
                start=t0s,
                end=t0s,  # inert: compiles the driver, integrates ~nothing
                position=e0 + 100.0 * (k + 1),
                velocity=v0,
                burns=[],
            )
            for k in range(w)
        ]
        t0 = time.time()
        propagate_ships(eph, ships)
        print(f"  replan driver width {w}: {time.time() - t0:.1f} s", flush=True)

    print(f"[prime] done in {time.time() - t_all:.1f} s", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

"""Compile-shape bounding invariants (round 3).

Every distinct jitted shape is a fresh compile; the package bounds the shape universe with canonical chunk /
knot / batch sizes (ephemeris.CHUNK_STEPS, spacecraft.KNOT_CAPACITY,
pow2 fleet padding) and dynamic adaptive parameters.  These tests pin
the BEHAVIOURAL contracts of those choices: padding must not leak into
results, tail buckets must still cover the requested span, and editing
a tolerance must not mint a new compiled driver.
"""

from pathlib import Path

import numpy as np
import pytest

from ephemeris_explorer_tpu.ephemeris import CHUNK_STEPS, generate_ephemeris
from ephemeris_explorer_tpu.ftime import Duration, Epoch
from ephemeris_explorer_tpu.io import scene
from ephemeris_explorer_tpu.io.scene import Ship, ShipBurn
from ephemeris_explorer_tpu.spacecraft import (
    _PROPAGATE_JIT_CACHE,
    propagate_ship,
    propagate_ships,
)

SYSTEMS = Path(__file__).resolve().parent.parent / "systems"


@pytest.fixture(scope="module")
def sem_eph():
    sc = scene.load_scene(SYSTEMS / "sun_earth_moon_2433282.5")
    eph = generate_ephemeris(sc.state, sc.settings, Duration.from_days(40.0))
    return sc, eph


def _mk_ship(base, k):
    return Ship(
        name=f"pad-{k}",
        integrator="Verner87",
        tolerance=1e-3,
        start=base.start,
        end=base.end,
        position=base.position + np.array([50.0 * (k + 1), 0, 0]),
        velocity=base.velocity,
        burns=[
            ShipBurn(
                start=Epoch.from_offset_seconds(
                    base.start.as_offset_seconds() + 3600.0
                ),
                duration=Duration.from_seconds(120.0),
                acceleration=np.array([1e-3 * (k + 1), 0, 0]),
                reference="Earth",
            )
        ],
    )


def test_fleet_pow2_padding_is_inert(sem_eph):
    """An odd-sized fleet (padded to the next power of two with inert
    end==start ships) returns exactly the requested ships, each matching
    its single-ship propagation."""
    sc, eph = sem_eph
    base = sc.ships[0]
    ships = [_mk_ship(base, k) for k in range(3)]  # pads 3 -> 4
    fleet = propagate_ships(eph, ships, max_knots=4096)
    assert set(fleet) == {s.name for s in ships}
    for s in ships:
        solo = propagate_ship(eph, s, max_knots=4096)
        batched = fleet[s.name]
        assert abs(solo.end_s - batched.end_s) < 1.0
        t = solo.start_s + 0.5 * (solo.end_s - solo.start_s)
        assert np.max(np.abs(solo.position(t) - batched.position(t))) < 1e-2


def test_tolerance_edit_reuses_compiled_driver(sem_eph):
    """Adaptive params are dynamic operands: editing the tolerance must not
    mint a new compiled batch driver (jit keyed only on
    (method, max_knots, backend)), but must change the result."""
    sc, eph = sem_eph
    base = sc.ships[0]
    loose = _mk_ship(base, 0)
    fleet_a = propagate_ships(eph, [loose], max_knots=2048)
    keys_after_first = set(_PROPAGATE_JIT_CACHE)

    tight = Ship(
        name=loose.name,
        integrator=loose.integrator,
        tolerance=1e-7,
        start=loose.start,
        end=loose.end,
        position=loose.position,
        velocity=loose.velocity,
        burns=list(loose.burns),
    )
    fleet_b = propagate_ships(eph, [tight], max_knots=2048)
    assert set(_PROPAGATE_JIT_CACHE) == keys_after_first, (
        "tolerance edit minted a new compiled driver"
    )
    # tighter tolerance -> more adaptive knots
    assert len(fleet_b[tight.name].ts) > len(fleet_a[loose.name].ts)


def test_bucket_tail_ladder_invariants():
    """bucket_tail must cover (>= n), stay capped, keep relative overshoot
    <= 33%, be idempotent, and emit only ladder values (the finite shape
    set prime_cache compiles)."""
    from ephemeris_explorer_tpu.ephemeris import bucket_ladder, bucket_tail

    chunk = CHUNK_STEPS
    ladder = set(bucket_ladder(chunk, min_n=13))
    for n in list(range(13, 200)) + list(range(200, chunk + 1, 37)) + [chunk]:
        b = bucket_tail(n, chunk, min_n=13)
        assert b >= n
        assert b <= chunk
        if b < chunk:
            # adjacent ladder rungs are 1.5x apart: b <= 1.5 * (n - 1)
            assert b <= 1.5 * (n - 1) + 1, (n, b)
        assert bucket_tail(b, chunk, min_n=13) == b  # idempotent
        assert b in ladder, (n, b)
    assert len(ladder) < 25  # the universe stays bounded


@pytest.mark.slow
def test_tail_bucket_still_covers_span():
    """Default chunking buckets the tail chunk to the pow2/1.5x ladder
    (slight overshoot allowed): generated coverage must still include the
    whole requested span, and values must match an explicit single-chunk
    run."""
    sc = scene.load_scene(SYSTEMS / "sun_earth_moon_2433282.5")
    dt = sc.settings.dt.as_seconds()
    # n_steps = CHUNK_STEPS + 5000: an off-ladder tail that gets bucketed
    # (to 6144), so coverage overshoots the requested span
    n_steps = CHUNK_STEPS + 5000
    span = Duration.from_seconds(n_steps * dt)
    eph = generate_ephemeris(sc.state, sc.settings, span)
    t0 = sc.state.epoch.as_offset_seconds()
    for name in eph.names:
        assert eph[name].span_s >= span.as_seconds() - 1e-6

    # the bucketed run's overshoot covers the exact endpoint; an un-bucketed
    # single-chunk run stops up to DIV*count steps short of it (segments
    # complete only at sample boundaries), so it is NOT queried at frac=1.0
    assert eph.positions(t0 + span.as_seconds()) is not None
    ref = generate_ephemeris(sc.state, sc.settings, span, chunk_steps=n_steps)
    for frac in (0.1, 0.5, 0.9):
        t = t0 + frac * span.as_seconds()
        a = eph.positions(t)
        b = ref.positions(t)
        assert a is not None and b is not None
        np.testing.assert_array_equal(a, b)

"""CI gate for the placement of the batched spacecraft driver.

Every batch runs on the default device; a caller who wants another device
commits the operands there with ``jax.device_put`` (the smoke script's
host reference does this).  These tests pin that down:

* the compiled batch driver on operands committed to the host device must
  give BITWISE the same result as on uncommitted operands — same program,
  same backend here, so any difference is a transfer or placement bug;
* `propagate_ships` (grouping, padding to a power of two, prefix fetch)
  must reproduce the batch driver on host-committed operands bitwise;
* `make_host_mirror` must be a genuine LRU (hit refreshes recency), bounded,
  and must pin the keying device buffer while the entry lives.

Reference semantics being protected: restart/replan latency paths
(flight_plan.rs:264-303, prediction.rs:429-432).
"""

import gc
from pathlib import Path

import jax
import numpy as np
import pytest

from ephemeris_explorer_tpu import Duration, Epoch
from ephemeris_explorer_tpu.ephemeris import generate_ephemeris
from ephemeris_explorer_tpu.hostmirror import make_host_mirror
from ephemeris_explorer_tpu.io import scene
from ephemeris_explorer_tpu.io.scene import ShipBurn
from ephemeris_explorer_tpu.spacecraft import (
    _jitted_propagate_batch,
    build_timeline,
    propagate_ships,
    ship_params,
    stack_timelines,
)

SYSTEMS = Path(__file__).resolve().parent.parent / "systems"


# ---------------------------------------------------------------------------
# make_host_mirror unit gates
# ---------------------------------------------------------------------------


def test_host_mirror_hit_miss():
    calls = []
    mirror = make_host_mirror(lambda src: calls.append(src) or len(calls), capacity=4)
    k1, k2 = object(), object()
    assert mirror(k1, "a") == 1
    assert mirror(k1, "a") == 1  # hit: no rebuild
    assert calls == ["a"]
    assert mirror(k2, "b") == 2  # distinct key: miss
    assert calls == ["a", "b"]


def test_host_mirror_lru_not_fifo():
    """A hit must refresh recency: insert a,b; touch a; insert c.
    FIFO would evict a (the oldest insert); LRU keeps a and evicts b."""
    builds = []
    mirror = make_host_mirror(lambda src: builds.append(src) or src, capacity=2)
    ka, kb, kc = object(), object(), object()
    mirror(ka, "a")
    mirror(kb, "b")
    mirror(ka, "a")          # touch a -> b is now least-recently-used
    mirror(kc, "c")          # evicts b, NOT a
    assert builds == ["a", "b", "c"]
    mirror(ka, "a")          # still cached: no rebuild
    assert builds == ["a", "b", "c"]
    mirror(kb, "b")          # was evicted: rebuilds
    assert builds == ["a", "b", "c", "b"]


def test_host_mirror_capacity_bound():
    mirror = make_host_mirror(lambda src: src, capacity=3)
    keys = [object() for _ in range(10)]
    for i, k in enumerate(keys):
        mirror(k, i)
    assert len(mirror.cache) == 3


def test_host_mirror_pins_key():
    """The cache must hold a strong ref to the keying object so its id()
    cannot be recycled by a new allocation while the entry lives."""
    mirror = make_host_mirror(lambda src: src, capacity=2)

    class K:  # noqa: D401 - sentinel with identity semantics
        pass

    k = K()
    kid = id(k)
    mirror(k, "v")
    del k
    gc.collect()
    # the entry still holds the object: same id maps to the same entry and
    # the stored object is alive (not a dangling id)
    entry = mirror.cache[kid]
    assert isinstance(entry[0], K)
    assert entry[1] == "v"


# ---------------------------------------------------------------------------
# Cross-backend equality of the batched driver
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def sem_ctx():
    sc = scene.load_scene(SYSTEMS / "sun_earth_moon_2433282.5")
    # NOTE: shorter spans can commit zero complete spline segments (pack
    # end_s == start) — 40 d matches the spacecraft test fixture
    eph = generate_ephemeris(sc.state, sc.settings, Duration.from_days(40.0))
    return sc, eph


def _result_arrays(r):
    return [np.asarray(x) for x in jax.device_get(r)]


def test_cross_backend_bitwise_equality(sem_ctx):
    """the batch driver on uncommitted operands vs the same driver on
    operands committed to the host device with device_put, on identical
    (packed, timeline, state) inputs: identical knot counts, times,
    positions, velocities, reasons — bitwise.

    On this CI box both runs land on the cpu backend, so the test isolates
    exactly what an explicit placement adds: the device_put commit of every
    operand, the pack included.
    """
    sc, eph = sem_ctx
    ship = sc.ships[0]
    index = {n: i for i, n in enumerate(eph.names)}
    packed = eph.pack()

    # include a body-relative burn so the TNB/frame interpolation path runs
    t0 = ship.start.as_offset_seconds()
    burns = list(ship.burns) + [
        ShipBurn(
            start=Epoch.from_offset_seconds(t0 + 3000.0),
            duration=Duration.from_seconds(120.0),
            acceleration=np.asarray([1e-3, 0.0, 0.0]),
            reference="Earth",
        )
    ]
    tl = stack_timelines([build_timeline(burns, index)])
    params = ship_params(ship)
    end = t0 + 2.0 * 86400.0
    args = (
        packed,
        tl,
        np.asarray([t0]),
        np.asarray(ship.position, dtype=np.float64)[None],
        np.asarray(ship.velocity, dtype=np.float64)[None],
        np.asarray([end]),
    )

    fn = _jitted_propagate_batch(ship.integrator, params, 4096)
    r_dev = _result_arrays(fn(*args))
    r_cpu = _result_arrays(fn(*jax.device_put(args, jax.devices("cpu")[0])))

    assert len(r_dev) == len(r_cpu)
    for a, b in zip(r_dev, r_cpu):
        assert a.shape == b.shape and a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    # sanity: the run actually produced knots (field 3 = count)
    assert int(np.asarray(r_dev[3]).max()) > 2


@pytest.mark.parametrize("n_ships", [1, 3])
def test_propagate_ships_host_placement_bitwise(sem_ctx, n_ships):
    """propagate_ships and the batch driver on operands committed to the
    host device give identical trajectories, bitwise (the fleet is padded
    to a power of two in one and not in the other)."""
    import dataclasses

    sc, eph = sem_ctx
    base = sc.ships[0]
    t0 = base.start.as_offset_seconds()
    ships = [
        dataclasses.replace(
            base, name=f"s{k}", position=base.position + np.array([50.0 * k, 0.0, 0.0]),
            end=Epoch.from_offset_seconds(t0 + 86400.0),
        )
        for k in range(n_ships)
    ]
    dev = propagate_ships(eph, ships, max_knots=1024)
    index = {n: i for i, n in enumerate(eph.names)}
    args = (
        eph.pack(),
        stack_timelines([build_timeline(s.burns, index) for s in ships]),
        np.full(n_ships, t0),
        np.stack([s.position for s in ships]),
        np.stack([s.velocity for s in ships]),
        np.full(n_ships, t0 + 86400.0),
    )
    fn = _jitted_propagate_batch(base.integrator, ship_params(base), 1024)
    r = jax.device_get(fn(*jax.device_put(args, jax.devices("cpu")[0])))
    assert sorted(dev) == sorted(s.name for s in ships)
    for i, s in enumerate(ships):
        k = int(r.count[i])
        tr = dev[s.name]
        assert len(tr.ts) == k > 2
        for a, b in ((tr.ts, r.ts[i, :k]), (tr.pos, r.pos[i, :k]), (tr.vel, r.vel[i, :k])):
            np.testing.assert_array_equal(a, b)

"""Trajectory event detection: SOI crossings and apsides.

Rebuilds the reference's per-step event machinery
(``ephemeris_explorer/src/dynamics/spacecraft.rs:41-162, 302-604``) as a
vectorised post-processing pass over a propagated trajectory:

1. evaluate the sign functions at every knot for every body in one batched
   device pass (sphere-of-influence distance; radial velocity),
2. find sign-change intervals,
3. refine each flagged (interval, body) pair with a fixed-iteration bisection
   (100 iterations / 1e-3 s precision, find_zero_crossing semantics) in one
   vmapped device call.

The reference detects events inside the integration solout; detecting them
after the fact over the same knot sequence yields the same events because the
sign functions are evaluated on the identical cubic-Hermite interpolant.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import numpy as np

from .ephemeris import PackedEphemeris
from .hostmirror import make_host_mirror

ASCENDING = +1    # f goes - to +
DESCENDING = -1   # f goes + to -

BISECT_ITERS = 100
BISECT_PRECISION = 1e-3  # seconds (dynamics/spacecraft.rs:155)


@dataclass(frozen=True)
class Event:
    time: float
    body: int           # body index
    direction: int      # ASCENDING | DESCENDING


@dataclass(frozen=True)
class Apsis:
    time: float
    body: int
    distance: float
    periapsis: bool


class SoiTransitions:
    """Sorted (time, body) transition list with incremental maintenance.

    Mirrors ``SoiTransitions`` (dynamics/spacecraft.rs:302-379): ``insert``
    replaces an exact-time entry, dedups against the predecessor's body and
    keeps the list sorted; ``clear_after(t)`` keeps entries with time <= t;
    ``extend`` is insert-each.  List-like for existing consumers.
    """

    __slots__ = ("entries",)

    def __init__(self, entries=None):
        self.entries: list[tuple[float, int]] = list(entries or [])

    # -- list-like --------------------------------------------------------
    def __iter__(self):
        return iter(self.entries)

    def __len__(self):
        return len(self.entries)

    def __getitem__(self, i):
        return self.entries[i]

    def __eq__(self, other):
        return list(self) == list(other)

    def __repr__(self):
        return f"SoiTransitions({self.entries!r})"

    # -- queries (spacecraft.rs:308-329) ----------------------------------
    def _search(self, time: float) -> tuple[bool, int]:
        import bisect

        # key= avoids rebuilding the full time list per call (insert/extend
        # over long missions would otherwise be O(n^2))
        i = bisect.bisect_left(self.entries, time, key=lambda e: e[0])
        found = i < len(self.entries) and self.entries[i][0] == time
        return found, i

    def soi_at_idx(self, time: float) -> int | None:
        found, i = self._search(time)
        if found:
            return i
        return None if i == 0 else i - 1

    def soi_at(self, time: float) -> int | None:
        i = self.soi_at_idx(time)
        return None if i is None else self.entries[i][1]

    # -- mutation (spacecraft.rs:331-361) ----------------------------------
    def insert(self, time: float, body: int) -> None:
        found, i = self._search(time)
        if found:
            self.entries[i] = (time, body)
        elif i > 0 and self.entries[i - 1][1] == body:
            pass  # dedup against predecessor
        else:
            self.entries.insert(i, (time, body))

    def clear_after(self, time: float) -> None:
        found, i = self._search(time)
        del self.entries[i + 1 if found else i :]

    def clear_before(self, time: float) -> None:
        _, i = self._search(time)
        del self.entries[:i]

    def extend(self, other) -> None:
        for time, body in other:
            self.insert(time, body)


class Apsides:
    """Sorted apsis list with clear_after/extend (spacecraft.rs:412-446)."""

    __slots__ = ("entries",)

    def __init__(self, entries=None):
        self.entries: list[Apsis] = list(entries or [])

    def __iter__(self):
        return iter(self.entries)

    def __len__(self):
        return len(self.entries)

    def __getitem__(self, i):
        return self.entries[i]

    def __eq__(self, other):
        return list(self) == list(other)

    def __repr__(self):
        return f"Apsides({self.entries!r})"

    def _search(self, time: float) -> tuple[bool, int]:
        import bisect

        i = bisect.bisect_left(self.entries, time, key=lambda a: a.time)
        found = i < len(self.entries) and self.entries[i].time == time
        return found, i

    def insert(self, apsis: Apsis) -> None:
        found, i = self._search(apsis.time)
        if found:
            self.entries[i] = apsis
        else:
            self.entries.insert(i, apsis)

    def clear_after(self, time: float) -> None:
        found, i = self._search(time)
        del self.entries[i + 1 if found else i :]

    def extend(self, other) -> None:
        for a in other:
            self.insert(a)


# ---------------------------------------------------------------------------
# Host evaluation engine
#
# Event detection is small, shape-irregular work (K <= a few thousand knots,
# B ~ tens of bodies, trajectory lengths differing per ship), which is the
# WRONG shape for the device: every distinct knot count would trigger a fresh
# XLA compile and each refinement costs host<->device round trips.  The
# whole pass runs in plain numpy f64 against a host snapshot of the packed
# ephemeris — native IEEE double, no jit, no transfers.  (The device's job
# is the O(N^2 * steps) integration, not this.)
# ---------------------------------------------------------------------------


class _HostEph(NamedTuple):
    """numpy mirror of PackedEphemeris (one device_get per pack snapshot)."""

    mus: np.ndarray
    starts: np.ndarray
    intervals: np.ndarray
    offsets: np.ndarray
    nsegs: np.ndarray
    coeffs: np.ndarray


def _fetch_host_eph(eph) -> _HostEph:
    import jax

    return _HostEph(*jax.device_get(tuple(eph)))


# bounded mirror cache keyed on the device coeffs buffer (see hostmirror)
_host_mirror = make_host_mirror(_fetch_host_eph)


def _host(eph: PackedEphemeris) -> _HostEph:
    if isinstance(eph.coeffs, np.ndarray):
        return _HostEph(*(np.asarray(x) for x in eph))
    return _host_mirror(eph.coeffs, eph)


def _horner(c: np.ndarray, tau: np.ndarray) -> np.ndarray:
    """sum_d c[..., d, :] tau^d  (numpy twin of ops/polyfit.horner)."""
    tau = tau[..., None]
    out = np.zeros_like(c[..., -1, :])
    for d in range(c.shape[-2] - 1, -1, -1):
        out = out * tau + c[..., d, :]
    return out


def _horner_and_deriv(c: np.ndarray, tau: np.ndarray):
    """numpy twin of ops/polyfit.horner_and_deriv (d/dtau)."""
    tau = tau[..., None]
    n = c.shape[-2]
    val = c[..., n - 1, :]
    der = val
    for d in range(n - 2, 0, -1):
        val = val * tau + c[..., d, :]
        der = der * tau + val
    val = val * tau + c[..., 0, :]
    return val, der


def _segments(he: _HostEph, ts: np.ndarray):
    """(M, N, C, 3) segment coeffs + (M, N) tau at times ts ((M,) f64 s)."""
    local = ts[:, None] - he.starts[None, :]
    idx = np.ceil(local / he.intervals[None, :]).astype(np.int64) - 1
    idx = np.clip(idx, 0, he.nsegs[None, :] - 1)
    tau = (local - he.intervals[None, :] * idx) / he.intervals[None, :]
    return he.coeffs[he.offsets[None, :] + idx], tau


def _positions(he: _HostEph, ts: np.ndarray) -> np.ndarray:
    """(M, N, 3) body positions at (M,) times."""
    c, tau = _segments(he, ts)
    return _horner(c, tau)


def _state_vectors(he: _HostEph, ts: np.ndarray):
    c, tau = _segments(he, ts)
    pos, dtau = _horner_and_deriv(c, tau)
    return pos, dtau / he.intervals[None, :, None]


def hermite_eval_batch(knot_ts, knot_pos, knot_vel, ts):
    """Vectorised cubic-Hermite evaluation of the ship trajectory (numpy).

    knot_ts (K,), knot_pos/vel (K, 3); ts (M,) times inside the knot range.
    Returns (pos (M, 3), vel (M, 3)).
    """
    knot_ts = np.asarray(knot_ts)
    knot_pos = np.asarray(knot_pos)
    knot_vel = np.asarray(knot_vel)
    ts = np.asarray(ts)
    idx = np.clip(np.searchsorted(knot_ts, ts, side="right") - 1, 0, len(knot_ts) - 2)
    t0 = knot_ts[idx]
    t1 = knot_ts[idx + 1]
    p0, p1 = knot_pos[idx], knot_pos[idx + 1]
    v0, v1 = knot_vel[idx], knot_vel[idx + 1]
    dt = (t1 - t0)[:, None]
    a0, a1 = p0, v0
    dpv = p1 - p0
    a2 = dpv * 3.0 / dt**2 - (v0 * 2.0 + v1) / dt
    a3 = dpv * -2.0 / dt**3 + (v0 + v1) / dt**2
    x = (ts - t0)[:, None]
    pos = ((a3 * x + a2) * x + a1) * x + a0
    vel = (a3 * x * 3.0 + a2 * 2.0) * x + a1
    return pos, vel


def _bisect(f, t0s, t1s, f0s):
    """Vectorised bisection (find_zero_crossing, dynamics/spacecraft.rs:111-162)."""
    x0 = np.asarray(t0s, dtype=np.float64).copy()
    x1 = np.asarray(t1s, dtype=np.float64).copy()
    f0 = np.asarray(f0s, dtype=np.float64).copy()
    for _ in range(BISECT_ITERS):
        mid = x0 + (x1 - x0) / 2.0
        fm = f(mid)
        same = np.sign(f0) == np.sign(fm)
        x0 = np.where(same, mid, x0)
        f0 = np.where(same, fm, f0)
        x1 = np.where(same, x1, mid)
    return x0


def soi_transitions(
    traj, eph: PackedEphemeris, soi_radii
) -> list[tuple[float, int]]:
    """Ordered (time, body-index) SOI transition list for a trajectory.

    Mirrors the solout's transition bookkeeping
    (dynamics/spacecraft.rs:554-564 + SoiTransitions::insert dedup): on a
    descending crossing the ship enters that body's SOI; on an ascending
    crossing it enters the smallest containing SOI among the other bodies.
    """
    if len(traj.ts) < 2:
        return []
    he = _host(eph)
    kts = np.asarray(traj.ts)
    kpos = np.asarray(traj.pos)
    kvel = np.asarray(traj.vel)
    radii2 = np.asarray(soi_radii) ** 2

    def fsoi(ts):
        """(M,) times -> (M, B) signed SOI distance^2 for every body."""
        spos, _ = hermite_eval_batch(kts, kpos, kvel, ts)
        bpos = _positions(he, ts)                      # (M, B, 3)
        d2 = np.sum((spos[:, None, :] - bpos) ** 2, axis=-1)
        return d2 - radii2[None, :]

    vals = fsoi(kts)                                   # (K, B)
    sign = np.sign(vals)
    flips = sign[:-1] * sign[1:] < 0                   # (K-1, B)
    iv, ib = np.nonzero(flips)
    events: list[Event] = []
    if len(iv):
        roots = _bisect(
            lambda ts: fsoi(ts)[np.arange(len(ts)), ib],
            kts[iv], kts[iv + 1], vals[iv, ib],
        )
        for t, b, v0 in zip(roots, ib, vals[iv, ib]):
            events.append(Event(float(t), int(b), ASCENDING if v0 < 0 else DESCENDING))
    events.sort(key=lambda e: e.time)

    # initial SOI (new_solution, dynamics/spacecraft.rs:524-537)
    transitions: list[tuple[float, int]] = []
    init_soi = _soi_of(_positions(he, kts[:1])[0], soi_radii, traj.pos[0])
    if init_soi is not None:
        transitions.append((float(traj.ts[0]), init_soi))

    # ascending-crossing lookups, batched (ship + body positions for ALL)
    asc = [e for e in events if e.direction == ASCENDING]
    asc_pos: dict[float, tuple[np.ndarray, np.ndarray]] = {}
    if asc:
        ats = np.asarray([e.time for e in asc])
        p_all, _ = hermite_eval_batch(kts, kpos, kvel, ats)
        bpos_all = _positions(he, ats)
        for e, p, bp in zip(asc, p_all, bpos_all):
            asc_pos[e.time] = (p, bp)

    for e in events:
        if e.direction == DESCENDING:
            entered = e.body
        else:
            p, bp = asc_pos[e.time]
            entered = _soi_of(bp, soi_radii, p, except_=[e.body])
            if entered is None:
                continue
        if transitions and transitions[-1][1] == entered:
            continue  # dedup (SoiTransitions::insert, :332-337)
        transitions.append((e.time, entered))
    return transitions


def apsides(
    traj, eph: PackedEphemeris, transitions: list[tuple[float, int]]
) -> list[Apsis]:
    """Periapsis/apoapsis events relative to the active SOI body.

    Mirrors dynamics/spacecraft.rs:566-583: radial-velocity zero crossings
    within each knot interval, bounded by SOI transitions.
    """
    if len(traj.ts) < 2 or not transitions:
        return []
    he = _host(eph)
    kts = np.asarray(traj.ts)
    kpos = np.asarray(traj.pos)
    kvel = np.asarray(traj.vel)

    # active SOI body for each knot interval
    tr_times = np.array([t for t, _ in transitions])
    tr_bodies = np.array([b for _, b in transitions])
    idx = np.clip(np.searchsorted(tr_times, kts, side="right") - 1, 0, len(tr_times) - 1)
    body_per_knot = tr_bodies[idx]                      # (K,)

    def frv(ts, body):
        """(M,) times + (M,) body indices -> (M,) radial velocity."""
        spos, svel = hermite_eval_batch(kts, kpos, kvel, ts)
        bpos, bvel = _state_vectors(he, ts)
        m = np.arange(len(ts))
        rel_p = spos - bpos[m, body]
        rel_v = svel - bvel[m, body]
        return np.sum(rel_p * rel_v, axis=-1)

    vals = frv(kts, body_per_knot)

    # a sign change within interval [k, k+1] counts only when the SOI body is
    # the same at both ends (transitions split the search spans)
    same = body_per_knot[:-1] == body_per_knot[1:]
    flips = (np.sign(vals[:-1]) * np.sign(vals[1:]) < 0) & same
    iv = np.nonzero(flips)[0]
    out: list[Apsis] = []
    if len(iv) == 0:
        return out
    bsel = body_per_knot[iv]
    roots = _bisect(lambda ts: frv(ts, bsel), kts[iv], kts[iv + 1], vals[iv])
    # one batched ship-position + body-positions eval for ALL apsides
    p_all, _ = hermite_eval_batch(kts, kpos, kvel, roots)
    bp_all = _positions(he, roots)
    dists = np.linalg.norm(p_all - bp_all[np.arange(len(roots)), bsel], axis=-1)
    for t, b, v0, dist in zip(roots, bsel, vals[iv], dists):
        out.append(Apsis(float(t), int(b), float(dist), periapsis=v0 < 0))
    out.sort(key=lambda a: a.time)
    return out


def soi_at(eph: PackedEphemeris, soi_radii, t, position, except_=()) -> int | None:
    """Smallest containing SOI at `t` (find_soi, dynamics/spacecraft.rs:204-216)."""
    bpos = _positions(_host(eph), np.asarray([float(t)]))[0]
    return _soi_of(bpos, soi_radii, position, except_)


def _soi_of(bpos: np.ndarray, soi_radii, position, except_=()) -> int | None:
    """soi_at against precomputed body positions (host-side, no device calls)."""
    d2 = np.sum((np.asarray(position)[None, :] - bpos) ** 2, axis=-1)
    r2 = np.asarray(soi_radii) ** 2
    inside = d2 < r2
    for b in except_:
        inside[b] = False
    if not inside.any():
        return None
    cands = np.nonzero(inside)[0]
    return int(cands[np.argmin(d2[cands])])

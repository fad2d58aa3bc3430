"""Spacecraft propagation: flight plans, burn frames, adaptive integration.

Rebuilds the reference's spacecraft stack
(``ephemeris/src/propagators/spacecraft.rs`` +
``ephemeris_explorer/src/dynamics/spacecraft.rs``) for an accelerator:

* a flight plan's burns become a dense ``Timeline`` array of segments
  (coast / burn interleaving, ``spacecraft.rs:119-222``);
* propagation is an outer ``lax.while_loop`` over timeline segments with an
  inner adaptive while_loop; the integrator is RESET at every segment edge
  (fresh h_init and FSAL cache), mirroring ``reset_integrator`` at manoeuvre
  changes (``spacecraft.rs:599-615``) so restarts are deterministic;
* the context acceleration is the sum of all bodies' interpolated gravity
  evaluated from the packed ephemeris (``dynamics/spacecraft.rs:218-229``);
* burn accelerations are transformed from their reference frame (TNB relative
  to a body, or inertial; ``dynamics/spacecraft.rs:240-293``) at every stage;
* accepted steps append (t, position, velocity) knots into a preallocated
  buffer - the cubic-Hermite trajectory (``trajectory.rs:745-855``);
* a batch of ships propagates with ``vmap`` over padded timelines.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from .ephemeris import PackedEphemeris
from .ftime import Epoch
from .integrators import adaptive
from .integrators.adaptive import AdaptiveParams, AdaptiveState
from .integrators.methods import ERKNGTableau, get as get_method
from .io.scene import Ship, ShipBurn

EPOCH_MIN = -1.0e300
EPOCH_MAX = 1.0e300

FRAME_INERTIAL = 0
FRAME_RELATIVE = 1


class Timeline(NamedTuple):
    """Dense segment arrays (sorted, non-overlapping, covering (-inf, inf)).

    Mirrors ``Timeline::new`` (spacecraft.rs:129-157): coast segments fill
    the gaps between burns.  ``frame_body`` indexes the scene body list.
    """

    starts: jax.Array      # (S,)
    ends: jax.Array        # (S,)
    accels: jax.Array      # (S, 3) burn acceleration in the burn frame
    frame_kind: jax.Array  # (S,) FRAME_INERTIAL | FRAME_RELATIVE
    frame_body: jax.Array  # (S,) body index (0 when inertial)

    @property
    def n_segments(self) -> int:
        return self.starts.shape[0]


def build_timeline(
    burns: list[ShipBurn], body_index, pad_to: int | None = None
) -> Timeline:
    """Host-side timeline construction from burns (spacecraft.rs:129-157).

    `body_index` maps body name -> index.  Burns are sorted by start; gaps are
    coast segments.  Optionally right-pads with zero-length coasts at
    EPOCH_MAX so batched ships share a static segment count.
    """
    entries = sorted(burns, key=lambda b: b.start.as_offset_seconds())
    segs: list[tuple[float, float, np.ndarray, int, int]] = []
    cursor = EPOCH_MIN
    zero = np.zeros(3)
    for b in entries:
        s, e = b.start.as_offset_seconds(), b.end.as_offset_seconds()
        if s > cursor:
            segs.append((cursor, s, zero, FRAME_INERTIAL, 0))
        if b.reference is None:
            kind, ref = FRAME_INERTIAL, 0
        else:
            kind, ref = FRAME_RELATIVE, body_index(b.reference) if callable(body_index) else body_index[b.reference]
        segs.append((s, e, np.asarray(b.acceleration, dtype=np.float64), kind, ref))
        cursor = e
    if cursor < EPOCH_MAX:
        segs.append((cursor, EPOCH_MAX, zero, FRAME_INERTIAL, 0))
    if pad_to is not None:
        while len(segs) < pad_to:
            segs.append((EPOCH_MAX, EPOCH_MAX, zero, FRAME_INERTIAL, 0))
    # host (numpy) arrays: a fleet stacks many of these, and materialising
    # 5 device buffers per ship costs a host<->device transfer each —
    # callers that need device residency get it on first jitted use (or in
    # one conversion inside stack_timelines)
    return Timeline(
        starts=np.array([s[0] for s in segs]),
        ends=np.array([s[1] for s in segs]),
        accels=np.stack([s[2] for s in segs]),
        frame_kind=np.array([s[3] for s in segs], dtype=np.int32),
        frame_body=np.array([s[4] for s in segs], dtype=np.int32),
    )


def segment_idx_at(tl: Timeline, t) -> jax.Array:
    """partition_point(seg.end <= t)  (spacecraft.rs:165-167)."""
    return jnp.sum(tl.ends <= t).astype(jnp.int32)


def divergence_time(old: Timeline, new: Timeline, before) -> jax.Array:
    """Last common segment-start before `before` (spacecraft.rs:180-212).

    Common prefix = segments with equal starts; the prefix stops after the
    first pair with differing thrust.  Used for incremental flight-plan
    replanning (flight_plan.rs:264-303).
    """
    n = min(old.n_segments, new.n_segments)
    o, w = jax.tree_util.tree_map(lambda x: x[:n], old), jax.tree_util.tree_map(lambda x: x[:n], new)
    same_start = o.starts == w.starts
    same_thrust = (
        jnp.all(o.accels == w.accels, axis=-1)
        & (o.frame_kind == w.frame_kind)
        & (o.frame_body == w.frame_body)
        & (o.ends == w.ends)
    )
    # segment i yields its start if all starts up to i matched and all
    # thrusts before i matched
    prefix_start = jnp.cumprod(same_start) == 1
    prefix_thrust = jnp.concatenate([jnp.ones(1, bool), (jnp.cumprod(same_thrust) == 1)[:-1]])
    valid = prefix_start & prefix_thrust & (o.starts < before)
    return jnp.max(jnp.where(valid, o.starts, EPOCH_MIN))


# ---------------------------------------------------------------------------
# Burn-frame transform (dynamics/spacecraft.rs:240-293)
# ---------------------------------------------------------------------------


def tnb_to_inertial(rel_pos, rel_vel, accel):
    """Transform a TNB-frame acceleration to inertial.

    TNB basis (dynamics/spacecraft.rs:246-252): x = v_hat,
    y = (r x v)_hat, z = x cross y; matrix columns (x, z, y).

    Degenerate geometry (zero relative velocity or collinear r, v) yields a
    NaN acceleration, which the adaptive driver detects as a non-finite
    error norm and aborts the step with ``EVAL_FAILED`` — the functional
    equivalent of ``TNB::try_new`` returning ``None`` and failing the step
    (dynamics/spacecraft.rs:242-253); the propagation flushes the knots
    accumulated so far instead of silently continuing with a bad frame.
    """
    x = rel_vel / jnp.linalg.norm(rel_vel)
    y = jnp.cross(rel_pos, rel_vel)
    y = y / jnp.linalg.norm(y)
    z = jnp.cross(x, y)
    z = z / jnp.linalg.norm(z)
    m = jnp.stack([x, z, y], axis=-1)  # columns
    return m @ accel


def manoeuvre_accel(eph: PackedEphemeris, t, pos, vel, accel, kind, body):
    """Burn acceleration in the inertial frame at stage time/state."""

    def relative(_):
        bpos, bvel = eph.state_vectors(t)
        rel_p = pos - bpos[body]
        rel_v = vel - bvel[body]
        return tnb_to_inertial(rel_p, rel_v, accel)

    def inertial(_):
        return accel

    return jax.lax.cond(kind == FRAME_RELATIVE, relative, inertial, None)


# ---------------------------------------------------------------------------
# Propagation driver
# ---------------------------------------------------------------------------

# termination reasons
DONE_END = 0          # reached requested end
DONE_KNOTS_FULL = 1   # knot buffer exhausted
DONE_ERROR = 2        # step-size underflow / max iterations / eval failed

REASON_NAMES = {
    DONE_END: "end-reached",
    DONE_KNOTS_FULL: "knot-buffer-full",
    DONE_ERROR: "step-error",
}


# Canonical knot-buffer capacity. One value across every entry point
# (propagate, propagate_ships, propagate_resuming, Universe.replan,
# bench.py) so they share compiled shapes: max_knots is a static buffer
# dimension, and each distinct value costs a full recompile per method.  Long missions that overflow it resume transparently
# (propagate_resuming / the fleet fallback).
KNOT_CAPACITY = 8192


class PropagationResult(NamedTuple):
    ts: jax.Array       # (K,) knot times (f64 s); padded with +inf
    pos: jax.Array      # (K, 3)
    vel: jax.Array      # (K, 3)
    count: jax.Array    # () int32 valid knots
    reason: jax.Array   # () int32
    final_seg: jax.Array


class _Carry(NamedTuple):
    seg: jax.Array
    st: AdaptiveState
    ts: jax.Array
    pos: jax.Array
    vel: jax.Array
    count: jax.Array
    done: jax.Array
    reason: jax.Array


def _make_rhs(tab, eph: PackedEphemeris, tl: Timeline, seg):
    a = tl.accels[seg]
    kind = tl.frame_kind[seg]
    fbody = tl.frame_body[seg]
    burning = jnp.any(a != 0.0)

    if isinstance(tab, ERKNGTableau):
        def f(t, y, dy):
            acc = eph.accel_at(t, y)
            man = jax.lax.cond(
                burning,
                lambda _: manoeuvre_accel(eph, t, y, dy, a, kind, fbody),
                lambda _: jnp.zeros(3),
                None,
            )
            return acc + man
        return f

    def f(t, y):
        pos, vel = y
        acc = eph.accel_at(t, pos)
        man = jax.lax.cond(
            burning,
            lambda _: manoeuvre_accel(eph, t, pos, vel, a, kind, fbody),
            lambda _: jnp.zeros(3),
            None,
        )
        return (vel, acc + man)

    return f


def propagate(
    tab,
    eph: PackedEphemeris,
    tl: Timeline,
    t0,
    pos0,
    vel0,
    end_t,
    params: AdaptiveParams,
    max_knots: int = KNOT_CAPACITY,
) -> PropagationResult:
    """Propagate one spacecraft from t0 to end_t (jit/vmap friendly).

    The advance is additionally bounded by the ephemeris coverage
    (`eph.end_s`), mirroring the app's context-validity guard
    (dynamics/spacecraft.rs:231-238).
    """
    t0 = jnp.asarray(t0, jnp.float64)
    end_t = jnp.minimum(jnp.asarray(end_t, jnp.float64), eph.end_s)

    ts = jnp.full((max_knots,), jnp.inf, dtype=jnp.float64)
    pos = jnp.zeros((max_knots, 3), dtype=jnp.float64)
    vel = jnp.zeros((max_knots, 3), dtype=jnp.float64)
    ts = ts.at[0].set(t0)
    pos = pos.at[0].set(pos0)
    vel = vel.at[0].set(vel0)

    y0 = (pos0, vel0)

    def fresh_state(seg, t, y):
        """reset_integrator at a segment edge (spacecraft.rs:480-485)."""
        f = _make_rhs(tab, eph, tl, seg)
        return adaptive.init_state(tab, f, t, y, params)

    err_norm = adaptive.abs_tol_norm(params.tol_pos, params.tol_vel)

    def outer_cond(c: _Carry):
        return ~c.done

    def outer_body(c: _Carry):
        seg = c.seg
        bound = jnp.minimum(tl.ends[seg], end_t)
        f = _make_rhs(tab, eph, tl, seg)

        def inner_cond(ic):
            st, ts, pos, vel, count, stop, reason = ic
            return ~stop

        def inner_body(ic):
            st, ts, pos, vel, count, stop, reason = ic
            st2, h, status = adaptive.advance(tab, f, params, err_norm, st, bound)
            ok = status == adaptive.OK
            # predicated append: invalid index is dropped, no O(K) copy
            idx = jnp.where(ok, count, max_knots)
            ts = ts.at[idx].set(st2.t, mode="drop")
            pos = pos.at[idx].set(st2.y[0], mode="drop")
            vel = vel.at[idx].set(st2.y[1], mode="drop")
            count = jnp.where(ok, count + 1, count)
            full = count >= max_knots
            reached = st2.t >= bound
            stop = (~ok) | full | reached
            # BOUND_REACHED only comes from adaptive_advance's pre-check
            # (never mid-loop), so this branch fires solely on a
            # zero-progress call at the segment bound — still DONE_END,
            # not an error
            reason = jnp.where(
                full, DONE_KNOTS_FULL,
                jnp.where(ok | (status == adaptive.BOUND_REACHED), DONE_END, DONE_ERROR),
            ).astype(jnp.int32)
            return (st2, ts, pos, vel, count, stop, reason)

        st, ts, pos, vel, count, _, reason = jax.lax.while_loop(
            inner_cond,
            inner_body,
            (c.st, c.ts, c.pos, c.vel, c.count, jnp.asarray(False), jnp.asarray(DONE_END, jnp.int32)),
        )

        finished = (st.t >= end_t) | (reason != DONE_END) | (count >= max_knots)
        # advance to next segment with a reset integrator (spacecraft.rs:599-615)
        next_seg = seg + 1
        st_next = fresh_state(next_seg, st.t, st.y)
        # carry cumulative n across the reset? reference resets the instance
        # (n restarts); keep that behavior.
        return _Carry(
            seg=jnp.where(finished, seg, next_seg),
            st=jax.tree_util.tree_map(
                lambda a, b: jnp.where(finished, a, b), st, st_next
            ),
            ts=ts,
            pos=pos,
            vel=vel,
            count=count,
            done=finished,
            reason=jnp.where(
                finished & (reason == DONE_END) & (count >= max_knots),
                DONE_KNOTS_FULL,
                reason,
            ),
        )

    seg0 = segment_idx_at(tl, t0)
    init = _Carry(
        seg=seg0,
        st=fresh_state(seg0, t0, y0),
        ts=ts,
        pos=pos,
        vel=vel,
        count=jnp.asarray(1, jnp.int32),
        done=jnp.asarray(False),
        reason=jnp.asarray(DONE_END, jnp.int32),
    )
    c = jax.lax.while_loop(outer_cond, outer_body, init)
    return PropagationResult(
        ts=c.ts, pos=c.pos, vel=c.vel, count=c.count, reason=c.reason, final_seg=c.seg
    )


# ---------------------------------------------------------------------------
# Host-side Hermite trajectory (CubicHermiteSpline semantics)
# ---------------------------------------------------------------------------


@dataclass
class HermiteTrajectory:
    """Knot list with cubic-Hermite interpolation (trajectory.rs:745-855)."""

    ts: np.ndarray    # (K,) seconds, strictly increasing
    pos: np.ndarray   # (K, 3)
    vel: np.ndarray   # (K, 3)

    @classmethod
    def from_result(cls, r: PropagationResult) -> "HermiteTrajectory":
        k = int(r.count)
        return cls(
            ts=np.asarray(r.ts[:k]), pos=np.asarray(r.pos[:k]), vel=np.asarray(r.vel[:k])
        )

    @property
    def start_s(self) -> float:
        return float(self.ts[0]) if len(self.ts) else EPOCH_MIN

    @property
    def end_s(self) -> float:
        return float(self.ts[-1]) if len(self.ts) else EPOCH_MAX

    @property
    def start(self) -> Epoch:
        return Epoch.from_offset_seconds(self.start_s)

    @property
    def end(self) -> Epoch:
        return Epoch.from_offset_seconds(self.end_s)

    def contains(self, t) -> bool:
        ts = t.as_offset_seconds() if isinstance(t, Epoch) else float(t)
        return self.start_s <= ts <= self.end_s

    def _segment(self, ts: float):
        i = int(np.searchsorted(self.ts, ts))
        if i < len(self.ts) and self.ts[i] == ts:
            return ("knot", i)
        if i == 0 or i > len(self.ts) - 1:
            return None
        return ("seg", i - 1)

    def _hermite(self, i: int, ts: float, deriv: bool):
        t0, t1 = self.ts[i], self.ts[i + 1]
        p0, p1 = self.pos[i], self.pos[i + 1]
        v0, v1 = self.vel[i], self.vel[i + 1]
        dt = t1 - t0
        # coefficients as in CubicHermite::new (trajectory.rs:644-678)
        a0, a1 = p0, v0
        dpv = p1 - p0
        a2 = dpv * (3.0 / dt**2) - (v0 * 2.0 + v1) / dt
        a3 = dpv * (-2.0 / dt**3) + (v0 + v1) / dt**2
        x = ts - t0
        val = ((a3 * x + a2) * x + a1) * x + a0
        if not deriv:
            return val
        der = (a3 * x * 3.0 + a2 * 2.0) * x + a1
        return val, der

    def position(self, t) -> np.ndarray | None:
        ts = t.as_offset_seconds() if isinstance(t, Epoch) else float(t)
        seg = self._segment(ts)
        if seg is None:
            return None
        kind, i = seg
        if kind == "knot":
            return self.pos[i]
        return self._hermite(i, ts, deriv=False)

    def state_vector(self, t):
        ts = t.as_offset_seconds() if isinstance(t, Epoch) else float(t)
        seg = self._segment(ts)
        if seg is None:
            return None
        kind, i = seg
        if kind == "knot":
            return self.pos[i], self.vel[i]
        return self._hermite(i, ts, deriv=True)

    def get(self, t) -> tuple[np.ndarray, np.ndarray] | None:
        """Exact-knot lookup (trajectory.rs:846-849)."""
        ts = t.as_offset_seconds() if isinstance(t, Epoch) else float(t)
        i = int(np.searchsorted(self.ts, ts))
        if i < len(self.ts) and self.ts[i] == ts:
            return self.pos[i], self.vel[i]
        return None

    def clear_after(self, t) -> None:
        """Retain knots strictly before t (trajectory.rs:835-839)."""
        ts = t.as_offset_seconds() if isinstance(t, Epoch) else float(t)
        keep = self.ts < ts
        self.ts, self.pos, self.vel = self.ts[keep], self.pos[keep], self.vel[keep]

    def extend(self, other: "HermiteTrajectory") -> None:
        self.ts = np.concatenate([self.ts, other.ts])
        self.pos = np.concatenate([self.pos, other.pos])
        self.vel = np.concatenate([self.vel, other.vel])

    def join(self, other: "HermiteTrajectory") -> None:
        """clear_after(other.start) + extend (spacecraft.rs:557-561)."""
        self.clear_after(other.start_s)
        self.extend(other)


# ---------------------------------------------------------------------------
# High-level: propagate a Ship against an Ephemeris
# ---------------------------------------------------------------------------


def ship_params(ship: Ship, h_init: float = 60.0, n_max: int = 1_000_000) -> AdaptiveParams:
    """INITIAL_ADAPTIVE_PARAMS with the ship's tolerance (load/mod.rs:472-486)."""
    return AdaptiveParams(
        h_init=h_init, tol_pos=ship.tolerance, tol_vel=ship.tolerance, n_max=n_max
    )


def propagate_resuming(
    method: str,
    packed: PackedEphemeris,
    tl: Timeline,
    t0: float,
    pos0,
    vel0,
    end_s: float,
    params: AdaptiveParams,
    max_knots: int = KNOT_CAPACITY,
    max_resumes: int = 1024,
) -> tuple[HermiteTrajectory, int]:
    """Propagate one ship, resuming whenever the knot buffer fills.

    The reference's prediction task keeps stepping an incremental propagator
    until the bound and treats a step error as "end here, flush what we
    have" (prediction.rs:429-432).  The jitted driver has a STATIC knot
    buffer instead, so a long mission can fill it (DONE_KNOTS_FULL); this
    wrapper restarts from the last emitted knot (a fresh adaptive state at
    st.t — the same reset the integrator performs at every burn edge,
    spacecraft.rs:599-615) until the requested end, a real error, or no
    progress.  Returns (trajectory, final reason).
    """
    import logging

    logger = logging.getLogger("ephemeris_explorer_tpu")
    fn = _jitted_propagate_batch(method, params, max_knots)
    tl_b = jax.tree_util.tree_map(lambda x: x[None], tl)
    traj: HermiteTrajectory | None = None
    reason = DONE_END
    cur_t = float(t0)
    cur_p = np.asarray(pos0, dtype=np.float64)
    cur_v = np.asarray(vel0, dtype=np.float64)
    for _ in range(max_resumes):
        r = fn(
            packed,
            tl_b,
            np.asarray([cur_t], dtype=np.float64),
            np.asarray(cur_p, dtype=np.float64)[None],
            np.asarray(cur_v, dtype=np.float64)[None],
            np.asarray([end_s], dtype=np.float64),
        )
        # single batched fetch, sliced to the used prefix (4 separate pulls
        # of mostly-padding buffers otherwise; see propagate_ships)
        kmax = max(int(jax.device_get(jnp.max(r.count))), 1)
        res = PropagationResult(
            *(x[0] for x in jax.device_get(
                PropagationResult(*((x[:, :kmax] if x.ndim >= 2 else x) for x in r))
            ))
        )
        piece = HermiteTrajectory.from_result(res)
        reason = int(res.reason)
        if traj is None:
            traj = piece
        elif len(piece.ts) > 1:
            # first knot duplicates the resume point
            traj.extend(
                HermiteTrajectory(ts=piece.ts[1:], pos=piece.pos[1:], vel=piece.vel[1:])
            )
        if reason != DONE_KNOTS_FULL:
            break
        if len(piece.ts) < 2:  # no forward progress: avoid spinning
            reason = DONE_ERROR
            break
        cur_t = float(piece.ts[-1])
        cur_p, cur_v = piece.pos[-1], piece.vel[-1]
        if cur_t >= end_s:
            reason = DONE_END
            break
        logger.info(
            "knot buffer full at t=%s; resuming (%d knots so far)",
            cur_t,
            len(traj.ts),
        )
    if reason == DONE_ERROR:
        logger.warning(
            "propagation stopped early (%s) at t=%s (requested end %s)",
            REASON_NAMES[reason],
            traj.end_s if traj is not None and len(traj.ts) else cur_t,
            end_s,
        )
    return traj, reason


def propagate_ship(
    ephemeris,
    ship: Ship,
    until: Epoch | None = None,
    max_knots: int = KNOT_CAPACITY,
    body_index: dict[str, int] | None = None,
) -> HermiteTrajectory:
    """Full mission propagation of one ship (spacecraft_propagation.rs path).

    `body_index` (name -> packed body row) is required only when `ephemeris`
    is a bare :class:`PackedEphemeris` (which carries no names) AND the ship
    has body-relative burns.
    """
    if isinstance(ephemeris, PackedEphemeris):
        packed = ephemeris
        index = body_index
        if index is None and any(b.reference is not None for b in ship.burns):
            raise ValueError(
                "PackedEphemeris carries no body names; pass body_index= "
                "to propagate a ship with body-relative burns"
            )
    else:
        packed = ephemeris.pack()
        index = {n: i for i, n in enumerate(ephemeris.names)}
    tl = build_timeline(ship.burns, index)
    params = ship_params(ship)
    end = (until or ship.end).as_offset_seconds()
    traj, _ = propagate_resuming(
        ship.integrator,
        packed,
        tl,
        ship.start.as_offset_seconds(),
        ship.position,
        ship.velocity,
        end,
        params,
        max_knots=max_knots,
    )
    return traj


# ---------------------------------------------------------------------------
# Batched (vmapped) propagation - the "64 ships with flight plans" config
# ---------------------------------------------------------------------------


def stack_timelines(timelines: list[Timeline]) -> Timeline:
    """Pad to a common segment count and stack into (B, S) arrays."""
    s_max = max(t.n_segments for t in timelines)
    padded = []
    for t in timelines:
        pad = s_max - t.n_segments
        if pad:
            # pad on host — device concats here cost ~10 dispatches per
            # ship; the single jnp conversion below ships one buffer
            t = Timeline(
                starts=np.concatenate([np.asarray(t.starts), np.full((pad,), EPOCH_MAX)]),
                ends=np.concatenate([np.asarray(t.ends), np.full((pad,), EPOCH_MAX)]),
                accels=np.concatenate([np.asarray(t.accels), np.zeros((pad, 3))]),
                frame_kind=np.concatenate(
                    [np.asarray(t.frame_kind), np.zeros((pad,), np.int32)]
                ),
                frame_body=np.concatenate(
                    [np.asarray(t.frame_body), np.zeros((pad,), np.int32)]
                ),
            )
        padded.append(t)
    # numpy out: callers hand the stack to jit (ships once) or device_put
    # it with an explicit placement; an eager jnp conversion here would
    # pin it to the default device
    return Timeline(
        *(
            np.stack([np.asarray(getattr(t, f)) for t in padded])
            for f in Timeline._fields
        )
    )


def propagate_batch(
    tab,
    eph: PackedEphemeris,
    timelines: Timeline,     # stacked (B, S) arrays
    t0s,                     # (B,)
    pos0s,                   # (B, 3)
    vel0s,                   # (B, 3)
    end_ts,                  # (B,)
    params: AdaptiveParams,
    max_knots: int = KNOT_CAPACITY,
) -> PropagationResult:
    """vmapped fleet propagation: every ship runs the full segment-bounded
    adaptive driver in lockstep (divergent step counts are masked by the
    vmapped while_loops).  Ships must share (method, tolerance); the driver
    layer groups by those (ship JSON defaults: Verner87 @ 1e-3)."""

    def one(tl, t0, p0, v0, et):
        return propagate(tab, eph, tl, t0, p0, v0, et, params, max_knots=max_knots)

    return jax.vmap(one)(timelines, t0s, pos0s, vel0s, end_ts)


# jit cache for batched propagation: re-jitting a fresh closure per call
# would force a full recompilation every time
_PROPAGATE_JIT_CACHE: dict = {}


def _jitted_propagate_batch(method: str, params: AdaptiveParams, max_knots: int):
    """Compiled batch driver for (method, max_knots).

    The adaptive parameters enter as DYNAMIC scalars (one f64 7-vector +
    the n_max int), not as part of the jit key: every use is pure
    arithmetic inside the step controller, so editing a tolerance or step
    bound in the UI must not trigger a fresh compile — the reference
    treats tolerance as run-time data too (flight_plan.rs:124-184).
    Every batch runs on the default device: a GPU propagates even a single
    ship faster than the host (PERF.md).
    """
    key = (method, max_knots)
    fn = _PROPAGATE_JIT_CACHE.get(key)
    if fn is None:
        tab = get_method(method)

        @jax.jit
        def fn(packed, tl, t0, p0, v0, et, pf, n_max):
            p = AdaptiveParams(
                h_init=pf[0], h_max=pf[1], tol_pos=pf[2], tol_vel=pf[3],
                fac_min=pf[4], fac_max=pf[5], fac=pf[6], n_max=n_max,
            )
            return propagate_batch(
                tab, packed, tl, t0, p0, v0, et, p, max_knots=max_knots
            )

        _PROPAGATE_JIT_CACHE[key] = fn
    pf = np.asarray(
        [params.h_init, params.h_max, params.tol_pos, params.tol_vel,
         params.fac_min, params.fac_max, params.fac],
        dtype=np.float64,
    )
    n_max = np.int64(params.n_max)
    return lambda *args: fn(*args, pf, n_max)


def propagate_ships(ephemeris, ships, until=None, max_knots: int = KNOT_CAPACITY):
    """Propagate a fleet of Ship configs, grouping by (integrator, tolerance).

    Returns {ship.name: HermiteTrajectory}.
    """
    packed = ephemeris.pack() if not isinstance(ephemeris, PackedEphemeris) else ephemeris
    names = ephemeris.names
    index = {n: i for i, n in enumerate(names)}

    groups: dict[tuple, list] = {}
    for s in ships:
        groups.setdefault((s.integrator, s.tolerance), []).append(s)

    out = {}
    for (method, tol), group in groups.items():
        params = ship_params(group[0])
        b = len(group)
        # pad the batch to a power of two with INERT ships (end == start:
        # they finish in one knot): the batch width is a static vmap shape,
        # and each distinct width costs a full recompile per method
        bpad = 1 << max(b - 1, 0).bit_length()
        timelines = [build_timeline(s.burns, index) for s in group]
        t0_list = [s.start.as_offset_seconds() for s in group]
        p_list = [s.position for s in group]
        v_list = [s.velocity for s in group]
        end_list = [(until or s.end).as_offset_seconds() for s in group]
        for _ in range(bpad - b):
            timelines.append(timelines[0])
            t0_list.append(t0_list[0])
            p_list.append(p_list[0])
            v_list.append(v_list[0])
            end_list.append(t0_list[0])  # inert: end == start
        # operands stay NUMPY: the jit call ships them to the device once
        tls = stack_timelines(timelines)
        t0s = np.asarray(t0_list, dtype=np.float64)
        p0s = np.stack(p_list).astype(np.float64)
        v0s = np.stack(v_list).astype(np.float64)
        ends = np.asarray(end_list, dtype=np.float64)
        fn = _jitted_propagate_batch(method, params, max_knots)
        r = fn(packed, tls, t0s, p0s, v0s, ends)
        # One batched device->host fetch for the whole group: slicing the
        # device arrays per ship costs ~5 transfers per ship (count/reason
        # syncs + ts/pos/vel prefix pulls).  The knot buffers are also
        # mostly padding (static max_knots vs ~1e2 used), so slice to the
        # batch-max count on device first (29 MB -> ~0.4 MB for the
        # 64-ship fleet).
        kmax = max(int(jax.device_get(jnp.max(r.count))), 1)
        r = jax.device_get(
            PropagationResult(*((x[:, :kmax] if x.ndim >= 2 else x) for x in r))
        )
        for i, s in enumerate(group):
            res = PropagationResult(*(x[i] for x in r))
            if int(res.reason) == DONE_KNOTS_FULL:
                # per-ship resume fallback: the vmapped batch cannot resume
                # ships individually, so an exhausted ship re-runs through
                # the chunked single-ship driver
                traj, _ = propagate_resuming(
                    method,
                    packed,
                    jax.tree_util.tree_map(lambda x: x[i], tls),
                    float(t0s[i]),
                    np.asarray(p0s[i]),
                    np.asarray(v0s[i]),
                    float(ends[i]),
                    params,
                    max_knots=max_knots,
                )
                out[s.name] = traj
            else:
                out[s.name] = HermiteTrajectory.from_result(res)
    return out

"""Ephemeris generation and evaluation: the celestial production path.

Rebuilds the reference pipeline
(NBodyPropagator + SplineInterpolators + UniformSpline,
``ephemeris/src/propagators/nbody.rs``, ``ephemeris/src/trajectory.rs:412-633``)
for an accelerator:

* integration is a ``lax.scan`` over fixed QT12/Stormer13 multistep steps
  (one O(N^2) force evaluation per step);
* per-body position sampling (every ``count`` steps) and the 9-sample
  least-squares polynomial fits run as ONE vectorised pass per chunk over the
  scan-emitted positions (static shapes, no per-step scatters, no host
  round-trips in the hot loop);
* the host-side :class:`BodyEphemeris` mirrors ``UniformSpline`` exactly
  (O(1) end-inclusive segment lookup, push/clear/append/prepend semantics,
  Horner value+derivative evaluation), and :class:`PackedEphemeris` is the
  flattened device view used by the spacecraft RHS.

Time is carried as f64 seconds since the TAI epoch (ftime.Epoch offsets).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from .ftime import Duration, Epoch
from .integrators import get as get_method
from .integrators.multistep import (
    ELM2Carry,
    ELM2CarryQ,
    elm2_init,
    elm2_init_q,
    elm2_step,
    elm2_step_q,
)
from .ops import expansion as ex
from .io.scene import DIV, EphemeridesSettings, SolarSystemState
from .ops import nbody
from .ops.polyfit import MAX_COEFFS, fit_matrices, horner, horner_and_deriv

# Canonical generation chunk (steps per device dispatch).  Every entry point
# (Universe/PredictionTask, generate_ephemeris, bench.py) uses THIS size so
# they share compiled programs and persistent-compilation-cache entries:
# each distinct scan shape is a fresh compile.  ~90 days of dt=600 s steps:
# big enough for the unroll=8 scan body, small enough to keep merges
# incremental.
CHUNK_STEPS = 13184


def bucket_tail(n: int, chunk: int, min_n: int = 1) -> int:
    """Round a tail chunk up to the bucket ladder, capped at ``chunk``.

    Keeps the set of compiled scan shapes bounded (the span overshoots
    slightly; see CHUNK_STEPS).  The ladder is powers of two PLUS their
    1.5x midpoints (one extra mantissa bit): overshoot is bounded at
    b <= 1.5*(n-1) (asymptotically 33% of the tail) instead of the pow2
    ladder's 100%, for 2x the (persistent-cached, primeable via
    tools/prime_cache.py) shape universe.  Applied ONLY when the caller did
    not pick an explicit chunk size — an explicit chunk_steps is a
    contract.
    ``min_n`` lets callers enforce a floor (e.g. the multistep order the
    startup chunk must cover).
    """
    n = max(n, min_n)
    p = 1 << max(n - 1, 1).bit_length()  # next pow2 >= n
    mid = 3 * (p // 4)                   # 1.5x the previous octave
    if p >= 4 and mid >= n:
        p = mid
    return min(p, chunk)


def bucket_ladder(chunk: int, min_n: int = 1) -> list:
    """Every value :func:`bucket_tail` can produce for tails in
    [min_n, chunk] — the canonical compile-shape set tools/prime_cache.py
    primes."""
    out = set()
    n = max(min_n, 1)
    while n <= chunk:
        b = bucket_tail(n, chunk, min_n)
        out.add(b)
        n = b + 1
    out.add(chunk)
    return sorted(out)


# ---------------------------------------------------------------------------
# Host-side per-body container (UniformSpline semantics)
# ---------------------------------------------------------------------------


class BodyEphemeris:
    """Piecewise-polynomial trajectory over uniform segments.

    Equivalent of ``UniformSpline<DVec3>`` (trajectory.rs:412-633): ``start``
    is the epoch of the first segment, every segment spans ``interval``
    seconds, and segment coefficients are ascending-power polynomials in
    tau = (t - seg_start) / interval, padded to 9 coefficients.

    Concurrency: the reference shares trajectories between the merge thread
    and render systems via ``Arc<RwLock>`` (dynamics/mod.rs:84-147).  Here the
    mutable state is a single ``(start_s, coeffs)`` tuple published in ONE
    assignment per mutation, so a reader racing a background PredictionTask
    merge sees either the old or the new snapshot - never new coefficients
    with an old start.  Readers take one snapshot per evaluation.
    """

    __slots__ = ("interval_s", "_snap")

    def __init__(self, start_s: float, interval_s: float, coeffs: np.ndarray):
        self.interval_s = float(interval_s)     # immutable after construction
        self._snap = (float(start_s), coeffs)   # atomically-published pair

    # -- snapshot accessors ----------------------------------------------
    @property
    def start_s(self) -> float:
        return self._snap[0]

    @property
    def coeffs(self) -> np.ndarray:
        return self._snap[1]

    def snapshot(self) -> tuple[float, np.ndarray]:
        """One consistent (start_s, coeffs) view."""
        return self._snap

    # -- bounds (trajectory.rs:426-447) ---------------------------------
    @property
    def segment_count(self) -> int:
        return self._snap[1].shape[0]

    @property
    def span_s(self) -> float:
        return self.interval_s * self.segment_count

    @property
    def end_s(self) -> float:
        start, coeffs = self._snap
        return start + self.interval_s * coeffs.shape[0]

    @property
    def start(self) -> Epoch:
        return Epoch.from_offset_seconds(self.start_s)

    @property
    def end(self) -> Epoch:
        return Epoch.from_offset_seconds(self.end_s)

    def contains(self, t: Epoch | float) -> bool:
        ts = t.as_offset_seconds() if isinstance(t, Epoch) else float(t)
        start, coeffs = self._snap
        local = ts - start
        return local >= 0.0 and local <= self.interval_s * coeffs.shape[0]

    # -- indexing (trajectory.rs:552-617) --------------------------------
    def _index_exclusive(self, local: float, nseg: int) -> int | None:
        """End-inclusive 'previous polynomial at a knot' rule."""
        if local < 0.0 or local > self.interval_s * nseg:
            return None
        return max(int(np.ceil(local / self.interval_s)) - 1, 0)

    def get_polynomial(self, t: Epoch | float):
        ts = t.as_offset_seconds() if isinstance(t, Epoch) else float(t)
        start, coeffs = self._snap
        nseg = coeffs.shape[0]
        local = ts - start
        idx = self._index_exclusive(local, nseg)
        if idx is None or idx >= nseg:
            return None
        tau = (local - self.interval_s * idx) / self.interval_s
        return coeffs[idx], tau

    # -- evaluation ------------------------------------------------------
    def position(self, t: Epoch | float) -> np.ndarray | None:
        pt = self.get_polynomial(t)
        if pt is None:
            return None
        c, tau = pt
        return np.asarray(horner(jnp.asarray(c), tau))

    def state_vector(self, t: Epoch | float):
        pt = self.get_polynomial(t)
        if pt is None:
            return None
        c, tau = pt
        pos, dtau = horner_and_deriv(jnp.asarray(c), tau)
        # dx/dt = dx/dtau / interval  (trajectory.rs:466-469)
        return np.asarray(pos), np.asarray(dtau) / self.interval_s

    # -- mutation (trajectory.rs:484-549) --------------------------------
    # Every mutator builds the new arrays first, then publishes the new
    # (start_s, coeffs) pair in a single assignment.
    def push_back(self, coeffs: np.ndarray) -> None:
        start, old = self._snap
        self._snap = (start, np.concatenate([old, coeffs.reshape(-1, MAX_COEFFS, 3)]))

    def push_front(self, coeffs: np.ndarray) -> None:
        start, old = self._snap
        c = coeffs.reshape(-1, MAX_COEFFS, 3)
        self._snap = (
            start - self.interval_s * c.shape[0],
            np.concatenate([c, old]),
        )

    def append(self, other: "BodyEphemeris") -> None:
        start, old = self._snap
        o_start, o_coeffs = other._snap
        assert abs((start + self.interval_s * old.shape[0]) - o_start) < 1e-6
        self._snap = (start, np.concatenate([old, o_coeffs]))

    def prepend(self, other: "BodyEphemeris") -> None:
        start, old = self._snap
        o_start, o_coeffs = other._snap
        assert abs(start - (o_start + other.interval_s * o_coeffs.shape[0])) < 1e-6
        self._snap = (o_start, np.concatenate([o_coeffs, old]))

    def clear_after(self, t: Epoch | float) -> None:
        """Truncate segments at/after `t` (trajectory.rs:544-549).

        Out-of-range `t` is a no-op, matching the reference: UniformSpline's
        get_index returns None for t outside the spline, so clear_after
        leaves the spline untouched in that case.
        """
        ts = t.as_offset_seconds() if isinstance(t, Epoch) else float(t)
        start, coeffs = self._snap
        local = ts - start
        if local < 0.0 or local >= self.interval_s * coeffs.shape[0]:
            return
        idx = int(local / self.interval_s)
        self._snap = (start, coeffs[:idx])

    def clear_before(self, t: Epoch | float) -> None:
        """Drop segments strictly before `t` (trajectory.rs:537-542)."""
        ts = t.as_offset_seconds() if isinstance(t, Epoch) else float(t)
        start, coeffs = self._snap
        nseg = coeffs.shape[0]
        idx = self._index_exclusive(ts + self.interval_s - start, nseg)
        if idx is None:
            return
        idx = min(idx, nseg)
        self._snap = (start + self.interval_s * idx, coeffs[idx:])

    def between(self, start, end) -> "BodyEphemeris | None":
        """Sub-spline covering [start, end] (trajectory.rs:484-502)."""
        b_start, coeffs = self._snap
        nseg = coeffs.shape[0]
        if nseg == 0:
            return None
        s = start.as_offset_seconds() if isinstance(start, Epoch) else float(start)
        e = end.as_offset_seconds() if isinstance(end, Epoch) else float(end)
        i0 = self._index_exclusive(s - b_start, nseg)
        i1 = self._index_exclusive(e - b_start, nseg)
        if i0 is None or i1 is None:
            return None
        i1 = min(i1, nseg - 1)
        return BodyEphemeris(
            start_s=b_start + self.interval_s * i0,
            interval_s=self.interval_s,
            coeffs=coeffs[i0 : i1 + 1].copy(),
        )

    @property
    def nbytes(self) -> int:
        """Heap footprint of the coefficient store (the deepsize analogue
        surfaced in the ephemerides-debug window, debug.rs:141-146)."""
        return int(self._snap[1].nbytes)


@dataclass
class Ephemeris:
    """A system of body ephemerides (ordered as the scene's body list)."""

    names: list[str]
    mus: np.ndarray                    # (N,)
    bodies: dict[str, BodyEphemeris]

    @property
    def n(self) -> int:
        return len(self.names)

    def __getitem__(self, name: str) -> BodyEphemeris:
        return self.bodies[name]

    @property
    def start(self) -> Epoch:
        """Latest per-body start (bounds = intersection, simulation.rs:109-115).

        An EMPTY system returns the Epoch.ZERO sentinel (so start == end and
        the span is empty); callers that can see empty systems must check
        ``bodies`` rather than compare epochs.
        """
        return max((b.start for b in self.bodies.values()), default=Epoch.ZERO)

    @property
    def end(self) -> Epoch:
        """Earliest per-body end; Epoch.ZERO sentinel when empty (see start)."""
        return min((b.end for b in self.bodies.values()), default=Epoch.ZERO)

    def contains(self, t: Epoch | float) -> bool:
        return all(b.contains(t) for b in self.bodies.values())

    def positions(self, t: Epoch | float) -> np.ndarray | None:
        out = []
        for n in self.names:
            p = self.bodies[n].position(t)
            if p is None:
                return None
            out.append(p)
        return np.stack(out)

    @property
    def nbytes(self) -> int:
        """Total coefficient heap footprint (debug-window memory stat)."""
        return sum(b.nbytes for b in self.bodies.values())

    def pack(self) -> "PackedEphemeris":
        # one atomic snapshot per body so a concurrent merge cannot tear
        # a body's (start, coeffs) pair; cross-body consistency is the
        # caller's job (Universe holds its lock around pack())
        snaps = [self.bodies[n].snapshot() for n in self.names]
        starts = np.array([s for s, _ in snaps])
        intervals = np.array([self.bodies[n].interval_s for n in self.names])
        nsegs = np.array([c.shape[0] for _, c in snaps], dtype=np.int64)
        offsets = np.concatenate([[0], np.cumsum(nsegs)[:-1]])
        flat = np.concatenate([c for _, c in snaps])
        return PackedEphemeris(
            mus=jnp.asarray(self.mus),
            starts=jnp.asarray(starts),
            intervals=jnp.asarray(intervals),
            offsets=jnp.asarray(offsets),
            nsegs=jnp.asarray(nsegs),
            coeffs=jnp.asarray(flat),
        )


class PackedEphemeris(NamedTuple):
    """Flattened device view for jit-time evaluation (ragged across bodies)."""

    mus: jax.Array        # (N,)
    starts: jax.Array     # (N,)
    intervals: jax.Array  # (N,)
    offsets: jax.Array    # (N,) first-segment index into coeffs
    nsegs: jax.Array      # (N,)
    coeffs: jax.Array     # (sum(nsegs), MAX_COEFFS, 3)

    @property
    def start_s(self) -> jax.Array:
        return jnp.max(self.starts)

    @property
    def end_s(self) -> jax.Array:
        return jnp.min(self.starts + self.intervals * self.nsegs)

    def _segments(self, t):
        """(seg_coeffs (N, MAX_COEFFS, 3), tau (N,)) at time t (f64 seconds)."""
        local = t - self.starts
        idx = jnp.ceil(local / self.intervals).astype(jnp.int64) - 1
        idx = jnp.clip(idx, 0, self.nsegs - 1)
        tau = (local - self.intervals * idx) / self.intervals
        return self.coeffs[self.offsets + idx], tau

    def positions(self, t) -> jax.Array:
        """All body positions at time t: (N, 3).  No bounds checking - the
        caller is responsible for keeping t within bounds (the propagation
        drivers bound their advance by `end_s`, mirroring the reference's
        EvalFailed -> stop behavior)."""
        c, tau = self._segments(t)
        return horner(c, tau)

    def state_vectors(self, t):
        c, tau = self._segments(t)
        pos, dtau = horner_and_deriv(c, tau)
        return pos, dtau / self.intervals[:, None]

    def accel_at(self, t, at) -> jax.Array:
        """Gravitational acceleration from all bodies at point(s) `at`.

        Mirrors Bodies::acceleration (dynamics/spacecraft.rs:218-229).
        """
        return nbody.accel_at(self.positions(t), self.mus, at)


# ---------------------------------------------------------------------------
# Generation: scan with in-carry sampling + fitting
# ---------------------------------------------------------------------------


class SampleState(NamedTuple):
    ring: jax.Array       # (N, DIV, 3) sample ring; slot = sample_idx % 8
    n: jax.Array          # global step count (int64)


class GenCarry(NamedTuple):
    ms: object            # ELM2Carry | ELM2CarryQ
    samp: SampleState


def _fit_chunk_pass(all_ys, samp, counts, fit_ms, n0, nn_caps, cap_off, out):
    """Post-scan sampling + fitting for one chunk.

    all_ys: (L, N, 3) positions emitted by the chunk's steps (step n0+i+1 at
    row i; n0 is a traced scalar).  The per-body sample ring carries the <= 8
    samples preceding the chunk.  Segment counts are CAPACITY-shaped:
    ``nn_caps[b]`` is the most segments body b can complete in an L-step
    window (a function of L and counts only — NOT of the chunk's offset), so
    the compiled shape is offset-independent: the actually-completed segment
    count is computed from the traced ``n0`` and surplus capacity rows are
    dropped by an out-of-bounds scatter.  (Baking the actual counts into the
    jit key made every extension offset a fresh compile.)  Sample positions are gathered with dynamic
    indices from the chunk rows or the ring, fitted with the precomputed
    least-squares matrices.  Replaces a per-step scatter solout with one
    dense pass.

    Bodies are GROUPED by their static (count, fit-matrix) config and each
    group is processed in one batched gather + broadcast-reduce, so the
    trace size scales with the number of distinct configs, not with N
    (full_solar_system: 12 groups for 32 bodies; synthetic large-N systems:
    one group).
    """
    L = all_ys.shape[0]
    nb = len(counts)
    n0 = jnp.asarray(n0, jnp.int64)
    n_rows = out.shape[0]

    groups: dict[tuple, list[int]] = {}
    for b in range(nb):
        key = (int(counts[b]), int(nn_caps[b]), fit_ms[b].tobytes())
        groups.setdefault(key, []).append(b)

    new_ring = samp.ring
    for (cb, nn, _), bodies in groups.items():
        g = jnp.asarray(np.asarray(bodies))
        ys_g = all_ys[:, np.asarray(bodies)]                      # (L, |G|, 3)
        if nn > 0:
            m0 = (n0 // cb) // DIV
            m1 = ((n0 + L) // cb) // DIV                          # completed after chunk
            k_idx = DIV * m0 + jnp.arange(DIV * nn + 1)          # sample indices
            steps = k_idx * cb                                    # global steps
            in_chunk = steps > n0
            chunk_rows = jnp.clip(steps - n0 - 1, 0, L - 1)
            from_chunk = ys_g[chunk_rows]                         # (S, |G|, 3)
            # ring: (N, DIV, 3) -> (S, |G|, 3)
            from_ring = jnp.transpose(
                samp.ring[np.asarray(bodies)][:, k_idx % DIV], (1, 0, 2)
            )
            samples = jnp.where(in_chunk[:, None, None], from_chunk, from_ring)
            # window segments: (nn, 9) static gather
            win = np.arange(nn)[:, None] * DIV + np.arange(DIV + 1)[None, :]
            seg_samples = samples[jnp.asarray(win)]               # (nn, 9, |G|, 3)
            m_g = jnp.asarray(fit_ms[bodies[0]])                  # (9, 9)
            coeffs = jnp.sum(
                m_g[None, :, :, None, None] * seg_samples[:, None, :, :, :],
                axis=2,
            )                                                     # (nn, 9, |G|, 3)
            # segment s (global index m0 + s) is complete iff m0 + s < m1;
            # incomplete capacity rows scatter out of bounds and are dropped
            valid = (m0 + jnp.arange(nn)) < m1                    # (nn,)
            rows = jnp.concatenate(
                [
                    jnp.where(valid, cap_off[b] + jnp.arange(nn), n_rows)
                    for b in bodies
                ]
            )
            flat = jnp.transpose(coeffs, (2, 0, 1, 3)).reshape(-1, MAX_COEFFS, 3)
            out = out.at[rows].set(flat, mode="drop")

        # ring update, vectorised over slots: the latest sample k with
        # k % 8 == j inside this chunk (keep the old entry if none landed)
        k_max = (n0 + L) // cb
        js = jnp.arange(DIV)
        ks = k_max - ((k_max - js) % DIV)
        steps_r = ks * cb
        rows_r = jnp.clip(steps_r - n0 - 1, 0, L - 1)
        fresh = (steps_r > n0) & (ks >= 0)
        ring_g = jnp.where(
            fresh[None, :, None],
            jnp.transpose(ys_g[rows_r], (1, 0, 2)),               # (|G|, DIV, 3)
            samp.ring[np.asarray(bodies)],
        )
        new_ring = new_ring.at[g].set(ring_g)
    return new_ring, out


@dataclass(frozen=True)
class GenSpec:
    """Static per-generation configuration."""

    method: str                      # "QuinlanTremaine12" | "Stormer13" | ...
    h: float                         # signed step (seconds); negative = backward
    counts: tuple[int, ...]          # per-body sample stride in steps
    degrees: tuple[int, ...]
    perturbations: tuple = ()        # ops.perturbations specs (hashable)
    precise_sums: bool = False       # pair-precision beta sums (extended modes)

    @property
    def backward(self) -> bool:
        return self.h < 0


class NBodyPropagator:
    """Incremental fixed-step N-body propagation emitting fitted segments.

    The scan-shaped equivalent of
    ``NBodyPropagator<D, DVec3, QuinlanTremaine12<f64>, SplineInterpolators>``
    (dynamics/celestial.rs:139-140): call :meth:`step_chunk` repeatedly; each
    call advances ``n_steps`` integration steps in one jitted scan and returns
    the per-body polynomial segments completed during the chunk.
    """

    def __init__(
        self,
        state: SolarSystemState,
        settings: EphemeridesSettings,
        direction: int = +1,
        method: str = "QuinlanTremaine12",
        precision: str = "auto",
        perturbations: tuple = (),
        precise_sums: bool | None = None,
    ):
        """precision: "f64" (native IEEE f64, the reference's numerics),
        "extended" (quad-f32 expansion position state, see
        integrators.multistep.elm2_step_q), "extended3" (expansion state +
        3-limb force with error-free pair differences), "extendedF"
        (expansion state + full tf96 force, the highest-accuracy engine; see
        docs/ACCURACY.md), or "auto" (= "f64": every supported device
        computes native f64).

        perturbations: tuple of ops.perturbations specs (hashable); empty =
        the reference's Newtonian point-mass model.

        precise_sums: pair-precision beta sums in the multistep update
        (multistep._wsum_precise).  None = auto: ON for the extended
        precisions, OFF for "f64"."""
        names = [b.name for b in state.bodies]
        missing = [n for n in names if n not in settings.settings]
        if missing:
            raise KeyError(f"missing interpolation parameters for {missing}")
        counts = tuple(settings.settings[n].count for n in names)
        degrees = tuple(settings.settings[n].degree for n in names)
        h = float(np.copysign(settings.dt.as_seconds(), direction))
        if precision == "auto":
            precision = "f64"
        if precision not in ("f64", "extended", "extended3", "extendedF"):
            raise ValueError(precision)
        self.precision = precision
        if precise_sums is None:
            precise_sums = precision in ("extended", "extended3", "extendedF")
        self.spec = GenSpec(
            method=method, h=h, counts=counts, degrees=degrees,
            perturbations=tuple(perturbations),
            precise_sums=bool(precise_sums),
        )
        self.names = names
        self.mus = state.mus()
        self.dt_s = settings.dt.as_seconds()
        self.t0_s = state.epoch.as_offset_seconds()
        self._mu_dev = jnp.asarray(self.mus)
        self._tab = get_method(method)
        self._carry: GenCarry | None = None
        self._n_steps_done = 0
        self._chunk_fns: dict = {}
        self._init_state = (jnp.asarray(state.positions()), jnp.asarray(state.velocities()))
        # exact host-side limb split of the initial positions for the
        # extended precisions (three f32 limbs hold any binary64 exactly)
        self._init_limbs = ex.from_f64_host(state.positions())

    # -- bookkeeping -----------------------------------------------------
    @property
    def steps_done(self) -> int:
        return self._n_steps_done

    def time(self) -> Epoch:
        return Epoch.from_offset_seconds(self.t0_s + self.spec.h * self._n_steps_done)

    def _segments_done(self, n_steps: int) -> np.ndarray:
        c = np.array(self.spec.counts, dtype=np.int64)
        return (n_steps // c) // DIV

    # -- the jitted chunk ------------------------------------------------
    def _build_chunk_fn(self, n_scan: int, startup: bool, nn_caps, cap_off):
        return _chunk_fn(
            self.spec, self.precision, n_scan, startup, nn_caps, cap_off
        )

    def step_chunk_async(self, n_steps: int):
        """Dispatch `n_steps` steps; return a zero-arg fetcher for the
        per-body coefficients.

        The device program is queued asynchronously, so the caller can
        dispatch the NEXT chunk before invoking this chunk's fetcher —
        the host transfer of the fitted coefficient block then overlaps
        the next chunk's integration (double buffering).
        """
        startup = self._carry is None
        tab = self._tab
        n_scan = n_steps - (tab.order if startup else 0)
        if n_scan < 0:
            raise ValueError(f"first chunk must cover at least {tab.order} steps")

        n0 = self._n_steps_done
        m0 = self._segments_done(n0)
        m1 = self._segments_done(n0 + n_steps)
        n_new = tuple(int(x) for x in (m1 - m0))

        # capacity-shaped emission (offset-independent; see _fit_chunk_pass):
        # body b can complete at most n_steps // (DIV * count) + 1 segments
        # in any n_steps window
        c = np.array(self.spec.counts, dtype=np.int64)
        nn_caps = tuple(int(x) for x in (n_steps // (DIV * c) + 1))
        cap_off = tuple(
            int(x) for x in np.concatenate([[0], np.cumsum(nn_caps)[:-1]])
        )
        out = jnp.zeros((int(sum(nn_caps)), MAX_COEFFS, 3), dtype=jnp.float64)

        key = (n_scan, startup)
        if key not in self._chunk_fns:
            self._chunk_fns[key] = self._build_chunk_fn(n_scan, startup, nn_caps, cap_off)
        fn = self._chunk_fns[key]

        init_y, init_dy = self._init_state
        carry, out = fn(
            self._mu_dev,
            self._carry,
            init_y,
            init_dy,
            self._init_limbs,
            jnp.asarray(self.t0_s, jnp.float64),
            jnp.asarray(n0, jnp.int64),
            out,
        )
        self._carry = carry
        self._n_steps_done += n_steps
        names = self.names

        def fetch() -> dict[str, np.ndarray]:
            out_np = np.asarray(out)
            return {
                name: out_np[cap_off[i] : cap_off[i] + n_new[i]]
                for i, name in enumerate(names)
            }

        return fetch

    def step_chunk(self, n_steps: int) -> dict[str, np.ndarray]:
        """Advance `n_steps` steps; return dict name -> (n_new, 9, 3) coeffs."""
        return self.step_chunk_async(n_steps)()

    # -- segment placement ----------------------------------------------
    def segment_epochs(self, name: str, first_seg: int, n_seg: int):
        """(start_s, interval_s) of segments [first_seg, first_seg + n_seg)."""
        i = self.names.index(name)
        interval = self.dt_s * self.spec.counts[i] * DIV
        if not self.spec.backward:
            start = self.t0_s + interval * first_seg
        else:
            start = self.t0_s - interval * (first_seg + n_seg)
        return start, interval




_CHUNK_FN_CACHE: dict = {}


def _chunk_fn(spec: "GenSpec", precision: str, n_scan: int, startup: bool, nn_caps, cap_off):
    """Build (or fetch) the jitted generation chunk for a static config.

    Cached at module level so every propagator with the same configuration
    (method, step, counts, degrees, direction, precision, chunk shape) shares
    one compilation - fresh closures would recompile per instance.  The
    emission buffer is capacity-shaped (see _fit_chunk_pass), so the key is
    independent of the chunk's step offset: any extension reuses the
    compiled chunk for its (n_scan, startup) size.
    """
    key = (spec, precision, n_scan, startup)
    cached = _CHUNK_FN_CACHE.get(key)
    if cached is not None:
        return cached

    tab = get_method(spec.method)
    h = spec.h
    counts = spec.counts
    fit_ms = np.asarray(fit_matrices(spec.degrees, backward=spec.backward))
    extended = precision in ("extended", "extended3", "extendedF")
    pert = None
    if spec.perturbations:
        from .ops import perturbations as _perts

        pert = _perts.build(spec.perturbations)

    def chunk(mu, carry: GenCarry | None, init_y, init_dy, init_limbs, t0, n0, out):
        if pert is None:
            def accel(t, y):
                return nbody.pairwise_accel_auto(y, mu)
        else:
            def accel(t, y, dy):
                return nbody.pairwise_accel_auto(y, mu) + pert(t, y, dy, mu)

            accel.needs_velocity = True

        accel_limbs = None
        if precision == "extended3":
            from .ops.nbody_modes import pairwise_accel_limbs

            def _base_limbs(limbs):
                return pairwise_accel_limbs(limbs[0], limbs[1], limbs[2], mu)
        elif precision == "extendedF":
            from .ops.nbody_full3 import pairwise_accel_full3 as _full3

            def _base_limbs(limbs):
                return _full3(limbs[0], limbs[1], limbs[2], mu)

        if precision in ("extended3", "extendedF"):
            if pert is None:
                def accel_limbs(t, limbs):  # noqa: F811
                    return _base_limbs(limbs)
            else:
                def accel_limbs(t, limbs, dy):  # noqa: F811
                    y64 = (
                        limbs[2].astype(jnp.float64)
                        + limbs[1].astype(jnp.float64)
                        + limbs[0].astype(jnp.float64)
                    )
                    return _base_limbs(limbs) + pert(t, y64, dy, mu)

                accel_limbs.needs_velocity = True

        if startup:
            ring0 = jnp.zeros((len(counts), DIV, 3), dtype=jnp.float64)
            ring0 = ring0.at[:, 0].set(init_y)  # sample k=0 = initial position
            samp = SampleState(ring=ring0, n=jnp.asarray(0, jnp.int64))
            if extended:
                # limb-aware startup (the starter sees the same limb force
                # as the main scan) from the EXACT host-split initial limbs
                # (elm2_init_q docstring; measured in docs/ACCURACY.md)
                ms = elm2_init_q(
                    tab, accel, t0, init_y, init_dy, h,
                    accel_limbs=accel_limbs, y0_limbs=init_limbs,
                )
                startup_ys = ex.to_f64(tuple(l[::-1] for l in ms.ys))
            else:
                from .integrators.multistep import elm2_startup_scan

                t, dy, ys_fwd, ddys_fwd = elm2_startup_scan(
                    tab, accel, t0, init_y, init_dy, h
                )
                ms = ELM2Carry(t=t, ys=ys_fwd[::-1], ddys=ddys_fwd[::-1], dy=dy)
                startup_ys = ys_fwd
            carry = GenCarry(ms=ms, samp=samp)
        else:
            startup_ys = None

        # velocity-independent forces defer the Cowell velocity out of the
        # scan (see elm2_step with_velocity); restored once per chunk below
        lazy_vel = pert is None

        def body(ms, _):
            if extended:
                ms = elm2_step_q(
                    tab, accel, h, ms, accel_limbs=accel_limbs,
                    with_velocity=not lazy_vel,
                    precise_sums=spec.precise_sums,
                )
                y_now = ex.to_f64(tuple(l[0] for l in ms.ys))
            else:
                ms = elm2_step(tab, accel, h, ms, with_velocity=not lazy_vel)
                y_now = ms.ys[0]
            return ms, y_now

        # unroll: at solar-system N the scan body is dispatch-bound (many
        # small fused kernels on (12, 32, 3) arrays); unrolling 8 steps per
        # loop iteration amortises the sequential loop overhead.  Gated on
        # long scans: the 8x bigger body is pure compile-time cost for the
        # short chunks tests and interactive extension use.
        ms, scan_ys = jax.lax.scan(
            body, carry.ms, None, length=n_scan,
            unroll=8 if n_scan >= 4096 else 1,
        )
        if lazy_vel and n_scan > 0:
            from .integrators.multistep import elm2_velocity, elm2_velocity_q

            ms = ms._replace(
                dy=elm2_velocity_q(tab, ms, h, precise_sums=spec.precise_sums)
                if extended
                else elm2_velocity(tab, ms, h)
            )
        all_ys = (
            jnp.concatenate([startup_ys, scan_ys])
            if startup_ys is not None
            else scan_ys
        )
        ring, out = _fit_chunk_pass(
            all_ys, carry.samp, counts, fit_ms, n0, nn_caps, cap_off, out
        )
        samp = SampleState(ring=ring, n=carry.samp.n + all_ys.shape[0])
        return GenCarry(ms=ms, samp=samp), out

    fn = jax.jit(chunk, donate_argnums=(7,))
    _CHUNK_FN_CACHE[key] = fn
    return fn

def generate_ephemeris(
    state: SolarSystemState,
    settings: EphemeridesSettings,
    span: Duration,
    direction: int = +1,
    method: str = "QuinlanTremaine12",
    chunk_steps: int | None = None,
    precision: str = "auto",
    perturbations: tuple = (),
    precise_sums: bool | None = None,
) -> Ephemeris:
    """Generate a full system ephemeris over `span` (one direction).

    Equivalent to the app's initial generation path (load/mod.rs:673-687 with
    prediction.rs dispatch): fixed-step integration with per-body
    sampling/fitting, assembled into UniformSpline-equivalent containers.
    """
    prop = NBodyPropagator(
        state, settings, direction=direction, method=method,
        precision=precision, perturbations=perturbations,
        precise_sums=precise_sums,
    )
    n_steps = int(round(abs(span.as_seconds()) / prop.dt_s))
    chunk = chunk_steps or min(n_steps, CHUNK_STEPS)

    names = prop.names
    parts: dict[str, list[np.ndarray]] = {n: [] for n in names}
    done = 0
    pending = None
    while done < n_steps:
        this = min(chunk, n_steps - done)
        if chunk_steps is None and this < chunk:
            this = bucket_tail(this, chunk)
        # dispatch chunk k+1 BEFORE fetching chunk k's coefficients: the
        # host transfer overlaps the next chunk's device integration
        fetch = prop.step_chunk_async(this)
        if pending is not None:
            res = pending()
            for n in names:
                parts[n].append(res[n])
        pending = fetch
        done += this
    if pending is not None:
        res = pending()
        for n in names:
            parts[n].append(res[n])

    bodies = {}
    for i, n in enumerate(names):
        coeffs = np.concatenate(parts[n]) if parts[n] else np.zeros((0, MAX_COEFFS, 3))
        if prop.spec.backward:
            # backward generation produces segments newest-first; the spline
            # stores them in increasing time (push_front semantics)
            coeffs = coeffs[::-1]
        start, interval = prop.segment_epochs(n, 0, coeffs.shape[0])
        bodies[n] = BodyEphemeris(start_s=start, interval_s=interval, coeffs=coeffs)
    return Ephemeris(names=names, mus=prop.mus, bodies=bodies)


def merge_bidirectional(forward: Ephemeris, backward: Ephemeris) -> Ephemeris:
    """Combine forward + backward ephemerides into one span (prepend merge,
    celestial.rs:216-235)."""
    bodies = {}
    for n in forward.names:
        f, b = forward.bodies[n], backward.bodies[n]
        merged = BodyEphemeris(start_s=f.start_s, interval_s=f.interval_s, coeffs=f.coeffs)
        if b.segment_count:
            merged.prepend(b)
        bodies[n] = merged
    return Ephemeris(names=forward.names, mus=forward.mus, bodies=bodies)

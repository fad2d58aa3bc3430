"""Multi-chip scale-out: device meshes, sharded N-body kernels, ensembles.

The reference is single-process CPU Rust (SURVEY.md 2.6); its scaling axes in
the rebuild are:

* N (bodies)   - shard the O(N^2) pair interaction by receiver rows across
  mesh axis "model"; each device all-gathers source positions over the
  interconnect (NVLink, all to all between the cards of a host) and
  computes its local rows (a transpose-free row decomposition, the standard
  N-body SPMD recipe);
* E (ensemble) - independent initial conditions / batched spacecraft are data
  parallel across mesh axis "data" (pure vmap, no collectives);
* time         - sequential lax.scan (not parallelisable; physics).

Both the GSPMD path (jit + sharding annotations; XLA inserts collectives) and
an explicit shard_map path (manual all_gather) are provided.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..integrators.multistep import ELM2Carry, elm2_init, elm2_step, elm2_velocity
from ..ops import nbody


def make_mesh(data: int = 1, model: int = 1, devices=None) -> Mesh:
    devices = devices if devices is not None else jax.devices()
    n = data * model
    assert len(devices) >= n, f"need {n} devices, have {len(devices)}"
    dev = np.asarray(devices[:n]).reshape(data, model)
    return Mesh(dev, axis_names=("data", "model"))


# ---------------------------------------------------------------------------
# Explicit shard_map kernel: row-sharded pairwise acceleration
# ---------------------------------------------------------------------------


def pairwise_accel_rowsharded(mesh: Mesh, pos, mu):
    """O(N^2) accel with bodies sharded over the "model" axis.

    pos (N, 3) and the result are sharded on rows; mu is sharded likewise.
    Inside each shard we all_gather the source positions/mus and compute the
    local receiver rows - no psum needed for a row decomposition.
    """

    def kernel(pos_l, mu_l):
        # pos_l: (N/D, 3) local rows; gather full sources
        pos_all = jax.lax.all_gather(pos_l, "model", tiled=True)   # (N, 3)
        mu_all = jax.lax.all_gather(mu_l, "model", tiled=True)     # (N,)
        d = pos_all[None, :, :] - pos_l[:, None, :]                # (N/D, N, 3)
        r2 = jnp.sum(d * d, axis=-1)
        # self-interaction mask via global row ids
        shard = jax.lax.axis_index("model")
        nl = pos_l.shape[0]
        rows = shard * nl + jnp.arange(nl)
        self_mask = rows[:, None] == jnp.arange(pos_all.shape[0])[None, :]
        r2 = jnp.where(self_mask, 1.0, r2)
        inv_r = jax.lax.rsqrt(r2)
        inv_r3 = jnp.where(self_mask, 0.0, inv_r * inv_r * inv_r)
        w = mu_all[None, :] * inv_r3
        return jnp.einsum("ij,ijc->ic", w, d)

    return jax.shard_map(
        kernel,
        mesh=mesh,
        in_specs=(P("model", None), P("model")),
        out_specs=P("model", None),
    )(pos, mu)


# ---------------------------------------------------------------------------
# Row-sharded magnitude-split force
# ---------------------------------------------------------------------------


def make_rowsharded_split_force(mesh: Mesh, mus, k: int = 16):
    """Row-sharded magnitude-split force (SURVEY.md 2.6's row
    decomposition applied to the ~1e-9 rung, ops/nbody_modes.py): returns
    ``(refresh, force)``.

    * ``refresh(pos)``: per-CHUNK strong-set refresh — all_gather the f64
      positions over "model", local top-k + exclusion table (with the
      GLOBAL self diagonal, so the masked sum needs no row ids).
      Returns (idx, mask) row-sharded over "model".
    * ``force(pos, idx, mask)``: per-STEP acceleration — all_gather +
      `pairwise_accel_split_rows` (rectangular masked f32 sum + the f64
      strong-set correction gathering from the full source set).

    Every piece is per-receiver-row independent with column order
    preserved, so the results match the unsharded `pairwise_accel_split`
    / `strong_pair_indices` / `strong_pair_mask` (test_sharding.py).
    """
    from ..ops.nbody_modes import (
        pairwise_accel_split_rows,
        strong_pair_indices_rows,
        strong_pair_mask_rows,
    )

    mu_dev = jnp.asarray(mus)

    def refresh_kernel(pos_l):
        pos_all = jax.lax.all_gather(pos_l, "model", axis=0, tiled=True)
        row0 = jax.lax.axis_index("model").astype(jnp.int32) * pos_l.shape[0]
        idx = strong_pair_indices_rows(pos_all, pos_l, mu_dev, row0, k=k)
        return idx, strong_pair_mask_rows(idx, pos_all.shape[0], row0)

    def force_kernel(pos_l, idx_l, mask_l):
        pos_all = jax.lax.all_gather(pos_l, "model", axis=0, tiled=True)
        return pairwise_accel_split_rows(pos_all, pos_l, mu_dev, idx_l, mask_l)

    row = P("model", None)
    refresh = jax.jit(jax.shard_map(
        refresh_kernel, mesh=mesh,
        in_specs=(row,), out_specs=(row, row),
    ))
    force = jax.jit(jax.shard_map(
        force_kernel, mesh=mesh,
        in_specs=(row, row, row), out_specs=row,
    ))
    return refresh, force


def carry_sharding(mesh: Mesh, ensemble: bool) -> ELM2Carry:
    """PartitionSpecs for an ELM2Carry: bodies on "model", ensembles on "data"."""
    lead = ("data",) if ensemble else ()

    def sh(*spec):
        return NamedSharding(mesh, P(*lead, *spec))

    return ELM2Carry(
        t=NamedSharding(mesh, P(*lead)),
        ys=sh(None, "model", None),
        ddys=sh(None, "model", None),
        dy=sh("model", None),
    )


def _ensemble_accel(mus):
    """Per-member force (the ensemble step vmaps it)."""
    mu_dev = jnp.asarray(mus)
    return lambda t, y: nbody.pairwise_accel(y, mu_dev)


def make_sharded_ensemble_step(mesh: Mesh, tab, mus, h):
    """One QT12 step for an (E, ...) ensemble, sharded (E->data, N->model).

    Returns a jitted step with explicit in/out shardings; XLA GSPMD inserts
    the all-gather for the pair interaction over the "model" axis and keeps
    the ensemble axis fully parallel.
    """
    accel = _ensemble_accel(mus)

    def step(carry: ELM2Carry) -> ELM2Carry:
        return jax.vmap(lambda c: elm2_step(tab, accel, h, c))(carry)

    sh = carry_sharding(mesh, ensemble=True)
    return jax.jit(step, in_shardings=(sh,), out_shardings=sh)


def make_sharded_ensemble_scan(mesh: Mesh, tab, mus, h, n_steps: int):
    """`n_steps` QT12 ensemble steps in ONE device program (scan inside
    jit): one dispatch per chunk instead of per step."""
    accel = _ensemble_accel(mus)

    def run(carry: ELM2Carry) -> ELM2Carry:
        def body(c, _):
            return jax.vmap(lambda cc: elm2_step(tab, accel, h, cc))(c), None

        c, _ = jax.lax.scan(body, carry, None, length=n_steps)
        return c

    sh = carry_sharding(mesh, ensemble=True)
    return jax.jit(run, in_shardings=(sh,), out_shardings=sh)


def init_ensemble_carry(mesh: Mesh, tab, mus, t0, pos, vel, h) -> ELM2Carry:
    """Startup for an (E, N, 3) ensemble; runs the starter vmapped."""
    accel = _ensemble_accel(mus)

    def init_one(p, v):
        return elm2_init(tab, accel, t0, p, v, h)

    carry = jax.vmap(init_one)(jnp.asarray(pos), jnp.asarray(vel))
    sh = carry_sharding(mesh, ensemble=True)
    return jax.device_put(carry, sh)


# ---------------------------------------------------------------------------
# Sharded fleet propagation (ships data-parallel over the mesh)
# ---------------------------------------------------------------------------


def make_sharded_fleet_propagator(mesh: Mesh, method: str, params, max_knots: int):
    """Batched spacecraft propagation with ships sharded over axis "data".

    The packed ephemeris (the celestial context every ship reads) is
    REPLICATED; per-ship inputs/outputs are sharded on the leading batch
    axis.  GSPMD keeps each shard's vmapped while_loops fully local — no
    collectives in the hot loop, the canonical data-parallel serving shape.
    Returns (fn, place) where place(packed, tl, t0, p0, v0, end) device_puts
    the operands with the right shardings.
    """
    from ..integrators.methods import get as get_method
    from ..spacecraft import propagate_batch

    tab = get_method(method)
    repl = NamedSharding(mesh, P())
    batch1 = NamedSharding(mesh, P("data"))
    batch2 = NamedSharding(mesh, P("data", None))

    def _tl_sharding(tl):
        return type(tl)(
            starts=batch2, ends=batch2, accels=NamedSharding(mesh, P("data", None, None)),
            frame_kind=batch2, frame_body=batch2,
        )

    def place(packed, tl, t0s, p0s, v0s, ends):
        packed = jax.device_put(packed, jax.tree_util.tree_map(lambda _: repl, packed))
        tl = jax.device_put(tl, _tl_sharding(tl))
        return (
            packed,
            tl,
            jax.device_put(t0s, batch1),
            jax.device_put(p0s, batch2),
            jax.device_put(v0s, batch2),
            jax.device_put(ends, batch1),
        )

    @jax.jit
    def fn(packed, tl, t0s, p0s, v0s, ends):
        return propagate_batch(
            tab, packed, tl, t0s, p0s, v0s, ends, params, max_knots=max_knots
        )

    return fn, place


# ---------------------------------------------------------------------------
# Single-device ensemble stepping with the ensemble axis inside the carry
# ---------------------------------------------------------------------------
#
# elm2_step is shape-generic (its weighted sums reduce the leading ORDER
# axis and everything else is elementwise), so the carry simply keeps the
# ensemble axis inside: ys/ddys are (ORDER, E, N, 3), dy is (E, N, 3), one
# shared t; only the force is vmapped over members.


def _fused_ensemble_accel(mus):
    mu_dev = jnp.asarray(mus)
    return lambda t, y: jax.vmap(lambda yy: nbody.pairwise_accel(yy, mu_dev))(y)


def init_fused_ensemble_carry(tab, mus, t0, pos, vel, h) -> ELM2Carry:
    """Startup for the fused layout: pos/vel (E, N, 3) -> ys (ORDER, E, N, 3)."""
    accel = _fused_ensemble_accel(mus)
    return elm2_init(tab, accel, t0, jnp.asarray(pos), jnp.asarray(vel), h)


def make_fused_ensemble_scan(tab, mus, h, n_steps: int):
    """`n_steps` QT12 steps of the whole ensemble per device program.

    Velocity is deferred out of the scan (Newtonian forces never read it)
    and reconstructed once per program - same carry, less per-step work.
    """
    accel = _fused_ensemble_accel(mus)

    @jax.jit
    def run(carry: ELM2Carry) -> ELM2Carry:
        def body(c, _):
            return elm2_step(tab, accel, h, c, with_velocity=False), None

        c, _ = jax.lax.scan(body, carry, None, length=n_steps)
        return c._replace(dy=elm2_velocity(tab, c, h))

    return run

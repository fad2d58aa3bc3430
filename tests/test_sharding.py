"""Sharded kernels on the virtual 8-device CPU mesh."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from ephemeris_explorer_tpu.integrators import get
from ephemeris_explorer_tpu.ops import nbody
from ephemeris_explorer_tpu.parallel import sharding as sh

pytestmark = pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 devices")


def test_rowsharded_accel_matches():
    mesh = sh.make_mesh(data=1, model=8)
    rng = np.random.default_rng(0)
    n = 64
    pos = jnp.asarray(rng.normal(size=(n, 3)) * 1e6)
    mu = jnp.asarray(rng.uniform(1e3, 1e5, n))
    p = jax.device_put(pos, jax.NamedSharding(mesh, jax.P("model", None)))
    m = jax.device_put(mu, jax.NamedSharding(mesh, jax.P("model")))
    out = sh.pairwise_accel_rowsharded(mesh, p, m)
    ref = nbody.pairwise_accel(pos, mu)
    np.testing.assert_allclose(np.asarray(out), np.asarray(ref), rtol=1e-12)


def test_sharded_ensemble_step_matches_unsharded():
    mesh = sh.make_mesh(data=2, model=4)
    tab = get("QuinlanTremaine12")
    rng = np.random.default_rng(1)
    e, n = 4, 32
    pos = rng.normal(size=(e, n, 3)) * 1e6
    vel = rng.normal(size=(e, n, 3))
    mu = rng.uniform(1e3, 1e5, n)
    h = 600.0

    carry = sh.init_ensemble_carry(mesh, tab, mu, 0.0, pos, vel, h)
    step = sh.make_sharded_ensemble_step(mesh, tab, mu, h)
    out = step(carry)

    # unsharded reference
    from ephemeris_explorer_tpu.integrators.multistep import elm2_init, elm2_step

    mu_j = jnp.asarray(mu)
    accel = lambda t, y: nbody.pairwise_accel(y, mu_j)
    ref = jax.vmap(
        lambda p, v: elm2_step(tab, accel, h, elm2_init(tab, accel, 0.0, p, v, h))
    )(jnp.asarray(pos), jnp.asarray(vel))
    np.testing.assert_allclose(np.asarray(out.ys[0]), np.asarray(ref.ys[0]), rtol=1e-12)
    np.testing.assert_allclose(np.asarray(out.dy), np.asarray(ref.dy), rtol=1e-10)


def test_sharded_fleet_matches_unsharded():
    """Ships sharded over "data" (replicated context) produce the same
    trajectories as the unsharded vmapped driver."""
    from pathlib import Path

    from ephemeris_explorer_tpu import Duration, Epoch
    from ephemeris_explorer_tpu.ephemeris import generate_ephemeris
    from ephemeris_explorer_tpu.integrators.adaptive import AdaptiveParams
    from ephemeris_explorer_tpu.io.scene import ShipBurn, load_scene
    from ephemeris_explorer_tpu.spacecraft import (
        build_timeline,
        propagate_batch,
        stack_timelines,
    )
    from ephemeris_explorer_tpu.integrators.methods import get as get_method

    systems = Path(__file__).resolve().parent.parent / "systems"
    sc = load_scene(systems / "sun_earth_moon_2433282.5")
    eph = generate_ephemeris(sc.state, sc.settings, Duration.from_days(40.0))
    packed = eph.pack()
    t0 = sc.state.epoch.as_offset_seconds()
    base = sc.ships[0]

    n_ships = 4
    tls, p0s, v0s = [], [], []
    for k in range(n_ships):
        burns = [
            ShipBurn(
                start=Epoch.from_offset_seconds(t0 + 3600.0 + 60.0 * k),
                duration=Duration.from_seconds(60.0),
                acceleration=np.array([1e-3, 0.0, 0.0]),
                reference="Earth",
            )
        ]
        tls.append(build_timeline(burns, {"Earth": 1}))
        p0s.append(base.position + np.array([10.0 * k, 0.0, 0.0]))
        v0s.append(base.velocity)
    tl = stack_timelines(tls)
    t0s = jnp.full((n_ships,), t0 + 60.0)
    ends = jnp.full((n_ships,), t0 + 7200.0)
    p0s = jnp.asarray(np.stack(p0s))
    v0s = jnp.asarray(np.stack(v0s))
    params = AdaptiveParams(h_init=60.0, tol_pos=1e-3, tol_vel=1e-3, n_max=10_000)

    mesh = sh.make_mesh(data=4, model=2)
    fn, place = sh.make_sharded_fleet_propagator(mesh, "Verner87", params, max_knots=256)
    res = fn(*place(packed, tl, t0s, p0s, v0s, ends))

    ref = propagate_batch(
        get_method("Verner87"), packed, tl, t0s, p0s, v0s, ends, params, max_knots=256
    )
    np.testing.assert_array_equal(np.asarray(res.count), np.asarray(ref.count))
    np.testing.assert_allclose(
        np.asarray(res.pos), np.asarray(ref.pos), rtol=0, atol=1e-9
    )


def test_fused_ensemble_scan_matches_per_member():
    """The single-device ensemble scan (ensemble axis inside the carry,
    velocity deferred) equals the per-member scan with per-step velocity."""
    from ephemeris_explorer_tpu.integrators.multistep import elm2_init, elm2_step

    e, n = 3, 16
    rng = np.random.default_rng(9)
    pos = rng.normal(size=(e, n, 3)) * 1.0e6
    vel = rng.normal(size=(e, n, 3)) * 1.0
    mu = rng.uniform(1.0e3, 1.0e5, size=n)
    tab = get("QuinlanTremaine12")
    h = 600.0
    steps = 20

    carry0 = sh.init_fused_ensemble_carry(tab, mu, 0.0, pos, vel, h)
    out = sh.make_fused_ensemble_scan(tab, mu, h, steps)(carry0)

    mu_j = jnp.asarray(mu)
    accel = lambda t, y: nbody.pairwise_accel(y, mu_j)  # noqa: E731
    for k in range(e):
        c = elm2_init(tab, accel, 0.0, jnp.asarray(pos[k]), jnp.asarray(vel[k]), h)
        for _ in range(steps):
            c = elm2_step(tab, accel, h, c)
        np.testing.assert_allclose(
            np.asarray(out.ys[0, k]), np.asarray(c.ys[0]), rtol=1e-13
        )
        np.testing.assert_allclose(
            np.asarray(out.dy[k]), np.asarray(c.dy), rtol=1e-9,
            atol=np.abs(np.asarray(c.dy)).max() * 1e-12,
        )


MESHES = [(1, 8), (2, 4), (4, 2), (8, 1)]


@pytest.mark.parametrize("data,model", MESHES, ids=lambda v: str(v))
def test_rowsharded_accel_mesh_shapes(data, model):
    """The shard_map row decomposition over every factorisation of the
    8-device mesh (model = 1 is the degenerate one-shard case)."""
    mesh = sh.make_mesh(data=data, model=model)
    rng = np.random.default_rng(model)
    n = 64
    pos = jnp.asarray(rng.normal(size=(n, 3)) * 1e6)
    mu = jnp.asarray(rng.uniform(1e3, 1e5, n))
    p = jax.device_put(pos, jax.NamedSharding(mesh, jax.P("model", None)))
    m = jax.device_put(mu, jax.NamedSharding(mesh, jax.P("model")))
    out = np.asarray(sh.pairwise_accel_rowsharded(mesh, p, m))
    ref = np.asarray(nbody.pairwise_accel(pos, mu))
    # shards sum in their own order: rounding relative to the field scale
    np.testing.assert_allclose(out, ref, rtol=1e-12, atol=np.abs(ref).max() * 1e-14)


@pytest.mark.parametrize("data,model", MESHES, ids=lambda v: str(v))
def test_sharded_ensemble_step_mesh_shapes(data, model):
    """GSPMD ensemble step (E over "data", N over "model") on every mesh
    factorisation equals the unsharded vmapped step."""
    from ephemeris_explorer_tpu.integrators.multistep import elm2_init, elm2_step

    mesh = sh.make_mesh(data=data, model=model)
    tab = get("QuinlanTremaine12")
    rng = np.random.default_rng(data)
    e, n = data, 8 * model
    pos = rng.normal(size=(e, n, 3)) * 1e6
    vel = rng.normal(size=(e, n, 3))
    mu = rng.uniform(1e3, 1e5, n)
    h = 600.0

    carry = sh.init_ensemble_carry(mesh, tab, mu, 0.0, pos, vel, h)
    out = sh.make_sharded_ensemble_step(mesh, tab, mu, h)(carry)

    mu_j = jnp.asarray(mu)
    accel = lambda t, y: nbody.pairwise_accel(y, mu_j)  # noqa: E731
    ref = jax.vmap(
        lambda p, v: elm2_step(tab, accel, h, elm2_init(tab, accel, 0.0, p, v, h))
    )(jnp.asarray(pos), jnp.asarray(vel))
    np.testing.assert_allclose(np.asarray(out.ys[0]), np.asarray(ref.ys[0]), rtol=1e-12)
    np.testing.assert_allclose(np.asarray(out.dy), np.asarray(ref.dy), rtol=1e-10)


def test_rowsharded_split_force_matches():
    """The magnitude-split mode row-sharded over 8 devices: refresh (top-k
    + exclusion table with the GLOBAL diagonal) must be BITWISE vs
    unsharded (integer outputs), and the per-step force (rectangular
    masked f32 sum + f64 strong-set correction gathering from the
    all_gathered source set) within 1e-13 rowwise (each program fuses
    its own reduction order)."""
    from ephemeris_explorer_tpu.ops.nbody_modes import (
        pairwise_accel_split, strong_pair_indices, strong_pair_mask,
    )

    mesh = sh.make_mesh(data=1, model=8)
    rng = np.random.default_rng(23)
    n, k = 64, 6
    # two clusters: close pairs AND distant geometry in the strong sets
    pos = np.concatenate([
        rng.normal(size=(n // 2, 3)) * 1e6,
        rng.normal(size=(n // 2, 3)) * 1e6 + 3e7,
    ])
    mu = rng.uniform(1e3, 1e5, n)

    pos_j = jnp.asarray(pos)
    mu_j = jnp.asarray(mu)
    idx_ref = strong_pair_indices(pos_j, mu_j, k=k)
    mask_ref = strong_pair_mask(idx_ref, n)
    a_ref = pairwise_accel_split(pos_j, mu_j, idx_ref, mask_ref)

    refresh, force = sh.make_rowsharded_split_force(mesh, mu, k=k)
    p = jax.device_put(pos_j, jax.NamedSharding(mesh, jax.P("model", None)))
    def rowwise_close(a, ref):
        a, ref = np.asarray(a), np.asarray(ref)
        rel = np.linalg.norm(a - ref, axis=1) / np.linalg.norm(ref, axis=1)
        assert rel.max() < 1e-13, rel.max()

    idx, mask = refresh(p)
    np.testing.assert_array_equal(np.asarray(idx), np.asarray(idx_ref))
    np.testing.assert_array_equal(np.asarray(mask), np.asarray(mask_ref))
    rowwise_close(force(p, idx, mask), a_ref)

    # a second epoch: refreshed sets keep matching after the state moves
    p2 = p + jnp.asarray(rng.normal(size=(n, 3)) * 1e4)
    idx2, mask2 = refresh(p2)
    p2_one = jnp.asarray(np.asarray(p2))  # unsharded reference operand
    idx2_ref = strong_pair_indices(p2_one, mu_j, k=k)
    np.testing.assert_array_equal(np.asarray(idx2), np.asarray(idx2_ref))
    a2_ref = pairwise_accel_split(p2_one, mu_j, idx2_ref, strong_pair_mask(idx2_ref, n))
    rowwise_close(force(p2, idx2, mask2), a2_ref)

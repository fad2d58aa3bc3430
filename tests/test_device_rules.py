"""Device-facing rules that hold on every host: the force kernel choice per
lowering platform, the Pallas force in interpret mode, exact f64 -> f32
limb splits, the compile-cache location, ``precision="auto"``, and the
card smoke script's refusal to run without a GPU."""

import json
import os
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import ephemeris_explorer_tpu
from ephemeris_explorer_tpu.ops import eft, nbody, pallas_nbody

REPO = Path(__file__).resolve().parent.parent


def _cloud(n, seed=0):
    rng = np.random.default_rng(seed)
    return rng.normal(size=(n, 3)) * 1.0e6, rng.uniform(1.0e3, 1.0e5, size=n)


# ---------------------------------------------------------------------------
# the Pallas force (Triton route) run by the Pallas interpreter
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n", [1, 2, 7, 40, 130])
@pytest.mark.parametrize("tiles", [(16, 32), (8, 64), (32, 32)], ids=str)
def test_pallas_force_interpret_matches_xla(n, tiles):
    """Padding to the tile, masking of padded sources and of the self
    pair, and the in-register sums give XLA's force to f64 rounding."""
    pos, mu = _cloud(n, seed=n)
    ref = np.asarray(nbody.pairwise_accel(jnp.asarray(pos), jnp.asarray(mu)))
    got = np.asarray(pallas_nbody.pairwise_accel(
        jnp.asarray(pos), jnp.asarray(mu),
        block_rows=tiles[0], block_cols=tiles[1], interpret=True,
    ))
    assert got.shape == (n, 3) and got.dtype == np.float64
    scale = max(np.abs(ref).max(), 1e-300)
    assert np.abs(got - ref).max() <= 1e-14 * scale


@pytest.mark.gpu
@pytest.mark.parametrize("n", [32, 4096])
def test_pallas_force_compiled_on_gpu(gpu, n):
    """The kernel as compiled for the card against XLA's force."""
    pos, mu = _cloud(n, seed=3)
    with jax.default_device(gpu):
        ref = np.asarray(jax.jit(nbody.pairwise_accel)(jnp.asarray(pos), jnp.asarray(mu)))
        got = np.asarray(pallas_nbody.pairwise_accel(jnp.asarray(pos), jnp.asarray(mu)))
    assert np.abs(got - ref).max() <= 1e-13 * np.abs(ref).max()


@pytest.mark.parametrize(
    "n,platform,pallas",
    [
        (64, "cpu", False),
        (64, "cuda", False),
        (nbody.PALLAS_MIN_BODIES, "cpu", False),
        (nbody.PALLAS_MIN_BODIES, "cuda", True),
    ],
)
def test_force_kernel_choice_per_platform(n, platform, pallas):
    """pairwise_accel_auto lowers to the Triton kernel only for a GPU and
    only from PALLAS_MIN_BODIES bodies on (lowered here, never run)."""
    args = (
        jax.ShapeDtypeStruct((n, 3), jnp.float64),
        jax.ShapeDtypeStruct((n,), jnp.float64),
    )
    text = (
        jax.jit(nbody.pairwise_accel_auto)
        .trace(*args)
        .lower(lowering_platforms=(platform,))
        .as_text()
    )
    assert ("triton" in text) == pallas


def test_force_auto_below_threshold_is_xla_bitwise():
    pos, mu = _cloud(50)
    a = jax.jit(nbody.pairwise_accel_auto)(jnp.asarray(pos), jnp.asarray(mu))
    b = jax.jit(nbody.pairwise_accel)(jnp.asarray(pos), jnp.asarray(mu))
    assert np.array_equal(np.asarray(a), np.asarray(b))


# ---------------------------------------------------------------------------
# f64 -> f32 limb splits
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("k", [2, 3])
@pytest.mark.parametrize("scale", [1e-12, 1.0, 1e8, 4e9])
def test_f64_limbs_match_numpy_conversions(k, scale):
    """Each limb is numpy's f32 rounding of the remainder, so the jitted
    split reproduces the host split bit for bit (and three limbs sum back
    to x exactly)."""
    rng = np.random.default_rng(int(np.log2(scale) + 100) * k)
    x = rng.normal(size=4096) * scale
    got = jax.jit(lambda v: eft.f64_limbs(v, k))(jnp.asarray(x))
    r = x.copy()
    for limb in got[:-1]:
        want = r.astype(np.float32)
        assert np.array_equal(np.asarray(limb), want)
        r = r - want.astype(np.float64)
    assert np.array_equal(np.asarray(got[-1]), r.astype(np.float32))
    if k == 3:
        total = sum(np.asarray(l, np.float64) for l in got[::-1])
        assert np.array_equal(total, x)


def test_f64_limbs_avoid_convert_round_trip():
    """The split must not be a f64 -> f32 -> f64 convert pair: XLA:GPU
    folds such pairs (excess precision), which zeroes the low limbs."""
    text = jax.jit(lambda v: eft.f64_limbs(v, 3)).lower(
        jax.ShapeDtypeStruct((8,), jnp.float64)
    ).as_text()
    assert "reduce_precision" in text


# ---------------------------------------------------------------------------
# compile cache, precision="auto"
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("env", [None, "elsewhere"])
def test_compile_cache_dir_rule(monkeypatch, env):
    if env is None:
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
        want = str(REPO / ".jax_cache")
    else:
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", env)
        want = None
    assert ephemeris_explorer_tpu.compile_cache_dir() == want


def test_compile_cache_dir_is_gitignored():
    assert ".jax_cache/" in (REPO / ".gitignore").read_text().split()


def test_compile_cache_config_on_import(tmp_path):
    """A fresh interpreter takes JAX_COMPILATION_CACHE_DIR from the
    environment untouched, or the checkout's path when it is unset."""
    code = (
        "import jax, ephemeris_explorer_tpu; "
        "print(jax.config.jax_compilation_cache_dir)"
    )
    for env_val, want in ((None, str(REPO / ".jax_cache")), (str(tmp_path), str(tmp_path))):
        env = {k: v for k, v in os.environ.items() if k != "JAX_COMPILATION_CACHE_DIR"}
        env["JAX_PLATFORMS"] = "cpu"
        if env_val:
            env["JAX_COMPILATION_CACHE_DIR"] = env_val
        out = subprocess.run(
            [sys.executable, "-c", code], env=env, cwd=REPO,
            capture_output=True, text=True, check=True,
        ).stdout.strip().splitlines()[-1]
        assert out == want


@pytest.mark.parametrize("scene", ["sun_earth_moon_2433282.5", "simple_solar_system_2433282.5"])
def test_auto_precision_is_native_f64(scene):
    from ephemeris_explorer_tpu.ephemeris import NBodyPropagator
    from ephemeris_explorer_tpu.io.scene import load_scene

    sc = load_scene(REPO / "systems" / scene)
    prop = NBodyPropagator(sc.state, sc.settings, precision="auto")
    assert prop.precision == "f64"


# ---------------------------------------------------------------------------
# chip_smoke.py
# ---------------------------------------------------------------------------


def _run_smoke(cwd, script):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.run(
        [sys.executable, str(script)], cwd=cwd, env=env,
        capture_output=True, text=True, timeout=300,
    )


def test_chip_smoke_refuses_without_gpu():
    r = _run_smoke(REPO, REPO / "chip_smoke.py")
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


def test_chip_smoke_refuses_outside_the_repo(tmp_path):
    script = tmp_path / "chip_smoke.py"
    script.write_text((REPO / "chip_smoke.py").read_text())
    r = _run_smoke(tmp_path, script)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


@pytest.mark.parametrize("count", [1, 4])
def test_chip_smoke_contract_line(count):
    sys.path.insert(0, str(REPO))
    import chip_smoke

    dev = SimpleNamespace(platform="gpu", device_kind="NVIDIA H100 80GB HBM3")
    line = chip_smoke.contract_line([dev] * count)
    assert "\n" not in line
    assert json.loads(line) == {
        "ok": True,
        "device": {"platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": count},
    }


def test_chip_smoke_eft_phase_fails_on_a_compiled_break(monkeypatch):
    """Phase f compares each transform as compiled with its per-op IEEE
    evaluation; a compiled version that loses the low part must fail the
    phase and name the transform."""
    sys.path.insert(0, str(REPO))
    import chip_smoke

    real = eft.split

    def split_broken_when_compiled(a):
        hi, lo = real(a)
        return hi, (lo * 0 if isinstance(a, jax.core.Tracer) else lo)

    monkeypatch.setattr(eft, "split", split_broken_when_compiled)
    with pytest.raises(AssertionError, match=r"split/float32"):
        chip_smoke.phase_eft(lambda *a, **k: None, n=1 << 12)


@pytest.mark.parametrize(
    "failing",
    ["phase_eft", "phase_kernels", "phase_large_n", "phase_session", "phase_fleet",
     "phase_accuracy"],
)
def test_chip_smoke_failed_phase_fails_the_run(monkeypatch, capsys, failing):
    """Any phase that fails ends the run without the contract line."""
    sys.path.insert(0, str(REPO))
    import chip_smoke

    dev = SimpleNamespace(platform="gpu", device_kind="NVIDIA H100 80GB HBM3")
    monkeypatch.setattr(jax, "devices", lambda *a: [dev])
    monkeypatch.setattr(chip_smoke, "card_line", lambda: "NVIDIA H100 80GB HBM3, 700.00 W")
    ran = []
    for name in ("phase_eft", "phase_kernels", "phase_large_n", "phase_session",
                 "phase_fleet", "phase_accuracy"):
        def phase(log, name=name):
            ran.append(name)
            chip_smoke.check(name != failing, f"{name} failed")
        monkeypatch.setattr(chip_smoke, name, phase)
    with pytest.raises(AssertionError, match=failing):
        chip_smoke.main([])
    assert ran[-1] == failing
    assert '"ok"' not in capsys.readouterr().out

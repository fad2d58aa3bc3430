#!/usr/bin/env python3
"""Fast-mode preview propagation: the opt-in f32 pair force.

Demonstrates the visualization-grade single-precision force
(:func:`ephemeris_explorer_tpu.ops.nbody_modes.pairwise_accel_f32`,
~1e-6 relative error) driving a leapfrog preview of a synthetic cluster,
and reports its drift against the production f64 force over the same
steps.

Run:  python examples/fast_preview.py [--bodies 1024] [--steps 200]
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import jax
import jax.numpy as jnp
import numpy as np


def main() -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--bodies", type=int, default=1024)
    p.add_argument("--steps", type=int, default=200)
    args = p.parse_args()

    from ephemeris_explorer_tpu.ops.nbody import pairwise_accel_auto
    from ephemeris_explorer_tpu.ops.nbody_modes import pairwise_accel_f32

    n = args.bodies
    rng = np.random.default_rng(0)
    pos = rng.normal(size=(n, 3)) * 1.0e6
    vel = rng.normal(size=(n, 3)) * 1.0
    mu = rng.uniform(1.0e3, 1.0e5, size=n)
    mu64 = jnp.asarray(mu)
    mu32 = mu64.astype(jnp.float32)
    h = 600.0

    @jax.jit
    def preview(p32, v32):
        def body(c, _):
            p, v = c
            a = pairwise_accel_f32(p, mu32)
            v = v + a * jnp.float32(h)
            p = p + v * jnp.float32(h)
            return (p, v), None

        return jax.lax.scan(body, (p32, v32), None, length=args.steps)[0]

    @jax.jit
    def reference(p64, v64):
        def body(c, _):
            p, v = c
            a = pairwise_accel_auto(p, mu64)
            v = v + a * h
            p = p + v * h
            return (p, v), None

        return jax.lax.scan(body, (p64, v64), None, length=args.steps)[0]

    p32 = jnp.asarray(pos).astype(jnp.float32)
    v32 = jnp.asarray(vel).astype(jnp.float32)
    t0 = time.perf_counter()
    pf, _ = preview(p32, v32)
    pf_np = np.asarray(pf)
    t_fast = time.perf_counter() - t0

    t0 = time.perf_counter()
    pr, _ = reference(jnp.asarray(pos), jnp.asarray(vel))
    pr_np = np.asarray(pr)
    t_ref = time.perf_counter() - t0

    drift = np.abs(pf_np.astype(np.float64) - pr_np).max()
    scale = np.abs(pr_np).max()
    print(f"preview  : {t_fast:6.2f} s (incl. compile)")
    print(f"reference: {t_ref:6.2f} s (incl. compile)")
    print(f"max drift after {args.steps} steps: {drift:.3e} km "
          f"({drift / scale:.2e} relative)")


if __name__ == "__main__":
    main()

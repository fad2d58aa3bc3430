"""Pallas (Triton route) pairwise gravity in native f64.

Same semantics as :func:`.nbody.pairwise_accel` (zero softening,
mu-weighted inverse cube), written as one GPU kernel: each program owns a
power-of-two tile of receiver rows, loops over source tiles inside the
block and keeps the three component sums in registers, so no (N, N)
intermediate reaches device memory.  f64 ``rsqrt`` lowers to libdevice's
``__nv_rsqrt`` on the Triton route.

Layout: positions as three (N,) component vectors, mu as (N,); N is padded
to a multiple of both tile sizes, and padded sources are masked out.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu


def _force_kernel(
    x_ref, y_ref, z_ref, mu_ref, ax_ref, ay_ref, az_ref,
    *, n: int, block_rows: int, block_cols: int,
):
    i0 = pl.program_id(0) * block_rows
    rows = i0 + jnp.arange(block_rows, dtype=jnp.int32)
    xi = x_ref[pl.ds(i0, block_rows)][:, None]
    yi = y_ref[pl.ds(i0, block_rows)][:, None]
    zi = z_ref[pl.ds(i0, block_rows)][:, None]

    def col_tile(k, acc):
        c0 = k * block_cols
        cols = c0 + jnp.arange(block_cols, dtype=jnp.int32)
        dx = x_ref[pl.ds(c0, block_cols)][None, :] - xi
        dy = y_ref[pl.ds(c0, block_cols)][None, :] - yi
        dz = z_ref[pl.ds(c0, block_cols)][None, :] - zi
        r2 = dx * dx + dy * dy + dz * dz
        keep = (cols[None, :] < n) & (cols[None, :] != rows[:, None])
        inv_r = jax.lax.rsqrt(jnp.where(keep, r2, 1.0))
        mu_j = mu_ref[pl.ds(c0, block_cols)][None, :]
        w = jnp.where(keep, mu_j * (inv_r * inv_r * inv_r), 0.0)
        return (
            acc[0] + jnp.sum(w * dx, axis=1),
            acc[1] + jnp.sum(w * dy, axis=1),
            acc[2] + jnp.sum(w * dz, axis=1),
        )

    zero = jnp.zeros((block_rows,), x_ref.dtype)
    n_tiles = x_ref.shape[0] // block_cols
    ax, ay, az = jax.lax.fori_loop(0, n_tiles, col_tile, (zero, zero, zero))
    ax_ref[...] = ax
    ay_ref[...] = ay
    az_ref[...] = az


@partial(
    jax.jit,
    static_argnames=("block_rows", "block_cols", "num_warps", "interpret"),
)
def pairwise_accel(
    pos, mu, block_rows: int = 16, block_cols: int = 256, num_warps: int = 4,
    interpret: bool = False,
):
    """(N, 3) f64 positions and (N,) mu in, (N, 3) f64 accelerations out.

    ``block_rows`` and ``block_cols`` must be powers of two (the Triton
    route's block rule); the defaults were the fastest of a sweep on an
    H100 at N=4096, where the kernel is used (PERF.md).  ``interpret=True`` runs the kernel
    on the CPU.
    """
    n = pos.shape[0]
    tile = max(block_rows, block_cols)
    n_pad = -(-n // tile) * tile
    p = jnp.pad(pos, ((0, n_pad - n), (0, 0)))
    m = jnp.pad(mu, (0, n_pad - n))
    vec = jax.ShapeDtypeStruct((n_pad,), pos.dtype)
    rows = pl.BlockSpec((block_rows,), lambda i: (i,))
    whole = pl.BlockSpec((n_pad,), lambda i: (0,))
    ax, ay, az = pl.pallas_call(
        partial(_force_kernel, n=n, block_rows=block_rows, block_cols=block_cols),
        grid=(n_pad // block_rows,),
        in_specs=[whole] * 4,
        out_specs=[rows] * 3,
        out_shape=[vec] * 3,
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=num_warps),
        interpret=interpret,
        name="pairwise_accel_f64",
    )(p[:, 0], p[:, 1], p[:, 2], m)
    return jnp.stack([ax, ay, az], axis=-1)[:n]

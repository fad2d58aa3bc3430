"""Batched least-squares polynomial fitting and Horner evaluation.

The reference fits, per body, a degree-d polynomial over 9 position samples at
normalised times tau = i/8 (forward) or 1 - i/8 (backward) using an
orthogonal-polynomial least-squares routine
(ephemeris_explorer/src/dynamics/celestial.rs:19-136, poly_it-derived).

Because the sample abscissae are FIXED, the least-squares fit is a linear map
from the 9 samples to the d+1 coefficients.  We precompute that (d+1) x 9
matrix once (f64 pseudo-inverse of the Vandermonde matrix) and batch the fit
as an einsum over bodies x segments - one batched matmul instead of the
reference's per-segment iterative algorithm.  Both solve the identical
least-squares problem; results agree to f64 rounding.

Coefficient layout: ascending powers, padded with zeros to 9 entries
(degree <= 8 always, since degree is capped at sample_count-1 = 8,
celestial.rs:46).
"""

from __future__ import annotations

from functools import lru_cache

import jax.numpy as jnp
import numpy as np

DIV = 8
N_SAMPLES = DIV + 1
MAX_COEFFS = N_SAMPLES  # degree <= 8


def sample_taus(backward: bool = False) -> np.ndarray:
    """Normalised sample times (nbody.rs:411-443): i/8 fwd, 1 - i/8 bwd."""
    t = np.arange(N_SAMPLES, dtype=np.float64) / DIV
    return 1.0 - t if backward else t


@lru_cache(maxsize=None)
def fit_matrix(degree: int, backward: bool = False) -> np.ndarray:
    """(MAX_COEFFS, 9) map from 9 samples to padded polynomial coefficients."""
    degree = min(degree, N_SAMPLES - 1)
    ts = sample_taus(backward)
    v = np.vander(ts, degree + 1, increasing=True)  # (9, d+1)
    m, *_ = np.linalg.lstsq(v, np.eye(N_SAMPLES), rcond=None)  # (d+1, 9)
    out = np.zeros((MAX_COEFFS, N_SAMPLES), dtype=np.float64)
    out[: degree + 1] = m
    return out


def fit_matrices(degrees, backward: bool = False) -> np.ndarray:
    """Stack per-body fit matrices: (N, MAX_COEFFS, 9)."""
    return np.stack([fit_matrix(int(d), backward) for d in degrees])


def fit_segments(samples, m) -> jnp.ndarray:
    """Batched fit: samples (..., 9, 3), m (MAX_COEFFS, 9) -> (..., 9, 3) coeffs."""
    return jnp.einsum("dk,...kc->...dc", jnp.asarray(m), samples)


def horner(coeffs, tau):
    """Evaluate sum_d coeffs[..., d, :] tau^d  (trajectory.rs:398-410).

    coeffs: (..., C, 3); tau: broadcastable to (...,).  Returns (..., 3).
    """
    tau = jnp.asarray(tau)[..., None]
    out = coeffs[..., -1, :] * jnp.zeros_like(tau)  # zeros with right shape/dtype
    for d in range(coeffs.shape[-2] - 1, -1, -1):
        out = out * tau + coeffs[..., d, :]
    return out


def horner_and_deriv(coeffs, tau):
    """Simultaneous value + d/dtau evaluation (trajectory.rs:369-385).

    Returns (value, derivative) each (..., 3).  The derivative is with respect
    to tau; divide by the segment interval in seconds for a time derivative
    (trajectory.rs:466-469).
    """
    tau = jnp.asarray(tau)[..., None]
    c = coeffs.shape[-2]
    last = coeffs[..., c - 1, :]
    val = last
    der = last
    for d in range(c - 2, 0, -1):
        val = val * tau + coeffs[..., d, :]
        der = der * tau + val
    val = val * tau + coeffs[..., 0, :]
    return val, der

"""Batched Kalman filtering.

The reference runs one ``SharedKalmanFilter<N,M>::get_new_state`` per matched feature
(src/tracking/kalman_filter.hpp:46-106).  Here the same closed-form step is a pure
function over arrays; all features of a type update in ONE batched call (`vmap`/leading
axes), which turns the per-feature loop into array code instead of scalar code.

Numerical notes (f32 discipline, SURVEY.md §7 risk list):
* the innovation solve uses ``jnp.linalg.solve`` with a Tikhonov fallback instead of the
  reference's determinant-gated pseudo-inverse (kalman_filter.hpp:70-78);
* the covariance update is symmetrized exactly like the reference's
  ``selfadjointView`` trick (kalman_filter.hpp:88-91).
"""

from __future__ import annotations

from functools import partial

import jax.numpy as jnp

from ..pose.linalg6 import solve_spd


def kalman_step(state, cov, measurement, meas_cov,
                dynamics=None, output=None, process_noise=None):
    """One predict+update step.  Shapes: state [..., N], cov [..., N, N],
    measurement [..., M], meas_cov [..., M, M]; dynamics/output/process_noise are
    broadcastable matrices (defaults: identity dynamics/output, zero process noise).

    Returns (new_state, new_cov).  Parity: SharedKalmanFilter::get_new_state
    (kalman_filter.hpp:46-106)."""
    n = state.shape[-1]
    m = measurement.shape[-1]
    dt = state.dtype
    eye_n = jnp.eye(n, dtype=dt)

    if dynamics is None:
        dynamics = eye_n
    if output is None:
        output = jnp.eye(m, n, dtype=dt)
    if process_noise is None:
        process_noise = jnp.zeros((n, n), dtype=dt)

    # predict
    x_pred = jnp.einsum("...ij,...j->...i", dynamics, state)
    p_pred = jnp.einsum("...ij,...jk,...lk->...il", dynamics, cov, dynamics) + process_noise

    # innovation covariance S = H P H^T + R
    s = jnp.einsum("...ij,...jk,...lk->...il", output, p_pred, output) + meas_cov
    s = 0.5 * (s + jnp.swapaxes(s, -1, -2))

    # gain K = P H^T S^-1  (solve on S^T == S)
    pht = jnp.einsum("...ij,...kj->...ik", p_pred, output)
    # Tikhonov-regularized solve replaces the reference's pseudo-inverse fallback;
    # S is SPD so the unrolled Cholesky avoids pivoted LU loops
    s_reg = s + 1e-9 * jnp.eye(m, dtype=dt)
    gain = jnp.swapaxes(
        solve_spd(s_reg, jnp.swapaxes(pht, -1, -2)), -1, -2
    )

    innovation = measurement - jnp.einsum("...ij,...j->...i", output, x_pred)
    new_state = x_pred + jnp.einsum("...ij,...j->...i", gain, innovation)

    kh = jnp.einsum("...ij,...jk->...ik", gain, output)
    new_cov = jnp.einsum("...ij,...jk->...ik", jnp.eye(n, dtype=dt) - kh, p_pred)
    new_cov = 0.5 * (new_cov + jnp.swapaxes(new_cov, -1, -2))
    return new_state, new_cov


# Specializations matching the reference's per-feature-type filters ---------------

#: process noise for 3D map points (reference: point_with_tracking.cpp:69-83)
POINT_PROCESS_NOISE = 1e-3
#: process noise for plane states (reference: plane_with_tracking.cpp:81-95)
PLANE_PROCESS_NOISE = 1e-6


def track_points(positions, covariances, observations, obs_covariances,
                 process_noise: float = POINT_PROCESS_NOISE):
    """Batched 3x3 static-identity KF update of world points (reference:
    tracking::Point::track, point_with_tracking.cpp:32-67).

    Returns (new_positions, new_covariances, score, is_moving) where score is the
    displacement norm and is_moving flags motion above the observation sigma."""
    dt = positions.dtype
    pn = process_noise * jnp.eye(3, dtype=dt)
    new_pos, new_cov = kalman_step(positions, covariances, observations,
                                   obs_covariances, process_noise=pn)
    score = jnp.linalg.norm(positions - new_pos, axis=-1)
    obs_sigma = jnp.sqrt(jnp.abs(
        jnp.diagonal(obs_covariances, axis1=-2, axis2=-1)))
    is_moving = jnp.any(jnp.abs(positions - observations) > obs_sigma, axis=-1)
    return new_pos, new_cov, score, is_moving


def track_planes(plane_states, covariances, observations, obs_covariances,
                 process_noise: float = PLANE_PROCESS_NOISE):
    """Batched 4x4 KF update on hessian plane parameters (reference:
    tracking::Plane::track, plane_with_tracking.cpp:16-95).  Normal renormalization is
    left to the caller (map_primitive keeps hessian form normalized)."""
    dt = plane_states.dtype
    pn = process_noise * jnp.eye(4, dtype=dt)
    return kalman_step(plane_states, covariances, observations, obs_covariances,
                       process_noise=pn)


@partial(jnp.vectorize, signature="(n),(n,n),(m),(m,m)->(n),(n,n)")
def kalman_step_vectorized(state, cov, measurement, meas_cov):
    """gufunc wrapper of :func:`kalman_step` with default matrices, for odd batch
    shapes."""
    return kalman_step(state, cov, measurement, meas_cov)

"""Residual kernels for pose optimization.

Replaces the reference's virtual ``IOptimizationFeature::get_distance`` dispatch
(matches_containers.hpp:152-161 and per-type impls in
src/map_management/map_features/*.cpp) with three batched residual blocks assembled
into one stacked vector.  Jacobians come from ``jax.jacfwd`` over these pure functions
— exact derivatives, replacing the reference's ``Eigen::NumericalDiff``
(levenberg_marquardt_functors.hpp:90-92), a large accuracy+speed win flagged in
SURVEY.md §7.
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp

from ..config import CameraIntrinsics, RansacConfig
from ..geometry import inverse_depth as idp
from ..geometry import lines, pinhole, planes, se3
from .features import (LINE_ALPHA, PLANE_ALPHA, POINT2D_ALPHA, POINT_ALPHA,
                       MatchedFeatures)

#: residual magnitude assigned to invalid projections (reference uses
#: double::max, point_coordinates.cpp:257; we keep it finite for f32 cost sums)
BIG_RESIDUAL = 1.0e4


class PreparedFeatures(NamedTuple):
    """Pose-independent precomputation of a MatchedFeatures set.

    The inverse-depth features' +-3 sigma world-space segment endpoints
    (inverse_depth_coordinates.cpp:142-154) depend only on the feature state, not
    on the pose being optimized, so they are resolved ONCE per LM solve; every LM
    iteration then projects a single stacked [NP + 2*N2, 3] world-point array with
    one matmul instead of re-deriving the bearing trigonometry.  This keeps the
    sequential LM chain — the latency-critical path of the frame — to a minimal op
    count."""

    pts_world: jnp.ndarray       # [NP + 2*N2 + 2*NL, 3]: points, inverse-depth
                                 # far/near endpoints, line e0/e1 endpoints
    point_obs_uv: jnp.ndarray
    point_mask: jnp.ndarray
    point2d_obs_uv: jnp.ndarray
    point2d_mask: jnp.ndarray
    plane_world: jnp.ndarray
    plane_cam: jnp.ndarray
    plane_mask: jnp.ndarray
    line_obs_p0: jnp.ndarray
    line_obs_p1: jnp.ndarray
    line_mask: jnp.ndarray


def prepare_features(feats: MatchedFeatures, cam: CameraIntrinsics = None
                     ) -> PreparedFeatures:
    """Resolve every pose-independent quantity of the residual evaluation."""
    rho_std = feats.point2d_state_std[..., idp.INVERSE_DEPTH_IDX]
    far, near = idp.estimation_bounds(feats.point2d_state, rho_std)
    pts = jnp.concatenate([feats.point_world, far, near,
                           feats.line_world[..., :3],
                           feats.line_world[..., 3:]], axis=-2)
    return PreparedFeatures(
        pts_world=pts,
        point_obs_uv=feats.point_obs_uv, point_mask=feats.point_mask,
        point2d_obs_uv=feats.point2d_obs_uv, point2d_mask=feats.point2d_mask,
        plane_world=feats.plane_world, plane_cam=feats.plane_cam,
        plane_mask=feats.plane_mask,
        line_obs_p0=feats.line_obs_p0, line_obs_p1=feats.line_obs_p1,
        line_mask=feats.line_mask)


def _line_point_distances(l0, l1, q0, q1, ok, big):
    """Perpendicular distances of the two OBSERVED segment endpoints (q0, q1) to
    the infinite 2D line through the projected map segment (l0, l1) — the
    point-to-line residual of the reference's planned line design
    (README.md:134-136; distance machinery mirrored from line.hpp:77-171).
    Returns [NL, 2]."""
    d = l1 - l0
    nrm = jnp.sqrt(jnp.maximum(jnp.sum(d * d, axis=-1), 1e-12))
    n = jnp.stack([-d[..., 1], d[..., 0]], axis=-1) / nrm[..., None]
    r0 = jnp.sum((q0 - l0) * n, axis=-1)
    r1 = jnp.sum((q1 - l0) * n, axis=-1)
    r = jnp.stack([r0, r1], axis=-1)
    degenerate = (jnp.sum(d * d, axis=-1) < 1e-9)[..., None]
    r = jnp.where(degenerate, big, r)
    return jnp.where(ok[..., None], r, big)


def residual_vector_prepared(coeffs, prep: PreparedFeatures, cam: CameraIntrinsics):
    """Stacked residual vector from a prepared feature set (see
    :func:`residual_vector` for semantics)."""
    quat, position = se3.coefficients_to_pose(coeffs)
    w2c = se3.world_to_camera(quat, position)
    scr, ok = pinhole.world_to_screen(prep.pts_world, w2c, cam)

    np_ = prep.point_mask.shape[-1]
    n2 = prep.point2d_mask.shape[-1]

    dp = jnp.where(ok[:np_, None], prep.point_obs_uv - scr[:np_, :2], BIG_RESIDUAL)
    rp = jnp.where(prep.point_mask[..., None], dp, 0.0) * (POINT_ALPHA / 2.0)

    p0 = scr[np_:np_ + n2, :2]
    p1 = scr[np_ + n2:np_ + 2 * n2, :2]
    sok = ok[np_:np_ + n2] & ok[np_ + n2:np_ + 2 * n2]
    seg_len_sq = jnp.sum((p1 - p0) ** 2, axis=-1)
    line_d = lines.segment_signed_distance_to_point(p0, p1, prep.point2d_obs_uv)
    point_d = prep.point2d_obs_uv - p0
    dq = jnp.where((seg_len_sq < 1e-12)[..., None], point_d, line_d)
    dq = jnp.where(sok[..., None], dq, BIG_RESIDUAL)
    rq = jnp.where(prep.point2d_mask[..., None], dq, 0.0) * (POINT2D_ALPHA / 2.0)

    plane_w2c = se3.plane_world_to_camera_matrix(w2c)
    dk = planes.reduced_signed_distance(prep.plane_world, prep.plane_cam, plane_w2c)
    rk = jnp.where(prep.plane_mask[..., None], dk, 0.0) * (PLANE_ALPHA / 3.0)

    nl = prep.line_mask.shape[-1]
    l0 = scr[np_ + 2 * n2:np_ + 2 * n2 + nl, :2]
    l1 = scr[np_ + 2 * n2 + nl:, :2]
    lok = ok[np_ + 2 * n2:np_ + 2 * n2 + nl] & ok[np_ + 2 * n2 + nl:]
    dl = _line_point_distances(l0, l1, prep.line_obs_p0, prep.line_obs_p1, lok,
                               BIG_RESIDUAL)
    rl = jnp.where(prep.line_mask[..., None], dl, 0.0) * (LINE_ALPHA / 2.0)

    return jnp.concatenate(
        [rp.reshape(rp.shape[:-2] + (-1,)),
         rq.reshape(rq.shape[:-2] + (-1,)),
         rk.reshape(rk.shape[:-2] + (-1,)),
         rl.reshape(rl.shape[:-2] + (-1,))], axis=-1)


def point_residuals(feats: MatchedFeatures, w2c, cam: CameraIntrinsics):
    """Signed 2D px reprojection error per 3D point, [NP, 2]
    (reference: PointOptimizationFeature::get_distance, map_point.cpp:40-45)."""
    d = pinhole.signed_screen_distance_2d(
        feats.point_world, feats.point_obs_uv, w2c, cam, big=BIG_RESIDUAL)
    return jnp.where(feats.point_mask[..., None], d, 0.0)


def point2d_residuals(feats: MatchedFeatures, w2c, cam: CameraIntrinsics):
    """Signed px distance of the observation to the projected inverse-depth segment,
    [N2, 2] (reference: Point2dOptimizationFeature::get_distance,
    map_point2d.cpp:40-46 — rho variance taken from the state std dev)."""
    rho_var = feats.point2d_state_std[..., idp.INVERSE_DEPTH_IDX] ** 2
    d = idp.signed_screen_distance(
        feats.point2d_state, rho_var, feats.point2d_obs_uv, w2c, cam, big=BIG_RESIDUAL)
    return jnp.where(feats.point2d_mask[..., None], d, 0.0)


def plane_residuals(feats: MatchedFeatures, w2c, cam: CameraIntrinsics = None):
    """Reduced ``d*n`` plane error, [NK, 3] (reference:
    PlaneOptimizationFeature::get_distance, map_primitive.cpp:51-62)."""
    plane_w2c = se3.plane_world_to_camera_matrix(w2c)
    d = planes.reduced_signed_distance(feats.plane_world, feats.plane_cam, plane_w2c)
    return jnp.where(feats.plane_mask[..., None], d, 0.0)


def residual_vector(coeffs, feats: MatchedFeatures, cam: CameraIntrinsics,
                    weights=None):
    """Full stacked residual vector for the 6-dof optimization coefficients.

    Per-feature blocks are scaled by ``alpha / part_count`` exactly like the reference
    cost assembly (Global_Pose_Estimator::operator(), levenberg_marquardt_functors.cpp
    :128-169).  ``weights`` (unified index space) selects the RANSAC subset; masked or
    unselected features contribute zero residual."""
    if weights is not None:
        wp, wq, wk = feats.split_unified(weights)
        feats = feats.with_masks(wp > 0, wq > 0, wk > 0)
    return residual_vector_prepared(coeffs, prepare_features(feats, cam), cam)


def inlier_masks_prepared(quat, position, prep: PreparedFeatures,
                          cam: CameraIntrinsics,
                          ransac: RansacConfig = RansacConfig()):
    """Per-type inlier masks at a given pose from a prepared feature set (reference
    per-type ``is_inlier``: map_point.cpp:34-38 L1 px <= 3; map_point2d.cpp:33-38
    per-component <= 3; map_primitive.cpp:33-49 4-vector abs <= [0.2,0.2,0.2,50])."""
    w2c = se3.world_to_camera(quat, position)
    scr, ok = pinhole.world_to_screen(prep.pts_world, w2c, cam)
    np_ = prep.point_mask.shape[-1]
    n2 = prep.point2d_mask.shape[-1]

    dp = jnp.where(ok[:np_, None], prep.point_obs_uv - scr[:np_, :2], BIG_RESIDUAL)
    d_pt = jnp.sum(jnp.abs(dp), axis=-1)  # L1 px, point_coordinates.cpp:262-278
    point_in = (d_pt <= ransac.max_retroprojection_error_point_px) & prep.point_mask

    p0 = scr[np_:np_ + n2, :2]
    p1 = scr[np_ + n2:np_ + 2 * n2, :2]
    sok = ok[np_:np_ + n2] & ok[np_ + n2:np_ + 2 * n2]
    seg_len_sq = jnp.sum((p1 - p0) ** 2, axis=-1)
    line_d = lines.segment_signed_distance_to_point(p0, p1, prep.point2d_obs_uv)
    point_d = prep.point2d_obs_uv - p0
    d_2d = jnp.where((seg_len_sq < 1e-12)[..., None], point_d, line_d)
    d_2d = jnp.where(sok[..., None], d_2d, BIG_RESIDUAL)
    point2d_in = jnp.all(
        jnp.abs(d_2d) <= ransac.max_retroprojection_error_point2d_px, axis=-1
    ) & prep.point2d_mask

    plane_w2c = se3.plane_world_to_camera_matrix(w2c)
    d_pl = jnp.abs(planes.signed_distance(prep.plane_world, prep.plane_cam, plane_w2c))
    thresholds = jnp.asarray(
        [ransac.max_retroprojection_error_plane_normal] * 3
        + [ransac.max_retroprojection_error_plane_mm], dtype=d_pl.dtype)
    plane_in = jnp.all(d_pl <= thresholds, axis=-1) & prep.plane_mask

    nl = prep.line_mask.shape[-1]
    l0 = scr[np_ + 2 * n2:np_ + 2 * n2 + nl, :2]
    l1 = scr[np_ + 2 * n2 + nl:, :2]
    lok = ok[np_ + 2 * n2:np_ + 2 * n2 + nl] & ok[np_ + 2 * n2 + nl:]
    d_ln = _line_point_distances(l0, l1, prep.line_obs_p0, prep.line_obs_p1,
                                 lok, BIG_RESIDUAL)
    line_in = jnp.all(
        jnp.abs(d_ln) <= getattr(ransac, "max_retroprojection_error_line_px",
                                 3.0), axis=-1) & prep.line_mask

    return point_in, point2d_in, plane_in, line_in


def inlier_masks(quat, position, feats: MatchedFeatures, cam: CameraIntrinsics,
                 ransac: RansacConfig = RansacConfig()):
    """Per-type inlier masks at a given pose (wrapper over
    :func:`inlier_masks_prepared`)."""
    return inlier_masks_prepared(quat, position, prepare_features(feats, cam),
                                 cam, ransac)


def random_variation(feats: MatchedFeatures, key, scale=1.0) -> MatchedFeatures:
    """Perturb map features by their standard deviation for the Monte-Carlo pose
    covariance (reference per-type ``compute_random_variation``:
    map_point.cpp:48-57 full N(0,std) on the world point;
    map_point2d.cpp:49-74 theta/phi only, clamped to their domains;
    map_primitive.cpp:66-80 normal+d perturbation with renormalization).

    ``scale`` multiplies the noise (0 = unperturbed member of a fused batch)."""
    import jax

    k1, k2, k3, k4, k5 = jax.random.split(key, 5)
    dt = feats.point_world.dtype

    new_points = feats.point_world + scale * (
        jax.random.normal(k1, feats.point_world.shape, dtype=dt) * feats.point_world_std)

    theta = feats.point2d_state[..., idp.THETA_IDX]
    phi = feats.point2d_state[..., idp.PHI_IDX]
    nt = jnp.clip(
        theta + scale * jax.random.normal(k2, theta.shape, dtype=dt)
        * feats.point2d_state_std[..., idp.THETA_IDX], 0.0, jnp.pi)
    nphi = jnp.clip(
        phi + scale * jax.random.normal(k3, phi.shape, dtype=dt)
        * feats.point2d_state_std[..., idp.PHI_IDX], -jnp.pi, jnp.pi)
    new_state = feats.point2d_state.at[..., idp.THETA_IDX].set(nt)
    new_state = new_state.at[..., idp.PHI_IDX].set(nphi)

    plane_noise = scale * jax.random.normal(k4, feats.plane_world.shape, dtype=dt) \
        * feats.plane_world_std
    new_planes = planes.normalize_plane(feats.plane_world + plane_noise)

    new_lines = feats.line_world + scale * (
        jax.random.normal(k5, feats.line_world.shape, dtype=dt)
        * feats.line_world_std)

    return feats._replace(
        point_world=new_points, point2d_state=new_state, plane_world=new_planes,
        line_world=new_lines)

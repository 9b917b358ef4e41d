"""Covariance models and propagation.

Parity with the reference (src/utils/covariances.{hpp,cpp}) with one twist: all
routines are batched over a leading feature axis (replacing per-feature Eigen calls) and
keep covariance algebra in float32 with explicit symmetrization, which the test tier
validates against float64 golden values on CPU.
"""

from __future__ import annotations

import jax.numpy as jnp

from ..config import CameraIntrinsics, DepthNoiseModel


def get_depth_quantization(depth_mm, model: DepthNoiseModel = DepthNoiseModel()):
    """Minimum depth disparity at depth z: ``max(a + b z + c z^2, 0.5mm)``
    (reference: covariances.cpp:12-19 with constants from parameters.hpp:13-18)."""
    z = depth_mm
    return jnp.maximum(model.constant + model.linear * z + model.quadratic * z * z, model.floor_mm)


def propagate_covariance(cov, jacobian, eps=0.0):
    """First-order propagation ``J Sigma J^T (+ eps I)``
    (reference: covariances.hpp:55-64).  Batched over leading axes; symmetrized to
    counter f32 rounding (covariance-conditioning rule, SURVEY.md §7)."""
    out = jnp.einsum("...ij,...jk,...lk->...il", jacobian, cov, jacobian)
    out = 0.5 * (out + jnp.swapaxes(out, -1, -2))
    if eps:
        out = out + eps * jnp.eye(out.shape[-1], dtype=out.dtype)
    return out


def is_covariance_valid_fast(cov, atol=1e-5):
    """Hot-path covariance validity: finite, symmetric, positive-definite via
    Cholesky (NaN factor <=> not PD) — the jit analogue of the reference's
    LDLT-based isCovarianceValid hard-fail (covariances.hpp:13-50,
    rgbd_slam.cpp:167-171).  Batched; much cheaper than eigvalsh."""
    sym_t = jnp.swapaxes(cov, -1, -2)
    finite = jnp.all(jnp.isfinite(cov), axis=(-2, -1))
    scale = jnp.maximum(jnp.max(jnp.abs(cov), axis=(-2, -1)), 1.0)
    sym = jnp.max(jnp.abs(cov - sym_t), axis=(-2, -1)) < atol * scale
    n = cov.shape[-1]
    s = 0.5 * (cov + sym_t) + atol * jnp.eye(n, dtype=cov.dtype)
    if n == 3:
        # Sylvester's criterion in closed form: pure vector math, fuses into
        # the surrounding KF update instead of a batched Cholesky kernel
        a, b, c = s[..., 0, 0], s[..., 0, 1], s[..., 0, 2]
        d, e, f = s[..., 1, 1], s[..., 1, 2], s[..., 2, 2]
        m1 = a
        m2 = a * d - b * b
        m3 = a * (d * f - e * e) - b * (b * f - c * e) + c * (b * e - c * d)
        pd = (m1 > 0) & (m2 > 0) & (m3 > 0)
    else:
        chol = jnp.linalg.cholesky(s)
        pd = jnp.all(jnp.isfinite(chol), axis=(-2, -1))
    return finite & sym & pd


def is_covariance_valid(cov, atol=1e-5):
    """Symmetry + positive-semi-definiteness check (reference: covariances.hpp:13-50).
    Uses eigvalsh rather than LDLT; batched, returns a bool mask."""
    sym = jnp.all(jnp.abs(cov - jnp.swapaxes(cov, -1, -2)) < atol, axis=(-2, -1))
    eigs = jnp.linalg.eigvalsh(0.5 * (cov + jnp.swapaxes(cov, -1, -2)))
    psd = jnp.all(eigs > -atol, axis=-1)
    return sym & psd


def screen_point_covariance(screen, model: DepthNoiseModel = DepthNoiseModel(),
                            xy_sigma_px: float = 0.1):
    """Measurement covariance of a screen observation [u, v, z]: fixed 0.1px xy variance
    and depth-quantization z variance (reference: ScreenCoordinate::get_covariance,
    point_coordinates.cpp:99-143; invalid depth maps to variance 1000)."""
    from .pinhole import is_depth_valid

    z = screen[..., 2]
    zq = jnp.where(is_depth_valid(z), get_depth_quantization(z, model), 1000.0)
    xy_var = jnp.full_like(z, xy_sigma_px * xy_sigma_px)
    # one broadcasted multiply instead of three full-array index updates (each
    # .at[].set on a [N, 3, 3] batch lowered to a separate dynamic-update-slice)
    diag = jnp.stack([xy_var, xy_var, zq], axis=-1)
    return diag[..., :, None] * jnp.eye(3, dtype=screen.dtype)


def screen_to_camera_covariance(screen, screen_cov, cam: CameraIntrinsics):
    """Propagate a screen covariance into camera space with the reference's
    absolute-value jacobian (get_camera_point_covariance, covariances.cpp:76-94)."""
    z = screen[..., 2]
    jx = jnp.abs(screen[..., 0] - cam.cx) / cam.fx
    jy = jnp.abs(screen[..., 1] - cam.cy) / cam.fy
    zero = jnp.zeros_like(z)
    one = jnp.ones_like(z)
    j = jnp.stack(
        [
            jnp.stack([z / cam.fx, zero, jx], axis=-1),
            jnp.stack([zero, z / cam.fy, jy], axis=-1),
            jnp.stack([zero, zero, one], axis=-1),
        ],
        axis=-2,
    )
    return propagate_covariance(screen_cov, j)


def camera_to_screen_covariance(pt_cam, cam_cov, cam: CameraIntrinsics):
    """Camera-space covariance -> screen space (reference: get_screen_point_covariance,
    covariances.cpp:21-32)."""
    x, y, z = pt_cam[..., 0], pt_cam[..., 1], pt_cam[..., 2]
    safe_z = jnp.where(jnp.abs(z) < 1e-9, 1e-9, z)
    zero = jnp.zeros_like(z)
    one = jnp.ones_like(z)
    j = jnp.stack(
        [
            jnp.stack([cam.fx / safe_z, zero, -cam.fx * x / (safe_z * safe_z)], axis=-1),
            jnp.stack([zero, cam.fy / safe_z, -cam.fy * y / (safe_z * safe_z)], axis=-1),
            jnp.stack([zero, zero, one], axis=-1),
        ],
        axis=-2,
    )
    return propagate_covariance(cam_cov, j)


def rotate_covariance(cov, rotation_33, pose_cov=None):
    """Rotate a 3x3 covariance between camera/world frames and add the pose covariance
    (reference: get_camera_point_covariance / get_world_point_covariance,
    covariances.cpp:46-67)."""
    out = propagate_covariance(cov, rotation_33)
    if pose_cov is not None:
        out = out + pose_cov
    return out


def screen_point_to_world_covariance(screen, c2w, cam: CameraIntrinsics,
                                     pose_cov=None, model: DepthNoiseModel = DepthNoiseModel()):
    """Full chain screen measurement -> world covariance (reference:
    get_world_point_covariance(ScreenCoordinate...), covariances.cpp:69-74)."""
    s_cov = screen_point_covariance(screen, model)
    c_cov = screen_to_camera_covariance(screen, s_cov, cam)
    return rotate_covariance(c_cov, c2w[..., :3, :3], pose_cov)


# ---------------------------------------------------------------------------
# plane covariance conversions (hessian 4-param <-> reduced 3-param d*n)
# ---------------------------------------------------------------------------

def plane_covariance_from_point_cloud(plane_4, point_cloud_cov, eps=0.01):
    """3-param (n*d vector) point-cloud covariance -> 4-param hessian covariance
    (reference: compute_plane_covariance, covariances.cpp:96-155).

    plane_4 = [nx, ny, nz, d] with unit normal."""
    n = plane_4[..., :3]
    d = plane_4[..., 3:4]
    p = n * d  # reduced parametrization
    a, b, c = p[..., 0], p[..., 1], p[..., 2]
    a2, b2, c2 = a * a, b * b, c * c
    s = a2 + b2 + c2
    divider = s ** 1.5
    common = 1.0 / jnp.sqrt(s)
    row0 = jnp.stack([common - a2 / divider, -(a * b) / divider, -(a * c) / divider], axis=-1)
    row1 = jnp.stack([-(a * b) / divider, common - b2 / divider, -(b * c) / divider], axis=-1)
    row2 = jnp.stack([-(a * c) / divider, -(b * c) / divider, common - c2 / divider], axis=-1)
    row3 = jnp.stack([-a / divider, -b / divider, -c / divider], axis=-1)
    j = jnp.stack([row0, row1, row2, row3], axis=-2)
    return propagate_covariance(point_cloud_cov, j, eps=eps)


def reduced_point_cloud_covariance_from_plane(plane_4, plane_cov44, eps=0.01):
    """4-param hessian covariance -> 3-param (n*d) covariance (reference:
    compute_reduced_plane_point_cloud_covariance, covariances.cpp:157-199)."""
    n = plane_4[..., :3]
    d = plane_4[..., 3]
    zero = jnp.zeros_like(d)
    j = jnp.stack(
        [
            jnp.stack([d, zero, zero, n[..., 0]], axis=-1),
            jnp.stack([zero, d, zero, n[..., 1]], axis=-1),
            jnp.stack([zero, zero, d, n[..., 2]], axis=-1),
        ],
        axis=-2,
    )
    return propagate_covariance(plane_cov44, j, eps=eps)


def world_plane_covariance(plane_cam_4, plane_world_4, c2w, plane_cov44, world_pose_cov33, eps=0.01):
    """Camera plane covariance -> world plane covariance via the reduced point form
    (reference: get_world_plane_covariance, covariances.cpp:201-225)."""
    pc_cov = reduced_point_cloud_covariance_from_plane(plane_cam_4, plane_cov44, eps)
    pc_world = rotate_covariance(pc_cov, c2w[..., :3, :3], world_pose_cov33)
    return plane_covariance_from_point_cloud(plane_world_4, pc_world, eps)

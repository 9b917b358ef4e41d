"""Pinhole projections: screen <-> camera <-> world point transforms.

Parity with the reference coordinate classes (src/coordinates/point_coordinates.cpp):

* screen coordinates are ``[u px, v px, depth mm]`` (u = column, v = row),
* camera coordinates are mm in the optical frame (x right, y down, z forward),
* world coordinates are mm in the physical frame (x fwd, y left, z up),
* camera<->world transforms come from :mod:`rgbd_slam.geometry.se3` and already
  embed the fixed axis correction.

Everything is batched: points have shape ``[..., 3]`` and all ops broadcast, replacing
the reference's per-point Eigen arithmetic with vectorized array math that XLA fuses.
"""

from __future__ import annotations

import jax.numpy as jnp

from ..config import CameraIntrinsics


def is_depth_valid(depth_mm, min_depth=40.0, max_depth=6000.0):
    """Valid measured-depth gate (reference: point_coordinates.cpp:16-22)."""
    return (depth_mm > min_depth) & (depth_mm <= max_depth)


def screen_to_camera(screen, cam: CameraIntrinsics):
    """[u, v, z_mm] -> camera-space mm point (reference:
    ScreenCoordinate::to_camera_coordinates, point_coordinates.cpp:150-167)."""
    u, v, z = screen[..., 0], screen[..., 1], screen[..., 2]
    x = (u - cam.cx) / cam.fx * z
    y = (v - cam.cy) / cam.fy * z
    return jnp.stack([x, y, z], axis=-1)


def camera_to_screen(pt_cam, cam: CameraIntrinsics):
    """camera mm point -> [u, v, z_mm] (reference:
    CameraCoordinate::to_screen_coordinates, point_coordinates.cpp:203-212).
    z==0 is guarded with a tiny epsilon; the caller masks invalid projections."""
    x, y, z = pt_cam[..., 0], pt_cam[..., 1], pt_cam[..., 2]
    safe_z = jnp.where(jnp.abs(z) < 1e-9, 1e-9, z)
    u = cam.fx * x / safe_z + cam.cx
    v = cam.fy * y / safe_z + cam.cy
    return jnp.stack([u, v, z], axis=-1)


def apply_transform(m44, pts):
    """Apply a homogeneous 4x4 to [..., 3] points.  (A column-scalarized
    variant was measured SLOWER in the fused engine step — XLA's own fusion
    of the einsum form wins; don't "optimize" this again without a trace.)"""
    return jnp.einsum("...ij,...j->...i", m44[..., :3, :3], pts) + m44[..., :3, 3]


def camera_to_world_point(pt_cam, c2w):
    """(reference: CameraCoordinate::to_world_coordinates, point_coordinates.cpp:198-201)"""
    return apply_transform(c2w, pt_cam)


def world_to_camera_point(pt_world, w2c):
    """(reference: WorldCoordinate::to_camera_coordinates, point_coordinates.cpp:292-297)"""
    return apply_transform(w2c, pt_world)


def screen_to_world(screen, c2w, cam: CameraIntrinsics):
    return camera_to_world_point(screen_to_camera(screen, cam), c2w)


def world_to_screen(pt_world, w2c, cam: CameraIntrinsics):
    """World point -> screen [u,v,z]; also returns a validity mask (z>0, finite)."""
    pt_cam = world_to_camera_point(pt_world, w2c)
    screen = camera_to_screen(pt_cam, cam)
    valid = (pt_cam[..., 2] > 0) & jnp.all(jnp.isfinite(screen), axis=-1)
    return screen, valid


def is_in_screen_boundaries(screen, cam: CameraIntrinsics):
    """(reference: ScreenCoordinate::is_in_screen_boundaries,
    point_coordinates.cpp:169-180)"""
    u, v = screen[..., 0], screen[..., 1]
    ok = (u >= 0) & (u <= cam.width) & (v >= 0) & (v <= cam.height)
    if screen.shape[-1] >= 3:
        ok = ok & (screen[..., 2] > 0)
    return ok


def signed_screen_distance_2d(world_pt, screen_obs_uv, w2c, cam: CameraIntrinsics, big=1e10):
    """Signed px reprojection error of a world point vs. a 2D screen observation
    (reference: WorldCoordinate::get_signed_distance_2D_px,
    point_coordinates.cpp:245-260).  Invalid projections map to +-``big``."""
    proj, valid = world_to_screen(world_pt, w2c, cam)
    d = screen_obs_uv[..., :2] - proj[..., :2]
    return jnp.where(valid[..., None], d, big)


def screen_distance_px(world_pt, screen_obs_uv, w2c, cam: CameraIntrinsics, big=1e10):
    """L1 reprojection distance in px (reference: get_distance_px,
    point_coordinates.cpp:262-278)."""
    return jnp.sum(jnp.abs(signed_screen_distance_2d(world_pt, screen_obs_uv, w2c, cam, big)), axis=-1)

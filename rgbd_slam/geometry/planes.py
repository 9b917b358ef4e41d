"""Hessian-form plane coordinates and distances.

A plane is a 4-vector ``[nx, ny, nz, d]`` with unit normal; a point p lies on the plane
iff ``n . p + d == 0`` (parity with reference src/coordinates/plane_coordinates.{hpp,cpp}).
Camera<->world plane transforms use the 4x4 plane matrices from
:func:`rgbd_slam.geometry.se3.plane_camera_to_world_matrix`.
Batched over leading axes.
"""

from __future__ import annotations

import jax.numpy as jnp

from . import lines


def normalize_plane(plane_4):
    """Renormalize the normal part (the reference normalizes on construction,
    plane_coordinates.hpp:19-27)."""
    n = plane_4[..., :3]
    norm = jnp.maximum(jnp.linalg.norm(n, axis=-1, keepdims=True), 1e-12)
    return jnp.concatenate([n / norm, plane_4[..., 3:4]], axis=-1)


def plane_center(plane_4):
    """Closest point of the plane to the origin (reference: get_center,
    plane_coordinates.hpp:52)."""
    return plane_4[..., :3] * (-plane_4[..., 3:4])


def point_distance(plane_4, point):
    """Signed point-plane distance ``n.p + d`` (reference: get_point_distance,
    plane_coordinates.hpp:53-57)."""
    return jnp.sum(plane_4[..., :3] * point, axis=-1) + plane_4[..., 3]


def cos_angle(plane_a, plane_b):
    """(reference: get_cos_angle, plane_coordinates.hpp:58-61)"""
    return jnp.sum(plane_a[..., :3] * plane_b[..., :3], axis=-1)


def transform_plane(plane_4, plane_m44):
    """Apply a 4x4 plane transform (reference: to_world_coordinates /
    to_camera_coordinates, plane_coordinates.cpp:14-24)."""
    return jnp.einsum("...ij,...j->...i", plane_m44, plane_4)


def signed_distance(world_plane, camera_plane, plane_w2c):
    """4-vector plane error: per-axis wrapped angular distance of the normals plus the
    d difference (reference: get_signed_distance, plane_coordinates.cpp:26-37)."""
    proj = transform_plane(world_plane, plane_w2c)
    ang = lines.angle_distance(camera_plane[..., :3], proj[..., :3])
    dd = camera_plane[..., 3:4] - proj[..., 3:4]
    return jnp.concatenate([ang, dd], axis=-1)


def reduced_signed_distance(world_plane, camera_plane, plane_w2c):
    """Reduced 3-vector plane error ``d_c * n_c - d_p * n_p`` used in the LM cost
    (reference: get_reduced_signed_distance, plane_coordinates.cpp:49-56)."""
    proj = transform_plane(world_plane, plane_w2c)
    return camera_plane[..., 3:4] * camera_plane[..., :3] - proj[..., 3:4] * proj[..., :3]

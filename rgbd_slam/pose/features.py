"""Matched-feature containers for pose optimization.

The reference passes a heterogeneous ``match_container`` of ``IOptimizationFeature``
pointers with virtual residual dispatch (src/matches_containers.hpp:122-180).  This
design replaces it with a fixed-capacity structure-of-arrays pytree: one masked array
block per feature type, so residuals/inliers/scores evaluate as three batched kernels
with no per-feature dispatch (SURVEY.md §7).

Score semantics (parity): each feature contributes ``1/minimumCountForOptimization``
— points 1/5, 2D points 1/5, planes 1/3; a pose is solvable when the total score of the
participating features reaches 1.0 (matches_containers.hpp:140-149).
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp

# per-type optimization scores = 1 / minimum-features-for-optimization
# (reference: map_point.cpp:28-31, map_point2d.cpp:27-30, map_primitive.cpp:27-30
# with parameters.hpp:40-44) — derived from RansacConfig so the min-count knobs
# stay live.
from ..config import RansacConfig as _RANSAC_DEFAULTS

POINT_SCORE = 1.0 / _RANSAC_DEFAULTS().min_point_count
POINT2D_SCORE = 1.0 / _RANSAC_DEFAULTS().min_point2d_count
PLANE_SCORE = 1.0 / _RANSAC_DEFAULTS().min_plane_count
# lines never reach the reference's optimizer (USE_LINE_DETECTION undefined,
# rgbd_slam.cpp:304-313); score follows the point convention (5 lines constrain a
# pose) per the reference's planned point/line residual design (README.md:134-136)
LINE_SCORE = 1.0 / _RANSAC_DEFAULTS().min_point_count

# per-type residual weights alpha (reference: map_point.cpp:46, map_point2d.cpp:47,
# map_primitive.cpp:64)
POINT_ALPHA = 1.0
POINT2D_ALPHA = 0.3
PLANE_ALPHA = 1.0
LINE_ALPHA = 1.0


class MatchedFeatures(NamedTuple):
    """All feature matches fed into one pose optimization, mask-padded to static
    capacities.  Shapes: points obs/world [NP,2]/[NP,3]; 2D points obs/state
    [N2,2]/[N2,6]; planes camera/world [NK,4]."""

    # 3D points: observed screen uv vs map world point (+ std dev of the map point)
    point_obs_uv: jnp.ndarray
    point_world: jnp.ndarray
    point_world_std: jnp.ndarray
    point_mask: jnp.ndarray

    # inverse-depth 2D points: observed screen uv vs 6-dof inverse-depth state
    point2d_obs_uv: jnp.ndarray
    point2d_state: jnp.ndarray
    point2d_state_std: jnp.ndarray
    point2d_mask: jnp.ndarray

    # planes: observed camera-space hessian plane vs map world plane
    plane_cam: jnp.ndarray
    plane_world: jnp.ndarray
    plane_world_std: jnp.ndarray
    plane_mask: jnp.ndarray

    # lines: observed screen segment endpoints vs map world segment (e0|e1 packed
    # [NL, 6]); NEW vs the reference (README.md:134-136 design, never wired there)
    line_obs_p0: jnp.ndarray
    line_obs_p1: jnp.ndarray
    line_world: jnp.ndarray
    line_world_std: jnp.ndarray
    line_mask: jnp.ndarray

    @property
    def capacities(self):
        return (self.point_mask.shape[-1], self.point2d_mask.shape[-1],
                self.plane_mask.shape[-1], self.line_mask.shape[-1])

    def scores(self):
        """Per-feature scores over the unified index space [NP+N2+NK+NL] (zero
        where masked out)."""
        dt = self.point_world.dtype
        return jnp.concatenate([
            jnp.where(self.point_mask, POINT_SCORE, 0.0).astype(dt),
            jnp.where(self.point2d_mask, POINT2D_SCORE, 0.0).astype(dt),
            jnp.where(self.plane_mask, PLANE_SCORE, 0.0).astype(dt),
            jnp.where(self.line_mask, LINE_SCORE, 0.0).astype(dt),
        ], axis=-1)

    def valid_mask(self):
        return jnp.concatenate(
            [self.point_mask, self.point2d_mask, self.plane_mask,
             self.line_mask], axis=-1)

    def total_score(self):
        return jnp.sum(self.scores(), axis=-1)

    def split_unified(self, unified):
        """Split a unified-index array back into per-type blocks."""
        np_, n2, nk, nl = self.capacities
        return (unified[..., :np_], unified[..., np_:np_ + n2],
                unified[..., np_ + n2:np_ + n2 + nk],
                unified[..., np_ + n2 + nk:])

    def with_masks(self, point_mask, point2d_mask, plane_mask, line_mask=None):
        return self._replace(
            point_mask=point_mask & self.point_mask,
            point2d_mask=point2d_mask & self.point2d_mask,
            plane_mask=plane_mask & self.plane_mask,
            line_mask=(self.line_mask if line_mask is None
                       else line_mask & self.line_mask),
        )


def make_matched_features(point_obs_uv=None, point_world=None, point_world_std=None,
                          point2d_obs_uv=None, point2d_state=None, point2d_state_std=None,
                          plane_cam=None, plane_world=None, plane_world_std=None,
                          line_obs_p0=None, line_obs_p1=None, line_world=None,
                          line_world_std=None,
                          capacities=(64, 32, 8, 8), dtype=jnp.float32) -> MatchedFeatures:
    """Build a mask-padded MatchedFeatures from (possibly None / shorter) arrays."""
    if len(capacities) == 3:
        capacities = tuple(capacities) + (8,)
    np_, n2, nk, nl = capacities

    def pad(arr, cap, width):
        mask = jnp.zeros((cap,), dtype=bool)
        out = jnp.zeros((cap, width), dtype=dtype)
        if arr is not None and arr.shape[0] > 0:
            n = min(arr.shape[0], cap)
            out = out.at[:n].set(jnp.asarray(arr[:n], dtype=dtype))
            mask = mask.at[:n].set(True)
        return out, mask

    p_uv, p_mask = pad(point_obs_uv, np_, 2)
    p_w, _ = pad(point_world, np_, 3)
    p_std, _ = pad(point_world_std, np_, 3)
    q_uv, q_mask = pad(point2d_obs_uv, n2, 2)
    q_st, _ = pad(point2d_state, n2, 6)
    q_std, _ = pad(point2d_state_std, n2, 6)
    k_c, k_mask = pad(plane_cam, nk, 4)
    k_w, _ = pad(plane_world, nk, 4)
    k_std, _ = pad(plane_world_std, nk, 4)
    l_p0, l_mask = pad(line_obs_p0, nl, 2)
    l_p1, _ = pad(line_obs_p1, nl, 2)
    l_w, _ = pad(line_world, nl, 6)
    l_std, _ = pad(line_world_std, nl, 6)

    return MatchedFeatures(
        point_obs_uv=p_uv, point_world=p_w, point_world_std=p_std, point_mask=p_mask,
        point2d_obs_uv=q_uv, point2d_state=q_st, point2d_state_std=q_std,
        point2d_mask=q_mask,
        plane_cam=k_c, plane_world=k_w, plane_world_std=k_std, plane_mask=k_mask,
        line_obs_p0=l_p0, line_obs_p1=l_p1, line_world=l_w, line_world_std=l_std,
        line_mask=l_mask,
    )

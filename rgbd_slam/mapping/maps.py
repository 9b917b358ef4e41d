"""Structure-of-arrays local feature maps (points, inverse-depth points, planes).

Replacement for the reference's ``Feature_Map<...>`` dual ``{staged, local}``
``unordered_map`` containers (src/map_management/feature_map.hpp:235-966): every
feature type lives in ONE preallocated mask-padded array block; staged-vs-local is a
bool column; insertion/eviction/promotion are masked scatters; all per-feature updates
run batched (SURVEY.md §7 structure-of-arrays plan).

Lifecycle parity:
* staged confidence = successive-match-count / 3, promote when > 0.9, drop when the
  count reaches 0 (map_point.cpp:251-274 via parameters.hpp:102-110);
* local features are lost after 10 consecutive misses (map_point.cpp:303-306);
* planes promote after 4 staged hits and drop after 2 misses
  (map_primitive.cpp:286-288).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..utils import polygon as poly


class PointMap(NamedTuple):
    """3D world points with per-feature 3x3 Kalman state (reference: MapPoint,
    map_point.{hpp,cpp})."""
    pos: jnp.ndarray          # [M, 3] world mm
    cov: jnp.ndarray          # [M, 3, 3]
    desc: jnp.ndarray         # [M, 8] uint32 BRIEF
    fid: jnp.ndarray          # [M] int32 unique id, -1 = empty slot
    is_local: jnp.ndarray     # [M] bool (False = staged)
    match_count: jnp.ndarray  # [M] int32 successive matched count
    miss_count: jnp.ndarray   # [M] int32 consecutive unmatched count
    is_moving: jnp.ndarray    # [M] bool


class Point2DMap(NamedTuple):
    """Inverse-depth points (reference: MapPoint2D, map_point2d.{hpp,cpp})."""
    state: jnp.ndarray        # [M, 6] inverse-depth state
    cov: jnp.ndarray          # [M, 6, 6]
    desc: jnp.ndarray         # [M, 8] uint32
    fid: jnp.ndarray          # [M] int32
    is_local: jnp.ndarray
    match_count: jnp.ndarray
    miss_count: jnp.ndarray


class LineMap(NamedTuple):
    """World 3D line segments (NEW vs the reference: its line path is compiled out
    and has no feature map, rgbd_slam.cpp:304-313 / SURVEY.md §2.3; this is the
    north-star config-2 'points+lines pose' surface).  Endpoints are packed
    [M, 6] = (e0 | e1) world mm; each endpoint carries a 3x3 Kalman covariance."""
    endpoints: jnp.ndarray    # [M, 6] world mm (e0 | e1)
    cov: jnp.ndarray          # [M, 2, 3, 3] per-endpoint covariance
    fid: jnp.ndarray          # [M] int32
    is_local: jnp.ndarray
    match_count: jnp.ndarray
    miss_count: jnp.ndarray


def empty_line_map(capacity: int, dtype=jnp.float32) -> LineMap:
    return LineMap(
        endpoints=jnp.zeros((capacity, 6), dtype),
        cov=jnp.zeros((capacity, 2, 3, 3), dtype),
        fid=jnp.full((capacity,), -1, jnp.int32),
        is_local=jnp.zeros((capacity,), bool),
        match_count=jnp.zeros((capacity,), jnp.int32),
        miss_count=jnp.zeros((capacity,), jnp.int32),
    )


class PlaneMap(NamedTuple):
    """World planes with polygon footprint (reference: MapPlane,
    map_primitive.{hpp,cpp})."""
    params: jnp.ndarray       # [M, 4] world hessian
    cov: jnp.ndarray          # [M, 4, 4]
    poly_verts: jnp.ndarray   # [M, V, 2] world plane-basis polygon
    poly_count: jnp.ndarray   # [M]
    basis_center: jnp.ndarray # [M, 3]
    basis_u: jnp.ndarray      # [M, 3]
    basis_v: jnp.ndarray      # [M, 3]
    fid: jnp.ndarray          # [M] int32
    is_local: jnp.ndarray
    match_count: jnp.ndarray
    miss_count: jnp.ndarray


def empty_point_map(capacity: int, dtype=jnp.float32) -> PointMap:
    return PointMap(
        pos=jnp.zeros((capacity, 3), dtype),
        cov=jnp.zeros((capacity, 3, 3), dtype),
        desc=jnp.zeros((capacity, 8), jnp.uint32),
        fid=jnp.full((capacity,), -1, jnp.int32),
        is_local=jnp.zeros((capacity,), bool),
        match_count=jnp.zeros((capacity,), jnp.int32),
        miss_count=jnp.zeros((capacity,), jnp.int32),
        is_moving=jnp.zeros((capacity,), bool),
    )


def empty_point2d_map(capacity: int, dtype=jnp.float32) -> Point2DMap:
    return Point2DMap(
        state=jnp.zeros((capacity, 6), dtype),
        cov=jnp.zeros((capacity, 6, 6), dtype),
        desc=jnp.zeros((capacity, 8), jnp.uint32),
        fid=jnp.full((capacity,), -1, jnp.int32),
        is_local=jnp.zeros((capacity,), bool),
        match_count=jnp.zeros((capacity,), jnp.int32),
        miss_count=jnp.zeros((capacity,), jnp.int32),
    )


def empty_plane_map(capacity: int, max_verts: int = poly.MAX_VERTS,
                    dtype=jnp.float32) -> PlaneMap:
    return PlaneMap(
        params=jnp.zeros((capacity, 4), dtype),
        cov=jnp.zeros((capacity, 4, 4), dtype),
        poly_verts=jnp.zeros((capacity, max_verts, 2), dtype),
        poly_count=jnp.zeros((capacity,), jnp.int32),
        basis_center=jnp.zeros((capacity, 3), dtype),
        basis_u=jnp.zeros((capacity, 3), dtype),
        basis_v=jnp.zeros((capacity, 3), dtype),
        fid=jnp.full((capacity,), -1, jnp.int32),
        is_local=jnp.zeros((capacity,), bool),
        match_count=jnp.zeros((capacity,), jnp.int32),
        miss_count=jnp.zeros((capacity,), jnp.int32),
    )


def alive(m) -> jnp.ndarray:
    return m.fid >= 0


def allocate_slots(free_mask, want_mask):
    """Masked slot allocator: the k-th wanted item gets the k-th free slot.

    Returns ``slots`` with shape of ``want_mask``: destination index, or -1 when the
    map is full (items beyond capacity are dropped, like the reference's detection
    budget caps).  Replaces the id->object ``unordered_map`` insertions
    (feature_map.hpp:437-480)."""
    n_free = free_mask.shape[0]
    # free slot indices, in order; invalid entries point past the end
    free_rank = jnp.cumsum(free_mask.astype(jnp.int32)) - 1
    slot_of_rank = jnp.full((n_free,), -1, jnp.int32)
    # out-of-bounds writes (non-free slots) are dropped
    slot_of_rank = slot_of_rank.at[
        jnp.where(free_mask, free_rank, n_free)
    ].set(jnp.arange(n_free, dtype=jnp.int32), mode="drop")

    want_rank = jnp.cumsum(want_mask.astype(jnp.int32)) - 1
    num_free = jnp.sum(free_mask.astype(jnp.int32))
    ok = want_mask & (want_rank < num_free)
    safe_rank = jnp.clip(want_rank, 0, n_free - 1)
    return jnp.where(ok, slot_of_rank[safe_rank], -1)


def lifecycle_update(is_local, match_count, miss_count, matched,
                     promote_threshold: int, lose_threshold: int,
                     staged_drop_at_zero: bool = True):
    """Shared staged/local lifecycle step (reference: Feature_Map::update_local_map /
    update_staged_map, feature_map.hpp:701-833).

    matched: bool per slot.  Returns (new_is_local, new_match_count, new_miss_count,
    keep_mask)."""
    new_match = jnp.where(matched, match_count + 1,
                          jnp.maximum(match_count - 1, 0))
    new_miss = jnp.where(matched, 0, miss_count + 1)

    promote = ~is_local & (new_match >= promote_threshold)
    new_is_local = is_local | promote

    lost_local = is_local & (new_miss > lose_threshold)
    lost_staged = ~is_local & ~matched & (new_match <= 0) if staged_drop_at_zero \
        else jnp.zeros_like(matched)
    keep = ~(lost_local | lost_staged)
    return new_is_local, new_match, new_miss, keep


def remove_features(m, keep_mask):
    """Clear slots whose keep_mask is False (id -> -1)."""
    return m._replace(fid=jnp.where(keep_mask, m.fid, -1))

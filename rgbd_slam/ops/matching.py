"""Descriptor matching with spatial gating and Lowe ratio test.

Replaces the reference's BFMatcher Hamming kNN(k=2) with a spatial-hash candidate mask
(src/features/keypoints/keypoint_handler.cpp:124-137, 234-282).  Design: the
spatial hash becomes a dense screen-distance gate on the full distance matrix — for
map/frame sizes of a few hundred, one masked [M, N] matrix beats pointer-chasing a
hash grid and is plain elementwise array work.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from .brief import hamming_distance_matrix

#: max Hamming distance considered a usable match at all (256-bit descriptors;
#: BFMatcher has no absolute cap but the ratio test dominates — this guards the
#: all-candidates-terrible case)
MAX_HAMMING = 120


def match_precompute(map_desc, map_proj_uv, det_desc, det_uv):
    """Pose/mask-independent parts of the matching: the Hamming distance matrix and
    squared screen distances [M, N].  Shared across the local/staged/advanced match
    passes, which only differ in masks and radius."""
    d = hamming_distance_matrix(map_desc, det_desc)
    dx = map_proj_uv[:, None, 0] - det_uv[None, :, 0]
    dy = map_proj_uv[:, None, 1] - det_uv[None, :, 1]
    return d, dx * dx + dy * dy


def match_from_distances(d, dist_sq, map_valid, det_valid, det_taken,
                         search_radius: float = 30.0, lowe_ratio: float = 0.7):
    """Window-gated kNN(2) + Lowe ratio selection from precomputed distances
    (see :func:`match_descriptors`)."""
    in_window = dist_sq <= search_radius * search_radius
    allowed = in_window & det_valid[None, :] & ~det_taken[None, :] & map_valid[:, None]
    big = jnp.int32(10_000)
    gated = jnp.where(allowed, d, big)

    # kNN(2) + Lowe ratio (closer-to-zero = more discriminating, parameters.hpp:99)
    if gated.shape[1] < 2:  # static pad so kNN(2) is well-defined for tiny N
        gated = jnp.pad(gated, ((0, 0), (0, 2 - gated.shape[1])),
                        constant_values=big)
    neg_top2, idx_top2 = jax.lax.top_k(-gated, 2)
    best = -neg_top2[:, 0]
    second = -neg_top2[:, 1]
    best_idx = idx_top2[:, 0]

    ratio_ok = best.astype(jnp.float32) < lowe_ratio * second.astype(jnp.float32)
    # single-candidate case: second is ``big`` -> ratio passes if best is decent
    usable = (best < MAX_HAMMING) & ratio_ok & map_valid
    return jnp.where(usable, best_idx, -1).astype(jnp.int32), best


@partial(jax.jit, static_argnames=())
def match_descriptors(map_desc, map_proj_uv, map_valid,
                      det_desc, det_uv, det_valid, det_taken,
                      search_radius: float = 30.0,
                      lowe_ratio: float = 0.7):
    """Window-gated kNN(2) descriptor matching with ratio test.

    Args: map features (descriptors [M, 8] uint32, projected screen uv [M, 2], valid
    mask) vs detected features (descriptors [N, 8], positions [N, 2], valid mask,
    ``det_taken`` marks detections already consumed by optical-flow tracking).

    Returns (match_index [M] int32 — index into detections or -1,
    match_distance [M] int32).  Parity: Keypoint_Handler::get_match_indexes
    (keypoint_handler.cpp:234-282) with matchSearchRadius_px gating and Lowe ratio
    0.7 (parameters.hpp:98-100)."""
    d, dist_sq = match_precompute(map_desc, map_proj_uv, det_desc, det_uv)
    return match_from_distances(d, dist_sq, map_valid, det_valid, det_taken,
                                search_radius=search_radius, lowe_ratio=lowe_ratio)


def resolve_match_conflicts(match_index, match_distance, n_detections: int):
    """Ensure each detection is matched by at most one map feature, keeping the
    lowest-distance claimant (the reference marks detections matched incrementally,
    feature_map.hpp:308-326; batched resolution replaces the sequential claim)."""
    m = match_index.shape[0]
    valid = match_index >= 0
    safe_idx = jnp.where(valid, match_index, 0)
    key = match_distance.astype(jnp.int32) * m + jnp.arange(m, dtype=jnp.int32)
    key = jnp.where(valid, key, jnp.iinfo(jnp.int32).max)
    best_key = jnp.full((n_detections,), jnp.iinfo(jnp.int32).max, dtype=jnp.int32)
    best_key = best_key.at[safe_idx].min(jnp.where(valid, key, jnp.iinfo(jnp.int32).max))
    keep = valid & (best_key[safe_idx] == key)
    return jnp.where(keep, match_index, -1).astype(jnp.int32)

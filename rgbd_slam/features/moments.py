"""Centered second-moment accumulators for plane fitting.

The reference accumulates RAW sums (Sx..Szx, plane_segment.hpp:130-139, f64) and forms
the covariance by Koenig-Huygen subtraction (plane_segment.cpp:193-230).  In f32
that subtraction catastrophically cancels at mm scales (x^2 ~ 1e6, sums ~ 1e9), so
this design stores CENTERED moments instead: (count, mean, M2) with
``M2 = sum (p - mean)(p - mean)^T``, and combines regions with Chan's parallel-axis
update — exactly additive like ``expand_segment`` (plane_segment.cpp:170-190) but
numerically stable in f32.
"""

from __future__ import annotations

import jax.numpy as jnp


def from_points(points, weights):
    """Masked point set -> (count, mean [3], m2 [3,3]).  points [..., P, 3],
    weights [..., P]."""
    cnt = jnp.sum(weights, axis=-1)
    safe = jnp.maximum(cnt, 1.0)
    mean = jnp.sum(points * weights[..., None], axis=-2) / safe[..., None]
    dev = (points - mean[..., None, :]) * weights[..., None]
    m2 = jnp.einsum("...pi,...pj->...ij", dev, points - mean[..., None, :])
    return cnt, mean, m2


def combine(cnts, means, m2s, mask):
    """Combine per-cell accumulators over a masked set (Chan / parallel axis):
    cnts [..., C], means [..., C, 3], m2s [..., C, 3, 3], mask [..., C].
    Returns (count, mean, m2) of the union."""
    w = jnp.where(mask, cnts, 0.0)
    total = jnp.sum(w, axis=-1)
    safe = jnp.maximum(total, 1.0)
    mean = jnp.sum(means * w[..., None], axis=-2) / safe[..., None]
    dev = means - mean[..., None, :]
    shift = jnp.einsum("...c,...ci,...cj->...ij", w, dev, dev)
    m2 = jnp.sum(jnp.where(mask[..., None, None], m2s, 0.0), axis=-3) + shift
    return total, mean, m2


def combine_pair(cnt_a, mean_a, m2_a, cnt_b, mean_b, m2_b):
    """Combine two accumulators."""
    total = cnt_a + cnt_b
    safe = jnp.maximum(total, 1.0)
    mean = (mean_a * cnt_a[..., None] + mean_b * cnt_b[..., None]) / safe[..., None]
    da = mean_a - mean
    db = mean_b - mean
    m2 = m2_a + m2_b \
        + cnt_a[..., None, None] * jnp.einsum("...i,...j->...ij", da, da) \
        + cnt_b[..., None, None] * jnp.einsum("...i,...j->...ij", db, db)
    return total, mean, m2


def raw_second_moment(cnt, mean, m2):
    """Reconstruct the raw moment matrix ``sum p p^T`` (needed for the reference's
    plane-parameter covariance, Plane_Segment::get_point_cloud_covariance,
    plane_segment.cpp:192-203)."""
    return m2 + cnt[..., None, None] * jnp.einsum("...i,...j->...ij", mean, mean)

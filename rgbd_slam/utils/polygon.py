"""Fixed-capacity convex polygon operations on device.

The reference uses Boost.Geometry concave polygons (src/utils/polygon.{hpp,cpp}) whose
boolean ops have no array-native analogue; per SURVEY.md §7 we use convex polygons with
a fixed vertex capacity: vertices live in a plane-local 2D basis (center + x/y axes),
ops are masked and jittable, and the IoU gate / union-merge of the plane map
(map_primitive.cpp:91-161, plane_with_tracking.cpp:16-79) run batched on device.

Polygon representation: (verts [V, 2], count []) — verts beyond ``count`` are ignored;
a valid polygon is convex and counter-clockwise ordered.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

#: polygon vertex capacity.  Polygons store only STRICT corners (collinear and
#: micro-concave vertices are dropped by _drop_flat_vertices), so 16 slots hold
#: any realistic convex footprint; smaller capacity quadratically shrinks the
#: all-pairs O(V^2) intersection work in the plane-match gate.
MAX_VERTS = 16


def plane_basis(normal):
    """Orthonormal (u, v) basis of the plane with the given unit normal
    (reference: utils::Polygon plane-local basis, polygon.hpp:121-150)."""
    n = normal / jnp.maximum(jnp.linalg.norm(normal, axis=-1, keepdims=True), 1e-12)
    # pick the axis least aligned with n
    ref = jnp.where(jnp.abs(n[..., 0:1]) < 0.9,
                    jnp.asarray([1.0, 0.0, 0.0], n.dtype),
                    jnp.asarray([0.0, 1.0, 0.0], n.dtype))
    u = jnp.cross(n, ref)
    u = u / jnp.maximum(jnp.linalg.norm(u, axis=-1, keepdims=True), 1e-12)
    v = jnp.cross(n, u)
    return u, v


def project_to_plane(points, center, u, v):
    """3D points -> 2D plane-local coordinates."""
    rel = points - center
    return jnp.stack([jnp.sum(rel * u, axis=-1), jnp.sum(rel * v, axis=-1)], axis=-1)


def unproject_from_plane(pts2, center, u, v):
    return center + pts2[..., 0:1] * u + pts2[..., 1:2] * v


def _convexify(verts, count):
    """True convex hull of the first ``count`` vertices, CCW-ordered.

    O(V^3) membership test with zero sequential dependencies: the
    directed edge i->j lies on the hull iff every other active point is on its
    left (cross >= -eps); a point is a hull vertex iff it has an outgoing hull
    edge.  Hull vertices are then angle-ordered around their own centroid.

    Returns (verts [V, 2], count) padded with verts[0]."""
    n = verts.shape[0]
    act = jnp.arange(n) < count
    d = verts[None, :, :] - verts[:, None, :]        # [i, j, 2] = pj - pi
    dn = jnp.sum(d * d, axis=-1)                     # [i, j]
    # drop duplicate points first (e.g. the shared corners of two merged
    # polygons): a later copy would otherwise create zero-length cycle edges
    # that _drop_flat_vertices removes BOTH endpoints of, losing hull area
    pair = act[:, None] & act[None, :]
    scale2 = jnp.max(jnp.where(pair, dn, 0.0))
    idx = jnp.arange(n)
    dup = pair & (dn <= 1e-10 * jnp.maximum(scale2, 1e-30)) \
        & (idx[:, None] > idx[None, :])
    act = act & ~jnp.any(dup, axis=1)
    cross = d[:, :, None, 0] * d[:, None, :, 1] \
        - d[:, :, None, 1] * d[:, None, :, 0]        # [i, j, k] = (pj-pi)x(pk-pi)
    eps = 1e-5 * jnp.sqrt(dn[:, :, None] * dn[:, None, :] + 1e-30)
    k_ok = ~act[None, None, :] | (cross >= -eps)
    edge = act[:, None] & act[None, :] & (dn > 1e-12) & jnp.all(k_ok, axis=-1)
    on_hull = jnp.any(edge, axis=1) & act

    hcnt = jnp.maximum(jnp.sum(on_hull), 1)
    centroid = jnp.sum(jnp.where(on_hull[:, None], verts, 0.0), axis=0) / hcnt
    rel = verts - centroid
    ang = jnp.where(on_hull, jnp.arctan2(rel[:, 1], rel[:, 0]), 1e9)
    order = jnp.argsort(ang)
    out = verts[order]
    out_cnt = jnp.sum(on_hull)
    out = jnp.where((jnp.arange(n) < out_cnt)[:, None], out, out[0])
    return _drop_flat_vertices(out, out_cnt)


def _drop_flat_vertices(verts, count, eps_rel=1e-4, iters=3):
    """Remove collinear and micro-concave vertices from an ordered cycle, keeping
    only strict corners (turn angle sin > eps_rel).

    This is load-bearing for numerical robustness, not just size: a vertex that
    is collinear up to f32 noise makes its two edge LINES nearly parallel to the
    boundary, and any half-plane clip against such a line (e.g. matching a plane
    polygon against itself next frame) computes intersection parameters as
    noise/noise — slicing large bogus slivers out of the exact intersection."""
    n = verts.shape[0]
    idx = jnp.arange(n)

    def one_pass(carry, _):
        verts, count = carry
        act = idx < count
        last = verts[jnp.clip(count - 1, 0, n - 1)]
        nxt = jnp.where((idx == count - 1)[:, None], verts[0][None],
                        jnp.roll(verts, -1, axis=0))
        prv = jnp.where((idx == 0)[:, None], last[None],
                        jnp.roll(verts, 1, axis=0))
        e1 = verts - prv
        e2 = nxt - verts
        cr = e1[:, 0] * e2[:, 1] - e1[:, 1] * e2[:, 0]
        l1l2 = jnp.sqrt(jnp.sum(e1 * e1, -1) * jnp.sum(e2 * e2, -1))
        keep = act & (cr > eps_rel * l1l2)
        newc = jnp.sum(keep)
        order = jnp.argsort(~keep, stable=True)
        out = verts[order]
        out = jnp.where((idx < newc)[:, None], out, out[0])
        return (out, newc), None

    (verts, count), _ = jax.lax.scan(one_pass, (verts, count), None, length=iters)
    return verts, count


def convex_hull_by_angle(pts2, mask, max_verts: int = MAX_VERTS):
    """Convex hull of masked 2D points, capped at ``max_verts`` vertices: angular
    decimation around the centroid (bounds the candidate count) followed by an
    exact parallel convex hull of the survivors.  Replaces the reference's
    concave-hull boundary fit (third_party concave_fitting, noted unreliable in
    its own README; convex-only is the SURVEY §7 sanctioned simplification) —
    and guarantees the module's convex-polygon invariant that the Green's-theorem
    intersection relies on.

    Returns (verts [max_verts, 2], count)."""
    n = pts2.shape[0]
    # prefilter: the hull feeds on boundary-cell points (<= region perimeter,
    # ~100 on the 24x32 cell grid), so for big inputs compact the masked points
    # to 128 candidates in raster order before the O(n log n) angular sort — the
    # sort+gathers at n=768 x 16 detections are wasted work otherwise
    cap = 128
    if n > cap:
        pri = jnp.where(mask, -jnp.arange(n, dtype=pts2.dtype), -jnp.inf)
        _, keep = jax.lax.top_k(pri, cap)
        pts2 = pts2[keep]
        mask = mask[keep]
        n = cap
    cnt = jnp.maximum(jnp.sum(mask), 1)
    centroid = jnp.sum(jnp.where(mask[:, None], pts2, 0.0), axis=0) / cnt
    rel = pts2 - centroid
    ang = jnp.arctan2(rel[:, 1], rel[:, 0])
    ang = jnp.where(mask, ang, 1e9)  # masked points sort last
    order = jnp.argsort(ang)
    sorted_pts = pts2[order]
    sorted_mask = mask[order]

    # keep all points when they fit, else decimate evenly over the valid prefix
    valid_n = jnp.sum(mask)
    count = jnp.minimum(valid_n, max_verts)
    idx = jnp.minimum((jnp.arange(max_verts) * jnp.maximum(valid_n, 1))
                      // jnp.maximum(count, 1), n - 1)
    verts = sorted_pts[idx]
    vmask = sorted_mask[idx] & (jnp.arange(max_verts) < count)
    verts = jnp.where(vmask[:, None], verts, verts[0])
    return _convexify(verts, count)


def polygon_area(verts, count):
    """Shoelace area of the first ``count`` vertices (assumed ordered)."""
    v = verts
    nxt = jnp.roll(v, -1, axis=0)
    idx = jnp.arange(v.shape[0])
    active = idx < count
    # the edge from vertex count-1 wraps to vertex 0
    nxt = jnp.where((idx == count - 1)[:, None], v[0], nxt)
    cross = v[:, 0] * nxt[:, 1] - nxt[:, 0] * v[:, 1]
    return 0.5 * jnp.abs(jnp.sum(jnp.where(active, cross, 0.0)))


def _edges(verts, count):
    """Directed edge list (start, end, active) with wraparound at ``count``."""
    n = verts.shape[0]
    idx = jnp.arange(n)
    nxt = jnp.roll(verts, -1, axis=0)
    nxt = jnp.where((idx == count - 1)[:, None], verts[0], nxt)
    return verts, nxt, idx < count


def _as_ccw(verts, count):
    """Reorder the first ``count`` vertices counter-clockwise (no-op if already)."""
    v, nxt, act = _edges(verts, count)
    signed = jnp.sum(jnp.where(act, v[:, 0] * nxt[:, 1] - v[:, 1] * nxt[:, 0], 0.0))
    n = verts.shape[0]
    idx = jnp.arange(n)
    ridx = jnp.where(idx < count, count - 1 - idx, idx)
    return jnp.where(signed >= 0, verts, verts[jnp.clip(ridx, 0, n - 1)])


def _clipped_boundary_integral(av, an, aact, bv, bn, bact, strict=False):
    """Green's-theorem contribution of A's edges clipped to the inside of convex
    CCW polygon B: each edge p0->p1 of A intersected with every half-plane of B
    gives a feasible t-interval in closed form; the surviving sub-segment [u, w]
    contributes cross(u, w)/2 to the boundary integral.  Fully parallel over the
    [n_a, n_b] edge-pair grid — no sequential clipping.

    ``strict=True`` treats lying exactly ON a B edge line as outside — used for
    the second pass so collinear shared boundary segments are counted once."""
    d = an - av                                       # [n, 2]
    eb = bn - bv                                      # [m, 2]
    rel = av[:, None, :] - bv[None, :, :]             # [n, m, 2]
    # inside(B, p) per CCW edge j: cross(eb_j, p - bv_j) >= 0, affine in t:
    alpha = eb[None, :, 0] * rel[..., 1] - eb[None, :, 1] * rel[..., 0]
    beta = eb[None, :, 0] * d[:, None, 1] - eb[None, :, 1] * d[:, None, 0]
    # noise-robust classification: alpha/beta are cross products in area units,
    # so thresholds scale with the participating lengths.  A near-parallel edge
    # pair (|sin| < 1e-4) must NOT clip via t = -alpha/beta: both quantities are
    # f32 rounding noise there and the quotient slices bogus slivers.
    ebn = jnp.sqrt(jnp.sum(eb * eb, axis=-1))         # [m]
    dn = jnp.sqrt(jnp.sum(d * d, axis=-1))            # [n]
    reln = jnp.sqrt(jnp.sum(rel * rel, axis=-1))      # [n, m]
    par = jnp.abs(beta) <= 1e-4 * ebn[None, :] * dn[:, None] + 1e-30
    tol_a = 1e-4 * ebn[None, :] * (reln + dn[:, None]) + 1e-30
    pos = ~par & (beta > 0)
    neg = ~par & (beta < 0)
    lo_j = jnp.where(pos, -alpha / jnp.where(pos, beta, 1.0), -jnp.inf)
    hi_j = jnp.where(neg, -alpha / jnp.where(neg, beta, 1.0), jnp.inf)
    # parallel constraint: always satisfied or never; lying ON the line counts
    # as inside only for the non-strict pass (shared collinear boundary is then
    # integrated exactly once across the two passes)
    inside_par = (alpha > tol_a) if strict else (alpha >= -tol_a)
    hi_j = jnp.where(par & ~inside_par, -jnp.inf, hi_j)
    lo_j = jnp.where(bact[None, :], lo_j, -jnp.inf)
    hi_j = jnp.where(bact[None, :], hi_j, jnp.inf)
    t_lo = jnp.clip(jnp.max(lo_j, axis=1), 0.0, 1.0)
    t_hi = jnp.clip(jnp.min(hi_j, axis=1), 0.0, 1.0)
    ok = aact & (t_hi > t_lo)
    u = av + t_lo[:, None] * d
    w = av + t_hi[:, None] * d
    contrib = 0.5 * (u[:, 0] * w[:, 1] - u[:, 1] * w[:, 0])
    return jnp.sum(jnp.where(ok, contrib, 0.0))


def convex_intersection_area(verts_a, count_a, verts_b, count_b):
    """Exact area of the intersection of two convex polygons.

    Design: the boundary of A∩B consists of sub-segments of A's edges
    inside B plus sub-segments of B's edges inside A, each computable independently
    by interval-clipping against the other polygon's half-planes; Green's theorem
    sums their cross-product contributions to the exact area.  O(n·m) elementwise
    work with zero sequential dependencies (replaces the Sutherland-Hodgman
    fori_loop, which serialized ~n·m tiny ops on device)."""
    va = _as_ccw(verts_a, count_a)
    vb = _as_ccw(verts_b, count_b)
    av, an, aact = _edges(va, count_a)
    bv, bn, bact = _edges(vb, count_b)
    area = _clipped_boundary_integral(av, an, aact, bv, bn, bact) \
        + _clipped_boundary_integral(bv, bn, bact, av, an, aact, strict=True)
    valid = (count_a >= 3) & (count_b >= 3)
    return jnp.where(valid, jnp.maximum(area, 0.0), 0.0)


def polygon_iou(verts_a, count_a, verts_b, count_b):
    """Inter-over-union of two convex polygons (reference: Polygon::inter_over_union,
    polygon.cpp:463-576, used by the plane-match gate, map_primitive.cpp:91-161)."""
    inter = convex_intersection_area(verts_a, count_a, verts_b, count_b)
    area_a = polygon_area(verts_a, count_a)
    area_b = polygon_area(verts_b, count_b)
    union = area_a + area_b - inter
    return jnp.where(union > 1e-9, inter / jnp.maximum(union, 1e-9), 0.0)


def inter_over_area(verts_a, count_a, verts_b, count_b):
    """Intersection over the smaller polygon's area (the reference's
    ``minimumPlaneOverlapToConsiderMatch`` semantics, parameters.hpp:91-92)."""
    inter = convex_intersection_area(verts_a, count_a, verts_b, count_b)
    area = jnp.minimum(polygon_area(verts_a, count_a), polygon_area(verts_b, count_b))
    return jnp.where(area > 1e-9, inter / jnp.maximum(area, 1e-9), 0.0)


def merge_polygons(verts_a, count_a, verts_b, count_b, max_verts: int = MAX_VERTS):
    """Union-merge: star-shaped re-hull of the combined vertex sets (reference:
    Polygon::merge/union keeping the largest component, polygon.cpp:463-576;
    plane_with_tracking.cpp:16-79 merges boundary polygons on track)."""
    all_pts = jnp.concatenate([verts_a, verts_b], axis=0)
    mask = jnp.concatenate([
        jnp.arange(verts_a.shape[0]) < count_a,
        jnp.arange(verts_b.shape[0]) < count_b])
    return convex_hull_by_angle(all_pts, mask, max_verts)

"""CAPE-style plane & cylinder extraction from the cell-organized depth cloud.

Redesign of reference src/features/primitives/ (plane_segment.cpp,
primitive_detection.cpp, cylinder_segment.cpp, histogram.hpp):

* per-cell plane fits: ONE batched moment computation + batched 3x3 eigh over all
  cells (replaces the sequential init_planar_cell_fitting loop,
  primitive_detection.cpp:187-237).  Moments are stored CENTERED (count, mean, M2)
  and combined with Chan's parallel-axis rule — additive like the reference's raw-sum
  ``expand_segment`` (plane_segment.cpp:170-190) but stable in f32 (see moments.py);
* region growing: the reference's recursive chained merge test
  (primitive_detection.cpp:778-818) is *pairwise between adjacent cells* — the merge
  decision compares the previously accepted cell's patch with the candidate cell — so
  mergeability becomes 4 precomputed directed edge maps and each seed's growth is
  masked label propagation to a fixpoint (`lax.while_loop`), no recursion;
* the seed loop (histogram most-frequent-bin -> min-MSE seed -> grow -> fit,
  primitive_detection.cpp:267-390) stays sequential but bounded (`lax.scan` over a
  static seed budget) — plane counts per frame are small;
* plane merging (primitive_detection.cpp:503-560) uses the cell-map adjacency matrix
  and pairwise moment combination;
* boundary polygons: cross-erode/square-dilate mask difference, cell-center points
  within 3 sqrt(MSE) of the plane (primitive_detection.cpp:650-703), star-hulled in
  the plane basis (convex stand-in for the unreliable concave hull, SURVEY.md §7).
"""

from __future__ import annotations

import math
from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..config import CameraIntrinsics, DetectionConfig
from ..geometry.covariances import get_depth_quantization
from ..ops.depth_cloud import depth_to_cloud
from ..utils import polygon as poly
from . import moments

MAX_PLANES = 16
MAX_CYLINDERS = 4
HIST_BINS = 20  # reference: Histogram<20>, histogram.hpp:20-133


class CellGrid(NamedTuple):
    """Per-cell plane-fit state, [C] leading axis (gh*gw cells row-major)."""
    count: jnp.ndarray       # [C] valid point count
    mean: jnp.ndarray        # [C, 3] centroid
    m2: jnp.ndarray          # [C, 3, 3] centered second moment
    normal: jnp.ndarray      # [C, 3]
    d: jnp.ndarray           # [C]
    mse: jnp.ndarray         # [C]
    score: jnp.ndarray       # [C]
    planar: jnp.ndarray      # [C] bool
    distance_tol: jnp.ndarray  # [C]


class DetectedPlanes(NamedTuple):
    params: jnp.ndarray      # [MAX_PLANES, 4] camera-space hessian [n, d]
    centroid: jnp.ndarray    # [MAX_PLANES, 3]
    mse: jnp.ndarray         # [MAX_PLANES]
    point_count: jnp.ndarray # [MAX_PLANES]
    cloud_cov: jnp.ndarray   # [MAX_PLANES, 3, 3] inverse raw moment matrix
    poly_verts: jnp.ndarray  # [MAX_PLANES, V, 2] plane-basis boundary polygon
    poly_count: jnp.ndarray  # [MAX_PLANES]
    basis_center: jnp.ndarray  # [MAX_PLANES, 3]
    basis_u: jnp.ndarray     # [MAX_PLANES, 3]
    basis_v: jnp.ndarray     # [MAX_PLANES, 3]
    cell_mask: jnp.ndarray   # [MAX_PLANES, C]
    valid: jnp.ndarray       # [MAX_PLANES] bool


class DetectedCylinders(NamedTuple):
    axis: jnp.ndarray        # [MAX_CYLINDERS, 3]
    center: jnp.ndarray      # [MAX_CYLINDERS, 3] point on axis
    radius: jnp.ndarray      # [MAX_CYLINDERS]
    mse: jnp.ndarray         # [MAX_CYLINDERS]
    cell_mask: jnp.ndarray   # [MAX_CYLINDERS, C] inlier cells of the sub-segment
    valid: jnp.ndarray       # [MAX_CYLINDERS] bool


# ---------------------------------------------------------------------------
# per-cell fitting
# ---------------------------------------------------------------------------

def fit_plane_from_moments(cnt, mean, m2):
    """Closed-form eigen plane fit from centered moments (reference:
    Plane_Segment::fit_plane, plane_segment.cpp:232-284).  Batched.

    Returns (normal, d, centroid, mse, score, ok)."""
    from ..geometry.eig3 import sym_eig3_smallest

    safe = jnp.maximum(cnt, 1.0)
    cov = 0.5 * (m2 + jnp.swapaxes(m2, -1, -2))

    eigvals, normal = sym_eig3_smallest(cov)
    eigvals = jnp.abs(eigvals)  # ascending
    d = -jnp.sum(normal * mean, axis=-1)
    # orient normal toward the camera (d > 0), plane_segment.cpp:268-273
    flip = d <= 0
    normal = jnp.where(flip[..., None], -normal, normal)
    d = jnp.where(flip, -d, d)

    mse = eigvals[..., 0] / safe
    score = eigvals[..., 1] / jnp.maximum(eigvals[..., 0], 1e-6)
    ok = (cnt > 0) & jnp.all(jnp.isfinite(normal), axis=-1)
    return normal, d, mean, mse, score, ok


def fit_cells(cloud, valid, cfg: DetectionConfig = DetectionConfig()) -> CellGrid:
    """Batched plane fit of every depth-patch cell (reference:
    Plane_Segment::init_plane_segment, plane_segment.cpp:102-167).

    Moments come from BLOCK-VIEW reductions over ``[gh, patch, gw, patch]``
    reshapes of the dense cloud — no materialized cell reorder (the old
    ``organize_by_cells`` transpose was pure copies;
    depth_cloud.py keeps it for callers that need the per-cell point list)."""
    patch = cfg.depth_patch_size_px
    h, w = cloud.shape[:2]
    gh, gw = h // patch, w // patch
    c = gh * gw
    ppc = patch * patch
    dt = cloud.dtype

    blocks = cloud.reshape(gh, patch, gw, patch, 3)
    wts = valid.astype(dt).reshape(gh, patch, gw, patch)

    # continuity test on each cell's middle row/column, sliced from the dense
    # depth channel (is_cell_horizontal/vertical_continuous,
    # plane_segment.cpp:62-100)
    mid = patch // 2
    z = cloud[..., 2]
    row_lines = z[mid::patch, :].reshape(gh, 1, gw, patch) \
        .transpose(0, 2, 1, 3).reshape(c, 1, patch)
    col_lines = z[:, mid::patch].reshape(gh, patch, gw, 1) \
        .transpose(0, 2, 3, 1).reshape(c, 1, patch)

    def line_continuous(line):
        prev = line[:, :, :-1]
        nxt = line[:, :, 1:]
        both = (prev > 0) & (nxt > 0)
        jump = jnp.abs(nxt - prev) \
            > 4.0 * get_depth_quantization(jnp.maximum(nxt, 1.0))
        return ~jnp.any(both & jump, axis=(-1, -2))

    continuous = line_continuous(row_lines) & line_continuous(col_lines)

    cnt = jnp.sum(wts, axis=(1, 3)).reshape(c)
    safe = jnp.maximum(cnt, 1.0)
    sum_p = jnp.stack([jnp.sum(wts * blocks[..., i], axis=(1, 3))
                       for i in range(3)], -1).reshape(c, 3)
    mean = sum_p / safe[:, None]
    # M2 as 6 symmetric channel products, each one dense [H, W]-shaped
    # multiply + block reduction (a single 5-axis einsum here lowered to a
    # slow streaming contraction; the channel form fuses cleanly)
    mb = mean.reshape(gh, 1, gw, 1, 3)
    dev = [wts * (blocks[..., i] - mb[..., i]) for i in range(3)]
    raw = [blocks[..., i] - mb[..., i] for i in range(3)]
    cols = []
    for i in range(3):
        row = [None, None, None]
        for j in range(3):
            if j < i:
                row[j] = cols[j][i]
            else:
                row[j] = jnp.sum(dev[i] * raw[j], axis=(1, 3)).reshape(c)
        cols.append(row)
    m2 = jnp.stack([jnp.stack(r, -1) for r in cols], -2)

    min_points = int(ppc * cfg.min_zero_depth_proportion)
    enough = (cnt >= min_points) & (cnt >= ppc // 2)

    normal, d, centroid, mse, score, fit_ok = fit_plane_from_moments(cnt, mean, m2)

    # planar iff MSE below squared depth quantization (plane_segment.cpp:164-167)
    planar = continuous & enough & fit_ok \
        & (mse <= get_depth_quantization(jnp.abs(centroid[..., 2])) ** 2)

    # dynamic per-cell merge distance tolerance (primitive_detection.cpp:210-227)
    sin_merge = math.sin(math.radians(cfg.max_plane_merge_angle_d))
    corner0 = cloud[::patch, ::patch].reshape(c, 3)
    corner1 = cloud[patch - 1::patch, patch - 1::patch].reshape(c, 3)
    diameter = jnp.linalg.norm(corner1 - corner0, axis=-1)
    tol = jnp.minimum(cfg.max_plane_merge_distance_mm,
                      diameter * sin_merge * jnp.sqrt(jnp.maximum(cnt, 1.0)))
    tol = jnp.where(planar, tol, 0.0)

    return CellGrid(count=cnt, mean=mean, m2=m2, normal=normal, d=d,
                    mse=mse, score=score, planar=planar, distance_tol=tol)


# ---------------------------------------------------------------------------
# mergeability edges + label propagation
# ---------------------------------------------------------------------------

def _edge_maps(grid: CellGrid, gh: int, gw: int, cos_max: float):
    """Directed mergeability edges: edge[dir][y, x] = True when the neighbor in that
    direction may grow into cell (y, x) (reference merge test:
    Plane_Segment::can_be_merged, plane_segment.cpp:322-326, applied along the
    region-growing chain, primitive_detection.cpp:778-818)."""
    n = grid.normal.reshape(gh, gw, 3)
    d = grid.d.reshape(gh, gw)
    cen = grid.mean.reshape(gh, gw, 3)
    tol = grid.distance_tol.reshape(gh, gw)
    planar = grid.planar.reshape(gh, gw)

    edges = []
    for dy, dx in ((0, 1), (0, -1), (1, 0), (-1, 0)):
        n_from = jnp.roll(n, (dy, dx), axis=(0, 1))
        d_from = jnp.roll(d, (dy, dx), axis=(0, 1))
        p_from = jnp.roll(planar, (dy, dx), axis=(0, 1))
        cos_ab = jnp.sum(n_from * n, axis=-1)
        dist = jnp.abs(jnp.sum(n_from * cen, axis=-1) + d_from)
        e = (cos_ab > cos_max) & (dist < tol) & planar & p_from
        if dx == 1:
            e = e.at[:, 0].set(False)
        if dx == -1:
            e = e.at[:, -1].set(False)
        if dy == 1:
            e = e.at[0, :].set(False)
        if dy == -1:
            e = e.at[-1, :].set(False)
        edges.append(e)
    return jnp.stack(edges)  # [4, gh, gw]


def _connected_components(edges, planar, gh: int, gw: int):
    """Connected components of the planar-cell mergeability graph as min-label
    propagation with pointer-jumping shortcuts.

    The reference grows each histogram seed recursively through pairwise merge
    tests (primitive_detection.cpp:778-818); the set a seed reaches is exactly its
    connected component under those (symmetrized) edge tests, so one fixpoint over
    the whole grid replaces every per-seed flood fill.  Returns [C] int32 labels
    (component = min member cell index; non-planar cells get the sentinel C)."""
    c = gh * gw
    planar2 = planar.reshape(gh, gw)
    # symmetric connectivity: growable in either direction across the shared edge
    sym_l = (edges[0] | jnp.roll(edges[1], 1, axis=1)).at[:, 0].set(False)
    sym_u = (edges[2] | jnp.roll(edges[3], 1, axis=0)).at[0, :].set(False)
    sym_r = jnp.roll(sym_l, -1, axis=1).at[:, -1].set(False)
    sym_d = jnp.roll(sym_u, -1, axis=0).at[-1, :].set(False)

    big = jnp.asarray(c, jnp.int32)
    lbl0 = jnp.where(planar2, jnp.arange(c, dtype=jnp.int32).reshape(gh, gw), big)

    def prop(lbl):
        nb = jnp.minimum(
            jnp.minimum(jnp.where(sym_l, jnp.roll(lbl, 1, axis=1), big),
                        jnp.where(sym_r, jnp.roll(lbl, -1, axis=1), big)),
            jnp.minimum(jnp.where(sym_u, jnp.roll(lbl, 1, axis=0), big),
                        jnp.where(sym_d, jnp.roll(lbl, -1, axis=0), big)))
        return jnp.where(planar2, jnp.minimum(lbl, nb), big)

    def body(state):
        lbl, _ = state
        new = prop(prop(lbl))
        # pointer jumping: labels are cell indices, so a cell may adopt its
        # label's own label (reachability is transitive) — turns O(diameter)
        # convergence into O(log diameter)
        flat = jnp.concatenate([new.reshape(-1), big[None]])
        new = jnp.minimum(new, flat[new.reshape(-1)].reshape(gh, gw))
        new = jnp.minimum(new, flat[new.reshape(-1)].reshape(gh, gw))
        return new, jnp.any(new != lbl)

    lbl, _ = jax.lax.while_loop(lambda s: s[1], body, (lbl0, jnp.asarray(True)))
    return lbl.reshape(-1)


def _normal_bins(normals):
    """Polar-angle histogram bin of each normal (reference: Histogram<20> binning
    over (acos(-nz), atan2(nx, ny)), histogram.hpp:35-122)."""
    nx, ny, nz = normals[..., 0], normals[..., 1], normals[..., 2]
    proj = jnp.arccos(jnp.clip(-nz, -1.0, 1.0))
    ang = jnp.arctan2(nx, ny)
    bx = jnp.clip((proj / jnp.pi * HIST_BINS).astype(jnp.int32), 0, HIST_BINS - 1)
    by = jnp.clip(((ang + jnp.pi) / (2 * jnp.pi) * HIST_BINS).astype(jnp.int32),
                  0, HIST_BINS - 1)
    return bx * HIST_BINS + by


# ---------------------------------------------------------------------------
# cylinder fitting: sequential sub-segment MSAC (cylinder_segment.cpp:35-322)
# ---------------------------------------------------------------------------

#: sub-segments extracted per grown region (the reference's while loop peels
#: inlier sets until too few cells remain, cylinder_segment.cpp:144-147; real
#: scenes rarely produce more than a couple per region)
CYL_SUBSEGMENTS = 3


def _msac_iterations(cfg: DetectionConfig) -> int:
    """RANSAC iteration count from the inlier-proportion formula
    (cylinder_segment.cpp:130-135)."""
    num = math.log(1.0 - cfg.cylinder_ransac_probability_of_success)
    den = math.log(1.0 - cfg.cylinder_ransac_inlier_proportion ** 3)
    return max(1, int(num / den))


def _cylinder_axis(grid: CellGrid, active, cfg: DetectionConfig):
    """Cheap per-region axis estimate + acceptance score (reference:
    cylinder_segment.cpp:47-105): smallest-eigenvector PCA of [normals,
    -normals] — same covariance direction structure as the normals alone, so
    one weighted outer-product sum suffices — gated by
    lambda_max/lambda_min >= cylinderRansacMinimumScore."""
    dt = grid.normal.dtype
    w0 = (active & grid.planar).astype(dt)
    cnt0 = jnp.sum(w0)
    from ..geometry.eig3 import sym_eig3_smallest

    nn = jnp.einsum("c,ci,cj->ij", w0, grid.normal, grid.normal)
    eigvals, axis = sym_eig3_smallest(nn)         # ascending values
    score = eigvals[2] / jnp.maximum(eigvals[0], 1e-12)
    axis_ok = (score >= cfg.cylinder_ransac_min_score) & (cnt0 >= 3)
    return axis, axis_ok


def _fit_cylinder(grid: CellGrid, active, axis, axis_ok, cfg: DetectionConfig,
                  min_activated: int):
    """Multi-sub-segment cylinder fit over the activated cells (reference:
    Cylinder_Segment ctor, cylinder_segment.cpp:35-225).

    Parity path: centroids/normals projected to the axis-orthogonal plane
    (:107-125); then a SEQUENTIAL sub-segment loop — each round runs a
    truncated-relative-distance MSAC over random cell triplets with the
    closed-form LLS cylinder solution (:242-322), refits radius/center on the
    inliers (:160-185), records the sub-segment MSE (point-to-axis distance
    minus radius, :195-215) and removes the inliers from the remaining set
    (:143-159).  The reference's sequential triplet draws become a lockstep
    batch of deterministically scrambled triplets (determinism parity with
    MAKE_DETERMINISTIC seeding).

    Returns per-sub-segment arrays: (center [S, 3], radius [S], mse [S],
    valid [S], inliers [S, C])."""
    dt = grid.normal.dtype
    planar_active = active & grid.planar
    cnt0 = jnp.sum(planar_active.astype(dt))

    # project centroids and normals to the axis-orthogonal plane (3D form)
    cdot = grid.mean @ axis
    proj_c = grid.mean - cdot[:, None] * axis[None]
    ndot = grid.normal @ axis
    proj_n = grid.normal - ndot[:, None] * axis[None]
    proj_n = proj_n / jnp.maximum(
        jnp.linalg.norm(proj_n, axis=-1, keepdims=True), 1e-9)

    nc = grid.mean.shape[0]
    n_hyp = _msac_iterations(cfg)
    trunc = cfg.cylinder_ransac_sqrt_max_distance
    s = CYL_SUBSEGMENTS

    def lls_cylinder(sum_n, sum_c, sum_nc, k):
        """Closed-form LLS cylinder from sums over a cell set
        (cylinder_segment.cpp:160-190 / :263-274): a = 1 - |sum_n|^2/k^2,
        b = sum(n.c)/k - (sum_n . sum_c)/k^2, radius = b/a."""
        inv_k = 1.0 / jnp.maximum(k, 1.0)
        a = 1.0 - jnp.sum(sum_n * sum_n) * inv_k * inv_k
        b = sum_nc * inv_k - jnp.sum(sum_n * sum_c) * inv_k * inv_k
        radius = b / jnp.where(jnp.abs(a) < 1e-9, 1e-9, a)
        center = (sum_c - radius * sum_n) * inv_k
        return radius, center

    remaining = planar_active & axis_ok
    centers, radii, mses, valids, inlier_masks = [], [], [], [], []
    for si in range(s):
        rw = remaining.astype(dt)
        n_left = jnp.sum(rw)
        # while-loop condition (cylinder_segment.cpp:144-147)
        round_ok = axis_ok & (n_left > min_activated) & (n_left > 0.1 * cnt0) \
            & (n_left >= 3)

        # deterministic scrambled triplets over the compacted remaining set
        rank = jnp.cumsum(remaining.astype(jnp.int32)) - 1
        na = jnp.maximum(jnp.sum(remaining.astype(jnp.int32)), 1)
        compact = jnp.zeros((nc,), jnp.int32).at[
            jnp.where(remaining, rank, nc)].set(
            jnp.arange(nc, dtype=jnp.int32), mode="drop")
        tri = ((jnp.arange(n_hyp * 3, dtype=jnp.uint32).reshape(n_hyp, 3)
                + jnp.uint32(si * 7919))
               * jnp.uint32(2654435761)) % na.astype(jnp.uint32)
        tri_idx = compact[tri.astype(jnp.int32)]          # [B, 3]

        tn = proj_n[tri_idx]                              # [B, 3, 3]
        tc = proj_c[tri_idx]
        sum_n = jnp.sum(tn, axis=1)
        sum_c = jnp.sum(tc, axis=1)
        sum_nc = jnp.sum(tn * tc, axis=(1, 2))
        radius_h, center_h = jax.vmap(lls_cylinder)(
            sum_n, sum_c, sum_nc, jnp.full((n_hyp,), 3.0, dt))

        # truncated RELATIVE distance (cylinder_segment.cpp:283-299):
        # |(c_i - r n_i) - center|^2 / r^2, truncated at sqrtMaxDistance.
        # Expanded form: the cell-vs-hypothesis cross terms are two [C,3]@[3,B]
        # matmuls instead of a materialized [B, C, 3] intermediate
        cc = jnp.sum(proj_c * proj_c, axis=-1)            # [C]
        cn = jnp.sum(proj_c * proj_n, axis=-1)            # [C]
        c_dot = proj_c @ center_h.T                       # [C, B]
        n_dot = proj_n @ center_h.T                       # [C, B]
        r_ = radius_h[:, None]
        d2 = (cc[None, :] - 2.0 * r_ * cn[None, :] + r_ * r_
              - 2.0 * c_dot.T + 2.0 * r_ * n_dot.T
              + jnp.sum(center_h * center_h, axis=-1)[:, None]) \
            / jnp.maximum(r_ * r_, 1e-12)
        msac = jnp.sum(rw[None] * jnp.minimum(d2, trunc), axis=-1)
        best = jnp.argmin(msac)

        inliers = remaining & (d2[best] < trunc)
        k = jnp.sum(inliers.astype(dt))
        seg_ok = round_ok & (k >= 6)                      # checkpoint 2, :156

        # LLS refit on all inliers (:160-190)
        iw = inliers.astype(dt)
        radius, center = lls_cylinder(
            jnp.sum(proj_n * iw[:, None], axis=0),
            jnp.sum(proj_c * iw[:, None], axis=0),
            jnp.sum(proj_n * proj_c * iw[:, None]), k)
        radius = jnp.abs(radius)                          # concave rectify, :191

        # MSE: squared (point-to-axis-line distance - radius) over inliers
        rel = grid.mean - center[None]
        perp = rel - (rel @ axis)[:, None] * axis[None]
        dist = jnp.linalg.norm(perp, axis=-1) - radius
        mse = jnp.sum(iw * dist * dist) / jnp.maximum(k, 1.0)

        centers.append(center)
        radii.append(radius)
        mses.append(jnp.where(seg_ok, mse, jnp.inf))
        valids.append(seg_ok)
        inlier_masks.append(inliers & seg_ok)
        remaining = remaining & ~(inliers & seg_ok)

    return (jnp.stack(centers), jnp.stack(radii), jnp.stack(mses),
            jnp.stack(valids), jnp.stack(inlier_masks))


# ---------------------------------------------------------------------------
# main pipeline
# ---------------------------------------------------------------------------

@partial(jax.jit, static_argnames=("cam", "cfg"))
def find_primitives(depth_mm, cam: CameraIntrinsics,
                    cfg: DetectionConfig = DetectionConfig()):
    """Full CAPE extraction for one frame (reference:
    Primitive_Detection::find_primitives, primitive_detection.cpp:119-166).

    Returns (DetectedPlanes, DetectedCylinders)."""
    patch = cfg.depth_patch_size_px
    h, w = depth_mm.shape
    gh, gw = h // patch, w // patch
    n_cells = gh * gw
    dt = depth_mm.dtype

    cloud, valid = depth_to_cloud(depth_mm, cam)
    grid = fit_cells(cloud, valid, cfg)
    cos_max = math.cos(math.radians(cfg.max_plane_merge_angle_d))
    edges = _edge_maps(grid, gh, gw, cos_max)

    seed_threshold = max(1, int(cfg.min_plane_seed_proportion * n_cells))
    min_activated = max(1, int(cfg.min_cell_activated_proportion * n_cells))

    # --- all grown regions at once: connected components of the mergeability
    # graph (replaces the reference's sequential histogram-seed loop,
    # primitive_detection.cpp:267-390 — each seed grows to exactly its component,
    # so the K largest components ARE the seed loop's outputs, batched)
    comp = _connected_components(edges, grid.planar, gh, gw)      # [C]
    sizes = jax.ops.segment_sum(grid.planar.astype(jnp.int32), comp,
                                num_segments=n_cells + 1)[:n_cells]
    k_cand = MAX_PLANES + MAX_CYLINDERS
    cand_sizes, cand_roots = jax.lax.top_k(sizes, k_cand)          # [K]
    member = (comp[None, :] == cand_roots[:, None]) & (cand_sizes[:, None] > 0)

    cnt, mean, m2 = jax.vmap(
        lambda msk: moments.combine(grid.count, grid.mean, grid.m2, msk))(member)
    normal, d, centroid, mse, score, fit_ok = fit_plane_from_moments(cnt, mean, m2)

    # histogram seed gate (parity with the top-bin >= seedCount loop condition,
    # primitive_detection.cpp:278): the reference seeds a region from its most
    # populated orientation bin, so a region is seedable iff SOME bin among its
    # OWN member cells holds >= seed_threshold planar cells (gating on the
    # region's fitted normal breaks for curved regions whose average normal
    # matches no actual cell).  One [K, C] @ [C, bins] one-hot matmul.
    bins = _normal_bins(grid.normal)
    onehot = (bins[:, None] == jnp.arange(HIST_BINS * HIST_BINS)[None, :]) \
        & grid.planar[:, None]
    member_bin_counts = member.astype(dt) @ onehot.astype(dt)   # [K, bins]
    bin_gate = jnp.max(member_bin_counts, axis=-1) >= seed_threshold

    grown_ok = (cand_sizes >= min_activated) & bin_gate & fit_ok

    # plane-vs-cylinder model choice (primitive_detection.cpp:375-388)
    is_plane = grown_ok & (score > 100.0)
    try_cyl = grown_ok & ~is_plane & (cand_sizes > 5)
    # cheap axis/score gate on every region (cylinder_segment.cpp:97-101), then
    # the expensive sub-segment MSAC runs only on the few gated regions,
    # compacted to MAX_CYLINDERS region slots
    cy_axis, axis_ok = jax.vmap(
        lambda msk: _cylinder_axis(grid, msk, cfg))(member)
    cyl_cand = try_cyl & axis_ok
    r_rank = jnp.cumsum(cyl_cand.astype(jnp.int32)) - 1
    r_sel = cyl_cand & (r_rank < MAX_CYLINDERS)
    region_idx = jnp.zeros((MAX_CYLINDERS,), jnp.int32).at[
        jnp.where(r_sel, r_rank, MAX_CYLINDERS)].set(
        jnp.arange(k_cand, dtype=jnp.int32), mode="drop")
    region_live = jnp.arange(MAX_CYLINDERS) < jnp.sum(r_sel.astype(jnp.int32))
    sel_centers, sel_radii, sel_mses, sel_valids, sel_inliers = jax.vmap(
        lambda msk, ax, ok: _fit_cylinder(grid, msk, ax, ok, cfg,
                                          min_activated))(
        member[region_idx], cy_axis[region_idx], region_live)
    # route sub-segment results back to the full region index space via a
    # one-hot [k_cand, slots] matmul (see compact_to for why not a scatter)
    s_ = CYL_SUBSEGMENTS
    tgt = jnp.where(region_live, region_idx, k_cand)
    r_onehot = (tgt[None, :] == jnp.arange(k_cand)[:, None]).astype(dt)
    row_has = jnp.sum(r_onehot, axis=-1) > 0
    cy_centers = (r_onehot @ sel_centers.reshape(MAX_CYLINDERS, -1)) \
        .reshape(k_cand, s_, 3)
    cy_radii = r_onehot @ sel_radii
    cy_valids = (r_onehot @ sel_valids.astype(dt)) > 0.5
    # inf-valued invalid MSEs would turn 0*inf into NaN inside the matmul
    cy_mses = jnp.where(cy_valids,
                        r_onehot @ jnp.where(jnp.isfinite(sel_mses),
                                             sel_mses, 0.0), jnp.inf)
    cy_inliers = ((r_onehot @ sel_inliers.reshape(MAX_CYLINDERS, -1)
                   .astype(dt)) > 0.5).reshape(k_cand, s_, n_cells)
    # PER-SUB-SEGMENT model choice (primitive_detection.cpp:437-476): each
    # sub-segment compares its cylinder MSE against the region's merged-plane
    # MSE; plane-winning sub-segments re-enter the plane list (the reference
    # pushes newMergedPlane per winning sub-segment)
    seg_cyl_better = try_cyl[:, None] & cy_valids & (cy_mses < mse[:, None])
    seg_plane_better = try_cyl[:, None] & cy_valids & ~(cy_mses < mse[:, None])
    seg_flat = seg_cyl_better.reshape(-1)
    # cylinder slots are finite: overflow sub-segments (and overflow candidate
    # regions beyond the MSAC slots) fall back to the plane model rather than
    # being dropped (the reference has no slot cap)
    cyl_rank = jnp.cumsum(seg_flat.astype(jnp.int32)) - 1
    overflow = seg_flat & (cyl_rank >= MAX_CYLINDERS)
    seg_flat = seg_flat & ~overflow
    accept_plane = is_plane | jnp.any(seg_plane_better, axis=1) \
        | jnp.any(overflow.reshape(k_cand, CYL_SUBSEGMENTS), axis=1) \
        | (cyl_cand & ~r_sel)

    def compact_to(cap, accept, *arrays):
        """Gather accepted candidates (size-ranked) into the first ``cap`` slots.

        Implemented as a one-hot [cap, n] selection matmul rather than a scatter
        with an out-of-bounds sentinel: a backend once mis-lowered OOB-dropped
        scatters for power-of-two caps with >128-element rows (indices wrapped
        mod cap instead of dropping), and the matmul is exact anyway."""
        rank = jnp.cumsum(accept.astype(jnp.int32)) - 1
        dest = jnp.where(accept & (rank < cap), rank, cap)
        num = jnp.minimum(jnp.sum(accept.astype(jnp.int32)), cap)
        onehot = (dest[None, :] == jnp.arange(cap)[:, None]).astype(dt)  # [cap,n]
        row_has = (jnp.sum(onehot, axis=-1) > 0)
        outs = []
        for a, fill in arrays:
            n_src = a.shape[0]
            flat = a.reshape(n_src, -1).astype(dt)
            # zero non-accepted rows: 0 * inf (e.g. invalid MSEs) would NaN
            flat = jnp.where(accept[:, None], flat, 0.0)
            picked = onehot @ flat                      # [cap, prod(rest)]
            out = jnp.where(row_has[:, None], picked,
                            jnp.asarray(fill, dt)).reshape((cap,) + a.shape[1:])
            outs.append(out.astype(a.dtype) if a.dtype != bool
                        else (out > 0.5))
        return num, outs

    p_num, (p_cnt, p_mean, p_m2, p_cellmask) = compact_to(
        MAX_PLANES, accept_plane,
        (cnt, 0), (mean, 0), (m2, 0), (member, False))
    ks = k_cand * CYL_SUBSEGMENTS
    axis_flat = jnp.broadcast_to(cy_axis[:, None, :],
                                 (k_cand, CYL_SUBSEGMENTS, 3)).reshape(ks, 3)
    c_num, (c_axis, c_center, c_radius, c_mse, c_cells) = compact_to(
        MAX_CYLINDERS, seg_flat,
        (axis_flat, 0), (cy_centers.reshape(ks, 3), 0),
        (cy_radii.reshape(ks), 0), (cy_mses.reshape(ks), jnp.inf),
        (cy_inliers.reshape(ks, n_cells), False))

    plane_valid = jnp.arange(MAX_PLANES) < p_num

    p_cnt, p_mean, p_m2, p_cellmask, plane_valid = _merge_planes(
        p_cnt, p_mean, p_m2, p_cellmask, plane_valid, gh, gw, cos_max,
        cfg.max_plane_merge_distance_mm)

    normal, d, centroid, mse, score, fit_ok = fit_plane_from_moments(
        p_cnt, p_mean, p_m2)
    plane_valid = plane_valid & fit_ok
    params = jnp.concatenate([normal, d[..., None]], axis=-1)

    # plane-parameter covariance source: inverse raw moment matrix
    # (Plane_Segment::get_point_cloud_covariance, plane_segment.cpp:192-203),
    # norm-scaled before inversion for f32 conditioning
    from ..pose.linalg6 import solve_spd

    raw = moments.raw_second_moment(p_cnt, p_mean, p_m2)
    scale = jnp.maximum(jnp.linalg.norm(raw, axis=(-2, -1), keepdims=True), 1.0)
    cloud_cov = solve_spd(raw / scale + 1e-9 * jnp.eye(3, dtype=dt),
                          jnp.broadcast_to(jnp.eye(3, dtype=dt), raw.shape)) / scale

    planes_out = _build_plane_boundaries(
        params, centroid, mse, p_cnt, cloud_cov, p_cellmask, plane_valid,
        cloud, valid, gh, gw, patch)

    cylinders = DetectedCylinders(
        axis=c_axis, center=c_center, radius=c_radius, mse=c_mse,
        cell_mask=c_cells, valid=jnp.arange(MAX_CYLINDERS) < c_num)
    return planes_out, cylinders


def _merge_planes(p_cnt, p_mean, p_m2, p_cellmask, plane_valid, gh, gw,
                  cos_max, max_dist):
    """Merge adjacent co-planar grown planes (primitive_detection.cpp:503-560).

    Design: instead of the reference's sequential pairwise scan over the
    connected-components matrix, build the full mergeability matrix once, take its
    transitive closure with log2(MAX_PLANES) boolean matmuls, and fold every merge
    group onto its minimum-index representative with one masked moment combine.

    Documented deviation: the merge test is symmetrized (dist_ij OR dist_ji) and
    closed transitively over the STATIC pairwise matrix, so a chain A~B, B~C is
    fused even when the reference's sequential accumulate-and-refit scan would
    have re-fit merged(A,B) first and then rejected C.  In practice this only
    differs for near-threshold curved surfaces; those are exactly the regions the
    plane-vs-cylinder MSE choice routes to the cylinder model, and the engine's
    plane-match gate (exact polygon IoU) re-separates any over-merged footprint
    against the map on the next frame."""
    cell_maps = p_cellmask.reshape(MAX_PLANES, gh, gw)
    right = jnp.roll(cell_maps, -1, axis=2).at[:, :, -1].set(False)
    below = jnp.roll(cell_maps, -1, axis=1).at[:, -1, :].set(False)
    adj = jnp.zeros((MAX_PLANES, MAX_PLANES), bool)
    for shifted in (right, below):
        overlap = jnp.einsum("ahw,bhw->ab", cell_maps.astype(jnp.float32),
                             shifted.astype(jnp.float32)) > 0
        adj = adj | overlap | overlap.T

    n, d, cen, _, _, _ = fit_plane_from_moments(p_cnt, p_mean, p_m2)
    cos_ij = n @ n.T
    dist_ij = jnp.abs(jnp.einsum("ik,jk->ij", n, cen) + d[:, None])
    ok = plane_valid[:, None] & plane_valid[None, :]
    m = adj & ok & (cos_ij > cos_max) & ((dist_ij < max_dist) | (dist_ij.T < max_dist))
    m = m | jnp.eye(MAX_PLANES, dtype=bool)

    for _ in range(4):  # closure: path length doubles per squaring, 2^4 >= MAX_PLANES
        m = (m.astype(jnp.float32) @ m.astype(jnp.float32)) > 0
    root = jnp.argmax(m, axis=1)  # first connected index = representative

    group = (root[None, :] == jnp.arange(MAX_PLANES)[:, None]) & plane_valid[None, :]
    p_cnt, p_mean, p_m2 = jax.vmap(
        lambda msk: moments.combine(p_cnt, p_mean, p_m2, msk))(group)
    p_cellmask = jnp.einsum("gi,ic->gc", group.astype(jnp.float32),
                            p_cellmask.astype(jnp.float32)) > 0
    plane_valid = plane_valid & (root == jnp.arange(MAX_PLANES))
    return p_cnt, p_mean, p_m2, p_cellmask, plane_valid


def _build_plane_boundaries(params, centroid, mse, p_count, cloud_cov, p_cellmask,
                            plane_valid, cloud, valid, gh, gw, patch):
    """Boundary polygon per plane (primitive_detection.cpp:650-703): cross-erode /
    square-dilate mask difference, cell-center camera points within 3 sqrt(MSE) of the
    plane, star hull in the plane basis."""
    cell_maps = p_cellmask.reshape(MAX_PLANES, gh, gw)

    def erode_cross(m):
        return m & jnp.roll(m, 1, 1).at[:, 0].set(False) \
            & jnp.roll(m, -1, 1).at[:, -1].set(False) \
            & jnp.roll(m, 1, 0).at[0, :].set(False) \
            & jnp.roll(m, -1, 0).at[-1, :].set(False)

    def dilate_square(m):
        out = m
        for dy in (-1, 0, 1):
            for dx in (-1, 0, 1):
                s = jnp.roll(m, (dy, dx), (0, 1))
                if dy == 1:
                    s = s.at[0, :].set(False)
                if dy == -1:
                    s = s.at[-1, :].set(False)
                if dx == 1:
                    s = s.at[:, 0].set(False)
                if dx == -1:
                    s = s.at[:, -1].set(False)
                out = out | s
        return out

    cy = jnp.arange(gh) * patch + patch // 2
    cx = jnp.arange(gw) * patch + patch // 2
    centers = cloud[cy[:, None], cx[None, :]]      # [gh, gw, 3]
    centers_valid = valid[cy[:, None], cx[None, :]]

    def one_plane(cmap, plane4, pmse, pvalid):
        boundary = dilate_square(cmap) & ~erode_cross(cmap)
        dist = jnp.abs(jnp.sum(plane4[:3] * centers, axis=-1) + plane4[3])
        in_plane = boundary & centers_valid \
            & (dist < 3.0 * jnp.sqrt(jnp.maximum(pmse, 1e-6)) + 1.0)
        pts = centers.reshape(-1, 3)
        mask = in_plane.reshape(-1) & pvalid

        center3 = plane4[:3] * (-plane4[3])
        u, v = poly.plane_basis(plane4[:3])
        pts2 = poly.project_to_plane(pts, center3, u, v)
        verts, count = poly.convex_hull_by_angle(pts2, mask)
        ok = pvalid & (count >= 3)  # >=3 vertices (primitive_detection.cpp:614-633)
        return verts, count, center3, u, v, ok

    verts, counts, centers3, us, vs, ok = jax.vmap(one_plane)(
        cell_maps, params, mse, plane_valid)

    return DetectedPlanes(
        params=params, centroid=centroid, mse=mse, point_count=p_count,
        cloud_cov=cloud_cov, poly_verts=verts, poly_count=counts,
        basis_center=centers3, basis_u=us, basis_v=vs,
        cell_mask=p_cellmask, valid=ok)

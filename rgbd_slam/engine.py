"""RGB-D SLAM engine: the per-frame tracking pipeline as one pure jittable step.

Re-design of the reference orchestration (src/rgbd_slam.cpp:99-316 and
src/map_management/local_map.hpp): instead of an object graph mutated by three async
tasks, the whole frame is a pure function ``step(state, gray, depth) -> (state,
output)`` over fixed-capacity masked arrays.  Feature extraction, matching, RANSAC
pose optimization, Kalman map updates, lifecycle and insertion all execute on device
in one compiled program.

Row convention: the optimizer's MatchedFeatures blocks are allocated at MAP CAPACITY
and row i corresponds to map slot i, so RANSAC inlier masks flow straight back into
the per-slot lifecycle update (the reference's mark_outliers_as_unmatched,
local_map.hpp:122 / feature_map.hpp:483).
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from .config import CameraIntrinsics, SlamConfig
from .features import primitives
from .features.primitives import MAX_PLANES
from .geometry import covariances as cov_mod
from .geometry import inverse_depth as idp
from .geometry import pinhole, planes as planes_geo, se3
from .mapping import maps
from .ops import brief, fast, image, matching, optical_flow
from .pose.features import MatchedFeatures
from .pose.optimizer import compute_optimized_pose
from .tracking import inverse_depth_tracking as idt
from .tracking import kalman, motion_model
from .utils import polygon as poly


class SlamState(NamedTuple):
    quat: jnp.ndarray
    position: jnp.ndarray
    pose_cov: jnp.ndarray          # [6, 6]
    motion: motion_model.MotionModelState
    points: maps.PointMap
    points2d: maps.Point2DMap
    planes: maps.PlaneMap
    lines: maps.LineMap
    prev_pyramid: tuple            # previous frame's LK pyramid (levels+1 arrays)
    tracked_uv: jnp.ndarray        # [T, 2] screen pos of tracked map points
    tracked_ok: jnp.ndarray        # [T]
    tracked_map_idx: jnp.ndarray   # [T] int32 map slot of each tracked row
    frame_idx: jnp.ndarray
    failed_count: jnp.ndarray
    is_lost: jnp.ndarray
    next_id: jnp.ndarray
    key: jnp.ndarray


class StepOutput(NamedTuple):
    quat: jnp.ndarray
    position: jnp.ndarray
    pose_cov: jnp.ndarray
    success: jnp.ndarray
    is_lost: jnp.ndarray
    n_point_matches: jnp.ndarray
    n_point_inliers: jnp.ndarray
    n_points_alive: jnp.ndarray
    n_planes_alive: jnp.ndarray
    n_detected: jnp.ndarray
    n_lines: jnp.ndarray
    n_line_matches: jnp.ndarray    # map lines matched+inlier this frame
    n_lines_alive: jnp.ndarray     # live line-map features
    n_cylinders: jnp.ndarray       # detected cylinder sub-segments this frame
    n_plane_merge_dropped: jnp.ndarray  # matched planes past the polygon-merge
                                        # cap this frame (kept stale polygons)
    cylinder_cells: jnp.ndarray    # [C] union of cylinder inlier cell masks
    # per-slot observation record for the keyframe/BA backend
    point_obs_uv: jnp.ndarray   # [M3, 2] matched screen observation
    point_obs_z: jnp.ndarray    # [M3] measured depth (mm, 0 = depth-less) —
                                # feeds the window BA's RGB-D depth residual
    point_matched: jnp.ndarray  # [M3] bool (match AND RANSAC inlier)
    point_fid: jnp.ndarray      # [M3] map feature id (-1 = empty)
    # streaming feature-death export records (feature_map.hpp:748-758: LOCAL
    # features are appended to the map file when lost — unless moving — so the
    # final export is the union of everything ever mapped, not a shutdown
    # snapshot).  Snapshots are taken post-update / pre-insertion, so the
    # runner can harvest dying slots even when insertion reuses them.
    n_evicted: jnp.ndarray          # [] total dying features this frame (the
                                    # runner fetches the full records below
                                    # only when this scalar is nonzero)
    point_evicted: jnp.ndarray      # [M3] bool
    point_evict_pos: jnp.ndarray    # [M3, 3]
    point2d_evicted: jnp.ndarray    # [M2] bool
    point2d_evict_pos: jnp.ndarray  # [M2, 3] cartesian estimate at death
    plane_evicted: jnp.ndarray      # [MP] bool
    plane_evict_params: jnp.ndarray # [MP, 4]
    plane_evict_verts: jnp.ndarray  # [MP, V, 2]
    plane_evict_count: jnp.ndarray  # [MP]
    plane_evict_center: jnp.ndarray # [MP, 3]
    plane_evict_u: jnp.ndarray      # [MP, 3]
    plane_evict_v: jnp.ndarray      # [MP, 3]
    line_evicted: jnp.ndarray       # [ML] bool
    line_evict_eps: jnp.ndarray     # [ML, 6]


def init_state(cam: CameraIntrinsics, cfg: SlamConfig,
               quat=None, position=None, seed: int = 0) -> SlamState:
    dt = jnp.float32
    m3 = cfg.mapping.max_points_3d
    return SlamState(
        quat=se3.quat_identity(dt) if quat is None else jnp.asarray(quat, dt),
        position=jnp.zeros(3, dt) if position is None else jnp.asarray(position, dt),
        pose_cov=jnp.eye(6, dtype=dt) * 1e-3,
        motion=motion_model.reset(dt),
        points=maps.empty_point_map(m3),
        points2d=maps.empty_point2d_map(cfg.mapping.max_points_2d),
        planes=maps.empty_plane_map(cfg.mapping.max_planes),
        lines=maps.empty_line_map(cfg.mapping.max_lines),
        prev_pyramid=tuple(image.build_pyramid(
            jnp.zeros((cam.height, cam.width), dt),
            cfg.detection.optical_flow_pyramid_depth)),
        tracked_uv=jnp.zeros((cfg.mapping.max_tracked_points, 2), dt),
        tracked_ok=jnp.zeros((cfg.mapping.max_tracked_points,), bool),
        tracked_map_idx=jnp.full((cfg.mapping.max_tracked_points,), -1, jnp.int32),
        frame_idx=jnp.asarray(0, jnp.int32),
        failed_count=jnp.asarray(0, jnp.int32),
        is_lost=jnp.asarray(False),
        next_id=jnp.asarray(1, jnp.int32),
        key=jax.random.PRNGKey(seed),
    )


def _compact_mask(mask, cap: int):
    """Gather indices of the masked rows into a fixed-capacity block
    (idx [cap] int32, keep [cap] bool).  Lets rare per-slot work (depth-less
    fusions, 2D updates) run at a small static size instead of map capacity —
    otherwise the 6x6 covariance math runs at full map capacity every frame."""
    n = mask.shape[0]
    rank = jnp.cumsum(mask.astype(jnp.int32)) - 1
    dest = jnp.where(mask & (rank < cap), rank, cap)
    idx = jnp.zeros((cap,), jnp.int32).at[dest].set(
        jnp.arange(n, dtype=jnp.int32), mode="drop")
    keep = jnp.arange(cap) < jnp.minimum(jnp.sum(mask.astype(jnp.int32)), cap)
    return idx, keep


def _sample_depth(depth, uv):
    """Nearest-pixel depth lookup (reference: Keypoint_Handler::set depth sampling,
    keypoint_handler.cpp:17-26)."""
    h, w = depth.shape
    x = jnp.clip(jnp.round(uv[..., 0]).astype(jnp.int32), 0, w - 1)
    y = jnp.clip(jnp.round(uv[..., 1]).astype(jnp.int32), 0, h - 1)
    return depth[y, x]


# ---------------------------------------------------------------------------
# plane matching (hessian gate + polygon overlap, map_primitive.cpp:91-161)
# ---------------------------------------------------------------------------

def _match_planes(plane_map: maps.PlaneMap, det: primitives.DetectedPlanes,
                  c2w, cfg: SlamConfig):
    """Returns (match_index [Mp] into detections or -1)."""
    import math

    pc2w = se3.plane_camera_to_world_matrix(c2w)
    det_world = planes_geo.transform_plane(det.params, pc2w)

    cos_gate = math.cos(math.radians(cfg.matching.max_plane_match_angle_d))
    cosang = jnp.einsum("mi,di->md", plane_map.params[:, :3], det_world[:, :3])
    d_diff = jnp.abs(plane_map.params[:, 3:4] - det_world[None, :, 3])
    gate = (cosang > cos_gate) & (d_diff < cfg.matching.max_plane_match_distance_mm)
    gate = gate & maps.alive(plane_map)[:, None] & det.valid[None, :]

    # polygon overlap gate (map_primitive.cpp:91-161): the reference ranks
    # hessian-gated candidates by the EXACT polygon intersection area and gates
    # on interArea / detectedArea >= minimumPlaneOverlapToConsiderMatch.
    # The Green's-theorem intersection (utils/polygon.py) is O(V^2); computing it
    # for every map x detection pair at capacity [32 x 16] is mostly wasted.
    # The reference only intersects hessian-gated candidates (a handful per
    # frame), so compact the gate-passing pairs to PAIR_CAP and intersect those.
    r = c2w[:3, :3]
    t = c2w[:3, 3]
    det_center_w = det.basis_center @ r.T + t
    det_u_w = det.basis_u @ r.T
    det_v_w = det.basis_v @ r.T

    mp = plane_map.params.shape[0]
    nd = det.params.shape[0]
    det_area = jax.vmap(poly.polygon_area)(det.poly_verts, det.poly_count)

    # compact candidate pairs: highest-alignment gate-passers first (cap overflow
    # drops the least-aligned candidates; with scenes of <= a dozen planes the cap
    # is never reached)
    pair_cap = min(32, mp * nd)
    pri = jnp.where(gate.reshape(-1), cosang.reshape(-1), -jnp.inf)
    _, pair_idx = jax.lax.top_k(pri, pair_cap)
    pm_i = pair_idx // nd                                 # [P] map slot
    pd_i = pair_idx % nd                                  # [P] detection slot
    pair_ok = gate.reshape(-1)[pair_idx]

    # gathered detected polygons' vertices in the paired map plane's basis
    verts3 = (det_center_w[pd_i][:, None, :]
              + det.poly_verts[pd_i][..., 0:1] * det_u_w[pd_i][:, None, :]
              + det.poly_verts[pd_i][..., 1:2] * det_v_w[pd_i][:, None, :])
    rel = verts3 - plane_map.basis_center[pm_i][:, None, :]
    verts2 = jnp.stack([
        jnp.sum(rel * plane_map.basis_u[pm_i][:, None, :], axis=-1),
        jnp.sum(rel * plane_map.basis_v[pm_i][:, None, :], axis=-1)], axis=-1)

    inter_pairs = jax.vmap(poly.convex_intersection_area)(
        plane_map.poly_verts[pm_i], plane_map.poly_count[pm_i],
        verts2, det.poly_count[pd_i])
    inter = jnp.zeros((mp, nd), inter_pairs.dtype).at[pm_i, pd_i].set(
        jnp.where(pair_ok, inter_pairs, 0.0), mode="drop")
    ratio = inter / jnp.maximum(det_area[None, :], 1e-9)
    ok_pair = gate & (ratio >= cfg.matching.min_plane_overlap_for_match)
    pair_score = jnp.where(ok_pair, inter, -1.0)
    best = jnp.argmax(pair_score, axis=1)
    best_inter = jnp.take_along_axis(pair_score, best[:, None], axis=1)[:, 0]
    ok = best_inter > 0.0
    # one detection matches at most one map plane (the reference marks
    # detections as matched, map_primitive.cpp:122-124): ties go to the map
    # plane with the larger intersection area
    score = jnp.where(ok, best_inter, -1.0)
    winner = jax.vmap(
        lambda di: jnp.argmax(jnp.where(best == di, score, -1.0)))(
        jnp.arange(nd))
    ok = ok & (winner[best] == jnp.arange(mp))
    return jnp.where(ok, best, -1).astype(jnp.int32), det_world


# ---------------------------------------------------------------------------
# line matching (NEW surface: the reference has no line map, SURVEY.md §2.3;
# gates follow its plane-matching pattern one dimension down)
# ---------------------------------------------------------------------------

def _match_lines(line_map: maps.LineMap, det, w2c, cam, cfg: SlamConfig):
    """Match map lines to detected 2D segments at the predicted pose.

    Gates: 2D direction agreement, detection-midpoint perpendicular distance to
    the projected map line, and positive extent overlap along it.  Best candidate
    by perpendicular distance; each detection matches at most one map line.
    Returns (match_idx [Ml] into detections or -1, proj_l0, proj_l1)."""
    import math

    ml = line_map.fid.shape[0]
    nd = det.p0.shape[0]
    s0, ok0 = pinhole.world_to_screen(line_map.endpoints[:, :3], w2c, cam)
    s1, ok1 = pinhole.world_to_screen(line_map.endpoints[:, 3:], w2c, cam)
    l0, l1 = s0[:, :2], s1[:, :2]
    seg = l1 - l0
    seg_len = jnp.sqrt(jnp.maximum(jnp.sum(seg * seg, axis=-1), 1e-9))
    dir_m = seg / seg_len[:, None]
    norm_m = jnp.stack([-dir_m[:, 1], dir_m[:, 0]], axis=-1)

    cosang = jnp.abs(jnp.einsum("mi,di->md", dir_m, det.direction))
    mid = 0.5 * (det.p0 + det.p1)
    rel = mid[None, :, :] - l0[:, None, :]
    perp = jnp.abs(jnp.sum(rel * norm_m[:, None, :], axis=-1))
    t0 = jnp.sum((det.p0[None] - l0[:, None]) * dir_m[:, None], axis=-1)
    t1 = jnp.sum((det.p1[None] - l0[:, None]) * dir_m[:, None], axis=-1)
    lo = jnp.minimum(t0, t1)
    hi = jnp.maximum(t0, t1)
    overlap = jnp.minimum(hi, seg_len[:, None]) - jnp.maximum(lo, 0.0)

    gate = ((cosang > math.cos(math.radians(cfg.matching.max_line_match_angle_d)))
            & (perp < cfg.matching.max_line_match_distance_px)
            & (overlap > 0.0)
            & (ok0 & ok1)[:, None]
            & maps.alive(line_map)[:, None] & det.valid[None, :])
    score = jnp.where(gate, -perp, -jnp.inf)
    best = jnp.argmax(score, axis=1)
    best_ok = jnp.take_along_axis(gate, best[:, None], axis=1)[:, 0]
    best_perp = -jnp.take_along_axis(score, best[:, None], axis=1)[:, 0]
    # one detection -> one map line: ties go to the smaller perpendicular error
    rank = jnp.where(best_ok, -best_perp, -jnp.inf)
    winner = jax.vmap(
        lambda di: jnp.argmax(jnp.where(best == di, rank, -jnp.inf)))(
        jnp.arange(nd))
    ok = best_ok & (winner[best] == jnp.arange(ml))
    return jnp.where(ok, best, -1).astype(jnp.int32), l0, l1


# ---------------------------------------------------------------------------
# the frame step
# ---------------------------------------------------------------------------

@partial(jax.jit, static_argnames=("cam", "cfg", "with_planes", "with_lines"))
def step(state: SlamState, gray, depth, cam: CameraIntrinsics,
         cfg: SlamConfig, with_planes: bool = True, with_lines: bool = False):
    """Process one RGB-D frame (reference: RGBD_SLAM::track, rgbd_slam.cpp:99-160 +
    compute_new_pose, :163-257)."""
    dt = gray.dtype
    det_cfg = cfg.detection
    m3 = cfg.mapping.max_points_3d
    m2 = cfg.mapping.max_points_2d
    mp = cfg.mapping.max_planes

    key, k_drop, k_opt = jax.random.split(state.key, 3)

    # --- predicted pose: the reference implements the motion model but disables
    # it in the main loop (`#if 0`, rgbd_slam.cpp:176-180) -> default prediction
    # = current pose; the config flag restores constant-velocity prediction for
    # the matching gates + LM init (useful under occlusion bursts)
    if cfg.engine.use_motion_model_prediction:
        pred_quat, pred_pos = motion_model.predict_pose(
            state.motion, state.quat, state.position)
    else:
        pred_quat, pred_pos = state.quat, state.position
    w2c = se3.world_to_camera(pred_quat, pred_pos)
    c2w = se3.camera_to_world(pred_quat, pred_pos)

    # --- feature extraction ------------------------------------------------
    levels = det_cfg.optical_flow_pyramid_depth
    win_w = cam.width // det_cfg.optical_flow_window_width
    win_h = cam.height // det_cfg.optical_flow_window_height
    pyr_prev = list(state.prev_pyramid)
    pyr_cur = image.build_pyramid(gray, levels)

    # optical flow on last frame's tracked map points ("low cost association",
    # keypoint_detection.cpp:262-361)
    of_uv_t, of_ok_t = optical_flow.track_forward_backward(
        pyr_prev, pyr_cur, state.tracked_uv, state.tracked_ok,
        max_roundtrip_px=det_cfg.optical_flow_roundtrip_px,
        levels=levels, win_h=win_h, win_w=win_w,
        iterations=det_cfg.optical_flow_iterations,
        bwd_levels=(None
                    if det_cfg.optical_flow_backward_depth >= levels
                    else det_cfg.optical_flow_backward_depth),
        coarse_win=det_cfg.optical_flow_coarse_window_px,
        coarse_from_level=det_cfg.optical_flow_coarse_from_level,
        eps=det_cfg.optical_flow_eps_px)
    of_ok_t = of_ok_t & state.tracked_ok & (state.frame_idx > 0)
    # scatter tracked-row results back to map slots
    t_idx = jnp.where(of_ok_t & (state.tracked_map_idx >= 0),
                      state.tracked_map_idx, m3)
    of_uv = jnp.zeros((m3, 2), dt).at[t_idx].set(of_uv_t, mode="drop")
    of_ok = jnp.zeros((m3,), bool).at[t_idx].set(True, mode="drop")

    # FAST + BRIEF detection, masked around optically-tracked points
    # (keypoint_detection.cpp:111-156, 404-474).  Detection runs only on refresh
    # frames or when optical flow tracked fewer than maximumPointPerFrame points
    # (keypoint_detection.cpp:213, refresh cadence rgbd_slam.cpp:173) — skipped
    # frames pay zero detection cost through lax.cond.
    do_detect = (state.frame_idx % det_cfg.keypoint_refresh_frequency == 0) \
        | (jnp.sum(of_ok_t) < det_cfg.max_point_per_frame) \
        | state.is_lost

    def detect_branch(_):
        det_mask = fast.tracked_points_mask(
            (cam.height, cam.width), of_uv_t, of_ok_t,
            det_cfg.tracked_mask_radius_px)
        # Dynamic FAST threshold from the empirical points->threshold curve
        # (keypoint_detection.cpp:48-65) evaluated on the CURRENT point deficit
        # as a traced scalar — detection density tracks demand frame to frame
        # with zero recompiles.  At full deficit (maximumPointPerFrame) this
        # reproduces the reference's static 10x/30x constants (24 / 8); with
        # most points still tracked the threshold rises, so refresh frames
        # return only strong corners instead of re-flooding the matcher.
        deficit = jnp.maximum(
            det_cfg.max_point_per_frame - jnp.sum(of_ok_t), 10).astype(dt)
        thr = det_cfg.fast_curve_scale * jnp.power(
            det_cfg.fast_curve_decay, det_cfg.fast_deficit_mult_high * deficit)
        thr_low = det_cfg.fast_curve_scale * jnp.power(
            det_cfg.fast_curve_decay, det_cfg.fast_deficit_mult_low * deficit)
        xy, score, valid = fast.detect_fast_grid(
            gray, detection_mask=det_mask,
            threshold=thr,
            low_threshold=thr_low,
            max_points=det_cfg.max_point_per_frame,
            cell_rows=det_cfg.keypoint_cell_detection_height_count,
            cell_cols=det_cfg.keypoint_cell_detection_width_count)
        desc, valid = brief.compute_brief(gray, xy, valid)
        return xy, score, valid, desc

    def skip_branch(_):
        n = det_cfg.max_point_per_frame
        return (jnp.zeros((n, 2), dt), jnp.zeros((n,), dt),
                jnp.zeros((n,), bool), jnp.zeros((n, brief.N_WORDS), jnp.uint32))

    det_xy, det_score, det_valid, det_desc = jax.lax.cond(
        do_detect, detect_branch, skip_branch, None)
    det_z = _sample_depth(depth, det_xy)
    det_depth_ok = pinhole.is_depth_valid(det_z, cfg.engine.min_depth_mm,
                                          cfg.engine.max_depth_mm) & det_valid

    # --- data association --------------------------------------------------
    pts = state.points
    pts_alive = maps.alive(pts)

    # 3D points: optical flow hit first, else windowed descriptor match
    # (MapPoint::find_matches, map_point.cpp:71-114).  Matching runs local-map
    # features before staged ones and retries unmatched features at double the
    # search radius when the match count is below the optimization minimum
    # (two-pass + advanced search, feature_map.hpp:308-326)
    proj3, proj3_ok = pinhole.world_to_screen(pts.pos, w2c, cam)
    need_desc_match = pts_alive & ~of_ok & proj3_ok
    n_det = det_xy.shape[0]
    p2 = state.points2d
    p2_alive = maps.alive(p2)
    p2_cart = idp.to_world(p2.state)
    proj2, proj2_ok = pinhole.world_to_screen(p2_cart, w2c, cam)

    def match_branch(_):
        det_taken = jnp.zeros_like(det_valid)
        # Hamming + screen distances are identical across the local/staged/
        # advanced passes (only masks and radius change) — compute them once
        ham3, dsq3 = matching.match_precompute(pts.desc, proj3[:, :2],
                                               det_desc, det_xy)

        def match_pass(mask, taken, radius):
            idx, dist = matching.match_from_distances(
                ham3, dsq3, mask, det_valid, taken,
                search_radius=radius,
                lowe_ratio=cfg.matching.max_match_distance)
            idx = matching.resolve_match_conflicts(idx, dist, n_det)
            new_taken = taken.at[jnp.where(idx >= 0, idx, n_det)].set(
                True, mode="drop")
            return idx, new_taken

        radius = cfg.matching.match_search_radius_px
        idx_loc, det_taken = match_pass(need_desc_match & pts.is_local,
                                        det_taken, radius)
        idx_stg, det_taken = match_pass(need_desc_match & ~pts.is_local,
                                        det_taken, radius)
        p_idx = jnp.where(idx_loc >= 0, idx_loc, idx_stg)

        # advanced search: 2x radius retry when below minimumPointForOptimization
        n_matched_now = jnp.sum(of_ok) + jnp.sum(p_idx >= 0)
        idx_adv, det_taken_adv = match_pass(
            need_desc_match & (p_idx < 0), det_taken, radius * 2.0)
        use_adv = n_matched_now < cfg.ransac.min_point_count
        p_idx = jnp.where(use_adv & (p_idx < 0), idx_adv, p_idx)
        det_taken = jnp.where(use_adv, det_taken_adv, det_taken)

        # 2D points: windowed descriptor match at the projected cartesian
        # estimate (map_point2d.cpp:87-141; never fed to optical flow, :143-152)
        q_idx, q_dist = matching.match_descriptors(
            p2.desc, proj2[:, :2], p2_alive & proj2_ok,
            det_desc, det_xy, det_valid, det_taken,
            search_radius=cfg.matching.match_search_radius_px,
            lowe_ratio=cfg.matching.max_match_distance)
        q_idx = matching.resolve_match_conflicts(q_idx, q_dist, n_det)
        det_taken = det_taken.at[
            jnp.where(q_idx >= 0, q_idx, n_det)].set(True, mode="drop")
        return p_idx, q_idx, det_taken

    def no_match_branch(_):
        m3_ = pts.pos.shape[0]
        m2_ = p2.state.shape[0]
        return (jnp.full((m3_,), -1, jnp.int32), jnp.full((m2_,), -1, jnp.int32),
                jnp.zeros_like(det_valid))

    # descriptor matching only exists on detection frames
    p_match_idx, q_match_idx, det_taken = jax.lax.cond(
        do_detect, match_branch, no_match_branch, None)

    p_obs_uv = jnp.where(of_ok[:, None], of_uv,
                         det_xy[jnp.clip(p_match_idx, 0, det_xy.shape[0] - 1)])
    p_matched = of_ok | (p_match_idx >= 0)
    p_obs_z = _sample_depth(depth, p_obs_uv)
    p_obs_depth_ok = pinhole.is_depth_valid(
        p_obs_z, cfg.engine.min_depth_mm, cfg.engine.max_depth_mm)

    q_matched = q_match_idx >= 0
    q_obs_uv = det_xy[jnp.clip(q_match_idx, 0, det_xy.shape[0] - 1)]
    q_obs_z = _sample_depth(depth, q_obs_uv)
    q_obs_depth_ok = pinhole.is_depth_valid(
        q_obs_z, cfg.engine.min_depth_mm, cfg.engine.max_depth_mm)

    # lines: detection + matching + pose participation (north-star config 2 —
    # goes BEYOND the reference, whose line path is compiled out and never
    # reaches pose optimization, rgbd_slam.cpp:304-313 / SURVEY.md §2.3)
    ml_cap = cfg.mapping.max_lines
    if with_lines:
        from .features.lines import MAX_LINES as DET_LINES_CAP, detect_lines

        det_lines = detect_lines(gray)
        n_lines = jnp.sum(det_lines.valid)
        # endpoint depths, inset a few px toward the midpoint to dodge the depth
        # discontinuity that usually coincides with an intensity edge
        inset0 = det_lines.p0 + 3.0 * det_lines.direction
        inset1 = det_lines.p1 - 3.0 * det_lines.direction
        lz0 = _sample_depth(depth, inset0)
        lz1 = _sample_depth(depth, inset1)
        l_depth_ok = (pinhole.is_depth_valid(lz0, cfg.engine.min_depth_mm,
                                             cfg.engine.max_depth_mm)
                      & pinhole.is_depth_valid(lz1, cfg.engine.min_depth_mm,
                                               cfg.engine.max_depth_mm))
        l_match_idx, _, _ = _match_lines(state.lines, det_lines, w2c, cam, cfg)
    else:
        det_lines = None
        n_lines = jnp.asarray(0, jnp.int32)
        l_match_idx = jnp.full((ml_cap,), -1, jnp.int32)
    l_matched = l_match_idx >= 0

    # planes + cylinders (cylinders are detection products like the reference —
    # there is no cylinder feature map in src/map_management; they surface in
    # the step output and the debug image)
    n_grid_cells = (cam.height // det_cfg.depth_patch_size_px) \
        * (cam.width // det_cfg.depth_patch_size_px)
    if with_planes:
        det_planes, det_cyls = primitives.find_primitives(depth, cam, det_cfg)
        k_match_idx, det_planes_world = _match_planes(
            state.planes, det_planes, c2w, cfg)
        n_cylinders = jnp.sum(det_cyls.valid)
        cylinder_cells = jnp.any(
            det_cyls.cell_mask & det_cyls.valid[:, None], axis=0)
    else:
        det_planes = None
        k_match_idx = jnp.full((mp,), -1, jnp.int32)
        det_planes_world = jnp.zeros((MAX_PLANES, 4), dt)
        n_cylinders = jnp.asarray(0, jnp.int32)
        cylinder_cells = jnp.zeros((n_grid_cells,), bool)
    k_matched = k_match_idx >= 0

    # --- pose optimization -------------------------------------------------
    safe_k = jnp.clip(k_match_idx, 0, MAX_PLANES - 1)
    plane_cam_obs = det_planes.params[safe_k] if with_planes \
        else jnp.zeros((mp, 4), dt)
    if with_lines:
        safe_l = jnp.clip(l_match_idx, 0, DET_LINES_CAP - 1)
        line_obs_p0 = det_lines.p0[safe_l]
        line_obs_p1 = det_lines.p1[safe_l]
    else:
        line_obs_p0 = jnp.zeros((ml_cap, 2), dt)
        line_obs_p1 = jnp.zeros((ml_cap, 2), dt)
    line_std6 = jnp.sqrt(jnp.abs(jnp.diagonal(
        state.lines.cov, axis1=-2, axis2=-1))).reshape(ml_cap, 6)
    feats = MatchedFeatures(
        point_obs_uv=p_obs_uv,
        point_world=pts.pos,
        point_world_std=jnp.sqrt(jnp.abs(jnp.diagonal(pts.cov, axis1=-2, axis2=-1))),
        point_mask=p_matched & pts_alive,
        point2d_obs_uv=q_obs_uv,
        point2d_state=p2.state,
        point2d_state_std=jnp.sqrt(jnp.abs(jnp.diagonal(p2.cov, axis1=-2, axis2=-1))),
        point2d_mask=q_matched & p2_alive,
        plane_cam=plane_cam_obs,
        plane_world=state.planes.params,
        plane_world_std=jnp.sqrt(jnp.abs(jnp.diagonal(state.planes.cov,
                                                      axis1=-2, axis2=-1))),
        plane_mask=k_matched & maps.alive(state.planes),
        line_obs_p0=line_obs_p0,
        line_obs_p1=line_obs_p1,
        line_world=state.lines.endpoints,
        line_world_std=line_std6,
        line_mask=l_matched & maps.alive(state.lines),
    )
    opt = compute_optimized_pose(k_opt, pred_quat, pred_pos, feats, cam,
                                 ransac_cfg=cfg.ransac, engine_cfg=cfg.engine)

    first_frame = state.frame_idx == 0
    # live covariance-validity gate (reference: rgbd_slam.cpp:167-171 hard-fails
    # on an invalid pose covariance every frame): an indefinite/NaN covariance
    # or non-finite pose marks the frame failed instead of propagating silently
    pose_ok = (cov_mod.is_covariance_valid_fast(opt.covariance)
               & jnp.all(jnp.isfinite(opt.quat))
               & jnp.all(jnp.isfinite(opt.position)))
    success = opt.success & pose_ok & ~first_frame

    new_quat = jnp.where(success, opt.quat, pred_quat)
    new_pos = jnp.where(success, opt.position, pred_pos)
    new_pose_cov = jnp.where(success, opt.covariance, state.pose_cov)
    new_c2w = se3.camera_to_world(new_quat, new_pos)
    new_w2c = se3.world_to_camera(new_quat, new_pos)
    pose_cov3 = new_pose_cov[:3, :3]

    # --- map update --------------------------------------------------------
    # final per-slot "matched" = matched AND RANSAC inlier (outliers are treated as
    # unmatched, local_map.hpp:122)
    p_final = jnp.where(success, p_matched & opt.point_inliers, p_matched & False)
    q_final = jnp.where(success, q_matched & opt.point2d_inliers, q_matched & False)
    k_final = jnp.where(success, k_matched & opt.plane_inliers, k_matched & False)
    l_final = jnp.where(success, l_matched & opt.line_inliers, l_matched & False)

    # 3D point Kalman updates (map_point.cpp:188-240): depth-valid observations
    # fuse the world point; depth-less matches build a REAL inverse-depth
    # observation from the 2D screen match (origin = camera, rho = baseline/2,
    # initial angular/rho covariance) and fuse its cartesian projection with
    # the J Sigma J^T covariance — the reference's update_with_match else-branch
    # (map_point.cpp:218-240)
    # matched points per frame are bounded by tracked (128) + detections (100),
    # so the whole observation-covariance + KF chain runs on a compacted
    # 256-slot block instead of the full M3 map capacity
    midx, mkeep = _compact_mask(p_final & pts_alive, 256)
    uv_c = p_obs_uv[midx]
    obs_screen = jnp.stack([uv_c[:, 0], uv_c[:, 1], p_obs_z[midx]], axis=-1)
    obs_world = pinhole.screen_to_world(obs_screen, new_c2w, cam)
    obs_cov = cov_mod.screen_point_to_world_covariance(
        obs_screen, new_c2w, cam, pose_cov3)
    # depth-less matches are rarer still (LK survivors usually carry depth): the
    # inverse-depth observation math runs on a nested 64-slot block (overflow
    # beyond the cap falls back to the depth observation)
    depthless = mkeep & ~p_obs_depth_ok[midx]
    didx, dkeep = _compact_mask(depthless, 64)
    id_state_c = idp.from_screen_observation(
        uv_c[didx], new_c2w, cam,
        baseline_rho=det_cfg.inverse_depth_baseline / 2.0)
    id_cov_c = idt.initial_covariance(
        jnp.broadcast_to(pose_cov3, (64, 3, 3)), det_cfg)
    obs_world = obs_world.at[didx].set(
        jnp.where(dkeep[:, None], idp.to_world(id_state_c), obs_world[didx]),
        mode="drop")
    obs_cov = obs_cov.at[didx].set(
        jnp.where(dkeep[:, None, None],
                  idt.cartesian_covariance(id_state_c, id_cov_c),
                  obs_cov[didx]),
        mode="drop")
    upd_pos, upd_cov, _, moving = kalman.track_points(
        pts.pos[midx], pts.cov[midx], obs_world, obs_cov)
    # per-feature covariance gate (point_with_tracking.cpp:43 hard-fails on an
    # invalid fused covariance): rows whose KF output is invalid keep their
    # previous state instead of absorbing the observation
    kf_ok = (cov_mod.is_covariance_valid_fast(upd_cov)
             & jnp.all(jnp.isfinite(upd_pos), axis=-1))
    mkeep = mkeep & kf_ok
    match_c = p_match_idx[midx]
    desc_upd = mkeep & ~of_ok[midx] & (match_c >= 0)
    desc_c = det_desc[jnp.clip(match_c, 0, det_desc.shape[0] - 1)]
    new_points = pts._replace(
        pos=pts.pos.at[midx].set(
            jnp.where(mkeep[:, None], upd_pos, pts.pos[midx]), mode="drop"),
        cov=pts.cov.at[midx].set(
            jnp.where(mkeep[:, None, None], upd_cov, pts.cov[midx]),
            mode="drop"),
        desc=pts.desc.at[midx].set(
            jnp.where(desc_upd[:, None], desc_c, pts.desc[midx]), mode="drop"),
        is_moving=pts.is_moving.at[midx].set(
            jnp.where(mkeep, moving, pts.is_moving[midx]), mode="drop"),
    )

    # 2D point fusion (map_point2d.cpp:243-260) — matched 2D points per frame are
    # bounded by detections (usually ~10), so fuse on a compacted 64-slot block
    # instead of both fusion branches at full [M2, 6, 6] capacity
    q_obs_screen = jnp.stack([q_obs_uv[:, 0], q_obs_uv[:, 1], q_obs_z], axis=-1)
    qidx, qkeep = _compact_mask(q_final & p2_alive, 64)
    st3, cov3_, _ = idt.fuse_screen_observation_3d(
        p2.state[qidx], p2.cov[qidx], q_obs_screen[qidx], new_c2w, pose_cov3,
        cam)
    st2, cov2_, _ = idt.fuse_screen_observation_2d(
        p2.state[qidx], p2.cov[qidx], q_obs_uv[qidx], new_c2w, pose_cov3, cam,
        det_cfg)
    okd = q_obs_depth_ok[qidx]
    fused_state = jnp.where(okd[:, None], st3, st2)
    fused_cov = jnp.where(okd[:, None, None], cov3_, cov2_)
    desc_c = det_desc[jnp.clip(q_match_idx[qidx], 0, det_desc.shape[0] - 1)]
    new_points2d = p2._replace(
        state=p2.state.at[qidx].set(
            jnp.where(qkeep[:, None], fused_state, p2.state[qidx]),
            mode="drop"),
        cov=p2.cov.at[qidx].set(
            jnp.where(qkeep[:, None, None], fused_cov, p2.cov[qidx]),
            mode="drop"),
        desc=p2.desc.at[qidx].set(
            jnp.where(qkeep[:, None], desc_c, p2.desc[qidx]), mode="drop"),
    )

    # plane updates: world-frame 4x4 KF + polygon merge (map_primitive.cpp:204-251,
    # plane_with_tracking.cpp:16-95)
    pl = state.planes
    if with_planes:
        # world-frame plane parameters + covariance for ALL detections once,
        # using the OPTIMIZED pose (the predicted-pose transform in
        # _match_planes is only a matching gate); shared by the matched-update
        # and staged-insertion paths
        det_world_norm = planes_geo.normalize_plane(planes_geo.transform_plane(
            det_planes.params, se3.plane_camera_to_world_matrix(new_c2w)))
        det_world_cov = cov_mod.world_plane_covariance(
            det_planes.params, det_world_norm, new_c2w,
            cov_mod.plane_covariance_from_point_cloud(
                det_planes.params, det_planes.cloud_cov),
            pose_cov3)
        obs_world_planes = det_world_norm[safe_k]
        obs_plane_cov = det_world_cov[safe_k]
        upd_params, upd_pcov = kalman.track_planes(
            pl.params, pl.cov, obs_world_planes, obs_plane_cov)
        upd_params = planes_geo.normalize_plane(upd_params)
        plane_kf_ok = (cov_mod.is_covariance_valid_fast(upd_pcov)
                       & jnp.all(jnp.isfinite(upd_params), axis=-1))
        do_k = (k_final & maps.alive(pl) & plane_kf_ok)[:, None]

        # polygon merge in the map plane's basis — compacted to the few
        # matched planes (a handful per frame) instead of vmapping the
        # O(V^2) hull merge over all map slots (in a bench trace the
        # full-slot merge was most of the plane stage)
        r = new_c2w[:3, :3]
        t = new_c2w[:3, 3]
        det_center_w = det_planes.basis_center[safe_k] @ r.T + t
        det_u_w = det_planes.basis_u[safe_k] @ r.T
        det_v_w = det_planes.basis_v[safe_k] @ r.T

        def merge_poly(mi):
            verts3 = (det_center_w[mi][None, :]
                      + det_planes.poly_verts[safe_k[mi]][:, 0:1] * det_u_w[mi][None, :]
                      + det_planes.poly_verts[safe_k[mi]][:, 1:2] * det_v_w[mi][None, :])
            verts2 = poly.project_to_plane(
                verts3, pl.basis_center[mi], pl.basis_u[mi], pl.basis_v[mi])
            return poly.merge_polygons(
                pl.poly_verts[mi], pl.poly_count[mi],
                verts2, det_planes.poly_count[safe_k[mi]])

        merge_cap = min(cfg.mapping.plane_merge_cap, mp)
        kidx, kkeep = _compact_mask(do_k[:, 0], merge_cap)
        # no silent caps: matched planes beyond the merge cap keep a stale
        # polygon this frame (params/cov still update); count them
        n_merge_dropped = jnp.maximum(
            jnp.sum(do_k[:, 0].astype(jnp.int32)) - merge_cap, 0)
        mverts_c, mcounts_c = jax.vmap(merge_poly)(kidx)
        # unfilled compact rows scatter out of bounds (dropped) — a 0-default
        # index would otherwise race a real merge into slot 0
        kidx_w = jnp.where(kkeep, kidx, mp)
        mverts = pl.poly_verts.at[kidx_w].set(mverts_c, mode="drop")
        mcounts = pl.poly_count.at[kidx_w].set(mcounts_c, mode="drop")
        new_planes = pl._replace(
            params=jnp.where(do_k, upd_params, pl.params),
            cov=jnp.where(do_k[..., None], upd_pcov, pl.cov),
            poly_verts=mverts,
            poly_count=mcounts,
        )
    else:
        new_planes = pl
        n_merge_dropped = jnp.asarray(0, jnp.int32)

    # --- lifecycle ---------------------------------------------------------
    # staged confidence = matches / point_staged_age_confidence, promote when
    # > point_min_confidence_for_map (map_point.cpp:251-274): hits > 0.9*3 => 3
    promote_pts = int(cfg.mapping.point_min_confidence_for_map
                      * cfg.mapping.point_staged_age_confidence) + 1
    p_loc, p_mc, p_miss, p_keep = maps.lifecycle_update(
        new_points.is_local, new_points.match_count, new_points.miss_count,
        p_final, promote_pts, cfg.mapping.point_unmatched_count_to_loose)
    # death-export record (feature_map.hpp:748-758: lost LOCAL features stream
    # to the map writer unless moving); snapshot before insertion reuses slots
    p_evicted = pts_alive & new_points.is_local & ~p_keep & ~new_points.is_moving
    p_evict_pos = new_points.pos
    new_points = maps.remove_features(
        new_points._replace(is_local=p_loc, match_count=p_mc, miss_count=p_miss),
        p_keep | ~pts_alive)

    q_loc, q_mc, q_miss, q_keep = maps.lifecycle_update(
        new_points2d.is_local, new_points2d.match_count, new_points2d.miss_count,
        q_final, promote_pts, cfg.mapping.point_unmatched_count_to_loose)
    q_evicted = p2_alive & new_points2d.is_local & ~q_keep
    q_evict_pos = idp.to_world(new_points2d.state)
    new_points2d = maps.remove_features(
        new_points2d._replace(is_local=q_loc, match_count=q_mc, miss_count=q_miss),
        q_keep | ~p2_alive)

    k_loc, k_mc, k_miss, k_keep = maps.lifecycle_update(
        new_planes.is_local, new_planes.match_count, new_planes.miss_count,
        k_final, cfg.mapping.plane_staged_promote_hits,
        cfg.mapping.plane_unmatched_count_to_loose)
    # staged planes drop after 2 misses (map_primitive.cpp:286-288)
    k_staged_drop = ~new_planes.is_local & (k_miss >= cfg.mapping.plane_staged_drop_misses)
    k_evicted = maps.alive(pl) & new_planes.is_local & ~k_keep
    k_evict = (new_planes.params, new_planes.poly_verts, new_planes.poly_count,
               new_planes.basis_center, new_planes.basis_u, new_planes.basis_v)
    new_planes = maps.remove_features(
        new_planes._replace(is_local=k_loc, match_count=k_mc, miss_count=k_miss),
        (k_keep & ~k_staged_drop) | ~maps.alive(pl))

    # --- 2D -> 3D upgrade (map_point2d.cpp:220-241) ------------------------
    lin_score = idt.linearity_score(new_points2d.state, new_points2d.cov,
                                    jnp.broadcast_to(new_c2w, (m2, 4, 4)))
    upgrade = maps.alive(new_points2d) & (lin_score < 0.1) & q_final
    # upgrades are rare (bounded by this frame's 2D matches): compute the world
    # projection + covariance on a compacted 32-slot block
    uidx, ukeep = _compact_mask(upgrade, 32)
    up_state_c = new_points2d.state[uidx]
    up_world = idp.to_world(up_state_c)
    up_cov = idt.cartesian_covariance(up_state_c, new_points2d.cov[uidx])

    # --- insertion of new features ----------------------------------------
    # when tracking is fine: unmatched detections go to the staged maps; when lost,
    # ALL detections re-seed the map (rgbd_slam.cpp:233-241, local_map.hpp:181-199)
    newly_lost = state.failed_count + (~success).astype(jnp.int32) \
        > cfg.engine.max_failed_tracking
    insert_all = ((~success) & (newly_lost | state.is_lost)) | first_frame
    # unmatched detections are staged only on successful frames (update vs
    # update_no_pose, local_map.hpp:110-173); when lost, everything re-seeds
    allow_insert = success | insert_all
    det_free = det_valid & (~det_taken | insert_all) & allow_insert

    # new 3D points from depth-valid detections
    want3 = det_free & det_depth_ok
    free3 = ~maps.alive(new_points)
    # upgraded 2D points also claim 3D slots (after detections)
    det_screen = jnp.stack([det_xy[:, 0], det_xy[:, 1], det_z], axis=-1)
    new_world = pinhole.screen_to_world(det_screen, new_c2w, cam)
    new_world_cov = cov_mod.screen_point_to_world_covariance(
        det_screen, new_c2w, cam, pose_cov3)

    cand_pos = jnp.concatenate([new_world, up_world], axis=0)
    cand_cov = jnp.concatenate([new_world_cov, up_cov], axis=0)
    cand_desc = jnp.concatenate([det_desc, new_points2d.desc[uidx]], axis=0)
    cand_want = jnp.concatenate([want3, ukeep], axis=0)
    cand_local = jnp.concatenate([jnp.zeros_like(want3), ukeep], axis=0)
    slots3 = maps.allocate_slots(free3, cand_want)
    ok3 = slots3 >= 0
    tgt3 = jnp.where(ok3, slots3, m3)
    n_new3 = jnp.cumsum(ok3.astype(jnp.int32))
    ids3 = state.next_id + n_new3 - 1
    new_points = new_points._replace(
        pos=new_points.pos.at[tgt3].set(cand_pos, mode="drop"),
        cov=new_points.cov.at[tgt3].set(cand_cov, mode="drop"),
        desc=new_points.desc.at[tgt3].set(cand_desc, mode="drop"),
        fid=new_points.fid.at[tgt3].set(ids3, mode="drop"),
        is_local=new_points.is_local.at[tgt3].set(cand_local, mode="drop"),
        match_count=new_points.match_count.at[tgt3].set(1, mode="drop"),
        miss_count=new_points.miss_count.at[tgt3].set(0, mode="drop"),
        is_moving=new_points.is_moving.at[tgt3].set(False, mode="drop"),
    )
    next_id = state.next_id + jnp.sum(ok3.astype(jnp.int32))

    # upgraded 2D points leave the 2D map (only those that got a 3D slot)
    upgraded_ok = jnp.zeros((m2,), bool).at[uidx].set(
        ok3[det_xy.shape[0]:] & ukeep, mode="drop")
    new_points2d = maps.remove_features(new_points2d, ~upgraded_ok)

    # new 2D points from depth-less detections (map_point2d staged ctor)
    want2 = det_free & ~det_depth_ok
    free2 = ~maps.alive(new_points2d)
    slots2 = maps.allocate_slots(free2, want2)
    ok2 = slots2 >= 0
    tgt2 = jnp.where(ok2, slots2, m2)
    new_2d_state = idp.from_screen_observation(
        det_xy, new_c2w, cam, baseline_rho=det_cfg.inverse_depth_baseline / 2.0)
    new_2d_cov = idt.initial_covariance(
        jnp.broadcast_to(pose_cov3, (det_xy.shape[0], 3, 3)), det_cfg)
    n_new2 = jnp.cumsum(ok2.astype(jnp.int32))
    ids2 = next_id + n_new2 - 1
    new_points2d = new_points2d._replace(
        state=new_points2d.state.at[tgt2].set(new_2d_state, mode="drop"),
        cov=new_points2d.cov.at[tgt2].set(new_2d_cov, mode="drop"),
        desc=new_points2d.desc.at[tgt2].set(det_desc, mode="drop"),
        fid=new_points2d.fid.at[tgt2].set(ids2, mode="drop"),
        is_local=new_points2d.is_local.at[tgt2].set(False, mode="drop"),
        match_count=new_points2d.match_count.at[tgt2].set(1, mode="drop"),
        miss_count=new_points2d.miss_count.at[tgt2].set(0, mode="drop"),
    )
    next_id = next_id + jnp.sum(ok2.astype(jnp.int32))

    # new staged planes from unmatched detections
    if with_planes:
        det_plane_taken = jnp.zeros((MAX_PLANES,), bool)
        det_plane_taken = det_plane_taken.at[
            jnp.where(k_final, safe_k, MAX_PLANES)].set(True, mode="drop")
        wantk = det_planes.valid & ~det_plane_taken
        freek = ~maps.alive(new_planes)
        slotsk = maps.allocate_slots(freek, wantk)
        okk = slotsk >= 0
        tgtk = jnp.where(okk, slotsk, mp)
        pw = det_world_norm
        pw_cov = det_world_cov
        r = new_c2w[:3, :3]
        t = new_c2w[:3, 3]
        n_newk = jnp.cumsum(okk.astype(jnp.int32))
        idsk = next_id + n_newk - 1
        new_planes = new_planes._replace(
            params=new_planes.params.at[tgtk].set(pw, mode="drop"),
            cov=new_planes.cov.at[tgtk].set(pw_cov, mode="drop"),
            poly_verts=new_planes.poly_verts.at[tgtk].set(det_planes.poly_verts,
                                                          mode="drop"),
            poly_count=new_planes.poly_count.at[tgtk].set(det_planes.poly_count,
                                                          mode="drop"),
            basis_center=new_planes.basis_center.at[tgtk].set(
                det_planes.basis_center @ r.T + t, mode="drop"),
            basis_u=new_planes.basis_u.at[tgtk].set(det_planes.basis_u @ r.T,
                                                    mode="drop"),
            basis_v=new_planes.basis_v.at[tgtk].set(det_planes.basis_v @ r.T,
                                                    mode="drop"),
            fid=new_planes.fid.at[tgtk].set(idsk, mode="drop"),
            is_local=new_planes.is_local.at[tgtk].set(False, mode="drop"),
            match_count=new_planes.match_count.at[tgtk].set(1, mode="drop"),
            miss_count=new_planes.miss_count.at[tgtk].set(0, mode="drop"),
        )
        next_id = next_id + jnp.sum(okk.astype(jnp.int32))

    # --- line map update (NEW surface; per-endpoint 3x3 KF like map points) ----
    if with_lines:
        li = state.lines
        # observed 3D endpoints at the optimized pose (inset screen points paired
        # with their sampled depths)
        det_e_scr0 = jnp.stack([inset0[:, 0], inset0[:, 1], lz0], axis=-1)
        det_e_scr1 = jnp.stack([inset1[:, 0], inset1[:, 1], lz1], axis=-1)
        det_e0_w = pinhole.screen_to_world(det_e_scr0, new_c2w, cam)
        det_e1_w = pinhole.screen_to_world(det_e_scr1, new_c2w, cam)
        det_e0_cov = cov_mod.screen_point_to_world_covariance(
            det_e_scr0, new_c2w, cam, pose_cov3)
        det_e1_cov = cov_mod.screen_point_to_world_covariance(
            det_e_scr1, new_c2w, cam, pose_cov3)

        obs_e0 = det_e0_w[safe_l]
        obs_e1 = det_e1_w[safe_l]
        oc0 = det_e0_cov[safe_l]
        oc1 = det_e1_cov[safe_l]
        e0m = li.endpoints[:, :3]
        e1m = li.endpoints[:, 3:]
        # endpoint correspondence: segment endpoints are unordered, pick the
        # assignment with the smaller total displacement
        d_direct = (jnp.linalg.norm(e0m - obs_e0, axis=-1)
                    + jnp.linalg.norm(e1m - obs_e1, axis=-1))
        d_swap = (jnp.linalg.norm(e0m - obs_e1, axis=-1)
                  + jnp.linalg.norm(e1m - obs_e0, axis=-1))
        swap = (d_swap < d_direct)[:, None]
        o0 = jnp.where(swap, obs_e1, obs_e0)
        o1 = jnp.where(swap, obs_e0, obs_e1)
        c0 = jnp.where(swap[..., None], oc1, oc0)
        c1 = jnp.where(swap[..., None], oc0, oc1)
        upd_e0, upd_c0, _, _ = kalman.track_points(e0m, li.cov[:, 0], o0, c0)
        upd_e1, upd_c1, _, _ = kalman.track_points(e1m, li.cov[:, 1], o1, c1)
        l_upd = (l_final & maps.alive(li) & l_depth_ok[safe_l])[:, None]
        new_lines = li._replace(
            endpoints=jnp.where(l_upd, jnp.concatenate([upd_e0, upd_e1], -1),
                                li.endpoints),
            cov=jnp.where(l_upd[..., None, None],
                          jnp.stack([upd_c0, upd_c1], axis=1), li.cov),
        )
        # lifecycle: same staged/local rules as map points (promote >= 3,
        # lose > 10 — map_point.cpp:251-274 convention applied to the new type)
        l_loc, l_mc, l_miss, l_keepm = maps.lifecycle_update(
            new_lines.is_local, new_lines.match_count, new_lines.miss_count,
            l_final, cfg.mapping.point_staged_age_confidence,
            cfg.mapping.point_unmatched_count_to_loose)
        l_evicted = maps.alive(li) & new_lines.is_local & ~l_keepm
        l_evict_eps = new_lines.endpoints
        new_lines = maps.remove_features(
            new_lines._replace(is_local=l_loc, match_count=l_mc,
                               miss_count=l_miss),
            l_keepm | ~maps.alive(li))
        # insertion: unmatched valid detections with both endpoint depths
        det_taken_l = jnp.zeros((DET_LINES_CAP,), bool).at[
            jnp.where(l_match_idx >= 0, l_match_idx, DET_LINES_CAP)].set(
            True, mode="drop")
        want_l = det_lines.valid & l_depth_ok \
            & (~det_taken_l | insert_all) & allow_insert
        free_l = ~maps.alive(new_lines)
        slots_l = maps.allocate_slots(free_l, want_l)
        okl = slots_l >= 0
        tgt_l = jnp.where(okl, slots_l, ml_cap)
        ids_l = next_id + jnp.cumsum(okl.astype(jnp.int32)) - 1
        cand_ep = jnp.concatenate([det_e0_w, det_e1_w], axis=-1)
        cand_cov = jnp.stack([det_e0_cov, det_e1_cov], axis=1)
        new_lines = new_lines._replace(
            endpoints=new_lines.endpoints.at[tgt_l].set(cand_ep, mode="drop"),
            cov=new_lines.cov.at[tgt_l].set(cand_cov, mode="drop"),
            fid=new_lines.fid.at[tgt_l].set(ids_l, mode="drop"),
            is_local=new_lines.is_local.at[tgt_l].set(False, mode="drop"),
            match_count=new_lines.match_count.at[tgt_l].set(1, mode="drop"),
            miss_count=new_lines.miss_count.at[tgt_l].set(0, mode="drop"),
        )
        next_id = next_id + jnp.sum(okl.astype(jnp.int32))
    else:
        new_lines = state.lines
        l_evicted = jnp.zeros((ml_cap,), bool)
        l_evict_eps = state.lines.endpoints

    # --- next-frame tracking set (get_tracked_features, local_map.hpp:46-71) ----
    proj_next, proj_next_ok = pinhole.world_to_screen(new_points.pos, new_w2c, cam)
    in_screen = pinhole.is_in_screen_boundaries(proj_next, cam)
    drop_chance = 2 * det_cfg.keypoint_refresh_frequency  # 1/10 drop, local_map.hpp:66
    rand_keep = jax.random.randint(k_drop, (m3,), 0, drop_chance) != 0
    track_cand = maps.alive(new_points) & proj_next_ok & in_screen & rand_keep
    # compact to the first T candidates (optical flow cost is linear in T)
    t_cap = cfg.mapping.max_tracked_points
    cand_rank = jnp.cumsum(track_cand.astype(jnp.int32)) - 1
    sel = track_cand & (cand_rank < t_cap)
    dest = jnp.where(sel, cand_rank, t_cap)
    tracked_uv_next = jnp.zeros((t_cap, 2), dt).at[dest].set(
        proj_next[:, :2], mode="drop")
    tracked_idx_next = jnp.full((t_cap,), -1, jnp.int32).at[dest].set(
        jnp.arange(m3, dtype=jnp.int32), mode="drop")
    tracked_ok_next = jnp.arange(t_cap) < jnp.sum(sel)

    # --- tracking state ----------------------------------------------------
    failed_count = jnp.where(success, 0,
                             jnp.where(first_frame, 0, state.failed_count + 1))
    is_lost = failed_count > cfg.engine.max_failed_tracking
    motion_state, _, _, _ = motion_model.predict_next_pose(
        state.motion, new_quat, new_pos)
    motion_state = jax.tree.map(
        lambda a, b: jnp.where(success, a, b),
        motion_state, motion_model.reset(dt))

    new_state = SlamState(
        quat=new_quat, position=new_pos, pose_cov=new_pose_cov,
        motion=motion_state,
        points=new_points, points2d=new_points2d, planes=new_planes,
        lines=new_lines,
        prev_pyramid=tuple(pyr_cur),
        tracked_uv=tracked_uv_next,
        tracked_ok=tracked_ok_next,
        tracked_map_idx=tracked_idx_next,
        frame_idx=state.frame_idx + 1,
        failed_count=failed_count,
        is_lost=is_lost,
        next_id=next_id,
        key=key,
    )
    output = StepOutput(
        quat=new_quat, position=new_pos, pose_cov=new_pose_cov,
        success=success | first_frame, is_lost=is_lost,
        n_point_matches=jnp.sum(p_matched & pts_alive),
        n_point_inliers=jnp.sum(p_final),
        n_points_alive=jnp.sum(maps.alive(new_points)),
        n_planes_alive=jnp.sum(maps.alive(new_planes)),
        n_detected=jnp.sum(det_valid),
        n_lines=n_lines,
        n_line_matches=jnp.sum(l_final),
        n_lines_alive=jnp.sum(maps.alive(new_lines)),
        n_cylinders=n_cylinders,
        n_plane_merge_dropped=n_merge_dropped,
        cylinder_cells=cylinder_cells,
        point_obs_uv=p_obs_uv,
        point_obs_z=jnp.where(p_obs_depth_ok, p_obs_z, 0.0),
        point_matched=p_final & pts_alive,
        point_fid=pts.fid,
        n_evicted=(jnp.sum(p_evicted) + jnp.sum(q_evicted)
                   + jnp.sum(k_evicted) + jnp.sum(l_evicted)),
        point_evicted=p_evicted,
        point_evict_pos=p_evict_pos,
        point2d_evicted=q_evicted,
        point2d_evict_pos=q_evict_pos,
        plane_evicted=k_evicted,
        plane_evict_params=k_evict[0],
        plane_evict_verts=k_evict[1],
        plane_evict_count=k_evict[2],
        plane_evict_center=k_evict[3],
        plane_evict_u=k_evict[4],
        plane_evict_v=k_evict[5],
        line_evicted=l_evicted,
        line_evict_eps=l_evict_eps,
    )
    return new_state, output

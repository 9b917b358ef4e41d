#!/usr/bin/env python
"""Per-stage device timing of the SLAM engine on the current JAX backend.

Parity with the reference's show_statistics percentage breakdown
(rgbd_slam.cpp:325-347): times each pipeline stage as its own jitted function on
representative shapes, plus the fused full step, and prints a table.
"""

import sys
import time

sys.path.insert(0, "/root/repo")

import jax
import jax.numpy as jnp

from rgbd_slam import engine
from rgbd_slam.config import TUM_FR1, SlamConfig
from rgbd_slam.features import primitives
from rgbd_slam.ops import brief, fast, image, matching, optical_flow
from rgbd_slam.pose.features import MatchedFeatures
from rgbd_slam.pose.optimizer import compute_optimized_pose
from rgbd_slam.synthetic import WallScene, lateral_trajectory


def timeit(name, fn, *args, n=20):
    out = jax.block_until_ready(fn(*args))
    t0 = time.perf_counter()
    for _ in range(n):
        out = fn(*args)
    jax.block_until_ready(out)
    dt = (time.perf_counter() - t0) / n
    print(f"{name:34s} {dt * 1e3:9.3f} ms")
    return dt


def main():
    cam, cfg = TUM_FR1, SlamConfig()
    det = cfg.detection
    scene = WallScene(cam)
    poses = lateral_trajectory(4, speed_mm=4.0)
    (g0, d0), (g1, d1) = scene.render(*poses[0]), scene.render(*poses[1])
    g0, d0, g1, d1 = map(lambda a: jax.device_put(jnp.asarray(a)), (g0, d0, g1, d1))

    state = engine.init_state(cam, cfg)
    state, out = engine.step(state, g0, d0, cam, cfg)
    state, out = engine.step(state, g1, d1, cam, cfg)
    jax.block_until_ready(out)

    levels = det.optical_flow_pyramid_depth
    win_w = cam.width // det.optical_flow_window_width
    win_h = cam.height // det.optical_flow_window_height

    pyr = jax.jit(lambda g: tuple(image.build_pyramid(g, levels)))
    p0 = jax.block_until_ready(pyr(g0))
    total = 0.0
    total += timeit("build_pyramid", pyr, g1)
    p1 = pyr(g1)

    of = jax.jit(lambda a, b, uv, ok: optical_flow.track_forward_backward(
        list(a), list(b), uv, ok,
        max_roundtrip_px=cfg.matching.match_search_radius_px,
        levels=levels, win_h=win_h, win_w=win_w,
        iterations=det.optical_flow_iterations))
    total += timeit("optical_flow fwd+bwd", of, p0, p1, state.tracked_uv,
                    state.tracked_ok)

    def detect(g, uv, ok):
        mask = fast.tracked_points_mask((cam.height, cam.width), uv, ok,
                                        det.tracked_mask_radius_px)
        xy, score, valid = fast.detect_fast_grid(
            g, detection_mask=mask, threshold=float(det.fast_threshold),
            low_threshold=float(det.fast_threshold_low),
            max_points=det.max_point_per_frame,
            cell_rows=det.keypoint_cell_detection_height_count,
            cell_cols=det.keypoint_cell_detection_width_count)
        desc, valid = brief.compute_brief(g, xy, valid)
        return xy, desc, valid

    detect_j = jax.jit(detect)
    total += timeit("FAST + BRIEF", detect_j, g1, state.tracked_uv, state.tracked_ok)
    det_xy, det_desc, det_valid = detect_j(g1, state.tracked_uv, state.tracked_ok)

    m3 = cfg.mapping.max_points_3d
    feat_uv = jnp.zeros((m3, 2), jnp.float32)
    feat_desc = jnp.zeros((m3, det_desc.shape[1]), det_desc.dtype)
    feat_mask = jnp.ones((m3,), bool)

    match_j = jax.jit(lambda: matching.match_descriptors(
        feat_desc, feat_uv, feat_mask, det_desc, det_xy, det_valid,
        jnp.zeros_like(det_valid),
        search_radius=cfg.matching.match_search_radius_px,
        lowe_ratio=cfg.matching.max_match_distance))
    total += timeit("descriptor matching (1 pass)", match_j)

    prim_j = jax.jit(lambda d: primitives.find_primitives(d, cam, det))
    total += timeit("find_primitives (CAPE)", prim_j, d1)

    key = jax.random.PRNGKey(0)
    feats = MatchedFeatures(
        point_obs_uv=jnp.zeros((m3, 2), jnp.float32),
        point_world=jnp.zeros((m3, 3), jnp.float32),
        point_world_std=jnp.ones((m3, 3), jnp.float32),
        point_mask=jnp.arange(m3) < 60,
        point2d_obs_uv=jnp.zeros((cfg.mapping.max_points_2d, 2), jnp.float32),
        point2d_state=jnp.zeros((cfg.mapping.max_points_2d, 6), jnp.float32),
        point2d_state_std=jnp.ones((cfg.mapping.max_points_2d, 6), jnp.float32),
        point2d_mask=jnp.zeros((cfg.mapping.max_points_2d,), bool),
        plane_cam=jnp.zeros((cfg.mapping.max_planes, 4), jnp.float32),
        plane_world=jnp.zeros((cfg.mapping.max_planes, 4), jnp.float32),
        plane_world_std=jnp.ones((cfg.mapping.max_planes, 4), jnp.float32),
        plane_mask=jnp.zeros((cfg.mapping.max_planes,), bool),
        line_obs_p0=jnp.zeros((cfg.mapping.max_lines, 2), jnp.float32),
        line_obs_p1=jnp.zeros((cfg.mapping.max_lines, 2), jnp.float32),
        line_world=jnp.zeros((cfg.mapping.max_lines, 6), jnp.float32),
        line_world_std=jnp.ones((cfg.mapping.max_lines, 6), jnp.float32),
        line_mask=jnp.zeros((cfg.mapping.max_lines,), bool),
    )
    q0 = jnp.asarray([1.0, 0, 0, 0], jnp.float32)
    t0v = jnp.zeros(3, jnp.float32)
    opt_j = jax.jit(lambda k: compute_optimized_pose(
        k, q0, t0v, feats, cam, ransac_cfg=cfg.ransac, engine_cfg=cfg.engine))
    total += timeit("compute_optimized_pose", opt_j, key)

    full = timeit("FULL engine.step (fused)", lambda: engine.step(
        state, g1, d1, cam, cfg)[1])
    print(f"{'sum of stages':34s} {total * 1e3:9.3f} ms")
    print(f"full-step FPS: {1.0 / full:.1f}")


if __name__ == "__main__":
    main()

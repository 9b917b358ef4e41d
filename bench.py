#!/usr/bin/env python
"""Benchmark: frames/s/chip of the full SLAM engine (extract + pose + map update).

Prints ONE JSON line: {"metric": ..., "value": N, "unit": ..., "vs_baseline": N}.

Baseline: the reference claims 200-400 FPS end-to-end on CPU at 640x480
(BASELINE.md; README.md:16) — vs_baseline is measured FPS / 400 (the north-star
frames/s/chip target, BASELINE.json).

Legs (one rendered sequence each; no public dataset in this environment):

1. **Throughput**: steady-state jitted engine steps, donated state, device-resident
   frames, single final sync.  Scene: 640x480 three-plane RoomScene under a 6-DoF
   orbit (rotation + translation) with the Kinect depth-quantization noise model.
2. **Stage breakdown**: a short jax.profiler trace of the steady state, GPU
   device-op time grouped by the jitted function each op sits in (the
   reference's show_statistics percentage table, rgbd_slam.cpp:325-347,
   measured at the op level) plus the device-busy fraction of the wall clock.
3. **Accuracy + live BA**: runner.run_frames(ba_every=8) vs BA off on the same
   frames — full-trajectory Horn-aligned ATE-RMSE and in-system BA iters/s.
4. **Hard scene**: 300-frame orbit through HardRoomScene (depth holes, noise
   bursts, a foreground occluder, a texture-poor band) — the adversarial ATE.
5. **Lines leg**: the room orbit with the line map + line pose residuals ON
   (north-star config 2) — its ATE and fps cost vs points+planes.
6. **Tunnel**: forward flight in the cylindrical TunnelScene (CAPE analogue).

Runs on a GPU only; the JSON line names the device kind, count and the card's
power limit.
"""

import collections
import json
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import rgbd_slam  # noqa: E402, F401
from rgbd_slam import engine, profiling, runner  # noqa: E402
from rgbd_slam.config import TUM_FR1, SlamConfig  # noqa: E402
from rgbd_slam.geometry.covariances import DepthNoiseModel  # noqa: E402
from rgbd_slam.synthetic import (  # noqa: E402
    HardRoomScene, RoomScene, TunnelScene, orbit_trajectory)

N_FRAMES = 120
N_HARD_FRAMES = 300
N_LINES_FRAMES = 80
N_TUNNEL_FRAMES = 100

def render_frames(cam):
    scene = RoomScene(cam, depth_noise=DepthNoiseModel())
    poses = orbit_trajectory(N_FRAMES, speed_mm=4.0)
    # staged: all legs run on device-resident frames
    frames = runner.stage_frames([scene.render(q, p) for q, p in poses])
    gt_pos = np.stack([p for _, p in poses]).astype(np.float64)
    return frames, gt_pos


def bench_throughput(frames_dev, gt_pos, cam, cfg):
    # donate the state: XLA aliases the input/output map buffers, removing the
    # per-frame state copies the non-donating call pays
    step_d = jax.jit(lambda s, g, d: engine.step(s, g, d, cam, cfg),
                     donate_argnums=(0,))

    state = engine.init_state(cam, cfg)
    for g, d in frames_dev[:2]:  # warm up / compile
        state, out = step_d(state, g, d)
    jax.block_until_ready(out)

    outs = []
    t0 = time.time()
    for g, d in frames_dev[2:]:
        state, out = step_d(state, g, d)
        outs.append((out.position, out.success))
    jax.block_until_ready(outs[-1])
    elapsed = time.time() - t0

    fps = len(outs) / elapsed
    final_err = float(jnp.linalg.norm(outs[-1][0] - jnp.asarray(gt_pos[-1])))
    success = bool(outs[-1][1])

    # stage breakdown: trace 8 steady-state steps, group GPU device-op time
    # by the jitted function each op sits in
    with tempfile.TemporaryDirectory() as trace_dir:
        with jax.profiler.trace(trace_dir):
            for g, d in frames_dev[2:10]:
                state, out = step_d(state, g, d)
            jax.block_until_ready(out)
        stages, device_us = _parse_trace(trace_dir, n_frames=8)
    return fps, final_err, success, stages, device_us


def _parse_trace(trace_dir, n_frames):
    by_stage = collections.Counter()
    for _, dur_ns, stats in profiling.gpu_events(trace_dir):
        by_stage[profiling.stage_of(str(stats.get("name", "")))] += dur_ns
    stages = {k: round(v / 1e3 / n_frames, 1)
              for k, v in by_stage.most_common()}
    return stages, sum(by_stage.values()) / 1e3 / n_frames


def bench_accuracy(frames, gt_pos, cam, cfg):
    """Full-trajectory ATE with the BA backend live in the loop (ba_every=8),
    plus the BA-off ablation on the SAME frames."""
    state, traj, stats = runner.run_frames(frames, cam, cfg, with_planes=True,
                                           ba_every=8)
    metrics = runner.evaluate_against_ground_truth(traj, gt_pos)
    _, traj_off, _ = runner.run_frames(frames, cam, cfg, with_planes=True)
    metrics_off = runner.evaluate_against_ground_truth(traj_off, gt_pos)
    return metrics["ate_rmse_mm"], metrics_off["ate_rmse_mm"], stats


def bench_hard(cam, cfg):
    """300 frames through the pathology scene (holes, bursts, occluder, weak
    texture) with live BA — the adversarial ATE (VERDICT r3 weak #4).

    Reported as the MEDIAN over 3 engine seeds: hard-scene ATE is chaotically
    sensitive to the RANSAC/feature RNG stream (measured 29 -> 70 mm from a
    perturbation that changed nothing but slot order), so a single seed is a
    lottery draw, not a metric.  The motion-model-prediction ablation
    (VERDICT r4 #9, motion_model.cpp:29-71) runs on the same seeds."""
    import dataclasses

    scene = HardRoomScene(cam, depth_noise=DepthNoiseModel())
    poses = orbit_trajectory(N_HARD_FRAMES, speed_mm=4.0)
    frames = runner.stage_frames([scene.render(q, p) for q, p in poses])
    gt = np.stack([p for _, p in poses]).astype(np.float64)

    def runs(run_cfg):
        ates, lost = [], 0
        for seed in (0, 1, 2):
            _, traj, stats = runner.run_frames(frames, cam, run_cfg,
                                               with_planes=True, ba_every=8,
                                               seed=seed)
            ates.append(runner.evaluate_against_ground_truth(
                traj, gt)["ate_rmse_mm"])
            lost = max(lost, stats.lost_count)
        return sorted(ates), lost

    ates, lost = runs(cfg)
    cfg_pred = dataclasses.replace(cfg, engine=dataclasses.replace(
        cfg.engine, use_motion_model_prediction=True))
    ates_pred, lost_pred = runs(cfg_pred)
    return ates, lost, ates_pred, lost_pred


def bench_roll(cam, cfg):
    """Roll-heavy leg (fr1_rpy analogue, VERDICT r4 #7): +-30 deg roll about
    the optical axis — the rotation BRIEF is not invariant to.  Measures the
    documented rotation-robustness bound of the BRIEF+LK pipeline (the
    reference's answer is its ORB build option, keypoint_detection.cpp:34-45)."""
    from rgbd_slam.synthetic import roll_trajectory

    scene = RoomScene(cam, depth_noise=DepthNoiseModel())
    poses = roll_trajectory(N_FRAMES)
    frames = runner.stage_frames([scene.render(q, p) for q, p in poses])
    gt = np.stack([p for _, p in poses]).astype(np.float64)
    _, traj, stats = runner.run_frames(frames, cam, cfg, with_planes=True,
                                       ba_every=8)
    m = runner.evaluate_against_ground_truth(traj, gt)
    return m["ate_rmse_mm"], stats.lost_count


def bench_lines(frames, gt_pos, cam, cfg):
    """North-star config 2 (points+lines in the pose): the room orbit with the
    line map on — end-to-end ATE + throughput of the lines build.

    Throughput uses the same methodology as the flagship leg (donated state,
    device-resident frames, single final sync) so lines_fps and the headline
    fps are directly comparable; the ATE comes from the full runner loop."""
    sub = frames[:N_LINES_FRAMES]
    _, traj, stats = runner.run_frames(sub, cam, cfg, with_planes=True,
                                       with_lines=True)
    m = runner.evaluate_against_ground_truth(traj, gt_pos[:N_LINES_FRAMES])

    step_d = jax.jit(lambda s, g, d: engine.step(s, g, d, cam, cfg,
                                                 with_lines=True),
                     donate_argnums=(0,))
    state = engine.init_state(cam, cfg)
    for g, d in sub[:2]:
        state, out = step_d(state, g, d)
    jax.block_until_ready(out)
    outs = []
    t0 = time.time()
    for g, d in sub[2:]:
        state, out = step_d(state, g, d)
        outs.append(out.success)
    jax.block_until_ready(outs[-1])
    lines_fps = len(outs) / (time.time() - t0)
    return m["ate_rmse_mm"], lines_fps


def bench_lines_lowtex(cam, cfg):
    """The scene lines are FOR (VERDICT r4 #2): a low-texture striped wall
    (contrast crushed to ~12%) where the corner detector starves but stripe
    edges remain — lines-on must beat lines-off here, the capability the
    reference's (compiled-out) line path was designed toward
    (line_detection.cpp, rgbd_slam.cpp:304-313)."""
    from rgbd_slam.synthetic import StripeWallScene, lateral_trajectory

    # corner-starved: dense stripes in one direction (lines everywhere), the
    # cross direction nearly stripe-free (few intersections = few corners),
    # block texture crushed below the FAST low-tier threshold
    scene = StripeWallScene(cam, texture_scale=0.03, stripe_period_z=2400.0)
    poses = lateral_trajectory(N_LINES_FRAMES, speed_mm=4.0)
    frames = runner.stage_frames([scene.render(q, p) for q, p in poses])
    gt = np.stack([p for _, p in poses]).astype(np.float64)
    _, t_off, _ = runner.run_frames(frames, cam, cfg, with_planes=False)
    off = runner.evaluate_against_ground_truth(t_off, gt)["ate_rmse_mm"]
    _, t_on, _ = runner.run_frames(frames, cam, cfg, with_planes=False,
                                   with_lines=True)
    on = runner.evaluate_against_ground_truth(t_on, gt)["ate_rmse_mm"]
    return on, off


def tunnel_trajectory(n_frames):
    """Forward flight along the tunnel axis (world x) with slow yaw — the
    CAPE-tunnel analogue run (north-star config 3, main_CAPE.cpp:48-65)."""
    from rgbd_slam.synthetic import _quat_from_euler
    poses = []
    for i in range(n_frames):
        quat = _quat_from_euler(np.radians(0.03) * i, 0.0, 0.0)
        pos = np.array([8.0 * i, 0.3 * i, 0.2 * i], np.float32)
        poses.append((quat, pos))
    return poses


def bench_tunnel(cam, cfg):
    """Full-sequence ATE inside the cylindrical tunnel with planes+cylinders
    on — BA-on and BA-off, so the backend earns its place on both flagship
    scenes."""
    scene = TunnelScene(cam)
    poses = tunnel_trajectory(N_TUNNEL_FRAMES)
    frames = runner.stage_frames([scene.render(q, p) for q, p in poses])
    gt = np.stack([p for _, p in poses]).astype(np.float64)
    _, traj_off, _ = runner.run_frames(frames, cam, cfg, with_planes=True)
    off = runner.evaluate_against_ground_truth(traj_off, gt)["ate_rmse_mm"]
    _, traj_on, _ = runner.run_frames(frames, cam, cfg, with_planes=True,
                                      ba_every=8)
    on = runner.evaluate_against_ground_truth(traj_on, gt)["ate_rmse_mm"]
    return on, off


def main():
    dev = profiling.require_gpu()
    card = profiling.gpu_card()
    cam, cfg = TUM_FR1, SlamConfig()
    frames, gt_pos = render_frames(cam)

    fps, final_err, success, stages, device_us = bench_throughput(
        frames, gt_pos, cam, cfg)
    ate_mm, ate_off_mm, stats = bench_accuracy(frames, gt_pos, cam, cfg)
    hard_ates, hard_lost, hard_ates_pred, hard_lost_pred = bench_hard(cam, cfg)
    lines_ate_mm, lines_fps = bench_lines(frames, gt_pos, cam, cfg)
    lt_on, lt_off = bench_lines_lowtex(cam, cfg)
    roll_ate_mm, roll_lost = bench_roll(cam, cfg)
    tunnel_ate_mm, tunnel_ate_off_mm = bench_tunnel(cam, cfg)

    wall_us = 1e6 / fps if fps > 0 else 0.0
    result = {
        "metric": "frames_per_second_per_chip",
        "value": round(fps, 2),
        "unit": "fps@640x480",
        "vs_baseline": round(fps / 400.0, 4),
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices()), "card": card},
        "stage_us_per_frame": stages,
        "device_us_per_frame": round(device_us, 1),
        "device_busy_fraction": round(device_us / wall_us, 3) if wall_us else 0,
        "ate_rmse_mm": round(ate_mm, 3),
        "ate_ba_off_mm": round(ate_off_mm, 3),
        "ate_frames": N_FRAMES,
        "ate_hard_mm": round(hard_ates[1], 3),  # median of 3 seeds
        "ate_hard_seeds_mm": [round(a, 3) for a in hard_ates],
        "ate_hard_pred_mm": round(hard_ates_pred[1], 3),
        "ate_hard_pred_seeds_mm": [round(a, 3) for a in hard_ates_pred],
        "hard_frames": N_HARD_FRAMES,
        "hard_lost_frames": hard_lost,
        "hard_lost_frames_pred": hard_lost_pred,
        "ate_roll_mm": round(roll_ate_mm, 3),
        "roll_lost_frames": roll_lost,
        "ate_lines_mm": round(lines_ate_mm, 3),
        "lines_fps": round(lines_fps, 1),
        "lines_frames": N_LINES_FRAMES,
        "ate_lowtex_lines_mm": round(lt_on, 3),
        "ate_lowtex_nolines_mm": round(lt_off, 3),
        "ate_tunnel_mm": round(tunnel_ate_mm, 3),
        "ate_tunnel_ba_off_mm": round(tunnel_ate_off_mm, 3),
        "tunnel_frames": N_TUNNEL_FRAMES,
        "final_pose_error_mm": round(final_err, 2),
        "tracking_success": success,
        "ba_iters_per_s": round(stats.ba_iters_per_s, 1),
        "ba_runs": stats.ba_runs,
        "ba_accepted": stats.ba_accepted,
    }
    print(json.dumps(result))


if __name__ == "__main__":
    main()

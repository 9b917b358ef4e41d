"""Windowed Schur-complement BA tests: convergence on synthetic windows and
single-device vs. sharded-mesh equivalence (the SURVEY.md §7 correctness anchor)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh

from rgbd_slam.config import CameraIntrinsics
from rgbd_slam.geometry import pinhole, se3
from rgbd_slam.parallel import ba

CAM = CameraIntrinsics(width=640, height=480, fx=520.0, fy=520.0, cx=320.0, cy=240.0)
K, L, C = 6, 128, 4


def make_window(rng, noise_px=0.0, K=K, L=L, C=C):
    """Synthetic keyframe window: camera sliding laterally, landmarks on a slab."""
    gt_poses = []
    for i in range(K):
        quat = se3.quat_from_axis_angle(jnp.array([0.0, 0.0, 1.0]),
                                        jnp.float32(0.01 * i))
        pos = jnp.asarray([20.0 * i, 30.0 * i, 5.0 * i], jnp.float32)
        gt_poses.append(se3.pose_to_coefficients(quat, pos))
    gt_poses = jnp.stack(gt_poses)

    landmarks = jnp.asarray(np.concatenate([
        rng.uniform(2000, 4000, (L, 1)),
        rng.uniform(-1500, 1500, (L, 2))], axis=1), jnp.float32)

    # each landmark observed in C random keyframes
    obs_kf = jnp.asarray(rng.integers(0, K, (L, C)), jnp.int32)

    def project(pose6, lm):
        quat, pos = se3.coefficients_to_pose(pose6)
        w2c = se3.world_to_camera(quat, pos)
        s, v = pinhole.world_to_screen(lm, w2c, CAM)
        return s[:2], v

    uv = np.zeros((L, C, 2), np.float32)
    mask = np.zeros((L, C), bool)
    for l in range(L):
        for c in range(C):
            s, v = project(gt_poses[int(obs_kf[l, c])], landmarks[l])
            uv[l, c] = np.asarray(s)
            mask[l, c] = bool(v)
    uv += rng.normal(0, noise_px, uv.shape).astype(np.float32)
    return gt_poses, landmarks, obs_kf, jnp.asarray(uv), jnp.asarray(mask)


def perturb(rng, gt_poses, landmarks, pose_mm=30.0, lm_mm=40.0):
    """Perturb all poses except keyframe 0 (the gauge anchor) and all landmarks."""
    dp = rng.normal(0, 1, gt_poses.shape).astype(np.float32)
    dp[:, :3] *= pose_mm
    dp[:, 3:] *= 0.01
    dp[0] = 0.0
    dl = rng.normal(0, lm_mm, landmarks.shape).astype(np.float32)
    return gt_poses + jnp.asarray(dp), landmarks + jnp.asarray(dl)


class TestSingleDeviceBA:
    @pytest.mark.smoke
    def test_converges_to_ground_truth(self, rng):
        gt_poses, gt_lm, obs_kf, uv, mask = make_window(rng)
        poses0, lm0 = perturb(rng, gt_poses, gt_lm)
        poses, lms, costs = ba.ba_solve(poses0, lm0, obs_kf, uv, mask, CAM,
                                        iterations=12)
        # cost monotonically (mostly) decreasing and tiny at the end
        assert float(costs[-1]) < float(costs[0]) * 1e-3
        pos_err = np.abs(np.asarray(poses[:, :3] - gt_poses[:, :3]))
        assert pos_err.max() < 5.0, f"pose error {pos_err.max():.1f}mm"

    def test_noisy_observations_still_converge(self, rng):
        gt_poses, gt_lm, obs_kf, uv, mask = make_window(rng, noise_px=0.3)
        poses0, lm0 = perturb(rng, gt_poses, gt_lm)
        poses, lms, costs = ba.ba_solve(poses0, lm0, obs_kf, uv, mask, CAM,
                                        iterations=12)
        pos_err = np.abs(np.asarray(poses[:, :3] - gt_poses[:, :3]))
        assert pos_err.max() < 20.0

    def test_gauge_fixed(self, rng):
        gt_poses, gt_lm, obs_kf, uv, mask = make_window(rng)
        poses0, lm0 = perturb(rng, gt_poses, gt_lm)
        poses, _, _ = ba.ba_solve(poses0, lm0, obs_kf, uv, mask, CAM,
                                  iterations=4)
        np.testing.assert_allclose(np.asarray(poses[0]), np.asarray(poses0[0]),
                                   atol=1e-5)


class TestShardedBA:
    def test_matches_single_device(self, rng):
        gt_poses, gt_lm, obs_kf, uv, mask = make_window(rng)
        poses0, lm0 = perturb(rng, gt_poses, gt_lm)

        ref_poses, ref_lm, ref_costs = ba.ba_solve(
            poses0, lm0, obs_kf, uv, mask, CAM, iterations=6)

        devices = np.array(jax.devices()[:8]).reshape(8)
        mesh = Mesh(devices, ("lm",))
        fn = ba.make_sharded_ba(mesh, CAM, n_keyframes=K, iterations=6)
        sh_poses, sh_lm, sh_costs = fn(poses0, lm0, obs_kf, uv, mask)

        np.testing.assert_allclose(np.asarray(sh_costs), np.asarray(ref_costs),
                                   rtol=2e-3)
        np.testing.assert_allclose(np.asarray(sh_poses), np.asarray(ref_poses),
                                   atol=2e-2)
        np.testing.assert_allclose(np.asarray(sh_lm), np.asarray(ref_lm),
                                   atol=1.0)

    def test_pcg_reduced_solve_matches_dense(self, rng):
        """The row-block-sharded PCG reduced solve (no device holds the dense
        [6K, 6K]) must reproduce the replicated-Cholesky path: both SURVEY
        §2.10 partition axes — landmark blocks for elimination, keyframe row
        blocks for the reduced system — on one 8-device mesh."""
        k8 = 8  # 6*K must divide the mesh axis (48 / 8)
        gt_poses, gt_lm, obs_kf, uv, mask = make_window(rng, K=k8, L=128, C=4)
        poses0, lm0 = perturb(rng, gt_poses, gt_lm)

        ref_poses, ref_lm, ref_costs = ba.ba_solve(
            poses0, lm0, obs_kf, uv, mask, CAM, iterations=5)

        devices = np.array(jax.devices()[:8]).reshape(8)
        mesh = Mesh(devices, ("lm",))
        fn = ba.make_sharded_ba(mesh, CAM, n_keyframes=k8, iterations=5,
                                reduced_solver="pcg")
        sh_poses, sh_lm, sh_costs = fn(poses0, lm0, obs_kf, uv, mask)

        assert np.isfinite(np.asarray(sh_poses)).all()
        np.testing.assert_allclose(np.asarray(sh_costs), np.asarray(ref_costs),
                                   rtol=5e-3)
        np.testing.assert_allclose(np.asarray(sh_poses), np.asarray(ref_poses),
                                   atol=5e-2)

    @pytest.mark.parametrize("solver", ["dense", "pcg"])
    def test_anchored_with_depth_matches_single_device(self, rng, solver):
        """The live-pipeline solve (odometry/map anchors + measured depth) on
        the mesh, with either reduced solver, reproduces the one-device solve."""
        k8 = 8  # 6*K must divide the mesh axis (48 / 8)
        gt_poses, gt_lm, obs_kf, uv, mask = make_window(rng, K=k8, L=128, C=4)
        poses0, lm0 = perturb(rng, gt_poses, gt_lm)
        obs_z = jnp.where(mask, gt_lm[:, None, 0] + 5.0, 0.0)

        ref_poses, _, ref_costs = ba.ba_solve(
            poses0, lm0, obs_kf, uv, mask, CAM, iterations=5, anchored=True,
            obs_z=obs_z)
        mesh = Mesh(np.array(jax.devices()[:8]).reshape(8), ("lm",))
        fn = ba.make_sharded_ba(mesh, CAM, n_keyframes=k8, iterations=5,
                                anchored=True, reduced_solver=solver,
                                with_depth=True)
        sh_poses, _, sh_costs = fn(poses0, lm0, obs_kf, uv, mask, obs_z)

        np.testing.assert_allclose(np.asarray(sh_costs), np.asarray(ref_costs),
                                   rtol=2e-3)
        np.testing.assert_allclose(np.asarray(sh_poses), np.asarray(ref_poses),
                                   atol=2e-2)

    def test_chip_smoke_four_card_path(self):
        """chip_smoke.py --four-cards on 4 of the virtual devices: a full
        keyframe window refined through the runner's sharded solve and the
        pcg reduced solve, each checked against the one-device refine."""
        import os
        import sys

        sys.path.insert(0, os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))))
        import chip_smoke

        res = chip_smoke.sharded_ba(jax.devices()[:4])
        assert res["landmarks"] > 256
        assert res["dense"][-1] < 0.5 * res["dense"][0]
        assert len(res["pcg"]) == len(res["one_device"]) == 8

    def test_ba_iters_per_second_positive(self, rng):
        import time

        gt_poses, gt_lm, obs_kf, uv, mask = make_window(rng)
        poses0, lm0 = perturb(rng, gt_poses, gt_lm)
        devices = np.array(jax.devices()[:8]).reshape(8)
        mesh = Mesh(devices, ("lm",))
        fn = ba.make_sharded_ba(mesh, CAM, n_keyframes=K, iterations=6)
        out = jax.block_until_ready(fn(poses0, lm0, obs_kf, uv, mask))
        t0 = time.time()
        out = jax.block_until_ready(fn(poses0, lm0, obs_kf, uv, mask))
        iters_per_s = 6 / (time.time() - t0)
        assert iters_per_s > 0


@pytest.mark.slow
class TestKeyframeWindow:
    def _run_engine_window(self):
        import jax.numpy as jnp

        from rgbd_slam import engine
        from rgbd_slam.config import (CameraIntrinsics, EngineConfig,
                                          MappingConfig, SlamConfig)
        from rgbd_slam.parallel.keyframes import KeyframeWindow
        from rgbd_slam.synthetic import WallScene, lateral_trajectory

        cam = CameraIntrinsics(width=320, height=240, fx=260.0, fy=260.0,
                               cx=160.0, cy=120.0)
        cfg = SlamConfig(
            mapping=MappingConfig(max_points_3d=128, max_points_2d=32,
                                  max_planes=8, max_tracked_points=64),
            engine=EngineConfig(pose_covariance_mc_iterations=8,
                                lm_iterations=8, ransac_hypothesis_batch=16))
        scene = WallScene(cam)
        poses = lateral_trajectory(6)
        window = KeyframeWindow(max_keyframes=6)
        state = engine.init_state(cam, cfg)
        for i, (q, p) in enumerate(poses):
            g, d = scene.render(q, p)
            state, out = engine.step(state, jnp.asarray(g), jnp.asarray(d),
                                     cam, cfg)
            window.add_keyframe(out.quat, out.position, out, state.points.pos,
                                timestamp=i)
        return cam, window, poses

    def test_window_collects_observations(self):
        cam, window, poses = self._run_engine_window()
        assert window.n_keyframes == 6
        multi = [e for e in window.obs.values() if len(e) >= 2]
        assert len(multi) >= 20, f"only {len(multi)} multi-view landmarks"

    def test_refine_reduces_cost_and_keeps_trajectory(self):
        cam, window, poses = self._run_engine_window()
        result = window.refine(cam, iterations=6)
        assert result is not None
        refined, lm, costs = result
        assert costs[-1] <= costs[0] * 1.05
        # refined keyframe positions stay close to ground truth
        for (q, p), (gt_q, gt_p) in zip(refined, poses):
            assert np.linalg.norm(p - np.asarray(gt_p)) < 15.0

    def test_refine_apply_feeds_back(self, rng):
        """apply_refinement writes refined poses/landmarks into the window."""
        cam, window, poses = self._run_engine_window()
        result = window.refine(cam, iterations=6)
        assert result is not None
        refined, lm, costs = result
        window.apply_refinement(refined, lm)
        from rgbd_slam.geometry import se3
        q0, p0 = refined[-1]
        np.testing.assert_allclose(
            window.poses[-1],
            np.asarray(se3.pose_to_coefficients(jnp.asarray(q0, jnp.float32),
                                                jnp.asarray(p0, jnp.float32))),
            atol=1e-5)

    def test_window_slides(self):
        from rgbd_slam.parallel.keyframes import KeyframeWindow

        class FakeOut:
            def __init__(self):
                self.point_matched = np.zeros(4, bool)
                self.point_fid = np.full(4, -1)
                self.point_obs_uv = np.zeros((4, 2))

        w = KeyframeWindow(max_keyframes=3)
        for i in range(5):
            w.add_keyframe(np.array([1.0, 0, 0, 0]), np.zeros(3), FakeOut(),
                           np.zeros((4, 3)), timestamp=i)
        assert w.n_keyframes == 3
        assert w.timestamps == [2.0, 3.0, 4.0]


@pytest.mark.slow
class TestLiveBAIntegration:
    """run_frames(ba_every=N): the BA backend runs inside the live pipeline,
    scatters refined landmarks back into the map and retro-corrects the
    trajectory (fills the reference's update_local_to_global TODO,
    local_map.hpp:263-266)."""

    def _run(self, ba_every=None):
        from rgbd_slam.config import (DepthNoiseModel, EngineConfig,
                                          MappingConfig, SlamConfig)
        from rgbd_slam.runner import evaluate_against_ground_truth, run_frames
        from rgbd_slam.synthetic import RoomScene, orbit_trajectory

        cam = CameraIntrinsics(width=320, height=240, fx=260.0, fy=260.0,
                               cx=160.0, cy=120.0)
        cfg = SlamConfig(
            mapping=MappingConfig(max_points_3d=128, max_points_2d=32,
                                  max_planes=8, max_tracked_points=64),
            engine=EngineConfig(pose_covariance_mc_iterations=8,
                                lm_iterations=8, ransac_hypothesis_batch=16))
        scene = RoomScene(cam, depth_noise=DepthNoiseModel())
        # long enough for real odometry drift to accumulate: on short
        # near-driftless runs windowed BA has nothing to correct and its
        # loose anchors only add noise (the flagship 120-frame bench is the
        # headline evidence; this is its scaled-down counterpart)
        poses = orbit_trajectory(70, speed_mm=5.0, yaw_rate_d=0.2)
        frames = [scene.render(q, p) for q, p in poses]
        gt = np.stack([p for _, p in poses])
        _, traj, stats = run_frames(frames, cam, cfg, with_planes=True,
                                    ba_every=ba_every, ba_window=8,
                                    ba_iterations=6)
        ate = evaluate_against_ground_truth(traj, gt)["ate_rmse_mm"]
        return ate, stats

    def test_ba_on_no_worse_than_ba_off(self):
        """No-harm guard at test scale: at 320x240 over 70 frames the
        accumulated drift is small and depth-BA lands within noise of
        odometry (measured 12.19 vs 12.11 mm).  The STRICT beat is asserted
        where it matters and reproduces: the 640x480 120-frame flagship bench
        (bench.py ate_rmse_mm < ate_ba_off_mm, r4: 14.3 vs 16.3 mm room,
        7.4 vs 7.9 mm tunnel) — this test exists to catch the r2/r3 failure
        mode where live BA actively degraded the trajectory."""
        ate_off, _ = self._run(ba_every=None)
        ate_on, stats = self._run(ba_every=4)
        assert stats.ba_runs >= 3, f"BA only ran {stats.ba_runs} times"
        assert stats.ba_accepted >= 1, "no BA solve was accepted"
        assert stats.ba_iters_per_s > 0
        assert np.isfinite(ate_on) and np.isfinite(ate_off)
        assert ate_on <= ate_off * 1.08, (
            f"BA-on ATE {ate_on:.2f}mm must not degrade BA-off "
            f"{ate_off:.2f}mm")


class TestDistributedInit:
    def test_single_process_is_noop(self, monkeypatch):
        """Without coordinator env vars the multi-host hook must be a no-op
        (single-process dev boxes, CI, and the bench all hit this path)."""
        monkeypatch.delenv("JAX_COORDINATOR_ADDRESS", raising=False)
        monkeypatch.delenv("JAX_NUM_PROCESSES", raising=False)
        assert ba.init_distributed() is False
        # explicit single-process args are also a no-op
        assert ba.init_distributed(coordinator_address="host:1234",
                                   num_processes=1) is False

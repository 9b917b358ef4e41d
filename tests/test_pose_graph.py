"""Pose-graph layer tests (parallel/pose_graph.py).

The pose graph is the north-star inter-window consistency layer (SURVEY.md §5;
the reference's empty ``update_local_to_global`` TODO, local_map.hpp:263-266).
Three tiers, mirroring the reference's test style (SURVEY.md §4): solver
round-trip on a known problem, layer-level behavior (graph beats raw odometry
chaining when better relative estimates exist), and live-runner integration.
"""

import numpy as np
import pytest

import jax.numpy as jnp

from rgbd_slam.geometry import se3
from rgbd_slam.parallel.pose_graph import (
    PoseGraph, _np_rel_coeffs, np_compose, np_relative, solve_pose_graph)


def _coeffs(quat, pos):
    return np.asarray(se3.pose_to_coefficients(
        jnp.asarray(quat, jnp.float32), jnp.asarray(pos, jnp.float32)))


def _gt_chain(n, seed=0, step_mm=25.0, yaw_step=0.02):
    """Ground-truth pose chain with rotation (quats, positions)."""
    rng = np.random.default_rng(seed)
    quats, positions = [np.array([1.0, 0.0, 0.0, 0.0])], [np.zeros(3)]
    for _ in range(n - 1):
        ang = yaw_step * (1 + 0.3 * rng.standard_normal())
        dq = np.array([np.cos(ang / 2), 0.0, 0.0, np.sin(ang / 2)])
        dp = np.array([step_mm, 0.3 * step_mm, 0.0]) \
            + rng.standard_normal(3) * 2.0
        q, p = np_compose(quats[-1], positions[-1], dq, dp)
        quats.append(q / np.linalg.norm(q))
        positions.append(p)
    return quats, positions


class TestSolver:
    def test_exact_edges_recover_drifted_nodes(self):
        """Exact relative measurements + drifted node estimates -> the solve
        pulls every node back onto the ground-truth chain (gauge = node 0)."""
        n = 12
        quats, positions = _gt_chain(n)
        rng = np.random.default_rng(3)

        poses = np.zeros((n, 6), np.float32)
        poses[0] = _coeffs(quats[0], positions[0])
        for i in range(1, n):
            noisy_p = positions[i] + rng.standard_normal(3) * 30.0
            poses[i] = _coeffs(quats[i], noisy_p)

        m = 2 * (n - 1)
        ei = np.zeros((m,), np.int32)
        ej = np.zeros((m,), np.int32)
        meas = np.zeros((m, 6), np.float32)
        w = np.zeros((m,), np.float32)
        for i in range(n - 1):
            q_rel, p_rel = np_relative(quats[i], positions[i],
                                       quats[i + 1], positions[i + 1])
            ei[i], ej[i] = i, i + 1
            meas[i] = _np_rel_coeffs(q_rel, p_rel)
            w[i] = 1.0
        # remaining rows stay weight-0 padding (also exercises the mask)

        refined, costs = solve_pose_graph(
            jnp.asarray(poses), jnp.asarray(ei), jnp.asarray(ej),
            jnp.asarray(meas), jnp.asarray(w), iterations=10)
        refined = np.asarray(refined)
        costs = np.asarray(costs)

        assert costs[-1] < 1e-3 * costs[0]
        err0 = np.linalg.norm(poses[:, :3] - np.stack(positions), axis=1)
        err1 = np.linalg.norm(refined[:, :3] - np.stack(positions), axis=1)
        assert err1.max() < 1.0
        assert err1.max() < 0.05 * err0.max()

    def test_padding_nodes_untouched(self):
        n, cap = 5, 8
        quats, positions = _gt_chain(n)
        poses = np.zeros((cap, 6), np.float32)
        for i in range(n):
            poses[i] = _coeffs(quats[i], positions[i])
        pad_before = poses[n:].copy()
        ei = np.array([0, 1, 2, 3] + [0] * 4, np.int32)
        ej = np.array([1, 2, 3, 4] + [0] * 4, np.int32)
        meas = np.zeros((8, 6), np.float32)
        w = np.zeros((8,), np.float32)
        for i in range(4):
            q_rel, p_rel = np_relative(quats[i], positions[i],
                                       quats[i + 1], positions[i + 1])
            meas[i] = _np_rel_coeffs(q_rel, p_rel)
            w[i] = 1.0
        refined, _ = solve_pose_graph(
            jnp.asarray(poses), jnp.asarray(ei), jnp.asarray(ej),
            jnp.asarray(meas), jnp.asarray(w), iterations=5)
        np.testing.assert_allclose(np.asarray(refined)[n:], pad_before,
                                   atol=1e-5)


class TestPoseGraphLayer:
    def test_ba_edges_beat_odometry_chain(self):
        """The north-star scenario (VERDICT r2 next #5): odometry drifts, the
        windowed backend produces better relative poses for keyframes it saw
        together; the graph re-chains those relatives so the ABSOLUTE
        trajectory beats raw odometry chaining (= windowed BA without a
        stitching layer) on ATE."""
        n = 60  # keyframes of a long sequence (~300 frames at 1 kf / 5 frames)
        quats, positions = _gt_chain(n, seed=1)
        rng = np.random.default_rng(7)

        graph = PoseGraph(max_nodes=64, max_edges=256)
        # odometry: relative poses with a systematic bias + noise -> drift
        odo_q = [quats[0]]
        odo_p = [positions[0]]
        for i in range(1, n):
            q_rel, p_rel = np_relative(quats[i - 1], positions[i - 1],
                                       quats[i], positions[i])
            p_rel_noisy = p_rel + np.array([1.2, 0.8, 0.3]) \
                + rng.standard_normal(3) * 0.5
            q, p = np_compose(odo_q[-1], odo_p[-1], q_rel, p_rel_noisy)
            odo_q.append(q)
            odo_p.append(p)
        for i in range(n):
            graph.add_keyframe(i * 5, odo_q[i], odo_p[i])

        ate_odo = np.sqrt(np.mean(np.sum(
            (np.stack(odo_p) - np.stack(positions)) ** 2, axis=1)))

        # BA windows (8 keyframes, sliding by 4): near-ground-truth relatives
        for start in range(0, n - 8, 4):
            fids = [(start + j) * 5 for j in range(8)]
            refined = [(quats[start + j],
                        positions[start + j] + rng.standard_normal(3) * 0.2)
                       for j in range(8)]
            graph.add_ba_window(fids, refined)

        solved = graph.solve(iterations=10)
        assert solved is not None
        _, rq, rp = solved
        ate_graph = np.sqrt(np.mean(np.sum(
            (rp - np.stack(positions)) ** 2, axis=1)))
        assert ate_graph < 0.3 * ate_odo

    def test_node_overflow_drops_oldest(self):
        graph = PoseGraph(max_nodes=4, max_edges=16)
        for i in range(6):
            graph.add_keyframe(i, np.array([1.0, 0, 0, 0]),
                               np.array([10.0 * i, 0, 0]))
        assert graph.dropped_nodes == 2
        assert graph.frame_ids == [2, 3, 4, 5]
        assert all(2 <= a and 2 <= b for a, b, _ in graph.edges)

    def test_odometry_and_ba_edges_coexist(self):
        """A BA edge on a pair must NOT replace its odometry edge — both
        constraints compete with their own weights (ADVICE r3)."""
        graph = PoseGraph(max_nodes=8, max_edges=32)
        q = np.array([1.0, 0, 0, 0])
        for i in range(3):
            graph.add_keyframe(i, q, np.array([10.0 * i, 0, 0]))
        refined = [(q, np.array([0.0, 0, 0])), (q, np.array([11.0, 0, 0])),
                   (q, np.array([21.0, 0, 0]))]
        graph.add_ba_window([0, 1, 2], refined)
        kinds = {k[2] for k in graph.edges}
        assert kinds == {"odom", "ba"}
        assert (0, 1, "odom") in graph.edges and (0, 1, "ba") in graph.edges


@pytest.mark.slow
class TestRunnerIntegration:
    @pytest.fixture(scope="class")
    def scene_run(self):
        from rgbd_slam import runner
        from rgbd_slam.config import CameraIntrinsics, SlamConfig
        from rgbd_slam.synthetic import RoomScene, orbit_trajectory

        cam = CameraIntrinsics(width=320, height=240, fx=260.0, fy=260.0,
                               cx=160.0, cy=120.0)
        cfg = SlamConfig()
        scene = RoomScene(cam)
        traj_gt = orbit_trajectory(60, speed_mm=6.0)
        frames = [scene.render(q, p) for q, p in traj_gt]
        gt = np.stack([p for _, p in traj_gt]).astype(np.float64)
        return frames, gt, cam, cfg

    def test_live_ba_with_graph_tracks(self, scene_run):
        """Keyframe-gated BA + pose graph runs live and stays accurate: the
        anchored window must not degrade the trajectory (the r2 bench showed
        un-anchored BA tripling ATE — this is the regression gate)."""
        from rgbd_slam import runner
        frames, gt, cam, cfg = scene_run
        _, traj_off, _ = runner.run_frames(frames, cam, cfg, with_planes=True)
        ate_off = runner.evaluate_against_ground_truth(
            traj_off, gt)["ate_rmse_mm"]
        _, traj_ba, stats = runner.run_frames(frames, cam, cfg,
                                              with_planes=True, ba_every=8)
        ate_ba = runner.evaluate_against_ground_truth(
            traj_ba, gt)["ate_rmse_mm"]
        assert stats.ba_runs >= 3
        assert stats.ba_accepted >= 1
        assert ate_ba < max(1.25 * ate_off, ate_off + 5.0)
        # golden-trajectory budget (VERDICT r2 next #4): this scene family runs
        # at ~17-19 mm ATE; regression fails above 30 mm
        assert ate_off < 30.0
        assert ate_ba < 30.0

    def test_keyframe_selection_gates_frames(self, scene_run):
        """The window must hold SELECTED keyframes (motion-gated), not every
        frame (VERDICT r2 missing #3): with 6 mm/frame motion and a 20 mm
        gate, keyframes are ~1 in 3-4 frames."""
        from rgbd_slam import runner
        frames, gt, cam, cfg = scene_run
        _, traj, stats = runner.run_frames(frames, cam, cfg, with_planes=True,
                                           ba_every=8)
        assert stats.ba_runs >= 3
        assert 5 <= stats.keyframe_count <= len(frames) // 2

"""Line segment detector tests on synthetic imagery (the reference has none — LSD is
compiled out of its main loop; this is capability parity with upstream's planned
point/line design, reference README.md:134-136)."""

import numpy as np
import jax.numpy as jnp

from rgbd_slam.features import lines
import pytest


def draw_line(img, p0, p1, value=200.0, width=2):
    n = int(np.hypot(p1[0] - p0[0], p1[1] - p0[1])) * 2
    ts = np.linspace(0, 1, max(n, 2))
    for t in ts:
        x = p0[0] + t * (p1[0] - p0[0])
        y = p0[1] + t * (p1[1] - p0[1])
        xi, yi = int(round(x)), int(round(y))
        img[max(yi - width // 2, 0): yi + width // 2 + 1,
            max(xi - width // 2, 0): xi + width // 2 + 1] = value
    return img


def seg_endpoint_error(det_p0, det_p1, gt_p0, gt_p1):
    d1 = np.linalg.norm(det_p0 - gt_p0) + np.linalg.norm(det_p1 - gt_p1)
    d2 = np.linalg.norm(det_p0 - gt_p1) + np.linalg.norm(det_p1 - gt_p0)
    return min(d1, d2) / 2


class TestLineDetection:
    def test_horizontal_line(self):
        img = np.full((240, 320), 50.0, np.float32)
        draw_line(img, (40, 120), (280, 120))
        det = lines.detect_lines(jnp.asarray(img))
        v = np.asarray(det.valid)
        assert v.sum() >= 1
        i = int(np.argmax(np.asarray(det.strength)))
        d = np.abs(np.asarray(det.direction[i]))
        assert d[0] > 0.98, f"direction {d}"
        err = seg_endpoint_error(np.asarray(det.p0[i]), np.asarray(det.p1[i]),
                                 np.array([40, 120]), np.array([280, 120]))
        assert err < 25, f"endpoint error {err}"

    def test_diagonal_line(self):
        img = np.full((240, 320), 50.0, np.float32)
        draw_line(img, (50, 50), (250, 200))
        det = lines.detect_lines(jnp.asarray(img))
        assert int(det.valid.sum()) >= 1
        i = int(np.argmax(np.asarray(det.strength)))
        d = np.asarray(det.direction[i])
        gt_dir = np.array([200.0, 150.0])
        gt_dir /= np.linalg.norm(gt_dir)
        assert abs(abs(d @ gt_dir)) > 0.98

    def test_two_lines(self):
        img = np.full((240, 320), 50.0, np.float32)
        draw_line(img, (30, 60), (290, 60))
        draw_line(img, (160, 20), (160, 220))
        det = lines.detect_lines(jnp.asarray(img))
        assert int(det.valid.sum()) >= 2
        dirs = np.abs(np.asarray(det.direction)[np.asarray(det.valid)])
        has_h = (dirs[:, 0] > 0.95).any()
        has_v = (dirs[:, 1] > 0.95).any()
        assert has_h and has_v

    def test_flat_image_no_lines(self):
        img = np.full((240, 320), 100.0, np.float32)
        det = lines.detect_lines(jnp.asarray(img))
        assert int(det.valid.sum()) == 0

    def test_noise_no_lines(self, rng):
        img = rng.uniform(0, 255, (240, 320)).astype(np.float32)
        det = lines.detect_lines(jnp.asarray(img))
        # pure noise has no coherent orientation tiles
        assert int(det.valid.sum()) <= 2


@pytest.mark.slow
class TestLinesInPose:
    """Line features in pose optimization (north-star config 2 — NEW surface, the
    reference never wires lines into its optimizer, rgbd_slam.cpp:304-313)."""

    def _cam_cfg(self):
        from rgbd_slam.config import (CameraIntrinsics, EngineConfig,
                                          MappingConfig, SlamConfig)
        cam = CameraIntrinsics(width=320, height=240, fx=260.0, fy=260.0,
                               cx=160.0, cy=120.0)
        cfg = SlamConfig(
            mapping=MappingConfig(max_points_3d=128, max_points_2d=32,
                                  max_planes=8, max_tracked_points=64),
            engine=EngineConfig(pose_covariance_mc_iterations=8,
                                lm_iterations=8, ransac_hypothesis_batch=16))
        return cam, cfg

    def test_lines_only_recovers_pose(self, rng):
        """8 world segments in varied orientations constrain the full 6-dof pose."""
        import jax
        from rgbd_slam.config import CameraIntrinsics
        from rgbd_slam.geometry import pinhole, se3
        from rgbd_slam.pose.features import make_matched_features
        from rgbd_slam.pose.optimizer import compute_optimized_pose

        cam = CameraIntrinsics(width=640, height=480, fx=520.0, fy=520.0,
                               cx=320.0, cy=240.0)
        gt_q = se3.quat_from_axis_angle(jnp.asarray([0.0, 0.0, 1.0]),
                                        jnp.float32(0.02))
        gt_p = jnp.asarray([12.0, -8.0, 5.0], jnp.float32)
        w2c = se3.world_to_camera(gt_q, gt_p)

        n = 10
        mids = np.concatenate([rng.uniform(2000, 3500, (n, 1)),
                               rng.uniform(-900, 900, (n, 2))], axis=1)
        dirs = rng.normal(0, 1, (n, 3))
        dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
        e0 = mids - 250 * dirs
        e1 = mids + 250 * dirs
        s0, ok0 = jax.vmap(lambda p: pinhole.world_to_screen(
            jnp.asarray(p, jnp.float32), w2c, cam))(e0)
        s1, ok1 = jax.vmap(lambda p: pinhole.world_to_screen(
            jnp.asarray(p, jnp.float32), w2c, cam))(e1)
        keep = np.asarray(ok0 & ok1)
        feats = make_matched_features(
            line_obs_p0=np.asarray(s0)[keep][:, :2],
            line_obs_p1=np.asarray(s1)[keep][:, :2],
            line_world=np.concatenate([e0, e1], axis=1)[keep],
            line_world_std=np.full((int(keep.sum()), 6), 1.0),
            capacities=(8, 4, 4, 12))
        assert int(keep.sum()) >= 6
        res = compute_optimized_pose(
            jax.random.PRNGKey(0), se3.quat_identity(jnp.float32),
            jnp.zeros(3, jnp.float32), feats, cam)
        assert bool(res.success)
        assert float(jnp.linalg.norm(res.position - gt_p)) < 10.0

    def test_line_map_builds_and_matches(self):
        """Engine on a stripe wall: the line map fills and matches frame-to-frame."""
        import jax.numpy as jnp
        from rgbd_slam import engine
        from rgbd_slam.synthetic import StripeWallScene, lateral_trajectory

        cam, cfg = self._cam_cfg()
        scene = StripeWallScene(cam)
        poses = lateral_trajectory(6, speed_mm=4.0)
        state = engine.init_state(cam, cfg)
        matches = []
        alive = []
        for q, p in poses:
            g, d = scene.render(q, p)
            state, out = engine.step(state, jnp.asarray(g), jnp.asarray(d),
                                     cam, cfg, with_planes=False,
                                     with_lines=True)
            matches.append(int(out.n_line_matches))
            alive.append(int(out.n_lines_alive))
        assert alive[-1] >= 2, f"line map never filled: {alive}"
        assert max(matches) >= 2, f"no line matches: {matches}"
        assert bool(out.success)

    def test_degrades_to_points_without_depth_lines(self):
        """with_lines=True on a line-free textured wall behaves like points-only."""
        import jax.numpy as jnp
        from rgbd_slam import engine
        from rgbd_slam.synthetic import WallScene, lateral_trajectory

        cam, cfg = self._cam_cfg()
        scene = WallScene(cam)
        poses = lateral_trajectory(4, speed_mm=4.0)
        state = engine.init_state(cam, cfg)
        for q, p in poses:
            g, d = scene.render(q, p)
            state, out = engine.step(state, jnp.asarray(g), jnp.asarray(d),
                                     cam, cfg, with_planes=False,
                                     with_lines=True)
        assert bool(out.success)
        err = float(jnp.linalg.norm(out.position - jnp.asarray(poses[-1][1])))
        assert err < 15.0
"""Pose optimizer behavior tests.

Mirrors the reference's testPoseOptimization tier (tests/test_pose_optimization.cpp):
synthetic noisy point cloud + synthetic planes, perturbed start poses
(perfect/good/medium/bad), translation-only / rotation-only suites, plane-only and
multi-feature suites, and outlier-robustness ladders at 10/50/100% outliers.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

pytestmark = pytest.mark.slow  # LM/RANSAC behavior suites (compile-heavy)

from rgbd_slam.config import CameraIntrinsics, EngineConfig
from rgbd_slam.geometry import pinhole, planes, se3
from rgbd_slam.pose.features import make_matched_features
from rgbd_slam.pose.optimizer import compute_optimized_pose, lm_solve

CAM = CameraIntrinsics(width=640, height=480, fx=548.86, fy=549.36, cx=316.49, cy=229.06)
FAST_ENGINE = EngineConfig(pose_covariance_mc_iterations=16, lm_iterations=12,
                           ransac_hypothesis_batch=32)


def make_cube_cloud(rng, n=24):
    """Synthetic cube point cloud in front of the camera (reference:
    test_pose_optimization.cpp:53-80)."""
    pts = rng.uniform(-1.0, 1.0, size=(n, 3)) * np.array([500.0, 500.0, 500.0])
    pts[:, 0] += 2500.0  # world x is forward
    return jnp.asarray(pts, dtype=jnp.float32)


def observe_points(world_pts, quat, position):
    w2c = se3.world_to_camera(quat, position)
    screen, valid = pinhole.world_to_screen(world_pts, w2c, CAM)
    return screen[:, :2], np.asarray(valid)


def make_world_planes(rng, n=4):
    normals = rng.normal(size=(n, 3))
    normals[:, 0] -= 2.0  # roughly facing the camera
    ds = rng.uniform(1000.0, 4000.0, size=(n, 1))
    return planes.normalize_plane(jnp.asarray(np.concatenate([normals, ds], 1),
                                              dtype=jnp.float32))


def observe_planes(world_planes, quat, position):
    w2c = se3.world_to_camera(quat, position)
    pw2c = se3.plane_world_to_camera_matrix(w2c)
    return planes.transform_plane(world_planes, pw2c)


def run_optimization(feats, start_quat, start_pos, seed=0, cov=False):
    return compute_optimized_pose(
        jax.random.PRNGKey(seed), start_quat, start_pos, feats, CAM,
        engine_cfg=FAST_ENGINE, compute_covariance=cov)


def perturbed_pose(rng, quat, position, pos_mm, rot_rad):
    dq = se3.quat_from_axis_angle(
        jnp.asarray(rng.normal(size=3), jnp.float32), jnp.float32(rot_rad))
    q = se3.quat_normalize(se3.quat_multiply(jnp.asarray(quat), dq))
    p = jnp.asarray(position + rng.normal(size=3) * pos_mm, jnp.float32)
    return q, p


GT_QUAT = se3.quat_normalize(jnp.asarray([0.98, 0.05, -0.12, 0.08], jnp.float32))
GT_POS = jnp.asarray([120.0, -80.0, 60.0], jnp.float32)


def assert_pose_recovered(res, quat, position, pos_tol=10.0, rot_tol_deg=0.5):
    assert bool(res.success), "optimization reported failure"
    perr = float(se3.position_error(res.position, position))
    rerr = float(se3.rotation_error_deg(res.quat, jnp.asarray(quat)))
    assert perr < pos_tol, f"position error {perr:.2f}mm"
    assert rerr < rot_tol_deg, f"rotation error {rerr:.3f}deg"


class TestPointOnlyOptimization:
    @pytest.mark.parametrize("pos_mm,rot_rad", [(0.0, 0.0), (20.0, 0.02),
                                                (100.0, 0.1), (300.0, 0.25)])
    def test_perturbed_starts(self, rng, pos_mm, rot_rad):
        """Perfect/good/medium/bad start poses (reference:
        test_pose_optimization.cpp:35-37)."""
        world = make_cube_cloud(rng)
        obs, valid = observe_points(world, GT_QUAT, GT_POS)
        assert valid.all()
        feats = make_matched_features(
            point_obs_uv=np.asarray(obs), point_world=np.asarray(world),
            point_world_std=np.full((world.shape[0], 3), 5.0))
        q0, p0 = perturbed_pose(rng, GT_QUAT, GT_POS, pos_mm, rot_rad)
        res = run_optimization(feats, q0, p0)
        assert_pose_recovered(res, GT_QUAT, GT_POS, pos_tol=5.0, rot_tol_deg=0.3)

    def test_translation_only(self, rng):
        world = make_cube_cloud(rng)
        obs, _ = observe_points(world, GT_QUAT, GT_POS)
        feats = make_matched_features(
            point_obs_uv=np.asarray(obs), point_world=np.asarray(world),
            point_world_std=np.full((world.shape[0], 3), 5.0))
        res = run_optimization(feats, GT_QUAT, GT_POS + jnp.asarray([200.0, -150.0, 100.0]))
        assert_pose_recovered(res, GT_QUAT, GT_POS, pos_tol=5.0)

    @pytest.mark.parametrize("axis", [(0, 0, 1), (0, 1, 0), (1, 0, 0)])
    def test_rotation_only(self, rng, axis):
        """Yaw/pitch/roll-only perturbations (reference rotation suites)."""
        world = make_cube_cloud(rng)
        obs, _ = observe_points(world, GT_QUAT, GT_POS)
        feats = make_matched_features(
            point_obs_uv=np.asarray(obs), point_world=np.asarray(world),
            point_world_std=np.full((world.shape[0], 3), 5.0))
        dq = se3.quat_from_axis_angle(jnp.asarray(axis, jnp.float32), jnp.float32(0.15))
        q0 = se3.quat_normalize(se3.quat_multiply(GT_QUAT, dq))
        res = run_optimization(feats, q0, GT_POS)
        assert_pose_recovered(res, GT_QUAT, GT_POS, pos_tol=5.0, rot_tol_deg=0.3)


class TestPlaneOnlyOptimization:
    def test_planes_recover_pose(self, rng):
        world_planes = make_world_planes(rng, n=5)
        cam_planes = observe_planes(world_planes, GT_QUAT, GT_POS)
        feats = make_matched_features(
            plane_cam=np.asarray(cam_planes), plane_world=np.asarray(world_planes),
            plane_world_std=np.full((5, 4), [0.01, 0.01, 0.01, 5.0]))
        q0, p0 = perturbed_pose(rng, GT_QUAT, GT_POS, 80.0, 0.08)
        res = run_optimization(feats, q0, p0)
        assert_pose_recovered(res, GT_QUAT, GT_POS, pos_tol=10.0, rot_tol_deg=0.5)


class TestMultiFeatureOptimization:
    def test_points_and_planes(self, rng):
        world = make_cube_cloud(rng, n=12)
        obs, _ = observe_points(world, GT_QUAT, GT_POS)
        world_planes = make_world_planes(rng, n=3)
        cam_planes = observe_planes(world_planes, GT_QUAT, GT_POS)
        feats = make_matched_features(
            point_obs_uv=np.asarray(obs), point_world=np.asarray(world),
            point_world_std=np.full((12, 3), 5.0),
            plane_cam=np.asarray(cam_planes), plane_world=np.asarray(world_planes),
            plane_world_std=np.full((3, 4), [0.01, 0.01, 0.01, 5.0]))
        q0, p0 = perturbed_pose(rng, GT_QUAT, GT_POS, 100.0, 0.1)
        res = run_optimization(feats, q0, p0)
        assert_pose_recovered(res, GT_QUAT, GT_POS, pos_tol=8.0, rot_tol_deg=0.4)

    def test_covariance_is_valid(self, rng):
        from rgbd_slam.geometry.covariances import is_covariance_valid

        world = make_cube_cloud(rng)
        obs, _ = observe_points(world, GT_QUAT, GT_POS)
        feats = make_matched_features(
            point_obs_uv=np.asarray(obs), point_world=np.asarray(world),
            point_world_std=np.full((world.shape[0], 3), 5.0))
        res = run_optimization(feats, GT_QUAT, GT_POS, cov=True)
        assert bool(res.success)
        assert bool(is_covariance_valid(res.covariance, atol=1e-2))
        # diagonal floor of 1e-3 (pose_optimization.cpp:423)
        assert np.all(np.diag(np.asarray(res.covariance)) >= 1e-3 - 1e-6)


class TestOutlierRobustness:
    @staticmethod
    def corrupt(rng, obs, fraction):
        obs = np.asarray(obs).copy()
        n = obs.shape[0]
        k = int(round(n * fraction))
        idx = rng.choice(n, size=k, replace=False)
        obs[idx] = rng.uniform([0, 0], [640, 480], size=(k, 2))
        return obs, idx

    @pytest.mark.parametrize("fraction", [0.1, 0.3, 0.5])
    def test_outlier_ladder(self, rng, fraction):
        """10/30/50% outliers: RANSAC must still recover the pose (reference:
        outlier suites, test_pose_optimization.cpp:1006-1272)."""
        world = make_cube_cloud(rng, n=32)
        obs, _ = observe_points(world, GT_QUAT, GT_POS)
        obs_c, outlier_idx = self.corrupt(rng, obs, fraction)
        feats = make_matched_features(
            point_obs_uv=obs_c, point_world=np.asarray(world),
            point_world_std=np.full((32, 3), 5.0))
        q0, p0 = perturbed_pose(rng, GT_QUAT, GT_POS, 50.0, 0.05)
        res = run_optimization(feats, q0, p0, seed=3)
        assert_pose_recovered(res, GT_QUAT, GT_POS, pos_tol=10.0, rot_tol_deg=0.5)
        # true outliers must be flagged as such
        inl = np.asarray(res.point_inliers)
        assert not inl[outlier_idx].any()

    def test_all_outliers_fails_gracefully(self, rng):
        """100% outliers: optimization must report failure, not crash or return a
        confident pose (reference: test_pose_optimization.cpp 100%-outlier cases)."""
        world = make_cube_cloud(rng, n=16)
        obs = rng.uniform([0, 0], [640, 480], size=(16, 2))
        feats = make_matched_features(
            point_obs_uv=obs, point_world=np.asarray(world),
            point_world_std=np.full((16, 3), 5.0))
        res = run_optimization(feats, GT_QUAT, GT_POS, seed=4)
        assert not bool(res.success)

    def test_not_enough_features_fails(self, rng):
        """Score < 1.0 (fewer than 5 points) must fail
        (pose_optimization.cpp:117-124)."""
        world = make_cube_cloud(rng, n=3)
        obs, _ = observe_points(world, GT_QUAT, GT_POS)
        feats = make_matched_features(
            point_obs_uv=np.asarray(obs), point_world=np.asarray(world),
            point_world_std=np.full((3, 3), 5.0))
        res = run_optimization(feats, GT_QUAT, GT_POS)
        assert not bool(res.success)


class TestLMCore:
    def test_lm_reduces_cost(self, rng):
        world = make_cube_cloud(rng)
        obs, _ = observe_points(world, GT_QUAT, GT_POS)
        feats = make_matched_features(
            point_obs_uv=np.asarray(obs), point_world=np.asarray(world),
            point_world_std=np.full((world.shape[0], 3), 5.0))
        q0, p0 = perturbed_pose(rng, GT_QUAT, GT_POS, 100.0, 0.1)
        c0 = se3.pose_to_coefficients(q0, p0)
        c1, cost1 = lm_solve(c0, feats, CAM, iterations=12)
        from rgbd_slam.pose.residuals import residual_vector

        cost0 = float(jnp.sum(residual_vector(c0, feats, CAM) ** 2))
        assert float(cost1) < cost0 * 1e-2

    def test_lm_jits_and_vmaps(self, rng):
        world = make_cube_cloud(rng, n=8)
        obs, _ = observe_points(world, GT_QUAT, GT_POS)
        feats = make_matched_features(
            point_obs_uv=np.asarray(obs), point_world=np.asarray(world),
            point_world_std=np.full((8, 3), 5.0))
        c0 = se3.pose_to_coefficients(GT_QUAT, GT_POS)
        f = jax.jit(lambda c: lm_solve(c, feats, CAM, iterations=4)[0])
        out = f(c0)
        assert out.shape == (6,)
        batch = jnp.broadcast_to(c0, (8, 6))
        outs = jax.vmap(lambda c: lm_solve(c, feats, CAM, iterations=2)[0])(batch)
        assert outs.shape == (8, 6)

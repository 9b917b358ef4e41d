"""Kalman filter behavior tests.

Mirrors the reference's testKalmanFiltering tier (tests/test_kalman_filtering.cpp):
textbook problems with known limits — plus batched-update coverage, since this
design runs ALL features through one vectorized step.
"""

import jax.numpy as jnp
import numpy as np

from rgbd_slam.tracking import inverse_depth_tracking as idt
from rgbd_slam.tracking import motion_model
from rgbd_slam.tracking.kalman import kalman_step, track_planes, track_points
from rgbd_slam.geometry import inverse_depth as idp
from rgbd_slam.geometry import se3
from rgbd_slam.geometry.covariances import is_covariance_valid


class TestKalmanStep:
    def test_building_height(self):
        """Static 1-state estimation (altimeter example): repeated measurements of a
        constant converge to the sample mean with shrinking variance."""
        true_height = 50.0
        meas = np.array([48.54, 47.11, 55.01, 55.15, 49.89, 40.85, 46.72, 50.05, 51.27, 49.95])
        state = jnp.array([60.0])
        cov = jnp.array([[225.0]])
        r = jnp.array([[25.0]])
        for m in meas:
            state, cov = kalman_step(state, cov, jnp.array([m]), r)
        assert abs(float(state[0]) - true_height) < 1.5
        assert float(cov[0, 0]) < 3.0

    def test_variance_monotonic_decrease(self):
        state = jnp.zeros(3)
        cov = 100.0 * jnp.eye(3)
        r = 4.0 * jnp.eye(3)
        last = 100.0
        for _ in range(5):
            state, cov = kalman_step(state, cov, jnp.zeros(3), r)
            tr = float(jnp.trace(cov))
            assert tr < last
            last = tr

    def test_perfect_measurement_dominates(self):
        state = jnp.array([0.0, 0.0, 0.0])
        cov = 1e4 * jnp.eye(3)
        obs = jnp.array([10.0, -5.0, 3.0])
        new_state, new_cov = kalman_step(state, cov, obs, 1e-4 * jnp.eye(3))
        np.testing.assert_allclose(new_state, obs, atol=1e-2)
        assert float(jnp.trace(new_cov)) < 1e-2

    def test_batched_matches_sequential(self, rng):
        states = jnp.asarray(rng.normal(size=(16, 3)), dtype=jnp.float32)
        covs = jnp.broadcast_to(5.0 * jnp.eye(3), (16, 3, 3)).astype(jnp.float32)
        obs = jnp.asarray(rng.normal(size=(16, 3)), dtype=jnp.float32)
        rs = jnp.broadcast_to(2.0 * jnp.eye(3), (16, 3, 3)).astype(jnp.float32)
        bs, bc = kalman_step(states, covs, obs, rs)
        for i in range(16):
            s, c = kalman_step(states[i], covs[i], obs[i], rs[i])
            np.testing.assert_allclose(bs[i], s, atol=1e-5)
            np.testing.assert_allclose(bc[i], c, atol=1e-5)


class TestPointTracking:
    def test_track_points_moves_toward_observation(self, rng):
        pos = jnp.asarray(rng.normal(size=(8, 3)) * 100, dtype=jnp.float32)
        cov = jnp.broadcast_to(50.0 * jnp.eye(3), (8, 3, 3)).astype(jnp.float32)
        obs = pos + 10.0
        obs_cov = jnp.broadcast_to(50.0 * jnp.eye(3), (8, 3, 3)).astype(jnp.float32)
        new_pos, new_cov, score, moving = track_points(pos, cov, obs, obs_cov)
        # equal covariances: posterior halfway
        np.testing.assert_allclose(new_pos, pos + 5.0, atol=0.1)
        assert np.all(np.asarray(score) > 0)
        assert np.asarray(moving).all()  # 10 > sqrt(50)
        assert np.asarray(is_covariance_valid(new_cov)).all()

    def test_not_moving_within_sigma(self):
        pos = jnp.zeros((1, 3))
        cov = jnp.eye(3)[None] * 100.0
        obs = jnp.full((1, 3), 1.0)
        obs_cov = jnp.eye(3)[None] * 100.0  # sigma 10 > displacement 1
        _, _, _, moving = track_points(pos, cov, obs, obs_cov)
        assert not bool(moving[0])

    def test_track_planes_shapes(self, rng):
        st = jnp.asarray(rng.normal(size=(4, 4)), dtype=jnp.float32)
        cov = jnp.broadcast_to(jnp.eye(4), (4, 4, 4)).astype(jnp.float32) * 0.1
        obs = st + 0.01
        new_st, new_cov = track_planes(st, cov, obs, cov)
        assert new_st.shape == (4, 4)
        assert np.asarray(is_covariance_valid(new_cov)).all()


class TestInverseDepthTracking:
    def _make_state(self, point, origin):
        return idp.from_cartesian(jnp.asarray(point), jnp.asarray(origin))

    def test_initial_covariance_structure(self):
        cov = idt.initial_covariance(jnp.eye(3) * 4.0)
        c = np.asarray(cov)
        np.testing.assert_allclose(c[:3, :3], np.eye(3) * 4.0)
        assert c[3, 3] > 0 and c[4, 4] > 0 and c[5, 5] > 0
        assert bool(is_covariance_valid(cov))

    def test_world_round_trip(self, rng):
        pts = rng.normal(size=(32, 3)) * 1000 + np.array([3000, 0, 0])
        origins = rng.normal(size=(32, 3)) * 10
        st = idp.from_cartesian(jnp.asarray(pts), jnp.asarray(origins))
        back = idp.to_world(st)
        np.testing.assert_allclose(np.asarray(back), pts, rtol=1e-4, atol=0.5)

    def test_jacobians_vs_autodiff(self, rng):
        import jax

        pts = jnp.asarray(rng.normal(size=(4, 3)) * 100 + np.array([500, 0, 0]))
        origins = jnp.asarray(rng.normal(size=(4, 3)))
        st = idp.from_cartesian(pts, origins)
        jac = idp.to_world_jacobian(st)
        jac_ad = jax.vmap(jax.jacfwd(idp.to_world))(st)
        np.testing.assert_allclose(jac, jac_ad, rtol=1e-3, atol=1e-3)

        jac2 = idp.from_cartesian_jacobian(pts, origins)
        jac2_ad = jax.vmap(jax.jacfwd(lambda p, o: idp.from_cartesian(p, o)))(pts, origins)
        np.testing.assert_allclose(jac2, jac2_ad, rtol=1e-3, atol=1e-3)

    def test_fusion_converges_to_truth(self):
        """Repeated noiseless cartesian fusions shrink toward the observed point
        (reference behavior: inverse-depth fusion suite,
        tests/test_coordinate_systems.cpp:303-729)."""
        true_pt = jnp.array([[4000.0, 500.0, -300.0]])
        origin = jnp.zeros((1, 3))
        # start with a biased estimate along the correct bearing
        st = idp.from_cartesian(true_pt * 0.7, origin)
        cov = idt.initial_covariance(jnp.eye(3)[None] * 1.0)
        obs_cov = jnp.broadcast_to(jnp.eye(3) * 100.0, (1, 3, 3))
        for _ in range(20):
            st, cov, _ = idt.fuse_cartesian(st, cov, true_pt, obs_cov)
        est = idp.to_world(st)
        assert float(jnp.linalg.norm(est - true_pt)) < 100.0

    def test_linearity_score_decreases_with_certainty(self):
        st = idp.from_cartesian(jnp.array([[3000.0, 0.0, 0.0]]), jnp.zeros((1, 3)))
        c2w = se3.camera_to_world(se3.quat_identity(), jnp.zeros(3))[None]
        cov_hi = idt.initial_covariance(jnp.eye(3)[None])
        cov_lo = cov_hi.at[:, 3, 3].multiply(1e-6)
        s_hi = float(idt.linearity_score(st, cov_hi, c2w)[0])
        s_lo = float(idt.linearity_score(st, cov_lo, c2w)[0])
        assert s_lo < s_hi


class TestMotionModel:
    def test_first_prediction_is_identity(self):
        st = motion_model.reset()
        q = se3.quat_identity()
        p = jnp.array([100.0, 0.0, 0.0])
        st, pq, pp, _ = motion_model.predict_next_pose(st, q, p)
        np.testing.assert_allclose(pp, p, atol=1e-6)
        np.testing.assert_allclose(pq, q, atol=1e-6)

    def test_constant_velocity_prediction(self):
        """After constant-velocity motion the model predicts continued motion
        (reference: testMotionModel constant-velocity suite)."""
        st = motion_model.reset()
        q = se3.quat_identity()
        vel = jnp.array([10.0, 0.0, 0.0])
        p = jnp.zeros(3)
        for i in range(8):
            p = vel * (i + 1.0)
            st, pq, pp, _ = motion_model.predict_next_pose(st, q, p)
        # decaying-mean velocity approaches the true constant velocity
        pred_vel = np.asarray(pp - p)
        assert 5.0 < pred_vel[0] <= 10.5
        assert abs(pred_vel[1]) < 1e-3

    def test_variance_inflation(self):
        st = motion_model.reset()
        st, _, _, infl = motion_model.predict_next_pose(
            st, se3.quat_identity(), jnp.zeros(3), should_increase_variance=True
        )
        assert float(infl[0, 0]) == 100.0
        assert float(infl[3, 3]) == 0.01 + 0.0 or abs(float(infl[3, 3]) - 0.01) < 1e-9

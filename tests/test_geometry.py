"""Geometry round-trip tests.

Mirrors the reference's testCoordinateSystems tier (tests/test_coordinate_systems.cpp):
screen<->camera<->world round-trips including rotations, basis changes, plane
transforms, and line distances — plus batched/jit coverage that the reference (being
per-object C++) has no analogue for.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from rgbd_slam.config import CameraIntrinsics
from rgbd_slam.geometry import basis, covariances, lines, pinhole, planes, se3

CAM = CameraIntrinsics(width=640, height=480, fx=548.86, fy=549.36, cx=316.49, cy=229.06)


def random_quat(rng, n=()):
    q = rng.normal(size=n + (4,))
    return q / np.linalg.norm(q, axis=-1, keepdims=True)


class TestQuaternions:
    def test_identity_matrix(self):
        m = se3.quat_to_matrix(se3.quat_identity())
        np.testing.assert_allclose(m, np.eye(3), atol=1e-6)

    def test_matrix_round_trip(self, rng):
        q = random_quat(rng, (64,)).astype(np.float32)
        m = se3.quat_to_matrix(q)
        q2 = se3.matrix_to_quat(m)
        # q and -q are the same rotation
        dot = np.abs(np.sum(np.asarray(q2) * q, axis=-1))
        np.testing.assert_allclose(dot, 1.0, atol=1e-5)

    def test_rotate_matches_matrix(self, rng):
        q = random_quat(rng, (16,)).astype(np.float32)
        v = rng.normal(size=(16, 3)).astype(np.float32)
        out1 = se3.quat_rotate(q, v)
        out2 = np.einsum("nij,nj->ni", se3.quat_to_matrix(q), v)
        np.testing.assert_allclose(out1, out2, atol=1e-4)

    def test_multiply_compose(self, rng):
        qa, qb = random_quat(rng), random_quat(rng)
        v = rng.normal(size=3)
        lhs = se3.quat_rotate(se3.quat_multiply(qa, qb), v)
        rhs = se3.quat_rotate(qa, se3.quat_rotate(qb, v))
        np.testing.assert_allclose(lhs, rhs, atol=1e-4)

    def test_stereographic_round_trip(self, rng):
        q = random_quat(rng, (128,))
        # keep away from the z=-1 singularity guard
        q = np.where(q[..., 3:4] < -0.9, -q, q)
        c = se3.quat_to_stereographic(jnp.asarray(q))
        q2 = se3.stereographic_to_quat(c)
        dot = np.abs(np.sum(np.asarray(q2) * q, axis=-1))
        np.testing.assert_allclose(dot, 1.0, atol=1e-5)

    def test_euler_quaternion(self):
        # yaw-only rotation around z
        q = se3.quat_from_euler(np.pi / 2, 0.0, 0.0)
        v = se3.quat_rotate(q, jnp.array([1.0, 0.0, 0.0]))
        np.testing.assert_allclose(v, [0.0, 1.0, 0.0], atol=1e-6)

    def test_slerp_endpoints(self, rng):
        qa, qb = random_quat(rng), random_quat(rng)
        np.testing.assert_allclose(
            np.abs(np.sum(np.asarray(se3.quat_slerp(qa, qb, 0.0)) * qa)), 1.0, atol=1e-6
        )
        np.testing.assert_allclose(
            np.abs(np.sum(np.asarray(se3.quat_slerp(qa, qb, 1.0)) * qb)), 1.0, atol=1e-6
        )


class TestAxisConvention:
    def test_axis_correction(self):
        """Camera optical frame maps to the physical frame: z fwd -> x fwd,
        x right -> -y, y down -> -z (reference: camera_transformation.cpp:7-13)."""
        c = se3.AXIS_CORRECTION
        np.testing.assert_allclose(c @ [0, 0, 1], [1, 0, 0], atol=1e-12)
        np.testing.assert_allclose(c @ [1, 0, 0], [0, -1, 0], atol=1e-12)
        np.testing.assert_allclose(c @ [0, 1, 0], [0, 0, -1], atol=1e-12)

    def test_c2w_w2c_inverse(self, rng):
        q = random_quat(rng)
        p = rng.normal(size=3) * 1000
        c2w = se3.camera_to_world(q, p)
        w2c = se3.world_to_camera(q, p)
        np.testing.assert_allclose(np.asarray(c2w @ w2c), np.eye(4), atol=1e-3)


class TestScreenCameraWorld:
    def test_screen_camera_round_trip(self, rng):
        uv = rng.uniform([0, 0], [640, 480], size=(256, 2))
        z = rng.uniform(100, 5000, size=(256, 1))
        screen = np.concatenate([uv, z], axis=-1).astype(np.float32)
        cam_pt = pinhole.screen_to_camera(screen, CAM)
        back = pinhole.camera_to_screen(cam_pt, CAM)
        np.testing.assert_allclose(back, screen, rtol=1e-4, atol=1e-2)

    @pytest.mark.parametrize("seed", [0, 1, 2])
    def test_world_round_trip_with_pose(self, seed):
        rng = np.random.default_rng(seed)
        q = random_quat(rng)
        p = rng.normal(size=3) * 500
        c2w = se3.camera_to_world(q, p)
        w2c = se3.world_to_camera(q, p)
        uv = rng.uniform([50, 50], [600, 430], size=(128, 2))
        z = rng.uniform(200, 4000, size=(128, 1))
        screen = np.concatenate([uv, z], axis=-1).astype(np.float32)
        world = pinhole.screen_to_world(screen, c2w, CAM)
        back, valid = pinhole.world_to_screen(world, w2c, CAM)
        assert np.asarray(valid).all()
        np.testing.assert_allclose(np.asarray(back), screen, rtol=1e-3, atol=0.1)

    def test_identity_pose_forward_depth(self):
        """At identity pose a point straight down the optical axis lands at +x world
        (the physical forward axis)."""
        screen = jnp.array([CAM.cx, CAM.cy, 1000.0])
        c2w = se3.camera_to_world(se3.quat_identity(), jnp.zeros(3))
        world = pinhole.screen_to_world(screen, c2w, CAM)
        np.testing.assert_allclose(world, [1000.0, 0.0, 0.0], atol=0.5)

    def test_reprojection_distance_zero(self, rng):
        q = random_quat(rng)
        p = rng.normal(size=3) * 100
        w2c = se3.world_to_camera(q, p)
        c2w = se3.camera_to_world(q, p)
        screen = np.array([320.0, 240.0, 1500.0], dtype=np.float32)
        world = pinhole.screen_to_world(screen, c2w, CAM)
        d = pinhole.screen_distance_px(world, screen[:2], w2c, CAM)
        assert float(d) < 1e-2


class TestBasisChanges:
    def test_round_trip(self, rng):
        xyz = rng.normal(size=(512, 3)) * 100
        sph = basis.cartesian_to_spherical(xyz)
        back = basis.spherical_to_cartesian(sph)
        np.testing.assert_allclose(back, xyz, rtol=1e-5, atol=1e-3)

    def test_jacobians_match_autodiff(self, rng):
        xyz = jnp.asarray(rng.normal(size=(8, 3)), dtype=jnp.float32) * 10
        jac = basis.cartesian_to_spherical_jacobian(xyz)
        jac_ad = jax.vmap(jax.jacfwd(basis.cartesian_to_spherical))(xyz)
        np.testing.assert_allclose(jac, jac_ad, rtol=1e-3, atol=1e-4)

        sph = basis.cartesian_to_spherical(xyz)
        jac2 = basis.spherical_to_cartesian_jacobian(sph)
        jac2_ad = jax.vmap(jax.jacfwd(basis.spherical_to_cartesian))(sph)
        np.testing.assert_allclose(jac2, jac2_ad, rtol=1e-3, atol=1e-4)

    def test_jacobians_are_inverses(self, rng):
        xyz = jnp.asarray(rng.normal(size=(8, 3))) * 10
        j1 = basis.cartesian_to_spherical_jacobian(xyz)
        j2 = basis.spherical_to_cartesian_jacobian(basis.cartesian_to_spherical(xyz))
        prod = np.einsum("nij,njk->nik", j2, j1)
        np.testing.assert_allclose(prod, np.broadcast_to(np.eye(3), (8, 3, 3)), atol=1e-4)


class TestPlanes:
    def test_transform_round_trip(self, rng):
        q = random_quat(rng)
        p = rng.normal(size=3) * 1000
        c2w = se3.camera_to_world(q, p)
        w2c = se3.world_to_camera(q, p)
        pc2w = se3.plane_camera_to_world_matrix(c2w)
        pw2c = se3.plane_world_to_camera_matrix(w2c)
        plane = planes.normalize_plane(jnp.asarray(rng.normal(size=(16, 4)) * [1, 1, 1, 500]))
        world = planes.transform_plane(plane, pc2w)
        back = planes.transform_plane(world, pw2c)
        np.testing.assert_allclose(np.asarray(back), np.asarray(plane), rtol=1e-4, atol=1e-3)

    def test_plane_transform_preserves_point_membership(self, rng):
        """Points on a camera plane, moved to world space, lie on the world plane."""
        q = random_quat(rng)
        p = rng.normal(size=3) * 200
        c2w = se3.camera_to_world(q, p)
        pc2w = se3.plane_camera_to_world_matrix(c2w)
        n = np.array([0.0, 0.0, 1.0])
        d = -1000.0  # plane z=1000 in camera space
        plane_cam = jnp.array([*n, d])
        pts_cam = np.concatenate(
            [rng.normal(size=(32, 2)) * 300, np.full((32, 1), 1000.0)], axis=-1
        )
        pts_world = pinhole.camera_to_world_point(jnp.asarray(pts_cam), c2w)
        plane_world = planes.transform_plane(plane_cam, pc2w)
        dist = planes.point_distance(plane_world, pts_world)
        np.testing.assert_allclose(np.asarray(dist), 0.0, atol=1e-2)

    def test_reduced_distance_zero_for_same_plane(self, rng):
        q = random_quat(rng)
        p = rng.normal(size=3) * 100
        w2c = se3.world_to_camera(q, p)
        pw2c = se3.plane_world_to_camera_matrix(w2c)
        plane_world = planes.normalize_plane(jnp.array([0.3, -0.5, 0.8, 700.0]))
        plane_cam = planes.transform_plane(plane_world, pw2c)
        err = planes.reduced_signed_distance(plane_world, plane_cam, pw2c)
        np.testing.assert_allclose(np.asarray(err), 0.0, atol=1e-3)


class TestLines:
    def test_point_line_distance(self):
        d = lines.segment_signed_distance_to_point(
            jnp.array([0.0, 0.0]), jnp.array([10.0, 0.0]), jnp.array([5.0, 3.0])
        )
        np.testing.assert_allclose(d, [0.0, 3.0], atol=1e-6)

    def test_line_line_distance(self):
        # skew lines: x-axis and the line (y=5, z=1) along y... use z-offset parallel axes
        p1, d1 = jnp.array([0.0, 0.0, 0.0]), jnp.array([1.0, 0.0, 0.0])
        p2, d2 = jnp.array([0.0, 0.0, 4.0]), jnp.array([0.0, 1.0, 0.0])
        dist = lines.signed_line_distance(p1, d1, p2, d2)
        np.testing.assert_allclose(np.linalg.norm(dist), 4.0, atol=1e-6)

    def test_intersecting_lines_zero(self):
        p1, d1 = jnp.array([0.0, 0.0, 0.0]), jnp.array([1.0, 0.0, 0.0])
        p2, d2 = jnp.array([5.0, -5.0, 0.0]), jnp.array([0.0, 1.0, 0.0])
        dist = lines.signed_line_distance(p1, d1, p2, d2)
        np.testing.assert_allclose(np.linalg.norm(dist), 0.0, atol=1e-6)


class TestCovariances:
    def test_depth_quantization_floor(self):
        assert float(covariances.get_depth_quantization(jnp.array(10.0))) == 0.5
        # Kinect model grows quadratically: at 5m the quantization is several cm
        q5 = float(covariances.get_depth_quantization(jnp.array(5000.0)))
        assert 50 < q5 < 80

    def test_screen_covariance_structure(self):
        cov = covariances.screen_point_covariance(jnp.array([100.0, 100.0, 2000.0]))
        c = np.asarray(cov)
        assert c[0, 0] == pytest.approx(0.01)
        assert c[1, 1] == pytest.approx(0.01)
        assert c[2, 2] > 0.5
        assert covariances.is_covariance_valid(cov)

    def test_propagation_validity_chain(self, rng):
        screen = jnp.asarray(
            np.concatenate(
                [rng.uniform(0, 600, size=(32, 2)), rng.uniform(500, 4000, size=(32, 1))],
                axis=-1,
            ),
            dtype=jnp.float32,
        )
        q = random_quat(rng)
        c2w = se3.camera_to_world(jnp.asarray(q), jnp.zeros(3))
        w_cov = covariances.screen_point_to_world_covariance(screen, c2w, CAM)
        assert np.asarray(covariances.is_covariance_valid(w_cov)).all()

    def test_plane_covariance_round_trip_validity(self, rng):
        plane = planes.normalize_plane(jnp.array([0.2, 0.3, 0.93, 1500.0]))
        pc_cov = jnp.asarray(np.diag([25.0, 25.0, 25.0]), dtype=jnp.float32)
        cov44 = covariances.plane_covariance_from_point_cloud(plane, pc_cov)
        assert bool(covariances.is_covariance_valid(cov44, atol=1e-3))
        back = covariances.reduced_point_cloud_covariance_from_plane(plane, cov44)
        assert bool(covariances.is_covariance_valid(back, atol=1e-3))


class TestJitAndBatch:
    def test_projection_jits(self):
        f = jax.jit(lambda s, m: pinhole.screen_to_world(s, m, CAM))
        c2w = se3.camera_to_world(se3.quat_identity(), jnp.zeros(3))
        out = f(jnp.array([[320.0, 240.0, 1000.0]] * 8), c2w)
        assert out.shape == (8, 3)

    def test_vmap_over_poses(self, rng):
        qs = jnp.asarray(random_quat(rng, (8,)), dtype=jnp.float32)
        ps = jnp.asarray(rng.normal(size=(8, 3)), dtype=jnp.float32)
        mats = jax.vmap(se3.camera_to_world)(qs, ps)
        assert mats.shape == (8, 4, 4)


class TestEig3:
    def test_matches_eigh(self, rng):
        from rgbd_slam.geometry.eig3 import sym_eig3_smallest

        m = rng.normal(size=(64, 3, 3)).astype(np.float32)
        a = jnp.asarray(np.einsum("nij,nkj->nik", m, m))  # PSD
        vals, vec = sym_eig3_smallest(a)
        ref_vals, ref_vecs = np.linalg.eigh(np.asarray(a))
        np.testing.assert_allclose(np.asarray(vals), ref_vals, rtol=2e-3, atol=1e-3)
        dot = np.abs(np.sum(np.asarray(vec) * ref_vecs[..., 0], axis=-1))
        np.testing.assert_allclose(dot, 1.0, atol=5e-3)

    def test_isotropic_matrix(self):
        from rgbd_slam.geometry.eig3 import sym_eig3_smallest

        a = jnp.eye(3)[None] * 2.5
        vals, vec = sym_eig3_smallest(a)
        np.testing.assert_allclose(np.asarray(vals)[0], [2.5, 2.5, 2.5], atol=1e-6)
        assert np.isfinite(np.asarray(vec)).all()


class TestCovarianceValidFast:
    """Hot-path validity check agrees with the eigvalsh-based reference check
    on valid, indefinite, asymmetric and non-finite inputs."""

    def test_agrees_with_reference_check(self, rng):
        from rgbd_slam.geometry import covariances
        a = rng.normal(size=(32, 3, 3)).astype(np.float32)
        spd = a @ np.swapaxes(a, -1, -2) + 0.1 * np.eye(3, dtype=np.float32)
        assert np.asarray(
            covariances.is_covariance_valid_fast(jnp.asarray(spd))).all()
        bad = spd.copy()
        bad[0] -= 10.0 * np.eye(3, dtype=np.float32)   # indefinite
        bad[1, 0, 1] += 5.0                            # asymmetric
        bad[2, 2, 2] = np.nan                          # non-finite
        got = np.asarray(covariances.is_covariance_valid_fast(jnp.asarray(bad)))
        assert not got[0] and not got[1] and not got[2]
        assert got[3:].all()

    def test_6x6_cholesky_path(self):
        from rgbd_slam.geometry import covariances
        good = np.eye(6, dtype=np.float32) * 1e-3
        assert bool(covariances.is_covariance_valid_fast(jnp.asarray(good)))
        assert not bool(covariances.is_covariance_valid_fast(
            jnp.asarray(-good)))
        assert not bool(covariances.is_covariance_valid_fast(
            jnp.full((6, 6), np.nan, np.float32)))

"""End-to-end engine tests on a synthetic rendered RGB-D sequence.

The reference evaluates end-to-end behavior manually on TUM sequences; here a textured
wall is rendered analytically so ground-truth poses are exact and the full step
(extract -> associate -> optimize -> map update) is validated frame by frame.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

pytestmark = pytest.mark.slow  # engine-compile-heavy tier

from rgbd_slam import engine
from rgbd_slam.config import CameraIntrinsics, SlamConfig, MappingConfig, EngineConfig
from rgbd_slam.geometry import se3
from rgbd_slam.mapping import maps

CAM = CameraIntrinsics(width=320, height=240, fx=260.0, fy=260.0, cx=160.0, cy=120.0)
CFG = SlamConfig(
    mapping=MappingConfig(max_points_3d=256, max_points_2d=64, max_planes=8),
    engine=EngineConfig(pose_covariance_mc_iterations=8, lm_iterations=10,
                        ransac_hypothesis_batch=24),
)

WALL_X = 2500.0  # wall plane x = const in world space (world x is forward)


def texture(y, z):
    return (120.0 + 45.0 * np.sin(y / 55.0) + 40.0 * np.cos(z / 45.0)
            + 30.0 * np.sin((y + z) / 35.0) + 20.0 * np.cos((y - 2 * z) / 75.0))


def render(quat, position):
    """Render gray+depth of the textured wall x=WALL_X from the given pose."""
    c2w = np.asarray(se3.camera_to_world(jnp.asarray(quat), jnp.asarray(position)))
    origin = c2w[:3, 3]
    rot = c2w[:3, :3]
    us, vs = np.meshgrid(np.arange(CAM.width), np.arange(CAM.height))
    dir_cam = np.stack([(us - CAM.cx) / CAM.fx, (vs - CAM.cy) / CAM.fy,
                        np.ones_like(us, dtype=np.float64)], axis=-1)
    dir_world = dir_cam @ rot.T
    t = (WALL_X - origin[0]) / dir_world[..., 0]
    w = origin + t[..., None] * dir_world
    gray = texture(w[..., 1], w[..., 2]).astype(np.float32)
    depth = t.astype(np.float32)  # dir_cam z == 1 -> depth = t
    return jnp.asarray(gray), jnp.asarray(depth)


def run_sequence(n_frames, motion_fn, cfg=CFG, with_planes=True, seed=0):
    state = engine.init_state(CAM, cfg, seed=seed)
    outs = []
    gt = []
    for i in range(n_frames):
        quat, pos = motion_fn(i)
        gray, depth = render(quat, pos)
        state, out = engine.step(state, gray, depth, CAM, cfg,
                                 with_planes=with_planes)
        outs.append(out)
        gt.append((quat, pos))
    return state, outs, gt


class TestMapsPrimitives:
    def test_allocate_slots(self):
        free = jnp.array([False, True, False, True, True])
        want = jnp.array([True, False, True, True, True])
        slots = np.asarray(maps.allocate_slots(free, want))
        # 4 wanted, 3 free: first three get slots 1, 3, 4; last dropped
        assert slots.tolist() == [1, -1, 3, 4, -1]

    def test_lifecycle_promotion(self):
        is_local = jnp.array([False, False, True])
        mc = jnp.array([2, 0, 5])
        miss = jnp.array([0, 0, 9])
        matched = jnp.array([True, False, False])
        loc, mc2, miss2, keep = maps.lifecycle_update(is_local, mc, miss, matched,
                                                      3, 10)
        assert bool(loc[0])          # 3rd successive match -> promoted
        assert not bool(keep[1])     # staged, count hits 0 -> dropped
        assert bool(keep[2])         # local, 10 misses == threshold, not yet lost
        _, _, miss3, keep3 = maps.lifecycle_update(loc, mc2, miss2,
                                                   jnp.array([False] * 3), 3, 10)
        assert not bool(keep3[2])    # 11th miss -> lost


class TestEngineStatic:
    def test_first_frame_seeds_map(self):
        state, outs, _ = run_sequence(1, lambda i: (se3.quat_identity(),
                                                    jnp.zeros(3)))
        assert bool(outs[0].success)
        assert int(outs[0].n_points_alive) > 20
        # all new points are staged, none local
        assert not bool(jnp.any(state.points.is_local & maps.alive(state.points)))

    def test_static_camera_tracks(self):
        state, outs, _ = run_sequence(
            4, lambda i: (se3.quat_identity(), jnp.zeros(3)))
        for out in outs[1:]:
            assert bool(out.success)
            assert float(jnp.linalg.norm(out.position)) < 10.0
        # staged points get promoted to local after 3 successive matches
        assert bool(jnp.any(state.points.is_local & maps.alive(state.points)))

    def test_wall_plane_in_map(self):
        state, outs, _ = run_sequence(
            2, lambda i: (se3.quat_identity(), jnp.zeros(3)))
        assert int(outs[-1].n_planes_alive) >= 1
        pl = state.planes
        a = np.asarray(maps.alive(pl))
        params = np.asarray(pl.params)[a]
        # wall at world x=2500: world normal ~ (+-1, 0, 0), |d| ~ 2500
        assert np.abs(params[:, 0]).max() > 0.99
        assert np.any(np.abs(np.abs(params[:, 3]) - WALL_X) < 20)


class TestEngineMotion:
    @pytest.mark.smoke
    def test_lateral_translation_tracked(self):
        speed = 4.0  # mm/frame along world y

        def motion(i):
            return se3.quat_identity(), jnp.asarray([0.0, speed * i, 0.0], jnp.float32)

        state, outs, gt = run_sequence(6, motion)
        for i, out in enumerate(outs):
            if i == 0:
                continue
            assert bool(out.success), f"frame {i} failed"
            err = float(jnp.linalg.norm(out.position - gt[i][1]))
            assert err < 8.0, f"frame {i} position error {err:.1f}mm"

    def test_forward_translation_tracked(self):
        def motion(i):
            return se3.quat_identity(), jnp.asarray([6.0 * i, 0.0, 0.0], jnp.float32)

        state, outs, gt = run_sequence(5, motion)
        errs = [float(jnp.linalg.norm(outs[i].position - gt[i][1]))
                for i in range(1, 5)]
        assert max(errs) < 10.0, f"errors {errs}"

    def test_small_rotation_tracked(self):
        def motion(i):
            q = se3.quat_from_axis_angle(jnp.array([0.0, 0.0, 1.0]),
                                         jnp.float32(0.004 * i))
            return q, jnp.zeros(3, jnp.float32)

        state, outs, gt = run_sequence(5, motion)
        for i in range(1, 5):
            assert bool(outs[i].success)
            rerr = float(se3.rotation_error_deg(outs[i].quat, gt[i][0]))
            assert rerr < 0.3, f"frame {i} rotation error {rerr:.2f}deg"


class TestEngineRobustness:
    def test_garbage_depth_does_not_crash(self, rng):
        state = engine.init_state(CAM, CFG)
        gray = jnp.asarray(rng.uniform(0, 255, (240, 320)), jnp.float32)
        depth = jnp.asarray(rng.uniform(-5, 10, (240, 320)), jnp.float32)
        state, out = engine.step(state, gray, depth, CAM, CFG)
        assert np.isfinite(np.asarray(out.position)).all()

    def test_blank_frames_fail_gracefully(self):
        state = engine.init_state(CAM, CFG)
        gray = jnp.full((240, 320), 128.0)
        depth = jnp.zeros((240, 320))
        for _ in range(3):
            state, out = engine.step(state, gray, depth, CAM, CFG)
        # no features at all: tracking cannot succeed, pose must stay finite
        assert np.isfinite(np.asarray(out.position)).all()
        assert not bool(out.success) or int(state.frame_idx) == 1


class TestCylinderPipeline:
    """Cylinders flow end-to-end: detected in a tunnel scene, surfaced in the
    step output and the debug image (reference: cylinder_segment.cpp:35-225 +
    primitive_detection.cpp:437-476; CAPE tunnel is north-star config 3)."""

    def test_tunnel_frame_detects_cylinder(self):
        from rgbd_slam.synthetic import TunnelScene

        scene = TunnelScene(CAM, radius_mm=1200.0)
        q = np.array([1.0, 0.0, 0.0, 0.0], np.float32)
        gray, depth = scene.render(q, np.zeros(3, np.float32))
        state = engine.init_state(CAM, CFG)
        state, out = engine.step(state, jnp.asarray(gray), jnp.asarray(depth),
                                 CAM, CFG)
        assert int(out.n_cylinders) >= 1, "tunnel frame found no cylinder"
        assert int(out.cylinder_cells.sum()) >= 6
        # a flat wall frame must NOT report cylinders
        g2, d2 = render(q, np.zeros(3, np.float32))
        state2 = engine.init_state(CAM, CFG)
        state2, out2 = engine.step(state2, jnp.asarray(g2), jnp.asarray(d2),
                                   CAM, CFG)
        assert int(out2.n_cylinders) == 0

    def test_debug_image_tints_cylinder_cells(self):
        from rgbd_slam.io.debug_image import render_debug_image
        from rgbd_slam.synthetic import TunnelScene

        scene = TunnelScene(CAM, radius_mm=1200.0)
        q = np.array([1.0, 0.0, 0.0, 0.0], np.float32)
        gray, depth = scene.render(q, np.zeros(3, np.float32))
        state = engine.init_state(CAM, CFG)
        state, out = engine.step(state, jnp.asarray(gray), jnp.asarray(depth),
                                 CAM, CFG)
        img_with = render_debug_image(gray, state, CAM,
                                      cylinder_cells=out.cylinder_cells)
        img_without = render_debug_image(gray, state, CAM)
        assert (img_with != img_without).any()


class TestPlaneMatchGate:
    """Exact polygon intersection gate (map_primitive.cpp:91-161): rotated or
    elongated footprints whose bounding boxes overlap but whose polygons do not
    must be rejected; true overlaps must match."""

    @staticmethod
    def _plane_map_with_poly(verts2, normal=(-1.0, 0.0, 0.0), d=2500.0,
                             center=(2500.0, 0.0, 0.0)):
        pm = maps.empty_plane_map(CFG.mapping.max_planes)
        n = np.asarray(normal, np.float32)
        u = np.asarray([0.0, 1.0, 0.0], np.float32)
        v = np.asarray([0.0, 0.0, 1.0], np.float32)
        verts = np.zeros((pm.poly_verts.shape[1], 2), np.float32)
        verts[:len(verts2)] = verts2
        return pm._replace(
            params=pm.params.at[0].set(jnp.asarray([*n, d])),
            poly_verts=pm.poly_verts.at[0].set(jnp.asarray(verts)),
            poly_count=pm.poly_count.at[0].set(len(verts2)),
            basis_center=pm.basis_center.at[0].set(jnp.asarray(center)),
            basis_u=pm.basis_u.at[0].set(jnp.asarray(u)),
            basis_v=pm.basis_v.at[0].set(jnp.asarray(v)),
            fid=pm.fid.at[0].set(1),
            match_count=pm.match_count.at[0].set(1),
        )

    @staticmethod
    def _detection_with_poly(verts2, normal=(0.0, 0.0, -1.0), d=2500.0,
                             center=(0.0, 0.0, 2500.0)):
        """Detection in CAMERA coordinates (optical: z forward); the axis
        correction maps cam z->world x, cam -x->world y, cam -y->world z, so
        basis u=(-1,0,0), v=(0,-1,0) lands on the map's world (y, z) basis."""
        from rgbd_slam.features.primitives import (MAX_PLANES,
                                                       DetectedPlanes)

        nverts = 16
        params = np.zeros((MAX_PLANES, 4), np.float32)
        params[0] = [*normal, d]
        pv = np.zeros((MAX_PLANES, nverts, 2), np.float32)
        pv[0, :len(verts2)] = verts2
        pc = np.zeros((MAX_PLANES,), np.int32)
        pc[0] = len(verts2)
        zeros3 = np.zeros((MAX_PLANES, 3), np.float32)
        bc, bu, bv = zeros3.copy(), zeros3.copy(), zeros3.copy()
        bc[0] = center
        bu[0] = [-1.0, 0.0, 0.0]
        bv[0] = [0.0, -1.0, 0.0]
        valid = np.zeros((MAX_PLANES,), bool)
        valid[0] = True
        return DetectedPlanes(
            params=jnp.asarray(params), centroid=jnp.asarray(bc),
            mse=jnp.zeros((MAX_PLANES,)), point_count=jnp.asarray(pc, jnp.float32),
            cloud_cov=jnp.tile(jnp.eye(3)[None], (MAX_PLANES, 1, 1)),
            poly_verts=jnp.asarray(pv), poly_count=jnp.asarray(pc),
            basis_center=jnp.asarray(bc), basis_u=jnp.asarray(bu),
            basis_v=jnp.asarray(bv),
            cell_mask=jnp.zeros((MAX_PLANES, 192), bool),
            valid=jnp.asarray(valid))

    def _match(self, map_poly, det_poly):
        c2w = se3.camera_to_world(jnp.asarray([1.0, 0, 0, 0], jnp.float32),
                                  jnp.zeros(3, jnp.float32))
        pm = self._plane_map_with_poly(map_poly)
        det = self._detection_with_poly(det_poly)
        idx, _ = engine._match_planes(pm, det, c2w, CFG)
        return int(idx[0])

    def test_true_overlap_matches(self):
        square = [(-500, -500), (500, -500), (500, 500), (-500, 500)]
        assert self._match(square, square) == 0

    def test_diagonal_slivers_bbox_overlaps_polygons_dont(self):
        """Two thin diagonal slivers on opposite diagonals: bounding boxes are
        identical (full overlap) but the polygons barely intersect."""
        a = [(-1000, -1000), (-900, -1000), (1000, 900), (1000, 1000),
             (900, 1000), (-1000, -900)]
        b = [(1000, -1000), (1000, -900), (-900, 1000), (-1000, 1000),
             (-1000, 900), (900, -1000)]
        # same-plane parameters -> hessian gate passes; bbox IoU = 1.0
        assert self._match(a, b) == -1

    def test_small_corner_overlap_rejected(self):
        """Overlap below the 0.4 inter/area threshold is rejected."""
        a = [(-1000, -1000), (0, -1000), (0, 0), (-1000, 0)]
        b = [(-200, -200), (800, -200), (800, 800), (-200, 800)]
        # intersection = 200x200 = 4e4; det area = 1e6 -> ratio 0.04 < 0.4
        assert self._match(a, b) == -1


class TestDepthlessFusion:
    """Depth-less 3D-point observations fuse a real inverse-depth observation's
    cartesian projection (map_point.cpp:188-240), not a diagonal inflation."""

    def test_observation_on_ray_with_ray_aligned_covariance(self):
        from rgbd_slam.geometry import inverse_depth as idp
        from rgbd_slam.geometry import pinhole
        from rgbd_slam.tracking import inverse_depth_tracking as idt

        det = CFG.detection
        c2w = se3.camera_to_world(jnp.asarray([1.0, 0, 0, 0], jnp.float32),
                                  jnp.zeros(3, jnp.float32))
        uv = jnp.asarray([[200.0, 100.0]], jnp.float32)
        state = idp.from_screen_observation(
            uv, c2w, CAM, baseline_rho=det.inverse_depth_baseline / 2.0)
        world = np.asarray(idp.to_world(state))[0]
        # the projected observation sits on the camera ray through uv at
        # depth 2/baseline (rho = baseline/2)
        scr, ok = pinhole.world_to_screen(jnp.asarray(world[None]),
                                          se3.world_to_camera(
                                              jnp.asarray([1.0, 0, 0, 0],
                                                          jnp.float32),
                                              jnp.zeros(3, jnp.float32)), CAM)
        assert bool(ok[0])
        np.testing.assert_allclose(np.asarray(scr)[0, :2], [200.0, 100.0],
                                   atol=0.1)
        assert abs(np.linalg.norm(world) - 2.0 / det.inverse_depth_baseline) \
            < 1.0

        cov66 = idt.initial_covariance(
            jnp.broadcast_to(jnp.eye(3) * 1e-6, (1, 3, 3)), det)
        cov3 = np.asarray(idt.cartesian_covariance(state, cov66))[0]
        # covariance is far larger along the ray than across it
        ray = world / np.linalg.norm(world)
        along = ray @ cov3 @ ray
        eigs = np.linalg.eigvalsh(cov3)
        across = eigs[0]
        assert along / across > 100.0

    def test_depthless_match_still_updates_point(self):
        """A frame whose matched points lose depth must still fuse (the
        reference never skips the update)."""
        quat = jnp.asarray([1.0, 0, 0, 0], jnp.float32)
        state = engine.init_state(CAM, CFG)
        for i in range(3):
            g, d = render(quat, jnp.asarray([0.0, 4.0 * i, 0.0], jnp.float32))
            state, out = engine.step(state, g, d, CAM, CFG)
        g, d = render(quat, jnp.asarray([0.0, 12.0, 0.0], jnp.float32))
        state, out = engine.step(state, g, jnp.zeros_like(d), CAM, CFG)
        assert np.isfinite(np.asarray(state.points.pos)).all()
        assert np.isfinite(np.asarray(state.points.cov)).all()


class TestLostAndRecovery:
    """Mid-sequence tracking loss and recovery (reference: >3 consecutive pose
    failures -> lost, motion model reset, all detections re-seed the staged map;
    rgbd_slam.cpp:221-249, local_map.hpp:181-199).  Previous coverage was
    unit-level only — this drives the full engine through a blackout."""

    def test_blackout_recovery_e2e(self):
        quat = np.array([1.0, 0.0, 0.0, 0.0], np.float32)

        def pos(i):
            return np.array([0.0, 4.0 * (min(i, 7)), 0.0], np.float32)

        state = engine.init_state(CAM, CFG)
        flags = []
        for i in range(26):
            if 8 <= i < 14:
                # camera covered: featureless gray, no depth
                g = jnp.full((CAM.height, CAM.width), 128.0, jnp.float32)
                d = jnp.zeros((CAM.height, CAM.width), jnp.float32)
            else:
                g, d = render(quat, pos(i))
            state, out = engine.step(state, g, d, CAM, CFG)
            flags.append((bool(out.success), bool(out.is_lost),
                          int(out.n_points_alive)))

        succ = [f[0] for f in flags]
        lost = [f[1] for f in flags]
        # tracking failed through the blackout and the lost flag latched after
        # max_failed_tracking consecutive failures
        assert not any(succ[8:14]), f"blackout frames must fail: {succ[8:14]}"
        assert any(lost[8:16]), f"lost flag never latched: {lost}"
        # recovery: re-seeded map tracks again within a few frames of light
        assert any(succ[14:20]), f"never recovered after blackout: {succ[14:]}"
        assert succ[-1] and not lost[-1]
        # the held pose survives the blackout (gt did not move), so the
        # recovered trajectory stays consistent
        err = float(np.linalg.norm(np.asarray(state.position) - pos(25)))
        assert err < 25.0, f"post-recovery drift {err:.1f} mm"
        # the re-seeded map repopulated
        assert flags[-1][2] > 30


class TestCovarianceGating:
    """Live covariance-validity gating (reference: rgbd_slam.cpp:167-171 +
    point_with_tracking.cpp:43 hard-fail on invalid covariances; here the jit
    analogue marks the frame failed / rejects the fusion instead of letting a
    NaN or indefinite covariance propagate silently)."""

    def test_nan_map_points_fail_cleanly(self):
        quat = jnp.asarray([1.0, 0, 0, 0], jnp.float32)
        state = engine.init_state(CAM, CFG)
        for i in range(3):
            g, d = render(quat, jnp.asarray([0.0, 4.0 * i, 0.0], jnp.float32))
            state, out = engine.step(state, g, d, CAM, CFG)
        assert bool(out.success)
        # poison every alive landmark: the matched feature set feeding RANSAC
        # becomes degenerate and the LM solve goes non-finite
        state = state._replace(points=state.points._replace(
            pos=jnp.where(maps.alive(state.points)[:, None], jnp.nan,
                          state.points.pos)))
        prev_pos = np.asarray(state.position)
        g, d = render(quat, jnp.asarray([0.0, 12.0, 0.0], jnp.float32))
        state, out = engine.step(state, g, d, CAM, CFG)
        # clean failure frame: no NaN pose, success off, pose held
        assert not bool(out.success)
        assert np.isfinite(np.asarray(out.position)).all()
        assert np.isfinite(np.asarray(out.quat)).all()
        assert np.isfinite(np.asarray(out.pose_cov)).all()
        np.testing.assert_allclose(np.asarray(out.position), prev_pos)

    def test_indefinite_pose_cov_blocks_point_fusion(self):
        """A poisoned pose covariance propagates into the per-observation world
        covariances; the per-feature KF gate must keep the map finite."""
        quat = jnp.asarray([1.0, 0, 0, 0], jnp.float32)
        state = engine.init_state(CAM, CFG)
        for i in range(3):
            g, d = render(quat, jnp.asarray([0.0, 4.0 * i, 0.0], jnp.float32))
            state, out = engine.step(state, g, d, CAM, CFG)
        state = state._replace(
            pose_cov=jnp.full((6, 6), jnp.nan, jnp.float32))
        g, d = render(quat, jnp.asarray([0.0, 12.0, 0.0], jnp.float32))
        state, out = engine.step(state, g, d, CAM, CFG)
        assert np.isfinite(np.asarray(state.points.pos)).all()
        assert np.isfinite(np.asarray(state.points.cov)).all()

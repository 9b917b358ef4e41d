"""Front-end ops tests: FAST, BRIEF, LK optical flow, matching, depth cloud.

The reference has no unit tests for these (they are OpenCV calls); these tests pin the
behavior of our from-scratch kernels on synthetic images with known structure.
"""

import jax
import pytest
import jax.numpy as jnp
import numpy as np

from rgbd_slam.config import CameraIntrinsics
from rgbd_slam.ops import brief, depth_cloud, fast, image, matching, optical_flow

CAM = CameraIntrinsics(width=64, height=48, fx=50.0, fy=50.0, cx=32.0, cy=24.0)


def blob_grid(h, w, pitch=16, size=6, lo=50.0, hi=200.0):
    """Grid of isolated bright squares: their L-corners are true FAST-9 corners
    (checkerboard X-junctions are NOT: the max contiguous arc there is 8)."""
    img = np.full((h, w), lo, dtype=np.float32)
    for y in range(pitch // 2, h - size, pitch):
        for x in range(pitch // 2, w - size, pitch):
            img[y:y + size, x:x + size] = hi
    return img


def textured_image(rng, h=120, w=160):
    """Smooth random texture with strong gradients (good for LK)."""
    base = rng.uniform(0, 255, size=(h // 8, w // 8)).astype(np.float32)
    img = np.asarray(jax.image.resize(jnp.asarray(base), (h, w), "cubic"))
    return img


class TestImageOps:
    def test_blur_preserves_constant(self):
        img = jnp.full((32, 32), 7.0)
        out = image.gaussian_blur5(img)
        np.testing.assert_allclose(out, 7.0, atol=1e-5)

    def test_pyramid_shapes(self):
        img = jnp.zeros((48, 64))
        pyr = image.build_pyramid(img, 3)
        assert [p.shape for p in pyr] == [(48, 64), (24, 32), (12, 16), (6, 8)]

    def test_bilinear_sample_exact_on_grid(self, rng):
        img = jnp.asarray(rng.uniform(0, 1, (16, 16)), dtype=jnp.float32)
        xy = jnp.array([[3.0, 5.0], [10.0, 2.0]])
        vals = image.bilinear_sample(img, xy)
        np.testing.assert_allclose(vals, [img[5, 3], img[2, 10]], atol=1e-6)

    def test_bilinear_midpoint(self):
        img = jnp.array([[0.0, 1.0], [0.0, 1.0]])
        v = image.bilinear_sample(img, jnp.array([0.5, 0.5]))
        np.testing.assert_allclose(v, 0.5, atol=1e-6)

    def test_gradients_of_ramp(self):
        ys, xs = np.mgrid[0:16, 0:16]
        img = jnp.asarray(3.0 * xs + 2.0 * ys, dtype=jnp.float32)
        ix, iy = image.gradients(img)
        np.testing.assert_allclose(ix[2:-2, 2:-2], 3.0, atol=1e-5)
        np.testing.assert_allclose(iy[2:-2, 2:-2], 2.0, atol=1e-5)


class TestFast:
    def test_detects_corner_of_square(self):
        img = np.full((48, 64), 50.0, dtype=np.float32)
        img[16:32, 20:40] = 200.0  # bright rectangle: 4 corners
        is_corner, score = fast.fast_response(jnp.asarray(img), 20.0)
        found = np.argwhere(np.asarray(is_corner))
        assert len(found) > 0
        # each rectangle corner should have a detection within 2 px
        for cy, cx in [(16, 20), (16, 39), (31, 20), (31, 39)]:
            d = np.min(np.abs(found - [cy, cx]).sum(axis=1))
            assert d <= 2, f"corner ({cy},{cx}) missed"

    def test_no_corners_on_flat_image(self):
        img = jnp.full((48, 64), 100.0)
        is_corner, _ = fast.fast_response(img, 10.0)
        assert not bool(jnp.any(is_corner))

    def test_grid_detection_returns_valid_points(self):
        img = blob_grid(96, 128)
        xy, score, valid = fast.detect_fast_grid(jnp.asarray(img), max_points=50)
        assert xy.shape == (50, 2)
        n = int(valid.sum())
        assert n > 10
        # all valid points are interior
        v = np.asarray(valid)
        p = np.asarray(xy)[v]
        assert (p[:, 0] >= 3).all() and (p[:, 0] < 128 - 3).all()

    def test_detection_mask_suppresses(self):
        img = blob_grid(96, 128)
        xy0, _, v0 = fast.detect_fast_grid(jnp.asarray(img), max_points=50)
        # mask out everything: no detections
        mask = jnp.zeros((96, 128), dtype=bool)
        _, _, v1 = fast.detect_fast_grid(jnp.asarray(img), detection_mask=mask,
                                         max_points=50)
        assert int(v1.sum()) == 0

    def test_tracked_mask_radius(self):
        pts = jnp.array([[64.0, 48.0]])
        ok = jnp.array([True])
        mask = fast.tracked_points_mask((96, 128), pts, ok, radius=15.0)
        assert not bool(mask[48, 64])
        assert not bool(mask[48 + 14, 64])
        assert bool(mask[48, 64 + 20])


class TestBrief:
    def test_descriptor_deterministic_and_shifted(self, rng):
        img = textured_image(rng)
        xy = jnp.array([[40.0, 30.0], [80.0, 60.0], [120.0, 90.0]])
        valid = jnp.ones(3, dtype=bool)
        d1, v1 = brief.compute_brief(jnp.asarray(img), xy, valid)
        d2, v2 = brief.compute_brief(jnp.asarray(img), xy, valid)
        assert np.array_equal(np.asarray(d1), np.asarray(d2))
        assert np.asarray(v1).all()

    def test_same_point_matches_itself_across_noise(self, rng):
        img = textured_image(rng)
        noisy = img + rng.normal(0, 2.0, img.shape).astype(np.float32)
        xy = jnp.asarray(rng.uniform([20, 20], [140, 100], (8, 2)), jnp.float32)
        valid = jnp.ones(8, dtype=bool)
        da, _ = brief.compute_brief(jnp.asarray(img), xy, valid)
        db, _ = brief.compute_brief(jnp.asarray(noisy), xy, valid)
        dist = brief.hamming_distance_matrix(da, db)
        d = np.asarray(dist)
        # self-distance far below cross-distance
        self_d = np.diag(d)
        cross = d + np.eye(8) * 1000
        assert (self_d < cross.min(axis=1)).all()
        assert self_d.mean() < 40

    def test_border_points_invalidated(self, rng):
        img = textured_image(rng)
        xy = jnp.array([[2.0, 2.0], [80.0, 60.0]])
        _, v = brief.compute_brief(jnp.asarray(img), xy, jnp.ones(2, dtype=bool))
        assert not bool(v[0]) and bool(v[1])


class TestOpticalFlow:
    def test_tracks_pure_translation(self, rng):
        img = textured_image(rng, 120, 160)
        shift = (3, 5)  # (dy, dx)
        img2 = np.roll(img, shift, axis=(0, 1))
        pyr1 = image.build_pyramid(jnp.asarray(img), 3)
        pyr2 = image.build_pyramid(jnp.asarray(img2), 3)
        pts = jnp.asarray(rng.uniform([30, 30], [130, 90], (16, 2)), jnp.float32)
        valid = jnp.ones(16, dtype=bool)
        new_pts, status = optical_flow.lk_track(pyr1, pyr2, pts, valid,
                                               levels=3, win_h=21, win_w=21)
        ok = np.asarray(status)
        assert ok.sum() >= 12
        flow = np.asarray(new_pts - pts)[ok]
        np.testing.assert_allclose(flow[:, 0], shift[1], atol=0.5)
        np.testing.assert_allclose(flow[:, 1], shift[0], atol=0.5)

    def test_forward_backward_keeps_good_points(self, rng):
        img = textured_image(rng, 120, 160)
        img2 = np.roll(img, (2, -4), axis=(0, 1))
        pyr1 = image.build_pyramid(jnp.asarray(img), 3)
        pyr2 = image.build_pyramid(jnp.asarray(img2), 3)
        pts = jnp.asarray(rng.uniform([40, 40], [120, 80], (12, 2)), jnp.float32)
        valid = jnp.ones(12, dtype=bool)
        tracked, status = optical_flow.track_forward_backward(
            pyr1, pyr2, pts, valid, levels=3, win_h=21, win_w=21)
        assert int(status.sum()) >= 9

    def test_flat_region_fails(self):
        img = jnp.full((64, 64), 100.0)
        pyr = image.build_pyramid(img, 2)
        pts = jnp.array([[32.0, 32.0]])
        _, status = optical_flow.lk_track(pyr, pyr, pts, jnp.array([True]),
                                          levels=2, win_h=11, win_w=11)
        assert not bool(status[0])


class TestMatching:
    def test_spatial_gate_blocks_distant_match(self, rng):
        desc = jnp.asarray(rng.integers(0, 2**32, (2, 8), dtype=np.uint32))
        map_uv = jnp.array([[10.0, 10.0], [100.0, 100.0]])
        det_uv = jnp.array([[12.0, 11.0], [200.0, 200.0]])
        idx, dist = matching.match_descriptors(
            desc, map_uv, jnp.ones(2, bool),
            desc, det_uv, jnp.ones(2, bool), jnp.zeros(2, bool),
            search_radius=30.0)
        assert int(idx[0]) == 0        # same descriptor, within window
        assert int(idx[1]) == -1       # its detection is 140px away

    def test_taken_detections_excluded(self, rng):
        desc = jnp.asarray(rng.integers(0, 2**32, (1, 8), dtype=np.uint32))
        idx, _ = matching.match_descriptors(
            desc, jnp.array([[10.0, 10.0]]), jnp.ones(1, bool),
            desc, jnp.array([[10.0, 10.0]]), jnp.ones(1, bool),
            jnp.array([True]),  # taken by optical flow
            search_radius=30.0)
        assert int(idx[0]) == -1

    def test_conflict_resolution_keeps_best(self):
        match_index = jnp.array([0, 0, 1], dtype=jnp.int32)
        match_dist = jnp.array([10, 5, 7], dtype=jnp.int32)
        resolved = matching.resolve_match_conflicts(match_index, match_dist, 4)
        assert list(np.asarray(resolved)) == [-1, 0, 1]


class TestDepthCloud:
    def test_back_projection_round_trip(self, rng):
        depth = jnp.asarray(rng.uniform(500, 3000, (48, 64)), dtype=jnp.float32)
        cloud, valid = depth_cloud.depth_to_cloud(depth, CAM)
        assert bool(valid.all())
        # reproject: u = fx x/z + cx
        u = CAM.fx * cloud[..., 0] / cloud[..., 2] + CAM.cx
        v = CAM.fy * cloud[..., 1] / cloud[..., 2] + CAM.cy
        us = np.broadcast_to(np.arange(64), (48, 64))
        vs = np.broadcast_to(np.arange(48)[:, None], (48, 64))
        np.testing.assert_allclose(np.asarray(u), us, atol=1e-2)
        np.testing.assert_allclose(np.asarray(v), vs, atol=1e-2)

    def test_invalid_depth_masked(self):
        depth = jnp.array([[10.0, 1000.0], [7000.0, 0.0]])
        cloud, valid = depth_cloud.depth_to_cloud(depth, CAM)
        assert np.asarray(valid).tolist() == [[False, True], [False, False]]
        assert float(jnp.abs(cloud[0, 0]).sum()) == 0.0

    def test_cell_organization(self):
        arr = jnp.arange(40 * 60 * 3, dtype=jnp.float32).reshape(40, 60, 3)
        cells = depth_cloud.organize_by_cells(arr, patch=20)
        assert cells.shape == (2 * 3, 400, 3)
        # first cell contains exactly the top-left 20x20 patch
        np.testing.assert_array_equal(
            np.asarray(cells[0]).reshape(20, 20, 3), np.asarray(arr[:20, :20]))

    def test_rectify_identity(self, rng):
        depth = jnp.asarray(rng.uniform(500, 3000, (48, 64)), dtype=jnp.float32)
        out = depth_cloud.rectify_depth(depth, CAM, CAM, np.eye(4))
        # identity extrinsics: most pixels keep their depth
        close = np.abs(np.asarray(out) - np.asarray(depth)) < 1.0
        assert close.mean() > 0.95


@pytest.mark.slow
class TestRectifyTwoCamera:
    """Non-identity depth->rgb extrinsics against a synthetic two-camera render
    (VERDICT r2 next #7; reference: rgbd_slam.cpp:99-121 +
    depth_map_transformation.cpp:23-87)."""

    def test_offset_camera_rectifies_onto_rgb_view(self):
        from rgbd_slam.config import CameraIntrinsics
        from rgbd_slam.synthetic import RoomScene

        cam = CameraIntrinsics(width=160, height=120, fx=130.0, fy=130.0,
                               cx=80.0, cy=60.0)
        scene = RoomScene(cam)
        ident = np.array([1.0, 0.0, 0.0, 0.0], np.float32)
        # depth camera 20 mm to the RIGHT of the rgb camera: physical frame is
        # x fwd / y left / z up (se3.AXIS_CORRECTION), so right = -y world; in
        # optical coords (x right, y down, z fwd) the offset is +x
        _, depth_rgb_view = scene.render(ident, np.zeros(3, np.float32))
        _, depth_cam_view = scene.render(ident,
                                         np.array([0.0, -20.0, 0.0], np.float32))
        ext = np.eye(4)
        ext[0, 3] = 20.0  # depth-cam optical origin at +20 mm x in rgb frame
        out = np.asarray(depth_cloud.rectify_depth(
            jnp.asarray(depth_cam_view), cam, cam, ext))
        both = (out > 0) & (depth_rgb_view > 0)
        assert both.mean() > 0.8
        err = np.abs(out - depth_rgb_view)[both]
        # forward-warp quantization is ~1 px; the scene's depth gradient keeps
        # the residual within a few mm for the bulk of pixels
        assert np.median(err) < 5.0
        assert (err < 25.0).mean() > 0.9

    def test_runner_applies_rectification(self):
        from rgbd_slam import runner
        from rgbd_slam.config import (CameraIntrinsics, CameraSetup,
                                          SlamConfig)
        from rgbd_slam.synthetic import RoomScene, lateral_trajectory

        cam = CameraIntrinsics(width=160, height=120, fx=130.0, fy=130.0,
                               cx=80.0, cy=60.0)
        cfg = SlamConfig()
        scene = RoomScene(cam)
        ident = np.array([1.0, 0.0, 0.0, 0.0], np.float32)
        ext = tuple(tuple(row) for row in
                    [[1.0, 0.0, 0.0, 20.0], [0.0, 1.0, 0.0, 0.0],
                     [0.0, 0.0, 1.0, 0.0], [0.0, 0.0, 0.0, 1.0]])
        setup = CameraSetup(rgb=cam, depth=cam, depth_to_rgb=ext)
        frames = []
        for q, p in lateral_trajectory(4, speed_mm=5.0):
            gray, _ = scene.render(q, p)
            # depth rendered from the OFFSET camera; the runner must rectify it
            # into the rgb view before the engine consumes it
            _, depth = scene.render(q, p + np.array([0.0, -20.0, 0.0],
                                                    np.float32))
            frames.append((gray, depth))
        _, traj, stats = runner.run_frames(frames, cam, cfg, with_planes=True,
                                           camera_setup=setup)
        assert stats.success_count >= 2

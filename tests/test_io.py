"""IO layer tests: dataset parsing, trajectory/ATE, map writers."""

import os

import numpy as np
import pytest

from rgbd_slam.io import datasets, map_writer
from rgbd_slam.io.trajectory import Trajectory, ate_rmse, umeyama_alignment


class TestTumParsing:
    def make_dataset(self, tmp_path, n=4):
        from PIL import Image

        d = tmp_path / "seq"
        (d / "rgb").mkdir(parents=True)
        (d / "depth").mkdir()
        rgb_lines, depth_lines, gt_lines = ["# rgb"], ["# depth"], ["# gt"]
        rng = np.random.default_rng(0)
        for i in range(n):
            ts = 1000.0 + 0.1 * i
            rgb = (rng.uniform(0, 255, (48, 64, 3))).astype(np.uint8)
            depth = (rng.uniform(1000, 20000, (48, 64))).astype(np.uint16)
            Image.fromarray(rgb).save(d / "rgb" / f"{ts:.4f}.png")
            Image.fromarray(depth.astype(np.int32), mode="I").save(d / "depth" / f"{ts + 0.004:.4f}.png")
            rgb_lines.append(f"{ts:.4f} rgb/{ts:.4f}.png")
            depth_lines.append(f"{ts + 0.004:.4f} depth/{ts + 0.004:.4f}.png")
            gt_lines.append(f"{ts:.4f} {0.01 * i} 0 0 0 0 0 1")
        (d / "rgb.txt").write_text("\n".join(rgb_lines))
        (d / "depth.txt").write_text("\n".join(depth_lines))
        (d / "groundtruth.txt").write_text("\n".join(gt_lines))
        return str(d)

    def test_index_and_load(self, tmp_path):
        path = self.make_dataset(tmp_path)
        idx = datasets.index_tum(path)
        assert len(idx) == 4
        assert idx[0].gt_position is not None
        frame = datasets.load_tum_frame(idx[0])
        assert frame.gray.shape == (48, 64)
        assert frame.depth_mm.shape == (48, 64)
        # depth scaled by 1/5 (main_TUM.cpp:242)
        assert 200 <= frame.depth_mm.mean() <= 4000

    def test_ground_truth_quaternion_order(self, tmp_path):
        path = self.make_dataset(tmp_path)
        idx = datasets.index_tum(path)
        # file is qx qy qz qw = 0 0 0 1 -> stored wxyz = 1 0 0 0
        np.testing.assert_allclose(idx[0].gt_quaternion, [1, 0, 0, 0])


class TestTrajectory:
    def test_ate_zero_for_identical(self, rng):
        p = rng.normal(size=(20, 3)) * 100
        assert ate_rmse(p, p) < 1e-9

    def test_ate_invariant_to_rigid_motion(self, rng):
        p = rng.normal(size=(50, 3)) * 100
        from rgbd_slam.geometry import se3
        import jax.numpy as jnp

        q = rng.normal(size=4)
        q /= np.linalg.norm(q)
        r = np.asarray(se3.quat_to_matrix(jnp.asarray(q)))
        moved = p @ r.T + np.array([10.0, -5.0, 3.0])
        assert ate_rmse(moved, p, align=True) < 1e-4

    def test_ate_detects_real_error(self, rng):
        p = rng.normal(size=(50, 3)) * 100
        noisy = p + rng.normal(size=(50, 3)) * 5
        err = ate_rmse(noisy, p, align=True)
        assert 2.0 < err < 15.0

    def test_save_tum_format(self, tmp_path, rng):
        t = Trajectory()
        t.append(1.0, [1, 2, 3], [1, 0, 0, 0])
        out = tmp_path / "traj.txt"
        t.save_tum_format(str(out))
        line = out.read_text().strip().split()
        assert len(line) == 8
        assert float(line[7]) == 1.0  # qw last


class TestMapWriters:
    def test_obj_writer(self, tmp_path):
        path = str(tmp_path / "map.obj")
        with map_writer.OBJWriter(path) as w:
            w.add_point([1.0, 2.0, 3.0])
            w.add_line([[0, 0, 0], [1, 1, 1]])
            w.add_polygon([[0, 0, 0], [1, 0, 0], [1, 1, 0]], [0, 0, 1])
        text = open(path).read()
        assert "v 1.0 2.0 3.0" in text
        assert text.count("v ") == 6
        assert "l " in text and "f " in text and "vn " in text

    def test_xyz_writer(self, tmp_path):
        path = str(tmp_path / "map.xyz")
        with map_writer.XYZWriter(path) as w:
            w.add_point([1.0, 2.0, 3.0])
        assert open(path).read().strip() == "1.0 2.0 3.0"

    def test_pcd_writer_header(self, tmp_path):
        path = str(tmp_path / "map.pcd")
        with map_writer.PCDWriter(path) as w:
            w.add_point([1.0, 2.0, 3.0])
            w.add_point([4.0, 5.0, 6.0])
        text = open(path).read()
        assert "POINTS 2" in text and "DATA ascii" in text

    def test_export_slam_map(self, tmp_path):
        from rgbd_slam import engine
        from rgbd_slam.config import CameraIntrinsics, SlamConfig, MappingConfig

        cfg = SlamConfig(mapping=MappingConfig(max_points_3d=32, max_points_2d=8,
                                               max_planes=4))
        cam = CameraIntrinsics(width=64, height=48)
        state = engine.init_state(cam, cfg)
        # hand-place one alive point
        state = state._replace(points=state.points._replace(
            fid=state.points.fid.at[0].set(7),
            pos=state.points.pos.at[0].set([1.0, 2.0, 3.0])))
        path = str(tmp_path / "out.obj")
        map_writer.export_slam_map(state, path)
        assert "v 1.0 2.0 3.0" in open(path).read()


@pytest.mark.slow
class TestStreamingMapExport:
    """Streaming feature-death export (reference: feature_map.hpp:748-758 — every
    lost LOCAL feature is appended to the map file at death, :288-298 the
    surviving local map is appended at shutdown)."""

    def test_dead_features_reach_the_export(self, tmp_path):
        import jax.numpy as jnp

        from rgbd_slam import runner
        from rgbd_slam.mapping import maps as maps_mod
        from test_engine import CAM, CFG, render
        from rgbd_slam.geometry import se3

        # 4 static frames promote wall points to local; a long pan then drives
        # the original features out of view until they exceed the 10-miss
        # lifecycle limit and die mid-run
        frames = []
        for i in range(26):
            yaw = 0.0 if i < 4 else 0.06 * (i - 3)
            quat = se3.quat_from_axis_angle(jnp.asarray([0.0, 0.0, 1.0]),
                                            jnp.asarray(yaw, jnp.float32))
            frames.append(render(np.asarray(quat), np.zeros(3, np.float32)))

        evicted_per_frame = []

        def on_frame(i, state, out, dt):
            evicted_per_frame.append(int(np.asarray(out.point_evicted).sum()))

        path = str(tmp_path / "streamed.obj")
        state, traj, stats = runner.run_frames(
            frames, CAM, CFG, with_planes=True, export_map=path,
            on_frame=on_frame)

        total_evicted = sum(evicted_per_frame)
        assert total_evicted > 0, \
            "pan sequence must evict local features mid-run"
        # the streamed file holds dead + surviving-local features: strictly more
        # points than the final alive-local map alone
        n_alive_local = int(np.asarray(
            maps_mod.alive(state.points) & state.points.is_local).sum())
        v_lines = [ln for ln in open(path).read().splitlines()
                   if ln.startswith("v ")]
        assert len(v_lines) >= n_alive_local + total_evicted

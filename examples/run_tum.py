#!/usr/bin/env python
"""TUM RGB-D sequence runner (parity with reference examples/main_TUM.cpp).

Usage:
    python examples/run_tum.py -d /path/to/rgbd_dataset_freiburg1_xyz \\
        [-c tum_fr1] [-n MAX_FRAMES] [-o trajectory.txt] [-m map.obj] \\
        [--no-planes] [--lines] [--ba N] [--stream-map]

Prints per-frame status, final ATE-RMSE vs groundtruth (when present — replacing the
reference's ad-hoc per-frame error print, main_TUM.cpp:264-270), and the stage timing
summary (show_statistics parity).
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np

from rgbd_slam import runner
from rgbd_slam.config import TUM_FR1, CameraIntrinsics, SlamConfig
from rgbd_slam.io import datasets
from rgbd_slam.io.map_writer import export_slam_map
from rgbd_slam.io.trajectory import ate_rmse

CAMERAS = {
    "tum_fr1": TUM_FR1,
    "tum_fr2": CameraIntrinsics(640, 480, 520.9, 521.0, 325.1, 249.7),
    "tum_fr3": CameraIntrinsics(640, 480, 535.4, 539.2, 320.1, 247.6),
    "default": CameraIntrinsics(),
}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("-d", "--dataset", required=True, help="TUM sequence directory")
    ap.add_argument("-c", "--camera", default="tum_fr1", choices=sorted(CAMERAS))
    ap.add_argument("--camera-yaml", default="",
                    help="camera YAML (reference configuration_example.yaml "
                         "format); overrides -c")
    ap.add_argument("-n", "--max-frames", type=int, default=0)
    ap.add_argument("-o", "--trajectory-out", default="")
    ap.add_argument("-m", "--map-out", default="")
    ap.add_argument("--no-planes", action="store_true")
    ap.add_argument("--lines", action="store_true",
                    help="enable the line feature map + line pose residuals "
                         "(north-star config 2; beyond the reference, whose "
                         "line path is compiled out)")
    ap.add_argument("--ba", dest="ba_every", type=int, default=0, metavar="N",
                    help="run windowed Schur BA every N frames (0 = off), with "
                         "keyframe selection and pose-graph stitching")
    ap.add_argument("--stream-map", action="store_true",
                    help="stream the map file during the run (features append "
                         "at death, reference feature_map.hpp:748-758) instead "
                         "of a shutdown snapshot; requires -m")
    ap.add_argument("--native-loader", action="store_true",
                    help="use the C++ prefetching PNG loader")
    args = ap.parse_args()

    setup = None
    if args.camera_yaml:
        from rgbd_slam.config import load_camera_yaml

        setup = load_camera_yaml(args.camera_yaml)
        cam = setup.rgb
    else:
        cam = CAMERAS[args.camera]
    cfg = SlamConfig()
    index = datasets.index_tum(args.dataset)
    if args.max_frames:
        index = index[: args.max_frames]
    if not index:
        print("no frames found", file=sys.stderr)
        return 1
    print(f"{len(index)} frames in {args.dataset}")

    if args.native_loader:
        from rgbd_slam.io.native_loader import NativeFrameLoader

        loader = NativeFrameLoader([i.rgb_path for i in index],
                                   [i.depth_path for i in index],
                                   cam.height, cam.width, depth_scale=0.2)
        frames = ((g, d, index[i].timestamp)
                  for i, (g, d) in enumerate(loader))
    else:
        frames = ((f.gray, f.depth_mm, f.timestamp)
                  for f in map(datasets.load_tum_frame, index))

    def on_frame(i, state, out, dt):
        if i % 20 == 0:
            print(f"frame {i}: success={bool(out.success)} "
                  f"lost={bool(out.is_lost)} "
                  f"pts={int(out.n_points_alive)} "
                  f"planes={int(out.n_planes_alive)} ({dt * 1000:.0f} ms)")

    state, traj, stats = runner.run_frames(
        frames, cam, cfg, with_planes=not args.no_planes,
        with_lines=args.lines, on_frame=on_frame,
        ba_every=args.ba_every or None,
        export_map=(args.map_out if args.stream_map and args.map_out else None),
        camera_setup=setup)
    print(stats.summary())
    if args.ba_every:
        print(f"BA: runs={stats.ba_runs} accepted={stats.ba_accepted} "
              f"iters/s={stats.ba_iters_per_s:.1f} "
              f"keyframes={stats.keyframe_count}")

    gt = [i.gt_position for i in index if i.gt_position is not None]
    if len(gt) == len(index):
        gt_mm = np.stack(gt) * 1000.0  # TUM groundtruth is meters
        est = traj.positions_array()
        n = min(len(est), len(gt_mm))
        print(f"ATE-RMSE: {ate_rmse(est[:n], gt_mm[:n]):.1f} mm over {n} frames")

    if args.trajectory_out:
        traj.save_tum_format(args.trajectory_out)
        print(f"trajectory -> {args.trajectory_out}")
    if args.map_out and not args.stream_map:
        export_slam_map(state, args.map_out)
    if args.map_out:
        print(f"map -> {args.map_out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python
"""Smoke test of the SLAM engine on one GPU: the quickest proof that it runs.

    python chip_smoke.py               # one GPU: every phase below
    python chip_smoke.py --four-cards  # four GPUs: sharded BA vs one device

Phases, in order; any failure exits non-zero (nothing is caught):

1. the card's name and power limit (nvidia-smi);
2. the ``gpu``-marked tests, in a child process that ends before this process
   imports JAX, so one process at a time holds the card;
3. JAX finds a GPU;
4. the Triton LK kernel against the XLA path at the engine's real widths
   (tests/lk_real_width.py), with both timings;
5. the main path: ``runner.run_frames`` over the seeded 120-frame 640x480 room
   orbit with planes, keyframe BA and the pose graph: no frame lost, and ATE at
   most 1.25x that of the same frames and seed on the CPU backend;
6. 20 frames with the line map on;
7. the phase-5 run again: are the trajectories bit-identical?
8. peak device memory and the compile and set-up seconds.

The last line of standard output is one JSON object naming the device.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
N_FRAMES = 120
N_LINES_FRAMES = 20
# ATE-RMSE of phase 5's run on the CPU backend (same frames, seed and config;
# JAX 0.9.0 XLA:CPU on the H100 machine's host, 0 frames lost, 14 BA runs)
CPU_ATE_MM = 15.481
ATE_FACTOR = 1.25


def card():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True, text=True)
    return out.stdout.strip()


def gpu_tests():
    env = dict(os.environ, JAX_PLATFORMS="cuda")
    subprocess.run([sys.executable, "-m", "pytest", "tests", "-m", "gpu", "-q",
                    "-p", "no:cacheprovider"], cwd=REPO, env=env, check=True)


def room_orbit(n_frames: int, cam=None):
    """Device-resident frames of the seeded room orbit and ground truth
    (TUM fr1 intrinsics unless ``cam`` is given)."""
    import numpy as np

    from rgbd_slam import runner
    from rgbd_slam.config import TUM_FR1
    from rgbd_slam.geometry.covariances import DepthNoiseModel
    from rgbd_slam.synthetic import RoomScene, orbit_trajectory

    scene = RoomScene(cam or TUM_FR1, depth_noise=DepthNoiseModel())
    poses = orbit_trajectory(n_frames, speed_mm=4.0)
    frames = runner.stage_frames([scene.render(q, p) for q, p in poses])
    return frames, np.stack([p for _, p in poses]).astype(np.float64)


def main_path(frames, gt, cam=None, **kw):
    """One run_frames pass with planes, BA and the pose graph."""
    from rgbd_slam import runner
    from rgbd_slam.config import TUM_FR1, SlamConfig

    _, traj, stats = runner.run_frames(frames, cam or TUM_FR1, SlamConfig(),
                                       with_planes=True, ba_every=8, **kw)
    ate = runner.evaluate_against_ground_truth(traj, gt)["ate_rmse_mm"]
    return traj, stats, ate


def keyframe_window(seed: int = 0, cam=None, every: int = 4):
    """A full keyframe window as the runner builds one: 8 keyframes, one every
    ``every`` frames of the room orbit, each observing up to 512 landmarks
    (the map's point capacity) with 0.5 px pixel noise and 1% depth noise,
    starting from poses and landmarks off the truth by a few mm."""
    import jax.numpy as jnp
    import numpy as np

    from rgbd_slam.config import TUM_FR1, SlamConfig
    from rgbd_slam.geometry import pinhole, se3
    from rgbd_slam.parallel.keyframes import KeyframeWindow
    from rgbd_slam.synthetic import orbit_trajectory

    cam = cam or TUM_FR1
    rng = np.random.default_rng(seed)
    window = KeyframeWindow()
    n = SlamConfig().mapping.max_points_3d
    poses = orbit_trajectory(window.max_keyframes * every)[::every]
    # landmarks: random pixels of the first keyframe at 0.8-4 m
    screen = np.stack([rng.uniform(0, cam.width, n),
                       rng.uniform(0, cam.height, n),
                       rng.uniform(800.0, 4000.0, n)], axis=-1)
    lm = np.asarray(pinhole.screen_to_world(
        jnp.asarray(screen, jnp.float32),
        se3.camera_to_world(*map(jnp.asarray, poses[0])), cam))
    for i, (quat, pos) in enumerate(poses):
        s, ok = pinhole.world_to_screen(
            jnp.asarray(lm), se3.world_to_camera(jnp.asarray(quat),
                                                 jnp.asarray(pos)), cam)
        s = np.asarray(s)
        ok = np.asarray(ok) & ((s[:, 0] >= 0) & (s[:, 0] < cam.width)
                               & (s[:, 1] >= 0) & (s[:, 1] < cam.height))
        fobs = np.concatenate([
            ok[:, None],
            s[:, :2] + rng.normal(0.0, 0.5, (n, 2)),
            s[:, 2:] * (1.0 + rng.normal(0.0, 0.01, (n, 1))),
            lm + rng.normal(0.0, 10.0, lm.shape)], axis=-1).astype(np.float32)
        off = rng.normal(0.0, 5.0, 3) if i else 0.0
        window.add_keyframe_packed(quat, pos + off, fobs,
                                   np.arange(n, dtype=np.int32),
                                   frame_id=i * every)
    return window


def sharded_ba(devices, cam=None):
    """The sharded-BA path on ``devices`` against one device, on a full
    keyframe window: ``KeyframeWindow.refine(mesh=...)``, the call
    ``run_frames(ba_mesh=...)`` makes, and ``make_sharded_ba`` with the
    dense and the pcg reduced solver."""
    import jax
    import numpy as np
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    from rgbd_slam.config import TUM_FR1
    from rgbd_slam.parallel import ba

    mesh = Mesh(np.array(devices), ("lm",))
    cam = cam or TUM_FR1
    window = keyframe_window(cam=cam)
    k, iters = window.max_keyframes, 8

    one, _, one_costs = window.refine(cam, iterations=iters)
    one_pos = np.stack([p for _, p in one])
    res = {"landmarks": int(window.build_problem()[-1].sum()),
           "one_device": [float(c) for c in one_costs]}
    # dense: the runner's own sharded refine
    refined, _, costs = window.refine(cam, iterations=iters, mesh=mesh)
    pos = np.stack([p for _, p in refined])
    res["dense"] = costs
    # pcg: the same window through make_sharded_ba's row-block-sharded solve
    poses, landmarks, obs_kf, obs_uv, obs_z, obs_mask = window.build_problem()[:6]
    fn = ba.make_sharded_ba(mesh, cam, n_keyframes=k, iterations=iters,
                            anchored=True, reduced_solver="pcg",
                            with_depth=True)
    sh = NamedSharding(mesh, P("lm"))
    new_poses, _, res["pcg"] = fn(poses, *(
        jax.device_put(a, sh)
        for a in (landmarks, obs_kf, obs_uv, obs_mask, obs_z)))
    # pose coefficients lead with the position
    pcg_pos = np.asarray(new_poses)[:len(one), :3]
    for solver, p in (("dense", pos), ("pcg", pcg_pos)):
        res[solver] = [float(c) for c in np.asarray(res[solver])]
        np.testing.assert_allclose(res[solver], one_costs, rtol=2e-3)
        np.testing.assert_allclose(p, one_pos, atol=2e-2)
    return res


def device_line(jax):
    d = jax.devices()[0]
    return json.dumps({"ok": True, "device": {
        "platform": d.platform, "kind": d.device_kind,
        "count": len(jax.devices())}})


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--four-cards", action="store_true",
                        help="run only the sharded-BA path on four GPUs")
    four = parser.parse_args().four_cards

    print(f"card: {card()}", flush=True)
    if not four:
        gpu_tests()

    t_import = time.time()
    sys.path.insert(0, REPO)
    import jax
    import numpy as np

    import rgbd_slam  # noqa: F401 (compile cache, matmul precision)

    dev = jax.devices()[0]
    assert dev.platform == "gpu", f"no GPU: JAX runs on {dev.platform}"
    print(f"device: {dev.device_kind} x{len(jax.devices())}", flush=True)

    if four:
        assert len(jax.devices()) >= 4, jax.devices()
        t0 = time.time()
        res = sharded_ba(jax.devices()[:4])
        print("sharded BA on 4 GPUs == one device (costs rtol 2e-3, poses "
              f"atol 2e-2), {time.time() - t0:.1f} s with compiles: "
              f"{json.dumps(res)}", flush=True)
        print(device_line(jax))
        return

    sys.path.insert(0, os.path.join(REPO, "tests"))
    import lk_real_width

    lk = lk_real_width.compare(reps=50)
    lk_real_width.check(lk)
    print(f"LK kernel vs XLA at 640x480, T=128, 53x53, 5 levels: "
          f"{json.dumps(lk)}", flush=True)

    t_setup = time.time()
    frames, gt = room_orbit(N_FRAMES)
    setup_s = time.time() - t_setup
    traj, stats, ate = main_path(frames, gt)
    print(f"main path: {N_FRAMES} frames, ATE {ate:.3f} mm, lost "
          f"{stats.lost_count}, BA runs {stats.ba_runs}, "
          f"{stats.fps:.1f} fps, compile {stats.compile_s:.1f} s "
          f"(BA {stats.ba_compile_s:.1f} s)", flush=True)
    assert stats.lost_count == 0, stats.summary()
    assert np.isfinite(traj.positions_array()).all()
    assert ate <= ATE_FACTOR * CPU_ATE_MM, (ate, CPU_ATE_MM)

    from rgbd_slam import runner
    from rgbd_slam.config import TUM_FR1, SlamConfig

    _, ltraj, lstats = runner.run_frames(frames[:N_LINES_FRAMES], TUM_FR1,
                                         SlamConfig(), with_planes=True,
                                         with_lines=True)
    lines_ate = runner.evaluate_against_ground_truth(
        ltraj, gt[:N_LINES_FRAMES])["ate_rmse_mm"]
    print(f"lines: {N_LINES_FRAMES} frames, ATE {lines_ate:.3f} mm, lost "
          f"{lstats.lost_count}", flush=True)
    assert lstats.lost_count == 0, lstats.summary()
    assert np.isfinite(ltraj.positions_array()).all()

    traj2, _, _ = main_path(frames, gt)
    same = (np.array_equal(traj.positions_array(), traj2.positions_array())
            and np.array_equal(np.asarray(traj.quaternions),
                               np.asarray(traj2.quaternions)))
    print(f"determinism: two runs of the same seeded sequence are "
          f"{'bit-identical' if same else 'NOT bit-identical'}", flush=True)

    peak = dev.memory_stats()["peak_bytes_in_use"]
    print(f"peak device memory {peak} B; set-up {setup_s:.1f} s; compile "
          f"{stats.compile_s + stats.ba_compile_s:.1f} s; process "
          f"{time.time() - t_import:.1f} s since JAX import", flush=True)
    print(device_line(jax))


if __name__ == "__main__":
    main()

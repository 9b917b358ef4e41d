"""LK kernel against the XLA path at the engine's real widths.

Two 640x480 frames of the seeded room orbit, the default DetectionConfig (53x53
windows, 5 pyramid levels, 10 iterations, finest-level backward track, 3 px
round-trip gate) and 128 tracked slots.  Shared by the GPU test in
``test_lk_kernel.py`` and by ``chip_smoke.py``.

Both implementations run in float32 with no matrix product; only the order of
the window sums differs (53x53 reduction trees in XLA, masked 64x64 blocks in
the kernel), so tracked points agree to ~1e-4 px and the status can flip only
for a slot whose round trip sits on the gate.
"""

from __future__ import annotations

import time

import jax
import jax.numpy as jnp
import numpy as np

from rgbd_slam.config import TUM_FR1, SlamConfig
from rgbd_slam.geometry.covariances import DepthNoiseModel
from rgbd_slam.ops import image, optical_flow
from rgbd_slam.synthetic import RoomScene, orbit_trajectory

N_SLOTS = 128
POINT_TOL_PX = 0.01      # kernel vs XLA where both accept
MAX_STATUS_FLIPS = 2     # slots whose status differs...
GATE_TOL_PX = 0.01       # ...each with its round trip this close to the gate


def lk_args(cfg: SlamConfig = SlamConfig(), cam=TUM_FR1):
    det = cfg.detection
    levels = det.optical_flow_pyramid_depth
    return dict(max_roundtrip_px=det.optical_flow_roundtrip_px, levels=levels,
                win_h=cam.height // det.optical_flow_window_height,
                win_w=cam.width // det.optical_flow_window_width,
                iterations=det.optical_flow_iterations,
                bwd_levels=(None if det.optical_flow_backward_depth >= levels
                            else det.optical_flow_backward_depth),
                coarse_win=det.optical_flow_coarse_window_px,
                coarse_from_level=det.optical_flow_coarse_from_level,
                eps=det.optical_flow_eps_px)


def inputs(seed: int = 0, frame_gap: int = 2):
    """Pyramids of two rendered frames and N_SLOTS seeded slots (a few invalid,
    a few on the border)."""
    cam, args = TUM_FR1, lk_args()
    scene = RoomScene(cam, depth_noise=DepthNoiseModel())
    poses = orbit_trajectory(frame_gap + 1, speed_mm=4.0)
    g0 = scene.render(*poses[0])[0]
    g1 = scene.render(*poses[frame_gap])[0]
    pyr0 = image.build_pyramid(jnp.asarray(g0), args["levels"])
    pyr1 = image.build_pyramid(jnp.asarray(g1), args["levels"])
    rng = np.random.default_rng(seed)
    pts = rng.uniform([0, 0], [cam.width, cam.height], (N_SLOTS, 2))
    pts[:4] = [[0.5, 0.5], [cam.width - 1.5, 10.0], [20.0, cam.height - 1.2],
               [3.0, 3.0]]
    valid = np.ones(N_SLOTS, bool)
    valid[4:12] = False
    return pyr0, pyr1, jnp.asarray(pts, jnp.float32), jnp.asarray(valid)


def xla_roundtrip(pyr0, pyr1, pts, valid, args):
    """Round-trip distance of each slot on the XLA path (for the gate check)."""
    kw = {k: args[k] for k in ("win_h", "win_w", "iterations", "eps",
                               "coarse_win", "coarse_from_level")}
    levels, bwd = args["levels"], args["bwd_levels"]
    fwd, ok = optical_flow.lk_track(pyr0, pyr1, pts, valid, levels=levels, **kw)
    back, _ = optical_flow.lk_track(pyr1, pyr0, fwd, ok,
                                    levels=levels if bwd is None else bwd, **kw)
    return np.asarray(jnp.linalg.norm(pts - back, axis=-1))


def time_call(fn, reps):
    """Mean seconds per call of ``fn`` over ``reps`` back-to-back calls."""
    jax.block_until_ready(fn())
    t0 = time.perf_counter()
    for _ in range(reps):
        out = fn()
    jax.block_until_ready(out)
    return (time.perf_counter() - t0) / reps


def compare(reps: int = 0) -> dict:
    """Kernel and XLA path on the same inputs; with ``reps`` > 0 also the
    mean seconds per call of each, timed in turns (kernel, XLA, XLA, kernel)."""
    pyr0, pyr1, pts, valid = inputs()
    args = lk_args()

    def run(use_kernel):
        return optical_flow.track_forward_backward(
            pyr0, pyr1, pts, valid, use_kernel=use_kernel, **args)

    (pk, sk), (px, sx) = run(True), run(False)
    pk, sk, px, sx = map(np.asarray, (pk, sk, px, sx))
    both = sk & sx
    flips = np.flatnonzero(sk != sx)
    rt = xla_roundtrip(pyr0, pyr1, pts, valid, args)
    res = dict(
        n_accepted_kernel=int(sk.sum()), n_accepted_xla=int(sx.sum()),
        max_point_diff_px=float(np.abs(pk - px)[both].max(initial=0.0)),
        status_flips=flips.tolist(),
        flip_gate_distance_px=[float(abs(rt[i] - args["max_roundtrip_px"]))
                               for i in flips])
    if reps:
        t = {"kernel": [], "xla": []}
        for name in ("kernel", "xla", "xla", "kernel"):
            t[name].append(time_call(lambda: run(name == "kernel"), reps))
        res["kernel_s"] = float(np.mean(t["kernel"]))
        res["xla_s"] = float(np.mean(t["xla"]))
    return res


def check(res: dict):
    assert res["n_accepted_xla"] >= N_SLOTS // 2, res
    assert res["max_point_diff_px"] <= POINT_TOL_PX, res
    assert len(res["status_flips"]) <= MAX_STATUS_FLIPS, res
    assert all(d <= GATE_TOL_PX for d in res["flip_gate_distance_px"]), res

#!/usr/bin/env python
"""LK kernel against the XLA path end to end, on one GPU, in one process.

On the seeded 120-frame 640x480 room orbit of chip_smoke.py, each measured in
turns (kernel, XLA, XLA, kernel):

* ``engine.step`` with donated state at steady state: host ms per frame
  (frames 2..119 dispatched back to back, one final ``block_until_ready``),
  ``STEP_ROUNDS`` x 2 per implementation, and device us per frame (GPU events
  of a profiler trace of 8 steady frames);
* ``runner.run_frames`` with planes, BA every 8 frames and the pose graph
  (RunStats.fps: host work and BA included, the compile frame excluded; each
  implementation is warmed up by one untimed run first), ``SERVED_ROUNDS`` x 2
  per implementation, reported with median and quartiles;
* LK alone at the same widths (tests/lk_real_width.py), and the kernel with
  4 and 8 warps per program, ``WARPS_ROUNDS`` x 2 each.

The implementation is pinned while the engine step is traced, by binding
``use_kernel`` of ``optical_flow.track_forward_backward``; ``run_frames`` is
served by the pinned step in place of ``engine.step``.

Prints one JSON line.  Usage: python tools/lk_ab.py
"""

import contextlib
import functools
import json
import os
import sys
import tempfile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [REPO, os.path.join(REPO, "tests")]

import chip_smoke  # noqa: E402

ORDER = (True, False, False, True)   # kernel, XLA, XLA, kernel
STEP_ROUNDS = 3
SERVED_ROUNDS = 5
WARPS_ROUNDS = 5
NAME = {True: "kernel", False: "xla"}


def pinned_step(use_kernel: bool, **jit_kw):
    """``engine.step`` with LK pinned to one implementation."""
    import jax

    from rgbd_slam import engine
    from rgbd_slam.ops import optical_flow

    track, raw = optical_flow.track_forward_backward, engine.step.__wrapped__

    @functools.wraps(raw)
    def step(*args, **kw):
        optical_flow.track_forward_backward = functools.partial(
            track, use_kernel=use_kernel)
        try:
            return raw(*args, **kw)
        finally:
            optical_flow.track_forward_backward = track

    return jax.jit(step, static_argnames=("cam", "cfg", "with_planes",
                                          "with_lines"), **jit_kw)


@contextlib.contextmanager
def serving(step):
    """``run_frames`` calls ``step`` in place of ``engine.step``."""
    from rgbd_slam import engine

    saved = engine.step
    engine.step = step
    try:
        yield
    finally:
        engine.step = saved


def spread(xs):
    import numpy as np

    q1, med, q3 = np.percentile(xs, [25, 50, 75])
    return {"median": float(med), "q1": float(q1), "q3": float(q3)}


def kernel_by_warps(reps: int = 200):
    """Seconds per LK kernel call with 4 and with 8 warps per program."""
    import jax

    import lk_real_width
    from rgbd_slam.ops import lk_triton

    pyr0, pyr1, pts, valid = lk_real_width.inputs()
    raw = functools.partial(lk_triton.lk_forward_backward.__wrapped__,
                            **lk_real_width.lk_args())
    fns, kept = {}, lk_triton.NUM_WARPS
    try:
        for w in (4, 8):
            lk_triton.NUM_WARPS = w   # read while the kernel is traced
            fns[w] = jax.jit(raw)
            jax.block_until_ready(fns[w](pyr0, pyr1, pts, valid))
    finally:
        lk_triton.NUM_WARPS = kept
    t = {"4": [], "8": []}
    for _ in range(WARPS_ROUNDS):
        for w in (4, 8, 8, 4):
            t[str(w)].append(lk_real_width.time_call(
                lambda: fns[w](pyr0, pyr1, pts, valid), reps))
    return t


def main():
    import time

    import jax
    import numpy as np

    import lk_real_width
    from rgbd_slam import engine, profiling, runner
    from rgbd_slam.config import TUM_FR1, SlamConfig

    dev = profiling.require_gpu()
    card = profiling.gpu_card()
    cam, cfg = TUM_FR1, SlamConfig()
    frames, gt = chip_smoke.room_orbit(chip_smoke.N_FRAMES)
    donated = {k: pinned_step(k, donate_argnums=(0,)) for k in (True, False)}
    served_by = {k: pinned_step(k) for k in (True, False)}

    def warm(k):
        state = engine.init_state(cam, cfg)
        for g, d in frames[:2]:
            state, out = donated[k](state, g, d, cam, cfg)
        jax.block_until_ready(out)
        return state

    def step_ms(k):
        state = warm(k)
        t0 = time.perf_counter()
        for g, d in frames[2:]:
            state, out = donated[k](state, g, d, cam, cfg)
        jax.block_until_ready(out)
        return 1e3 * (time.perf_counter() - t0) / (len(frames) - 2)

    def device_us(k):
        state = warm(k)
        with tempfile.TemporaryDirectory() as trace_dir:
            with jax.profiler.trace(trace_dir):
                for g, d in frames[2:10]:
                    state, out = donated[k](state, g, d, cam, cfg)
                jax.block_until_ready(out)
            return sum(e[1] for e in profiling.gpu_events(trace_dir)) / 8e3

    def served(k):
        with serving(served_by[k]):
            _, traj, stats = runner.run_frames(frames, cam, cfg,
                                               with_planes=True, ba_every=8)
        ate = runner.evaluate_against_ground_truth(traj, gt)["ate_rmse_mm"]
        return stats.fps, ate, stats.lost_count

    res = {"card": card, "device_kind": dev.device_kind}
    for m in ("step_ms", "device_us_per_frame", "run_frames_fps", "ate_mm",
              "lost"):
        res[m] = {"kernel": [], "xla": []}
    for _ in range(STEP_ROUNDS):
        for k in ORDER:
            res["step_ms"][NAME[k]].append(step_ms(k))
    for k in ORDER[:2]:
        res["device_us_per_frame"][NAME[k]].append(device_us(k))
    for k in (True, False):
        served(k)   # warm-up: engine and BA solver compiles
    for _ in range(SERVED_ROUNDS):
        for k in ORDER:
            fps, ate, lost = served(k)
            res["run_frames_fps"][NAME[k]].append(fps)
            res["ate_mm"][NAME[k]].append(ate)
            res["lost"][NAME[k]].append(lost)

    lk = lk_real_width.compare(reps=100)
    res["lk_alone_ms"] = {"kernel": 1e3 * lk["kernel_s"],
                          "xla": 1e3 * lk["xla_s"]}
    res["lk_check"] = {k: lk[k] for k in ("max_point_diff_px", "status_flips",
                                          "n_accepted_kernel",
                                          "n_accepted_xla")}
    res["lk_kernel_ms_by_warps"] = {
        w: [1e3 * s for s in t] for w, t in kernel_by_warps().items()}
    res["spread"] = {m: {n: spread(v) for n, v in res[m].items()}
                     for m in ("step_ms", "run_frames_fps",
                               "lk_kernel_ms_by_warps")}
    res["mean"] = {m: {n: float(np.mean(v)) for n, v in res[m].items()}
                   for m in ("step_ms", "device_us_per_frame",
                             "run_frames_fps")}
    print(json.dumps(res))


if __name__ == "__main__":
    main()

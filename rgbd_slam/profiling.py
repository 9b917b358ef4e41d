"""Per-stage timing statistics and device profiling hooks.

Parity with the reference's hand-rolled wall-clock accounting (per-class
``_mean*Duration`` members dumped by ``show_statistics`` cascades,
rgbd_slam.cpp:325-347) plus ``jax.profiler`` trace capture
around any stage for real device timelines.
"""

from __future__ import annotations

import contextlib
import glob
import os
import subprocess
import time
from collections import defaultdict

import jax


class StageTimer:
    """Accumulates wall-clock per named stage; prints a percentage breakdown like
    the reference's show_statistics (rgbd_slam.cpp:325-347)."""

    def __init__(self):
        self.totals = defaultdict(float)
        self.counts = defaultdict(int)

    @contextlib.contextmanager
    def stage(self, name: str, block: bool = False):
        t0 = time.time()
        out = yield
        if block and out is not None:
            jax.block_until_ready(out)
        self.totals[name] += time.time() - t0
        self.counts[name] += 1

    def record(self, name: str, seconds: float):
        self.totals[name] += seconds
        self.counts[name] += 1

    def show_statistics(self, frame_count: int | None = None) -> str:
        """Formatted breakdown (reference: show_statistics cascades)."""
        total = sum(self.totals.values())
        lines = []
        if frame_count:
            lines.append(f"Mean frame treatment duration: "
                         f"{total / max(frame_count, 1) * 1000:.2f} ms "
                         f"over {frame_count} frames")
        for name, t in sorted(self.totals.items(), key=lambda kv: -kv[1]):
            pct = 100.0 * t / total if total > 0 else 0.0
            mean_ms = 1000.0 * t / max(self.counts[name], 1)
            lines.append(f"\t{name}: {mean_ms:.2f} ms mean ({pct:.1f}%)")
        return "\n".join(lines)


@contextlib.contextmanager
def device_trace(log_dir: str):
    """Capture a jax.profiler device trace around a block (device timeline; view
    with TensorBoard or xprof)."""
    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


def require_gpu():
    """The first JAX device, which must be a GPU: a measurement path that finds
    none fails instead of timing the CPU."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise RuntimeError(f"no GPU: JAX runs on {dev.platform!r}; device "
                           "times are measured on a GPU only")
    return dev


def gpu_card() -> str:
    """The card's name and power limit, as nvidia-smi reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True, text=True)
    return out.stdout.strip().splitlines()[0]


def gpu_events(trace_dir: str):
    """Device events of the newest ``jax.profiler`` trace under ``trace_dir``:
    a list of (name, duration_ns, stats) from the GPU device planes.  The
    stats carry ``hlo_op``, ``hlo_module`` and ``name``, the op's name-stack
    path (``jit(step)/jit(track_forward_backward)/...``)."""
    paths = sorted(glob.glob(os.path.join(trace_dir, "plugins", "profile",
                                          "*", "*.xplane.pb")))
    if not paths:
        raise RuntimeError(f"no profiler trace under {trace_dir}")
    data = jax.profiler.ProfileData.from_file(paths[-1])
    events = [(e.name, e.duration_ns, dict(e.stats))
              for plane in data.planes if plane.name.startswith("/device:GPU")
              for line in plane.lines for e in line.events]
    if not events:
        raise RuntimeError(f"the trace under {trace_dir} holds no GPU device "
                           "events")
    return events


def stage_of(name_path: str, step: str = "step") -> str:
    """Stage of a device op: the outermost jitted function nested inside the
    jitted ``step`` (``track_forward_backward`` for ``.../jit(step)/jit(
    track_forward_backward)/...``), the step itself for its own ops, else the
    innermost jitted function."""
    jits = [c[4:-1] for c in name_path.split("/") if c.startswith("jit(")]
    if step in jits:
        rest = jits[jits.index(step) + 1:]
        return rest[0] if rest else step
    return jits[-1] if jits else "?"

"""Line segment detection (LSD-equivalent capability).

The reference wraps the vendored LSD detector (src/features/lines/line_detection.cpp
+ third_party/line_segment_detector.cpp) but compiles it OUT of the main loop
(USE_LINE_DETECTION never defined, rgbd_slam.cpp:304-313) and has no line feature map
— lines never reach pose optimization (SURVEY.md §2.3).

LSD's per-pixel region growing is hostile to batch hardware, so this detector uses
the same machinery as the CAPE plane extractor one dimension down (SURVEY.md §7
"gradient-based line detector variant that batches"):

1. image gradients -> level-line orientation (double-angle representation so
   opposite-polarity edges merge, like LSD's level lines);
2. per-tile edge statistics: weighted 2D centroid/second-moments + orientation
   coherence (mean resultant length of the doubled angles);
3. directed mergeability edges between adjacent coherent tiles (orientation and
   perpendicular-offset gates) + masked label propagation from strong seeds —
   exactly the plane region-growing pattern;
4. merged segments from combined tile moments (Chan combination); endpoints from
   the projection extent along the principal direction.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..ops.image import gradients

MAX_LINES = 32
MAX_LINE_SEEDS = 16
TILE = 16


class DetectedLines(NamedTuple):
    p0: jnp.ndarray        # [MAX_LINES, 2] segment start (x, y) px
    p1: jnp.ndarray        # [MAX_LINES, 2] segment end
    direction: jnp.ndarray # [MAX_LINES, 2] unit direction
    strength: jnp.ndarray  # [MAX_LINES] accumulated gradient magnitude
    tile_count: jnp.ndarray  # [MAX_LINES]
    valid: jnp.ndarray     # [MAX_LINES] bool


class _TileGrid(NamedTuple):
    weight: jnp.ndarray    # [T] total gradient magnitude of edge pixels
    count: jnp.ndarray     # [T] edge pixel count
    mean: jnp.ndarray      # [T, 2] weighted centroid (x, y)
    m2: jnp.ndarray        # [T, 2, 2] weighted centered second moment
    cos2: jnp.ndarray      # [T] mean cos(2 theta) (magnitude-weighted)
    sin2: jnp.ndarray      # [T] mean sin(2 theta)
    coherence: jnp.ndarray # [T] mean resultant length in [0, 1]
    is_line: jnp.ndarray   # [T] bool


def _tile_stats(gray, mag_threshold: float, min_edge_frac: float,
                min_coherence: float):
    h, w = gray.shape
    gh, gw = h // TILE, w // TILE
    ix, iy = gradients(gray)
    mag = jnp.sqrt(ix * ix + iy * iy)
    # level-line orientation: edge direction is perpendicular to the gradient;
    # double angle so theta and theta+pi agree
    theta = jnp.arctan2(iy, ix) + jnp.pi / 2.0
    c2 = jnp.cos(2.0 * theta)
    s2 = jnp.sin(2.0 * theta)

    edge = mag > mag_threshold
    wgt = jnp.where(edge, mag, 0.0)

    ys = jax.lax.broadcasted_iota(gray.dtype, (h, w), 0)
    xs = jax.lax.broadcasted_iota(gray.dtype, (h, w), 1)

    def tiles_of(x):
        return x[: gh * TILE, : gw * TILE].reshape(gh, TILE, gw, TILE) \
            .transpose(0, 2, 1, 3).reshape(gh * gw, TILE * TILE)

    tw = tiles_of(wgt)
    tx = tiles_of(xs)
    ty = tiles_of(ys)
    tc2 = tiles_of(c2)
    ts2 = tiles_of(s2)

    weight = jnp.sum(tw, axis=-1)
    count = jnp.sum(tw > 0, axis=-1)
    safe_w = jnp.maximum(weight, 1e-9)
    mean_x = jnp.sum(tw * tx, axis=-1) / safe_w
    mean_y = jnp.sum(tw * ty, axis=-1) / safe_w
    dx = tx - mean_x[:, None]
    dy = ty - mean_y[:, None]
    m2 = jnp.stack([
        jnp.stack([jnp.sum(tw * dx * dx, -1), jnp.sum(tw * dx * dy, -1)], -1),
        jnp.stack([jnp.sum(tw * dx * dy, -1), jnp.sum(tw * dy * dy, -1)], -1),
    ], axis=-2)
    mc2 = jnp.sum(tw * tc2, axis=-1) / safe_w
    ms2 = jnp.sum(tw * ts2, axis=-1) / safe_w
    coherence = jnp.sqrt(mc2 * mc2 + ms2 * ms2)

    min_edges = int(TILE * TILE * min_edge_frac)
    is_line = (count >= min_edges) & (coherence > min_coherence)
    return _TileGrid(weight=weight, count=count,
                     mean=jnp.stack([mean_x, mean_y], -1), m2=m2,
                     cos2=mc2, sin2=ms2, coherence=coherence,
                     is_line=is_line), gh, gw


def _tile_direction(cos2, sin2):
    """Unit direction from the double-angle mean."""
    theta = 0.5 * jnp.arctan2(sin2, cos2)
    return jnp.stack([jnp.cos(theta), jnp.sin(theta)], axis=-1)


def _line_edge_maps(grid: _TileGrid, gh: int, gw: int, max_angle_cos: float,
                    max_offset_px: float):
    """Directed mergeability between 8-adjacent line tiles: orientations agree
    (double-angle dot) and the neighbor's centroid lies near this tile's line."""
    d = _tile_direction(grid.cos2, grid.sin2).reshape(gh, gw, 2)
    # normalize the double-angle vector: its raw magnitude is the coherence, which
    # would otherwise scale the orientation-agreement dot product
    norm = jnp.maximum(grid.coherence, 1e-9).reshape(gh, gw)
    c2 = grid.cos2.reshape(gh, gw) / norm
    s2 = grid.sin2.reshape(gh, gw) / norm
    cen = grid.mean.reshape(gh, gw, 2)
    ok = grid.is_line.reshape(gh, gw)

    shifts = [(0, 1), (0, -1), (1, 0), (-1, 0), (1, 1), (1, -1), (-1, 1), (-1, -1)]
    edges = []
    for dy, dx in shifts:
        c2f = jnp.roll(c2, (dy, dx), (0, 1))
        s2f = jnp.roll(s2, (dy, dx), (0, 1))
        df = jnp.roll(d, (dy, dx), (0, 1))
        cf = jnp.roll(cen, (dy, dx), (0, 1))
        okf = jnp.roll(ok, (dy, dx), (0, 1))
        # double-angle agreement
        agree = (c2f * c2 + s2f * s2) > max_angle_cos
        rel = cen - cf
        perp = jnp.abs(rel[..., 0] * (-df[..., 1]) + rel[..., 1] * df[..., 0])
        e = agree & (perp < max_offset_px) & ok & okf
        if dx == 1:
            e = e.at[:, 0].set(False)
        if dx == -1:
            e = e.at[:, -1].set(False)
        if dy == 1:
            e = e.at[0, :].set(False)
        if dy == -1:
            e = e.at[-1, :].set(False)
        edges.append(e)
    return jnp.stack(edges), shifts


def _propagate(seed_idx, edges, shifts, available, gh, gw):
    active0 = jnp.zeros((gh * gw,), bool).at[seed_idx].set(True).reshape(gh, gw)
    avail = available.reshape(gh, gw)

    def body(state):
        active, _ = state
        grow = jnp.zeros_like(active)
        for e, (dy, dx) in zip(edges, shifts):
            grow = grow | (jnp.roll(active, (dy, dx), (0, 1)) & e)
        new_active = active | (grow & avail)
        return new_active, jnp.any(new_active != active)

    active, _ = jax.lax.while_loop(lambda s: s[1], body,
                                   (active0, jnp.asarray(True)))
    return active.reshape(-1)


@partial(jax.jit, static_argnames=("mag_threshold", "min_edge_frac",
                                   "min_coherence", "min_tiles"))
def detect_lines(gray, mag_threshold: float = 15.0, min_edge_frac: float = 0.06,
                 min_coherence: float = 0.7, min_tiles: int = 2) -> DetectedLines:
    """Detect up to MAX_LINES line segments in a gray image."""
    import math

    grid, gh, gw = _tile_stats(gray, mag_threshold, min_edge_frac, min_coherence)
    # double-angle cos gate ~ 2x the angular tolerance (12.5 deg -> cos(25 deg))
    edges, shifts = _line_edge_maps(grid, gh, gw, math.cos(math.radians(25.0)),
                                    max_offset_px=6.0)

    def seed_step(carry, _):
        (available, l_p0, l_p1, l_dir, l_str, l_cnt, l_num) = carry
        seed_w = jnp.where(available & grid.is_line, grid.weight, -1.0)
        seed_idx = jnp.argmax(seed_w)
        proceed = seed_w[seed_idx] > 0

        active = _propagate(seed_idx, edges, shifts, available, gh, gw)
        active = active & grid.is_line & available
        n_tiles = jnp.sum(active)

        # combined weighted moments over member tiles (Chan combination)
        w = jnp.where(active, grid.weight, 0.0)
        tot = jnp.maximum(jnp.sum(w), 1e-9)
        mean = jnp.sum(grid.mean * w[:, None], axis=0) / tot
        dev = grid.mean - mean
        m2 = jnp.sum(jnp.where(active[:, None, None], grid.m2, 0.0), axis=0) \
            + jnp.einsum("t,ti,tj->ij", w, dev, dev)

        # principal direction of the 2x2 weighted scatter (closed form)
        a, b, c = m2[0, 0], m2[0, 1], m2[1, 1]
        ang = 0.5 * jnp.arctan2(2.0 * b, a - c)
        direction = jnp.stack([jnp.cos(ang), jnp.sin(ang)])

        # endpoints: projection extent of member tile centroids (+ half tile)
        proj = jnp.sum((grid.mean - mean) * direction[None, :], axis=-1)
        proj = jnp.where(active, proj, 0.0)
        lo = jnp.min(jnp.where(active, proj, jnp.inf)) - TILE / 2
        hi = jnp.max(jnp.where(active, proj, -jnp.inf)) + TILE / 2
        p0 = mean + lo * direction
        p1 = mean + hi * direction

        accept = proceed & (n_tiles >= min_tiles) & (l_num < MAX_LINES)
        slot = jnp.minimum(l_num, MAX_LINES - 1)
        l_p0 = jnp.where(accept, l_p0.at[slot].set(p0), l_p0)
        l_p1 = jnp.where(accept, l_p1.at[slot].set(p1), l_p1)
        l_dir = jnp.where(accept, l_dir.at[slot].set(direction), l_dir)
        l_str = jnp.where(accept, l_str.at[slot].set(tot), l_str)
        l_cnt = jnp.where(accept, l_cnt.at[slot].set(n_tiles), l_cnt)
        l_num = l_num + accept.astype(jnp.int32)

        consumed = jnp.where(proceed & (n_tiles >= min_tiles), active,
                             jnp.zeros_like(active).at[seed_idx].set(proceed))
        available = available & ~consumed
        return (available, l_p0, l_p1, l_dir, l_str, l_cnt, l_num), None

    dt = gray.dtype
    init = (grid.is_line,
            jnp.zeros((MAX_LINES, 2), dt), jnp.zeros((MAX_LINES, 2), dt),
            jnp.zeros((MAX_LINES, 2), dt), jnp.zeros((MAX_LINES,), dt),
            jnp.zeros((MAX_LINES,), jnp.int32), jnp.asarray(0, jnp.int32))
    (available, l_p0, l_p1, l_dir, l_str, l_cnt, l_num), _ = jax.lax.scan(
        seed_step, init, None, length=MAX_LINE_SEEDS)

    return DetectedLines(p0=l_p0, p1=l_p1, direction=l_dir, strength=l_str,
                         tile_count=l_cnt,
                         valid=jnp.arange(MAX_LINES) < l_num)

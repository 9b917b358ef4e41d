"""FAST-9/16 corner detection, fully vectorized.

The reference uses per-cell OpenCV FAST detectors with a two-tier threshold
(src/features/keypoints/keypoint_detection.cpp:48-65, 404-474).  Here the segment test
evaluates over the WHOLE image at once: 16 rolled copies of the image give the
Bresenham circle, boolean algebra finds 9-contiguous arcs, and non-maximum suppression
plus per-cell top-K budgeting replace the per-cell detector objects.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from .image import max_pool_same

# Bresenham circle of radius 3, 16 points, in (dy, dx) order starting at 12 o'clock
# going clockwise (OpenCV order).
CIRCLE_OFFSETS = (
    (-3, 0), (-3, 1), (-2, 2), (-1, 3), (0, 3), (1, 3), (2, 2), (3, 1),
    (3, 0), (3, -1), (2, -2), (1, -3), (0, -3), (-1, -3), (-2, -2), (-3, -1),
)

ARC_LENGTH = 9  # FAST-9


def _shifted_stack(img):
    """[16, H, W] stack of the circle-neighbor images (borders replicate; border
    responses are suppressed later)."""
    outs = []
    for dy, dx in CIRCLE_OFFSETS:
        outs.append(jnp.roll(img, (-dy, -dx), axis=(0, 1)))
    return jnp.stack(outs, axis=0)


def _pack_bits(bools):
    """[16, H, W] bool -> [H, W] uint32 bitmask (shifts + one reduce; a
    matmul formulation with M=1 has no work to batch)."""
    n = bools.shape[0]
    shifts = jnp.arange(n, dtype=jnp.uint32)[:, None, None]
    return jnp.sum(bools.astype(jnp.uint32) << shifts, axis=0)


def _arc9(bits):
    """True where the circular 16-bit mask contains a run of >= ARC_LENGTH=9
    contiguous set bits: doubling-AND run-length trick, O(log) ops instead of the
    16x9 boolean unroll."""
    x = bits | (bits << 16)          # unwrap the circle
    y = x & (x >> 1)                 # runs >= 2
    y = y & (y >> 2)                 # runs >= 4
    y = y & (y >> 4)                 # runs >= 8
    y = y & (x >> 8)                 # runs >= 9
    return (y & jnp.uint32(0xFFFF)) != 0


def _interior_mask(h, w):
    ys = jax.lax.broadcasted_iota(jnp.int32, (h, w), 0)
    xs = jax.lax.broadcasted_iota(jnp.int32, (h, w), 1)
    return (ys >= 3) & (ys < h - 3) & (xs >= 3) & (xs < w - 3)


def fast_response_2tier(img, threshold: float, low_threshold: float):
    """FAST-9/16 segment test + corner score at TWO thresholds sharing one
    circle-neighbor stack (the reference's normal + sensitive-fallback detector
    tiers, keypoint_detection.cpp:48-65).

    Returns (corner_hi, score_hi, corner_lo, score_lo)."""
    shifted = _shifted_stack(img)  # [16, H, W]
    diff = shifted - img[None]
    interior = _interior_mask(*img.shape)

    def tier(t):
        is_corner = (_arc9(_pack_bits(diff > t)) | _arc9(_pack_bits(diff < -t))) \
            & interior
        score = jnp.sum(jnp.maximum(jnp.abs(diff) - t, 0.0), axis=0)
        return is_corner, jnp.where(is_corner, score, 0.0)

    hi_c, hi_s = tier(threshold)
    lo_c, lo_s = tier(low_threshold)
    return hi_c, hi_s, lo_c, lo_s


def fast_response(img, threshold: float):
    """FAST-9/16 segment test + corner score over the whole image.

    Returns (is_corner [H, W] bool, score [H, W] float).  The score is the sum of
    absolute circle differences beyond the threshold (an NMS-ranking score, like
    OpenCV's ``FAST`` score semantics for ordering)."""
    c, s, _, _ = fast_response_2tier(img, threshold, threshold)
    return c, s


def _subpixel_refine(score, ys, xs):
    """Quadratic 1D fits on the score surface around each detected corner
    (replaces cv::cornerSubPix, keypoint_detection.cpp:100-105)."""
    h, w = score.shape
    flat = score.reshape(-1)

    def at(y, x):
        y = jnp.clip(y, 0, h - 1)
        x = jnp.clip(x, 0, w - 1)
        return flat[y * w + x]

    c = at(ys, xs)
    dx = at(ys, xs - 1) - 2 * c + at(ys, xs + 1)
    dy = at(ys - 1, xs) - 2 * c + at(ys + 1, xs)
    ox = jnp.where(jnp.abs(dx) > 1e-6,
                   0.5 * (at(ys, xs - 1) - at(ys, xs + 1)) / jnp.where(jnp.abs(dx) > 1e-6, dx, 1.0),
                   0.0)
    oy = jnp.where(jnp.abs(dy) > 1e-6,
                   0.5 * (at(ys - 1, xs) - at(ys + 1, xs)) / jnp.where(jnp.abs(dy) > 1e-6, dy, 1.0),
                   0.0)
    return (xs.astype(score.dtype) + jnp.clip(ox, -0.5, 0.5),
            ys.astype(score.dtype) + jnp.clip(oy, -0.5, 0.5))


@partial(jax.jit, static_argnames=("max_points", "cell_rows", "cell_cols"))
def detect_fast_grid(img, detection_mask=None, threshold: float = 20.0,
                     low_threshold: float = 10.0, max_points: int = 100,
                     cell_rows: int = 3, cell_cols: int = 3):
    """Grid-budgeted FAST detection (reference: perform_keypoint_detection,
    keypoint_detection.cpp:404-474 — a cell_rows x cell_cols grid of detectors with a
    more sensitive fallback tier, then a global point budget of ``max_points``).

    ``detection_mask`` (optional [H, W] bool) disables detection where False — the
    already-tracked-point mask (compute_key_point_mask, keypoint_detection.cpp:111-156).

    Returns (xy [max_points, 2] float, score [max_points], valid [max_points] bool)."""
    is_corner, score, is_corner_low, score_low = fast_response_2tier(
        img, threshold, low_threshold)

    if detection_mask is not None:
        is_corner = is_corner & detection_mask
        is_corner_low = is_corner_low & detection_mask

    def nms(corner, sc):
        sc = jnp.where(corner, sc, 0.0)
        pooled = max_pool_same(sc, 3)
        return jnp.where((sc >= pooled) & corner, sc, 0.0)

    nms_hi = nms(is_corner, score)
    nms_lo = nms(is_corner_low, score_low)

    h, w = img.shape
    n_cells = cell_rows * cell_cols
    per_cell = -(-max_points // n_cells)  # ceil budget per cell

    # pad to uniform cells and reshape to [n_cells, cell_pixels] — per-cell top-K
    # then runs as one lax.top_k instead of a full-image sort
    ph = -(-h // cell_rows) * cell_rows
    pw = -(-w // cell_cols) * cell_cols
    ch, cw = ph // cell_rows, pw // cell_cols

    def cells_of(x):
        xp = jnp.pad(x, ((0, ph - h), (0, pw - w)))
        return xp.reshape(cell_rows, ch, cell_cols, cw).transpose(0, 2, 1, 3) \
            .reshape(n_cells, ch * cw)

    hi_cells = cells_of(nms_hi)
    lo_cells = cells_of(nms_lo)

    # two-tier: use the sensitive tier only in cells where the high tier found
    # fewer than the cell budget (keypoint_detection.cpp:435-452)
    hi_counts = jnp.sum(hi_cells > 0, axis=-1)
    use_low = (hi_counts < per_cell)[:, None]
    merged_cells = jnp.where(hi_cells > 0, hi_cells,
                             jnp.where(use_low, lo_cells, 0.0))

    cell_vals, cell_idx = jax.lax.top_k(merged_cells, per_cell)

    # global top-max_points among the per-cell winners
    top_scores, top_pos = jax.lax.top_k(cell_vals.reshape(-1), max_points)
    cell_of_top = top_pos // per_cell
    within = cell_idx.reshape(-1)[top_pos]
    valid = top_scores > 0

    ys_sel = (cell_of_top // cell_cols) * ch + within // cw
    xs_sel = (cell_of_top % cell_cols) * cw + within % cw
    # subpixel refine on the raw (pre-NMS) response surface
    refine_img = jnp.where(score > 0, score, score_low)
    x_ref, y_ref = _subpixel_refine(refine_img, ys_sel, xs_sel)
    xy = jnp.stack([x_ref, y_ref], axis=-1)
    xy = jnp.where(valid[:, None], xy, 0.0)
    return xy, jnp.where(valid, top_scores, 0.0), valid


def tracked_points_mask(shape, tracked_xy, tracked_valid, radius: float = 15.0):
    """Detection mask disabling a square of half-size ``radius`` px around each
    tracked point (reference: compute_key_point_mask, keypoint_detection.cpp:111-156
    — the reference uses circles; the square approximation lets the dilation run as
    two separable max-pools instead of a per-point scan over the image).  Returns a
    [H, W] bool mask, True where detection is allowed."""
    h, w = shape
    xi = jnp.clip(jnp.round(tracked_xy[:, 0]).astype(jnp.int32), 0, w - 1)
    yi = jnp.clip(jnp.round(tracked_xy[:, 1]).astype(jnp.int32), 0, h - 1)
    flat = jnp.zeros((h * w,), dtype=jnp.float32)
    idx = jnp.where(tracked_valid, yi * w + xi, h * w)
    flat = flat.at[idx].set(1.0, mode="drop")
    seeds = flat.reshape(h, w)
    k = 2 * int(radius) + 1
    dil = jax.lax.reduce_window(seeds, -jnp.inf, jax.lax.max, (k, 1), (1, 1), "SAME")
    dil = jax.lax.reduce_window(dil, -jnp.inf, jax.lax.max, (1, k), (1, 1), "SAME")
    return dil < 0.5

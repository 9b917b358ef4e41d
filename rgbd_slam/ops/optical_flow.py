"""Pyramidal Lucas-Kanade optical flow with forward-backward validation.

Replaces cv::calcOpticalFlowPyrLK as used by the reference
(src/features/keypoints/keypoint_detection.cpp:262-361): window = image/12 x image/9
(~53x53 at 640x480), 4 pyramid levels, 10 iterations with eps 0.03, then a backward
track whose round-trip distance gates the match.

Two implementations with one semantics:

* the plain XLA path below: ALL points advance in lockstep — ``vmap`` over points,
  a static loop over pyramid levels, ``lax.fori_loop`` over LK iterations.  Window
  reads are contiguous ``dynamic_slice`` patches with a 4-tap bilinear blend
  instead of per-pixel gathers.
* :mod:`.lk_triton`, a Pallas kernel through Triton that tracks one point per
  program through every level, forward and backward, in one launch.

:func:`track_forward_backward` takes the kernel on a GPU and the XLA path
everywhere else.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from .image import in_border


def sample_window(img, top_left_xy, h: int, w: int):
    """Bilinear [h, w] window of ``img`` whose top-left corner is at the float
    position ``top_left_xy`` = (x, y).  One contiguous (h+1, w+1) dynamic_slice plus a
    4-tap blend; the corner is clamped into the image (callers gate border points)."""
    x0 = jnp.floor(top_left_xy[0])
    y0 = jnp.floor(top_left_xy[1])
    fx = (top_left_xy[0] - x0).astype(img.dtype)
    fy = (top_left_xy[1] - y0).astype(img.dtype)
    xi = jnp.clip(x0.astype(jnp.int32), 0, img.shape[1] - (w + 1))
    yi = jnp.clip(y0.astype(jnp.int32), 0, img.shape[0] - (h + 1))
    p = jax.lax.dynamic_slice(img, (yi, xi), (h + 1, w + 1))
    return ((1 - fy) * ((1 - fx) * p[:h, :w] + fx * p[:h, 1:w + 1])
            + fy * ((1 - fx) * p[1:h + 1, :w] + fx * p[1:h + 1, 1:w + 1]))


def level_windows(dims, win_h: int, win_w: int, coarse_win: int | None,
                  coarse_from_level: int):
    """Window (height, width) of every pyramid level with shape ``dims[lvl]``:
    ``coarse_win`` from ``coarse_from_level`` up, the full window below it,
    clamped to the level size (coarse levels can be tiny)."""
    wins = []
    for lvl, (lh, lw) in enumerate(dims):
        coarse = lvl >= coarse_from_level and coarse_win
        wins.append((min(coarse_win if coarse else win_h, lh - 3),
                     min(coarse_win if coarse else win_w, lw - 3)))
    return tuple(wins)


def _lk_level(prev_img, next_img, pt_prev, guess, win_h: int, win_w: int,
              iterations: int, eps: float):
    """Iterative LK at one pyramid level for a single point."""
    half = jnp.asarray([(win_w - 1) / 2.0, (win_h - 1) / 2.0], pt_prev.dtype)
    # clamp the window origin ONCE so the template and the moving (tl+g) windows
    # stay consistently aligned; sample_window's own clamp is only a backstop
    lh, lw = prev_img.shape
    tl = jnp.clip(pt_prev - half,
                  jnp.asarray([2.0, 2.0], pt_prev.dtype),
                  jnp.asarray([lw - win_w - 3.0, lh - win_h - 3.0], pt_prev.dtype))

    # template + gradients from one (win+2)-halo patch of the previous image
    tp = sample_window(prev_img, tl - 1.0, win_h + 2, win_w + 2)
    t = tp[1:-1, 1:-1]
    ix = 0.5 * (tp[1:-1, 2:] - tp[1:-1, :-2])
    iy = 0.5 * (tp[2:, 1:-1] - tp[:-2, 1:-1])

    gxx = jnp.sum(ix * ix)
    gxy = jnp.sum(ix * iy)
    gyy = jnp.sum(iy * iy)
    det = gxx * gyy - gxy * gxy
    ok = det > 1e-6
    inv_det = jnp.where(ok, 1.0 / jnp.where(ok, det, 1.0), 0.0)

    def body(_, carry):
        g, done = carry
        j = sample_window(next_img, tl + g, win_h, win_w)
        diff = t - j
        bx = jnp.sum(ix * diff)
        by = jnp.sum(iy * diff)
        dx = (gyy * bx - gxy * by) * inv_det
        dy = (gxx * by - gxy * bx) * inv_det
        step = jnp.stack([dx, dy])
        new_g = jnp.where(done, g, g + step)
        done = done | (jnp.sum(step * step) < eps * eps)
        return new_g, done

    guess, _ = jax.lax.fori_loop(0, iterations, body,
                                 (guess, jnp.logical_not(ok)))
    return guess, ok


@partial(jax.jit, static_argnames=("levels", "win_h", "win_w", "iterations",
                                   "coarse_win", "coarse_from_level"))
def lk_track(prev_pyramid, next_pyramid, points, points_valid,
             levels: int = 4, win_h: int = 53, win_w: int = 53,
             iterations: int = 10, eps: float = 0.03,
             coarse_win: int | None = None,
             coarse_from_level: int = 1):
    """Track ``points`` [N, 2] from the previous to the next image (XLA path).

    ``prev_pyramid``/``next_pyramid`` are lists from :func:`build_pyramid` (length
    >= levels+1).  Returns (new_points [N, 2], status [N] bool)."""
    wins = level_windows([p.shape for p in prev_pyramid[:levels + 1]],
                         win_h, win_w, coarse_win, coarse_from_level)

    def track_one(pt, valid):
        g = jnp.zeros(2, dtype=pt.dtype)
        ok_all = valid
        for lvl in range(levels, -1, -1):
            pt_l = pt * (0.5 ** lvl)
            wh, ww = wins[lvl]
            g, ok = _lk_level(prev_pyramid[lvl], next_pyramid[lvl], pt_l, g,
                              wh, ww, iterations, eps)
            # cv parity: only the finest level's structure tensor sets status
            # (a flat coarse window skips refinement via inv_det = 0 instead)
            if lvl == 0:
                ok_all = ok_all & ok
            if lvl > 0:
                g = g * 2.0
        new_pt = pt + g
        h, w = prev_pyramid[0].shape
        status = ok_all & in_border(new_pt, h, w, margin=1.0) \
            & jnp.all(jnp.isfinite(new_pt))
        return jnp.where(status, new_pt, pt), status

    return jax.vmap(track_one)(points, points_valid)


def kernel_is_default() -> bool:
    """The LK kernel is the implementation on a GPU; the XLA path elsewhere."""
    return jax.default_backend() == "gpu"


@partial(jax.jit, static_argnames=("max_roundtrip_px", "levels", "win_h",
                                   "win_w", "iterations", "use_kernel",
                                   "bwd_levels", "coarse_win", "eps",
                                   "coarse_from_level"))
def track_forward_backward(prev_pyramid, next_pyramid, points, points_valid,
                           max_roundtrip_px: float = 30.0,
                           levels: int = 4, win_h: int = 53, win_w: int = 53,
                           iterations: int = 10,
                           use_kernel: bool | None = None,
                           bwd_levels: int | None = None,
                           coarse_win: int | None = None,
                           eps: float = 0.03,
                           coarse_from_level: int = 1):
    """Forward LK + backward validation (reference: get_keypoints_from_optical_flow,
    keypoint_detection.cpp:262-361): forward track, border filter, backward track,
    reject when the round trip exceeds ``max_roundtrip_px`` (matchSearchRadius).

    ``bwd_levels`` < ``levels`` runs the backward track zero-seeded from that
    pyramid level down (see ``DetectionConfig.optical_flow_backward_depth``).
    ``use_kernel`` picks the implementation; None takes the kernel on a GPU and
    the XLA path elsewhere, and True without a GPU raises.

    Returns (tracked_points [N, 2], status [N] bool) — surviving points keep their
    index, i.e. their map id ("low cost feature association")."""
    if use_kernel is None:
        use_kernel = kernel_is_default()
    kw = dict(win_h=win_h, win_w=win_w, iterations=iterations,
              coarse_win=coarse_win, eps=eps,
              coarse_from_level=coarse_from_level)
    if use_kernel:
        from .lk_triton import lk_forward_backward

        return lk_forward_backward(prev_pyramid, next_pyramid, points,
                                   points_valid,
                                   max_roundtrip_px=max_roundtrip_px,
                                   levels=levels, bwd_levels=bwd_levels, **kw)

    fwd, fwd_ok = lk_track(prev_pyramid, next_pyramid, points, points_valid,
                           levels=levels, **kw)
    if bwd_levels is None or bwd_levels >= levels:
        bwd_levels = levels
    bwd, bwd_ok = lk_track(next_pyramid, prev_pyramid, fwd, fwd_ok,
                           levels=bwd_levels, **kw)
    roundtrip = jnp.linalg.norm(points - bwd, axis=-1)
    status = fwd_ok & bwd_ok & (roundtrip <= max_roundtrip_px)
    return jnp.where(status[:, None], fwd, points), status

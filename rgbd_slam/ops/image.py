"""Core image operations: blur, pyramids, gradients, bilinear sampling.

These are the building blocks of the feature-extraction front end (the reference
delegates them to OpenCV: buildOpticalFlowPyramid, boxFilter inside BRIEF, etc.).
Everything is pure jnp on [H, W] float32 images — XLA fuses the stencils.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

_GAUSS_5 = jnp.array([1.0, 4.0, 6.0, 4.0, 1.0]) / 16.0


def _sep_filter(img, kernel):
    """Separable 2D filter with edge replication, [H, W] -> [H, W].

    K shifted adds rather than lax.conv: a single-channel NCHW conv gives a
    convolution unit nothing to batch, and the adds fuse into one pass."""
    k = kernel.astype(img.dtype)
    r = k.shape[0] // 2
    padded = jnp.pad(img, ((r, r), (0, 0)), mode="edge")
    out = jnp.zeros_like(img)
    for i in range(k.shape[0]):
        out = out + k[i] * jax.lax.dynamic_slice_in_dim(padded, i, img.shape[0], 0)
    padded = jnp.pad(out, ((0, 0), (r, r)), mode="edge")
    out2 = jnp.zeros_like(img)
    for i in range(k.shape[0]):
        out2 = out2 + k[i] * jax.lax.dynamic_slice_in_dim(padded, i, img.shape[1], 1)
    return out2


def gaussian_blur5(img):
    """5-tap binomial blur (the pyrDown kernel)."""
    return _sep_filter(img, _GAUSS_5)


def box_filter(img, size: int):
    """Box sum filter of odd ``size`` (the BRIEF pre-smoothing; OpenCV BRIEF uses a
    9x9 box sum via integral images).  Two separable add-reduce windows."""
    r = size // 2
    padded = jnp.pad(img, ((r, r), (r, r)), mode="edge")
    out = jax.lax.reduce_window(padded, jnp.zeros((), img.dtype), jax.lax.add,
                                (size, 1), (1, 1), "VALID")
    return jax.lax.reduce_window(out, jnp.zeros((), img.dtype), jax.lax.add,
                                 (1, size), (1, 1), "VALID")


def _decim_matrix(w: int):
    """[w, ceil(w/2)] matrix fusing the horizontal 5-tap binomial blur with 2x
    column decimation (edge-replicated taps), so the decimation needs no
    strided ``[::2]`` slice along the minor dimension."""
    import numpy as np

    k = np.array([1.0, 4.0, 6.0, 4.0, 1.0], np.float64) / 16.0
    wo = (w + 1) // 2
    d = np.zeros((w, wo), np.float32)
    for jj in range(wo):
        for t in range(5):
            j = min(max(2 * jj + t - 2, 0), w - 1)
            d[j, jj] += k[t]
    return d


def pyr_down(img):
    """Gaussian blur + 2x decimation (cv::pyrDown equivalent).

    Vertical pass: 5 shifted adds + even-row extraction via a contiguous
    reshape slice.  Horizontal pass: blur and decimation fused into one banded
    matmul."""
    h, w = img.shape
    k = _GAUSS_5.astype(img.dtype)
    r = 2
    padded = jnp.pad(img, ((r, r), (0, 0)), mode="edge")
    v = jnp.zeros_like(img)
    for i in range(5):
        v = v + k[i] * jax.lax.dynamic_slice_in_dim(padded, i, h, 0)
    if h % 2:
        v = jnp.concatenate([v, v[-1:]], axis=0)
    ho = (h + 1) // 2
    v_even = v.reshape(ho, 2 * w)[:, :w]  # rows 0, 2, ... as a contiguous slice
    d = jnp.asarray(_decim_matrix(w), img.dtype)
    return v_even @ d


def build_pyramid(img, levels: int):
    """Image pyramid [level0=full ... levelN] (reference: buildOpticalFlowPyramid,
    keypoint_detection.cpp:184)."""
    pyr = [img]
    for _ in range(levels):
        pyr.append(pyr_down(pyr[-1]))
    return pyr


def gradients(img):
    """Central-difference gradients (Ix, Iy) with replicated edges."""
    ix = 0.5 * (jnp.roll(img, -1, axis=1) - jnp.roll(img, 1, axis=1))
    iy = 0.5 * (jnp.roll(img, -1, axis=0) - jnp.roll(img, 1, axis=0))
    # kill wrap-around at borders
    ix = ix.at[:, 0].set(0.0).at[:, -1].set(0.0)
    iy = iy.at[0, :].set(0.0).at[-1, :].set(0.0)
    return ix, iy


def bilinear_sample(img, xy):
    """Bilinear interpolation of [H, W] image at float (x, y) positions [..., 2].
    Coordinates are clipped to the valid range (border replication)."""
    h, w = img.shape
    x = jnp.clip(xy[..., 0], 0.0, w - 1.000001)
    y = jnp.clip(xy[..., 1], 0.0, h - 1.000001)
    x0 = jnp.floor(x).astype(jnp.int32)
    y0 = jnp.floor(y).astype(jnp.int32)
    x1 = jnp.minimum(x0 + 1, w - 1)
    y1 = jnp.minimum(y0 + 1, h - 1)
    fx = x - x0.astype(img.dtype)
    fy = y - y0.astype(img.dtype)

    flat = img.reshape(-1)
    def at(yi, xi):
        return flat[yi * w + xi]

    v00 = at(y0, x0)
    v01 = at(y0, x1)
    v10 = at(y1, x0)
    v11 = at(y1, x1)
    return ((1 - fy) * ((1 - fx) * v00 + fx * v01)
            + fy * ((1 - fx) * v10 + fx * v11))


def in_border(xy, h: int, w: int, margin: float = 1.0):
    """Strict in-image test with margin (reference: is_in_border,
    keypoint_detection.cpp)."""
    return ((xy[..., 0] >= margin) & (xy[..., 0] < w - margin)
            & (xy[..., 1] >= margin) & (xy[..., 1] < h - margin))


@partial(jax.jit, static_argnames=("window",))
def max_pool_same(img, window: int = 3):
    """Max pool with 'same' padding for non-maximum suppression."""
    return jax.lax.reduce_window(
        img, -jnp.inf, jax.lax.max, (window, window), (1, 1), "SAME")

"""BRIEF-256 binary descriptors, batched over keypoints.

The reference uses OpenCV's BriefDescriptorExtractor (32-byte descriptors of
integer-offset point-pair tests on a box-smoothed image around the integer-rounded
keypoint; src/features/keypoints/keypoint_detection.cpp:67,236).  Design: each
keypoint's 32x32 patch is one vmapped ``dynamic_slice`` (a block gather), and ALL
256 point-pair tests evaluate as a single [N, 1024] @ [1024, 512] one-hot matmul —
no scalar gathers anywhere.  Descriptors are [N, 8] uint32 whose Hamming
distances use ``lax.population_count`` on the XOR matrix.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from .image import box_filter

PATCH_SIZE = 31
_PATCH = 32  # lane-friendly patch edge; offsets land in [0, 30]
N_BITS = 256
N_WORDS = N_BITS // 32


def _make_pattern(seed: int = 12345):
    """Deterministic BRIEF sampling pattern: isotropic Gaussian pairs with
    sigma = patch/5, rounded to integer offsets and clamped to the patch (BRIEF
    paper G II layout; OpenCV's fixed pattern is integer-offset too)."""
    rng = np.random.default_rng(seed)
    sigma = PATCH_SIZE / 5.0
    half = PATCH_SIZE // 2
    a = np.rint(np.clip(rng.normal(0.0, sigma, (N_BITS, 2)), -half, half))
    b = np.rint(np.clip(rng.normal(0.0, sigma, (N_BITS, 2)), -half, half))
    return a.astype(np.int32), b.astype(np.int32)

_PATTERN_A, _PATTERN_B = _make_pattern()


def _pattern_matrix():
    """[1024, 512] one-hot matrix: column j < 256 selects pattern-A point j,
    column 256+j selects pattern-B point j, from the flattened 32x32 patch whose
    center pixel sits at local (15, 15)."""
    half = PATCH_SIZE // 2
    m = np.zeros((_PATCH * _PATCH, 2 * N_BITS), np.float32)
    for j, (dx, dy) in enumerate(_PATTERN_A):
        m[(dy + half) * _PATCH + (dx + half), j] = 1.0
    for j, (dx, dy) in enumerate(_PATTERN_B):
        m[(dy + half) * _PATCH + (dx + half), N_BITS + j] = 1.0
    return m

_PATTERN_MATRIX = _pattern_matrix()


@partial(jax.jit, static_argnames=())
def compute_brief(img, xy, valid):
    """Descriptors for keypoints ``xy`` [N, 2] on image [H, W].

    Returns (descriptors [N, 8] uint32, desc_valid [N] bool) — points whose patch
    leaves the image are invalidated (OpenCV removes them,
    keypoint_detection.cpp:232-240)."""
    h, w = img.shape
    n = xy.shape[0]
    smoothed = box_filter(img, 9)

    half = PATCH_SIZE // 2
    ci = jnp.rint(xy).astype(jnp.int32)
    corner_x = jnp.clip(ci[:, 0] - half, 0, w - _PATCH)
    corner_y = jnp.clip(ci[:, 1] - half, 0, h - _PATCH)
    patches = jax.vmap(
        lambda cy, cx: jax.lax.dynamic_slice(smoothed, (cy, cx),
                                             (_PATCH, _PATCH)))(corner_y, corner_x)
    vals = patches.reshape(n, _PATCH * _PATCH) @ jnp.asarray(
        _PATTERN_MATRIX, img.dtype)                       # [N, 512]
    bits = vals[:, :N_BITS] < vals[:, N_BITS:]            # [N, 256]

    # pack 256 bits into 8 uint32 words
    bits_u = bits.astype(jnp.uint32).reshape(n, N_WORDS, 32)
    shifts = jnp.arange(32, dtype=jnp.uint32)
    desc = jnp.sum(bits_u << shifts[None, None, :], axis=-1).astype(jnp.uint32)

    inside = ((xy[:, 0] >= half) & (xy[:, 0] < w - half)
              & (xy[:, 1] >= half) & (xy[:, 1] < h - half))
    return desc, valid & inside


def hamming_distance_matrix(desc_a, desc_b):
    """Pairwise Hamming distances [A, B] between uint32-packed descriptor sets
    [A, 8] and [B, 8] (replaces the reference's BFMatcher Hamming kNN,
    src/features/keypoints/keypoint_handler.cpp:234-282)."""
    x = jnp.bitwise_xor(desc_a[:, None, :], desc_b[None, :, :])
    return jnp.sum(jax.lax.population_count(x), axis=-1).astype(jnp.int32)

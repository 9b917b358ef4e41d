"""Forward-backward pyramidal Lucas-Kanade as one Pallas kernel through Triton.

Same semantics as the XLA path of :func:`.optical_flow.track_forward_backward`;
only the order of the window sums differs.  One program tracks one point
(``grid=(N,)``; the default 128 tracked slots are one wave on an H100's 132 SMs):
it walks every pyramid level coarse to fine, then the zero-seeded backward track
and the round-trip gate, in a single launch per frame.

* A window is one power-of-two block (64 x 64 holds the 53-pixel window plus its
  gradient halo and bilinear tap), read by masked loads at dynamic offsets
  straight from the level images in global memory.  Both pyramids of a 640x480
  frame are ~2.5 MB, so the reads hit L2.
* Triton cannot slice a register tile, so the four bilinear taps and the
  central-difference gradients are shifted loads: the template patch needs 12
  distinct integer shifts, each moving window 4.
* The template and its gradients stay in registers across the iterations, and
  each point leaves its iteration loop as soon as its step drops below ``eps``.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from .optical_flow import kernel_is_default, level_windows

# template-patch shifts (dy, dx) read to build t, ix and iy: the bilinear taps
# {0,1}^2 of the centre (1,1) and of its four neighbours (1,0) (1,2) (0,1) (2,1)
_TEMPLATE_SHIFTS = tuple(sorted({(ay + ty, ax + tx)
                                 for ay, ax in ((1, 1), (1, 0), (1, 2),
                                                (0, 1), (2, 1))
                                 for ty in (0, 1) for tx in (0, 1)}))
# warps per program; tools/lk_ab.py times 4 against 8 in turns (PERF.md)
NUM_WARPS = 8


def _blend(p00, p01, p10, p11, fx, fy):
    # the XLA path's sample_window expression, term for term
    return ((1 - fy) * ((1 - fx) * p00 + fx * p01)
            + fy * ((1 - fx) * p10 + fx * p11))


def _origin(x, hi: int):
    """(clamped integer corner, fraction) of a float window origin, as
    sample_window computes them.  The float is clamped before the int cast so
    that no out-of-range or non-finite value is converted; a non-finite origin
    still yields a non-finite fraction."""
    x0 = jnp.floor(x)
    safe = jnp.where(jnp.isfinite(x0), x0, 0.0)
    return jnp.clip(safe, 0.0, float(hi)).astype(jnp.int32), x - x0


def _track(src, dst, px, py, valid, *, top: int, dims, wins, block: int,
           iterations: int, eps: float):
    """Coarse-to-fine LK of one point from ``src`` to ``dst`` (level refs),
    zero-seeded at level ``top``.  Returns the level-0 flow and the finest
    level's structure-tensor test."""
    rows = jax.lax.broadcasted_iota(jnp.int32, (block, block), 0)
    cols = jax.lax.broadcasted_iota(jnp.int32, (block, block), 1)
    gx = gy = jnp.float32(0.0)
    ok0 = jnp.bool_(False)
    for lvl in range(top, -1, -1):
        (lh, lw), (wh, ww) = dims[lvl], wins[lvl]
        in_win = (rows < wh) & (cols < ww)
        scale = 0.5 ** lvl
        tlx = jnp.clip(px * scale - (ww - 1) / 2.0, 2.0, lw - ww - 3.0)
        tly = jnp.clip(py * scale - (wh - 1) / 2.0, 2.0, lh - wh - 3.0)

        def taps(ref, yi, xi, shifts):
            return {(dy, dx): plgpu.load(
                ref.at[pl.ds(yi + dy, block), pl.ds(xi + dx, block)],
                mask=in_win, other=0.0) for dy, dx in shifts}

        # template patch of (wh+2, ww+2) with its corner at tl - 1
        xt, fxt = _origin(tlx - 1.0, lw - (ww + 3))
        yt, fyt = _origin(tly - 1.0, lh - (wh + 3))
        tap = taps(src[lvl], yt, xt, _TEMPLATE_SHIFTS)

        def patch(ay, ax):
            return _blend(tap[ay, ax], tap[ay, ax + 1], tap[ay + 1, ax],
                          tap[ay + 1, ax + 1], fxt, fyt)

        t = patch(1, 1)
        ix = 0.5 * (patch(1, 2) - patch(1, 0))
        iy = 0.5 * (patch(2, 1) - patch(0, 1))
        gxx = jnp.sum(ix * ix)
        gxy = jnp.sum(ix * iy)
        gyy = jnp.sum(iy * iy)
        det = gxx * gyy - gxy * gxy
        lvl_ok = det > 1e-6
        if lvl == 0:  # cv parity: only the finest level sets status
            ok0 = lvl_ok
        inv_det = jnp.where(lvl_ok, 1.0 / jnp.where(lvl_ok, det, 1.0), 0.0)

        def body(carry, tlx=tlx, tly=tly, t=t, ix=ix, iy=iy, gxx=gxx, gxy=gxy,
                 gyy=gyy, inv_det=inv_det, dref=dst[lvl], taps=taps, lh=lh,
                 lw=lw, wh=wh, ww=ww):
            it, cgx, cgy, _ = carry
            xj, fx = _origin(tlx + cgx, lw - (ww + 1))
            yj, fy = _origin(tly + cgy, lh - (wh + 1))
            j = taps(dref, yj, xj, ((0, 0), (0, 1), (1, 0), (1, 1)))
            diff = t - _blend(j[0, 0], j[0, 1], j[1, 0], j[1, 1], fx, fy)
            bx = jnp.sum(ix * diff)
            by = jnp.sum(iy * diff)
            dx = (gyy * bx - gxy * by) * inv_det
            dy = (gxx * by - gxy * bx) * inv_det
            return it + 1, cgx + dx, cgy + dy, dx * dx + dy * dy < eps * eps

        _, gx, gy, _ = jax.lax.while_loop(
            lambda c: (c[0] < iterations) & jnp.logical_not(c[3]), body,
            (jnp.int32(0), gx, gy, jnp.logical_not(lvl_ok & valid)))
        if lvl > 0:
            gx, gy = gx * 2.0, gy * 2.0
    return gx, gy, ok0


def _status(x, y, ok, h: int, w: int):
    # ops.image.in_border(margin=1) and finiteness, on scalars
    return (ok & (x >= 1.0) & (x < w - 1.0) & (y >= 1.0) & (y < h - 1.0)
            & jnp.isfinite(x) & jnp.isfinite(y))


def _kernel(px_ref, py_ref, valid_ref, *refs, levels: int, bwd_levels: int,
            dims, wins, block: int, iterations: int, eps: float,
            max_roundtrip: float):
    prev, nxt = refs[:levels + 1], refs[levels + 1:2 * levels + 2]
    ox_ref, oy_ref, ok_ref = refs[2 * levels + 2:]
    i = pl.program_id(0)
    px, py = px_ref[i], py_ref[i]
    valid = valid_ref[i] != 0
    h, w = dims[0]
    kw = dict(dims=dims, wins=wins, block=block, iterations=iterations,
              eps=eps)

    gx, gy, ok = _track(prev, nxt, px, py, valid, top=levels, **kw)
    fx, fy = px + gx, py + gy
    fwd_ok = _status(fx, fy, valid & ok, h, w)
    fx, fy = jnp.where(fwd_ok, fx, px), jnp.where(fwd_ok, fy, py)

    gx, gy, ok = _track(nxt, prev, fx, fy, fwd_ok, top=bwd_levels, **kw)
    bx, by = fx + gx, fy + gy
    bwd_ok = _status(bx, by, fwd_ok & ok, h, w)
    bx, by = jnp.where(bwd_ok, bx, fx), jnp.where(bwd_ok, by, fy)

    roundtrip = jnp.sqrt((px - bx) * (px - bx) + (py - by) * (py - by))
    status = fwd_ok & bwd_ok & (roundtrip <= max_roundtrip)
    ox_ref[i] = jnp.where(status, fx, px)
    oy_ref[i] = jnp.where(status, fy, py)
    ok_ref[i] = status.astype(jnp.int32)


@partial(jax.jit, static_argnames=("max_roundtrip_px", "levels", "win_h",
                                   "win_w", "iterations", "eps", "bwd_levels",
                                   "coarse_win", "coarse_from_level",
                                   "interpret"))
def lk_forward_backward(prev_pyramid, next_pyramid, points, points_valid, *,
                        max_roundtrip_px: float = 30.0, levels: int = 4,
                        win_h: int = 53, win_w: int = 53, iterations: int = 10,
                        eps: float = 0.03, bwd_levels: int | None = None,
                        coarse_win: int | None = None,
                        coarse_from_level: int = 1, interpret: bool = False):
    """Forward LK, backward validation and round-trip gate in one kernel.

    Arguments and result as :func:`.optical_flow.track_forward_backward`.
    Compiles for a GPU only; ``interpret=True`` runs the same kernel body on
    any backend (for tests)."""
    if not interpret and not kernel_is_default():
        raise RuntimeError(
            "the LK kernel compiles for a GPU only; this backend is "
            f"{jax.default_backend()!r} (pass interpret=True to run it anyway)")
    if bwd_levels is None or bwd_levels >= levels:
        bwd_levels = levels
    prev = [jnp.asarray(p, jnp.float32) for p in prev_pyramid[:levels + 1]]
    nxt = [jnp.asarray(p, jnp.float32) for p in next_pyramid[:levels + 1]]
    dims = tuple(p.shape for p in prev)
    wins = level_windows(dims, win_h, win_w, coarse_win, coarse_from_level)
    # one block holds a window, its gradient halo and its bilinear tap
    block = pl.next_power_of_2(max(max(wh, ww) for wh, ww in wins) + 3)
    n = points.shape[0]
    f32 = jax.ShapeDtypeStruct((n,), jnp.float32)
    ox, oy, ok = pl.pallas_call(
        partial(_kernel, levels=levels, bwd_levels=bwd_levels, dims=dims,
                wins=wins, block=block, iterations=iterations, eps=eps,
                max_roundtrip=float(max_roundtrip_px)),
        out_shape=(f32, f32, jax.ShapeDtypeStruct((n,), jnp.int32)),
        grid=(n,),
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=NUM_WARPS,
                                             num_stages=1),
        interpret=interpret,
        name="lk_forward_backward",
    )(points[:, 0].astype(jnp.float32), points[:, 1].astype(jnp.float32),
      points_valid.astype(jnp.int32), *prev, *nxt)
    return jnp.stack([ox, oy], axis=-1).astype(points.dtype), ok != 0

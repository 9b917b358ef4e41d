"""The Triton LK kernel (ops/lk_triton.py) against the XLA path it replaces on a
GPU: same semantics, only the order of the window sums differs.

On the CPU the kernel body runs in Pallas interpret mode on small images; the
``gpu``-marked cases compile it for the card.  The choice of implementation,
the per-level window rule and the Triton lowering at the engine's real widths
are checked here too.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax import export

from rgbd_slam.ops import image, lk_triton, optical_flow

H, W, LEVELS = 72, 96, 3
BASE = dict(max_roundtrip_px=1.0, levels=LEVELS, win_h=15, win_w=13,
            iterations=10, eps=0.03, bwd_levels=None, coarse_win=None,
            coarse_from_level=1)
# float32 with the sums in another order: points agree to ~1e-5 px here
POINT_TOL_PX = 1e-3


def textured(rng, h=H, w=W):
    base = rng.uniform(0, 255, size=(h // 8, w // 8)).astype(np.float32)
    return np.asarray(jax.image.resize(jnp.asarray(base), (h, w), "cubic"))


def case_inputs(name, rng):
    """(pyr0, pyr1, points, valid, lk kwargs, shift (dy, dx) or None)."""
    img = textured(rng)
    shift = (2, -3)
    pts = rng.uniform([12, 12], [W - 12, H - 12], (8, 2))
    valid = np.ones(8, bool)
    kw = dict(BASE)
    if name == "flat":
        img = np.full((H, W), 90.0, np.float32)
    elif name == "border":
        pts[:4] = [[0.2, 30.0], [W - 1.5, 20.0], [40.0, 0.6], [50.0, H - 1.1]]
    elif name == "invalid":
        valid[::2] = False
    elif name == "coarse_win":
        kw.update(coarse_win=7, coarse_from_level=1)
    elif name == "coarse_from_level_2":
        kw.update(coarse_win=9, coarse_from_level=2)
    elif name == "bwd_levels_0":
        kw.update(bwd_levels=0, max_roundtrip_px=3.0)
    img2 = np.roll(img, shift, axis=(0, 1))
    pyr0 = image.build_pyramid(jnp.asarray(img), LEVELS)
    pyr1 = image.build_pyramid(jnp.asarray(img2), LEVELS)
    return (pyr0, pyr1, jnp.asarray(pts, jnp.float32), jnp.asarray(valid), kw,
            None if name == "flat" else shift)


CASES = ["translation", "flat", "border", "invalid", "coarse_win",
         "coarse_from_level_2", "bwd_levels_0"]


@pytest.mark.parametrize("mode", ["interpret",
                                  pytest.param("gpu", marks=pytest.mark.gpu)])
@pytest.mark.parametrize("name", CASES)
def test_kernel_matches_xla(name, mode, rng, request):
    if mode == "gpu":
        request.getfixturevalue("gpu")
    pyr0, pyr1, pts, valid, kw, shift = case_inputs(name, rng)
    want, want_ok = optical_flow.track_forward_backward(
        pyr0, pyr1, pts, valid, use_kernel=False, **kw)
    got, got_ok = lk_triton.lk_forward_backward(
        pyr0, pyr1, pts, valid, interpret=mode == "interpret", **kw)
    want, want_ok, got, got_ok = map(np.asarray, (want, want_ok, got, got_ok))

    np.testing.assert_array_equal(got_ok, want_ok)
    np.testing.assert_allclose(got, want, atol=POINT_TOL_PX)
    # rejected slots keep their input position
    np.testing.assert_array_equal(got[~got_ok], np.asarray(pts)[~got_ok])
    if name == "flat":
        assert not got_ok.any()
    elif name == "border":
        assert not got_ok[:4].any() and got_ok[4:].sum() >= 3
    elif name == "invalid":
        assert not got_ok[::2].any() and got_ok[1::2].sum() >= 3
    else:
        assert got_ok.sum() >= 6
    if shift is not None and got_ok.any():
        flow = (got - np.asarray(pts))[got_ok]
        np.testing.assert_allclose(flow, np.broadcast_to(
            [shift[1], shift[0]], flow.shape), atol=0.5)


def test_bwd_levels_change_only_the_backward_track(rng):
    """A zero-seeded short backward track and the full one accept the same
    clean translation with the same forward points."""
    pyr0, pyr1, pts, valid, kw, _ = case_inputs("translation", rng)
    kw["max_roundtrip_px"] = 3.0
    full = lk_triton.lk_forward_backward(pyr0, pyr1, pts, valid,
                                         interpret=True, **kw)
    kw["bwd_levels"] = 0
    short = lk_triton.lk_forward_backward(pyr0, pyr1, pts, valid,
                                          interpret=True, **kw)
    np.testing.assert_array_equal(np.asarray(full[1]), np.asarray(short[1]))
    np.testing.assert_allclose(np.asarray(full[0]), np.asarray(short[0]),
                               atol=POINT_TOL_PX)


def test_cpu_takes_the_xla_path(rng):
    assert jax.default_backend() == "cpu"
    assert not optical_flow.kernel_is_default()
    pyr0, pyr1, pts, valid, kw, _ = case_inputs("translation", rng)
    default = optical_flow.track_forward_backward(pyr0, pyr1, pts, valid, **kw)
    xla = optical_flow.track_forward_backward(pyr0, pyr1, pts, valid,
                                              use_kernel=False, **kw)
    for a, b in zip(default, xla):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_kernel_without_gpu_raises(rng):
    pyr0, pyr1, pts, valid, kw, _ = case_inputs("translation", rng)
    with pytest.raises(RuntimeError, match="GPU"):
        optical_flow.track_forward_backward(pyr0, pyr1, pts, valid,
                                            use_kernel=True, **kw)
    with pytest.raises(RuntimeError, match="interpret=True"):
        lk_triton.lk_forward_backward(pyr0, pyr1, pts, valid, **kw)


def test_level_windows_clamp_to_level_size():
    dims = [(480, 640), (240, 320), (120, 160), (60, 80), (30, 40)]
    assert optical_flow.level_windows(dims, 53, 53, 53, 1) == (
        (53, 53), (53, 53), (53, 53), (53, 53), (27, 37))
    assert optical_flow.level_windows(dims, 53, 41, 21, 2) == (
        (53, 41), (53, 41), (21, 21), (21, 21), (21, 21))
    assert optical_flow.level_windows(dims, 53, 53, None, 1)[1] == (53, 53)


def test_kernel_lowers_to_triton_at_real_widths(monkeypatch):
    """The kernel goes through Pallas's Triton lowering for CUDA at 640x480,
    128 slots, 53x53 windows and 5 levels (cross-platform lowering: no GPU
    and no PTX compile involved)."""
    monkeypatch.setattr(lk_triton, "kernel_is_default", lambda: True)
    dims = [(480 >> lvl, 640 >> lvl) for lvl in range(5)]
    pyr = [jax.ShapeDtypeStruct(d, jnp.float32) for d in dims]
    pts = jax.ShapeDtypeStruct((128, 2), jnp.float32)
    valid = jax.ShapeDtypeStruct((128,), jnp.bool_)
    fn = jax.jit(lambda a, b, p, v: lk_triton.lk_forward_backward(
        a, b, p, v, max_roundtrip_px=3.0, levels=4, bwd_levels=0,
        coarse_win=53))
    exp = export.export(fn, platforms=["cuda"], disabled_checks=[
        export.DisabledSafetyCheck.custom_call("__gpu$xla.gpu.triton")])(
            pyr, pyr, pts, valid)
    text = exp.mlir_module()
    assert text.count("__gpu$xla.gpu.triton") == 1
    assert "grid_x = 128" in text
    assert [o.shape for o in exp.out_avals] == [(128, 2), (128,)]


@pytest.mark.gpu
def test_kernel_matches_xla_at_real_widths(gpu):
    """640x480 room-orbit frames, 128 slots, default LK config: points within
    0.01 px where both accept, at most 2 status flips, each on the gate."""
    import lk_real_width

    res = lk_real_width.compare()
    lk_real_width.check(res)

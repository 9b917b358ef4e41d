"""Native C++ PNG loader tests: decode parity against PIL and prefetch loader."""

import numpy as np
import pytest

from rgbd_slam.io import native_loader

pytestmark = pytest.mark.skipif(not native_loader.available(),
                                reason="native library not built")


def write_pngs(tmp_path, rng, n=3, h=48, w=64):
    from PIL import Image

    rgbs, depths = [], []
    for i in range(n):
        rgb = rng.integers(0, 255, (h, w, 3), dtype=np.uint8)
        depth = rng.integers(500, 30000, (h, w)).astype(np.uint16)
        rp = str(tmp_path / f"rgb_{i}.png")
        dp = str(tmp_path / f"depth_{i}.png")
        Image.fromarray(rgb).save(rp)
        # 16-bit grayscale PNG
        Image.fromarray(depth.astype(np.int32), mode="I").convert("I;16").save(dp)
        rgbs.append(rp)
        depths.append(dp)
    return rgbs, depths


class TestDecode:
    def test_rgb_to_gray_matches_pil(self, tmp_path, rng):
        from PIL import Image

        rgbs, _ = write_pngs(tmp_path, rng, n=1)
        native = native_loader.decode_png(rgbs[0], 48, 64, to_gray=True)
        assert native is not None
        ref = np.asarray(Image.open(rgbs[0]))
        expected = (0.299 * ref[..., 0] + 0.587 * ref[..., 1]
                    + 0.114 * ref[..., 2])
        np.testing.assert_allclose(native, expected, atol=0.01)

    def test_depth_16bit_scaled(self, tmp_path, rng):
        from PIL import Image

        _, depths = write_pngs(tmp_path, rng, n=1)
        native = native_loader.decode_png(depths[0], 48, 64, to_gray=False,
                                          scale=0.2)
        assert native is not None
        ref = np.asarray(Image.open(depths[0]), dtype=np.float32) * 0.2
        np.testing.assert_allclose(native, ref, atol=0.01)

    def test_wrong_size_rejected(self, tmp_path, rng):
        rgbs, _ = write_pngs(tmp_path, rng, n=1)
        assert native_loader.decode_png(rgbs[0], 10, 10) is None


class TestPrefetchLoader:
    def test_sequential_frames(self, tmp_path, rng):
        rgbs, depths = write_pngs(tmp_path, rng, n=3)
        loader = native_loader.NativeFrameLoader(rgbs, depths, 48, 64,
                                                 depth_scale=0.2)
        frames = list(loader)
        assert len(frames) == 3
        for gray, depth in frames:
            assert gray.shape == (48, 64) and depth.shape == (48, 64)
            assert np.isfinite(gray).all() and (depth >= 0).all()
        loader.close()

    def test_random_access(self, tmp_path, rng):
        rgbs, depths = write_pngs(tmp_path, rng, n=3)
        loader = native_loader.NativeFrameLoader(rgbs, depths, 48, 64)
        g2, d2 = loader.get(2)
        g0, d0 = loader.get(0)
        assert not np.array_equal(g2, g0)
        loader.close()

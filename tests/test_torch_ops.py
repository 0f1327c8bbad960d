"""The port's ops (timg_tpu_torch.ops) against the JAX package on the CPU.

Every comparison is exact: the conversion is integer arithmetic, the
resize sums exact bf16 products in f32, and the dither is the same f32
sequence, so the bytes must agree.  Inputs are made with numpy from a
seed and handed to both packages.  The CUDA kernels are held against
these plain versions in tests/test_torch_kernels.py.
"""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
os.environ["TIMG_TPU_TORCH_DEVICE"] = "cpu"

import jax.numpy as jnp  # noqa: E402

from timg_tpu.ops import resize as jresize  # noqa: E402
from timg_tpu.ops import yuv as jyuv  # noqa: E402
from timg_tpu_torch.ops import resize as tresize  # noqa: E402
from timg_tpu_torch.ops import sixel_kernel  # noqa: E402
from timg_tpu_torch.ops import yuv as tyuv  # noqa: E402


def _planes(seed, b, h, w):
    rng = np.random.default_rng(seed)
    ch, cw = (h + 1) // 2, (w + 1) // 2
    return (rng.integers(0, 256, (b, h, w), dtype=np.uint8),
            rng.integers(0, 256, (b, ch, cw), dtype=np.uint8),
            rng.integers(0, 256, (b, ch, cw), dtype=np.uint8))


def _words(seed, b, h, w):
    rng = np.random.default_rng(seed)
    img = rng.integers(0, 256, (b, h, w, 4), dtype=np.uint8)
    img[..., 3] = 255
    return img.view(np.int32).reshape(b, h, w)


# ---- (a) YUV 4:2:0 -> RGBA words --------------------------------------

@pytest.mark.parametrize("full_range", [False, True])
@pytest.mark.parametrize("b,h,w", [(2, 7, 9), (1, 13, 6), (3, 24, 32)])
def test_yuv420_matches_jax_and_numpy(full_range, b, h, w):
    y, u, v = _planes(h * w + full_range, b, h, w)
    got = tyuv.yuv420_to_rgba_words(torch.from_numpy(y), torch.from_numpy(u),
                                    torch.from_numpy(v), full_range).numpy()
    want_jax = np.asarray(jyuv.yuv420_to_rgba_words(y, u, v, full_range))
    want_np = jyuv.yuv420_to_rgba_words_np(y, u, v, full_range)
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want_jax)
    np.testing.assert_array_equal(got, want_np)


# (b, h, w, ch, cw); chroma None is ceil(h / 2) x ceil(w / 2); the last
# two have larger chroma planes, which every version clamps at the
# planes' own edges before keeping h x w.
@pytest.mark.parametrize("full_range", [False, True])
@pytest.mark.parametrize("b,h,w,ch,cw", [
    (1, 1, 1, None, None), (2, 2, 3, None, None), (1, 3, 2, None, None),
    (1, 1079, 1919, None, None), (2, 37, 41, None, None),
    (2, 7, 9, 6, 8), (1, 10, 17, 9, 12)])
def test_yuv420_plain_matches_jax_and_numpy(b, h, w, ch, cw, full_range):
    rng = np.random.default_rng(h * w + 7 * full_range)
    ch = (h + 1) // 2 if ch is None else ch
    cw = (w + 1) // 2 if cw is None else cw
    y = rng.integers(0, 256, (b, h, w), dtype=np.uint8)
    u, v = (rng.integers(0, 256, (b, ch, cw), dtype=np.uint8)
            for _ in range(2))
    got = tyuv.yuv420_to_rgba_words_plain(
        torch.from_numpy(y), torch.from_numpy(u), torch.from_numpy(v),
        full_range).numpy()
    np.testing.assert_array_equal(
        got, np.asarray(jyuv.yuv420_to_rgba_words(y, u, v, full_range)))
    np.testing.assert_array_equal(
        got, jyuv.yuv420_to_rgba_words_np(y, u, v, full_range))


# ---- (b) resize -------------------------------------------------------

@pytest.mark.parametrize("in_size,out_size,horizontal", [
    (256, 160, True), (108, 72, False), (128, 256, True), (96, 192, False),
    (1920, 1280, True), (1080, 720, False)])
def test_band_taps_rebuild_band_matrix(in_size, out_size, horizontal):
    """The compact tap tables hold exactly the bf16 band matrix."""
    m = jresize._band_matrix_np(in_size, out_size, horizontal)
    np.testing.assert_array_equal(
        tresize._band_matrix_np(in_size, out_size, horizontal), m)
    starts, taps = tresize.band_taps(m)
    assert starts.dtype == torch.int32 and taps.dtype == torch.bfloat16
    s = starts.numpy().astype(np.int64)
    assert (s >= 0).all() and (s + taps.shape[1] <= in_size).all()
    rebuilt = torch.zeros((in_size, out_size), dtype=torch.bfloat16)
    for t in range(taps.shape[1]):
        rebuilt[torch.from_numpy(s + t), torch.arange(out_size)] = taps[:, t]
    want = torch.from_numpy(m).to(torch.bfloat16)
    assert torch.equal(rebuilt.view(torch.int16), want.view(torch.int16))


@pytest.mark.parametrize("h,w,oh,ow", [
    (108, 256, 72, 160), (96, 128, 192, 256), (270, 384, 135, 240),
    (48, 64, 48, 64)])
def test_resize_video_words_matches_jax(h, w, oh, ow):
    words = _words(h + w, 2, h, w)
    got = tresize.resize_video_words(torch.from_numpy(words), oh, ow)
    want = np.asarray(jresize.resize_video_words(jnp.asarray(words), oh, ow))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("h,w,oh,ow", [
    (1080, 1920, 480, 800),    # horizontal first; 10-tap bands
    (1080, 1920, 720, 1280),   # vertical first
    (1080, 1920, 200, 356),    # vertical first; 14-tap bands
    (720, 1280, 300, 500),     # horizontal first
    (700, 1000, 150, 333)])    # vertical first; odd widths
def test_resize_full_frames_match_jax(h, w, oh, ow):
    """Seeded uniform noise, whose 8+-tap sums cross the 32-input blocks
    of the reference dot's order (ops/resize.py): every word equal."""
    words = _words(0, 1, h, w) if (oh, ow) == (480, 800) else \
        _words(h + oh, 1, h, w)
    got = tresize.resize_video_words(torch.from_numpy(words), oh, ow)
    want = np.asarray(jresize.resize_video_words(jnp.asarray(words), oh, ow))
    np.testing.assert_array_equal(got.numpy(), want)


def test_resize_480x800_word_that_ascending_order_missed():
    """Row 873's 10 taps into column 344 sum to 186.5 in the reference's
    order and 186.50001525878906 in ascending order: a bf16 tie that
    once made word (388, 344) 181 instead of 180 in channel 2."""
    words = _words(0, 1, 1080, 1920)
    got = tresize.resize_video_words(torch.from_numpy(words), 480, 800)
    assert not tresize.vertical_first(1080, 1920, 480, 800)
    word = np.array([int(got[0, 388, 344])], np.int32).view(np.uint8)
    assert word.tolist() == [141, 123, 180, 255]
    planes = torch.from_numpy(words[:, 873:874])
    ch2 = ((planes >> 16) & 0xFF).to(torch.float32)
    starts, taps = tresize.axis_taps(1920, 800, True)
    row = tresize._apply_taps(ch2, 2, starts, taps)
    assert float(row[0, 0, 344]) == 186.5


def test_resize_covers_both_pass_orders():
    orders = {tresize.vertical_first(h, w, oh, ow)
              for h, w, oh, ow in [(108, 256, 72, 160), (96, 128, 192, 256),
                                   (270, 384, 135, 240)]}
    assert orders == {True, False}


# The fused CUDA resize's tile plan (csrc/resize_words.cu; the kernel
# itself is held against the plain version on the card in
# tests/test_torch_kernels.py).
@pytest.mark.parametrize("h,w,oh,ow", [
    (1080, 1920, 720, 1280), (1080, 1920, 722, 1280), (1080, 1920, 480, 800),
    (2160, 3840, 720, 1280), (720, 1280, 300, 500), (96, 128, 192, 256),
    (1080, 1920, 135, 240), (2160, 3840, 270, 480),   # 2-row staged tiles
    (1080, 1920, 16, 28),      # 68x: fits only above the preferred budget
    (2160, 3840, 16, 28)])     # 135x: no tile fits
def test_tile_plan_covers_every_tap(h, w, oh, ow):
    if (h, w, oh, ow) == (2160, 3840, 16, 28):
        assert tresize.plan_tiles(h, w, oh, ow) is None
        return
    sv, tv = tresize.axis_taps(h, oh, False)
    sh, th = tresize.axis_taps(w, ow, True)
    plan = tresize.plan_tiles(h, w, oh, ow)
    assert plan.vertical_first == tresize.vertical_first(h, w, oh, ow)
    assert (plan.taps_v, plan.taps_h) == (tv.shape[1], th.shape[1])
    assert plan.cols in tresize.TILE_COLS
    assert tresize.TILE_THREADS % plan.cols == 0
    regions = tresize.tile_smem_regions(
        plan.vertical_first, plan.rows, plan.cols, plan.mid_n, plan.stage_n,
        plan.taps_v, plan.taps_h)
    offsets = np.cumsum([0] + [size for _, size in regions])
    # the staged words (16-byte cp.async) first, every region aligned
    assert regions[0][0] == 16
    assert all(o % align == 0 for o, (align, _) in zip(offsets, regions))
    assert plan.smem_bytes == offsets[-1]
    assert plan.smem_bytes <= tresize.SMEM_MAX
    if (h, w, oh, ow) != (1080, 1920, 16, 28):
        assert plan.smem_bytes <= tresize.SMEM_PREFERRED
    # every tap of every output of a tile lies in its tile row's and tile
    # column's windows, and each window fits the mid or staged extent
    for windows, starts, taps, tile, n in (
            (plan.windows_v, sv.numpy(), tv.shape[1], plan.rows, oh),
            (plan.windows_h, sh.numpy(), th.shape[1], plan.cols, ow)):
        assert windows.shape == (-(-n // tile), 2)
        for j, (lo, hi) in enumerate(windows):
            s = starts[j * tile:(j + 1) * tile]
            assert lo <= s.min() and s.max() + taps <= hi
    span_v = int((plan.windows_v[:, 1] - plan.windows_v[:, 0]).max())
    span_h = int((plan.windows_h[:, 1] - plan.windows_h[:, 0]).max())
    if plan.vertical_first:
        assert (plan.mid_n, plan.stage_n) == (span_h, span_v)
    else:
        assert (plan.mid_n, plan.stage_n) == (span_v, 0)


@pytest.mark.parametrize("start", range(64))
def test_first_flush_matches_reference_order(start):
    """The kernel's block ends (first_flush, then every 32 taps) are the
    taps t > 0 at which the reference order adds a block's sums to the
    total: (start + t) % 32 == 0."""
    f = tresize.first_flush(start)
    for taps in range(1, 41):
        want = [t for t in range(1, taps) if (start + t) % 32 == 0]
        assert list(range(f, taps, tresize.ORDER_BLOCK)) == want


def test_padded_plane_dims_matches_jax():
    for oh, ow in [(72, 160), (720, 1280), (726, 1281), (1, 1)]:
        assert tresize.padded_plane_dims(oh, ow) == \
            jresize.padded_plane_dims(oh, ow)


# ---- (c) FS cube dither -----------------------------------------------

def _jax_dither(words, h, w):
    from timg_tpu.ops.sixel_pallas3 import fs_dither_cube_fused
    return np.asarray(fs_dither_cube_fused(jnp.asarray(words), h, w,
                                           interpret=True, out_u8=True))


@pytest.mark.parametrize("b,h,w", [(2, 18, 25), (3, 130, 200), (1, 128, 128)])
def test_fs_dither_cube_matches_pallas_interpret(b, h, w):
    words = _words(b * 1000 + h, b, h, w)
    want = _jax_dither(words, h, w)
    plain = sixel_kernel.fs_dither_cube_plain(torch.from_numpy(words), h, w)
    fused = sixel_kernel.fs_dither_cube_fused(torch.from_numpy(words), h, w)
    assert plain.dtype == torch.uint8
    np.testing.assert_array_equal(plain.numpy(), want)
    np.testing.assert_array_equal(fused.numpy(), want)
    wide = sixel_kernel.fs_dither_cube_plain(torch.from_numpy(words), h, w,
                                             out_u8=False)
    assert wide.dtype == torch.int32
    np.testing.assert_array_equal(wide.numpy(), want.astype(np.int32))


def test_fs_dither_cube_bg_pad_rows():
    """722 content rows padded to 726 with an opaque bg word, as the
    video window pads to the sixel band height (here at 22 -> 24)."""
    b, th, w = 2, 22, 40
    padded_h = th + 5 - (th + 5) % 6
    bg_word = (10 | (200 << 8) | (30 << 16) | (255 << 24)) - (1 << 32)
    words = np.full((b, padded_h, w), bg_word, np.int32)
    words[:, :th] = _words(5, b, th, w)
    want = _jax_dither(words, padded_h, w)
    got = sixel_kernel.fs_dither_cube_plain(torch.from_numpy(words),
                                            padded_h, w)
    np.testing.assert_array_equal(got.numpy(), want)


def test_fs_dither_plain_reads_padded_input():
    """Words wider/taller than h x w (pitched input) dither only the
    valid extent, like the Pallas kernel's pre-padded contract."""
    words = _words(8, 2, 20, 30)
    want = _jax_dither(words[:, :18, :25].copy(), 18, 25)
    got = sixel_kernel.fs_dither_cube_fused(torch.from_numpy(words), 18, 25)
    np.testing.assert_array_equal(got.numpy(), want)


def test_fs_dither_plain_matches_numpy_mirror_rgba_input():
    from timg_tpu.ops.sixel_np import fs_dither_cube_np
    rng = np.random.default_rng(4)
    img = rng.integers(0, 256, (2, 11, 17, 4), dtype=np.uint8)
    got = sixel_kernel.fs_dither_cube_plain(torch.from_numpy(img), 11, 17,
                                            out_u8=False)
    np.testing.assert_array_equal(got.numpy(), fs_dither_cube_np(img))

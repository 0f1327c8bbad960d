"""The port's CUDA kernels against their plain PyTorch versions.

Imports no jax, so it runs on a GPU machine without the JAX package:

    python -m pytest tests/test_torch_kernels.py -m cuda

Tests marked ``cuda`` need a card and skip without one; the others pin
the wrappers' CPU behaviour (plain versions only for CPU tensors).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from timg_tpu_torch.ops import libsixel_kernel as tlib  # noqa: E402
from timg_tpu_torch.ops import libsixel_quant as lsq  # noqa: E402
from timg_tpu_torch.ops import resize as tresize  # noqa: E402
from timg_tpu_torch.ops import sixel_kernel  # noqa: E402
from timg_tpu_torch.ops.sixel_np import median_cut_tree  # noqa: E402


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is "
                    "false)")
    return torch.device("cuda")


def _words(seed, b, h, w):
    rng = np.random.default_rng(seed)
    img = rng.integers(0, 256, (b, h, w, 4), dtype=np.uint8)
    img[..., 3] = 255
    return torch.from_numpy(img.view(np.int32).reshape(b, h, w))


def _libsixel_inputs(words):
    """lsq palettes of each frame (padded to 256), the palette words and
    the diffuse flags, as the video window makes them."""
    rgb = words.numpy().view(np.uint8).reshape(words.shape + (4,))[..., :3]
    pals, diffs = zip(*(lsq.make_palette(f) for f in rgb))
    pals256 = torch.from_numpy(tlib.pad_palettes(list(pals)))
    return (pals256, tlib.palette_words(pals256),
            torch.tensor([int(d) for d in diffs], dtype=torch.int32))


def _tree(words):
    rgb = words[0].numpy().view(np.uint8).reshape(words.shape[1:] + (4,))
    _, levels, leaves = median_cut_tree(rgb[..., :3])
    return torch.from_numpy(levels), torch.from_numpy(leaves)


def test_cpu_tensors_take_the_plain_versions():
    words = _words(1, 2, 30, 40)
    assert torch.equal(tresize.resize_video_words(words, 20, 24),
                       tresize.resize_video_words_plain(words, 20, 24))
    assert torch.equal(sixel_kernel.fs_dither_cube_fused(words, 30, 40),
                       sixel_kernel.fs_dither_cube_plain(words, 30, 40))
    levels, leaves = _tree(words)
    assert torch.equal(
        sixel_kernel.fs_dither_tree_fused(words, levels, leaves, 30, 40),
        sixel_kernel.fs_dither_tree_plain(words, levels, leaves, 30, 40))
    pals, palw, diffs = _libsixel_inputs(words)
    tables = tlib.build_bucket_tables(pals)
    assert torch.equal(tables, tlib.build_bucket_tables_plain(pals))
    assert torch.equal(
        tlib.fs_dither_table_fused(words, tables, palw, diffs, 30, 40),
        tlib.fs_dither_table_plain(words, tables, palw, diffs, 30, 40))
    rgb = words.view(torch.uint8).reshape(2, 30, 40, 4)
    assert torch.equal(sixel_kernel.fs_dither_cube_rgb(rgb, 30, 40),
                       sixel_kernel.fs_dither_cube_rgb_plain(rgb, 30, 40))
    assert torch.equal(
        sixel_kernel.fs_dither_tree_rgb(rgb, levels, leaves, 30, 40),
        sixel_kernel.fs_dither_tree_rgb_plain(rgb, levels, leaves, 30, 40))
    assert (tlib.BUCKET_LAUNCHES, tlib.TABLE_LAUNCHES,
            sixel_kernel.TREE_LAUNCHES, sixel_kernel.RGB_LAUNCHES,
            sixel_kernel.TREE_RGB_LAUNCHES) == (0, 0, 0, 0, 0)


def test_resize_identity_returns_input():
    words = _words(2, 1, 12, 16)
    assert tresize.resize_video_words(words, 12, 16) is words


def test_cuda_wrappers_refuse_cpu_tensors():
    from timg_tpu_torch.ops import resize_kernel
    words = _words(3, 1, 12, 16)
    with pytest.raises(ValueError):
        resize_kernel.resize_video_words_cuda(words, 6, 8)
    with pytest.raises(ValueError):
        sixel_kernel.fs_dither_cube_cuda(words, 12, 16)
    levels, leaves = _tree(words)
    with pytest.raises(ValueError):
        sixel_kernel.fs_dither_tree_cuda(words, levels, leaves, 12, 16)
    rgb = words.view(torch.uint8).reshape(1, 12, 16, 4)
    with pytest.raises(ValueError):
        sixel_kernel.fs_dither_cube_rgb_cuda(rgb, 12, 16)
    with pytest.raises(ValueError):
        sixel_kernel.fs_dither_tree_rgb_cuda(rgb, levels, leaves, 12, 16)
    pals, palw, diffs = _libsixel_inputs(words)
    with pytest.raises(ValueError):
        tlib.build_bucket_tables_cuda(pals)
    with pytest.raises(ValueError):
        tlib.fs_dither_table_cuda(words, tlib.build_bucket_tables(pals),
                                  palw, diffs, 12, 16)


def test_dither_rejects_bad_input():
    with pytest.raises(ValueError):
        sixel_kernel.fs_dither_cube_plain(torch.zeros((1, 4, 4), dtype=
                                                      torch.int64), 4, 4)
    for bad in (torch.zeros((1, 4, 4, 2), dtype=torch.uint8),
                torch.zeros((1, 4, 4, 3), dtype=torch.int32)):
        with pytest.raises(ValueError):
            sixel_kernel.fs_dither_cube_rgb_plain(bad, 4, 4)


@pytest.mark.cuda
@pytest.mark.parametrize("h,w,oh,ow", [(108, 256, 72, 160),
                                       (96, 128, 192, 256),
                                       (270, 384, 135, 240),
                                       (1080, 1920, 722, 1280),
                                       (1080, 1920, 480, 800),
                                       (1080, 1920, 200, 356)])
def test_resize_kernel_matches_plain(cuda_device, h, w, oh, ow):
    from timg_tpu_torch.ops import resize_kernel
    words = _words(h, 2, h, w)
    want = tresize.resize_video_words_plain(words, oh, ow)
    got = resize_kernel.resize_video_words_cuda(words.to(cuda_device), oh, ow)
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), want)


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,w", [(2, 18, 25), (3, 130, 200), (2, 1100, 40),
                                   (1, 4096, 8)])
def test_dither_kernel_matches_plain(cuda_device, b, h, w):
    words = _words(h, b, h, w)
    want = sixel_kernel.fs_dither_cube_plain(words, h, w)
    got = sixel_kernel.fs_dither_cube_cuda(words.to(cuda_device), h, w)
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), want)
    wide = sixel_kernel.fs_dither_cube_cuda(words.to(cuda_device), h, w,
                                            out_u8=False)
    assert torch.equal(wide.cpu(), want.to(torch.int32))


@pytest.mark.cuda
def test_dither_kernel_reads_pitched_input(cuda_device):
    words = _words(7, 2, 40, 50).to(cuda_device)
    got = sixel_kernel.fs_dither_cube_cuda(words, 33, 41)
    want = sixel_kernel.fs_dither_cube_plain(words[:, :33, :41].cpu(), 33, 41)
    assert torch.equal(got.cpu(), want)


@pytest.mark.cuda
def test_dither_kernel_refuses_too_many_rows(cuda_device):
    words = torch.zeros((1, 4097, 4), dtype=torch.int32, device=cuda_device)
    with pytest.raises(ValueError):
        sixel_kernel.fs_dither_cube_cuda(words, 4097, 4)


@pytest.mark.cuda
def test_resize_kernel_480x800_seed0(cuda_device):
    """The frame where ascending summation put word (388, 344) off by
    one: the kernel follows the reference dot's order too."""
    rng = np.random.default_rng(0)
    img = rng.integers(0, 256, (1, 1080, 1920, 4), dtype=np.uint8)
    img[..., 3] = 255
    words = torch.from_numpy(img.view(np.int32).reshape(1, 1080, 1920))
    from timg_tpu_torch.ops import resize_kernel
    got = resize_kernel.resize_video_words_cuda(words.to(cuda_device),
                                                480, 800).cpu()
    assert torch.equal(got, tresize.resize_video_words_plain(words, 480, 800))
    word = np.array([int(got[0, 388, 344])], np.int32).view(np.uint8)
    assert word.tolist() == [141, 123, 180, 255]


@pytest.mark.cuda
@pytest.mark.parametrize("b,seed", [(3, 1), (32, 2)])
def test_bucket_kernel_matches_plain(cuda_device, b, seed):
    rng = np.random.default_rng(seed)
    pals = rng.integers(0, 256, (b, 256, 3)).astype(np.int32)
    pals[0, 128:] = pals[0, :128]                    # duplicates: first wins
    pals[1] = pals[1, :1]                            # one color repeated
    pals = torch.from_numpy(pals)
    want = tlib.build_bucket_tables_plain(pals)
    got = tlib.build_bucket_tables_cuda(pals.to(cuda_device))
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), want)


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,w", [(3, 18, 25), (2, 130, 200), (2, 1100, 40),
                                   (1, 4096, 8)])
def test_table_kernel_matches_plain(cuda_device, b, h, w):
    words = _words(h + 1, b, h, w)
    smooth = torch.full((h, w), 0x00204060, dtype=torch.int32)
    words[-1] = smooth | -(1 << 24)                  # one flat frame
    pals, palw, diffs = _libsixel_inputs(words)
    diffs[-1] = 0                                    # palette only
    tables = tlib.build_bucket_tables_plain(pals)
    want = tlib.fs_dither_table_plain(words, tables, palw, diffs, h, w)
    got = tlib.fs_dither_table_cuda(words.to(cuda_device), tables, palw,
                                    diffs, h, w)
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), want)
    wide = tlib.fs_dither_table_cuda(words.to(cuda_device), tables, palw,
                                     diffs, h, w, out_u8=False)
    assert torch.equal(wide.cpu(), want.to(torch.int32))


@pytest.mark.cuda
def test_table_kernel_reads_pitched_input(cuda_device):
    words = _words(8, 2, 40, 50)
    pals, palw, diffs = _libsixel_inputs(words)
    tables = tlib.build_bucket_tables_plain(pals)
    got = tlib.fs_dither_table_cuda(words.to(cuda_device), tables, palw,
                                    diffs, 33, 41)
    want = tlib.fs_dither_table_plain(words[:, :33, :41], tables, palw,
                                      diffs, 33, 41)
    assert torch.equal(got.cpu(), want)


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,w", [(2, 18, 25), (3, 130, 200), (2, 1100, 40),
                                   (1, 4096, 8)])
def test_tree_kernel_matches_plain(cuda_device, b, h, w):
    words = _words(h + 2, b, h, w)
    levels, leaves = _tree(words)
    want = sixel_kernel.fs_dither_tree_plain(words, levels, leaves, h, w)
    got = sixel_kernel.fs_dither_tree_cuda(words.to(cuda_device), levels,
                                           leaves, h, w)
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), want)
    wide = sixel_kernel.fs_dither_tree_cuda(words.to(cuda_device), levels,
                                            leaves, h, w, out_u8=False)
    assert torch.equal(wide.cpu(), want.to(torch.int32))


def _bytes(seed, b, h, w, c):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.integers(0, 256, (b, h, w, c),
                                         dtype=np.uint8))


# K9 (cube) and the tree quantizer on [B, H, W, C] bytes: the main
# path's 720x1280 and bg-padded 726 rows, 2 and 4 rows a thread (1025,
# 2049 rows), and C = 4 input of which only 3 channels are read.
RGB_SHAPES = [(2, 720, 1280, 4), (1, 726, 1280, 3), (2, 1025, 30, 3),
              (1, 2049, 12, 4), (3, 18, 25, 4)]


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,w,c", RGB_SHAPES)
def test_cube_rgb_kernel_matches_plain(cuda_device, b, h, w, c):
    frames = _bytes(h * c, b, h, w, c)
    want = sixel_kernel.fs_dither_cube_rgb_plain(frames, h, w)
    got = sixel_kernel.fs_dither_cube_rgb_cuda(frames.to(cuda_device), h, w)
    torch.cuda.synchronize()
    assert got.dtype == torch.int32
    assert torch.equal(got.cpu(), want)
    small = sixel_kernel.fs_dither_cube_rgb_cuda(frames.to(cuda_device), h,
                                                 w, out_u8=True)
    assert torch.equal(small.cpu(), want.to(torch.uint8))
    if c == 4:   # the fourth channel is never read
        other = frames.clone()
        other[..., 3] = 255 - other[..., 3]
        again = sixel_kernel.fs_dither_cube_rgb_cuda(other.to(cuda_device),
                                                     h, w)
        assert torch.equal(again.cpu(), want)


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,w,c", RGB_SHAPES)
def test_tree_rgb_kernel_matches_plain(cuda_device, b, h, w, c):
    frames = _bytes(h * c + 1, b, h, w, c)
    _, levels, leaves = median_cut_tree(frames[0, ..., :3].numpy())
    levels, leaves = torch.from_numpy(levels), torch.from_numpy(leaves)
    want = sixel_kernel.fs_dither_tree_rgb_plain(frames, levels, leaves, h, w)
    got = sixel_kernel.fs_dither_tree_rgb_cuda(frames.to(cuda_device),
                                               levels, leaves, h, w)
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), want)
    small = sixel_kernel.fs_dither_tree_rgb_cuda(frames.to(cuda_device),
                                                 levels, leaves, h, w,
                                                 out_u8=True)
    assert torch.equal(small.cpu(), want.to(torch.uint8))


@pytest.mark.cuda
def test_rgb_kernels_read_a_larger_frame(cuda_device):
    frames = _bytes(9, 2, 40, 50, 4).to(cuda_device)
    got = sixel_kernel.fs_dither_cube_rgb_cuda(frames, 33, 41)
    want = sixel_kernel.fs_dither_cube_rgb_plain(frames[:, :33, :41].cpu(),
                                                 33, 41)
    assert torch.equal(got.cpu(), want)


@pytest.mark.cuda
def test_rgb_kernels_refuse_too_many_rows(cuda_device):
    frames = torch.zeros((1, 4097, 4, 3), dtype=torch.uint8,
                         device=cuda_device)
    with pytest.raises(ValueError):
        sixel_kernel.fs_dither_cube_rgb_cuda(frames, 4097, 4)

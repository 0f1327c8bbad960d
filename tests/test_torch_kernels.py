"""The port's CUDA kernels against their plain PyTorch versions.

Imports no jax, so it runs on a GPU machine without the JAX package:

    python -m pytest tests/test_torch_kernels.py -m cuda

Tests marked ``cuda`` need a card and skip without one; the others pin
the wrappers' CPU behaviour (plain versions only for CPU tensors).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from timg_tpu_torch.ops import resize as tresize  # noqa: E402
from timg_tpu_torch.ops import sixel_kernel  # noqa: E402


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


def test_cpu_tensors_take_the_plain_versions():
    words = _words(1, 2, 30, 40)
    assert torch.equal(tresize.resize_video_words(words, 20, 24),
                       tresize.resize_video_words_plain(words, 20, 24))
    assert torch.equal(sixel_kernel.fs_dither_cube_fused(words, 30, 40),
                       sixel_kernel.fs_dither_cube_plain(words, 30, 40))


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


def test_dither_rejects_bad_input():
    with pytest.raises(ValueError):
        sixel_kernel.fs_dither_cube_plain(torch.zeros((1, 4, 4), dtype=
                                                      torch.int64), 4, 4)


@pytest.mark.cuda
@pytest.mark.parametrize("h,w,oh,ow", [(108, 256, 72, 160),
                                       (96, 128, 192, 256),
                                       (270, 384, 135, 240),
                                       (1080, 1920, 722, 1280)])
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

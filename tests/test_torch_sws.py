"""The port's swscale-exact resize (timg_tpu_torch.ops.sws_resize,
--resample=sws-bitexact) against the JAX package on the CPU, and its
CUDA kernel (csrc/sws_yuv420.cu) against the plain version on the card.

Tolerance everywhere: byte equality.  The references are the JAX
package's numpy mirror ``sws_yuv420_to_rgba_words_np`` and its jitted
``sws_yuv420_to_rgba_words`` on XLA:CPU, over the geometries of
tests/test_sws_resize.py (templates 0, 1 and 2, odd widths on the
full-chroma path, the unscaled converter, equal sizes of odd height) in
both ranges, on seeded planes and on flat ones: all-255 luma and blue
chroma overflow int32 in the full-chroma conversion, whose C
wraparound is the semantics.
"""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
os.environ["TIMG_TPU_TORCH_DEVICE"] = "cpu"

from timg_tpu.ops import sws_resize as jsws  # noqa: E402
from timg_tpu_torch.ops import sws_kernel  # noqa: E402
from timg_tpu_torch.ops import sws_resize as tsws  # noqa: E402

GEOS = [
    (64, 48, 32, 24),    # 2x downscale (template 0)
    (32, 24, 64, 48),    # 2x upscale (template 2)
    (64, 48, 64, 24),    # vertical-only
    (64, 48, 32, 48),    # horizontal-only
    (37, 23, 22, 37),    # odd source dims
    (129, 47, 48, 96),   # prime-ish
    (16, 4, 200, 4),     # extreme aspect (template 1, one chroma tap)
    (64, 48, 31, 24),    # odd width: full chroma, template 0
    (64, 48, 33, 48),    # full chroma, template 1
    (32, 24, 65, 48),    # odd upscale: full chroma, template 2
    (64, 48, 64, 48),    # unscaled converter (even dst_h)
    (63, 48, 63, 48),    # unscaled at an odd width
    (63, 47, 63, 47),    # odd-height equal size -> scaled path
    (64, 47, 64, 47),    # even-w odd-h equal size -> scaled path
]
# flat planes (Y, U, V): black, white, and the corners that overflow
FLAT = [(0, 0, 0), (255, 255, 255), (255, 255, 0), (0, 255, 255)]


def _planes(seed, sw, sh, n=3, flat=None):
    ch, cw = (sh + 1) // 2, (sw + 1) // 2
    if flat is not None:
        return tuple(np.full(s, val, np.uint8) for s, val in zip(
            ((n, sh, sw), (n, ch, cw), (n, ch, cw)), flat))
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 256, (n, sh, sw), np.uint8),
            rng.integers(0, 256, (n, ch, cw), np.uint8),
            rng.integers(0, 256, (n, ch, cw), np.uint8))


def _torch(planes):
    return [torch.from_numpy(p) for p in planes]


@pytest.mark.parametrize("full", [False, True])
@pytest.mark.parametrize("sw,sh,dw,dh", GEOS)
def test_plan_matches_jax(sw, sh, dw, dh, full):
    """Filters, geometry, template and gates equal the JAX package's
    Plan; the kernel's first taps are the index tables' first column."""
    got, want = tsws.Plan(sw, sh, dw, dh, full), jsws.Plan(sw, sh, dw, dh,
                                                           full)
    for k in ("h_lum_idx", "h_lum_coef", "h_chr_idx", "h_chr_coef",
              "v_lum_idx", "v_lum_coef", "v_chr_idx", "v_chr_coef"):
        np.testing.assert_array_equal(getattr(got, k), getattr(want, k))
        assert getattr(got, k).dtype == np.int32
    for k in ("src_w", "src_h", "dst_w", "dst_h", "chr_src_w",
              "chr_src_h", "chr_dst_w", "v_lum_size", "v_chr_size",
              "full_chroma", "unscaled", "template"):
        assert getattr(got, k) == getattr(want, k), k
    for k in ("yalpha", "uvalpha"):
        assert hasattr(got, k) == hasattr(want, k)
        if hasattr(want, k):
            np.testing.assert_array_equal(getattr(got, k), getattr(want, k))
    for pos, idx in ((got.h_lum_pos, got.h_lum_idx),
                     (got.h_chr_pos, got.h_chr_idx),
                     (got.v_lum_pos, got.v_lum_idx),
                     (got.v_chr_pos, got.v_chr_idx)):
        np.testing.assert_array_equal(pos, idx[:, 0])
    assert len(got.constants()) == 6


@pytest.mark.parametrize("full", [False, True])
@pytest.mark.parametrize("sw,sh,dw,dh", GEOS)
def test_plain_matches_numpy_mirror(sw, sh, dw, dh, full):
    for k, flat in enumerate([None] + FLAT):
        planes = _planes(sw * 100 + dw + full, sw, sh, flat=flat)
        want = jsws.sws_yuv420_to_rgba_words_np(*planes, dh, dw, full)
        got = tsws.sws_yuv420_to_rgba_words(*_torch(planes), dh, dw, full)
        assert got.dtype == torch.int32 and got.shape == (3, dh, dw)
        np.testing.assert_array_equal(got.numpy(), want, err_msg=str(flat))


@pytest.mark.parametrize("sw,sh,dw,dh", GEOS[:4] + GEOS[-7:])
def test_plain_matches_jitted_jax(sw, sh, dw, dh):
    import jax
    import jax.numpy as jnp

    fn = jax.jit(jsws.sws_yuv420_to_rgba_words, static_argnums=(3, 4, 5))
    for full in (False, True):
        for flat in (None, (255, 255, 255)):
            planes = _planes(11 + full, sw, sh, flat=flat)
            want = np.asarray(fn(*(jnp.asarray(p) for p in planes), dh, dw,
                                 full))
            got = tsws.sws_yuv420_to_rgba_words(*_torch(planes), dh, dw,
                                                full)
            np.testing.assert_array_equal(got.numpy(), want)


def test_flat_planes_reach_the_int32_wraparound(monkeypatch):
    """On the full-chroma path, all-255 luma with blue chroma overflows
    int32 in yuv2rgb_write_full (limited range): the plain version's
    wrap changes a value there, and the words still equal the mirror."""
    wrapped = []
    real = tsws._w

    def counting(x):
        out = real(x)
        wrapped.append(bool((out != x).any()))
        return out

    monkeypatch.setattr(tsws, "_w", counting)
    planes = _planes(0, 64, 48, flat=(255, 255, 0))
    got = tsws.sws_yuv420_to_rgba_words(*_torch(planes), 24, 31, False)
    assert any(wrapped)
    np.testing.assert_array_equal(
        got.numpy(), jsws.sws_yuv420_to_rgba_words_np(*planes, 24, 31,
                                                      False))


def test_cuda_wrapper_refuses_cpu_tensors_and_bad_planes():
    planes = _torch(_planes(1, 16, 12, n=1))
    plan = tsws.get_plan(16, 12, 8, 6, False)
    with pytest.raises(ValueError):
        sws_kernel.sws_yuv420_to_rgba_words_cuda(*planes, plan)
    assert sws_kernel.LAUNCHES == 0


def test_plain_chroma_planes_wider_than_half():
    """Chroma planes larger than ceil(H/2) x ceil(W/2) (a decoder's
    padded planes) give the words of the exact planes."""
    y, u, v = _planes(4, 30, 20)
    pad = [np.pad(p, ((0, 0), (0, 2), (0, 3)), constant_values=7)
           for p in (u, v)]
    for dh, dw in ((12, 18), (12, 17), (20, 30)):
        want = tsws.sws_yuv420_to_rgba_words(*_torch((y, u, v)), dh, dw,
                                             True)
        got = tsws.sws_yuv420_to_rgba_words(*_torch((y, *pad)), dh, dw,
                                            True)
        assert torch.equal(got, want)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is "
                    "false)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("sw,sh,dw,dh", GEOS + [
    (1920, 1080, 1280, 720), (1920, 1080, 1279, 720),
    (1920, 1080, 320, 90),     # the quarter sws window (-g160x48)
    (1920, 1080, 170, 96),     # 24 taps each way
    (3840, 2160, 1280, 720),
    (1920, 1080, 1280, 710),   # a short last chunk
    (1920, 24, 24, 12)])       # the wide path (taps in shared memory)
def test_kernel_matches_plain(cuda_device, sw, sh, dw, dh):
    """The CUDA kernel equals the plain version on the card, both
    ranges, seeded and flat planes at B=2 and seeded at B=1, padded
    chroma planes too."""
    for full in (False, True):
        for n, flat in [(2, None), (1, None)] + [(2, f) for f in FLAT]:
            planes = _torch(_planes(sw + dw + n, sw, sh, n=n, flat=flat))
            dev = [p.to(cuda_device) for p in planes]
            before = sws_kernel.LAUNCHES
            got = tsws.sws_yuv420_to_rgba_words(*dev, dh, dw, full)
            torch.cuda.synchronize()
            assert sws_kernel.LAUNCHES == before + 1
            want = tsws.sws_yuv420_to_rgba_words_plain(*planes, dh, dw,
                                                       full)
            assert torch.equal(got.cpu(), want), (full, n, flat)
    y, u, v = _torch(_planes(3, sw, sh, n=2))
    pad = [torch.nn.functional.pad(p, (0, 3, 0, 2), value=9).to(cuda_device)
           for p in (u, v)]
    got = tsws.sws_yuv420_to_rgba_words(y.to(cuda_device), *pad, dh, dw,
                                        False)
    assert torch.equal(got.cpu(), tsws.sws_yuv420_to_rgba_words_plain(
        y, u, v, dh, dw, False))

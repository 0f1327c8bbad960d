"""The port's library API (timg_tpu_torch.models, "sixel") and the ops it
runs, against the JAX package on the CPU.

Tolerance everywhere: byte equality.  The references are the JAX
package's strict numpy mirrors (ops/resize_np.resize_batch_np,
ops/cpu_mirror.alpha_compose_background_np, ops/sixel_np's dithers,
render/sixel_render.encode_sixel_stream), K9 itself in interpret mode
(ops/sixel_pallas.fs_dither_cube_pallas), and the JAX package's own
SixelModel on the CPU.  Small seeded inputs: [3, 40, 60, 4] with random
alpha, odd B, heights that are not multiples of 6.
"""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
os.environ["TIMG_TPU_TORCH_DEVICE"] = "cpu"

from timg_tpu.ops.cpu_mirror import alpha_compose_background_np  # noqa: E402
from timg_tpu.ops.resize_np import resize_batch_np  # noqa: E402
from timg_tpu.ops.sixel_np import (cube_palette, fs_dither_cube_np,  # noqa: E402
                                   fs_dither_tree_np, median_cut_tree)
from timg_tpu.render.sixel_render import encode_sixel_stream  # noqa: E402
from timg_tpu_torch import models  # noqa: E402
from timg_tpu_torch.ops import compose as tcompose  # noqa: E402
from timg_tpu_torch.ops import resize as tresize  # noqa: E402
from timg_tpu_torch.ops import sixel_kernel  # noqa: E402

BG = (0, 0, 0, 255)
NO_PATTERN = np.zeros(4, np.uint8)


def _frames(seed=0, b=3, h=40, w=60):
    """Seeded RGBA with random alpha: transparent, opaque and partial."""
    rng = np.random.default_rng(seed)
    fr = rng.integers(0, 256, (b, h, w, 4), dtype=np.uint8)
    fr[..., 3] = rng.choice(np.array([0, 7, 128, 255, 255], np.uint8),
                            size=(b, h, w))
    return fr


def _mirror_resized(fr, oh, ow, bg=BG):
    x = resize_batch_np(fr, oh, ow)
    return alpha_compose_background_np(x, np.array(bg, np.uint8), NO_PATTERN)


@pytest.mark.parametrize("oh,ow,weighted", [
    (18, 30, True), (24, 32, True),     # downsample; H not a multiple of 6
    (55, 90, True),                     # upsample (box)
    (40, 60, True),                     # no resize: the frames come back
    (40, 31, True), (21, 60, False),    # one axis only; unweighted alpha
])
def test_resize_batch_matches_numpy_mirror(oh, ow, weighted):
    """stb-exact 7-channel resize == resize_batch_np, byte for byte."""
    fr = _frames()
    want = resize_batch_np(fr, oh, ow, alpha_weighted=weighted)
    got = tresize.resize_batch(torch.from_numpy(fr), oh, ow,
                               alpha_weighted=weighted)
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("bg,pattern,pw,ph,start_row", [
    ((0, 0, 0, 255), (0, 0, 0, 0), 1, 1, 0),
    ((200, 150, 30, 255), (0, 0, 0, 0), 1, 1, 0),
    ((10, 20, 30, 255), (250, 240, 230, 255), 4, 2, 0),   # checkerboard
    ((10, 20, 30, 255), (10, 20, 30, 255), 4, 2, 0),      # pattern == bg
    ((90, 90, 90, 255), (0, 0, 0, 0), 1, 1, 17),          # start_row
    ((90, 90, 90, 0), (0, 0, 0, 0), 1, 1, 0),             # transparent bg
])
def test_compose_matches_numpy_mirror(bg, pattern, pw, ph, start_row):
    """alpha_compose_background == alpha_compose_background_np."""
    fr = _frames(1)
    want = alpha_compose_background_np(fr, np.array(bg, np.uint8),
                                       np.array(pattern, np.uint8), pw, ph,
                                       start_row)
    got = tcompose.alpha_compose_background(torch.from_numpy(fr), bg,
                                            pattern, pw, ph, start_row)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("b,h,w,c", [(3, 22, 30, 3), (1, 18, 25, 4),
                                     (3, 7, 40, 4)])
def test_k9_plain_matches_pallas_interpret_and_numpy(b, h, w, c):
    """K9's plain version (bytes in, int32 out) == fs_dither_cube_pallas
    in interpret mode == sixel_np.fs_dither_cube_np; C = 4 input reads
    only the first three channels."""
    import jax.numpy as jnp

    from timg_tpu.ops.sixel_pallas import fs_dither_cube_pallas

    rng = np.random.default_rng(b * 100 + h)
    img = rng.integers(0, 256, (b, h, w, c), dtype=np.uint8)
    got = sixel_kernel.fs_dither_cube_rgb_plain(torch.from_numpy(img), h, w)
    assert got.dtype == torch.int32 and tuple(got.shape) == (b, h, w)
    pallas = np.asarray(fs_dither_cube_pallas(jnp.asarray(img), h, w,
                                              interpret=True))
    np.testing.assert_array_equal(got.numpy(), pallas)
    np.testing.assert_array_equal(got.numpy(), fs_dither_cube_np(img))
    u8 = sixel_kernel.fs_dither_cube_rgb_plain(torch.from_numpy(img), h, w,
                                               out_u8=True)
    np.testing.assert_array_equal(u8.numpy(), pallas.astype(np.uint8))


@pytest.mark.parametrize("b,h,w,c", [(3, 22, 30, 3), (2, 13, 41, 4)])
def test_tree_rgb_plain_matches_numpy(b, h, w, c):
    """The tree quantizer's byte entry (plain) == fs_dither_tree_np."""
    rng = np.random.default_rng(h * w)
    img = rng.integers(0, 256, (b, h, w, c), dtype=np.uint8)
    _, levels, leaves = median_cut_tree(img[0, ..., :3])
    got = sixel_kernel.fs_dither_tree_rgb_plain(
        torch.from_numpy(img), torch.from_numpy(levels),
        torch.from_numpy(leaves), h, w)
    np.testing.assert_array_equal(got.numpy(),
                                  fs_dither_tree_np(img, levels, leaves))


def _cube_payloads(x):
    return [encode_sixel_stream(i, cube_palette())
            for i in fs_dither_cube_np(x)]


def _tree_payloads(x, quantizer):
    palette, levels, leaves = quantizer
    return [encode_sixel_stream(i, palette)
            for i in fs_dither_tree_np(x[..., :3], levels, leaves)]


@pytest.mark.parametrize("oh,ow", [(18, 30), (24, 32)])
def test_sixel_model_cube_matches_mirrors(oh, ow):
    fr = _frames(2)
    model = models.get("sixel")(out_h=oh, out_w=ow, dither="cube")
    assert model.device == torch.device("cpu")
    assert model.render_batch(fr) == _cube_payloads(
        _mirror_resized(fr, oh, ow))


def test_sixel_model_adaptive_per_frame_matches_mirrors():
    """A tree per frame, each from that frame."""
    fr = _frames(3)
    x = _mirror_resized(fr, 18, 30, bg=(40, 80, 120, 255))
    want = [_tree_payloads(x[i:i + 1], median_cut_tree(x[i, ..., :3]))[0]
            for i in range(len(x))]
    model = models.get("sixel")(out_h=18, out_w=30, dither="adaptive",
                                bg_color=(40, 80, 120, 255))
    assert model.render_batch(fr) == want


def test_sixel_model_adaptive_reuse_and_reset_match_mirrors():
    """One tree from the first frame seen, kept across batches until
    reset_palette."""
    first, second = _frames(4), _frames(5)
    model = models.get("sixel")(out_h=24, out_w=32, dither="adaptive",
                                adaptive_reuse=True)
    x1 = _mirror_resized(first, 24, 32)
    x2 = _mirror_resized(second, 24, 32)
    tree1 = median_cut_tree(x1[0, ..., :3])
    assert model.render_batch(first) == _tree_payloads(x1, tree1)
    assert model.render_batch(second) == _tree_payloads(x2, tree1)
    model.reset_palette()
    assert model.render_batch(second) == _tree_payloads(
        x2, median_cut_tree(x2[0, ..., :3]))


@pytest.mark.parametrize("full_range", [True, False])
def test_sixel_model_yuv_matches_jax_convert_resize(full_range):
    """render_batch_yuv: the port's convert + lean resize, then the cube
    dither, == the JAX package's convert + resize (its model's own
    ``_get_yuv_jit``) through the numpy dither mirror."""
    from timg_tpu.sources.video_source import _get_yuv_jit

    rng = np.random.default_rng(6)
    y = rng.integers(16, 236, (3, 48, 64), dtype=np.uint8)
    u = rng.integers(16, 240, (3, 24, 32), dtype=np.uint8)
    v = rng.integers(16, 240, (3, 24, 32), dtype=np.uint8)
    x = np.asarray(_get_yuv_jit()(y, u, v, 22, 40, full_range))
    model = models.get("sixel")(out_h=22, out_w=40, dither="cube")
    assert model.render_batch_yuv(y, u, v, full_range) == _cube_payloads(x)


@pytest.mark.parametrize("dither,reuse", [("cube", False),
                                          ("adaptive", False),
                                          ("adaptive", True)])
def test_sixel_model_matches_jax_model(dither, reuse):
    """The JAX package's SixelModel on the CPU writes the same bytes at
    this shape (its resize and dithers run XLA:CPU, not the mirrors)."""
    import timg_tpu.models as jmodels

    fr = _frames(7)
    kw = dict(out_h=18, out_w=30, dither=dither, adaptive_reuse=reuse)
    want = jmodels.get("sixel")(**kw).render_batch(fr)
    assert models.get("sixel")(**kw).render_batch(fr) == want


def test_sixel_model_takes_tensors_and_a_device():
    fr = _frames(8, b=1)
    model = models.get("sixel")(out_h=18, out_w=30, dither="cube",
                                device="cpu")
    assert model.render_batch(torch.from_numpy(fr)) == model.render_batch(fr)


def test_registry_and_not_ported():
    assert models.available() == ["sixel"]
    assert models.get("sixel") is models.SixelModel
    for name in ("half", "quarter", "kitty", "iterm2"):
        with pytest.raises(NotImplementedError, match="not yet ported"):
            models.get(name)
    with pytest.raises(KeyError):
        models.get("nope")

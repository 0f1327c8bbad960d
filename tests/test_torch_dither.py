"""The port's libsixel and adaptive dithers against the JAX package on the
CPU: the bucket-table build, the integer table wavefront (K8) and the
median-cut tree wavefront (K7).

Every comparison is exact (the table path is integer arithmetic, the
tree path the same f32 sequence as the JAX kernel).  The JAX kernels run
in interpret mode, as tests/test_libsixel.py and tests/test_ops.py run
them; palettes come from the jax-free timg_tpu/ops/libsixel_quant.py
and the tree from timg_tpu/ops/sixel_np.py.
"""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
os.environ["TIMG_TPU_TORCH_DEVICE"] = "cpu"

import jax.numpy as jnp  # noqa: E402

from timg_tpu.ops import libsixel_quant as lsq  # noqa: E402
from timg_tpu.ops import sixel_pallas3 as jp3  # noqa: E402
from timg_tpu.ops.sixel_np import median_cut_tree  # noqa: E402
from timg_tpu_torch.ops import libsixel_kernel as tlib  # noqa: E402
from timg_tpu_torch.ops import sixel_kernel  # noqa: E402


def _rgba_words(frames_rgb):
    """[B, h, w, 3] uint8 -> [B, h, w] int32 opaque RGBA words."""
    b, h, w, _ = frames_rgb.shape
    rgba = np.concatenate(
        [frames_rgb, np.full((b, h, w, 1), 255, np.uint8)], axis=-1)
    return np.ascontiguousarray(rgba).view(np.int32).reshape(b, h, w)


def _noisy_and_flat(h, w, seed):
    """A noisy gradient (more than 256 buckets: diffuse) and a flat
    two-color pattern (few buckets: palette only), as
    tests/test_libsixel.py builds them."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w]
    noisy = np.clip(np.stack([(x * 255 // w), (y * 255 // h),
                              ((x + y) * 113) % 256], -1).astype(np.int32)
                    + rng.integers(-20, 20, (h, w, 3)), 0,
                    255).astype(np.uint8)
    flat = (np.stack([x // 14, y // 10, (x + y) // 20], -1)
            % 2 * 200).astype(np.uint8)
    return noisy, flat


# ---- bucket-table build -----------------------------------------------

def _palettes(kind, seed):
    rng = np.random.default_rng(seed)
    if kind == "random":
        return rng.integers(0, 256, (3, 256, 3)).astype(np.int32)
    if kind == "ties":
        # duplicated entries and equidistant pairs around bucket bases:
        # the first minimum must win
        base = rng.integers(0, 32, (3, 256, 3)).astype(np.int32) * 8
        base[:, 128:] = base[:, :128]
        base[:, 1::2] = np.clip(base[:, 0::2] + 8, 0, 255)
        return base
    # repeated tails: short palettes padded with their first color, as
    # the video window pads them
    pals = [rng.integers(0, 256, (n, 3)).astype(np.uint8)
            for n in (1, 17, 200)]
    return tlib.pad_palettes(pals)


@pytest.mark.parametrize("kind", ["random", "ties", "tails"])
def test_bucket_tables_match_jax_and_lsq(kind):
    pals = _palettes(kind, {"random": 1, "ties": 2, "tails": 3}[kind])
    got = tlib.build_bucket_tables(torch.from_numpy(pals))
    assert got.dtype == torch.uint8 and tuple(got.shape) == (3, 32768)
    want = np.asarray(jp3.build_bucket_tables_device(jnp.asarray(pals)))
    np.testing.assert_array_equal(got.numpy(), want)
    for i in range(3):
        np.testing.assert_array_equal(
            got[i].numpy(), lsq.build_bucket_table(pals[i].astype(np.uint8)))


def test_argmin_returns_first_minimum():
    """The plain build relies on torch.argmin picking the first of equal
    minima (libsixel's strict <)."""
    d = torch.tensor([[5, 2, 7, 2, 2], [0, 0, 0, 0, 0], [9, 8, 8, 1, 1]])
    assert d.argmin(dim=1).tolist() == [1, 0, 3]
    pals = np.zeros((1, 256, 3), np.int32)
    pals[0, :] = (40, 40, 40)
    pals[0, 7] = (0, 0, 0)
    pals[0, 9] = (0, 0, 0)
    got = tlib.build_bucket_tables_plain(torch.from_numpy(pals))
    assert int(got[0, 0]) == 7                      # black bucket: 7 not 9
    assert int(got[0, (5 << 10) | (5 << 5) | 5]) == 0   # (40,40,40): entry 0


def test_bucket_bases_match_jax():
    np.testing.assert_array_equal(tlib.bucket_bases().numpy(),
                                  jp3._bucket_bases())


# ---- K8: integer table wavefront --------------------------------------

def _table_batch(frames_rgb):
    """lsq palettes, tables and diffuse flags for each frame, in the
    JAX layout (packed) and the port's (unpacked)."""
    pals, diffs = [], []
    for f in frames_rgb:
        pal, diffuse = lsq.make_palette(f)
        pals.append(pal)
        diffs.append(bool(diffuse))
    pals256 = tlib.pad_palettes(pals)
    tables = np.stack([lsq.build_bucket_table(p) for p in pals])
    return pals, pals256, tables, np.asarray(diffs, np.int32)


def _jax_table_dither(words, tables, pals, diffs, h, w):
    tw, pw, dw = jp3.pack_libsixel_tables(tables, pals, diffs)
    return np.asarray(jp3.fs_dither_table_fused(
        jnp.asarray(words), jnp.asarray(tw), jnp.asarray(pw),
        jnp.asarray(dw), h, w, interpret=True, out_u8=True))


def _port_table_dither(words, pals256, diffs, h, w, fn=None):
    pals_t = torch.from_numpy(pals256)
    tables = tlib.build_bucket_tables(pals_t)
    fn = fn or tlib.fs_dither_table_fused
    return fn(torch.from_numpy(words), tables, tlib.palette_words(pals_t),
              torch.from_numpy(diffs), h, w).numpy()


def test_table_dither_matches_jax_and_lsq():
    """A noisy (diffuse) and a flat (diffuse = 0) frame in one batch."""
    h, w = 37, 53
    noisy, flat = _noisy_and_flat(h, w, 5)
    frames = np.stack([noisy, flat, noisy[::-1].copy()])
    pals, pals256, tables, diffs = _table_batch(frames)
    assert diffs[0] and not diffs[1]          # the batch mixes both modes
    words = _rgba_words(frames)
    want = _jax_table_dither(words, tables, pals, diffs, h, w)
    got = _port_table_dither(words, pals256, diffs, h, w)
    plain = _port_table_dither(words, pals256, diffs, h, w,
                               tlib.fs_dither_table_plain)
    assert got.dtype == np.uint8
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(plain, want)
    for i in range(3):
        spec = lsq.apply_palette_bucket_table(frames[i], tables[i], pals[i],
                                              bool(diffs[i]))
        np.testing.assert_array_equal(got[i], spec, err_msg=f"frame {i}")


def test_table_dither_bg_padded_rows():
    """23 content rows padded to 24 with an opaque bg word (h not a
    multiple of 6 before the pad), read from wider pitched words."""
    th, w = 23, 40
    padded_h = th + 5 - (th + 5) % 6
    noisy, flat = _noisy_and_flat(th, w, 7)
    bg = np.array([10, 200, 30], np.uint8)
    frames = np.empty((2, padded_h, w, 3), np.uint8)
    frames[:, th:] = bg
    frames[0, :th], frames[1, :th] = noisy, flat
    pals, pals256, tables, diffs = _table_batch(frames)
    words = np.zeros((2, padded_h + 3, w + 5), np.int32)
    words[:, :padded_h, :w] = _rgba_words(frames)
    want = _jax_table_dither(words[:, :padded_h, :w].copy(), tables, pals,
                             diffs, padded_h, w)
    got = _port_table_dither(words, pals256, diffs, padded_h, w)
    np.testing.assert_array_equal(got, want)


def test_table_plain_int32_output():
    h, w = 12, 20
    noisy, _ = _noisy_and_flat(h, w, 9)
    pals, pals256, tables, diffs = _table_batch(noisy[None])
    pals_t = torch.from_numpy(pals256)
    out = tlib.fs_dither_table_plain(
        torch.from_numpy(_rgba_words(noisy[None])),
        tlib.build_bucket_tables(pals_t), tlib.palette_words(pals_t),
        torch.from_numpy(diffs), h, w, out_u8=False)
    assert out.dtype == torch.int32
    np.testing.assert_array_equal(
        out[0].numpy(),
        lsq.apply_palette_bucket_table(noisy, tables[0], pals[0],
                                       bool(diffs[0])))


# ---- K7: median-cut tree wavefront ------------------------------------

def _jax_tree_dither(words, levels, leaves, h, w):
    return np.asarray(jp3.fs_dither_tree_fused(
        jnp.asarray(words), jnp.asarray(levels), jnp.asarray(leaves), h, w,
        interpret=True, out_u8=True))


def test_tree_dither_matches_jax():
    """30x41, as tests/test_ops.py holds the JAX kernel."""
    rng = np.random.default_rng(21)
    img = rng.integers(0, 256, (2, 30, 41, 4), dtype=np.uint8)
    img[..., 3] = 255
    _, levels, leaves = median_cut_tree(img[..., :3])
    words = img.view(np.int32).reshape(2, 30, 41)
    want = _jax_tree_dither(words, levels, leaves, 30, 41)
    got = sixel_kernel.fs_dither_tree_fused(
        torch.from_numpy(words), torch.from_numpy(levels),
        torch.from_numpy(leaves), 30, 41)
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), want)
    from timg_tpu.ops.sixel_np import fs_dither_tree_np
    wide = sixel_kernel.fs_dither_tree_plain(
        torch.from_numpy(words), torch.from_numpy(levels),
        torch.from_numpy(leaves), 30, 41, out_u8=False)
    np.testing.assert_array_equal(
        wide.numpy(), fs_dither_tree_np(img, levels, leaves))


def test_tree_dither_bg_padded_rows():
    """A tree from a smooth frame (few distinct colors, so empty and
    single-color boxes occur), 22 rows padded to 24 with a bg word,
    read from pitched words."""
    th, w = 22, 33
    padded_h = th + 5 - (th + 5) % 6
    noisy, flat = _noisy_and_flat(th, w, 11)
    frames = np.empty((2, padded_h, w, 3), np.uint8)
    frames[:, th:] = (200, 150, 255)
    frames[0, :th], frames[1, :th] = noisy, flat
    _, levels, leaves = median_cut_tree(frames[1])
    words = np.zeros((2, padded_h + 2, w + 7), np.int32)
    words[:, :padded_h, :w] = _rgba_words(frames)
    want = _jax_tree_dither(words[:, :padded_h, :w].copy(), levels, leaves,
                            padded_h, w)
    got = sixel_kernel.fs_dither_tree_fused(
        torch.from_numpy(words), torch.from_numpy(levels),
        torch.from_numpy(leaves), padded_h, w)
    np.testing.assert_array_equal(got.numpy(), want)

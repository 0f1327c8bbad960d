"""The port's block ops (timg_tpu_torch.ops.blocks, ops.diff and the
block pipelines) against the JAX package's on the CPU.

The plain PyTorch versions must be byte-equal to timg_tpu.ops.blocks
(XLA on the CPU) and to its numpy mirrors (timg_tpu.ops.cpu_mirror) on
seeded frames that reach every branch: the transparency threshold
(alphas 0x5f, 0x60, 0x61), flat cells (the ``d < 1`` exit), mirrored
cells (tied candidates), 3-pixel alpha averages that are not integers,
all-0 and all-255 frames, with ``use_upper`` both ways.  The video
window's interface (``quarter_cells`` / ``half_cells``: words in, the
odd-height pad row and the tail by position) must give the planes of
the JAX window's concatenations.
"""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
os.environ["TIMG_TPU_TORCH_DEVICE"] = "cpu"

from timg_tpu.ops import blocks as jblocks  # noqa: E402
from timg_tpu.ops import cpu_mirror  # noqa: E402
from timg_tpu.ops import diff as jdiff  # noqa: E402
from timg_tpu_torch.ops import blocks as tblocks  # noqa: E402
from timg_tpu_torch.ops import diff as tdiff  # noqa: E402
from timg_tpu_torch.ops import pipeline as tpipe  # noqa: E402

ALPHAS = np.array([0, 1, 0x5F, 0x60, 0x61, 0x80, 0xFE, 0xFF], np.uint8)


def _frames(seed, b=4, h=24, w=32):
    """Seeded RGBA frames: noise with alphas around the threshold, a flat
    block, mirrored cells, cells of three opaque pixels beside one
    transparent one, an all-0 and an all-255 frame."""
    rng = np.random.default_rng(seed)
    f = rng.integers(0, 256, (b, h, w, 4), dtype=np.uint8)
    f[..., 3] = rng.choice(ALPHAS, (b, h, w))
    f[0, :8, :8] = f[0, 0, 0]                         # flat: d = 0 < 1
    near = f[0, 8:12]
    near[...] = rng.integers(100, 103, near.shape)    # near-flat
    if b > 1:
        f[1, :, 1::2] = f[1, :, 0::2]                 # left == right
        f[1, 1::2] = f[1, 0::2][:h // 2]              # top == bottom
        f[1, :4, :, 3] = np.array([0x5F, 0x60, 0x61, 0xFF])[:h, None]
    if b > 2:                       # alpha (a + b + c) / 3 not an integer
        f[2, ::2, ::2, 3] = 0x7F
        f[2, ::2, 1::2, 3] = 0x80
        f[2, 1::2, :, 3] = 0x81
    if b > 3:
        f[3] = 0
    if b > 4:
        f[4] = 255
    return f


def _np(planes):
    return [np.asarray(p) for p in planes]


@pytest.mark.parametrize("use_upper", [False, True])
@pytest.mark.parametrize("seed,shape", [(0, (5, 24, 32)), (1, (2, 6, 10)),
                                        (2, (3, 40, 18))])
@pytest.mark.parametrize("name", ["quarter", "half"])
def test_blocks_plain_match_jax_and_mirror(name, seed, shape, use_upper):
    f = _frames(seed, *shape)
    want = _np(getattr(jblocks, f"{name}_blocks")(
        f, use_upper_half_block=use_upper))
    mirror = _np(getattr(cpu_mirror, f"{name}_blocks_np")(
        f, use_upper_half_block=use_upper))
    plain = getattr(tblocks, f"{name}_blocks_plain")
    got = [p.numpy() for p in plain(torch.from_numpy(f), use_upper)]
    dispatched = [p.numpy() for p in getattr(tblocks, f"{name}_blocks")(
        torch.from_numpy(f), use_upper_half_block=use_upper)]
    for g, d, w, m in zip(got, dispatched, want, mirror):
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(g, m)
        np.testing.assert_array_equal(d, w)


def test_frames_reach_every_glyph_and_override():
    """The seeded frames reach all nine glyphs in quarter cells and both
    the early exit and a full scan."""
    f = np.concatenate([_frames(s, 5, 24, 32) for s in range(3)])
    glyph, _, _ = _np(jblocks.quarter_blocks(f))
    assert set(np.unique(glyph)) == set(range(9))
    up, _, _ = _np(jblocks.quarter_blocks(f, use_upper_half_block=True))
    assert (up == 8).sum() > (glyph == 8).sum()


@pytest.mark.parametrize("cell_w", [1, 2])
def test_window_cell_diff_matches_jax(cell_w):
    f = _frames(3, 4, 12, 16)
    f[2] = f[1]
    f[3, :6] = f[2, :6]
    want = np.asarray(jdiff.window_cell_diff(f, cell_w))
    got = tdiff.window_cell_diff(torch.from_numpy(f), cell_w).numpy()
    assert got.dtype == np.bool_
    np.testing.assert_array_equal(got, want)
    assert got[1].all() and got[2, :3].all() and not got[0].all()


def _jax_window(f, use_upper, tail, cell_w, blocks_fn):
    """The JAX block window's own formulation on RGBA frames: the pad row
    by concatenation, the blocks, the diff against the concatenated
    tail (timg_tpu/render/plane_cache.py:599-617)."""
    import jax.numpy as jnp

    th, tw = f.shape[1:3]

    def pad(x):
        if th % 2 == 0:
            return x
        blank = np.zeros((len(x), 1, tw, 4), np.uint8)
        return np.concatenate([x, blank] if use_upper else [blank, x], 1)

    padded = pad(f)
    glyph, fg, bg = _np(blocks_fn(padded, use_upper_half_block=use_upper))
    head = np.zeros_like(padded[:1]) if tail is None else pad(tail[None])
    eq = np.asarray(jdiff.window_cell_diff(
        jnp.concatenate([head, padded]), cell_w))
    return glyph, fg, bg, eq


@pytest.mark.parametrize("use_upper", [False, True])
@pytest.mark.parametrize("th", [10, 11])
@pytest.mark.parametrize("tail", [False, True])
@pytest.mark.parametrize("name,cell_w", [("quarter", 2), ("half", 1)])
def test_cells_plain_match_the_jax_window(name, cell_w, tail, th,
                                          use_upper):
    f = _frames(th + 7 * tail, 3, th, 14)
    f[..., 3] = np.where(f[..., 3] < 0x60, 255, f[..., 3])
    f[1, : th // 2] = f[0, : th // 2]              # half the cells repeat
    prev = _frames(50, 1, th, 14)[0] if tail else None
    if tail:
        prev[th // 2:] = f[0, th // 2:]
    want = _jax_window(f, use_upper, prev, cell_w,
                       getattr(jblocks, f"{name}_blocks"))
    words = torch.from_numpy(f.view(np.int32)[..., 0].copy())
    tail_words = (torch.from_numpy(prev.view(np.int32)[..., 0].copy())
                  if tail else None)
    cells = getattr(tblocks, f"{name}_cells")
    glyph, fg, bg, eq = cells(words, use_upper, tail_words)
    assert glyph.dtype == torch.uint8 and fg.dtype == torch.int32
    np.testing.assert_array_equal(glyph.numpy(), want[0])
    np.testing.assert_array_equal(
        fg.numpy().view(np.uint8).reshape(want[1].shape), want[1])
    np.testing.assert_array_equal(
        bg.numpy().view(np.uint8).reshape(want[2].shape), want[2])
    np.testing.assert_array_equal(eq.numpy(), want[3])
    assert eq[1].any() and not eq[1].all()
    _, _, _, none = cells(words, use_upper, tail_words, diff=False)
    assert none is None


def test_odd_height_pad_row_is_transparent():
    """The blank pad row has alpha 0: in an opaque frame of odd height
    the pad row's half of the edge cells is transparent."""
    f = np.full((1, 3, 4, 4), 200, np.uint8)
    words = torch.from_numpy(f.view(np.int32)[..., 0].copy())
    glyph, fg, bg, _ = tblocks.quarter_cells(words, False)  # blank on top
    assert glyph[0, 0].tolist() == [tblocks.LOWER_BLOCK] * 2
    assert (bg[0, 0] == 0).all() and (fg[0, 0] == words[0, 0, 0]).all()
    glyph, _, bg, _ = tblocks.quarter_cells(words, True)    # at the bottom
    assert glyph[0, 1].tolist() == [tblocks.UPPER_BLOCK] * 2
    assert (bg[0, 1] == 0).all()


def test_quarter_pipeline_matches_graft_entry():
    """The flagship: __graft_entry__.entry()'s own fn on its own seeded
    [4, 240, 320, 4] input against the port's quarter_pipeline."""
    import __graft_entry__

    fn, (frames,) = __graft_entry__.entry()
    want = _np(fn(frames))
    got = tpipe.quarter_pipeline(torch.from_numpy(frames), 96, 160,
                                 bg_color=(0, 0, 0, 255))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w)


@pytest.mark.parametrize("name", ["quarter", "half"])
@pytest.mark.parametrize("bg,pattern", [(None, None),
                                        ((0, 0, 0, 255), None),
                                        ((30, 60, 90, 255),
                                         (200, 10, 10, 255))])
def test_block_pipelines_match_jax(name, bg, pattern):
    from timg_tpu.ops import pipeline as jpipe

    f = _frames(9, 2, 40, 60)
    kw = dict(bg_color=bg, pattern_color=pattern, use_upper_half_block=True)
    want = _np(getattr(jpipe, f"{name}_pipeline")(f, 18, 26, **kw))
    got = getattr(tpipe, f"{name}_pipeline")(torch.from_numpy(f), 18, 26,
                                            **kw)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w)

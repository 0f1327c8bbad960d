"""The port's CUDA kernels against their plain PyTorch versions.

Imports no jax, so it runs on a GPU machine without the JAX package:

    python -m pytest tests/test_torch_kernels.py -m cuda

Tests marked ``cuda`` need a card and skip without one; the others pin
the wrappers' CPU behaviour (plain versions only for CPU tensors).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from timg_tpu_torch.ops import blocks as tblocks  # noqa: E402
from timg_tpu_torch.ops import blocks_kernel  # noqa: E402
from timg_tpu_torch.ops import libsixel_kernel as tlib  # noqa: E402
from timg_tpu_torch.ops import libsixel_quant as lsq  # noqa: E402
from timg_tpu_torch.ops import resize as tresize  # noqa: E402
from timg_tpu_torch.ops import sixel_kernel, yuv_kernel  # noqa: E402
from timg_tpu_torch.ops import yuv as tyuv  # noqa: E402
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


def _yuv_planes(seed, b, h, w, ch=None, cw=None):
    """Seeded uint8 planes: [b, h, w] y and [b, ch, cw] u, v (by default
    ceil(h / 2) x ceil(w / 2))."""
    rng = np.random.default_rng(seed)
    ch = (h + 1) // 2 if ch is None else ch
    cw = (w + 1) // 2 if cw is None else cw
    return tuple(torch.from_numpy(rng.integers(0, 256, s, dtype=np.uint8))
                 for s in ((b, h, w), (b, ch, cw), (b, ch, cw)))


def test_cpu_tensors_take_the_plain_versions():
    y, u, v = _yuv_planes(0, 2, 9, 13)
    for full_range in (False, True):
        assert torch.equal(tyuv.yuv420_to_rgba_words(y, u, v, full_range),
                           tyuv.yuv420_to_rgba_words_plain(y, u, v,
                                                           full_range))
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
            sixel_kernel.TREE_RGB_LAUNCHES,
            yuv_kernel.LAUNCHES) == (0, 0, 0, 0, 0, 0)


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
    with pytest.raises(ValueError):
        yuv_kernel.yuv420_to_rgba_words_cuda(*_yuv_planes(4, 1, 12, 16),
                                             False)
    assert yuv_kernel.LAUNCHES == 0
    for cells in (blocks_kernel.quarter_cells_cuda,
                  blocks_kernel.half_cells_cuda):
        with pytest.raises(ValueError):
            cells(words)
    assert blocks_kernel.QUARTER_LAUNCHES == blocks_kernel.HALF_LAUNCHES == 0


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
@pytest.mark.parametrize("b,h,w,oh,ow", [
    (2, 2160, 3840, 720, 1280),   # 4K-class input (K2's domain), T = 11
    (2, 1080, 1920, 135, 240),    # 2-row tiles staged by 16-byte copies
    (3, 333, 517, 101, 203),      # ragged tiles on both axes
    (2, 40, 30, 20, 15)])         # output narrower than one tile
def test_resize_kernel_tiles_match_plain(cuda_device, b, h, w, oh, ow):
    from timg_tpu_torch.ops import resize_kernel
    words = _words(h + w, b, h, w)
    want = tresize.resize_video_words_plain(words, oh, ow)
    before = resize_kernel.LAUNCHES
    got = resize_kernel.resize_video_words_cuda(words.to(cuda_device), oh, ow)
    torch.cuda.synchronize()
    assert resize_kernel.LAUNCHES == before + 1
    assert torch.equal(got.cpu(), want)


@pytest.mark.cuda
def test_video_stage_matches_plain(cuda_device):
    """The video window's stage on the card (convert, the resize with its
    own cached tables, background rows) against the same steps on the
    CPU: convert, resize_video_words_plain, background pad."""
    from timg_tpu_torch.ops.yuv import yuv420_to_rgba_words
    from timg_tpu_torch.render.plane_cache import VideoStage
    rng = np.random.default_rng(11)
    y = torch.from_numpy(rng.integers(0, 256, (2, 270, 384), dtype=np.uint8))
    u, v = (torch.from_numpy(rng.integers(0, 256, (2, 135, 192),
                                          dtype=np.uint8)) for _ in range(2))
    bg = -(1 << 24) | 0x203040
    stage = VideoStage(135, 240, False, 138, bg)
    got = stage(y.to(cuda_device), u.to(cuda_device), v.to(cuda_device))
    words = tresize.resize_video_words_plain(
        yuv420_to_rgba_words(y, u, v, False), 135, 240)
    want = torch.cat([words, torch.full((2, 3, 240), bg, dtype=torch.int32)],
                     dim=1)
    assert torch.equal(got.cpu(), want)


# Geometries that no fused tile fits (ops/resize.py plan_tiles -> None):
# they take the two-pass kernels of csrc/resize_passes.cu.  The first
# three are horizontal-first (the pass along rows over the words, then
# the pass along columns); the fourth is vertical-first; the fifth is
# horizontal-first with rows wider than one chunk of the pass along rows
# (4,096 words), whose taps it reloads each chunk; the last has rows of
# a width that is no multiple of 4 words, which it copies a word at a
# time.
UNTILED = [(2160, 3840, 16, 28), (2160, 3840, 24, 40), (1080, 1920, 12, 20),
           (2160, 3840, 12, 28), (200, 4400, 6, 24), (1080, 1922, 12, 20)]


@pytest.mark.parametrize("h,w,oh,ow,tiled", [g + (False,) for g in UNTILED]
                         + [(1080, 1920, 16, 28, True)])
def test_tile_planner_refuses_only_untileable(h, w, oh, ow, tiled):
    assert (tresize.plan_tiles(h, w, oh, ow) is not None) == tiled


def test_untiled_pass_orders():
    assert [tresize.vertical_first(*g) for g in UNTILED] == [False] * 3 \
        + [True, False, False]


def _f32(x):
    return np.asarray(x, np.float32)


def _dot_sum(vals, taps, s):
    """The reference dot's order, a tap at a time (ops/resize.py's module
    docstring): vals [R, n] f32, taps [T] f32 -> [R] f32."""
    total = even = odd = np.zeros(vals.shape[0], np.float32)
    for t, tap in enumerate(taps):
        k = s + t
        if t > 0 and k % 32 == 0:
            total = total + (even + odd)
            even = odd = np.zeros_like(even)
        if k & 1:
            odd = odd + tap * vals[:, k]
        else:
            even = even + tap * vals[:, k]
    return total + (even + odd)


def _rows_kernel_sums(vals, taps16, dst, nb_max, starts, width):
    """resize_rows_to_mid's order, all outputs: thread (j, p) sums, for
    each slot, its 16 products of inputs 32 j + p + 2i in ascending i
    (the slot's +0 taps outside the band included, as the kernel adds
    them); the chain of output o adds each block's (even + odd) in block
    order.  -> [R, out] f32."""
    rows, n = vals.shape
    nb, _, slots, _ = taps16.shape
    padded = np.zeros((rows, 32 * nb), np.float32)
    padded[:, :n] = vals
    sums = np.zeros((rows, len(starts) * 3 * nb_max * 2), np.float32)
    for j in range(nb):
        for p in (0, 1):
            x = padded[:, 32 * j + p::2][:, :16]
            for m in range(slots):
                acc = np.zeros(rows, np.float32)
                for i in range(16):
                    acc = acc + taps16[j, p, m, i] * x[:, i]
                if dst[j, m] >= 0:
                    sums[:, dst[j, m] + p] = acc
    out = np.zeros((rows, len(starts)), np.float32)
    for o, s in enumerate(starts):
        total = np.zeros(rows, np.float32)
        for jr in range((s + width - 1) // 32 - s // 32 + 1):
            e = 2 * (3 * nb_max * o + jr)
            total = total + (sums[:, e] + sums[:, e + 1])
        out[:, o] = total
    return out


def _pass_kernel_sum(vals, taps, s):
    """resize_pass's order: a block of 32 inputs at a time, its even and
    odd products in two ascending sums, inputs outside the band skipped."""
    total = np.zeros(vals.shape[0], np.float32)
    for kb in range(s - s % 32, s + len(taps), 32):
        even = odd = np.zeros_like(total)
        for k in range(max(kb, s), min(kb + 32, s + len(taps))):
            if k & 1:
                odd = odd + taps[k - s] * vals[:, k]
            else:
                even = even + taps[k - s] * vals[:, k]
        total = total + (even + odd)
    return total


def _bits(x):
    return np.asarray(x, np.float32).view(np.uint32)


@pytest.mark.parametrize("geometry", UNTILED + [(None, 80, None, 2)])
@pytest.mark.parametrize("values", ["bytes", "bf16"])
def test_resize_passes_split_keeps_the_dot_order(geometry, values):
    """The two-pass kernels' split of each output's sum (per thread, per
    order block and parity, then the blocks in order) equals the
    reference dot's order bit for bit in f32, on every tap table of the
    untiled geometries (both axes) and on hand-made bands whose first and
    last order blocks are partial; a plain ascending sum does not, so the
    check can fail."""
    rng = np.random.default_rng(7)
    _, n_in, _, n_out = geometry
    tables = []
    if geometry[0] is None:    # bands starting mid-block, ending mid-block
        starts = torch.tensor([5, 37], dtype=torch.int32)
        taps = torch.from_numpy(rng.uniform(-0.05, 0.3, (2, 40)).astype(
            np.float32)).to(torch.bfloat16)
        tables.append((n_in, starts, taps))
    else:
        h, w, oh, ow = geometry
        tables += [(w, *tresize.axis_taps(w, ow, True)),
                   (h, *tresize.axis_taps(h, oh, False))]
    differs = 0
    for n, starts, taps in tables:
        if values == "bytes":
            vals = rng.integers(0, 256, (16, n)).astype(np.float32)
        else:
            vals = torch.from_numpy(rng.uniform(0, 255, (16, n)).astype(
                np.float32)).to(torch.bfloat16).to(torch.float32).numpy()
        taps16, dst, nb_max = tresize.slot_taps(starts, taps, n)
        assert taps16.shape[2] <= 6        # the kernel's kSlots
        tf = taps.to(torch.float32).numpy()
        width = tf.shape[1]
        rows = _rows_kernel_sums(vals, taps16.numpy(), dst.numpy(), nb_max,
                                 starts.tolist(), width)
        for o, s in enumerate(starts.tolist()):
            want = _bits(_dot_sum(vals, tf[o], s))
            assert np.array_equal(_bits(rows[:, o]), want)
            assert np.array_equal(_bits(_pass_kernel_sum(vals, tf[o], s)),
                                  want)
            ascending = np.zeros(vals.shape[0], np.float32)
            for t in range(width):
                ascending = ascending + tf[o, t] * vals[:, s + t]
            differs += int((_bits(ascending) != want).sum())
    assert differs > 0


@pytest.mark.cuda
@pytest.mark.parametrize("h,w,oh,ow", UNTILED)
def test_resize_passes_match_plain(cuda_device, h, w, oh, ow):
    from timg_tpu_torch.ops import resize_kernel
    words = _words(oh + ow, 2, h, w)
    want = tresize.resize_video_words_plain(words, oh, ow)
    before = (resize_kernel.LAUNCHES, resize_kernel.PASS_LAUNCHES)
    got = resize_kernel.resize_video_words_cuda(words.to(cuda_device), oh, ow)
    torch.cuda.synchronize()
    assert (resize_kernel.LAUNCHES, resize_kernel.PASS_LAUNCHES) == (
        before[0], before[1] + 1)
    assert torch.equal(got.cpu(), want)


# The f32 driver's band plan (csrc/fs_dither_cube.cu, planned by
# sixel_kernel.plan_bands) at the batch sizes of the main paths.
@pytest.mark.parametrize("b", [1, 8, 32])
@pytest.mark.parametrize("h", [1, 31, 720, 726, 1100, 4096])
def test_band_plan_covers_rows_in_ticket_order(b, h):
    sms = 132
    plan = sixel_kernel.plan_bands(b, h, sms)
    rows = plan.warps * sixel_kernel.ROWS_PER_WARP
    # every row in exactly one band, and no band empty
    owner = [y // rows for y in range(h)]
    assert sorted(set(owner)) == list(range(plan.bands))
    assert (plan.bands - 1) * rows < h <= plan.bands * rows
    # the block fits the SM's registers at the driver's launch bounds
    assert 1 <= plan.warps <= sixel_kernel.MAX_WARPS
    assert plan.warps * 32 * sixel_kernel.REGISTERS_PER_THREAD \
        <= sixel_kernel.REGISTERS_PER_SM
    # tickets: one block for each (frame, band), and every band's ticket
    # comes after the band above it in the same frame
    tickets = {sixel_kernel.ticket_band(t, b): t
               for t in range(b * plan.bands)}
    assert set(tickets) == {(f, j) for f in range(b)
                            for j in range(plan.bands)}
    assert all(tickets[f, j - 1] < tickets[f, j]
               for f in range(b) for j in range(1, plan.bands))
    # blocks of MIN_WARPS warps where the frame has that many, more where
    # the batch would otherwise leave SMs idle
    n_warps = -(-h // 32)
    assert plan.warps >= min(n_warps, sixel_kernel.MIN_WARPS)
    assert plan.bands <= max(1, sms // b) \
        or plan.warps == sixel_kernel.MAX_WARPS
    assert 2 * plan.bands >= min(sms // b,
                                 -(-n_warps // sixel_kernel.MIN_WARPS))
    # the band edges' carry arrays hold every step a warp runs: to its
    # last row at x = w, rounded up to a pair of chunks
    for w in (1, 1280):
        assert sixel_kernel.edge_len(h, w) >= \
            2 * (h - 1) + w + 1 + 2 * sixel_kernel.CHUNK


# K8 (the bucket table and its palette in every block's shared memory)
# on the driver's band plan at the batches and heights the main paths
# launch: a block fits the SM's shared memory and registers.
@pytest.mark.parametrize("b", [1, 8, 32])
@pytest.mark.parametrize("h", [1, 31, 720, 726, 4096])
def test_table_band_plan_fits_the_sm(b, h):
    plan = sixel_kernel.plan_bands(b, h, 132)
    smem = sixel_kernel.block_smem_bytes("table", plan.warps)
    assert smem == (1 << 15) + 4 * 256 + plan.warps * (64 * 32 + 4)
    assert smem <= sixel_kernel.SMEM_PER_BLOCK
    assert plan.warps * 32 * sixel_kernel.REGISTERS_PER_THREAD \
        <= sixel_kernel.REGISTERS_PER_SM
    # the f32 quantizers' blocks stay under the 48 KB default
    for quant in ("cube", "tree"):
        assert sixel_kernel.block_smem_bytes(quant, sixel_kernel.MAX_WARPS) \
            <= 48 * 1024


# The f32 driver at warp and band edges: 31-33 and 65 rows (a partial
# warp, one full warp, one row over, two warps and a row) at 1, 3 and 70
# columns; warps that share a block's ring (B=32 and B=64 plan 2 and 5
# warps a block); and every band edge of a full frame at B=1.
DRIVER_EDGES = [(2, h, w) for h in (31, 32, 33, 65) for w in (1, 3, 70)] \
    + [(32, 130, 50), (64, 300, 20), (1, 720, 1280)]


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,w", [(2, 18, 25), (3, 130, 200), (2, 1100, 40),
                                   (1, 4096, 8)] + DRIVER_EDGES)
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


BUCKET_PALETTES = ["random", "ties", "tails", "zeros", "full"]
INT32 = np.iinfo(np.int32)


def _bucket_palettes(kind, b, seed):
    """[b, 256, 3] int32 palettes: random; tie-heavy (duplicated entries
    and equidistant pairs around bucket bases); short ones padded with
    their first color, as the video window pads them; all 0; all 255."""
    rng = np.random.default_rng(seed)
    if kind == "random":
        return rng.integers(0, 256, (b, 256, 3)).astype(np.int32)
    if kind == "ties":
        pals = rng.integers(0, 32, (b, 256, 3)).astype(np.int32) * 8
        pals[:, 128:] = pals[:, :128]
        pals[:, 1::2] = np.clip(pals[:, 0::2] + 8, 0, 255)
        return pals
    if kind == "tails":
        return tlib.pad_palettes([
            rng.integers(0, 256, ((1, 17, 200)[i % 3], 3)).astype(np.uint8)
            for i in range(b)])
    return np.full((b, 256, 3), 0 if kind == "zeros" else 255, np.int32)


def _packed_bucket_table(pal, split):
    """numpy emulation of csrc/bucket_tables.cu on one [256, 3] palette:
    per (r5, g5) row and split lane, the min over the lane's entries of
    v = 256 |p|^2 + i - 4096 (r5 pr + g5 pg + b5 pb) for b5 = 0..31;
    then the lanes' reduce-scatter (at each stage the lane with the
    stage's bit keeps the upper half) and each lane's keys written at its
    offset.  Asserts that every packed value fits int32."""
    p = pal.astype(np.int64)
    ent = np.stack([(p * p).sum(1) * 256 + np.arange(256), -4096 * p[:, 0],
                    -4096 * p[:, 1], -4096 * p[:, 2]], 1)
    rows = np.arange(1024)
    r5, g5, b5 = rows[:, None] >> 5, rows[:, None] & 31, np.arange(32)
    m = []
    for part in range(split):
        e = ent[part::split]
        base = e[None, :, 0] + r5 * e[None, :, 1] + g5 * e[None, :, 2]
        packed = base[:, None, :] + b5[None, :, None] * e[None, None, :, 3]
        assert INT32.min <= packed.min() and packed.max() <= INT32.max
        m.append(packed.min(axis=2))                      # [1024, 32]
    first = [0] * split
    half, bit = 16, 1
    while bit < split:
        kept = []
        for part in range(split):
            hi = (part & bit) != 0
            cut = slice(half, 2 * half) if hi else slice(0, half)
            kept.append(np.minimum(m[part][:, cut], m[part ^ bit][:, cut]))
            first[part] += half if hi else 0
        m, half, bit = kept, half // 2, bit * 2
    out = np.zeros((1024, 32), np.int64)
    written = np.zeros((1024, 32), bool)
    for part in range(split):
        keys = slice(first[part], first[part] + 32 // split)
        assert not written[:, keys].any()
        out[:, keys], written[:, keys] = m[part], True
    assert written.all()
    return (out & 0xFF).astype(np.uint8).reshape(-1)


@pytest.mark.parametrize("split", [1, 2, 4, 8])
@pytest.mark.parametrize("kind", BUCKET_PALETTES)
def test_packed_bucket_min_matches_spec(kind, split):
    """The kernel's exact separable form, emulated in numpy, equals
    libsixel's bucket table (integer distances, first minimum) with the
    palette split over 1, 2, 4 (the kernel's) and 8 lanes."""
    for pal in _bucket_palettes(kind, 2, BUCKET_PALETTES.index(kind)):
        np.testing.assert_array_equal(_packed_bucket_table(pal, split),
                                      lsq.build_bucket_table(pal))


@pytest.mark.cuda
@pytest.mark.parametrize("b", [1, 8, 32])
@pytest.mark.parametrize("kind", BUCKET_PALETTES)
def test_bucket_kernel_palettes_match_plain(cuda_device, kind, b):
    pals = torch.from_numpy(_bucket_palettes(kind, b, b))
    want = tlib.build_bucket_tables_plain(pals)
    before = tlib.BUCKET_LAUNCHES
    got = tlib.build_bucket_tables_cuda(pals.to(cuda_device))
    torch.cuda.synchronize()
    assert tlib.BUCKET_LAUNCHES == before + 1
    assert torch.equal(got.cpu(), want)


_BT601 = {False: (76309, 104597, 25675, 53279, 132201, 16),
          True: (65536, 91881, 22554, 46802, 116130, 0)}


def _convert_threads(y, u, v, full_range):
    """numpy emulation of csrc/yuv420.cu: each thread's 8 words of a row
    from the 6 chroma columns j0 - 1 .. j0 + 4 it reads (clamped to the
    planes' own edges), the vertical stage once a column, then per pixel
    the horizontal stage and BT.601, all int32."""
    cy, crv, cgu, cgv, cbu, y0 = _BT601[full_range]
    y, u, v = (np.asarray(t).astype(np.int32) for t in (y, u, v))
    b, h, w = y.shape
    ch, cw = u.shape[1:]
    r = np.arange(h) >> 1
    rn = np.where(np.arange(h) & 1, np.minimum(r + 1, ch - 1),
                  np.maximum(r - 1, 0))

    def fin(x):
        return np.clip((x + 32768) >> 16, 0, 255)

    out = np.zeros((b, h, w), np.int32)
    for x0 in range(0, w, 8):
        cols = np.clip(x0 // 2 - 1 + np.arange(6), 0, cw - 1)
        cu, cv = ((3 * c[:, r][:, :, cols] + c[:, rn][:, :, cols] + 2) >> 2
                  for c in (u, v))                          # [b, h, 6]
        for k in range(min(8, w - x0)):
            c = k // 2 + 1
            nb = c + 1 if k & 1 else c - 1
            d = ((3 * cu[..., c] + cu[..., nb] + 2) >> 2) - 128
            e = ((3 * cv[..., c] + cv[..., nb] + 2) >> 2) - 128
            yc = cy * (y[:, :, x0 + k] - y0)
            out[:, :, x0 + k] = (fin(yc + crv * e)
                                 | fin(yc - cgu * d - cgv * e) << 8
                                 | fin(yc + cbu * d) << 16 | -(1 << 24))
    return out


# (b, h, w, ch, cw): chroma None is ceil(h / 2) x ceil(w / 2); the last
# two have chroma planes larger than that (the upsample clamps at the
# planes' own edges, then keeps h x w).
CONVERT_CPU = [(1, 1, 1, None, None), (2, 2, 3, None, None),
               (1, 3, 2, None, None), (2, 9, 13, None, None),
               (1, 1079, 1919, None, None), (2, 16, 24, None, None),
               (2, 7, 9, 6, 8), (1, 10, 17, 9, 12)]


@pytest.mark.parametrize("full_range", [False, True])
@pytest.mark.parametrize("b,h,w,ch,cw", CONVERT_CPU)
def test_convert_threads_match_plain(b, h, w, ch, cw, full_range):
    y, u, v = _yuv_planes(h * w, b, h, w, ch, cw)
    np.testing.assert_array_equal(
        _convert_threads(y, u, v, full_range),
        tyuv.yuv420_to_rgba_words_plain(y, u, v, full_range).numpy())


def test_convert_refuses_chroma_too_small():
    y, u, v = _yuv_planes(5, 1, 8, 8, 3, 4)
    with pytest.raises(RuntimeError):   # the plain chain cannot narrow
        tyuv.yuv420_to_rgba_words_plain(y, u, v, False)


@pytest.mark.cuda
@pytest.mark.parametrize("full_range", [False, True])
@pytest.mark.parametrize("b,h,w,ch,cw", [
    (2, 1080, 1920, None, None), (3, 1079, 1919, None, None),
    (1, 1, 1, None, None), (2, 2, 3, None, None), (1, 3, 2, None, None),
    (2, 2160, 3840, None, None), (2, 7, 9, 6, 8), (1, 33, 45, 20, 30)])
def test_convert_kernel_matches_plain(cuda_device, b, h, w, ch, cw,
                                      full_range):
    y, u, v = _yuv_planes(h + w, b, h, w, ch, cw)
    want = tyuv.yuv420_to_rgba_words_plain(y, u, v, full_range)
    before = yuv_kernel.LAUNCHES
    got = tyuv.yuv420_to_rgba_words(y.to(cuda_device), u.to(cuda_device),
                                    v.to(cuda_device), full_range)
    torch.cuda.synchronize()
    assert yuv_kernel.LAUNCHES == before + 1
    assert torch.equal(got.cpu(), want)


@pytest.mark.cuda
def test_convert_kernel_reads_noncontiguous_planes(cuda_device):
    """Planes cut from larger ones (strided rows; transposed) and planes
    that start at no multiple of 8 bytes (a contiguous cut of frames, so
    the kernel reads them in place) give the plain version's words."""
    y, u, v = _yuv_planes(6, 3, 40, 64, 24, 40)
    cuts = [(y[1:, 3:30, 5:52], u[1:, 2:16, 3:27], v[1:, :14, 1:25]),
            (_yuv_planes(7, 2, 30, 20)[0].transpose(1, 2),
             *(t.transpose(1, 2) for t in _yuv_planes(8, 2, 30, 20)[1:])),
            _yuv_planes(9, 3, 27, 47)]
    cuts[2] = tuple(t[1:] for t in cuts[2])
    for full_range, (y, u, v) in zip((False, True, False), cuts):
        want = tyuv.yuv420_to_rgba_words_plain(y, u, v, full_range)
        got = yuv_kernel.yuv420_to_rgba_words_cuda(
            y.to(cuda_device), u.to(cuda_device), v.to(cuda_device),
            full_range)
        torch.cuda.synchronize()
        assert torch.equal(got.cpu(), want)


# K8 on the shared driver: its own shapes, with libsixel's palettes and
# tables (the last frame flat, with diffuse flag 0: a palette-only frame
# in the launch of diffusing ones); and the driver's warp and band edges
# (DRIVER_EDGES) with random tables and palettes, so that large offsets
# cross every edge, every frame diffusing but a last palette-only one
# where the batch has more than one.
@pytest.mark.cuda
@pytest.mark.parametrize("b,h,w,random", [(3, 18, 25, False),
                                          (2, 130, 200, False),
                                          (2, 1100, 40, False),
                                          (1, 4096, 8, False)]
                         + [e + (True,) for e in DRIVER_EDGES])
def test_table_kernel_matches_plain(cuda_device, b, h, w, random):
    words = _words(h + 1, b, h, w)
    if random:
        rng = np.random.default_rng(h * w + b)
        tables = torch.from_numpy(rng.integers(0, 256, (b, tlib.N_BUCKETS),
                                               dtype=np.uint8))
        palw = tlib.palette_words(torch.from_numpy(
            rng.integers(0, 256, (b, 256, 3), dtype=np.int32)))
        diffs = torch.ones(b, dtype=torch.int32)
        diffs[-1] = int(b == 1)                      # palette only
    else:
        smooth = torch.full((h, w), 0x00204060, dtype=torch.int32)
        words[-1] = smooth | -(1 << 24)              # one flat frame
        pals, palw, diffs = _libsixel_inputs(words)
        diffs[-1] = 0                                # palette only
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
                                   (1, 4096, 8)] + DRIVER_EDGES)
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
# the driver's warp and band edges (DRIVER_EDGES) on bytes
RGB_EDGES = [(b, h, w, 3) for b, h, w in DRIVER_EDGES[:-1]] \
    + [(1, 720, 1280, 4)]


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,w,c", RGB_SHAPES + RGB_EDGES)
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
@pytest.mark.parametrize("b,h,w,c", RGB_SHAPES + RGB_EDGES)
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


# ---- block cells (csrc/block_cells.cu) ------------------------------------

def _block_words(seed, b, th, tw):
    """Seeded RGBA words for the block cells: noise with alphas around the
    transparency threshold, flat and mirrored cells, a repeated region
    (so the window diff finds equal cells) and alpha-0 and alpha-255
    runs."""
    rng = np.random.default_rng(seed)
    img = rng.integers(0, 256, (b, th, tw, 4), dtype=np.uint8)
    img[..., 3] = rng.choice(np.array([0, 0x5F, 0x60, 0x61, 0x80, 255],
                                      np.uint8), (b, th, tw))
    img[0, :4, :4] = img[0, 0, 0]
    img[:, :, 1::2] = np.where(rng.random((b, th, 1, 1)) < 0.3,
                               img[:, :, 0::2][:, :, :tw // 2],
                               img[:, :, 1::2])
    if b > 1:
        img[1, : th // 2] = img[0, : th // 2]
    return torch.from_numpy(img.view(np.int32)[..., 0].copy())


F32 = np.float32


def _fma32(a, b, c):
    """fmaf on float32 arrays: a * b + c rounded once.  a * b is exact in
    float64; TwoSum gives the error of the float64 sum, which settles a
    sum that lands on a float32 midpoint."""
    p = np.asarray(a, np.float64) * np.asarray(b, np.float64)
    c = np.asarray(c, np.float64)
    s = p + c
    bb = s - p
    err = (p - (s - bb)) + (c - bb)
    y = s.astype(F32)
    up = np.nextafter(y, F32(np.inf))
    down = np.nextafter(y, F32(-np.inf))
    y = np.where((s == (y + up.astype(np.float64)) / 2) & (err > 0), up, y)
    return np.where((s == (y + down.astype(np.float64)) / 2) & (err < 0),
                    down, y)


def _div_n(s, n):
    """block_cells.cu div_n: s * (1/n), corrected once by the residual."""
    n = np.asarray(n).astype(F32)
    inv = F32(1) / n
    q = s * inv
    return _fma32(_fma32(-q, n, s), inv, q)


def _root(v, approx):
    """block_cells.cu root with ``approx`` as its approximate root of v:
    the nearest integer, less one where its square exceeds v, then
    clamped to 255."""
    k = np.rint(approx).astype(F32)
    k = np.where(k * k > v, k - F32(1), k)
    return np.minimum(k, F32(255)).astype(np.uint8)


def _repack_lattice():
    """Every value the repack's root is fed: a pixel's square, m * 0.5,
    m * 0.25 and rn(m / 3) of the integer sums m of 2, 4 and 3 squares."""
    return np.unique(np.concatenate([
        (np.arange(256) ** 2).astype(F32),
        np.arange(2 * 65025 + 1).astype(F32) * F32(0.5),
        np.arange(4 * 65025 + 1).astype(F32) * F32(0.25),
        np.arange(3 * 65025 + 1).astype(F32) / F32(3)]))


@pytest.mark.parametrize("n", [1, 2, 3, 4])
def test_block_kernel_division_is_exact_on_every_sum(n):
    """div_n equals the correctly rounded division on every integer sum
    of n squares of bytes (0..195,075 for n = 3; alpha sums are within
    it), where the reciprocal product alone is off for a third of the
    sums of three."""
    s = np.arange(n * 65025 + 1).astype(F32)
    want = s / F32(n)
    np.testing.assert_array_equal(_div_n(s, n), want)
    if n == 3:
        assert int((s * (F32(1) / F32(3)) != want).sum()) == 65024


@pytest.mark.parametrize("approx", ["exact", "low", "high", "-0.49",
                                    "+0.49"])
def test_block_kernel_root_is_exact_on_the_repack_lattice(approx):
    """root equals (uint8)min(sqrtf(v), 255) on all 390,151 values the
    repack takes, with its approximate root exact, off by 2^-10 of
    itself either way, or off by 0.49."""
    v = _repack_lattice()
    assert len(v) == 390151
    want = np.minimum(np.sqrt(v), F32(255)).astype(np.uint8)
    s = np.sqrt(v.astype(np.float64))
    s = {"exact": s, "low": s * (1 - 2.0 ** -10),
         "high": s * (1 + 2.0 ** -10), "-0.49": s - 0.49,
         "+0.49": s + 0.49}[approx]
    np.testing.assert_array_equal(_root(v, s), want)


@pytest.mark.parametrize("shift", [0, 1, 5, 13])
def test_plain_repack_root_is_exact_on_the_repack_lattice(shift):
    """The plain version's repack takes every value of the lattice to
    (uint8)min(sqrtf(v), 255), wherever the value sits in the tensor (the
    lattice rolled by ``shift``, beside alphas, as the plain version
    lays out its colors)."""
    v = np.roll(_repack_lattice(), shift)
    want = np.minimum(np.sqrt(v), F32(255)).astype(np.uint8)
    lin = np.zeros((len(v), 4), F32)
    lin[:, 0] = v
    lin[:, 3] = 255
    got = tblocks._repack(torch.from_numpy(lin)).numpy()
    np.testing.assert_array_equal(got[:, 0], want)


@pytest.mark.cuda
def test_plain_repack_root_is_exact_on_the_card(cuda_device):
    """The plain version's repack on CUDA tensors, on the whole lattice."""
    v = _repack_lattice()
    lin = torch.zeros((len(v), 4), dtype=torch.float32)
    lin[:, 0] = torch.from_numpy(v)
    got = tblocks._repack(lin.to(cuda_device)).cpu().numpy()
    np.testing.assert_array_equal(
        got[:, 0], np.minimum(np.sqrt(v), F32(255)).astype(np.uint8))


def _sq3(d):
    return (d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1]) \
        + d[..., 2] * d[..., 2]


def test_block_kernel_pair_cost_equals_the_reference_avd():
    """pair_cost's (sq3(x - y) + sq3(z - w)) * 0.5 equals the
    reference's avd2(x, y) + avd2(z, w) (the distances to each pair's
    average, framebuffer.h:177-194) bit for bit, on seeded linear colors
    and on near-equal pairs."""
    rng = np.random.default_rng(7)
    n = 400_000
    x, y, z, w = ((rng.integers(0, 256, (n, 3)) ** 2).astype(F32)
                  for _ in range(4))
    near = np.clip(np.sqrt(x).astype(int)
                   + rng.integers(-2, 3, (n, 3)), 0, 255)
    y[: n // 2] = (near[: n // 2] ** 2).astype(F32)

    def avd2(a, b):
        m = (a + b) * F32(0.5)
        return _sq3(a - m) + _sq3(b - m)

    want = avd2(x, y) + avd2(z, w)
    got = (_sq3(x - y) + _sq3(z - w)) * F32(0.5)
    np.testing.assert_array_equal(got, want)


# the pixels each quarter candidate's fg averages (block_cells.cu
# kFgMasks: tl 1, tr 2, bl 4, br 8), candidate 7 with use_upper last
FG_MASKS = np.array([15, 1, 2, 4, 8, 5, 9, 12, 3])


def _cell_pixels(w, top, cw):
    """[b, th, tw, 4] bytes -> each cell's [b, h2, tw / cw, 2 * cw, 4]
    pixels (tl, tr, bl, br or top, bottom) read by index, as the kernel
    reads them: row 2 * r + dy - top of the words, blank outside."""
    b, th, tw, _ = w.shape
    h2 = (th + 1) // 2
    rows = 2 * np.arange(h2)[:, None] + np.arange(2)[None, :] - top
    inside = (rows >= 0) & (rows < th)
    px = np.where(inside[None, :, :, None, None],
                  w[:, np.clip(rows, 0, th - 1)], 0)
    px = px.reshape(b, h2, 2, tw // cw, cw, 4).transpose(0, 1, 3, 2, 4, 5)
    return px.reshape(b, h2, tw // cw, 2 * cw, 4)


def _emulate_quarter(px, use_upper):
    """The quarter kernel's per-thread algorithm in numpy float32 over
    all cells at once: the exact sums, the costs by its routines, the
    lazy scan (a cell stops taking candidates where the kernel's thread
    stops computing them; none where an override decides), the chosen
    candidate's colors from its mask, the overrides.  Returns (glyph,
    fg, bg, depth), depth the candidates each cell computed."""
    f = px.astype(F32)
    lin = np.concatenate([f[..., :3] * f[..., :3], f[..., 3:]], axis=-1)
    tl, tr, bl, br = (lin[..., j, :] for j in range(4))
    total = ((tl + tr) + bl) + br

    def avd(m, *vs):
        acc = _sq3(vs[0][..., :3] - m[..., :3])
        for v in vs[1:]:
            acc = acc + _sq3(v[..., :3] - m[..., :3])
        return acc

    def pair(x, y):
        return _sq3(x[..., :3] - y[..., :3])

    costs = [
        lambda: avd(total * F32(0.25), tl, tr, bl, br),
        lambda: avd(_div_n(total - tl, 3), tr, bl, br),
        lambda: avd(_div_n(total - tr, 3), tl, bl, br),
        lambda: avd(_div_n(total - bl, 3), tl, tr, br),
        lambda: avd(_div_n(total - br, 3), tl, tr, bl),
        lambda: (pair(tr, br) + pair(tl, bl)) * F32(0.5),
        lambda: (pair(tr, bl) + pair(tl, br)) * F32(0.5),
        lambda: (pair(tl, tr) + pair(bl, br)) * F32(0.5)]
    clear = px[..., 3] >= 0x60
    top_t = ~clear[..., 0] & ~clear[..., 1]
    bot_t = ~clear[..., 2] & ~clear[..., 3]
    best = np.full(top_t.shape, 1e12, F32)
    chosen = np.zeros(top_t.shape, np.int64)
    depth = np.zeros(top_t.shape, np.int64)
    stopped = top_t | bot_t
    for k, cost_of in enumerate(costs):
        live = ~stopped
        depth += live
        cost = cost_of()
        better = live & (cost < best)
        best = np.where(better, cost, best)
        chosen = np.where(better, k, chosen)
        stopped |= better & (cost < 1)

    upper = 8 if use_upper else 7
    glyph = np.where(chosen == 7, upper, chosen)
    fm = FG_MASKS[np.where((chosen == 7) & use_upper, 8, chosen)]
    glyph = np.where(bot_t, 8, glyph)
    fm = np.where(bot_t, 3, fm)
    glyph = np.where(top_t, 7, glyph)
    fm = np.where(top_t, 12, fm)
    bits = (fm[..., None] >> np.arange(4)) & 1
    fg_sum = np.zeros_like(tl)
    for j in range(4):
        fg_sum = fg_sum + np.where(bits[..., j, None] == 1, lin[..., j, :],
                                   F32(0))
    fn = bits.sum(-1)

    def repack(s, n):
        v = _div_n(s, n[..., None])
        rgb = _root(v[..., :3], np.sqrt(v[..., :3].astype(np.float64)))
        return np.concatenate([rgb, v[..., 3:].astype(np.uint8)], -1)

    fg = repack(fg_sum, fn)
    bg = np.where((fn == 4)[..., None], fg,
                  repack(total - fg_sum, np.maximum(4 - fn, 1)))
    bg = np.where(bot_t[..., None], px[..., 2, :], bg)
    bg = np.where(top_t[..., None], px[..., 0, :], bg)
    both = top_t & bot_t
    glyph = np.where(both, 0, glyph)
    fg = np.where(both[..., None], px[..., 2, :], fg)
    return glyph.astype(np.uint8), fg, bg, depth


def _emulate_cells(words, use_upper, prev, quarter):
    """The block kernel's per-thread algorithm in numpy, over all cells:
    the pad row and the tail by index, the quarter cells as
    ``_emulate_quarter``, the half cells' raw pixels, the diff.  Returns
    (glyph, fg, bg, eq, depth), depth None for half cells."""
    w = words.numpy().view(np.uint8).reshape(words.shape + (4,))
    b, th, tw, _ = w.shape
    top = 1 if (th % 2 and not use_upper) else 0
    cw = 2 if quarter else 1
    px = _cell_pixels(w, top, cw)
    head = (prev.numpy().view(np.uint8).reshape((1,) + prev.shape + (4,))
            if prev is not None else np.zeros_like(w[:1]))
    before = _cell_pixels(np.concatenate([head, w[:-1]]), top, cw)
    eq = (px == before).all(axis=(-1, -2))
    if quarter:
        glyph, fg, bg, depth = _emulate_quarter(px, use_upper)
        return glyph, fg, bg, eq, depth
    t, u = px[..., 0, :], px[..., 1, :]
    is_bg = (t == u).all(-1) | ((t[..., 3] < 0x60) & (u[..., 3] < 0x60))
    glyph = np.where(is_bg, 0, 8 if use_upper else 7).astype(np.uint8)
    first = (is_bg | use_upper)[..., None]
    return glyph, np.where(first, t, u), np.where(first, u, t), eq, None


def _check_emulation(words, prev, use_upper, quarter):
    cells = (tblocks.quarter_cells_plain if quarter
             else tblocks.half_cells_plain)
    want = cells(words, use_upper, prev)
    got = _emulate_cells(words, use_upper, prev, quarter)
    np.testing.assert_array_equal(got[0], want[0].numpy())
    np.testing.assert_array_equal(
        got[1], want[1].numpy().view(np.uint8).reshape(got[1].shape))
    np.testing.assert_array_equal(
        got[2], want[2].numpy().view(np.uint8).reshape(got[2].shape))
    np.testing.assert_array_equal(got[3], want[3].numpy())
    return got[4]


@pytest.mark.parametrize("quarter", [True, False])
@pytest.mark.parametrize("use_upper", [False, True])
@pytest.mark.parametrize("th,tail", [(8, False), (7, True), (9, False)])
def test_block_kernel_algorithm_matches_plain(quarter, use_upper, th, tail):
    """The kernel's per-thread formulation (exact sums, pair costs, /3
    and root by their routines, the lazy scan, the chosen candidate's
    colors from its mask, pad row and tail by index) emulated in numpy
    float32 equals the plain vectorized version."""
    words = _block_words(th, 2, th, 10)
    prev = _block_words(th + 1, 1, th, 10)[0] if tail else None
    if tail:
        prev[: th // 2] = words[0, : th // 2]
    _check_emulation(words, prev, use_upper, quarter)


def _window(kind, seed, b, th, tw):
    """An opaque window of [b, th, tw] words: "flat" one color (every
    quarter cell stops at candidate 0), "noise" uniform bytes (no cell
    stops early)."""
    rng = np.random.default_rng(seed)
    if kind == "flat":
        img = np.empty((b, th, tw, 4), np.uint8)
        img[...] = rng.integers(0, 256, 4, dtype=np.uint8)
    else:
        img = rng.integers(0, 256, (b, th, tw, 4), dtype=np.uint8)
    img[..., 3] = 255
    return torch.from_numpy(img.view(np.int32)[..., 0].copy())


@pytest.mark.parametrize("quarter", [True, False])
@pytest.mark.parametrize("kind", ["flat", "noise"])
def test_block_kernel_algorithm_on_flat_and_noise(kind, quarter):
    """The emulation on a flat and a noise window (odd height, with a
    tail): equal to the plain version, and the lazy scan computes one
    candidate a flat cell and all 8 a noise cell."""
    words = _window(kind, 3, 2, 15, 24)
    prev = _window(kind, 4, 1, 15, 24)[0]
    depth = _check_emulation(words, prev, False, quarter)
    if quarter:   # the odd height's blank top row overrides its cells
        assert (depth[:, 0] == 0).all()
        assert (depth[:, 1:] == (1 if kind == "flat" else 8)).all()


@pytest.mark.parametrize("diff", [True, False])
def test_cell_outputs_share_one_buffer(diff):
    """The kernel's outputs are views of one buffer with the plain
    version's shapes and dtypes, fg and bg 4-byte aligned; cells_to_host
    gives what a fetch of each gives."""
    shape = (3, 5, 7)
    glyph, fg, bg, eq = blocks_kernel.cell_outputs(shape, diff,
                                                   torch.device("cpu"))
    parts = [glyph, fg, bg] + ([eq] if diff else [])
    assert [t.dtype for t in parts] == [torch.uint8, torch.int32,
                                        torch.int32, torch.bool][:len(parts)]
    assert all(t.shape == shape and t.is_contiguous() for t in parts)
    assert (eq is None) == (not diff)
    assert fg.data_ptr() % 4 == 0 and bg.data_ptr() % 4 == 0
    storage = glyph.untyped_storage()
    assert storage.nbytes() == (1052 if diff else 948)
    assert all(t.untyped_storage().data_ptr() == storage.data_ptr()
               for t in parts)
    rng = np.random.default_rng(5)
    for t in parts:
        t.view(torch.uint8).copy_(torch.from_numpy(rng.integers(
            0, 2 if t.dtype == torch.bool else 256,
            t.view(torch.uint8).shape, dtype=np.uint8)))
    got = tblocks.cells_to_host((glyph, fg, bg, eq))
    want = (glyph.numpy(), fg.numpy().view(np.uint8).reshape(shape + (4,)),
            bg.numpy().view(np.uint8).reshape(shape + (4,)),
            eq.numpy() if diff else None)
    for g, w in zip(got, want):
        if w is None:
            assert g is None
        else:
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)


@pytest.mark.cuda
@pytest.mark.parametrize("b,th,tw", [(3, 20, 30), (2, 21, 30), (4, 17, 26),
                                     (1, 1, 2), (2, 720, 1280),
                                     (2, 361, 640)])
@pytest.mark.parametrize("use_upper", [False, True])
@pytest.mark.parametrize("quarter", [True, False])
def test_block_kernel_matches_plain(cuda_device, b, th, tw, use_upper,
                                    quarter):
    """quarter_cells / half_cells on the card, byte-equal to their plain
    versions, with and without the tail and the diff."""
    words = _block_words(th * tw + b, b, th, tw)
    prev = _block_words(th + tw, 1, th, tw)[0]
    prev[: th // 2] = words[-1, : th // 2]
    kern = (blocks_kernel.quarter_cells_cuda if quarter
            else blocks_kernel.half_cells_cuda)
    plain = (tblocks.quarter_cells_plain if quarter
             else tblocks.half_cells_plain)
    for tail in (None, prev):
        for diff in (True, False):
            got = kern(words.to(cuda_device), use_upper,
                       tail.to(cuda_device) if tail is not None else None,
                       diff)
            torch.cuda.synchronize()
            want = plain(words, use_upper, tail, diff)
            assert (got[3] is None) == (want[3] is None) == (not diff)
            for g, w in zip(got, want):
                if w is not None:
                    assert g.dtype == w.dtype and torch.equal(g.cpu(), w)


@pytest.mark.cuda
def test_block_kernel_reads_unaligned_and_counts(cuda_device):
    """A window whose words start at an odd word (a view) is copied, not
    misread; each call counts one launch; the frame-batch interface
    (quarter_blocks / half_blocks) launches the same kernel."""
    words = _block_words(5, 3, 12, 18).to(cuda_device)
    flat = torch.cat([torch.zeros(1, dtype=torch.int32, device=cuda_device),
                      words.reshape(-1)])
    view = flat[1:].view(3, 12, 18)
    assert view.data_ptr() % 8
    n0 = blocks_kernel.QUARTER_LAUNCHES
    got = blocks_kernel.quarter_cells_cuda(view)
    assert blocks_kernel.QUARTER_LAUNCHES == n0 + 1
    want = tblocks.quarter_cells_plain(words.cpu())
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)
    frames = words.view(torch.uint8).reshape(3, 12, 18, 4)
    h0 = blocks_kernel.HALF_LAUNCHES
    for fn, plain in ((tblocks.quarter_blocks, tblocks.quarter_blocks_plain),
                      (tblocks.half_blocks, tblocks.half_blocks_plain)):
        for g, w in zip(fn(frames), plain(frames.cpu())):
            assert g.dtype == w.dtype and torch.equal(g.cpu(), w)
    assert blocks_kernel.QUARTER_LAUNCHES == n0 + 2
    assert blocks_kernel.HALF_LAUNCHES == h0 + 1


@pytest.mark.cuda
def test_plain_block_average_divides_exactly_on_the_card(cuda_device):
    """The plain version's /3 on CUDA tensors is the correctly rounded
    division (torch divides by a Python scalar as a multiply by its
    reciprocal there, which differs for a third of these sums)."""
    s = np.arange(0, 3 * 65025 + 1, dtype=np.float32)
    v = torch.zeros((len(s), 4), dtype=torch.float32)
    v[:, 0] = v[:, 3] = torch.from_numpy(s)
    zero = torch.zeros_like(v)
    for dev in (torch.device("cpu"), cuda_device):
        avg, _ = tblocks._avd(v.to(dev), zero.to(dev), zero.to(dev))
        np.testing.assert_array_equal(avg[:, 0].cpu().numpy(),
                                      s / np.float32(3))


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["flat", "noise"])
@pytest.mark.parametrize("th,tw", [(40, 64), (719, 1280), (21, 30)])
@pytest.mark.parametrize("quarter", [True, False])
def test_block_kernel_matches_plain_on_flat_and_noise(cuda_device, kind, th,
                                                      tw, quarter):
    """The kernels on a flat window (every quarter scan stops at its
    first candidate) and a noise window (none stops early), with a tail,
    byte-equal to the plain versions."""
    words = _window(kind, th, 3, th, tw)
    prev = _window(kind, tw, 1, th, tw)[0]
    kern = (blocks_kernel.quarter_cells_cuda if quarter
            else blocks_kernel.half_cells_cuda)
    plain = (tblocks.quarter_cells_plain if quarter
             else tblocks.half_cells_plain)
    got = kern(words.to(cuda_device), False, prev.to(cuda_device))
    torch.cuda.synchronize()
    for g, w in zip(got, plain(words, False, prev)):
        assert g.dtype == w.dtype and torch.equal(g.cpu(), w)


@pytest.mark.cuda
@pytest.mark.parametrize("tw", [24, 26])
@pytest.mark.parametrize("offset", [0, 2])
def test_quarter_kernel_pairs_and_single_cells_agree(cuda_device, offset,
                                                     tw):
    """A thread takes two adjacent cells, and a row of an odd number of
    cells (tw % 4 == 2) ends in a lone one, on words 16-byte aligned or
    8 bytes off it.  Both equal the plain version."""
    words = _block_words(11, 3, 13, tw)
    flat = torch.zeros(words.numel() + 4, dtype=torch.int32,
                       device=cuda_device)
    flat[offset:offset + words.numel()] = words.reshape(-1).to(cuda_device)
    view = flat[offset:offset + words.numel()].view(words.shape)
    assert view.data_ptr() % 16 == (0 if offset == 0 else 8)
    got = blocks_kernel.quarter_cells_cuda(view, True, view[-1].clone())
    want = tblocks.quarter_cells_plain(words, True, words[-1].clone())
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)


@pytest.mark.cuda
@pytest.mark.parametrize("quarter", [True, False])
def test_block_kernel_outputs_are_views_of_one_buffer(cuda_device, quarter):
    """On the card the four outputs are views of one buffer with the
    plain version's shapes and dtypes (fg and bg 4-byte aligned), and
    cells_to_host fetches them with one copy into the plain version's
    planes."""
    words = _block_words(12, 2, 9, 20)
    kern = (blocks_kernel.quarter_cells_cuda if quarter
            else blocks_kernel.half_cells_cuda)
    plain = (tblocks.quarter_cells_plain if quarter
             else tblocks.half_cells_plain)
    got = kern(words.to(cuda_device))
    want = plain(words)
    storage = got[0].untyped_storage().data_ptr()
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype
        assert g.untyped_storage().data_ptr() == storage
    assert got[1].data_ptr() % 4 == 0 and got[2].data_ptr() % 4 == 0
    for g, w in zip(tblocks.cells_to_host(got), tblocks.cells_to_host(want)):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)

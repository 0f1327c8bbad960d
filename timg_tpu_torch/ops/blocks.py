"""Unicode half/quarter block glyph and color selection (counterpart of
timg_tpu/ops/blocks.py).

For every 2x2 (quarter) or 1x2 (half) pixel cell pick a block glyph and
foreground/background colors minimizing the summed linear-color
distance.  Behavioral spec: ref src/unicode-block-canvas.cc:154-227
(FindBestGlyph), src/framebuffer.h:138-200 (LinearColor / avd).  The
float32 arithmetic follows the reference's C evaluation order, so the
ties and the ``d < 1`` early exit come out as the reference's.

A CUDA tensor goes through the hand-written kernel (ops/blocks_kernel.py,
csrc/block_cells.cu), a CPU tensor through the plain PyTorch version
below, which follows timg_tpu/ops/blocks.py op for op.  The JAX package
emulates a correctly rounded ``/3`` and ``sqrt`` (its ops/exact.py)
because the TPU's are approximate; torch's ``/`` rounds correctly on the
CPU, so it serves as it is.  The repack's root is ops/exact.py's
integer bisection, floor(sqrt(v)) on exact squares, which equals the
reference's truncated ``sqrtf`` on every value the repack is fed
(test_plain_repack_root_is_exact_on_the_repack_lattice): ``torch.sqrt``
on the CPU now and then returned a root too low for one cell's three
channels, exact squares included, so a truncated root wrote n - 1
(tools/quarter_repeat.py found it; ROADMAP, faults).  Each product and
sum is its own eager op, so none is contracted into an FMA.

Two interfaces:
- ``quarter_blocks`` / ``half_blocks``: [B, H, W, 4] uint8 frames (H even;
  W even for quarter) -> (glyph int32, fg uint8 [..., 4], bg uint8
  [..., 4]), the JAX package's contract;
- ``quarter_cells`` / ``half_cells``: the video window's, on the resized
  [B, th, tw] int32 RGBA words.  An odd ``th`` gets a blank (all-zero,
  so transparent) row on top, or at the bottom with ``use_upper``; with
  a ``prev`` tail ([th, tw] words of the frame before the window) the
  window diff ``eq`` of frame 0 compares against it.  Returns (glyph
  uint8, fg int32 words, bg int32 words, eq bool), eq[i] comparing
  frame i with frame i-1 cell by cell (None with ``diff=False``).

Glyph ids (ref unicode-block-canvas.cc:54-65):
  0 background, 1 top-left, 2 top-right, 3 bot-left, 4 bot-right,
  5 left-bar, 6 diagonal, 7 lower-half, 8 upper-half.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from timg_tpu_torch import tracing
from timg_tpu_torch.ops import blocks_kernel
from timg_tpu_torch.ops.diff import window_cell_diff
from timg_tpu_torch.ops.exact import floor_sqrt_255

GLYPHS = [" ", "▘", "▝", "▖", "▗",
          "▌", "▚", "▄", "▀"]
BACKGROUND, TOP_LEFT, TOP_RIGHT, BOT_LEFT, BOT_RIGHT = 0, 1, 2, 3, 4
LEFT_BAR, DIAGONAL, LOWER_BLOCK, UPPER_BLOCK = 5, 6, 7, 8

_TRANSPARENT_THRESHOLD = 0x60  # is_transparent(): a < 0x60 (ref :154)


def _lin(c_u8: torch.Tensor) -> torch.Tensor:
    """LinearColor: rgb -> c*c in float32, alpha passes through."""
    f = c_u8.to(torch.float32)
    return torch.cat([f[..., :3] * f[..., :3], f[..., 3:4]], dim=-1)


def _dist(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Quadratic rgb distance, reference evaluation order."""
    d = b[..., :3] - a[..., :3]
    return (d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1]) \
        + d[..., 2] * d[..., 2]


def _avd(*values: torch.Tensor):
    """Average the linear colors and sum distances to the average, adding
    in the reference's operand order.  /2 and /4 are the exact multiplies
    by 0.5 and 0.25, /3 the correctly rounded division: the divisor is a
    tensor on the values' device, because torch on CUDA divides by a
    Python scalar as a multiply by its reciprocal, which rounds
    differently."""
    acc = values[0]
    for v in values[1:]:
        acc = acc + v
    n = len(values)
    if n in (2, 4):
        avg = acc * (1.0 / n)
    else:
        avg = acc / torch.tensor(float(n), dtype=torch.float32,
                                 device=acc.device)
    total = _dist(avg, values[0])
    for v in values[1:]:
        total = total + _dist(avg, v)
    return avg, total


def _repack(lin: torch.Tensor) -> torch.Tensor:
    """LinearColor::repack: sqrtf truncated and clamped to 255 (the
    exact floor root: the linear colors stay below 256^2); alpha
    truncated (a 3-pixel alpha average is not an integer)."""
    rgb = floor_sqrt_255(lin[..., :3])
    return torch.cat([rgb, lin[..., 3:4]], dim=-1).to(torch.uint8)


def quarter_blocks_plain(frames: torch.Tensor,
                         use_upper_half_block: bool = False):
    """Plain PyTorch version: [B, H, W, 4] uint8 (H, W even) -> (glyph
    [B, H/2, W/2] int32, fg, bg [B, H/2, W/2, 4] uint8).  ref
    unicode-block-canvas.cc:162-227."""
    b, h, w, _ = frames.shape
    cells = frames.reshape(b, h // 2, 2, w // 2, 2, 4)
    tl_u8 = cells[:, :, 0, :, 0]
    tr_u8 = cells[:, :, 0, :, 1]
    bl_u8 = cells[:, :, 1, :, 0]
    br_u8 = cells[:, :, 1, :, 1]

    tl, tr, bl, br = _lin(tl_u8), _lin(tr_u8), _lin(bl_u8), _lin(br_u8)

    # the 8 candidates in the reference's switch order (ref :207-218)
    cand_fg, cand_bg, costs = [], [], []

    avg4, d4 = _avd(tl, tr, bl, br)
    cand_bg.append(avg4); cand_fg.append(avg4); costs.append(d4)        # 0

    for fg_pix, rest in ((tl, (tr, bl, br)), (tr, (tl, bl, br)),
                         (bl, (tl, tr, br)), (br, (tl, tr, bl))):
        avg3, d3 = _avd(*rest)
        cand_bg.append(avg3); cand_fg.append(fg_pix); costs.append(d3)  # 1-4

    bg_lb, d_bg = _avd(tr, br)
    fg_lb, d_fg = _avd(tl, bl)
    cand_bg.append(bg_lb); cand_fg.append(fg_lb); costs.append(d_bg + d_fg)

    bg_dg, d_bg = _avd(tr, bl)
    fg_dg, d_fg = _avd(tl, br)
    cand_bg.append(bg_dg); cand_fg.append(fg_dg); costs.append(d_bg + d_fg)

    if use_upper_half_block:  # candidate 7 per the user's choice
        bg_hb, d_bg = _avd(bl, br)
        fg_hb, d_fg = _avd(tl, tr)
        half_glyph = UPPER_BLOCK
    else:
        bg_hb, d_bg = _avd(tl, tr)
        fg_hb, d_fg = _avd(bl, br)
        half_glyph = LOWER_BLOCK
    cand_bg.append(bg_hb); cand_fg.append(fg_hb); costs.append(d_bg + d_fg)

    cost = torch.stack(costs, dim=-1)          # [B,h,w,8]
    fg_all = torch.stack(cand_fg, dim=-2)      # [B,h,w,8,4]
    bg_all = torch.stack(cand_bg, dim=-2)

    # the reference's loop: scan in order, keep strictly better, stop at
    # the first new best below 1
    run_min = torch.cat(
        [torch.full(cost.shape[:-1] + (1,), 1e12, dtype=cost.dtype,
                    device=cost.device),
         torch.cummin(cost, dim=-1).values[..., :-1]], dim=-1)
    breaks = (cost < run_min) & (cost < 1.0)
    has_break = breaks.any(dim=-1)
    break_idx = torch.argmax(breaks.to(torch.uint8), dim=-1)
    first_min = torch.argmax((cost == cost.amin(dim=-1, keepdim=True))
                             .to(torch.uint8), dim=-1)
    chosen = torch.where(has_break, break_idx, first_min)

    idx = chosen[..., None, None].expand(*chosen.shape, 1, 4)
    fg_lin = torch.gather(fg_all, -2, idx)[..., 0, :]
    bg_lin = torch.gather(bg_all, -2, idx)[..., 0, :]
    glyph = torch.where(chosen == 7, half_glyph, chosen).to(torch.int32)

    fg = _repack(fg_lin)
    bg = _repack(bg_lin)

    # transparency overrides (ref :182-191), bottom, top, then all
    t_tl = tl_u8[..., 3] < _TRANSPARENT_THRESHOLD
    t_tr = tr_u8[..., 3] < _TRANSPARENT_THRESHOLD
    t_bl = bl_u8[..., 3] < _TRANSPARENT_THRESHOLD
    t_br = br_u8[..., 3] < _TRANSPARENT_THRESHOLD
    top_t = t_tl & t_tr
    bot_t = t_bl & t_br
    all_t = top_t & bot_t

    avg_bot = _repack(_avd(bl, br)[0])
    avg_top = _repack(_avd(tl, tr)[0])

    def sel(mask, a, b_):
        m = mask[..., None] if b_.dim() > mask.dim() else mask
        return torch.where(m, a, b_)

    glyph = sel(bot_t, UPPER_BLOCK, glyph).to(torch.int32)
    fg = sel(bot_t, avg_top, fg)
    bg = sel(bot_t, bl_u8, bg)
    glyph = sel(top_t, LOWER_BLOCK, glyph).to(torch.int32)
    fg = sel(top_t, avg_bot, fg)
    bg = sel(top_t, tl_u8, bg)
    glyph = sel(all_t, BACKGROUND, glyph).to(torch.int32)
    fg = sel(all_t, bl_u8, fg)
    bg = sel(all_t, tl_u8, bg)
    return glyph, fg, bg


def half_blocks_plain(frames: torch.Tensor,
                      use_upper_half_block: bool = False):
    """Plain PyTorch version: [B, H, W, 4] uint8 (H even) -> (glyph
    [B, H/2, W] int32, fg, bg [B, H/2, W, 4] uint8).  No color math: the
    colors are the raw pixels (ref unicode-block-canvas.cc:165-171)."""
    b, h, w, _ = frames.shape
    cells = frames.reshape(b, h // 2, 2, w, 4)
    top = cells[:, :, 0]
    bottom = cells[:, :, 1]

    equal = (top == bottom).all(dim=-1)
    both_t = ((top[..., 3] < _TRANSPARENT_THRESHOLD)
              & (bottom[..., 3] < _TRANSPARENT_THRESHOLD))
    is_bg = equal | both_t

    if use_upper_half_block:
        glyph_val, fg_px, bg_px = UPPER_BLOCK, top, bottom
    else:
        glyph_val, fg_px, bg_px = LOWER_BLOCK, bottom, top

    glyph = torch.where(is_bg, BACKGROUND, glyph_val).to(torch.int32)
    fg = torch.where(is_bg[..., None], top, fg_px)
    bg = torch.where(is_bg[..., None], bottom, bg_px)
    return glyph, fg, bg


def _pad_rows(words: torch.Tensor, use_upper: bool) -> torch.Tensor:
    """[B, th, tw] words -> [B, th + th % 2, tw]: an odd height gets a
    blank row on top (at the bottom with ``use_upper``), as the
    reference's odd-height empty-line shift (ref :356-365)."""
    if words.shape[1] % 2 == 0:
        return words
    blank = torch.zeros_like(words[:, :1])
    return torch.cat([words, blank] if use_upper else [blank, words], dim=1)


def _cells_plain(blocks_fn, cell_w: int, words: torch.Tensor,
                 use_upper: bool, prev: Optional[torch.Tensor], diff: bool):
    b, _, tw = words.shape
    padded = _pad_rows(words, use_upper)
    ph = padded.shape[1]
    frames = padded.contiguous().view(torch.uint8).reshape(b, ph, tw, 4)
    glyph, fg, bg = blocks_fn(frames, use_upper_half_block=use_upper)
    eq = None
    if diff:
        head = (_pad_rows(prev[None], use_upper) if prev is not None
                else torch.zeros_like(padded[:1]))
        pair = torch.cat([head, padded]).contiguous().view(torch.uint8)
        eq = window_cell_diff(pair.reshape(b + 1, ph, tw, 4), cell_w)

    def words_of(c):
        return c.contiguous().view(torch.int32)[..., 0]

    return glyph.to(torch.uint8), words_of(fg), words_of(bg), eq


def quarter_cells_plain(words: torch.Tensor, use_upper: bool = False,
                        prev: Optional[torch.Tensor] = None,
                        diff: bool = True):
    """Plain version of the quarter cells: see the module docstring (tw
    even).  Without ``prev``, eq[0] compares with a blank frame."""
    return _cells_plain(quarter_blocks_plain, 2, words, use_upper, prev, diff)


def half_cells_plain(words: torch.Tensor, use_upper: bool = False,
                     prev: Optional[torch.Tensor] = None,
                     diff: bool = True):
    """Plain version of the half cells: see the module docstring."""
    return _cells_plain(half_blocks_plain, 1, words, use_upper, prev, diff)


def quarter_cells(words: torch.Tensor, use_upper: bool = False,
                  prev: Optional[torch.Tensor] = None, diff: bool = True):
    """Quarter cells of a [B, th, tw] words window (tw even).  A CUDA
    tensor launches the kernel, a CPU tensor runs the plain version."""
    if words.is_cuda:
        return blocks_kernel.quarter_cells_cuda(words, use_upper, prev, diff)
    return quarter_cells_plain(words, use_upper, prev, diff)


def half_cells(words: torch.Tensor, use_upper: bool = False,
               prev: Optional[torch.Tensor] = None, diff: bool = True):
    """Half cells of a [B, th, tw] words window.  A CUDA tensor launches
    the kernel, a CPU tensor runs the plain version."""
    if words.is_cuda:
        return blocks_kernel.half_cells_cuda(words, use_upper, prev, diff)
    return half_cells_plain(words, use_upper, prev, diff)


def cells_to_host(cells):
    """(glyph, fg, bg, eq) of ``quarter_cells`` / ``half_cells`` -> numpy
    (glyph uint8, fg and bg [..., 4] uint8, eq bool or None).  On the
    card the outputs are views of one uint8 buffer (blocks_kernel.
    cell_outputs), fetched with one copy and viewed again on the host."""
    with tracing.span("window.fetch") as s:
        if cells[0].is_cuda:
            host = cells[0]._base.cpu()
            cells = [t if t is None else host.view(t.dtype).as_strided(
                t.shape, t.stride(), t.storage_offset()) for t in cells]
        glyph, fg, bg, eq = (t if t is None else t.numpy() for t in cells)
        s.count = sum(a.nbytes for a in (glyph, fg, bg, eq)
                      if a is not None)
    return (glyph, fg.view(np.uint8).reshape(fg.shape + (4,)),
            bg.view(np.uint8).reshape(bg.shape + (4,)), eq)


def _blocks(cells_fn, frames: torch.Tensor, use_upper: bool):
    b, h, w, _ = frames.shape
    words = frames.contiguous().view(torch.int32)[..., 0]
    glyph, fg, bg, _ = cells_fn(words, use_upper, diff=False)
    return (glyph.to(torch.int32),
            fg.view(torch.uint8).reshape(fg.shape + (4,)),
            bg.view(torch.uint8).reshape(bg.shape + (4,)))


def quarter_blocks(frames: torch.Tensor, use_upper_half_block: bool = False):
    """[B, H, W, 4] uint8 (H, W even) -> (glyph int32, fg, bg uint8), the
    contract of timg_tpu/ops/blocks.py:quarter_blocks, on the frames'
    device (the kernel on CUDA)."""
    return _blocks(quarter_cells, frames, use_upper_half_block)


def half_blocks(frames: torch.Tensor, use_upper_half_block: bool = False):
    """[B, H, W, 4] uint8 (H even) -> (glyph int32, fg, bg uint8), the
    contract of timg_tpu/ops/blocks.py:half_blocks, on the frames'
    device (the kernel on CUDA)."""
    return _blocks(half_cells, frames, use_upper_half_block)

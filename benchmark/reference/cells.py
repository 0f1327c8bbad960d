"""Quarter block cells, in NumPy.

The reference viewer's FindBestGlyph (timg src/unicode-block-canvas.cc):
each 2x2 pixel cell takes the first of 8 glyph candidates whose summed
linear-color distance is a new best below 1, else the best of all 8;
colors are averaged in linear space (c -> c * c) and repacked with a
truncated square root.  Transparent halves (alpha < 0x60) override.
Glyph ids: 0 background, 1-4 one quadrant, 5 left bar, 6 diagonal,
7 lower half, 8 upper half.
"""

from __future__ import annotations

import numpy as np

from reference.pixels import floor_sqrt
from reference.precision import F32, Precision

TRANSPARENT = 0x60


def _lin(c: np.ndarray, r) -> np.ndarray:
    f = c.astype(np.float32)
    return np.concatenate([r(f[..., :3] * f[..., :3]), f[..., 3:4]], axis=-1)


def _dist(a, b, r):
    d = r(b[..., :3] - a[..., :3])
    return r(r(r(d[..., 0] * d[..., 0]) + r(d[..., 1] * d[..., 1]))
             + r(d[..., 2] * d[..., 2]))


def _avd(r, *values):
    acc = values[0]
    for v in values[1:]:
        acc = r(acc + v)
    avg = r(acc / np.float32(len(values)))
    total = _dist(avg, values[0], r)
    for v in values[1:]:
        total = r(total + _dist(avg, v, r))
    return avg, total


def _repack(lin: np.ndarray) -> np.ndarray:
    rgb = floor_sqrt(lin[..., :3])
    return np.concatenate([rgb, lin[..., 3:4]], axis=-1).astype(np.uint8)


def quarter_cells(frame: np.ndarray, prec: Precision = F32):
    """[H, W, 4] uint8 (H, W even) -> (glyph [H/2, W/2] int,
    fg, bg [H/2, W/2, 4] uint8)."""
    r = prec.r
    h, w, _ = frame.shape
    cells = frame.reshape(h // 2, 2, w // 2, 2, 4)
    tl_u8, tr_u8 = cells[:, 0, :, 0], cells[:, 0, :, 1]
    bl_u8, br_u8 = cells[:, 1, :, 0], cells[:, 1, :, 1]
    tl, tr, bl, br = (_lin(p, r) for p in (tl_u8, tr_u8, bl_u8, br_u8))

    fgs, bgs, costs = [], [], []
    avg4, d4 = _avd(r, tl, tr, bl, br)
    fgs.append(avg4); bgs.append(avg4); costs.append(d4)
    for one, rest in ((tl, (tr, bl, br)), (tr, (tl, bl, br)),
                      (bl, (tl, tr, br)), (br, (tl, tr, bl))):
        avg3, d3 = _avd(r, *rest)
        fgs.append(one); bgs.append(avg3); costs.append(d3)
    for fg_pair, bg_pair in (((tl, bl), (tr, br)), ((tl, br), (tr, bl)),
                             ((bl, br), (tl, tr))):
        fg_avg, d_fg = _avd(r, *fg_pair)
        bg_avg, d_bg = _avd(r, *bg_pair)
        fgs.append(fg_avg); bgs.append(bg_avg); costs.append(r(d_bg + d_fg))

    cost = np.stack(costs, axis=-1)                           # [h, w, 8]
    run_min = np.concatenate(
        [np.full(cost.shape[:-1] + (1,), 1e12, np.float32),
         np.minimum.accumulate(cost, axis=-1)[..., :-1]], axis=-1)
    stops = (cost < run_min) & (cost < 1.0)
    chosen = np.where(stops.any(axis=-1), stops.argmax(axis=-1),
                      cost.argmin(axis=-1))
    idx = chosen[..., None, None]
    fg = _repack(np.take_along_axis(np.stack(fgs, axis=-2), idx, -2)[..., 0, :])
    bg = _repack(np.take_along_axis(np.stack(bgs, axis=-2), idx, -2)[..., 0, :])
    glyph = chosen.astype(np.int32)

    top_t = (tl_u8[..., 3] < TRANSPARENT) & (tr_u8[..., 3] < TRANSPARENT)
    bot_t = (bl_u8[..., 3] < TRANSPARENT) & (br_u8[..., 3] < TRANSPARENT)
    avg_bot = _repack(_avd(r, bl, br)[0])
    avg_top = _repack(_avd(r, tl, tr)[0])
    for mask, g, f, b in ((bot_t, 8, avg_top, bl_u8),
                          (top_t, 7, avg_bot, tl_u8),
                          (top_t & bot_t, 0, bl_u8, tl_u8)):
        glyph = np.where(mask, g, glyph)
        fg = np.where(mask[..., None], f, fg)
        bg = np.where(mask[..., None], b, bg)
    return glyph, fg, bg


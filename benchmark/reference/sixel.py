"""What one payload of the library's sixel cell has to be: the sixel
model in ``adaptive`` mode with ``adaptive_reuse``, in NumPy.

One median-cut tree serves the whole stream: it is built from the
stream's first frame (answer 0, after the resize and the compose), and
every frame is then dithered with it and assembled.

- the front half: ``pixels.stb_resize`` and ``pixels.compose_background``,
  as the quarter cell's reference runs them;
- ``median_cut_tree``: timg's 256-colour palette (libsixel with
  ``SIXEL_LARGE_LUM`` and ``SIXEL_REP_AVERAGE_COLORS``, timg
  src/sixel-canvas.cc:134-148) as the port defines it: a frozen copy of
  the rules of timg_tpu_torch/ops/sixel_np.py ``median_cut_tree``, kept
  here so that later changes to the program cannot move the yardstick;
- ``fs_dither_tree``: Floyd-Steinberg in float32 with the tree as the
  quantizer;
- ``dcs``: the sixel DCS bytes, with libsixel's structure.

**The one departure from the textbook dither.**  A textbook raster
scan pushes each pixel's error onto its four neighbours as it goes, so a
pixel's value collects them in the order up-left, up, up-right, left:
``(((p + ul/16) + 5up/16) + 3ur/16) + 7left/16``.  The port's kernels
scan anti-diagonals (t = x + 2y, ops/sixel_np.py ``_wavefront_np``) and
sum ``p + (7left/16 + ((3ur/16 + 5up/16) + ul/16))``.  In float32 the
two round differently and the comparison is exact, so this reference
sums in the kernels' association; it visits the anti-diagonals too, the
frames of a call side by side.

The entry ``library_sixel_adaptive`` computes all the answers that a
run sampled (``inputs.sample``, harness/sample.py) on its first call,
so that the dither's steps run over all of them at once, and keeps them
on ``inputs`` until each is asked for.
"""

from __future__ import annotations

import math

import numpy as np

from reference import pixels
from reference.precision import F32, Precision

TREE_DEPTH = 8
# LARGE_LUM's luminosity weights of R, G and B (netpbm, libsixel)
LUM = np.array([0.2989, 0.5866, 0.1145], dtype=np.float64)
# at most this many pixels build a tree (libsixel's sampling by quality)
SAMPLE_LIMIT = 1 << 18

# the Floyd-Steinberg shares
C7, C5, C3, C1 = (np.float32(n / 16.0) for n in (7, 5, 3, 1))


# --------------------------------------------------------------------------
# The median-cut tree
# --------------------------------------------------------------------------

def _split(colors: np.ndarray, counts: np.ndarray, box: np.ndarray):
    """One box's split: (axis, threshold, left, right).  LARGE_LUM: the
    axis of the largest (max - min) x luminosity weight, the first on a
    tie; the box's colours sorted along it (stable); the cut after the
    first colour at which the running count reaches half the box's
    count, leaving at least one colour on each side.  A value that
    continues across the cut moves the cut to the end of that value,
    so that the rule is a comparison (left iff value <= threshold);
    where that leaves the right side empty, the threshold drops by
    one."""
    values = colors[box]
    axis = int(np.argmax((values.max(axis=0) - values.min(axis=0)) * LUM))
    order = box[np.argsort(colors[box, axis], kind="stable")]
    along = colors[order, axis]
    running = np.cumsum(counts[order])
    cut = int(np.searchsorted(running, running[-1] / 2.0)) + 1
    cut = min(max(cut, 1), len(order) - 1)
    thr = int(along[cut - 1])
    if int(along[cut]) == thr:
        cut = int((along <= thr).sum())
        if cut >= len(order):
            thr -= 1
            cut = int((along <= thr).sum())
    return axis, thr, order[:cut], order[cut:]


def median_cut_tree(frame: np.ndarray):
    """[..., 3] uint8 pixels -> (palette [256, 3] uint8, levels [8, 128]
    int32, leaves [256] int32).

    The rules:

    1. Every ``ceil(n / 2^18)``-th pixel of the n, where n > 2^18; their
       distinct colours, each with its count.
    2. A balanced tree of depth 8: at level d each of the 2^d boxes
       (node i at ``levels[d, i]``) splits in two, children 2i and
       2i + 1.  Its word is ``axis << 8 | threshold``; a pixel goes left
       iff its rounded value on ``axis`` is <= threshold.  An empty box
       and a box of one colour take (0, 255): all go left.  Any other
       box splits as ``_split`` says.
    3. AVERAGE_COLORS: a leaf's colour is the mean of its box's distinct
       colours (each counted once) + 0.5, truncated; an empty leaf takes
       the mean of all the distinct colours so.
    4. ``leaves[i] = i << 24 | r << 16 | g << 8 | b`` of leaf i.
    """
    flat = np.asarray(frame).reshape(-1, 3)
    if len(flat) > SAMPLE_LIMIT:
        flat = flat[::math.ceil(len(flat) / SAMPLE_LIMIT)]
    keys, counts = np.unique(flat[:, 0].astype(np.int64) << 16
                             | flat[:, 1].astype(np.int64) << 8
                             | flat[:, 2], return_counts=True)
    colors = np.stack([keys >> 16, (keys >> 8) & 0xFF, keys & 0xFF],
                      axis=1).astype(np.int64)

    levels = np.zeros((TREE_DEPTH, 128), np.int32)
    boxes = [np.arange(len(colors))]
    for d in range(TREE_DEPTH):
        children = []
        for node, box in enumerate(boxes):
            if len(box) == 0 or len(np.unique(colors[box], axis=0)) <= 1:
                levels[d, node] = 255
                children += [box, box[:0]]
                continue
            axis, thr, left, right = _split(colors, counts, box)
            levels[d, node] = axis << 8 | (thr & 0xFF)
            children += [left, right]
        boxes = children

    def mean(idx):
        return (colors[idx].sum(axis=0) / len(idx) + 0.5).astype(np.uint8)

    everything = mean(np.arange(len(colors))) if len(colors) else \
        np.zeros(3, np.uint8)
    palette = np.stack([mean(box) if len(box) else everything
                        for box in boxes])
    leaves = (np.arange(len(boxes), dtype=np.int64) << 24
              | palette[:, 0].astype(np.int64) << 16
              | palette[:, 1].astype(np.int64) << 8
              | palette[:, 2]).astype(np.int32)
    return palette, levels, leaves


# --------------------------------------------------------------------------
# Floyd-Steinberg with the tree
# --------------------------------------------------------------------------

def fs_dither_tree(frames: np.ndarray, tree,
                   prec: Precision = F32) -> np.ndarray:
    """[B, h, w, >= 3] uint8 frames, one tree -> [B, h, w] uint8 leaf
    indices.  A pixel's value is its colour plus its neighbours' errors
    (the module's docstring gives the sum), clipped to [0, 255]; it
    descends the tree rounded (half to even), and its error is the value
    less its leaf's colour.  Every float32 result is rounded by
    ``prec``."""
    r = prec.r
    palette, levels, _ = tree
    axis = (levels >> 8).astype(np.intp)
    thr = (levels & 0xFF).astype(np.float32)
    colour = palette.astype(np.float32)
    b, h, w = frames.shape[:3]
    px = frames[..., :3].astype(np.float32)
    # the errors, with a border of zeros: pixel (y, x) at [y + 1, x + 1]
    err = np.zeros((b, h + 1, w + 2, 3), np.float32)
    out = np.empty((b, h, w), np.uint8)
    ys = np.arange(h)
    for t in range(w + 2 * (h - 1)):
        xs = t - 2 * ys
        on = (xs >= 0) & (xs < w)
        y, x = ys[on], xs[on]
        above = r(r(r(err[:, y, x + 2] * C3) + r(err[:, y, x + 1] * C5))
                  + r(err[:, y, x] * C1))
        incoming = r(r(err[:, y + 1, x] * C7) + above)
        v = np.clip(r(px[:, y, x] + incoming), np.float32(0),
                    np.float32(255))
        q = np.round(v).reshape(-1)
        at = np.arange(0, len(q), 3)      # a pixel's first channel in q
        node = np.zeros(len(at), np.intp)
        for d in range(TREE_DEPTH):
            node = 2 * node + (q[at + axis[d][node]] > thr[d][node])
        node = node.reshape(b, len(y))
        err[:, y + 1, x + 1] = r(v - colour[node])
        out[:, y, x] = node
    return out


# --------------------------------------------------------------------------
# The DCS bytes
# --------------------------------------------------------------------------

def _pct(v) -> int:
    return (int(v) * 100 + 127) // 255


def _runs(rows: np.ndarray) -> tuple:
    """[R, w] sixel masks -> (bytes of every row's runs, row ends):
    '?' + mask a column, a run of more than 3 as '!<n><char>', a
    row's trailing run of '?' left out."""
    n_rows, w = rows.shape
    flat = rows.reshape(-1)
    starts = np.empty(flat.size, bool)
    np.not_equal(flat[1:], flat[:-1], out=starts[1:])
    starts[::w] = True                # a row's first column
    at = np.flatnonzero(starts)
    row, x = np.divmod(at, w)
    # a row's first column starts a run, so a run ends in its row
    end = np.append(at[1:], flat.size) - row * w
    length = end - x
    ch = flat[at] + np.uint8(0x3F)
    keep = ~((ch == 0x3F) & (end == w))
    row, length, ch = row[keep], length[keep], ch[keep]

    # each run as a token of at most 2 + len(str(w)) bytes: a short run
    # its characters, a long one '!', its length's digits, its character
    width = max(3, 2 + len(str(w)))
    tok = np.repeat(ch[:, None], width, axis=1)
    used = np.arange(width)[None, :] < length[:, None]
    long_ = np.flatnonzero(length > 3)
    n = length[long_]
    digits = np.ones(len(n), np.int64)
    for p in range(1, width - 2):
        digits += n >= 10 ** p
    tok[long_, 0] = ord("!")
    for j in range(1, width - 1):
        on = j <= digits
        place = 10 ** (digits[on] - j)
        tok[long_[on], j] = n[on] // place % 10 + ord("0")
    tok[long_, 1 + digits] = ch[long_]
    used[long_] = np.arange(width)[None, :] <= 1 + digits[:, None]
    ends = np.cumsum(np.bincount(row, weights=used.sum(axis=1),
                                 minlength=n_rows)).astype(np.int64)
    return tok[used].tobytes(), ends


def dcs(indices: np.ndarray, palette: np.ndarray) -> bytes:
    """[h, w] indices + [n, 3] uint8 palette -> the DCS payload:
    ``ESC P q "1;1;w;h``; each palette entry ``#i;2;r;g;b`` in percent,
    (v * 100 + 127) // 255; then bands of 6 rows, each the colours
    present in it in ascending order (an index past the palette is left
    out), each as ``#c`` and its row of sixels (``_runs``; bit k of a
    sixel is row k of the band), colours parted by '$', bands by '-';
    ``ESC \\``."""
    h, w = indices.shape
    n = len(palette)
    out = bytearray(b'\033Pq"1;1;%d;%d' % (w, h))
    for i, (cr, cg, cb) in enumerate(palette):
        out += b"#%d;2;%d;%d;%d" % (i, _pct(cr), _pct(cg), _pct(cb))
    n_bands = -(-h // 6)
    bands = np.full((n_bands * 6, w), 256, np.int64)
    bands[:h] = indices
    bands = bands.reshape(n_bands, 6, w)
    masks = np.zeros(n_bands * 257 * w, np.uint8)
    at = np.arange(n_bands)[:, None] * (257 * w) + np.arange(w)[None, :]
    for k in range(6):
        masks[at + bands[:, k] * w] |= np.uint8(1 << k)
    masks = masks.reshape(n_bands, 257, w)[:, :n]
    present = masks.any(axis=2)
    row_band, row_colour = np.nonzero(present)
    body, ends = _runs(masks[present])
    start = 0
    for band in range(n_bands):
        first = True
        for i in np.nonzero(row_band == band)[0]:
            if not first:
                out += b"$"
            first = False
            out += b"#%d" % row_colour[i]
            out += body[start:ends[i]]
            start = int(ends[i])
        if band != n_bands - 1:
            out += b"-"
    out += b"\033\\"
    return bytes(out)


# --------------------------------------------------------------------------
# The cell's payloads
# --------------------------------------------------------------------------

def front(frame: np.ndarray, out_h: int, out_w: int, bg,
          prec: Precision = F32) -> np.ndarray:
    """One decoded RGBA frame -> the model's resized frame: the stb
    resize, then the compose over ``bg`` unless it is transparent."""
    x = pixels.stb_resize(frame, out_h, out_w, prec)
    if bg is not None and bg[3] != 0:
        x = pixels.compose_background(x, bg, prec)
    return x


def payloads(frames, first: np.ndarray, out_h: int, out_w: int, bg,
             prec: Precision = F32, tree=None) -> list:
    """The payloads of ``frames`` ([h, w, 4] RGBA each) in a stream whose
    first frame is ``first``: the tree of ``first``'s resized frame (or
    ``tree``, already built from it), every frame dithered with it."""
    if tree is None:
        tree = median_cut_tree(front(first, out_h, out_w, bg, prec)[..., :3])
    x = np.stack([front(f, out_h, out_w, bg, prec) for f in frames])
    return [dcs(idx, tree[0]) for idx in fs_dither_tree(x, tree, prec)]


def library_sixel_adaptive(inputs, key: int, prec: Precision = F32) -> bytes:
    """The payload of answer ``key``; the first call computes those of
    every answer the run sampled."""
    cfg = inputs.config
    shape = int(cfg["out_h"]), int(cfg["out_w"]), tuple(cfg["bg_color"])
    memo = vars(inputs).setdefault("sixel_reference", {})
    if (prec.name, key) not in memo:
        sample = getattr(inputs, "sample", None)
        keys = sorted(sample.chosen()) if sample is not None else []
        keys = [k for k in keys if (prec.name, k) not in memo]
        if key not in keys:
            keys = [key]
        if ("tree", prec.name) not in memo:
            memo["tree", prec.name] = median_cut_tree(
                front(inputs.frame(0), *shape, prec)[..., :3])
        got = payloads([inputs.frame(k) for k in keys], None, *shape, prec,
                       tree=memo["tree", prec.name])
        memo.update(((prec.name, k), p) for k, p in zip(keys, got))
    return memo.pop((prec.name, key))

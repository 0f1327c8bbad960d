"""Pure-numpy mirrors of the sixel FS-dither device kernels.

These replicate the *wavefront* formulation of ops/sixel.py's
``_wavefront_scan`` (antidiagonals t = x + 2y, the exact error-mixing
association of the scan step) rather than the scalar raster reference,
so their output is bit-identical to the device path — same f32
operations in the same order, just evaluated step-by-step in numpy.

Why they exist: a one-shot CLI invocation on a still image must not pay
an XLA compile (tens of seconds for a fresh shape; see ops/backend.py
``prefer_host``).  The jax-free mirror finishes a typical sixel still in
tens of milliseconds.  tests/test_units.py asserts bit-identity against
the scan formulation; the TPU Pallas kernels are asserted bit-identical
to the scan in turn, so all three agree.
"""

from __future__ import annotations

import numpy as np

_C7 = np.float32(7.0 / 16.0)
_C5 = np.float32(5.0 / 16.0)
_C3 = np.float32(3.0 / 16.0)
_C1 = np.float32(1.0 / 16.0)

_CUBE_LEVELS = (6, 7, 6)
TREE_DEPTH = 8
_TREE_DEPTH = TREE_DEPTH

# Luminosity proportions used by LARGE_LUM axis choice (netpbm/libsixel).
_LUM = np.array([0.2989, 0.5866, 0.1145], dtype=np.float64)

_SAMPLE_LIMIT = 1 << 18  # like libsixel's quality-based sampling


def cube_palette() -> np.ndarray:
    """[252, 3] uint8 palette of the 6x7x6 cube."""
    lr, lg, lb = _CUBE_LEVELS
    r = np.round(np.arange(lr) * 255.0 / (lr - 1))
    g = np.round(np.arange(lg) * 255.0 / (lg - 1))
    b = np.round(np.arange(lb) * 255.0 / (lb - 1))
    grid = np.stack(np.meshgrid(r, g, b, indexing="ij"), axis=-1)
    return grid.reshape(-1, 3).astype(np.uint8)


def median_cut_tree(pixels: np.ndarray):
    """Balanced depth-8 median-cut tree quantizer.

    Returns (palette [256,3] u8, levels [8,128] i32, leaves [256] i32):
    * levels[d, node] packs (axis << 8 | thr): descend left iff
      round(v[axis]) <= thr;
    * leaves[node] packs (idx << 24 | r << 16 | g << 8 | b) for the
      leaf's palette entry.
    Nodes at level d occupy [0, 2^d) (level tables padded to 128; the
    last level's 256 nodes live in the leaf table).
    """
    flat = np.asarray(pixels).reshape(-1, 3)
    if len(flat) > _SAMPLE_LIMIT:
        stride = int(np.ceil(len(flat) / _SAMPLE_LIMIT))
        flat = flat[::stride]
    packed = (flat[:, 0].astype(np.int64) << 16 |
              flat[:, 1].astype(np.int64) << 8 | flat[:, 2])
    keys, counts = np.unique(packed, return_counts=True)
    colors = np.stack([(keys >> 16) & 0xFF, (keys >> 8) & 0xFF,
                       keys & 0xFF], axis=1).astype(np.int64)

    n_leaves = 1 << TREE_DEPTH
    levels = np.zeros((TREE_DEPTH, 128), np.int32)
    palette = np.zeros((n_leaves, 3), np.uint8)

    # boxes[node] at the current level: index array into colors
    boxes = {0: np.arange(len(colors))}
    for d in range(TREE_DEPTH):
        nxt = {}
        for node in range(1 << d):
            box = boxes.get(node)
            if box is None or len(box) == 0:
                # empty: descend everything left into another empty box
                levels[d, node] = (0 << 8) | 255
                nxt[node * 2] = box if box is not None else None
                continue
            if len(np.unique(colors[box], axis=0)) <= 1:
                levels[d, node] = (0 << 8) | 255   # all left
                nxt[node * 2] = box
                continue
            # LARGE_LUM: dimension with largest luminosity-weighted
            # spread
            spreads = (colors[box].max(axis=0)
                       - colors[box].min(axis=0)) * _LUM
            dim = int(np.argmax(spreads))
            srt = box[np.argsort(colors[box, dim], kind="stable")]
            csum = np.cumsum(counts[srt])
            half = csum[-1] / 2.0
            cut = int(np.searchsorted(csum, half)) + 1
            cut = min(max(cut, 1), len(srt) - 1)
            # threshold: descend-left iff value <= colors[srt[cut-1]].
            # Equal values may straddle the frequency cut; move the cut
            # to the value boundary so the rule is a pure comparison.
            thr = int(colors[srt[cut - 1], dim])
            if int(colors[srt[cut], dim]) == thr:
                below = colors[srt, dim] <= thr
                cut2 = int(below.sum())
                if cut2 >= len(srt):      # all values equal the max
                    thr -= 1
                    below = colors[srt, dim] <= thr
                    cut2 = int(below.sum())
                cut = cut2
            levels[d, node] = (dim << 8) | (thr & 0xFF)
            nxt[node * 2] = srt[:cut]
            nxt[node * 2 + 1] = srt[cut:]
        boxes = nxt

    parent_avg = (colors.sum(axis=0) / max(len(colors), 1) + 0.5
                  ).astype(np.uint8) if len(colors) else np.zeros(3,
                                                                  np.uint8)
    for node in range(n_leaves):
        box = boxes.get(node)
        if box is None or len(box) == 0:
            palette[node] = parent_avg
        else:
            palette[node] = (colors[box].sum(axis=0) / len(box)
                             + 0.5).astype(np.uint8)
    # empty leaves carry the global average color so unused indices
    # still map to something sane
    leaves = ((np.arange(n_leaves, dtype=np.int64) << 24)
              | (palette[:, 0].astype(np.int64) << 16)
              | (palette[:, 1].astype(np.int64) << 8)
              | palette[:, 2].astype(np.int64)).astype(np.int32)
    return palette, levels, leaves


def _wavefront_np(frames_rgb: np.ndarray, quantize) -> np.ndarray:
    """[B, H, W, >=3] uint8 -> [B, H, W] int32 indices.

    ``quantize(v [B,H,3] f32) -> (idx [B,H] i32, color [B,H,3] f32)``.
    Mirrors _wavefront_scan: one step per antidiagonal, carries of the
    last three error wavefronts, row-above terms mixed before the
    single row shift (the scan's association, ops/sixel.py:182-205).
    """
    frames = np.ascontiguousarray(frames_rgb[..., :3])
    b, h, w = frames.shape[:3]
    n_steps = w + 2 * (h - 1)
    ys = np.arange(h)

    e1 = np.zeros((b, h, 3), np.float32)
    e2 = np.zeros_like(e1)
    e3 = np.zeros_like(e1)
    out = np.zeros((b, h, w), np.int32)

    for t in range(n_steps):
        xs = t - 2 * ys
        valid = (xs >= 0) & (xs < w)
        (rows,) = np.nonzero(valid)
        col = np.zeros((b, h, 3), np.float32)
        col[:, rows] = frames[:, rows, xs[rows]]

        mix = e1 * _C3 + e2 * _C5 + e3 * _C1
        incoming = e1 * _C7
        incoming[:, 1:] += mix[:, :-1]
        v = np.clip(col + incoming, np.float32(0.0), np.float32(255.0))
        idx, chosen = quantize(v)
        err = v - chosen
        err[:, ~valid] = 0.0
        e3, e2, e1 = e2, e1, err
        out[:, rows, xs[rows]] = idx[:, rows]
    return out


def fs_dither_cube_np(frames_rgb: np.ndarray) -> np.ndarray:
    """Numpy mirror of ops/sixel.py _fs_dither_cube_impl (6x7x6 cube)."""
    lr, lg, lb = _CUBE_LEVELS
    steps = np.asarray([(lr - 1) / 255.0, (lg - 1) / 255.0,
                        (lb - 1) / 255.0], np.float32)
    inv_steps = np.asarray([255.0 / (lr - 1), 255.0 / (lg - 1),
                            255.0 / (lb - 1)], np.float32)

    def quantize(v):
        q = np.round(v * steps)
        chosen = np.round(q * inv_steps)
        qi = q.astype(np.int32)
        idx = (qi[..., 0] * lg + qi[..., 1]) * lb + qi[..., 2]
        return idx, chosen

    return _wavefront_np(frames_rgb, quantize)


def fs_dither_tree_np(frames_rgb: np.ndarray, levels: np.ndarray,
                      leaves: np.ndarray) -> np.ndarray:
    """Numpy mirror of ops/sixel.py _fs_dither_tree_impl (median-cut
    tree descent: 8 level lookups + leaf unpack)."""
    levels = np.asarray(levels)
    leaves = np.asarray(leaves)

    def quantize(v):
        vq = np.round(v)
        node = np.zeros(v.shape[:-1], np.int32)
        for d in range(_TREE_DEPTH):
            word = levels[d][node]
            axis = word >> 8
            thr = (word & 0xFF).astype(np.float32)
            comp = np.where(axis == 0, vq[..., 0],
                            np.where(axis == 1, vq[..., 1], vq[..., 2]))
            node = node * 2 + (comp > thr).astype(np.int32)
        leaf = leaves[node]
        idx = (leaf >> 24) & 0xFF
        color = np.stack(
            [((leaf >> 16) & 0xFF).astype(np.float32),
             ((leaf >> 8) & 0xFF).astype(np.float32),
             (leaf & 0xFF).astype(np.float32)], axis=-1)
        return idx, color

    return _wavefront_np(frames_rgb, quantize)

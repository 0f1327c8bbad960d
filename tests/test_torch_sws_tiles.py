"""A numpy emulation of the sws kernel's tiled design (csrc/sws_yuv420.cu,
``sws_scaled``), held byte-equal to the port's plain version on the CPU.

The emulation walks what the kernel walks: each frame's strips of output
columns and chunks of output rows (one block each), the chunk's steps
from the plan's ``Tiling``, the byte spans staged from the aligned first
column in 16-byte pieces (or byte by byte where a plane's rows are not
16-byte aligned), the horizontal pass with a thread's taps in registers
(zero past the filter, reading the stride's tail) or, on the wide path,
the filter's own taps, into int32 rings of intermediates slotted by row
(a step's rows up to the ring's end, then from its start), then the
vertical pass in templates 0, 1 and 2 and both conversions from
the ring, and the stores of a thread's four words (16 bytes where the
row allows, then 8, then 4).  Shared memory starts as seeded noise, so a
read of anything the block did not write shows in the words; each ring
slot remembers its row, and every read checks it.  Tolerance: byte
equality with ``sws_yuv420_to_rgba_words_plain``.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from timg_tpu_torch.ops import sws_resize as tsws  # noqa: E402

M32 = np.uint64(0xFFFFFFFF)


def u32(x):
    """int -> the uint32 the kernel holds (two's complement), in uint64."""
    return np.asarray(x).astype(np.int64).astype(np.uint64) & M32


def s32(x):
    """uint32 (in uint64) -> its int32 value, in int64."""
    x = np.asarray(x, np.uint64) & M32
    return x.astype(np.int64) - ((x >> np.uint64(31)).astype(np.int64) << 32)


def vertical(rows, vcoef, tmpl, full, chroma):
    """The kernel's vertical pass of one plane: ``rows`` [n, taps, cols]
    int32 intermediates of n output rows, ``vcoef`` [n, taps] their
    coefficients (one for the whole row, as the kernel broadcasts)."""
    taps = rows.shape[1]
    vcoef = vcoef[:, :, None]
    if tmpl == 0:
        acc = u32((1 << 9) - (128 << 19) if full and chroma
                  else (1 << 9) if full else (1 << 18))
        for t in range(taps):
            acc = (acc + u32(rows[:, t]) * u32(vcoef[:, t])) & M32
        return s32(acc) >> 10 if full else np.clip(s32(acc) >> 19, 0, 255)
    a = rows[:, 0].astype(np.int64)
    b = rows[:, 1].astype(np.int64) if taps > 1 else np.zeros_like(a)
    if tmpl == 2:
        alpha = u32(vcoef[:, 1])
        mix = (u32(a) * ((u32(4096) - alpha) & M32) + u32(b) * alpha) & M32
        if full:
            return s32((mix - u32(128 << 19)) if chroma else mix) >> 10
        return s32(mix) >> 19
    if not chroma:
        return s32(u32(a) << np.uint64(2)) if full else (a + 64) >> 7
    avg = (vcoef[:, 1] >= 2048) if taps == 2 else np.zeros((len(a), 1), bool)
    if full:
        return np.where(avg,
                        s32((u32(a) + u32(b) - u32(128 << 8)) << np.uint64(1)),
                        s32((u32(a) - u32(128 << 7)) << np.uint64(2)))
    return np.where(avg, (a + b + 128) >> 8, (a + 64) >> 7)


def pack(r, g, b):
    return s32(u32(r) | (u32(g) << np.uint64(8)) | (u32(b) << np.uint64(16))
               | np.uint64(0xFF000000))


def convert(k, y1, uu, vv, full):
    """The conversion of [n, cols] pixels: the yuv2rgb tables (chroma
    one column a pixel pair) or yuv2rgb_write_full (its own column)."""
    if full:
        y = ((u32(y1) - u32(k[1])) * u32(k[0]) + u32(1 << 21)) & M32
        r = (y + u32(vv) * u32(k[2])) & M32
        g = (y + u32(vv) * u32(k[5]) + u32(uu) * u32(k[4])) & M32
        b = (y + u32(uu) * u32(k[3])) & M32
        top = (1 << 30) - 1
        return pack(*(np.clip(s32(c), 0, top) >> 22 for c in (r, g, b)))

    def tab(idx):
        return np.clip(s32(u32(k[1]) + (idx & M32) * u32(k[0])) >> 16, 0,
                       255)

    def off(v, coef):
        return u32((s32(u32(v) * u32(coef)) >> 16) - (coef >> 9))

    n = y1.shape[-1]
    uu, vv = np.repeat(uu, 2, -1)[..., :n], np.repeat(vv, 2, -1)[..., :n]
    yy = u32(y1)
    return pack(tab(yy + off(vv, k[2])),
                tab(yy + off(uu, k[4]) + off(vv, k[5])),
                tab(yy + off(uu, k[3])))


class Block:
    """One block's shared memory and counters."""

    def __init__(self, plan, rng):
        t = plan.tiling
        self.ring_l = rng.integers(-1 << 31, 1 << 31, (t.ring_l, t.sw),
                                   dtype=np.int32)
        self.ring_c = rng.integers(-1 << 31, 1 << 31, (t.ring_c, 2, t.swc),
                                   dtype=np.int32)
        self.held_l = np.full(t.ring_l, -1)    # the row each slot holds
        self.held_c = np.full(t.ring_c, -1)
        # times each source row was made (a step makes a row at every
        # column of the strip together)
        self.made_l = np.zeros(plan.src_h, np.int64)
        self.made_c = np.zeros((2, plan.chr_src_h), np.int64)


def stage(plane, rows, a0, n16, stride, aligned, rng):
    """A step's byte rows in shared memory: pieces of 16 bytes from the
    aligned first column, or the same bytes one by one up to the row's
    end; the rest of the stride is whatever shared memory held."""
    buf = rng.integers(0, 256, (len(rows), stride), dtype=np.uint8)
    end = a0 + 16 * n16
    if aligned:
        assert end <= plane.shape[1], "a 16-byte piece leaves its row"
    else:
        end = min(end, plane.shape[1])
    for i, r in enumerate(rows):
        buf[i, :end - a0] = plane[r, a0:end]
    return buf


def hpass(buf, pos, coef, kf):
    """hScale8To15 of every staged row at every column of the strip:
    ``pos`` the columns' first byte in the stride, ``coef`` [n, f]; with
    registers (kf > 0) each column runs kf taps, zero past its filter."""
    n, f = coef.shape
    taps = kf or f
    cf = np.zeros((n, taps), np.int64)
    cf[:, :f] = coef
    acc = np.zeros((buf.shape[0], n), np.uint64)
    for j in range(taps):
        acc = (acc + u32(buf[:, pos + j]) * u32(cf[:, j])) & M32
    return np.minimum(s32(acc) >> 7, 32767)


def emulate(plan, y, u, v, seed=0):
    """The kernel's words for [B, H, W] y and [B, CH, CW] u, v (numpy
    uint8), with the blocks' counters: (words, writes a word, blocks)."""
    t = plan.tiling
    rng = np.random.default_rng(seed)
    nb, dh, dw = y.shape[0], plan.dst_h, plan.dst_w
    full = plan.full_chroma
    k = plan.constants()
    out = rng.integers(-1 << 31, 1 << 31, (nb, dh, dw), dtype=np.int64)
    writes = np.zeros((nb, dh, dw), np.int64)
    al_l, al_c = y.shape[2] % 16 == 0, u.shape[2] % 16 == 0
    blocks = {}
    for f in range(nb):
        for s in range(t.n_strips):
            x0 = s * t.sw
            xc0 = x0 if full else x0 // 2
            ncol = min(t.sw, dw - x0)
            ncol_c = min(t.swc, plan.chr_dst_w - xc0)
            a0l, n16l, a0c, n16c = (int(x) for x in t.strips[s])
            xs, xcs = x0 + np.arange(ncol), xc0 + np.arange(ncol_c)
            pos_l, pos_c = plan.h_lum_pos[xs] - a0l, plan.h_chr_pos[xcs] - a0c
            coef_l, coef_c = plan.h_lum_coef[xs], plan.h_chr_coef[xcs]
            for c in range(t.n_chunks):
                blk = blocks[f, s, c] = Block(plan, rng)
                steps = t.steps[t.chunk_steps[c]:t.chunk_steps[c + 1]]
                r0, c0 = int(steps[0][0]), int(steps[0][2])
                for la, lb, ca, cb, oa, ob, sl, sc in steps.tolist():
                    assert sl == (la - r0) % t.ring_l
                    assert sc == (ca - c0) % t.ring_c
                    rows = list(range(la, lb))
                    buf = stage(y[f], rows, a0l, n16l, t.stride_l, al_l, rng)
                    vals = hpass(buf, pos_l, coef_l, t.kf)
                    for i, r in enumerate(rows):
                        slot = (sl + i) % t.ring_l
                        blk.ring_l[slot, :ncol] = vals[i]
                        blk.held_l[slot] = r
                        blk.made_l[r] += 1
                    rows = list(range(ca, cb))
                    for p, plane in enumerate((u, v)):
                        buf = stage(plane[f], rows, a0c, n16c, t.stride_c,
                                    al_c, rng)
                        vals = hpass(buf, pos_c, coef_c, t.kf)
                        for i, r in enumerate(rows):
                            slot = (sc + i) % t.ring_c
                            blk.ring_c[slot, p, :ncol_c] = vals[i]
                            blk.held_c[slot] = r
                            blk.made_c[p, r] += 1
                    if ob > oa:
                        words = vpass(plan, blk, oa, ob, full, k)
                        store(out, writes, f, oa, x0, words[:, :ncol])
    return out.astype(np.int32), writes, blocks


def vpass(plan, blk, oa, ob, full, k):
    """The words of output rows [oa, ob) across the strip, from the
    rings; every slot read holds the row the filter names."""
    t = plan.tiling
    tmpl = plan.template
    rows_l = plan.v_lum_pos[oa:ob, None] + np.arange(plan.v_lum_size)
    rows_c = plan.v_chr_pos[oa:ob, None] + np.arange(plan.v_chr_size)
    # the plan's first slots, then the next ones, wrapping
    sl = (t.slots[oa:ob, :1] + np.arange(plan.v_lum_size)) % t.ring_l
    sc = (t.slots[oa:ob, 1:] + np.arange(plan.v_chr_size)) % t.ring_c
    np.testing.assert_array_equal(blk.held_l[sl], rows_l)
    np.testing.assert_array_equal(blk.held_c[sc], rows_c)
    vl, vc = plan.v_lum_coef[oa:ob], plan.v_chr_coef[oa:ob]
    y1 = vertical(blk.ring_l[sl], vl, tmpl, full, False)
    uu = vertical(blk.ring_c[sc, 0], vc, tmpl, full, True)
    vv = vertical(blk.ring_c[sc, 1], vc, tmpl, full, True)
    return convert(k, y1, uu, vv, full)


def store(out, writes, f, oa, x0, words):
    """Each thread's four words at x0 + 4q of rows oa, oa + 1, ...: one
    16-byte store where all four lie in the row and the address is
    16-byte aligned, else an 8-byte store of each aligned pair and
    single words for the rest."""
    dh, dw = out.shape[1:]
    n_rows, ncol = words.shape
    flat_out, flat_w = out.reshape(-1), writes.reshape(-1)
    q = np.arange(0, ncol, 4)
    i = ((f * dh + oa + np.arange(n_rows))[:, None] * dw + x0 + q)
    n = np.minimum(4, ncol - q)[None, :] + 0 * i
    wide = (n == 4) & (i % 4 == 0)
    starts, widths = [i[wide]], [np.full(wide.sum(), 4)]
    for j in range(4):
        narrow = ~wide & (j < n)
        pair = narrow & ((i + j) % 2 == 0) & (j + 1 < n)
        second = narrow & (j >= 1) & ((i + j - 1) % 2 == 0)
        single = narrow & ~pair & ~second
        starts += [i[pair] + j, i[single] + j]
        widths += [np.full(pair.sum(), 2), np.full(single.sum(), 1)]
    src = words.reshape(-1)
    first = (f * dh + oa) * dw + x0      # words[r, c] lands at
    for start, width in zip(starts, widths):
        for w in range(int(width.max(initial=0))):
            at = start[width > w] + w
            r, c = divmod(at - first, dw)
            flat_out[at] = src[r * ncol + c]
            np.add.at(flat_w, at, 1)


GEOS = [
    (64, 48, 32, 24),     # 2x downscale (template 0)
    (32, 24, 64, 48),     # 2x upscale (template 2)
    (64, 48, 64, 24),     # vertical-only
    (64, 48, 32, 48),     # horizontal-only
    (37, 23, 22, 37),     # odd source dims: rows not 16-byte aligned
    (129, 47, 48, 96),    # prime-ish
    (16, 4, 200, 4),      # extreme aspect (template 1, one chroma tap)
    (64, 48, 31, 24),     # odd width: full chroma, template 0
    (64, 48, 33, 48),     # full chroma, template 1
    (32, 24, 65, 48),     # odd upscale: full chroma, template 2
    (63, 47, 63, 47),     # odd-height equal size -> scaled path
    (64, 47, 64, 47),
    (320, 180, 30, 12),   # 10x: 24 taps, the wide ring
    (1920, 24, 24, 12),   # 80x across: the wide path (taps in memory)
]
# full-size geometries, one frame: the main path's 1080p -> 720p and its
# odd width, the block window's (-g160x48 quarter blocks: 320x90, and
# 170x96 where fl = fc = l = 24), 2160p -> 720p, a template-2 upscale,
# and a height whose last chunk is short
BIG = [
    (1920, 1080, 1280, 720),
    (1920, 1080, 1279, 720),
    (1920, 1080, 320, 90),
    (1920, 1080, 170, 96),
    (3840, 2160, 1280, 720),
    (640, 360, 1280, 720),
    (1920, 1080, 1280, 710),
]
FLAT = [(0, 0, 0), (255, 255, 255), (255, 255, 0), (0, 255, 255)]


def _planes(seed, sw, sh, n, flat=None, pad=(0, 0)):
    ch, cw = (sh + 1) // 2 + pad[0], (sw + 1) // 2 + pad[1]
    if flat is not None:
        return tuple(np.full(s, val, np.uint8) for s, val in zip(
            ((n, sh, sw), (n, ch, cw), (n, ch, cw)), flat))
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 256, (n, sh, sw), np.uint8),
            rng.integers(0, 256, (n, ch, cw), np.uint8),
            rng.integers(0, 256, (n, ch, cw), np.uint8))


def _check(planes, dh, dw, full, exact=None):
    y, u, v = planes
    plan = tsws.get_plan(y.shape[2], y.shape[1], dw, dh, full)
    got, writes, blocks = emulate(plan, y, u, v)
    assert (writes == 1).all(), "a word written other than once"
    if exact is None:
        exact = planes
    want = tsws.sws_yuv420_to_rgba_words_plain(
        *(torch.from_numpy(np.ascontiguousarray(p)) for p in exact), dh, dw,
        full).numpy()
    np.testing.assert_array_equal(got, want)
    return plan, blocks


@pytest.mark.parametrize("sw,sh,dw,dh", GEOS)
def test_emulation_matches_plain(sw, sh, dw, dh):
    for full in (False, True):
        for flat in [None] + FLAT:
            _check(_planes(sw + dw + full, sw, sh, 2, flat), dh, dw, full)


@pytest.mark.parametrize("sw,sh,dw,dh", BIG)
def test_emulation_matches_plain_full_size(sw, sh, dw, dh):
    for full in (False, True):
        _check(_planes(sw * 7 + dw, sw, sh, 1), dh, dw, full)
    _check(_planes(0, sw, sh, 1, (255, 255, 0)), dh, dw, False)


def test_emulation_padded_chroma_planes():
    """Chroma planes wider and taller than half (a decoder's padding,
    an odd stride): the words of the exact planes."""
    for sw, sh, dw, dh in ((1920, 1080, 1280, 720), (30, 20, 17, 12),
                           (64, 48, 31, 24)):
        y, u, v = _planes(5, sw, sh, 1, pad=(2, 3))
        exact = (y, u[:, :(sh + 1) // 2, :(sw + 1) // 2],
                 v[:, :(sh + 1) // 2, :(sw + 1) // 2])
        for full in (False, True):
            _check((y, u, v), dh, dw, full, exact)


def test_a_short_last_chunk_and_partial_strips():
    plan = tsws.get_plan(1920, 1080, 1280, 710, False)
    t = plan.tiling
    assert plan.dst_h % t.ch != 0
    plan = tsws.get_plan(1920, 1080, 1279, 720, False)
    assert plan.dst_w % plan.tiling.sw != 0


@pytest.mark.parametrize("sw,sh,dw,dh", GEOS + BIG)
def test_spans_cover_every_tap(sw, sh, dw, dh):
    """Each strip's span holds every horizontal tap of its columns (and
    the stride every register tap), each chunk's steps bring every row
    its output rows read before they are read, in increasing order, and
    the plan's positions are nondecreasing."""
    for full in (False, True):
        plan = tsws.get_plan(sw, sh, dw, dh, full)
        t = plan.tiling
        for pos in (plan.h_lum_pos, plan.h_chr_pos, plan.v_lum_pos,
                    plan.v_chr_pos):
            assert np.all(np.diff(pos) >= 0)
        for s in range(t.n_strips):
            for k, (pos, coef, x0, n, stride, span) in enumerate((
                    (plan.h_lum_pos, plan.h_lum_coef, s * t.sw, t.sw,
                     t.stride_l, t.span_l[s]),
                    (plan.h_chr_pos, plan.h_chr_coef,
                     s * t.sw // (1 if plan.full_chroma else 2), t.swc,
                     t.stride_c,
                     t.span_c[s]))):
                a0, n16 = t.strips[s][2 * k:2 * k + 2]
                p = pos[x0:x0 + n]
                assert a0 % 16 == 0 and a0 <= span[0] == p.min()
                assert span[1] == p.max() + coef.shape[1] - 1
                assert a0 + 16 * n16 > span[1] >= a0 + 16 * (n16 - 1)
                assert p.max() - a0 + max(t.kf, coef.shape[1]) <= stride
        for c in range(t.n_chunks):
            steps = t.steps[t.chunk_steps[c]:t.chunk_steps[c + 1]]
            o0, o1 = c * t.ch, min((c + 1) * t.ch, plan.dst_h)
            assert steps[0][4] == o0 and steps[-1][5] == o1
            np.testing.assert_array_equal(steps[1:, 0], steps[:-1, 1])
            np.testing.assert_array_equal(steps[1:, 2], steps[:-1, 3])
            np.testing.assert_array_equal(steps[1:, 4], steps[:-1, 5])
            assert steps[0][0] == plan.v_lum_pos[o0:o1].min()
            assert steps[0][2] == plan.v_chr_pos[o0:o1].min()
            for la, lb, ca, cb, oa, ob, _, _ in steps:
                assert 0 <= lb - la <= t.g_l and 0 <= cb - ca <= t.g_c
                assert lb - la + cb - ca > 0 or ob > oa
                for oy in range(oa, ob):
                    assert plan.v_lum_pos[oy] + plan.v_lum_size <= lb
                    assert plan.v_chr_pos[oy] + plan.v_chr_size <= cb
                    assert lb - plan.v_lum_pos[oy] <= t.ring_l
                    assert cb - plan.v_chr_pos[oy] <= t.ring_c
            assert steps[-1][1] <= plan.src_h
            assert steps[-1][3] <= plan.chr_src_h
        assert t.smem <= tsws.SMEM_BUDGET


@pytest.mark.parametrize("sw,sh,dw,dh", [(1920, 1080, 1280, 720),
                                         (1920, 1080, 320, 90),
                                         (64, 48, 31, 24),
                                         (320, 180, 30, 12)])
def test_each_intermediate_made_once_a_block(sw, sh, dw, dh):
    """In every block each (source row, column) intermediate is made at
    most once; across a strip's chunks the only rows made twice are a
    chunk's halo: rows its first output row reads, which the chunk above
    made too."""
    for full in (False, True):
        planes = _planes(1, sw, sh, 1)
        plan, blocks = _check(planes, dh, dw, full)
        t = plan.tiling
        for blk in blocks.values():
            assert blk.made_l.max() == 1 and blk.made_c.max() == 1
        for s in range(t.n_strips):
            made_l = sum(blocks[0, s, c].made_l for c in range(t.n_chunks))
            made_c = sum(blocks[0, s, c].made_c for c in range(t.n_chunks))
            # every row from the first one read to the last is made
            assert (made_l[plan.v_lum_pos.min():plan.v_lum_pos.max()
                           + plan.v_lum_size] >= 1).all()
            assert (made_c[:, plan.v_chr_pos.min():plan.v_chr_pos.max()
                           + plan.v_chr_size] >= 1).all()
            for c in range(1, t.n_chunks):
                # a row made again is one the chunk's first output row reads
                o0 = c * t.ch
                again_l = np.flatnonzero(blocks[0, s, c].made_l
                                         & blocks[0, s, c - 1].made_l)
                again_c = np.flatnonzero(blocks[0, s, c].made_c[0]
                                         & blocks[0, s, c - 1].made_c[0])
                assert set(again_l) <= set(plan.v_lum_pos[o0] + np.arange(
                    plan.v_lum_size))
                assert set(again_c) <= set(plan.v_chr_pos[o0] + np.arange(
                    plan.v_chr_size))
            assert (made_c[0] == made_c[1]).all()


def test_every_geometry_tiles():
    """Geometries from 1:320 up to 1920:1 get a tiling that fits (their
    coefficients fit the wide path's int16), and the unscaled converter
    takes none."""
    for g in ((1920, 1080, 1280, 720), (3840, 2160, 8, 4),
              (3840, 2160, 2, 2), (16, 4, 200, 4), (2, 2, 640, 360),
              (1920, 1080, 80, 24)):
        for full in (False, True):
            plan = tsws.Plan(*g, full)
            assert plan.tiling.smem <= tsws.SMEM_MAX
    with pytest.raises(ValueError):
        tsws.Plan(64, 48, 64, 48, False).tiling

"""swscale-exact bilinear video resize, yuv420p -> RGBA words
(counterpart of timg_tpu/ops/sws_resize.py).

``--resample=sws-bitexact`` runs the reference's video scaling
algorithm (swscale SWS_BILINEAR, ref src/video-source.cc:352-354,
image-scaler.cc:45-73) on the device with SWS_BITEXACT semantics.  A
CUDA tensor goes through the hand-written kernel (ops/sws_kernel.py,
csrc/sws_yuv420.cu), a CPU tensor through the plain version below,
which repeats the JAX package's ``_pipeline`` in torch integer ops and
is the kernel's oracle.

All arithmetic is int32 with C wraparound.  The plain version computes
in int64 and wraps to int32 (``_w``) before every shift, clip and
compare, which is what int32 arithmetic gives: wrapping commutes with
+, - and *.  Filters and template selection are computed on the host
per geometry (``Plan``, from the port's copy of ops/sws_model.py).
Output is [B, dst_h, dst_w] RGBA-packed int32 words (alpha 255), the
convention of ops/yuv.yuv420_to_rgba_words.  Odd output widths take
libswscale's full-chroma-interpolation path; equal size with an even
height takes the unscaled converter.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from timg_tpu_torch.ops import sws_kernel, sws_model


class Plan:
    """Per-geometry filters + template selection (host-side, numpy;
    timg_tpu/ops/sws_resize.py:Plan)."""

    def __init__(self, src_w: int, src_h: int, dst_w: int, dst_h: int,
                 full_range: bool):
        g = sws_model.sws_geometry(src_w, src_h, dst_w, dst_h)
        self.src_w, self.src_h = src_w, src_h
        self.dst_w, self.dst_h = dst_w, dst_h
        self.chr_src_w, self.chr_src_h = g["chr_src_w"], g["chr_src_h"]
        self.chr_dst_w = g["chr_dst_w"]
        self.full_range = full_range
        hlp, hlc = sws_model.init_filter(g["lum_x_inc"], src_w, dst_w,
                                         4, 1 << 14)
        hcp, hcc = sws_model.init_filter(g["chr_x_inc"], self.chr_src_w,
                                         self.chr_dst_w, 4, 1 << 14)
        vlp, vlc = sws_model.init_filter(g["lum_y_inc"], src_h, dst_h,
                                         2, 1 << 12)
        vcp, vcc = sws_model.init_filter(g["chr_y_inc"], self.chr_src_h,
                                         dst_h, 2, 1 << 12)
        # the filters' first taps ([n]) and coefficients ([n, taps]), as
        # the kernel reads them
        self.h_lum_pos, self.h_chr_pos = (hlp.astype(np.int32),
                                          hcp.astype(np.int32))
        self.v_lum_pos, self.v_chr_pos = (vlp.astype(np.int32),
                                          vcp.astype(np.int32))
        self.h_lum_idx = (hlp[:, None] + np.arange(hlc.shape[1])[None, :]
                          ).astype(np.int32)                  # [dstW, F]
        self.h_lum_coef = hlc.astype(np.int32)
        self.h_chr_idx = (hcp[:, None] + np.arange(hcc.shape[1])[None, :]
                          ).astype(np.int32)
        self.h_chr_coef = hcc.astype(np.int32)
        self.v_lum_idx = (vlp[:, None] + np.arange(vlc.shape[1])[None, :]
                          ).astype(np.int32)                  # [dstH, L]
        self.v_lum_coef = vlc.astype(np.int32)
        self.v_chr_idx = (vcp[:, None] + np.arange(vcc.shape[1])[None, :]
                          ).astype(np.int32)
        self.v_chr_coef = vcc.astype(np.int32)
        self.v_lum_size = vlc.shape[1]
        self.v_chr_size = vcc.shape[1]
        self.full_chroma = dst_w % 2 == 1  # SWS_FULL_CHR_H_INT
        # ff_get_unscaled_swscale gates the equal-size special converter
        # on EVEN dst height (!(dstH & 1)); odd-height equal-size runs
        # the scaled pipeline with identity filters (sws_model probe).
        self.unscaled = (src_w == dst_w and src_h == dst_h
                         and dst_h % 2 == 0)
        if self.v_lum_size == 1 and self.v_chr_size <= 2:
            self.template = 1
            self.uvalpha = (vcc[:, 1].astype(np.int32)
                            if self.v_chr_size == 2
                            else np.zeros(dst_h, np.int32))
        elif self.v_lum_size == 2 and self.v_chr_size == 2:
            self.template = 2
            self.yalpha = vlc[:, 1].astype(np.int32)
            self.uvalpha = vcc[:, 1].astype(np.int32)
        else:
            self.template = 0  # general X

    @functools.cached_property
    def tiling(self) -> "Tiling":
        """The kernel's tiling of this (scaled) geometry: strips, chunks,
        steps, spans and shared-memory layout (``Tiling``)."""
        return Tiling(self)

    def constants(self) -> list:
        """The conversion's six constants in the order the kernel takes
        them: the unscaled or scaled index-table constants (cy, a0, crv,
        cbu, cgu, cgv), or on the full-chroma path yuv2rgb_write_full's
        (y_coe, y_off, v2r, u2b, u2g, v2g)."""
        if self.unscaled:
            cst = (sws_model.FULL_UNSCALED if self.full_range
                   else sws_model.MPEG_UNSCALED)
        elif self.full_chroma:
            cst = sws_model.full_chroma_coeffs(self.full_range)
            return [cst[k] for k in ("y_coe", "y_off", "v2r", "u2b", "u2g",
                                     "v2g")]
        else:
            cst = (sws_model.FULL_SCALED if self.full_range
                   else sws_model.MPEG_SCALED)
        return [cst[k] for k in ("cy", "a0", "crv", "cbu", "cgu", "cgv")]


THREADS = 256              # the kernel's block
# horizontal taps a thread can hold in registers (the kernel's KF)
REG_TAPS = (4, 8, 12, 16, 24, 32)
SMEM_BUDGET = 48 * 1024    # shared memory a block takes where it can
SMEM_MAX = 227 * 1024      # and the most an H100 block can have (bytes)


def _round16(n: int) -> int:
    return (n + 15) & ~15


class Tiling:
    """How ``csrc/sws_yuv420.cu`` cuts a scaled geometry (host side).

    A block makes the words of one strip of ``sw`` output columns and
    one chunk of ``ch`` output rows of one frame.  It walks its chunk in
    steps; a step brings source rows ``[la, lb)`` of luma and ``[ca,
    cb)`` of both chroma planes into shared memory (the strip's byte
    span of each, in 16-byte pieces), runs their horizontal pass once
    into an int32 ring of 15-bit intermediates (``ring_l`` luma rows of
    ``sw`` columns, ``ring_c`` chroma rows of ``swc`` columns a plane;
    source row r in slot (r - the chunk's first row) % ring), then runs
    the vertical pass and the conversion of output rows ``[oa, ob)``
    from the ring.  A chunk's first step also makes the rows its first
    output row shares with the chunk above (its halo); nothing else is
    made twice in a frame.  The byte rows of step s + 1 load while step
    s computes.

    Rows come in increasing order, the rows of an output row are all
    present when it is emitted, and no slot is overwritten while a row
    still to be read holds it: the ring is at least as deep as the rows
    any step holds at once (``_ring``).  Spans are mins and maxes of the
    filters' taps, so they assume no order of the positions; the plan's
    positions are checked nondecreasing all the same.
    """

    def __init__(self, plan: Plan):
        if plan.unscaled:
            raise ValueError("the unscaled converter takes no tiling")
        self.fl = plan.h_lum_coef.shape[1]
        self.fc = plan.h_chr_coef.shape[1]
        for pos in (plan.h_lum_pos, plan.h_chr_pos, plan.v_lum_pos,
                    plan.v_chr_pos):
            if np.any(np.diff(pos) < 0):
                raise ValueError("an sws filter's positions decrease")
        for coef in (plan.h_lum_coef, plan.h_chr_coef):
            # the kernel packs the coefficients as int16 (two taps an
            # instruction; the wide path's shared memory), and sums the
            # taps in any order: no sum of a row may wrap
            if coef.min() < -(1 << 15) or coef.max() >= 1 << 15:
                raise ValueError("an sws coefficient would not fit int16")
            if 255 * int(np.abs(coef).astype(np.int64).sum(1).max()) \
                    >= 1 << 31:
                raise ValueError("an sws horizontal sum could wrap")
        taps = max(self.fl, self.fc)
        # taps in registers, or (0) the wide path: coefficients in
        # shared memory, staged once a block
        self.kf = next((k for k in REG_TAPS if k >= taps), 0)
        x_scale = plan.src_w / plan.dst_w
        first = 128 if x_scale <= 3 else 64 if x_scale <= 12 else 32
        # the first layout that fits, preferring the budget, then wide
        # strips, then many rows a step
        for budget in (SMEM_BUDGET, SMEM_MAX):
            sw = first
            while sw >= 4:
                for cap in (32, 16, 8, 4, 2, 1):
                    self._layout(plan, sw, cap)
                    if self.smem <= budget:
                        return
                sw //= 2
        raise ValueError(
            f"no sws tiling of {plan.src_w}x{plan.src_h} -> "
            f"{plan.dst_w}x{plan.dst_h} fits {SMEM_MAX} bytes of shared "
            "memory")

    def _layout(self, plan: Plan, sw: int, cap: int) -> None:
        full = plan.full_chroma
        self.sw = sw
        self.swc = sw if full else sw // 2
        self.lanes_c = 2 * self.swc          # both chroma planes
        self.n_strips = -(-plan.dst_w // sw)
        # output rows a step emits at most: two passes of the vertical
        # pass's threads (a thread four words of a row)
        self.out_rows = 8 * THREADS // sw
        y_l = plan.src_h / plan.dst_h
        y_c = plan.chr_src_h / plan.dst_h
        # rows a step may bring: enough for its output rows
        self.g_l = max(1, min(cap, int(np.ceil(self.out_rows * y_l)) + 1))
        self.g_c = max(1, min(cap, int(np.ceil(self.out_rows * y_c)) + 1))
        # chunks: about sixteen blocks for each of an H100's 132 SMs at
        # the CLI's 8 frames (several waves, so the last one is short
        # beside the rest), with the halo at most a quarter of a chunk's
        # own rows
        want = -(-16 * 132 // (8 * self.n_strips))
        ch = max(-(-plan.dst_h // want),
                 int(np.ceil(4 * (plan.v_lum_size - 1) / y_l)), 1)
        self.ch = min(ch, plan.dst_h)
        self.n_chunks = -(-plan.dst_h // self.ch)
        self._strip_spans(plan)
        self._steps(plan)
        self._ring(plan)
        # a step's output rows' vertical coefficients, luma then chroma
        vrows = int((self.steps[:, 5] - self.steps[:, 4]).max())
        parts = [("buf", 2 * (self.g_l * self.stride_l
                              + 2 * self.g_c * self.stride_c)),
                 ("vcoef",
                  vrows * (plan.v_lum_size + plan.v_chr_size) * 4),
                 ("ring_l", self.ring_l * sw * 4),
                 ("ring_c", self.ring_c * self.lanes_c * 4)]
        if self.kf == 0:
            parts += [("coef_l", self.fl * sw * 2),
                      ("coef_c", self.fc * self.swc * 2)]
        off = 0
        self.offsets = {}
        for name, size in parts:
            self.offsets[name] = off
            off += _round16(size)
        self.smem = off

    def _strip_spans(self, plan: Plan) -> None:
        """Each strip's first and last source column of luma and chroma
        (``span_l``, ``span_c``: [n_strips, 2]), and what the kernel
        stages (``strips``: [n_strips, 4] int32, the 16-byte-aligned
        first column and the count of 16-byte pieces through the last
        column, luma then chroma); a byte row's stride holds the pieces
        and every register tap past the filter's end."""
        # a register tap path reads up to 4 bytes past its last tap
        reads = self.kf + 4 if self.kf else 1
        spans, strips = [[], []], []
        stride_l = stride_c = 16
        for s in range(self.n_strips):
            row = []
            for k, (pos, f, x0, n) in enumerate((
                    (plan.h_lum_pos, self.fl, s * self.sw, self.sw),
                    (plan.h_chr_pos, self.fc, s * self.sw // (
                        1 if plan.full_chroma else 2), self.swc))):
                p = pos[x0:x0 + n].astype(np.int64)
                first, last = int(p.min()), int(p.max()) + f - 1
                a0 = first & ~15
                n16 = (last - a0) // 16 + 1
                stride = _round16(max(16 * n16, int(p.max()) - a0 + reads))
                if k == 0:
                    stride_l = max(stride_l, stride)
                else:
                    stride_c = max(stride_c, stride)
                spans[k].append((first, last))
                row += [a0, n16]
            strips.append(row)
        self.span_l = np.array(spans[0], np.int64)
        self.span_c = np.array(spans[1], np.int64)
        self.strips = np.array(strips, np.int32)
        self.stride_l, self.stride_c = stride_l, stride_c

    def _steps(self, plan: Plan) -> None:
        """Each chunk's steps (``steps``: [n_steps, 8] int32 la, lb, ca,
        cb, oa, ob and, once the rings are sized, the ring slots of la
        and ca; chunk k's are ``chunk_steps[k]`` to ``chunk_steps[k +
        1]``).  A step takes as many output rows (up to ``out_rows``)
        as fit in ``g_l`` new luma and ``g_c`` new chroma rows; where
        not even one fits, it brings that many rows towards the next
        output row and emits nothing."""
        last_l = plan.v_lum_pos.astype(np.int64) + plan.v_lum_size - 1
        last_c = plan.v_chr_pos.astype(np.int64) + plan.v_chr_size - 1
        steps, starts = [], [0]
        for k in range(self.n_chunks):
            o0, o1 = k * self.ch, min((k + 1) * self.ch, plan.dst_h)
            need_l = np.maximum.accumulate(last_l[o0:o1]) + 1
            need_c = np.maximum.accumulate(last_c[o0:o1]) + 1
            lb = int(plan.v_lum_pos[o0:o1].min())
            cb = int(plan.v_chr_pos[o0:o1].min())
            o = o0
            while o < o1:
                n = 0
                while (n < self.out_rows and o + n < o1
                       and need_l[o + n - o0] <= lb + self.g_l
                       and need_c[o + n - o0] <= cb + self.g_c):
                    n += 1
                if n:
                    nl = max(lb, int(need_l[o + n - 1 - o0]))
                    nc = max(cb, int(need_c[o + n - 1 - o0]))
                else:
                    nl = max(lb, min(lb + self.g_l, int(need_l[o - o0])))
                    nc = max(cb, min(cb + self.g_c, int(need_c[o - o0])))
                steps.append((lb, nl, cb, nc, o, o + n, 0, 0))
                lb, cb, o = nl, nc, o + n
            starts.append(len(steps))
        self.steps = np.array(steps, np.int32).reshape(-1, 8)
        self.chunk_steps = np.array(starts, np.int32)

    def _ring(self, plan: Plan) -> None:
        """Ring depths: at least every row a step writes, every row from
        the first an emitted output row reads to the last written so far
        (``lb``), and a thread's row stride in the horizontal pass; and
        each step's and each output row's first ring slots (``slots``:
        [dst_h, 2] int32, luma and chroma)."""
        ring_l, ring_c = THREADS // self.sw, THREADS // self.lanes_c
        for la, lb, ca, cb, oa, ob, _, _ in self.steps:
            ring_l = max(ring_l, lb - la)
            ring_c = max(ring_c, cb - ca)
            if ob > oa:
                ring_l = max(ring_l, lb - int(plan.v_lum_pos[oa:ob].min()))
                ring_c = max(ring_c, cb - int(plan.v_chr_pos[oa:ob].min()))
        self.ring_l, self.ring_c = int(ring_l), int(ring_c)
        # each step's and each output row's first luma and chroma slot
        chunk = np.arange(plan.dst_h) // self.ch
        first = self.steps[self.chunk_steps[:-1]]
        of_step = np.repeat(np.arange(self.n_chunks),
                            np.diff(self.chunk_steps))
        self.steps[:, 6] = (self.steps[:, 0] - first[of_step, 0]) \
            % self.ring_l
        self.steps[:, 7] = (self.steps[:, 2] - first[of_step, 2]) \
            % self.ring_c
        self.slots = np.stack(
            [(plan.v_lum_pos - first[chunk, 0]) % self.ring_l,
             (plan.v_chr_pos - first[chunk, 2]) % self.ring_c],
            1).astype(np.int32)

    def params(self) -> list:
        """The kernel's int parameters, in the order of ``struct Tile``
        in csrc/sws_yuv420.cu."""
        o = self.offsets
        return [self.sw, self.kf, self.g_l, self.g_c, self.stride_l,
                self.stride_c, self.ring_l, self.ring_c, o["ring_l"],
                o["ring_c"], o["vcoef"], o.get("coef_l", 0),
                o.get("coef_c", 0), self.smem, self.n_strips, self.n_chunks]


@functools.lru_cache(maxsize=32)
def get_plan(src_w: int, src_h: int, dst_w: int, dst_h: int,
             full_range: bool) -> Plan:
    return Plan(src_w, src_h, dst_w, dst_h, full_range)


def _w(x: torch.Tensor) -> torch.Tensor:
    """int64 -> the int32 value C's wraparound gives, kept in int64."""
    return ((x + (1 << 31)) & 0xFFFFFFFF) - (1 << 31)


def _i64(a: np.ndarray, dev) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a)).to(dev, torch.int64)


def _unscaled_pipeline(y, u, v, plan: Plan) -> torch.Tensor:
    """Equal-size special converter (ff_yuv2rgb_get_func_ptr path):
    value-composed conversion, chroma shared per 2x2 block (see
    sws_model.unscaled_yuv420_to_rgba)."""
    cst = (sws_model.FULL_UNSCALED if plan.full_range
           else sws_model.MPEG_UNSCALED)
    h, w = plan.src_h, plan.src_w
    yv = y.to(torch.int64)
    uu = u.to(torch.int64).repeat_interleave(2, 1).repeat_interleave(
        2, 2)[:, :h, :w]
    vv = v.to(torch.int64).repeat_interleave(2, 1).repeat_interleave(
        2, 2)[:, :h, :w]
    f = _w(cst["a0"] + yv * cst["cy"]) >> 16
    r = (f + (_w(cst["crv"] * (vv - 128)) >> 16)).clamp(0, 255)
    g = (f + (_w(cst["cgu"] * (uu - 128)) >> 16)
         + (_w(cst["cgv"] * (vv - 128)) >> 16)).clamp(0, 255)
    b = (f + (_w(cst["cbu"] * (uu - 128)) >> 16)).clamp(0, 255)
    return r | (g << 8) | (b << 16) | -(1 << 24)


def _pipeline(y, u, v, plan: Plan) -> torch.Tensor:
    """[B, H, W] u8 planes -> [B, dstH, dstW] words, in int64 holding
    int32 values (timg_tpu/ops/sws_resize.py:_pipeline)."""
    if plan.unscaled:
        return _unscaled_pipeline(y, u, v, plan)
    dev = y.device

    def hscale(src, idx, coef):
        # [B, H, srcW] u8 -> [B, H, dstW] 15-bit; the sum wraps to int32
        # as the C path's does
        win = src.to(torch.int64).index_select(
            -1, _i64(idx.reshape(-1), dev))
        win = win.reshape(src.shape[:-1] + idx.shape)
        acc = _w((win * _i64(coef, dev)[None, None]).sum(-1))
        return torch.clamp(acc >> 7, max=32767)

    y15 = hscale(y, plan.h_lum_idx, plan.h_lum_coef)
    u15 = hscale(u, plan.h_chr_idx, plan.h_chr_coef)
    v15 = hscale(v, plan.h_chr_idx, plan.h_chr_coef)

    def vlines(p15, idx):
        # [B, srcH, W] -> [B, dstH, L, W]
        g = p15.index_select(1, _i64(idx.reshape(-1), dev))
        return g.reshape(p15.shape[0], idx.shape[0], idx.shape[1],
                         p15.shape[2])

    ly = vlines(y15, plan.v_lum_idx)            # [B, dstH, L, dstW]
    lu = vlines(u15, plan.v_chr_idx)
    lv = vlines(v15, plan.v_chr_idx)

    if plan.full_chroma:
        return _full_chroma_pack(ly, lu, lv, plan)

    if plan.template == 1:
        y1 = (ly[:, :, 0] + 64) >> 7
        if plan.v_chr_size == 2:
            avg = (_i64(plan.uvalpha, dev) >= 2048)[None, :, None]
            uu = torch.where(avg, (lu[:, :, 0] + lu[:, :, 1] + 128) >> 8,
                             (lu[:, :, 0] + 64) >> 7)
            vv = torch.where(avg, (lv[:, :, 0] + lv[:, :, 1] + 128) >> 8,
                             (lv[:, :, 0] + 64) >> 7)
        else:
            uu = (lu[:, :, 0] + 64) >> 7
            vv = (lv[:, :, 0] + 64) >> 7
    elif plan.template == 2:
        ya = _i64(plan.yalpha, dev)[None, :, None]
        uva = _i64(plan.uvalpha, dev)[None, :, None]
        y1 = _w(ly[:, :, 0] * (4096 - ya) + ly[:, :, 1] * ya) >> 19
        uu = _w(lu[:, :, 0] * (4096 - uva) + lu[:, :, 1] * uva) >> 19
        vv = _w(lv[:, :, 0] * (4096 - uva) + lv[:, :, 1] * uva) >> 19
    else:
        vlc = _i64(plan.v_lum_coef, dev)[None, :, :, None]
        vcc = _i64(plan.v_chr_coef, dev)[None, :, :, None]
        y1 = (_w((1 << 18) + (ly * vlc).sum(2)) >> 19).clamp(0, 255)
        uu = (_w((1 << 18) + (lu * vcc).sum(2)) >> 19).clamp(0, 255)
        vv = (_w((1 << 18) + (lv * vcc).sum(2)) >> 19).clamp(0, 255)

    cst = (sws_model.FULL_SCALED if plan.full_range
           else sws_model.MPEG_SCALED)

    def off(c, coef):
        return (_w(c * coef) >> 16) - (coef >> 9)

    def tab(idx):
        return (_w(cst["a0"] + idx * cst["cy"]) >> 16).clamp(0, 255)

    # chroma shared per output pixel pair: [B,dstH,chrW] -> [B,dstH,dstW]
    ou_g, ou_b = off(uu, cst["cgu"]), off(uu, cst["cbu"])
    ov_r, ov_g = off(vv, cst["crv"]), off(vv, cst["cgv"])

    def widen(c):
        return c.repeat_interleave(2, -1)[..., :plan.dst_w]

    r = tab(y1 + widen(ov_r))
    g = tab(y1 + widen(ou_g) + widen(ov_g))
    b = tab(y1 + widen(ou_b))
    return r | (g << 8) | (b << 16) | -(1 << 24)


def _full_chroma_pack(ly, lu, lv, plan: Plan) -> torch.Tensor:
    """Odd dst_w (SWS_FULL_CHR_H_INT): yuv2rgb_full_{1,2,X} vertical
    templates (19-bit >>10 intermediates) + per-pixel
    yuv2rgb_write_full.  The C path's int32 wraparound IS the semantics
    (see sws_model._write_full)."""
    dev = ly.device
    if plan.template == 1:
        y1 = ly[:, :, 0] << 2
        if plan.v_chr_size == 2:
            avg = (_i64(plan.uvalpha, dev) >= 2048)[None, :, None]
            uu = torch.where(avg,
                             (lu[:, :, 0] + lu[:, :, 1] - (128 << 8)) << 1,
                             (lu[:, :, 0] - (128 << 7)) << 2)
            vv = torch.where(avg,
                             (lv[:, :, 0] + lv[:, :, 1] - (128 << 8)) << 1,
                             (lv[:, :, 0] - (128 << 7)) << 2)
        else:
            uu = (lu[:, :, 0] - (128 << 7)) << 2
            vv = (lv[:, :, 0] - (128 << 7)) << 2
    elif plan.template == 2:
        ya = _i64(plan.yalpha, dev)[None, :, None]
        uva = _i64(plan.uvalpha, dev)[None, :, None]
        y1 = _w(ly[:, :, 0] * (4096 - ya) + ly[:, :, 1] * ya) >> 10
        uu = _w(lu[:, :, 0] * (4096 - uva) + lu[:, :, 1] * uva
                - (128 << 19)) >> 10
        vv = _w(lv[:, :, 0] * (4096 - uva) + lv[:, :, 1] * uva
                - (128 << 19)) >> 10
    else:
        vlc = _i64(plan.v_lum_coef, dev)[None, :, :, None]
        vcc = _i64(plan.v_chr_coef, dev)[None, :, :, None]
        y1 = _w((1 << 9) + (ly * vlc).sum(2)) >> 10
        uu = _w((1 << 9) - (128 << 19) + (lu * vcc).sum(2)) >> 10
        vv = _w((1 << 9) - (128 << 19) + (lv * vcc).sum(2)) >> 10

    cst = sws_model.full_chroma_coeffs(plan.full_range)
    y1 = _w((y1 - cst["y_off"]) * cst["y_coe"] + (1 << 21))
    r = _w(y1 + vv * cst["v2r"])
    g = _w(y1 + vv * cst["v2g"] + uu * cst["u2g"])
    b = _w(y1 + uu * cst["u2b"])

    def clip30(x):
        return x.clamp(0, (1 << 30) - 1) >> 22

    return clip30(r) | (clip30(g) << 8) | (clip30(b) << 16) | -(1 << 24)


def sws_yuv420_to_rgba_words_plain(y: torch.Tensor, u: torch.Tensor,
                                   v: torch.Tensor, dst_h: int, dst_w: int,
                                   full_range: bool) -> torch.Tensor:
    """Plain PyTorch version: [B,H,W] y + [B,>=ceil(H/2),>=ceil(W/2)]
    u/v uint8 -> [B,dstH,dstW] int32 RGBA words, on their device."""
    plan = get_plan(y.shape[-1], y.shape[-2], dst_w, dst_h,
                    bool(full_range))
    return _pipeline(y, u, v, plan).to(torch.int32)


def sws_yuv420_to_rgba_words(y: torch.Tensor, u: torch.Tensor,
                             v: torch.Tensor, dst_h: int, dst_w: int,
                             full_range: bool) -> torch.Tensor:
    """[B,H,W] y + [B,ceil(H/2),ceil(W/2)] u/v uint8 -> [B,dstH,dstW]
    int32 RGBA words, byte-equal to libswscale SWS_BILINEAR|
    SWS_BITEXACT; the contract of timg_tpu/ops/sws_resize.py:
    sws_yuv420_to_rgba_words.  A CUDA tensor launches the kernel, a CPU
    tensor runs the plain version."""
    if y.is_cuda:
        plan = get_plan(y.shape[-1], y.shape[-2], dst_w, dst_h,
                        bool(full_range))
        return sws_kernel.sws_yuv420_to_rgba_words_cuda(y, u, v, plan)
    return sws_yuv420_to_rgba_words_plain(y, u, v, dst_h, dst_w, full_range)

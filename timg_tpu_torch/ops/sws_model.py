"""Scalar model of swscale's SWS_BILINEAR|SWS_BITEXACT yuv420p->RGBA path.

The reference scales video frames host-side with swscale SWS_BILINEAR in
the same call that converts YUV->RGBA (ref src/video-source.cc:59-89 +
:352-354, image-scaler.cc:45-73).  VERDICT r3 #3 asks for a device path
bit-equal to an sws-bilinear oracle; SWS_BITEXACT selects libswscale's
platform-independent C kernels (the only variant whose bytes are stable
across hosts), so that is the target semantics.  This module is the
integer-exact scalar model of that path for AV_PIX_FMT_YUV420P ->
AV_PIX_FMT_RGBA, validated byte-for-byte against the real libswscale
6.7.100 (FFmpeg 5.1) via ``timg_sws_scale_yuv420(..., bitexact=1)``
(tests/test_sws_model.py); the device kernel in ops/sws_resize.py is
pinned against THIS model, closing the chain device == scalar == lib.

Pipeline structure (mirrors libswscale's scaled path):

1. horizontal scale: 8-bit source rows -> 15-bit intermediates with
   14-bit filter coefficients (``h_scale_8to15``); chroma is scaled to
   HALF the output width (RGB destinations reuse one chroma sample for
   two pixels unless full-chroma interpolation is requested -- we probe
   and model the default).
2. vertical scale + pack: 12-bit vertical coefficients; one of three
   arithmetic templates is chosen per-session from the vertical filter
   sizes (packed1 for unscaled luma, packed2 for 2-tap luma+chroma,
   packedX in general).
3. YUV->RGB conversion: per-component integer contributions; the exact
   constants below were recovered by exhaustive probing of the oracle
   (every (Y, U) and (Y, V) pair, both ranges) and verified on random
   (U, V) pairs; bilinear-scaled intermediates stay inside [0, 255] so
   the probed domain is complete.

Filter construction (``init_filter``) reconstructs libswscale's
initFilter() for the SWS_BILINEAR case: geometry in 16.16 fixed point,
coefficients accumulated at a dynamic ``fone`` scale, zero-tap
reduction, border folding, and error-diffused normalization to the
14/12-bit target scale.  Uncertain details were settled by probing the
oracle (see tests/test_sws_model.py for the fuzz matrix).
"""

from __future__ import annotations

import numpy as np

# Conversion constants recovered from the oracle (see module docstring).
#
# The SCALED path (any size change) converts through libswscale's
# yuv2rgb index tables: out = clip((A0 + idx*CY) >> 16) with
# idx = Y1 + off(U) + off(V) and off(c) = ((c*COEF) >> 16) - (COEF >> 9)
# (fill_table biases the table pointer by elemsize*(inc>>9), i.e. the
# offset at chroma 128).  CY matches ff_yuv2rgb_coeffs[SWS_CS_ITU601]
# range-scaled; COEF values are the chroma coefficients re-expressed in
# table-index units (value/CY); A0/COEF each have a feasible window --
# every value in it is byte-equivalent over the reachable [0, 255]
# intermediate domain (bilinear filters keep Y1/U/V in range).
MPEG_SCALED = dict(cy=76309, a0=-1304881, crv=89831, cbu=113536,
                   cgu=-22048, cgv=-45754)
FULL_SCALED = dict(cy=65536, a0=32767, crv=91881, cbu=116127,
                   cgu=-22552, cgv=-46793)

# The UNSCALED special converter (srcW==dstW and srcH==dstH hits
# ff_yuv2rgb_get_func_ptr instead of the scaled pipeline) composes in
# VALUE space: out = clip(fY(Y) + k(c)), fY(Y) = (A0 + Y*CY) >> 16,
# k(c) = (COEF*(c-128)) >> 16.  Recovered/verified exhaustively.
# Selection requires EVEN dst height (ff_get_unscaled_swscale's
# ``!(dstH & 1)`` gate); odd-height equal-size runs the normal scaled
# pipeline with identity filters (probed: 63x47/64x47/61x45 match the
# scaled templates byte-exactly, not this converter).  Width parity is
# irrelevant to the gate (63x48 uses this converter).
MPEG_UNSCALED = dict(cy=76309, a0=-1220491, crv=104597, cbu=132201,
                     cgu=-25671, cgv=-53279)
FULL_UNSCALED = dict(cy=65536, a0=32768, crv=91881, cbu=116129,
                     cgu=-22553, cgv=-46802)

SWS_MAX_REDUCE_CUTOFF = 0.002


def full_chroma_coeffs(full_range: bool) -> dict:
    """yuv2rgb_write_full's int16 coefficients (utils.c
    sws_setColorspaceDetails): ITU601 inverse table, range-scaled,
    then roundToInt16(v << 13).  Verified byte-exact by the odd-width
    fuzz matrix in tests/test_sws_model.py."""
    crv, cbu, cgu, cgv = 104597, 132201, -25675, -53279
    cy, oy = 1 << 16, 0
    if not full_range:
        cy = (cy * 255) // 219
        oy = 16 << 16
    else:
        crv = (crv * 224) // 255
        cbu = (cbu * 224) // 255
        cgu = (cgu * 224) // 255
        cgv = (cgv * 224) // 255

    def r16(v):
        return (v + (1 << 15)) >> 16

    return dict(y_coe=r16(cy << 13), y_off=r16(oy << 9),
                v2r=r16(crv << 13), u2b=r16(cbu << 13),
                u2g=r16(cgu << 13), v2g=r16(cgv << 13))


def _c_div(a: int, b: int) -> int:
    """C integer division (truncates toward zero)."""
    q = abs(a) // abs(b)
    return q if (a >= 0) == (b >= 0) else -q


def _rounded_div(a: int, b: int) -> int:
    """libavutil ROUNDED_DIV with C truncating division."""
    return _c_div(a + (b >> 1) if a > 0 else a - (b >> 1), b)


def _av_log2(v: int) -> int:
    return max(int(v).bit_length() - 1, 0)


def init_filter(x_inc: int, src_w: int, dst_w: int, filter_align: int,
                one: int, src_pos: int = 128, dst_pos: int = 128):
    """libswscale initFilter() for SWS_BILINEAR (bitexact C layout).

    Returns (filter_pos int64[dst_w], coeffs int64[dst_w, filter_size]).
    ``one`` is the normalized coefficient sum (1<<14 horizontal,
    1<<12 vertical); positions are in 1/256 pel (get_local_pos output,
    128 = centered, the default for all four filters here).
    """
    fone = 1 << (54 - min(_av_log2(x_inc >> 16), 8))
    if abs(x_inc - 0x10000) < 10 and src_pos == dst_pos:
        # unscaled
        filter_size = 1
        filt = np.full((dst_w, 1), fone, dtype=object)
        pos = np.arange(dst_w, dtype=np.int64)
    else:
        size_factor = 2  # SWS_BILINEAR
        if x_inc <= 1 << 16:
            filter_size = 1 + size_factor  # upscaling
        else:
            filter_size = 1 + (size_factor * src_w + dst_w - 1) // dst_w
        filter_size = min(filter_size, src_w - 2)
        filter_size = max(filter_size, 1)

        filt = np.zeros((dst_w, filter_size), dtype=object)
        pos = np.zeros(dst_w, dtype=np.int64)
        # dst pixel centers mapped into src space, 15.17 fixed point
        x_dst_in_src = ((dst_pos * x_inc) >> 7) - ((src_pos * 0x10000) >> 7)
        for i in range(dst_w):
            xx = _c_div(x_dst_in_src - (filter_size - 2) * (1 << 16),
                        1 << 17)
            pos[i] = xx
            for j in range(filter_size):
                d = abs(xx * (1 << 17) - x_dst_in_src) << 13
                if x_inc > 1 << 16:
                    d = d * dst_w // src_w
                coeff = (1 << 30) - d
                if coeff < 0:
                    coeff = 0
                coeff *= fone >> 30
                filt[i, j] = coeff
                xx += 1
            x_dst_in_src += 2 * x_inc

    # reduce: drop exactly-zero (below cutoff) taps, preserving
    # filterPos monotonicity (libswscale utils.c "step1").
    filter_size = filt.shape[1]
    cutoff_lim = int(SWS_MAX_REDUCE_CUTOFF * fone)
    min_filter_size = 0
    for i in range(dst_w - 1, -1, -1):
        mn = filter_size
        cut = 0
        for _ in range(filter_size):
            cut += abs(int(filt[i, 0]))
            if cut > cutoff_lim:
                break
            if i < dst_w - 1 and pos[i] >= pos[i + 1]:
                break
            filt[i, :-1] = filt[i, 1:]
            filt[i, -1] = 0
            pos[i] += 1
        cut = 0
        for j in range(filter_size - 1, 0, -1):
            cut += abs(int(filt[i, j]))
            if cut > cutoff_lim:
                break
            mn -= 1
        if mn > min_filter_size:
            min_filter_size = mn

    if min_filter_size == 1 and filter_align == 2:
        filter_align = 1  # x86 special case for unscaled vertical
    out_size = (min_filter_size + filter_align - 1) & ~(filter_align - 1)
    out = np.zeros((dst_w, out_size), dtype=object)
    for i in range(dst_w):
        for j in range(out_size):
            if j < filt.shape[1] and j < min_filter_size:
                out[i, j] = filt[i, j]

    # fix borders
    for i in range(dst_w):
        if pos[i] < 0:
            for j in range(1, out_size):
                left = max(j + pos[i], 0)
                out[i, left] += out[i, j]
                if left != j:
                    out[i, j] = 0
            pos[i] = 0
        if pos[i] + out_size > src_w:
            shift = pos[i] + min(out_size - src_w, 0)
            acc = 0
            for j in range(out_size - 1, -1, -1):
                if pos[i] + j >= src_w:
                    acc += out[i, j]
                    out[i, j] = 0
            for j in range(out_size - 1, shift - 1, -1):
                out[i, j] = out[i, j - shift]
            for j in range(shift):
                out[i, j] = 0
            pos[i] -= shift
            out[i, src_w - 1 - pos[i]] += acc

    # normalize to `one` with error diffusion
    final = np.zeros((dst_w, out_size), dtype=np.int64)
    for i in range(dst_w):
        s = sum(int(v) for v in out[i])
        s = (s + one // 2) // one
        if not s:
            s = 1
        err = 0
        for j in range(out_size):
            v = int(out[i, j]) + err
            int_v = _rounded_div(v, s)
            final[i, j] = int_v
            err = v - int_v * s
    return pos, final


def sws_geometry(src_w: int, src_h: int, dst_w: int, dst_h: int):
    """Scale increments + chroma plane sizes for yuv420p -> RGBA.

    Even dst_w: chroma is scaled to HALF the output width and shared by
    pixel pairs.  Odd dst_w: libswscale enables full chroma horizontal
    interpolation (SWS_FULL_CHR_H_INT) -- chroma is scaled to the FULL
    output width and converted per pixel via yuv2rgb_write_full."""
    chr_src_w = -(-src_w // 2)
    chr_src_h = -(-src_h // 2)
    chr_dst_w = dst_w if dst_w % 2 else dst_w // 2
    chr_dst_h = dst_h
    lum_x_inc = ((src_w << 16) + (dst_w >> 1)) // dst_w
    lum_y_inc = ((src_h << 16) + (dst_h >> 1)) // dst_h
    chr_x_inc = ((chr_src_w << 16) + (chr_dst_w >> 1)) // chr_dst_w
    chr_y_inc = ((chr_src_h << 16) + (chr_dst_h >> 1)) // chr_dst_h
    return dict(chr_src_w=chr_src_w, chr_src_h=chr_src_h,
                chr_dst_w=chr_dst_w, chr_dst_h=chr_dst_h,
                lum_x_inc=lum_x_inc, lum_y_inc=lum_y_inc,
                chr_x_inc=chr_x_inc, chr_y_inc=chr_y_inc)


def h_scale_8to15(src_rows: np.ndarray, pos: np.ndarray,
                  coeffs: np.ndarray) -> np.ndarray:
    """hScale8To15_c: [N, srcW] u8 -> [N, dstW] i32 (15-bit clamped)."""
    n, _ = src_rows.shape
    dst_w, fsize = coeffs.shape
    src = src_rows.astype(np.int64)
    out = np.zeros((n, dst_w), np.int64)
    for j in range(fsize):
        out += src[:, pos + j] * coeffs[None, :, j]
    return np.minimum(out >> 7, (1 << 15) - 1)


def _filters(src_w, src_h, dst_w, dst_h):
    g = sws_geometry(src_w, src_h, dst_w, dst_h)
    h_lum = init_filter(g["lum_x_inc"], src_w, dst_w, 4, 1 << 14)
    h_chr = init_filter(g["chr_x_inc"], g["chr_src_w"], g["chr_dst_w"],
                        4, 1 << 14)
    v_lum = init_filter(g["lum_y_inc"], src_h, dst_h, 2, 1 << 12)
    v_chr = init_filter(g["chr_y_inc"], g["chr_src_h"], g["chr_dst_h"],
                        2, 1 << 12)
    return g, h_lum, h_chr, v_lum, v_chr


def _wrap32(x):
    """C int32 wraparound ((unsigned)Y + V*coeff in yuv2rgb_write_full
    wraps mod 2**32 before the sign-bit clip test)."""
    return ((x + (1 << 31)) % (1 << 32)) - (1 << 31)


def _write_full(y1, uu, vv, cst):
    """yuv2rgb_write_full (output.c): value-composed per-pixel
    conversion used on the full-chroma path; av_clip_uintp2(.,30)
    then >>22."""
    y1 = _wrap32(_wrap32((y1 - cst["y_off"]) * cst["y_coe"]) + (1 << 21))
    r = _wrap32(y1 + vv * cst["v2r"])
    g = _wrap32(y1 + vv * cst["v2g"] + uu * cst["u2g"])
    b = _wrap32(y1 + uu * cst["u2b"])

    def clip30(x):
        return np.clip(x, 0, (1 << 30) - 1)

    return clip30(r) >> 22, clip30(g) >> 22, clip30(b) >> 22


def _full_chroma_rows(y15, u15, v15, vlp, vlc, vcp, vcc, dst_h, dst_w,
                      full_range):
    """The yuv2rgb_full_{1,2,X} vertical templates (output.c): same
    three-way selection as the packed path but 19-bit >>10
    intermediates and per-pixel write_full conversion."""
    v_lum_size = vlc.shape[1]
    v_chr_size = vcc.shape[1]
    cst = full_chroma_coeffs(full_range)
    out = np.zeros((dst_h, dst_w, 4), np.uint8)
    for dy in range(dst_h):
        ly = y15[vlp[dy]:vlp[dy] + v_lum_size].astype(np.int64)
        lu = u15[vcp[dy]:vcp[dy] + v_chr_size].astype(np.int64)
        lv = v15[vcp[dy]:vcp[dy] + v_chr_size].astype(np.int64)
        if v_lum_size == 1 and v_chr_size <= 2:
            uvalpha = int(vcc[dy, 1]) if v_chr_size == 2 else 0
            y1 = ly[0] << 2
            if uvalpha < 2048:
                uu = (lu[0] - (128 << 7)) << 2
                vv = (lv[0] - (128 << 7)) << 2
            else:
                uu = (lu[0] + lu[1] - (128 << 8)) << 1
                vv = (lv[0] + lv[1] - (128 << 8)) << 1
        elif v_lum_size == 2 and v_chr_size == 2:
            yalpha = int(vlc[dy, 1])
            uvalpha = int(vcc[dy, 1])
            y1 = (ly[0] * (4096 - yalpha) + ly[1] * yalpha) >> 10
            uu = (lu[0] * (4096 - uvalpha) + lu[1] * uvalpha
                  - (128 << 19)) >> 10
            vv = (lv[0] * (4096 - uvalpha) + lv[1] * uvalpha
                  - (128 << 19)) >> 10
        else:
            y1 = ((1 << 9) + (ly * vlc[dy][:, None]).sum(0)) >> 10
            uu = ((1 << 9) - (128 << 19)
                  + (lu * vcc[dy][:, None]).sum(0)) >> 10
            vv = ((1 << 9) - (128 << 19)
                  + (lv * vcc[dy][:, None]).sum(0)) >> 10
        r, g, b = _write_full(y1, uu, vv, cst)
        out[dy, :, 0] = r
        out[dy, :, 1] = g
        out[dy, :, 2] = b
        out[dy, :, 3] = 255
    return out


def sws_bilinear_yuv420_to_rgba(y: np.ndarray, u: np.ndarray,
                                v: np.ndarray, dst_h: int, dst_w: int,
                                full_range: bool) -> np.ndarray:
    """The full scalar pipeline; byte-equal to the bitexact oracle."""
    src_h, src_w = y.shape
    if dst_h == src_h and dst_w == src_w and dst_h % 2 == 0:
        # ff_get_unscaled_swscale selects the yuv2rgb special converter
        # only for even dst heights; odd heights stay on the scaled path.
        return unscaled_yuv420_to_rgba(y, u, v, full_range)

    g, (hlp, hlc), (hcp, hcc), (vlp, vlc), (vcp, vcc) = _filters(
        src_w, src_h, dst_w, dst_h)

    y15 = h_scale_8to15(y, hlp, hlc)                 # [srcH, dstW]
    u15 = h_scale_8to15(u, hcp, hcc)                 # [chrSrcH, chrDstW]
    v15 = h_scale_8to15(v, hcp, hcc)

    v_lum_size = vlc.shape[1]
    v_chr_size = vcc.shape[1]

    if dst_w % 2:
        return _full_chroma_rows(y15, u15, v15, vlp, vlc, vcp, vcc,
                                 dst_h, dst_w, full_range)

    out = np.zeros((dst_h, dst_w, 4), np.uint8)
    cst = FULL_SCALED if full_range else MPEG_SCALED
    for dy in range(dst_h):
        lum_lines = y15[vlp[dy]:vlp[dy] + v_lum_size]      # [L, dstW]
        u_lines = u15[vcp[dy]:vcp[dy] + v_chr_size]
        v_lines = v15[vcp[dy]:vcp[dy] + v_chr_size]
        if v_lum_size == 1 and v_chr_size <= 2:
            # yuv2packed1: luma/chroma taken (almost) directly
            uvalpha = int(vcc[dy, 1]) if v_chr_size == 2 else 0
            y1 = (lum_lines[0] + 64) >> 7
            if uvalpha < 2048:
                uu = (u_lines[0] + 64) >> 7
                vv = (v_lines[0] + 64) >> 7
            else:
                uu = (u_lines[0] + u_lines[1] + 128) >> 8
                vv = (v_lines[0] + v_lines[1] + 128) >> 8
        elif v_lum_size == 2 and v_chr_size == 2:
            # yuv2packed2: blend two lines, no rounding bias
            yalpha = int(vlc[dy, 1])
            uvalpha = int(vcc[dy, 1])
            y1 = (lum_lines[0] * (4096 - yalpha)
                  + lum_lines[1] * yalpha) >> 19
            uu = (u_lines[0] * (4096 - uvalpha)
                  + u_lines[1] * uvalpha) >> 19
            vv = (v_lines[0] * (4096 - uvalpha)
                  + v_lines[1] * uvalpha) >> 19
        else:
            # yuv2packedX: 1<<18 bias, then conditional clip
            y1 = (1 << 18) + (lum_lines * vlc[dy][:, None]).sum(0)
            uu = (1 << 18) + (u_lines * vcc[dy][:, None]).sum(0)
            vv = (1 << 18) + (v_lines * vcc[dy][:, None]).sum(0)
            y1 >>= 19
            uu >>= 19
            vv >>= 19
            y1 = np.clip(y1, 0, 255)
            uu = np.clip(uu, 0, 255)
            vv = np.clip(vv, 0, 255)

        # chroma (chr_dst_w samples) is shared by output pixel pairs
        uu_px = np.repeat(uu, 2)[:dst_w]
        vv_px = np.repeat(vv, 2)[:dst_w]

        def off(c, coef):
            return ((c * coef) >> 16) - (coef >> 9)

        def tab(idx):
            return np.clip((cst["a0"] + idx * cst["cy"]) >> 16, 0, 255)

        out[dy, :, 0] = tab(y1 + off(vv_px, cst["crv"]))
        out[dy, :, 1] = tab(y1 + off(uu_px, cst["cgu"])
                            + off(vv_px, cst["cgv"]))
        out[dy, :, 2] = tab(y1 + off(uu_px, cst["cbu"]))
        out[dy, :, 3] = 255
    return out


def unscaled_yuv420_to_rgba(y: np.ndarray, u: np.ndarray, v: np.ndarray,
                            full_range: bool) -> np.ndarray:
    """The equal-size special converter (ff_yuv2rgb_get_func_ptr path).

    Value-composed conversion with chroma shared per 2x2 block;
    recovered exhaustively from the oracle at identity geometry."""
    src_h, src_w = y.shape
    cst = FULL_UNSCALED if full_range else MPEG_UNSCALED
    yv = y.astype(np.int64)
    uu = np.repeat(np.repeat(u.astype(np.int64), 2, 0), 2, 1)[:src_h, :src_w]
    vv = np.repeat(np.repeat(v.astype(np.int64), 2, 0), 2, 1)[:src_h, :src_w]
    f = (cst["a0"] + yv * cst["cy"]) >> 16
    out = np.zeros((src_h, src_w, 4), np.uint8)
    out[:, :, 0] = np.clip(f + ((cst["crv"] * (vv - 128)) >> 16), 0, 255)
    out[:, :, 1] = np.clip(f + ((cst["cgu"] * (uu - 128)) >> 16)
                           + ((cst["cgv"] * (vv - 128)) >> 16), 0, 255)
    out[:, :, 2] = np.clip(f + ((cst["cbu"] * (uu - 128)) >> 16), 0, 255)
    out[:, :, 3] = 255
    return out

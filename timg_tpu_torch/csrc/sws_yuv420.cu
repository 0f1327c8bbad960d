// swscale SWS_BILINEAR | SWS_BITEXACT, yuv420p -> RGBA words.
//
// Replaces timg_tpu/ops/sws_resize.py sws_yuv420_to_rgba_words (XLA in
// the reference, no Pallas kernel), whose arithmetic is libswscale's
// bitexact C path: a horizontal pass of 8-bit samples into 15-bit
// intermediates (14-bit coefficients, >> 7, min 32767), a vertical pass
// with 12-bit coefficients in one of three templates (1: one luma tap,
// chroma one tap or the two-tap average gated on uvalpha >= 2048; 2:
// two taps each; 0: the general sum, rounded >> 19 and clipped), then
// the conversion: the yuv2rgb index tables for even output widths (one
// chroma column for each pixel pair), yuv2rgb_write_full for odd ones
// (chroma at the full width), or, at equal size and even height, the
// unscaled converter (chroma shared by each 2x2 block).
//
// All of it is int32 with C wraparound, which is the semantics where
// the full-chroma conversion overflows: every +, - and * here runs in
// uint32_t and is read back as int32_t before a shift, a clip or a
// compare, so a right shift is arithmetic on a negative value and no
// signed overflow is undefined.  No float anywhere.
//
// Input: [B, H, W] Y and two [B, CH, CW] chroma planes, uint8,
// contiguous (CH >= ceil(H / 2), CW >= ceil(W / 2)); the plan's tables:
// for each output column the first source column and the coefficients
// of the horizontal filter (luma and chroma), for each output row the
// first source row and the coefficients of the vertical filter (luma
// and chroma), int32, every tap inside its plane (the wrapper checks).
// Output: [B, dst_h, dst_w] int32 words R | G << 8 | B << 16 |
// 0xFF000000.
//
// Layout: a thread makes the two words of one output pixel pair of one
// row.  It runs the horizontal filter of each source row its vertical
// filter reads, in registers, for its two luma columns, and for the
// pair's one chroma column (each pixel's own on the full-chroma path),
// so an intermediate of the separable passes is made again by every
// output row that reads it (L luma and LC chroma rows, 4 and 2 at 1080p
// -> 720p); nothing goes through device memory between the passes.
// Neighbouring threads read neighbouring source bytes and the same
// table rows, which L1 serves.  Bound on the H100: about even between
// device-memory bytes (1.5 B in, 4 B out a pixel) and the integer
// operations the function needs; this first design spends more
// operations than that, making intermediates again.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

typedef uint32_t u32;

struct Consts {
  // scaled and unscaled: cy, a0, crv, cbu, cgu, cgv; full chroma: y_coe,
  // y_off, v2r, u2b, u2g, v2g
  int k[6];
};

struct Tables {
  const int* h_pos;    // [dst_w] first luma source column
  const int* h_coef;   // [dst_w, fl]
  const int* hc_pos;   // [chr_dst_w] first chroma source column
  const int* hc_coef;  // [chr_dst_w, fc]
  const int* v_pos;    // [dst_h] first luma source row
  const int* v_coef;   // [dst_h, l]
  const int* vc_pos;   // [dst_h] first chroma source row
  const int* vc_coef;  // [dst_h, lc]
  int fl, fc, l, lc;
};

__device__ __forceinline__ int32_t s32(u32 x) { return (int32_t)x; }

__device__ __forceinline__ int32_t clampi(int32_t x, int32_t lo,
                                          int32_t hi) {
  return min(max(x, lo), hi);
}

// hScale8To15_c at one output column of one source row
__device__ __forceinline__ int32_t hsample(const uint8_t* __restrict__ row,
                                           const int* __restrict__ pos,
                                           const int* __restrict__ coef,
                                           int taps, int x) {
  const uint8_t* src = row + __ldg(pos + x);
  const int* c = coef + (int64_t)x * taps;
  u32 acc = 0;
  for (int j = 0; j < taps; ++j)
    acc += (u32)__ldg(src + j) * (u32)__ldg(c + j);
  return min(s32(acc) >> 7, 32767);
}

// The vertical pass of one plane at output row oy and intermediate
// column x, in the template of the plan: for template 0 the rounded sum
// (>> 19 and clipped, or >> 10 on the full-chroma path), for templates
// 1 and 2 the per-template arithmetic of the luma (CHROMA false) or of
// the chroma (CHROMA true).
template <bool FULL, bool CHROMA>
__device__ __forceinline__ int32_t vertical(
    const uint8_t* __restrict__ plane, int stride,
    const int* __restrict__ hpos, const int* __restrict__ hcoef, int ftaps,
    int r0, const int* __restrict__ vcoef, int vtaps, int tmpl, int x) {
  if (tmpl == 0) {
    u32 acc = FULL ? (CHROMA ? (1u << 9) - (128u << 19) : (1u << 9))
                   : (1u << 18);
    for (int t = 0; t < vtaps; ++t) {
      const int32_t s = hsample(plane + (int64_t)(r0 + t) * stride, hpos,
                                hcoef, ftaps, x);
      acc += (u32)s * (u32)__ldg(vcoef + t);
    }
    return FULL ? s32(acc) >> 10 : clampi(s32(acc) >> 19, 0, 255);
  }
  const int32_t a = hsample(plane + (int64_t)r0 * stride, hpos, hcoef,
                            ftaps, x);
  const int32_t b = vtaps > 1 ? hsample(plane + (int64_t)(r0 + 1) * stride,
                                        hpos, hcoef, ftaps, x)
                              : 0;
  if (tmpl == 2) {
    const u32 alpha = (u32)__ldg(vcoef + 1);
    const u32 mix = (u32)a * (4096u - alpha) + (u32)b * alpha;
    if (FULL)
      return s32(CHROMA ? mix - (128u << 19) : mix) >> 10;
    return s32(mix) >> 19;
  }
  // template 1
  if (!CHROMA) return FULL ? s32((u32)a << 2) : (a + 64) >> 7;
  const bool avg = vtaps == 2 && __ldg(vcoef + 1) >= 2048;
  if (FULL)
    return avg ? s32(((u32)a + (u32)b - (128u << 8)) << 1)
               : s32(((u32)a - (128u << 7)) << 2);
  return avg ? (a + b + 128) >> 8 : (a + 64) >> 7;
}

// libswscale's yuv2rgb index tables: out = clip((a0 + idx * cy) >> 16)
__device__ __forceinline__ int32_t tab(const Consts& c, u32 idx) {
  return clampi(s32((u32)c.k[1] + idx * (u32)c.k[0]) >> 16, 0, 255);
}

__device__ __forceinline__ u32 off(int32_t v, int coef) {
  return (u32)((s32((u32)v * (u32)coef) >> 16) - (coef >> 9));
}

__device__ __forceinline__ int32_t pack(int32_t r, int32_t g, int32_t b) {
  return s32((u32)r | ((u32)g << 8) | ((u32)b << 16) | 0xFF000000u);
}

// yuv2rgb_write_full: av_clip_uintp2(., 30) >> 22 of each channel
__device__ __forceinline__ int32_t write_full(const Consts& c, int32_t y1,
                                              int32_t uu, int32_t vv) {
  const u32 y = ((u32)y1 - (u32)c.k[1]) * (u32)c.k[0] + (1u << 21);
  const u32 r = y + (u32)vv * (u32)c.k[2];
  const u32 g = y + (u32)vv * (u32)c.k[5] + (u32)uu * (u32)c.k[4];
  const u32 b = y + (u32)uu * (u32)c.k[3];
  constexpr int32_t top = (1 << 30) - 1;
  return pack(clampi(s32(r), 0, top) >> 22, clampi(s32(g), 0, top) >> 22,
              clampi(s32(b), 0, top) >> 22);
}

template <bool FULL>
__global__ void __launch_bounds__(kThreads)
sws_scaled(const uint8_t* __restrict__ y, const uint8_t* __restrict__ u,
           const uint8_t* __restrict__ v, int h, int w, int ch, int cw,
           int dst_h, int dst_w, int pairs, int tmpl, Tables t, Consts c,
           int32_t* __restrict__ out) {
  const int g = blockIdx.x * kThreads + threadIdx.x;
  if (g >= dst_h * pairs) return;
  const int frame = blockIdx.y;
  const int oy = g / pairs;
  const int p = g - oy * pairs;
  const uint8_t* yf = y + (int64_t)frame * h * w;
  const uint8_t* uf = u + (int64_t)frame * ch * cw;
  const uint8_t* vf = v + (int64_t)frame * ch * cw;
  const int ry = __ldg(t.v_pos + oy);
  const int rc = __ldg(t.vc_pos + oy);
  const int* vl = t.v_coef + (int64_t)oy * t.l;
  const int* vc = t.vc_coef + (int64_t)oy * t.lc;

  int32_t words[2];
  int32_t uu = 0, vv = 0;
  if (!FULL) {   // one chroma column for the pair
    uu = vertical<false, true>(uf, cw, t.hc_pos, t.hc_coef, t.fc, rc,
                               vc, t.lc, tmpl, p);
    vv = vertical<false, true>(vf, cw, t.hc_pos, t.hc_coef, t.fc, rc,
                               vc, t.lc, tmpl, p);
  }
  const int n = min(2, dst_w - 2 * p);
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    if (k >= n) break;
    const int ox = 2 * p + k;
    const int32_t y1 = vertical<FULL, false>(yf, w, t.h_pos, t.h_coef,
                                             t.fl, ry, vl, t.l, tmpl, ox);
    if (FULL) {
      uu = vertical<true, true>(uf, cw, t.hc_pos, t.hc_coef, t.fc, rc,
                                vc, t.lc, tmpl, ox);
      vv = vertical<true, true>(vf, cw, t.hc_pos, t.hc_coef, t.fc, rc,
                                vc, t.lc, tmpl, ox);
      words[k] = write_full(c, y1, uu, vv);
    } else {
      const u32 yy = (u32)y1;
      words[k] = pack(tab(c, yy + off(vv, c.k[2])),
                      tab(c, yy + off(uu, c.k[4]) + off(vv, c.k[5])),
                      tab(c, yy + off(uu, c.k[3])));
    }
  }
  int32_t* dst = out + ((int64_t)frame * dst_h + oy) * dst_w + 2 * p;
  if (n == 2 && ((uintptr_t)dst & 7) == 0) {
    *reinterpret_cast<int2*>(dst) = make_int2(words[0], words[1]);
  } else {
    dst[0] = words[0];
    if (n == 2) dst[1] = words[1];
  }
}

// Equal size, even height: out = clip(fY(Y) + k(c)) with fY(Y) = (a0 +
// Y cy) >> 16 and k(c) = (coef (c - 128)) >> 16, chroma from the 2x2
// block's sample.
__global__ void __launch_bounds__(kThreads)
sws_unscaled(const uint8_t* __restrict__ y, const uint8_t* __restrict__ u,
             const uint8_t* __restrict__ v, int h, int w, int ch, int cw,
             int pairs, Consts c, int32_t* __restrict__ out) {
  const int g = blockIdx.x * kThreads + threadIdx.x;
  if (g >= h * pairs) return;
  const int frame = blockIdx.y;
  const int row = g / pairs;
  const int p = g - row * pairs;
  const int64_t ci = ((int64_t)frame * ch + (row >> 1)) * cw + p;
  const int32_t du = (int32_t)__ldg(u + ci) - 128;
  const int32_t dv = (int32_t)__ldg(v + ci) - 128;
  const int32_t kr = s32((u32)c.k[2] * (u32)dv) >> 16;
  const int32_t kg = (s32((u32)c.k[4] * (u32)du) >> 16)
                     + (s32((u32)c.k[5] * (u32)dv) >> 16);
  const int32_t kb = s32((u32)c.k[3] * (u32)du) >> 16;
  const int64_t p0 = ((int64_t)frame * h + row) * w + 2 * p;
  const int n = min(2, w - 2 * p);
  int32_t words[2];
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    if (k >= n) break;
    const int32_t f =
        s32((u32)c.k[1] + (u32)__ldg(y + p0 + k) * (u32)c.k[0]) >> 16;
    words[k] = pack(clampi(f + kr, 0, 255), clampi(f + kg, 0, 255),
                    clampi(f + kb, 0, 255));
  }
  int32_t* dst = out + p0;
  if (n == 2 && ((uintptr_t)dst & 7) == 0) {
    *reinterpret_cast<int2*>(dst) = make_int2(words[0], words[1]);
  } else {
    dst[0] = words[0];
    if (n == 2) dst[1] = words[1];
  }
}

}  // namespace

// y: [b, h, w], u and v: [b, ch, cw], uint8, contiguous; tables as in
// the notes above, on the device; consts: six host ints; tmpl 0, 1 or
// 2; full_chroma: odd dst_w; unscaled: the equal-size converter (the
// tables are not read); out: [b, dst_h, dst_w] int32.
extern "C" int timg_sws_yuv420_to_rgba_words(
    const void* y, const void* u, const void* v, int b, int h, int w,
    int ch, int cw, int dst_h, int dst_w, const void* h_pos,
    const void* h_coef, int fl, const void* hc_pos, const void* hc_coef,
    int fc, const void* v_pos, const void* v_coef, int l,
    const void* vc_pos, const void* vc_coef, int lc, int tmpl,
    int full_chroma, int unscaled, const int* consts, void* out,
    void* stream) {
  if (b <= 0 || dst_h <= 0 || dst_w <= 0) return 0;
  if (b > 65535 || 2 * ch < h || 2 * cw < w)
    return (int)cudaErrorInvalidValue;
  Consts c;
  for (int i = 0; i < 6; ++i) c.k[i] = consts[i];
  const auto* yp = (const uint8_t*)y;
  const auto* up = (const uint8_t*)u;
  const auto* vp = (const uint8_t*)v;
  auto* o = (int32_t*)out;
  cudaStream_t s = (cudaStream_t)stream;
  const int pairs = (dst_w + 1) / 2;
  const dim3 grid((int)(((int64_t)dst_h * pairs + kThreads - 1) / kThreads),
                  b);
  if (unscaled) {
    if (dst_h != h || dst_w != w) return (int)cudaErrorInvalidValue;
    sws_unscaled<<<grid, kThreads, 0, s>>>(yp, up, vp, h, w, ch, cw, pairs,
                                           c, o);
    return (int)cudaGetLastError();
  }
  Tables t{(const int*)h_pos,  (const int*)h_coef,  (const int*)hc_pos,
           (const int*)hc_coef, (const int*)v_pos,  (const int*)v_coef,
           (const int*)vc_pos, (const int*)vc_coef, fl, fc, l, lc};
  if (full_chroma)
    sws_scaled<true><<<grid, kThreads, 0, s>>>(yp, up, vp, h, w, ch, cw,
                                               dst_h, dst_w, pairs, tmpl, t,
                                               c, o);
  else
    sws_scaled<false><<<grid, kThreads, 0, s>>>(yp, up, vp, h, w, ch, cw,
                                                dst_h, dst_w, pairs, tmpl,
                                                t, c, o);
  return (int)cudaGetLastError();
}

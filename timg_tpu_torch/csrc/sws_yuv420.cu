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
// and chroma), int32, every tap inside its plane (the wrapper checks);
// and the plan's tiling (ops/sws_resize.py: Tiling): each strip's
// staged byte span, each chunk's steps, the ring depths and the shared
// memory layout.  Output: [B, dst_h, dst_w] int32 words R | G << 8 | B
// << 16 | 0xFF000000.
//
// Layout (sws_tiled): a block of 256 threads makes one strip of SW
// output columns (128, 64, ... as the plan picks) and one chunk of
// output rows of one frame, in the steps the plan lists.  A step
// stages the strip's byte span of its new source rows of Y, U and V in
// shared memory with 16-byte cp.async copies (byte loads where a
// plane's rows are not 16-byte aligned), the next step's copies in
// flight while this one computes; then each thread runs the horizontal
// filter of its one column down the step's new rows, in two runs (up
// to the ring's end, then from its start), into int32 rings of 15-bit
// intermediates: a column's position and coefficients sit in registers
// from the block's start (from 8 taps on, dp2a takes two taps an
// instruction from four staged bytes), or on the wide path, more than
// 32 taps, in shared memory; then the vertical filter and the
// conversion of the step's output rows, a thread the same four words
// of every eighth (SW 128) row, the step's vertical coefficients staged
// in shared memory and read there by every thread of a row, stored 16
// bytes wide where the row's alignment allows.  So a block makes each
// (source row, column) intermediate once; a chunk makes again only the
// rows its first output row shares with the chunk above.
//
// Bound on the H100: about even between device-memory bytes (1.5 B in,
// 4 B out a pixel) and the integer operations the function needs
// (chip_smoke's count, about 45 a pixel at 1080p -> 720p).  The kernel
// issues about twice that (the loads', the rings' and the loops' own
// instructions) and waits on its integer pipe (64 lanes an SM) at the
// main path's geometry; at a deep vertical filter (the block window's
// 24 taps) a block's serial steps wait on their loads and barriers.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// a block's threads; the tiling assumes as many (THREADS in
// ops/sws_resize.py)
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

// The plan's tiling (ops/sws_resize.py Tiling.params(), same order),
// and its tables on the device.
struct Tile {
  int sw;        // output columns a strip (a power of two, 4 to 128)
  int kf;        // horizontal taps in registers, or 0: the wide path
  int g_l, g_c;  // byte rows a step stages (luma; each chroma plane)
  int stride_l, stride_c;      // a staged byte row's stride
  int ring_l, ring_c;          // ring depths in rows
  int off_ring_l, off_ring_c;  // shared memory offsets
  int off_vcoef;               // a step's vertical coefficients
  int off_coef_l, off_coef_c;  // (wide path)
  int smem;                    // dynamic shared memory bytes
  int n_strips, n_chunks;
  const int* strips;        // [n_strips, 4] a0 and 16-byte pieces of
                            // luma, then chroma
  const int* steps;         // [n_steps, 8] la, lb, ca, cb, oa, ob and
                            // the ring slots of la and ca
  const int* chunk_steps;   // [n_chunks + 1]
  const int* slots;         // [dst_h, 2] an output row's first ring slot
                            // of luma and of chroma
};

__device__ __forceinline__ int32_t s32(u32 x) { return (int32_t)x; }

__device__ __forceinline__ int32_t clampi(int32_t x, int32_t lo,
                                          int32_t hi) {
  return min(max(x, lo), hi);
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}

// n rows of one plane's strip span, from byte column a0, n16 pieces of
// 16 bytes a row, into dst (a row every stride bytes): cp.async where
// the plane's rows are 16-byte aligned (then no piece leaves its row),
// else byte loads up to the row's end.
__device__ __forceinline__ void stage_rows(
    uint8_t* __restrict__ dst, int stride, const uint8_t* __restrict__ src,
    int row_len, int r0, int n, int a0, int n16, bool aligned, int first,
    int count) {
  for (int i = first; i < count; i += kThreads) {
    const int r = i / n16;
    const int p = i - r * n16;
    const int col = a0 + 16 * p;
    const uint8_t* from = src + (int64_t)(r0 + r) * row_len + col;
    uint8_t* to = dst + r * stride + 16 * p;
    if (aligned) {
      cp_async16(to, from);
    } else {
      const int m = min(16, row_len - col);
      for (int j = 0; j < m; ++j) to[j] = __ldg(from + j);
    }
  }
}

// N adjacent intermediates of a ring row (16 or 8 bytes, aligned)
template <int N>
__device__ __forceinline__ void ring_load(const int32_t* p, int32_t* v) {
  if (N == 4) {
    const int4 x = *reinterpret_cast<const int4*>(p);
    v[0] = x.x;
    v[1] = x.y;
    v[2] = x.z;
    v[3] = x.w;
  } else {
    const int2 x = *reinterpret_cast<const int2*>(p);
    v[0] = x.x;
    v[1] = x.y;
  }
}

// clip(x, 0, 255) in one instruction on Hopper (max(min(x, 255), 0))
__device__ __forceinline__ int32_t clip255(int32_t x) {
  return __vimin_s32_relu(x, 255);
}

// The vertical pass of one plane at one output row for N adjacent
// intermediate columns of the ring (the output row's first source row
// at `ring`, tap t a row of rstride further on, wrapping from `end` back
// by `span` elements), in the template of the plan: for template 0 the
// rounded sum (>> 19 and clipped, or >> 10 on the full-chroma path), for
// templates 1 and 2 the per-template arithmetic of the luma (CHROMA
// false) or of the chroma (CHROMA true).
// vcoef is the output row's (in shared memory), the same for every
// thread of the row.
template <bool FULL, bool CHROMA, int N>
__device__ __forceinline__ void vertical(const int32_t* ring, int rstride,
                                         const int32_t* end, int span,
                                         const int* __restrict__ vcoef,
                                         int vtaps, int tmpl, int32_t* out) {
  if (tmpl == 0) {
    u32 acc[N];
#pragma unroll
    for (int k = 0; k < N; ++k)
      acc[k] = FULL ? (CHROMA ? (1u << 9) - (128u << 19) : (1u << 9))
                    : (1u << 18);
#pragma unroll 4
    for (int t = 0; t < vtaps; ++t) {
      const u32 c = (u32)vcoef[t];
      int32_t s[N];
      ring_load<N>(ring, s);
#pragma unroll
      for (int k = 0; k < N; ++k) acc[k] += (u32)s[k] * c;
      ring += rstride;
      if (ring >= end) ring -= span;
    }
#pragma unroll
    for (int k = 0; k < N; ++k)
      out[k] = FULL ? s32(acc[k]) >> 10 : clip255(s32(acc[k]) >> 19);
    return;
  }
  int32_t a[N], b[N];
  ring_load<N>(ring, a);
  if (vtaps > 1) {
    ring += rstride;
    ring_load<N>(ring >= end ? ring - span : ring, b);
  } else {
#pragma unroll
    for (int k = 0; k < N; ++k) b[k] = 0;
  }
  if (tmpl == 2) {
    const u32 alpha = (u32)vcoef[1];
#pragma unroll
    for (int k = 0; k < N; ++k) {
      const u32 mix = (u32)a[k] * (4096u - alpha) + (u32)b[k] * alpha;
      out[k] = FULL ? s32(CHROMA ? mix - (128u << 19) : mix) >> 10
                    : s32(mix) >> 19;
    }
    return;
  }
  // template 1
  const bool avg = CHROMA && vtaps == 2 && vcoef[1] >= 2048;
#pragma unroll
  for (int k = 0; k < N; ++k) {
    if (!CHROMA)
      out[k] = FULL ? s32((u32)a[k] << 2) : (a[k] + 64) >> 7;
    else if (FULL)
      out[k] = avg ? s32(((u32)a[k] + (u32)b[k] - (128u << 8)) << 1)
                   : s32(((u32)a[k] - (128u << 7)) << 2);
    else
      out[k] = avg ? (a[k] + b[k] + 128) >> 8 : (a[k] + 64) >> 7;
  }
}

// libswscale's yuv2rgb index tables: out = clip((a0 + idx * cy) >> 16)
__device__ __forceinline__ int32_t tab(const Consts& c, u32 idx) {
  return clip255(s32((u32)c.k[1] + idx * (u32)c.k[0]) >> 16);
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

// acc + a.lo16 * b.byte0 + a.hi16 * b.byte1 (HI: bytes 2 and 3), the
// halves of a signed and the bytes of b unsigned, in 32-bit arithmetic
template <bool HI>
__device__ __forceinline__ u32 dp2a(u32 a, u32 b, u32 acc) {
  if (HI)
    asm("dp2a.hi.s32.u32 %0, %1, %2, %0;" : "+r"(acc) : "r"(a), "r"(b));
  else
    asm("dp2a.lo.s32.u32 %0, %1, %2, %0;" : "+r"(acc) : "r"(a), "r"(b));
  return acc;
}

// hScale8To15_c of one staged row at one column: KF taps from registers
// (zero past the filter; the stride holds the bytes they read: from 8
// taps on, four bytes at a time from aligned words, two taps an
// instruction), or on the wide path (KF 0) the filter's taps from
// shared memory, a tap's coefficients a row of `cstride`.  The plan
// checks that no sum can wrap, so the order of the taps is free.
template <int KF>
__device__ __forceinline__ int32_t hsample(const uint8_t* __restrict__ src,
                                           const int* cf,
                                           const int16_t* cs, int cstride,
                                           int taps) {
  u32 acc = 0;
  if (KF >= 8) {
    const uintptr_t a = (uintptr_t)src;
    const u32* wp = reinterpret_cast<const u32*>(a & ~(uintptr_t)3);
    const u32 sh = (u32)(a & 3) * 8;
    u32 w0 = wp[0];
#pragma unroll
    for (int j = 0; j < KF; j += 4) {
      const u32 w1 = wp[j / 4 + 1];
      const u32 b4 = __funnelshift_r(w0, w1, sh);
      acc = dp2a<false>(((u32)cf[j] & 0xFFFFu) | ((u32)cf[j + 1] << 16), b4,
                        acc);
      acc = dp2a<true>(((u32)cf[j + 2] & 0xFFFFu) | ((u32)cf[j + 3] << 16),
                       b4, acc);
      w0 = w1;
    }
  } else if (KF > 0) {
#pragma unroll
    for (int j = 0; j < KF; ++j) acc += (u32)src[j] * (u32)cf[j];
  } else {
    for (int j = 0; j < taps; ++j)
      acc += (u32)src[j] * (u32)(int32_t)cs[j * cstride];
  }
  return min(s32(acc) >> 7, 32767);
}

// A column's position in its staged span and its KF coefficients, once
// a block.
template <int KF>
__device__ __forceinline__ int load_column(const int* __restrict__ pos,
                                           const int* __restrict__ coef,
                                           int taps, int x, int a0,
                                           int* cf) {
#pragma unroll
  for (int j = 0; j < (KF > 0 ? KF : 1); ++j)
    cf[j] = KF > 0 && j < taps ? __ldg(coef + (int64_t)x * taps + j) : 0;
  return __ldg(pos + x) - a0;
}

// The horizontal pass of the staged rows [i0, i1) of a step (src: the
// step's first staged row at this column, a row every stride bytes)
// into ring slots dst + i * dstride: this thread's rows are those whose
// index is roff modulo rstep (a power of two).
template <int KF>
__device__ __forceinline__ void hrows(const uint8_t* src, int stride,
                                      int32_t* dst, int dstride, int i0,
                                      int i1, int roff, int rstep,
                                      const int* cf, const int16_t* cs,
                                      int cstride, int taps) {
  const int i = i0 + ((roff - i0) & (rstep - 1));
  src += i * stride;
  dst += i * dstride;
  for (int k = i; k < i1; k += rstep) {
    *dst = hsample<KF>(src, cf, cs, cstride, taps);
    src += rstep * stride;
    dst += rstep * dstride;
  }
}

template <bool FULL, int KF>
__global__ void __launch_bounds__(kThreads)
sws_tiled(const uint8_t* __restrict__ y, const uint8_t* __restrict__ u,
          const uint8_t* __restrict__ v, int h, int w, int ch, int cw,
          int dst_h, int dst_w, int chr_dst_w, int tmpl, bool aligned_l,
          bool aligned_c, Tables t, Tile g, Consts c,
          int32_t* __restrict__ out) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int tid = threadIdx.x;
  const int strip = blockIdx.x, chunk = blockIdx.y, frame = blockIdx.z;
  const int sw = g.sw, swc = FULL ? sw : sw / 2, lanes = 2 * swc;
  const int x0 = strip * sw, xc0 = FULL ? x0 : x0 / 2;
  const int ncol = min(sw, dst_w - x0), ncol_c = min(swc, chr_dst_w - xc0);
  const int a0l = __ldg(g.strips + 4 * strip);
  const int n16l = __ldg(g.strips + 4 * strip + 1);
  const int a0c = __ldg(g.strips + 4 * strip + 2);
  const int n16c = __ldg(g.strips + 4 * strip + 3);
  const uint8_t* yf = y + (int64_t)frame * h * w;
  const uint8_t* uf = u + (int64_t)frame * ch * cw;
  const uint8_t* vf = v + (int64_t)frame * ch * cw;
  // two byte buffers (this step's and the next one's), then the step's
  // vertical coefficients, then the rings: ring_l (ring_c) slots of sw
  // (2 x swc) intermediates
  const int buf_bytes = g.g_l * g.stride_l + 2 * g.g_c * g.stride_c;
  const int vtaps = t.l + t.lc;
  int* vco = reinterpret_cast<int*>(smem + g.off_vcoef);
  int32_t* ring_l = reinterpret_cast<int32_t*>(smem + g.off_ring_l);
  int32_t* ring_c = reinterpret_cast<int32_t*>(smem + g.off_ring_c);
  const int16_t* cs_l = reinterpret_cast<const int16_t*>(smem + g.off_coef_l);
  const int16_t* cs_c = reinterpret_cast<const int16_t*>(smem + g.off_coef_c);

  // this thread's luma column and chroma lane (plane, column), fixed for
  // the block, with their positions and coefficients
  const int cl = tid & (sw - 1), roff_l = tid / sw, rstep_l = kThreads / sw;
  const int lane = tid % lanes, roff_c = tid / lanes;
  const int rstep_c = kThreads / lanes;
  const int plane = lane / swc, cc = lane - plane * swc;
  constexpr int R = KF > 0 ? KF : 1;
  int cf_l[R], cf_c[R];
  const int pos_l = cl < ncol ? load_column<KF>(t.h_pos, t.h_coef, t.fl,
                                                x0 + cl, a0l, cf_l)
                              : 0;
  const int pos_c = cc < ncol_c ? load_column<KF>(t.hc_pos, t.hc_coef, t.fc,
                                                  xc0 + cc, a0c, cf_c)
                                : 0;
  if (KF == 0) {   // the wide path: coefficients [tap][column], once
    int16_t* wl = reinterpret_cast<int16_t*>(smem + g.off_coef_l);
    int16_t* wc = reinterpret_cast<int16_t*>(smem + g.off_coef_c);
    for (int i = tid; i < t.fl * sw; i += kThreads) {
      const int j = i / sw, x = i - j * sw;
      wl[i] = x < ncol ? (int16_t)__ldg(t.h_coef + (int64_t)(x0 + x) * t.fl
                                        + j)
                       : 0;
    }
    for (int i = tid; i < t.fc * swc; i += kThreads) {
      const int j = i / swc, x = i - j * swc;
      wc[i] = x < ncol_c ? (int16_t)__ldg(t.hc_coef
                                          + (int64_t)(xc0 + x) * t.fc + j)
                         : 0;
    }
  }
  // the rings' ends and sizes in elements
  const int span_l = g.ring_l * sw, span_c = g.ring_c * lanes;
  const int32_t* end_l = ring_l + span_l;
  const int32_t* end_c = ring_c + span_c;
  // this thread's quad of output columns in the vertical pass: words x0
  // + 4q to x0 + 4q + n_q - 1 of rows roff_v, roff_v + rstep_v, ...
  const int qshift = __ffs(sw) - 3;   // sw / 4 quads a row
  const int q = tid & ((1 << qshift) - 1);
  const int roff_v = tid >> qshift, rstep_v = kThreads >> qshift;
  const bool q_in = x0 + 4 * q < dst_w;
  const int n_q = min(4, dst_w - x0 - 4 * q);
  int32_t* out_q = out + (int64_t)frame * dst_h * dst_w + x0 + 4 * q;

  const int first = __ldg(g.chunk_steps + chunk);
  const int last = __ldg(g.chunk_steps + chunk + 1);

  auto stage = [&](int st, uint8_t* buf) {
    const int* sp = g.steps + 8 * st;
    const int la = __ldg(sp), nl = __ldg(sp + 1) - la;
    const int ca = __ldg(sp + 2), nc = __ldg(sp + 3) - ca;
    uint8_t* cbuf = buf + g.g_l * g.stride_l;
    stage_rows(buf, g.stride_l, yf, w, la, nl, a0l, n16l, aligned_l, tid,
               nl * n16l);
    stage_rows(cbuf, g.stride_c, uf, cw, ca, nc, a0c, n16c, aligned_c, tid,
               nc * n16c);
    stage_rows(cbuf + g.g_c * g.stride_c, g.stride_c, vf, cw, ca, nc, a0c,
               n16c, aligned_c, tid, nc * n16c);
  };

  stage(first, smem);
  cp_async_commit();
  for (int st = first; st < last; ++st) {
    const int* sp = g.steps + 8 * st;
    const int la = __ldg(sp), lb = __ldg(sp + 1);
    const int ca = __ldg(sp + 2), cb = __ldg(sp + 3);
    const int oa = __ldg(sp + 4), ob = __ldg(sp + 5);
    const int sl0 = __ldg(sp + 6), sc0 = __ldg(sp + 7);
    const uint8_t* cur = smem + ((st - first) & 1) * buf_bytes;
    if (st + 1 < last)
      stage(st + 1, smem + ((st - first + 1) & 1) * buf_bytes);
    cp_async_commit();
    cp_async_wait_one();   // this step's bytes have landed
    __syncthreads();

    // the step's output rows' vertical coefficients, for the vertical
    // pass after the next barrier
    for (int i = tid; i < (ob - oa) * vtaps; i += kThreads) {
      const int r = i / vtaps, j = i - r * vtaps;
      vco[i] = j < t.l ? __ldg(t.v_coef + (int64_t)(oa + r) * t.l + j)
                       : __ldg(t.vc_coef + (int64_t)(oa + r) * t.lc + j
                               - t.l);
    }
    // horizontal pass of the step's new rows into the rings: the rows
    // before the ring's end, then those from its start (a thread every
    // rstep-th row of the step, no wrap inside either run)
    if (cl < ncol) {
      const int n1 = min(lb - la, g.ring_l - sl0);
      hrows<KF>(cur + pos_l, g.stride_l, ring_l + sl0 * sw + cl, sw, 0, n1,
                roff_l, rstep_l, cf_l, cs_l + cl, sw, t.fl);
      hrows<KF>(cur + pos_l, g.stride_l, ring_l + cl - n1 * sw, sw, n1,
                lb - la, roff_l, rstep_l, cf_l, cs_l + cl, sw, t.fl);
    }
    if (cc < ncol_c) {
      const uint8_t* cbuf = cur + g.g_l * g.stride_l
                            + plane * g.g_c * g.stride_c + pos_c;
      const int n1 = min(cb - ca, g.ring_c - sc0);
      hrows<KF>(cbuf, g.stride_c, ring_c + sc0 * lanes + lane, lanes, 0, n1,
                roff_c, rstep_c, cf_c, cs_c + cc, swc, t.fc);
      hrows<KF>(cbuf, g.stride_c, ring_c + lane - n1 * lanes, lanes, n1,
                cb - ca, roff_c, rstep_c, cf_c, cs_c + cc, swc, t.fc);
    }
    __syncthreads();

    // vertical pass and conversion of the step's output rows: a thread
    // the four words at x0 + 4q of every rstep_v-th row
    if (!q_in) continue;
    for (int oy = oa + roff_v; oy < ob; oy += rstep_v) {
      const int* vl = vco + (oy - oa) * vtaps;
      const int* vc = vl + t.l;
      const int32_t* rl = ring_l + __ldg(g.slots + 2 * oy) * sw + 4 * q;
      const int32_t* rc = ring_c + __ldg(g.slots + 2 * oy + 1) * lanes;
      int32_t y1[4], words[4];
      vertical<FULL, false, 4>(rl, sw, end_l, span_l, vl, t.l, tmpl, y1);
      if (FULL) {
        int32_t uu[4], vv[4];
        vertical<true, true, 4>(rc + 4 * q, lanes, end_c, span_c, vc, t.lc,
                                tmpl, uu);
        vertical<true, true, 4>(rc + swc + 4 * q, lanes, end_c, span_c, vc,
                                t.lc, tmpl, vv);
#pragma unroll
        for (int k = 0; k < 4; ++k) words[k] = write_full(c, y1[k], uu[k],
                                                          vv[k]);
      } else {   // one chroma column for each pixel pair
        int32_t uu[2], vv[2];
        vertical<false, true, 2>(rc + 2 * q, lanes, end_c, span_c, vc, t.lc,
                                 tmpl, uu);
        vertical<false, true, 2>(rc + swc + 2 * q, lanes, end_c, span_c, vc,
                                 t.lc, tmpl, vv);
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const u32 yy = (u32)y1[k];
          const int32_t cu = uu[k >> 1], cv = vv[k >> 1];
          words[k] = pack(tab(c, yy + off(cv, c.k[2])),
                          tab(c, yy + off(cu, c.k[4]) + off(cv, c.k[5])),
                          tab(c, yy + off(cu, c.k[3])));
        }
      }
      // 16 bytes where all four words lie in the row and the address is
      // aligned, else 8-byte stores of the aligned pairs and single words
      int32_t* dst = out_q + (int64_t)oy * dst_w;
      if (n_q == 4 && ((uintptr_t)dst & 15) == 0) {
        *reinterpret_cast<int4*>(dst) =
            make_int4(words[0], words[1], words[2], words[3]);
      } else if (((uintptr_t)dst & 7) == 0) {   // pairs (0, 1) and (2, 3)
        if (n_q >= 2) {
          *reinterpret_cast<int2*>(dst) = make_int2(words[0], words[1]);
        } else {
          dst[0] = words[0];
        }
        if (n_q == 4) {
          *reinterpret_cast<int2*>(dst + 2) = make_int2(words[2], words[3]);
        } else if (n_q == 3) {
          dst[2] = words[2];
        }
      } else {                                  // 0, the pair (1, 2), 3
        dst[0] = words[0];
        if (n_q >= 3) {
          *reinterpret_cast<int2*>(dst + 1) = make_int2(words[1], words[2]);
        } else if (n_q == 2) {
          dst[1] = words[1];
        }
        if (n_q == 4) dst[3] = words[3];
      }
    }
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


// A kernel's dynamic shared memory above the default 48 KB is an
// attribute of the device current at the call, so it is set on every
// launch that needs it (a process may launch on several cards).
template <bool FULL, int KF>
cudaError_t launch_tiled(dim3 grid, cudaStream_t s, const uint8_t* y,
                         const uint8_t* u, const uint8_t* v, int h, int w,
                         int ch, int cw, int dst_h, int dst_w, int chr_dst_w,
                         int tmpl, bool aligned_l, bool aligned_c,
                         const Tables& t, const Tile& g, const Consts& c,
                         int32_t* out) {
  if (g.smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        sws_tiled<FULL, KF>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        g.smem);
    if (e != cudaSuccess) return e;
  }
  sws_tiled<FULL, KF><<<grid, kThreads, g.smem, s>>>(
      y, u, v, h, w, ch, cw, dst_h, dst_w, chr_dst_w, tmpl, aligned_l,
      aligned_c, t, g, c, out);
  return cudaGetLastError();
}

template <bool FULL>
cudaError_t launch_kf(dim3 grid, cudaStream_t s, const uint8_t* y,
                      const uint8_t* u, const uint8_t* v, int h, int w,
                      int ch, int cw, int dst_h, int dst_w, int chr_dst_w,
                      int tmpl, bool aligned_l, bool aligned_c,
                      const Tables& t, const Tile& g, const Consts& c,
                      int32_t* out) {
#define SWS_KF(K)                                                          \
  case K:                                                                  \
    return launch_tiled<FULL, K>(grid, s, y, u, v, h, w, ch, cw, dst_h,    \
                                 dst_w, chr_dst_w, tmpl, aligned_l,        \
                                 aligned_c, t, g, c, out);
  switch (g.kf) {
    SWS_KF(0)
    SWS_KF(4)
    SWS_KF(8)
    SWS_KF(12)
    SWS_KF(16)
    SWS_KF(24)
    SWS_KF(32)
    default:
      return cudaErrorInvalidValue;
  }
#undef SWS_KF
}

}  // namespace

// y: [b, h, w], u and v: [b, ch, cw], uint8, contiguous; tables as in
// the notes above, on the device; consts: six host ints; tmpl 0, 1 or
// 2; full_chroma: odd dst_w; unscaled: the equal-size converter (the
// tables and the tiling are not read); tile: the sixteen ints of
// Tiling.params(), with its strips, steps, chunk_steps and slots on
// the device; out: [b, dst_h, dst_w] int32.
extern "C" int timg_sws_yuv420_to_rgba_words(
    const void* y, const void* u, const void* v, int b, int h, int w,
    int ch, int cw, int dst_h, int dst_w, int chr_dst_w, const void* h_pos,
    const void* h_coef, int fl, const void* hc_pos, const void* hc_coef,
    int fc, const void* v_pos, const void* v_coef, int l,
    const void* vc_pos, const void* vc_coef, int lc, int tmpl,
    int full_chroma, int unscaled, const int* consts, const int* tile,
    const void* strips, const void* steps, const void* chunk_steps,
    const void* slots, void* out, void* stream) {
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
  if (unscaled) {
    if (dst_h != h || dst_w != w) return (int)cudaErrorInvalidValue;
    const int pairs = (dst_w + 1) / 2;
    const dim3 grid(
        (int)(((int64_t)dst_h * pairs + kThreads - 1) / kThreads), b);
    sws_unscaled<<<grid, kThreads, 0, s>>>(yp, up, vp, h, w, ch, cw, pairs,
                                           c, o);
    return (int)cudaGetLastError();
  }
  Tables t{(const int*)h_pos,  (const int*)h_coef,  (const int*)hc_pos,
           (const int*)hc_coef, (const int*)v_pos,  (const int*)v_coef,
           (const int*)vc_pos, (const int*)vc_coef, fl, fc, l, lc};
  Tile g{tile[0],  tile[1],  tile[2],  tile[3],  tile[4],  tile[5],
         tile[6],  tile[7],  tile[8],  tile[9],  tile[10], tile[11],
         tile[12], tile[13], tile[14], tile[15],
         (const int*)strips, (const int*)steps, (const int*)chunk_steps,
         (const int*)slots};
  if (g.sw < 4 || g.sw > 128 || (g.sw & (g.sw - 1)) || g.n_chunks > 65535
      || g.n_strips != (dst_w + g.sw - 1) / g.sw)
    return (int)cudaErrorInvalidValue;
  const bool aligned_l = ((uintptr_t)yp & 15) == 0 && w % 16 == 0;
  const bool aligned_c = ((uintptr_t)up & 15) == 0
                         && ((uintptr_t)vp & 15) == 0 && cw % 16 == 0;
  const dim3 grid(g.n_strips, g.n_chunks, b);
  return (int)(full_chroma
      ? launch_kf<true>(grid, s, yp, up, vp, h, w, ch, cw, dst_h, dst_w,
                        chr_dst_w, tmpl, aligned_l, aligned_c, t, g, c, o)
      : launch_kf<false>(grid, s, yp, up, vp, h, w, ch, cw, dst_h, dst_w,
                         chr_dst_w, tmpl, aligned_l, aligned_c, t, g, c,
                         o));
}

// YUV 4:2:0 planes -> RGBA words (BT.601, 16-bit fixed point).
//
// Replaces timg_tpu/ops/yuv.py yuv420_to_rgba_words (XLA in the
// reference, fused in one jit with the resize; no Pallas kernel).
// Input: [B, H, W] Y and two [B, CH, CW] chroma planes, uint8,
// contiguous, with 2 CH >= H and 2 CW >= W.  Output: [B, H, W] int32
// words R | G << 8 | B << 16 | 0xFF000000.
//
// The reference's arithmetic, per output pixel (x, y), all int32:
// chroma row r = y >> 1 and its neighbour r - 1 (even y) or r + 1 (odd
// y), clamped to the plane's own rows; per chroma column j, the vertical
// stage cv[j] = (3 c[r][j] + c[rn][j] + 2) >> 2; then column j = x >> 1
// and its neighbour j - 1 (even x) or j + 1 (odd x), clamped to the
// plane's own columns, (3 cv[j] + cv[jn] + 2) >> 2 -- vertical first,
// then horizontal, each rounded, as the reference's separable 2x
// upsample.  Then BT.601: (x + 32768) >> 16 (arithmetic shift), clamped
// to [0, 255].
//
// Layout: a thread makes PX = 8 consecutive words of one output row.  Its
// pixels need chroma columns j0 - 1 .. j0 + PX / 2 (j0 = x0 / 2) of two
// chroma rows a plane, which it reads as bytes (neighbouring threads
// share them through L1) and runs through the vertical stage once.  Y
// is read as one 8-byte load and the output written as 16-byte
// stores where the frame offset allows; a row's ragged tail takes bytes
// and scalar stores.  Bound on the H100: device-memory bytes, 1.5 B in
// and 4 B out a pixel; the arithmetic (about 50 integer operations a
// pixel) keeps the issue rate near that bound too.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int PX = 8;   // words a thread

struct Lim {
  static constexpr int cy = 76309, crv = 104597, cgu = 25675, cgv = 53279,
                       cbu = 132201, y0 = 16;
};
struct Full {
  static constexpr int cy = 65536, crv = 91881, cgu = 22554, cgv = 46802,
                       cbu = 116130, y0 = 0;
};

__device__ __forceinline__ int fin(int x) {
  return min(max((x + 32768) >> 16, 0), 255);
}

template <class K>
__device__ __forceinline__ int32_t word(int yb, int u, int v) {
  const int yc = K::cy * (yb - K::y0);
  const int d = u - 128, e = v - 128;
  const int r = fin(yc + K::crv * e);
  const int g = fin(yc - K::cgu * d - K::cgv * e);
  const int b = fin(yc + K::cbu * d);
  return (int32_t)((uint32_t)r | ((uint32_t)g << 8) | ((uint32_t)b << 16)
                   | 0xFF000000u);
}

// The pixel's chroma: the vertical stage's columns cv[0 .. PX/2 + 1]
// hold chroma columns j0 - 1 .. j0 + PX / 2 (clamped); pixel k is column
// k / 2 + 1, its neighbour one to the left (even k) or right (odd k).
__device__ __forceinline__ int horizontal(const int (&cv)[PX / 2 + 2],
                                          int k) {
  const int c = k / 2 + 1;
  return (3 * cv[c] + cv[(k & 1) ? c + 1 : c - 1] + 2) >> 2;
}

template <class K>
__global__ void __launch_bounds__(kThreads)
yuv420_words(const uint8_t* __restrict__ y, const uint8_t* __restrict__ u,
             const uint8_t* __restrict__ v, int h, int w, int ch, int cw,
             int groups, int32_t* __restrict__ out) {
  const int g = blockIdx.x * kThreads + threadIdx.x;
  if (g >= h * groups) return;
  const int frame = blockIdx.y;
  const int row = g / groups;
  const int x0 = (g - row * groups) * PX;
  const int n = min(PX, w - x0);
  const int64_t p0 = ((int64_t)frame * h + row) * w + x0;

  const int r = row >> 1;
  const int rn = (row & 1) ? min(r + 1, ch - 1) : max(r - 1, 0);
  const int64_t c0 = ((int64_t)frame * ch + r) * cw;
  const int64_t c1 = ((int64_t)frame * ch + rn) * cw;
  const int j0 = x0 >> 1;
  int cu[PX / 2 + 2], cv[PX / 2 + 2];
#pragma unroll
  for (int c = 0; c < PX / 2 + 2; ++c) {
    const int j = min(max(j0 - 1 + c, 0), cw - 1);
    cu[c] = (3 * u[c0 + j] + u[c1 + j] + 2) >> 2;
    cv[c] = (3 * v[c0 + j] + v[c1 + j] + 2) >> 2;
  }

  uint8_t yb[PX];
  const uint8_t* ys = y + p0;
  if (n == PX && ((uintptr_t)ys & 7) == 0) {
    const uint2 q = *reinterpret_cast<const uint2*>(ys);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      yb[k] = (uint8_t)(q.x >> (8 * k));
      yb[k + 4] = (uint8_t)(q.y >> (8 * k));
    }
  } else {
#pragma unroll
    for (int k = 0; k < PX; ++k) yb[k] = k < n ? ys[k] : 0;
  }

  int32_t px[PX];
#pragma unroll
  for (int k = 0; k < PX; ++k)
    px[k] = word<K>(yb[k], horizontal(cu, k), horizontal(cv, k));

  int32_t* dst = out + p0;
  if (n == PX && ((uintptr_t)dst & 15) == 0) {
#pragma unroll
    for (int q = 0; q < PX / 4; ++q)
      reinterpret_cast<int4*>(dst)[q] =
          make_int4(px[4 * q], px[4 * q + 1], px[4 * q + 2], px[4 * q + 3]);
  } else {
#pragma unroll
    for (int k = 0; k < PX; ++k)
      if (k < n) dst[k] = px[k];
  }
}

template <class K>
int launch(const uint8_t* y, const uint8_t* u, const uint8_t* v, int b,
           int h, int w, int ch, int cw, int32_t* out, cudaStream_t s) {
  const int groups = (w + PX - 1) / PX;
  const dim3 grid((int)(((int64_t)h * groups + kThreads - 1) / kThreads), b);
  yuv420_words<K><<<grid, kThreads, 0, s>>>(y, u, v, h, w, ch, cw, groups,
                                            out);
  return (int)cudaGetLastError();
}

}  // namespace

// y: [b, h, w], u and v: [b, ch, cw], uint8, contiguous, 2 ch >= h and
// 2 cw >= w; out: [b, h, w] int32.
extern "C" int timg_yuv420_to_rgba_words(const void* y, const void* u,
                                         const void* v, int b, int h, int w,
                                         int ch, int cw, int full_range,
                                         void* out, void* stream) {
  if (b <= 0 || h <= 0 || w <= 0) return 0;
  if (2 * ch < h || 2 * cw < w || b > 65535)
    return (int)cudaErrorInvalidValue;
  const auto* yp = (const uint8_t*)y;
  const auto* up = (const uint8_t*)u;
  const auto* vp = (const uint8_t*)v;
  auto* o = (int32_t*)out;
  cudaStream_t s = (cudaStream_t)stream;
  return full_range ? launch<Full>(yp, up, vp, b, h, w, ch, cw, o, s)
                    : launch<Lim>(yp, up, vp, b, h, w, ch, cw, o, s);
}

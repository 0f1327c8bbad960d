// libsixel-mode Floyd-Steinberg dither: integer error diffusion, the
// palette index looked up in the frame's 15-bit bucket table.
//
// Replaces the TPU kernel timg_tpu/ops/sixel_pallas3.py
// fs_dither_table_fused (K8: _make_wavefront_kernel_int +
// _make_fs_table_kernel) with its layout kernels K3-K5; the numpy
// specification is timg_tpu/ops/libsixel_quant.py
// apply_palette_bucket_table.  As in csrc/fs_dither_cube.cu, the skew is
// indexing: at step t, row y handles x = t - 2y.
//
// The table (32 KB) sits in shared memory, so the lookup is one byte
// load; the TPU needed a lane gather over [64, B, 128] packed words and
// a 6-level select for it.
//
// Layout: one block per frame, one thread per row (R = 2 or 4 rows a
// thread above 1024 rows).  Unlike the f32 cube path, whose row below
// takes one premixed error, libsixel truncates each neighbour's share
// separately, so the row below needs the row above's last three raw
// offsets.  Each row publishes its newest 3-channel offset at the end of
// a step through a double-buffered shared array (one __syncthreads() a
// step) and keeps the three it received last in registers: at step t,
// row y holds row y-1's offsets of steps t-1, t-2, t-3 (its pixels x+1,
// x, x-1) and its own of step t-1 (x-1).
// Shared memory: 32,768 B table + 1,024 B palette + 24 h B of carries
// (51,216 B at 726 rows, 132,096 B at the 4,096-row limit), above the
// 48 KB default, so the launcher raises the dynamic limit.
//
// Arithmetic (sixel_pallas3.py:440-443, 511-519, 561-592), all int32:
//   v = col; then in source-raster order, each add followed by a clamp
//   to [0, 255]: + up_left*1/16, + up*5/16, + up_right*3/16, + left*7/16,
//   where a*n/16 is C division (truncation toward zero);
//   key = (v0 >> 3) << 10 | (v1 >> 3) << 5 | (v2 >> 3);  idx = table[key]
//   offset = v - palette[idx] per channel (0 off the image, and 0 in a
//   frame whose diffuse flag is 0: it still writes indices).
//
// Bound on the H100: latency of the w + 2(h-1) serial steps, as the cube
// kernel; the work a step is a few dozen integer ops and two shared loads.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxThreads = 1024;
constexpr int kMaxRowsPerThread = 4;
constexpr int kBuckets = 1 << 15;
constexpr int kPalette = 256;

__device__ __forceinline__ int chan(int32_t word, int c) {
  return (word >> (8 * c)) & 0xFF;
}

__device__ __forceinline__ int clamp255(int v) {
  return min(max(v, 0), 255);
}

template <typename OutT, int R>
__global__ void __launch_bounds__(kMaxThreads)
fs_dither_table(const int32_t* __restrict__ words, int h, int w, int pitch_h,
                int pitch_w, const uint8_t* __restrict__ tables,
                const int32_t* __restrict__ pal_words,
                const int32_t* __restrict__ diffuse, OutT* __restrict__ out) {
  // [32768] u8 table, [256] palette words, [2][3][h] published offsets
  extern __shared__ __align__(16) unsigned char smem[];
  uint8_t* table = smem;
  int* pal = reinterpret_cast<int*>(smem + kBuckets);
  int* carry = pal + kPalette;
  const int b = blockIdx.x;
  const int nth = blockDim.x;
  const int32_t* src = words + (int64_t)b * pitch_h * pitch_w;
  OutT* dst = out + (int64_t)b * h * w;

  const uint8_t* tsrc = tables + (int64_t)b * kBuckets;
  if (((uintptr_t)tsrc & 15) == 0) {
    const int4* t4 = reinterpret_cast<const int4*>(tsrc);
    int4* s4 = reinterpret_cast<int4*>(table);
    for (int i = threadIdx.x; i < kBuckets / 16; i += nth) s4[i] = t4[i];
  } else {
    for (int i = threadIdx.x; i < kBuckets; i += nth) table[i] = tsrc[i];
  }
  for (int i = threadIdx.x; i < kPalette; i += nth)
    pal[i] = pal_words[(int64_t)b * kPalette + i];
  for (int i = threadIdx.x; i < 2 * 3 * h; i += nth) carry[i] = 0;
  const bool diffuses = diffuse[b] != 0;

  int left[R][3], u1[R][3], u2[R][3], u3[R][3];
#pragma unroll
  for (int k = 0; k < R; ++k)
#pragma unroll
    for (int c = 0; c < 3; ++c) left[k][c] = u1[k][c] = u2[k][c] = u3[k][c] = 0;
  __syncthreads();

  const int n_steps = w + 2 * (h - 1);
  for (int t = 0; t < n_steps; ++t) {
    const int* up_in = carry + (t & 1) * 3 * h;
    int* off_out = carry + ((t + 1) & 1) * 3 * h;
#pragma unroll
    for (int k = 0; k < R; ++k) {
      const int y = threadIdx.x + k * nth;
      if (y >= h) break;
      const int x = t - 2 * y;
      const bool valid = x >= 0 && x < w;
      const int32_t word = valid ? src[(int64_t)y * pitch_w + x] : 0;
      int v[3];
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        u3[k][c] = u2[k][c];
        u2[k][c] = u1[k][c];
        u1[k][c] = y == 0 ? 0 : up_in[c * h + y - 1];
        int a = chan(word, c);
        a = clamp255(a + u3[k][c] * 1 / 16);
        a = clamp255(a + u2[k][c] * 5 / 16);
        a = clamp255(a + u1[k][c] * 3 / 16);
        v[c] = clamp255(a + left[k][c] * 7 / 16);
      }
      const int key = (v[0] >> 3) << 10 | (v[1] >> 3) << 5 | (v[2] >> 3);
      const int idx = table[key];
      const int pw = pal[idx];
      const int color[3] = {(pw >> 16) & 0xFF, (pw >> 8) & 0xFF, pw & 0xFF};
      if (valid) dst[(int64_t)y * w + x] = (OutT)idx;
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        left[k][c] = valid && diffuses ? v[c] - color[c] : 0;
        off_out[c * h + y] = left[k][c];
      }
    }
    __syncthreads();
  }
}

template <typename OutT, int R>
int launch_rows(const int32_t* words, int b, int h, int w, int pitch_h,
                int pitch_w, const uint8_t* tables, const int32_t* pal_words,
                const int32_t* diffuse, OutT* out, cudaStream_t stream) {
  const int rows = (h + R - 1) / R;
  const int threads = (rows + 31) / 32 * 32;
  const size_t smem = (size_t)kBuckets + kPalette * sizeof(int)
                      + (size_t)2 * 3 * h * sizeof(int);
  cudaError_t err = cudaFuncSetAttribute(
      fs_dither_table<OutT, R>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  fs_dither_table<OutT, R><<<b, threads, smem, stream>>>(
      words, h, w, pitch_h, pitch_w, tables, pal_words, diffuse, out);
  return (int)cudaGetLastError();
}

template <typename OutT>
int launch(const int32_t* words, int b, int h, int w, int pitch_h,
           int pitch_w, const uint8_t* tables, const int32_t* pal_words,
           const int32_t* diffuse, OutT* out, cudaStream_t stream) {
  if (b <= 0 || h <= 0 || w <= 0) return 0;
  if (h <= kMaxThreads)
    return launch_rows<OutT, 1>(words, b, h, w, pitch_h, pitch_w, tables,
                                pal_words, diffuse, out, stream);
  if (h <= 2 * kMaxThreads)
    return launch_rows<OutT, 2>(words, b, h, w, pitch_h, pitch_w, tables,
                                pal_words, diffuse, out, stream);
  if (h <= kMaxRowsPerThread * kMaxThreads)
    return launch_rows<OutT, kMaxRowsPerThread>(
        words, b, h, w, pitch_h, pitch_w, tables, pal_words, diffuse, out,
        stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// words: [b, pitch_h, pitch_w] int32 RGBA words, valid extent h x w;
// tables: [b, 32768] uint8; pal_words: [b, 256] int32 0xRRGGBB;
// diffuse: [b] int32 (0 = palette only); out: [b, h, w] uint8 or int32.
extern "C" int timg_fs_dither_table(const void* words, int b, int h, int w,
                                    int pitch_h, int pitch_w,
                                    const void* tables, const void* pal_words,
                                    const void* diffuse, void* out,
                                    int out_u8, void* stream) {
  const int32_t* wd = (const int32_t*)words;
  const uint8_t* tb = (const uint8_t*)tables;
  const int32_t* pw = (const int32_t*)pal_words;
  const int32_t* df = (const int32_t*)diffuse;
  if (out_u8)
    return launch(wd, b, h, w, pitch_h, pitch_w, tb, pw, df, (uint8_t*)out,
                  (cudaStream_t)stream);
  return launch(wd, b, h, w, pitch_h, pitch_w, tb, pw, df, (int32_t*)out,
                (cudaStream_t)stream);
}

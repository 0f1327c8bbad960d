// libsixel bucket tables: per frame, the nearest palette index of every
// 15-bit bucket's base color.
//
// Replaces timg_tpu/ops/sixel_pallas3.py build_bucket_tables_device (an
// XLA argmin in the reference; no Pallas kernel).  Input: [B, 256, 3]
// int32 palettes (a short palette's tail repeats its first color).
// Output: [B, 32768] uint8 tables, where bucket k = r5 << 10 | g5 << 5 | b5
// has the base color (r5 << 3, g5 << 3, b5 << 3) and takes the index of
// the smallest integer squared distance, the FIRST minimum winning
// (strict <, libsixel's lookup rule; timg_tpu/ops/libsixel_quant.py
// build_bucket_table is the numpy specification).
//
// Layout: one block per (frame, range of 256 keys), one thread per key;
// the frame's palette sits in shared memory (3 KB) and every thread
// walks all 256 entries in order.  Bound on the H100: integer ALU work,
// B x 32768 x 256 distances (268 M at B = 32), about 4 ops each; no
// device-memory pressure (3 KB in, 32 KB out a frame).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBuckets = 1 << 15;
constexpr int kPalette = 256;
constexpr int kKeysPerBlock = 256;

__global__ void __launch_bounds__(kKeysPerBlock)
bucket_tables(const int32_t* __restrict__ pals, uint8_t* __restrict__ out) {
  __shared__ int pal[kPalette * 3];
  const int b = blockIdx.y;
  const int32_t* src = pals + (int64_t)b * kPalette * 3;
  for (int i = threadIdx.x; i < kPalette * 3; i += blockDim.x)
    pal[i] = src[i];
  __syncthreads();

  const int key = blockIdx.x * kKeysPerBlock + threadIdx.x;
  const int r = ((key >> 10) & 0x1F) << 3;
  const int g = ((key >> 5) & 0x1F) << 3;
  const int bl = (key & 0x1F) << 3;
  int best = 0;
  int best_d = 0x7FFFFFFF;
  for (int i = 0; i < kPalette; ++i) {
    const int dr = r - pal[3 * i], dg = g - pal[3 * i + 1],
              db = bl - pal[3 * i + 2];
    const int d = dr * dr + dg * dg + db * db;
    if (d < best_d) {
      best_d = d;
      best = i;
    }
  }
  out[(int64_t)b * kBuckets + key] = (uint8_t)best;
}

}  // namespace

// pals: [b, 256, 3] int32; out: [b, 32768] uint8.
extern "C" int timg_bucket_tables(const void* pals, int b, void* out,
                                  void* stream) {
  if (b <= 0) return 0;
  const dim3 grid(kBuckets / kKeysPerBlock, b);
  bucket_tables<<<grid, kKeysPerBlock, 0, (cudaStream_t)stream>>>(
      (const int32_t*)pals, (uint8_t*)out);
  return (int)cudaGetLastError();
}

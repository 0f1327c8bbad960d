// libsixel bucket tables: per frame, the nearest palette index of every
// 15-bit bucket's base color.
//
// Replaces timg_tpu/ops/sixel_pallas3.py build_bucket_tables_device (an
// XLA argmin in the reference; no Pallas kernel).  Input: [B, 256, 3]
// int32 palettes, channels in [0, 255] (a short palette's tail repeats
// its first color).  Output: [B, 32768] uint8 tables, where bucket
// k = r5 << 10 | g5 << 5 | b5 has the base color c = 8 (r5, g5, b5) and
// takes the index of the smallest integer squared distance, the FIRST
// minimum winning (strict <, libsixel's lookup rule;
// timg_tpu/ops/libsixel_quant.py build_bucket_table is the numpy
// specification).
//
// Exact separable form.  |c - p_i|^2 = |c|^2 - 16 (r5 pr_i + g5 pg_i +
// b5 pb_i) + |p_i|^2, and |c|^2 is the same for every i, so the argmin is
// that of e_i = |p_i|^2 - 16 (r5 pr_i + g5 pg_i) - 16 b5 pb_i.  Packing
// the index below it, v_i = 256 e_i + i, makes one signed min yield the
// smallest e and, among equal e, the smallest i: libsixel's rule.  With
// channels in [0, 255], e lies in [-379440, 195075], so v fits in int32.
//
// Layout: a thread owns one (frame, r5, g5) row of 32 keys (b5 = 0..31)
// and a kSplit-th of the palette (entries part, part + kSplit, ...).
// The block stages its frame's palette in shared memory as pre-scaled
// entries {256 |p|^2 + i, -4096 pr, -4096 pg, -4096 pb}; a thread forms
// each entry's row base with two multiply-adds and then, for each b5,
// one add (ptxas steps base + b5 (-4096 pb) across b5) and one min. The
// kSplit lanes of a row combine their packed minima by shuffles (min is
// associative and the packing keeps the first minimum, so the split
// changes no byte), each keeping 32 / kSplit keys, which it writes as
// one store of consecutive bytes.  Four lanes a row fill the card at
// the CLI's 8-frame window (1,024 warps, where one lane a row gives
// 256) for two shuffle stages (16 and 8 keys).
// Bound on the H100: the integer pipe, one min per (key, entry), B x
// 32768 x 256 (268 M at B = 32; the adds issue as IMAD.IADD on the FMA
// pipe), with no device-memory pressure (3 KB in, 32 KB out a frame).
// The inner dimension is 3, so tensor cores would compute mostly
// padding and leave the argmin to these same lanes.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int kBuckets = 1 << 15;
constexpr int kPalette = 256;
constexpr int kRowKeys = 32;               // b5 = 0..31 of one (r5, g5)
constexpr int kRows = kBuckets / kRowKeys;
constexpr int kThreads = 256;
constexpr int kSplit = 4;                  // lanes a row

// Four key bytes (the packed minima's low bytes: their indices) -> one
// little-endian word.
__device__ __forceinline__ uint32_t pack4(int a, int b, int c, int d) {
  return __byte_perm(__byte_perm(a, b, 0x0040), __byte_perm(c, d, 0x0040),
                     0x5410);
}

// One stage of the reduce-scatter: this lane and the lane `bit` away hold
// 2 HALF keys each; the lane with the bit set keeps the upper HALF, its
// partner the lower, each the min of both lanes' values, in m[0 .. HALF).
template <int HALF>
__device__ __forceinline__ void halve(int (&m)[kRowKeys], int hi, int bit) {
#pragma unroll
  for (int k = 0; k < HALF; ++k) {
    const int send = hi ? m[k] : m[k + HALF];
    const int keep = hi ? m[k + HALF] : m[k];
    m[k] = min(keep, __shfl_xor_sync(0xFFFFFFFFu, send, bit));
  }
}

__global__ void __launch_bounds__(kThreads)
bucket_tables(const int32_t* __restrict__ pals, uint8_t* __restrict__ out) {
  static_assert(kThreads == kPalette, "one thread stages one entry");
  __shared__ int4 ent[kPalette];
  const int frame = blockIdx.y;
  {
    const int i = threadIdx.x;
    const int32_t* p = pals + ((int64_t)frame * kPalette + i) * 3;
    const int r = p[0], g = p[1], bl = p[2];
    ent[i] = make_int4((r * r + g * g + bl * bl) * 256 + i, -4096 * r,
                       -4096 * g, -4096 * bl);
  }
  __syncthreads();

  const int part = threadIdx.x % kSplit;
  const int row = blockIdx.x * (kThreads / kSplit) + threadIdx.x / kSplit;
  const int r5 = row >> 5, g5 = row & 31;
  int m[kRowKeys];
#pragma unroll
  for (int k = 0; k < kRowKeys; ++k) m[k] = INT_MAX;
#pragma unroll 2
  for (int i = part; i < kPalette; i += kSplit) {
    const int4 e = ent[i];
    const int base = e.x + r5 * e.y + g5 * e.z;
#pragma unroll
    for (int k = 0; k < kRowKeys; ++k) m[k] = min(m[k], base + k * e.w);
  }

  // Reduce-scatter over the row's four lanes: at each stage the lane
  // with the stage's bit set keeps the upper half of its keys, so lane
  // part ends with the 8 keys from first on.
  halve<16>(m, part & 1, 1);
  halve<8>(m, part & 2, 2);
  const int first = (part & 1) << 4 | (part & 2) << 2;
  uint8_t* dst = out + (int64_t)frame * kBuckets + row * kRowKeys + first;
  *reinterpret_cast<uint2*>(dst) =
      make_uint2(pack4(m[0], m[1], m[2], m[3]), pack4(m[4], m[5], m[6], m[7]));
}

}  // namespace

// pals: [b, 256, 3] int32 in [0, 255]; out: [b, 32768] uint8, 8-byte
// aligned.
extern "C" int timg_bucket_tables(const void* pals, int b, void* out,
                                  void* stream) {
  if (b <= 0) return 0;
  const dim3 grid(kRows / (kThreads / kSplit), b);
  bucket_tables<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const int32_t*)pals, (uint8_t*)out);
  return (int)cudaGetLastError();
}

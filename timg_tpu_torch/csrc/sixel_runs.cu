// Sixel column runs of uint8 index planes: run counts a band and the
// compacted run records (the run-record device->host transport).
//
// Replaces timg_tpu/ops/sixel_runs.py run_counts and compact_runs (XLA
// device ops in the reference; no Pallas kernel).  Input: [B, >=h, >=w]
// uint8 planes, rows contiguous, given with their frame and row strides.
// A band is 6 rows; rows past h (the last band's pad) read as 0.  A
// column's words are w0 = c0 | c1 << 8 | c2 << 16 | c3 << 24 and w1 =
// c4 | c5 << 8 (uint32, so c3 << 24 does not overflow); a run starts at
// x = 0 and wherever (w0, w1) differs from column x - 1.
//
// band_run_counts: one block a (band, frame); each thread takes columns
// x = t, t + 256, ...; the start flags are counted with a ballot and
// popc a warp, then summed over the block.  Output [B, nb] int32.
//
// compact_runs: one block a (band, frame).  The band's first record is
// the sum of the counts of the frame's earlier bands (read from the
// counts the first kernel wrote); the block walks its columns in tiles
// of 256, ranks each tile's starts by a block scan of the flags (ballot
// and popc in a warp, warp totals in shared memory) and writes record
// (w0, w1 | x << 16) at first + running + rank, so the records come out
// band-major then by x, the order of the reference's sort keyed on the
// flat position, without a sort.  Records at or past ``cap`` are not
// written (the reference truncates the same way; the caller checks the
// counts first); the wrapper zeroes the output, so records past a
// frame's count are 0.
//
// Bound on the H100: device-memory bytes (each plane byte read once,
// 8 bytes a record written); the work a column is a few dozen integer
// operations.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

struct Planes {
  const uint8_t* p;
  long long frame_stride, row_stride;
  int h, w, nb;
};

// (w0, w1) of column x of the band whose first row is y0.
__device__ __forceinline__ void column_words(const Planes& P,
                                             const uint8_t* band, int nrows,
                                             int x, uint32_t& w0,
                                             uint32_t& w1) {
  uint32_t c[6] = {0, 0, 0, 0, 0, 0};
#pragma unroll
  for (int r = 0; r < 6; ++r)
    if (r < nrows) c[r] = band[(long long)r * P.row_stride + x];
  w0 = c[0] | (c[1] << 8) | (c[2] << 16) | (c[3] << 24);
  w1 = c[4] | (c[5] << 8);
}

__device__ __forceinline__ bool is_start(const Planes& P,
                                         const uint8_t* band, int nrows,
                                         int x, uint32_t& w0, uint32_t& w1) {
  column_words(P, band, nrows, x, w0, w1);
  if (x == 0) return true;
  uint32_t p0, p1;
  column_words(P, band, nrows, x - 1, p0, p1);
  return w0 != p0 || w1 != p1;
}

// Exclusive block scan of one 0/1 flag a thread (all threads call it);
// *total gets the block's sum.
__device__ __forceinline__ int flag_scan(bool flag, int* warp_sums,
                                         int* total) {
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  const unsigned ballot = __ballot_sync(0xffffffffu, flag);
  const int rank = __popc(ballot & ((1u << lane) - 1u));
  if (lane == 0) warp_sums[wid] = __popc(ballot);
  __syncthreads();
  int base = 0, tot = 0;
#pragma unroll
  for (int k = 0; k < kWarps; ++k) {
    const int s = warp_sums[k];
    base += k < wid ? s : 0;
    tot += s;
  }
  __syncthreads();
  *total = tot;
  return base + rank;
}

__global__ void __launch_bounds__(kThreads)
band_run_counts(Planes P, int32_t* __restrict__ counts) {
  __shared__ int warp_sums[kWarps];
  const int band = blockIdx.x, f = blockIdx.y;
  const int nrows = min(6, P.h - band * 6);
  const uint8_t* src = P.p + f * P.frame_stride
                       + (long long)band * 6 * P.row_stride;
  int n = 0;
  for (int x = threadIdx.x; x < P.w; x += kThreads) {
    uint32_t w0, w1;
    n += is_start(P, src, nrows, x, w0, w1);
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) n += __shfl_xor_sync(0xffffffffu, n, o);
  if ((threadIdx.x & 31) == 0) warp_sums[threadIdx.x >> 5] = n;
  __syncthreads();
  if (threadIdx.x == 0) {
    int tot = 0;
    for (int k = 0; k < kWarps; ++k) tot += warp_sums[k];
    counts[f * P.nb + band] = tot;
  }
}

__global__ void __launch_bounds__(kThreads)
compact_runs(Planes P, const int32_t* __restrict__ counts, int cap,
             int32_t* __restrict__ records) {
  __shared__ int warp_sums[kWarps];
  __shared__ int s_first;
  const int band = blockIdx.x, f = blockIdx.y;
  const int nrows = min(6, P.h - band * 6);
  const uint8_t* src = P.p + f * P.frame_stride
                       + (long long)band * 6 * P.row_stride;
  // first record of the band: the frame's earlier bands' counts
  int part = 0;
  for (int i = threadIdx.x; i < band; i += kThreads)
    part += counts[f * P.nb + i];
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    part += __shfl_xor_sync(0xffffffffu, part, o);
  if ((threadIdx.x & 31) == 0) warp_sums[threadIdx.x >> 5] = part;
  __syncthreads();
  if (threadIdx.x == 0) {
    int tot = 0;
    for (int k = 0; k < kWarps; ++k) tot += warp_sums[k];
    s_first = tot;
  }
  __syncthreads();
  const int first = s_first;
  int32_t* out = records + (long long)f * cap * 2;
  int running = 0;
  for (int x0 = 0; x0 < P.w; x0 += kThreads) {   // uniform trip count
    const int x = x0 + threadIdx.x;
    uint32_t w0 = 0, w1 = 0;
    const bool s = x < P.w && is_start(P, src, nrows, x, w0, w1);
    int tot;
    const int rank = flag_scan(s, warp_sums, &tot);
    const int pos = first + running + rank;
    if (s && pos < cap) {
      out[2 * pos] = (int32_t)w0;
      out[2 * pos + 1] = (int32_t)(w1 | ((uint32_t)x << 16));
    }
    running += tot;
  }
}

}  // namespace

// planes: [B, >=h, >=w] uint8 with the given strides (elements);
// counts: [B, nb] int32 out.  Returns cudaGetLastError() after the
// launch.
extern "C" int timg_band_run_counts(const void* planes, int b, int h, int w,
                                    long long frame_stride,
                                    long long row_stride, void* counts,
                                    void* stream) {
  const Planes P{(const uint8_t*)planes, frame_stride, row_stride, h, w,
                 (h + 5) / 6};
  band_run_counts<<<dim3(P.nb, b), kThreads, 0, (cudaStream_t)stream>>>(
      P, (int32_t*)counts);
  return (int)cudaGetLastError();
}

// counts: the [B, nb] int32 of timg_band_run_counts on these planes;
// records: [B, cap, 2] int32, zeroed by the caller.
extern "C" int timg_compact_runs(const void* planes, int b, int h, int w,
                                 long long frame_stride,
                                 long long row_stride, const void* counts,
                                 int cap, void* records, void* stream) {
  const Planes P{(const uint8_t*)planes, frame_stride, row_stride, h, w,
                 (h + 5) / 6};
  compact_runs<<<dim3(P.nb, b), kThreads, 0, (cudaStream_t)stream>>>(
      P, (const int32_t*)counts, cap, (int32_t*)records);
  return (int)cudaGetLastError();
}

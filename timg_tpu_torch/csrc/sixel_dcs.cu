// Sixel DCS body bytes of uint8 index planes, a band at a time (the
// device-emitted DCS device->host transport).
//
// Replaces timg_tpu/ops/sixel_dcs.py plan_device, layout_device and
// emit_device (XLA device ops in the reference, under batch_band_lens and
// batch_encode; no Pallas kernel).  Input: [B, >=h, >=w] uint8 planes,
// rows contiguous, given with their frame and row strides; w < 32768.
//
// One block of 256 threads a (band, frame).  The band's rows (at most 6;
// the last band's pad rows are left out, as the reference's sentinel 256
// matches no colour) are staged in shared memory.  Colour presence is a
// 256-byte set that every pixel stores 1 into; thread t owns colour t, and
// a block scan of the set lists the present colours in ascending order.
// The first 64 (COLOR_CAP) are laid out; the count goes out as it is, so
// the caller falls back to the plane when it exceeds 64.  For each listed
// colour in turn: its mask row (bit r where row r holds the colour) into
// shared memory; the run starts (x = 0 or a change), ranked by a block
// scan into a list of start columns; per run its length (next start or
// w), its value, and its bytes: none for the row's last run when it is 0
// (the trailing zero run is dropped), 2 + digits(len) for a run longer
// than 3 ('!', the length, the char), else len (the char repeated); the
// row's header ('$' before every content row but the band's first, '#'
// and the colour's digits) comes first.  A block scan of the runs' byte
// counts places each run.
//
// dcs_band_lens writes each band's byte total and colour count;
// dcs_emit redoes the layout and writes the bytes into [nb, cap] band
// buffers at their scanned offsets (the wrapper zeroes the buffers, so
// the tails past band_lens are 0; nothing is written at or past cap).
// The host reads the lengths to pick cap between the two launches, as
// the reference does.
//
// Bound on the H100: device-memory bytes (each plane byte read once, the
// band buffers written once); the work is a few integer operations a
// pixel and a listed colour, with several block barriers a row of 256
// columns.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;   // one thread a colour in the presence scan
constexpr int kWarps = kThreads / 32;
constexpr int kColorCap = 64;

struct Planes {
  const uint8_t* p;
  long long frame_stride, row_stride;
  int h, w, nb;
};

// Decimal digits, capped at 4 as the reference counts them.
__device__ __forceinline__ int digits(int v) {
  return v >= 1000 ? 4 : v >= 100 ? 3 : v >= 10 ? 2 : 1;
}

// Exclusive block scan of one int a thread (all threads call it); *total
// gets the block's sum.
__device__ __forceinline__ int block_scan(int v, int* warp_sums, int* total) {
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  int x = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) warp_sums[wid] = x;
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
  return base + x - v;
}

// The reference's digit k (0 = most significant) of v with nd digits:
// (v / 10^(nd - 1 - k)) % 10, the power capped at 1000.
__device__ __forceinline__ char digit(int v, int nd, int k) {
  const int p = nd - 1 - k;
  const int p10 = p <= 0 ? 1 : p == 1 ? 10 : p == 2 ? 100 : 1000;
  return (char)('0' + (v / p10) % 10);
}

template <bool kEmit>
__global__ void __launch_bounds__(kThreads)
dcs_bands(Planes P, int cap, int32_t* __restrict__ lens,
          int32_t* __restrict__ counts, uint8_t* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  int16_t* starts = (int16_t*)smem;              // w start columns
  uint8_t* rows = smem + 2 * P.w;                // 6 rows of w
  uint8_t* mrow = rows + 6 * P.w;                // a colour's mask row
  __shared__ uint8_t present[256];
  __shared__ int clist[kColorCap];
  __shared__ int warp_sums[kWarps];

  const int tid = threadIdx.x;
  const int band = blockIdx.x, f = blockIdx.y;
  const int w = P.w;
  const int nrows = min(6, P.h - band * 6);
  const uint8_t* src = P.p + f * P.frame_stride
                       + (long long)band * 6 * P.row_stride;
  present[tid] = 0;
  for (int i = tid; i < nrows * w; i += kThreads) {
    const int r = i / w, x = i - r * w;
    rows[i] = src[(long long)r * P.row_stride + x];
  }
  __syncthreads();
  for (int i = tid; i < nrows * w; i += kThreads) present[rows[i]] = 1;
  __syncthreads();
  int total;
  const int p = present[tid];
  const int rank = block_scan(p, warp_sums, &total);
  if (p && rank < kColorCap) clist[rank] = tid;
  __syncthreads();
  const int ncol = min(total, kColorCap);

  uint8_t* dst = kEmit ? out + ((long long)f * P.nb + band) * cap : nullptr;
  int pos = 0;           // the band's bytes so far (the same in all threads)
  bool seen = false;     // a content row came before
  for (int ci = 0; ci < ncol; ++ci) {
    const int color = clist[ci];
    int any = 0;
    for (int x = tid; x < w; x += kThreads) {
      int m = 0;
      for (int r = 0; r < nrows; ++r) m |= (rows[r * w + x] == color) << r;
      mrow[x] = (uint8_t)m;
      any |= m;
    }
    const bool content = __syncthreads_or(any) != 0;
    int nstarts = 0;
    for (int x0 = 0; x0 < w; x0 += kThreads) {   // uniform trip count
      const int x = x0 + tid;
      const int s = x < w && (x == 0 || mrow[x] != mrow[x - 1]);
      int tot;
      const int r = block_scan(s, warp_sums, &tot);
      if (s) starts[nstarts + r] = (int16_t)x;
      nstarts += tot;
    }
    __syncthreads();
    if (content) {
      const int nd = digits(color);
      if (kEmit && tid == 0) {
        int q = pos;
        if (seen && q < cap) dst[q] = '$';
        q += seen;
        if (q < cap) dst[q] = '#';
        ++q;
        for (int k = 0; k < nd; ++k, ++q)
          if (q < cap) dst[q] = digit(color, nd, k);
      }
      pos += 1 + nd + (seen ? 1 : 0);
    }
    for (int k0 = 0; k0 < nstarts; k0 += kThreads) {   // uniform
      const int k = k0 + tid;
      int len = 0, value = 0, nbytes = 0;
      if (k < nstarts) {
        const int x = starts[k];
        len = (k + 1 < nstarts ? starts[k + 1] : w) - x;
        value = mrow[x];
        if (!(k == nstarts - 1 && value == 0))
          nbytes = len > 3 ? 2 + digits(len) : len;
      }
      int tot;
      const int off = block_scan(nbytes, warp_sums, &tot);
      if (kEmit && nbytes) {
        const char ch = (char)(0x3F + value);
        int q = pos + off;
        if (len > 3) {
          const int nd = nbytes - 2;
          if (q < cap) dst[q] = '!';
          ++q;
          for (int d = 0; d < nd; ++d, ++q)
            if (q < cap) dst[q] = digit(len, nd, d);
          if (q < cap) dst[q] = ch;
        } else {
          for (int d = 0; d < len; ++d, ++q)
            if (q < cap) dst[q] = ch;
        }
      }
      pos += tot;
    }
    seen = seen || content;
    __syncthreads();      // mrow and starts are the next colour's
  }
  if (tid == 0) {
    lens[f * P.nb + band] = pos;
    if (!kEmit) counts[f * P.nb + band] = total;
  }
}

template <bool kEmit>
int launch(const Planes& P, int b, int cap, void* lens, void* counts,
           void* out, void* stream) {
  const size_t smem = 9 * (size_t)P.w;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        dcs_bands<kEmit>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  dcs_bands<kEmit><<<dim3(P.nb, b), kThreads, smem, (cudaStream_t)stream>>>(
      P, cap, (int32_t*)lens, (int32_t*)counts, (uint8_t*)out);
  return (int)cudaGetLastError();
}

}  // namespace

// planes: [B, >=h, >=w] uint8 with the given strides (elements); lens and
// counts: [B, nb] int32 out (bytes of each band's body; present colours).
extern "C" int timg_dcs_band_lens(const void* planes, int b, int h, int w,
                                  long long frame_stride,
                                  long long row_stride, void* lens,
                                  void* counts, void* stream) {
  const Planes P{(const uint8_t*)planes, frame_stride, row_stride, h, w,
                 (h + 5) / 6};
  return launch<false>(P, b, 0, lens, counts, nullptr, stream);
}

// bands: [B, nb, cap] uint8 out, zeroed by the caller; lens: [B, nb]
// int32 out.
extern "C" int timg_dcs_emit(const void* planes, int b, int h, int w,
                             long long frame_stride, long long row_stride,
                             int cap, void* bands, void* lens,
                             void* stream) {
  const Planes P{(const uint8_t*)planes, frame_stride, row_stride, h, w,
                 (h + 5) / 6};
  return launch<true>(P, b, cap, lens, nullptr, bands, stream);
}

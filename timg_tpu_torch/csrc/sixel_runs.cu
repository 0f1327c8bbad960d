// Sixel column runs of uint8 index planes: run counts a band and the
// compacted run records (the run-record device->host transport).
//
// Replaces timg_tpu/ops/sixel_runs.py run_counts and compact_runs (XLA
// device ops in the reference; no Pallas kernel).  Input: [B, >=h, >=w]
// uint8 planes, rows contiguous, at any byte address, given with their
// frame and row strides.  A band is 6 rows; rows past h (the last band's
// pad) read as 0.  A column's words are w0 = c0 | c1 << 8 | c2 << 16 |
// c3 << 24 and w1 = c4 | c5 << 8 (uint32, so c3 << 24 does not
// overflow); a run starts at x = 0 and wherever (w0, w1) differs from
// column x - 1.
//
// Bound on the H100: device-memory bytes (each plane byte read once, 8
// bytes a record slot written).  So each plane byte is loaded once, in
// aligned 16-byte loads:
// - A lane takes a span of 16 adjacent columns, a warp 512.  For each of
//   the band's rows it loads the aligned 16 bytes at or before its span
//   and takes the next 16 from the lane above by shuffle (lane 31 loads
//   them itself where the row is not 16-byte aligned); a select by word
//   and a funnel shift by byte give the span's 16 bytes, whatever the
//   row's alignment (one code path: the shifts are 0 on aligned rows).
// - The start flags come from the rows as they lie: a row XOR itself one
//   column to the right, ORed over the band's rows, is nonzero in
//   column x's byte exactly where column x starts a run; the 16 flags
//   form a bit mask.  Column x0 - 1, the span's left neighbour, comes
//   from the lane below by shuffle, from the warp before through shared
//   memory, or from the previous tile in a register.
//
// band_run_counts: one warp a (frame, band), four bands a block (the
// CLI's 8 frames of 120 bands still fill every SM); the warp walks its
// band 512 columns a step, the next step's loads issued before this
// step's work, its neighbour carried across steps, sums the popc of its
// masks and reduces by shuffle.  Output [B, nb] int32.
//
// compact_runs: one block a (band, frame), as many warps (at most 4) as
// 512-column spans cover the band, walking tiles of that width.  A
// start's record slot is the band's first record (the exclusive sum of
// the frame's earlier band counts, which warp 0 takes from the counts
// the caller passes while its loads are in flight) + the records of the
// band's earlier tiles + the exclusive sum of the tile's earlier warps +
// a warp shuffle scan of the lanes' popc + the popc of the lane's mask
// below it, so the records come out band-major then by x, the order of
// the reference's sort keyed on the flat position, without a sort.  A
// warp's first flag needs the warp before it, so each warp publishes
// its first and last columns and its count without that flag, and after
// one barrier a tile every thread completes the scan of the warp totals
// (shared slots alternate between tiles, so one barrier a tile
// suffices).  A record (w0, w1 | x << 16) is staged in the warp's shared
// slots (a 16-record skew keeps a lane's 16 records off one bank) and
// copied out in order, one coalesced 8-byte store each; slots at or past
// n are not written (the reference truncates the same way; the caller
// checks the counts first).  Every slot from the frame's total to n is
// written 0, shared out over the frame's bands, 16 bytes a store, so the
// kernel writes every byte of its [B, n, 2] output and the caller
// allocates it uninitialised.  The output goes out in streaming stores
// (evict first): the host fetches it once, so it need not displace
// other lines from L2.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kSpan = 16;                // columns a lane
constexpr int kWarpCols = 32 * kSpan;    // columns a warp
constexpr int kCountWarps = 4;           // bands a block of band_run_counts
constexpr int kMaxWarps = 4;             // warps a band in compact_runs
constexpr unsigned kAll = 0xffffffffu;

struct Planes {
  const uint8_t* p;
  long long frame_stride, row_stride;
  int h, w, nb;
};

// One column of a band: rows 0-3 in w0 (row r in byte r), rows 4-5 in
// w1's low half.
struct Column {
  uint32_t w0, w1;
};

// lo[r] <- the aligned 16 bytes at or before the span of row r of the
// band at src (they hold columns x0 - off .. x0 - off + 15, off the row's
// address mod 16); rows from nrows on, and chunks that hold no column
// below w, read as 0.
__device__ __forceinline__ void load_chunks(const uint8_t* src,
                                            long long row_stride, int nrows,
                                            int x0, int w, uint4 (&lo)[6]) {
#pragma unroll
  for (int r = 0; r < 6; ++r) {
    const uint8_t* row = src + r * row_stride;
    const int off = (int)((uintptr_t)row & 15);
    lo[r] = make_uint4(0, 0, 0, 0);
    if (r < nrows && x0 - off < w)
      lo[r] = __ldg((const uint4*)(row - off + x0));
  }
}

// R[r][j] <- row r's columns x0 + 4j .. x0 + 4j + 3 (byte k: column
// x0 + 4j + k), from the chunks of load_chunks: the next 16 bytes from
// the lane above (lane 31 loads them where the row is not aligned), then
// a select by word and a funnel shift by byte.  Every lane of the warp
// calls it with x0 = (a multiple of 512) + 16 lane.
__device__ __forceinline__ void align_span(const uint8_t* src,
                                           long long row_stride, int nrows,
                                           int x0, int w,
                                           const uint4 (&lo)[6],
                                           uint32_t (&R)[6][4]) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int r = 0; r < 6; ++r) {
    const uint8_t* row = src + r * row_stride;
    const int off = (int)((uintptr_t)row & 15);
    uint4 hi;
    hi.x = __shfl_down_sync(kAll, lo[r].x, 1);
    hi.y = __shfl_down_sync(kAll, lo[r].y, 1);
    hi.z = __shfl_down_sync(kAll, lo[r].z, 1);
    hi.w = __shfl_down_sync(kAll, lo[r].w, 1);
    if (lane == 31) {
      hi = make_uint4(0, 0, 0, 0);
      if (r < nrows && off && x0 + 16 - off < w)
        hi = __ldg((const uint4*)(row - off + x0) + 1);
    }
    uint32_t e[8] = {lo[r].x, lo[r].y, lo[r].z, lo[r].w,
                     hi.x, hi.y, hi.z, hi.w};
#pragma unroll
    for (int i = 0; i < 6; ++i) e[i] = (off & 8) ? e[i + 2] : e[i];
#pragma unroll
    for (int i = 0; i < 5; ++i) e[i] = (off & 4) ? e[i + 1] : e[i];
    const unsigned shift = 8 * (off & 3);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      R[r][j] = __funnelshift_r(e[j], e[j + 1], shift);
  }
}

// Column 4j + k of a span (j, k constants).
__device__ __forceinline__ Column column_at(const uint32_t (&R)[6][4], int j,
                                            int k) {
  const unsigned sel = k | (k + 4) << 4;
  const uint32_t a = __byte_perm(R[0][j], R[1][j], sel);
  const uint32_t b = __byte_perm(R[2][j], R[3][j], sel);
  return {__byte_perm(a, b, 0x5410), __byte_perm(R[4][j], R[5][j], sel)
                                         & 0xffffu};
}

// The span's start flags (bit k: column x0 + k), given column x0 - 1;
// bit 0 is set at x0 = 0 and columns at or past w are 0.
__device__ __forceinline__ unsigned span_starts(const uint32_t (&R)[6][4],
                                                Column prev, int x0, int w) {
  uint32_t d[4] = {0, 0, 0, 0};
#pragma unroll
  for (int r = 0; r < 6; ++r) {
    // the row one column to the right: column x's byte from column x - 1
    const uint32_t pb = r < 4 ? prev.w0 : prev.w1;
    d[0] |= R[r][0] ^ __byte_perm(pb, R[r][0], 0x6540 | (r & 3));
#pragma unroll
    for (int j = 1; j < 4; ++j)
      d[j] |= R[r][j] ^ __funnelshift_l(R[r][j - 1], R[r][j], 8);
  }
  unsigned m = 0;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    // bit 7 of each byte: the byte is nonzero; then the 4 bits gathered
    const uint32_t nz =
        (((d[j] & 0x7f7f7f7fu) + 0x7f7f7f7fu) | d[j]) & 0x80808080u;
    m |= ((((nz >> 7) * 0x00204081u) >> 21) & 15u) << (4 * j);
  }
  if (x0 == 0) m |= 1;
  const int valid = w - x0;
  return valid >= kSpan ? m : valid > 0 ? m & ((1u << valid) - 1) : 0;
}

__global__ void __launch_bounds__(32 * kCountWarps)
band_run_counts(Planes P, int nbands, int32_t* __restrict__ counts) {
  const int lane = threadIdx.x & 31;
  const int g = blockIdx.x * kCountWarps + (threadIdx.x >> 5);  // f nb + band
  if (g >= nbands) return;                                     // the warp
  const int f = g / P.nb, band = g - f * P.nb;
  const int nrows = min(6, P.h - band * 6);
  const uint8_t* src = P.p + f * P.frame_stride
                       + (long long)band * 6 * P.row_stride;
  Column carry{0, 0};   // column x0 - 1 of the step's lane 0
  int n = 0;
  uint4 lo[6], next[6];
  load_chunks(src, P.row_stride, nrows, lane * kSpan, P.w, lo);
  for (int xt = 0; xt < P.w; xt += kWarpCols) {
    const int x0 = xt + lane * kSpan;
    // the next step's loads go out before this step's work
    load_chunks(src, P.row_stride, nrows, x0 + kWarpCols, P.w, next);
    uint32_t R[6][4];
    align_span(src, P.row_stride, nrows, x0, P.w, lo, R);
    const Column last = column_at(R, 3, 3);
    Column prev{__shfl_up_sync(kAll, last.w0, 1),
                __shfl_up_sync(kAll, last.w1, 1)};
    if (lane == 0) prev = carry;
    n += __popc(span_starts(R, prev, x0, P.w));
    carry = {__shfl_sync(kAll, last.w0, 31), __shfl_sync(kAll, last.w1, 31)};
#pragma unroll
    for (int r = 0; r < 6; ++r) lo[r] = next[r];
  }
  n = __reduce_add_sync(kAll, n);
  if (lane == 0) counts[g] = n;
}

__global__ void __launch_bounds__(32 * kMaxWarps)
compact_runs(Planes P, const int32_t* __restrict__ counts, int n,
             int32_t* __restrict__ records) {
  // each warp's records of a tile, one skewed slot a 16 (conflict-free
  // where a lane stores 16 records), copied out in order
  __shared__ int2 s_rec[kMaxWarps][kWarpCols + kWarpCols / 16];
  __shared__ Column s_first[2][kMaxWarps], s_last[2][kMaxWarps];
  __shared__ int s_part[2][kMaxWarps];
  __shared__ int s_base, s_total;
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  const int band = blockIdx.x, f = blockIdx.y;
  const int nrows = min(6, P.h - band * 6);
  const uint8_t* src = P.p + f * P.frame_stride
                       + (long long)band * 6 * P.row_stride;
  int2* out = (int2*)records + (long long)f * n;
  int2* stage = s_rec[wid];
  Column carry{0, 0};   // the last column of the previous tile
  int running = 0;      // records of the band's earlier tiles
  for (int xt = 0, t = 0; xt < P.w; xt += nw * kWarpCols, ++t) {
    const int buf = t & 1;
    const int x0 = xt + wid * kWarpCols + lane * kSpan;
    uint4 lo[6];
    load_chunks(src, P.row_stride, nrows, x0, P.w, lo);
    if (t == 0 && wid == 0) {   // the band's first record, the frame's total
      int before = 0, total = 0;
      for (int i = lane; i < P.nb; i += 32) {
        const int c = counts[f * P.nb + i];
        total += c;
        before += i < band ? c : 0;
      }
      before = __reduce_add_sync(kAll, before);
      total = __reduce_add_sync(kAll, total);
      if (lane == 0) {
        s_base = before;
        s_total = total;
      }
    }
    uint32_t R[6][4];
    align_span(src, P.row_stride, nrows, x0, P.w, lo, R);
    const Column first = column_at(R, 0, 0), last = column_at(R, 3, 3);
    const Column prev{__shfl_up_sync(kAll, last.w0, 1),
                      __shfl_up_sync(kAll, last.w1, 1)};
    unsigned m = span_starts(R, prev, x0, P.w);
    if (lane == 0) m &= ~1u;   // the warp's first flag: after the barrier
    const int cnt = __popc(m);
    int inc = cnt;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(kAll, inc, o);
      if (lane >= o) inc += y;
    }
    if (lane == 0) s_first[buf][wid] = first;
    if (lane == 31) {
      s_last[buf][wid] = last;
      s_part[buf][wid] = inc;
    }
    __syncthreads();
    // each warp's first flag against the column before it, and the
    // exclusive scan of the warp totals
    int before = 0, tile = 0, lead = 0, mine = 0;
    Column p = carry;
#pragma unroll
    for (int k = 0; k < kMaxWarps; ++k) {
      if (k < nw) {
        const Column q = s_first[buf][k];
        const int xk = xt + k * kWarpCols;
        const int f0 = xk < P.w && (xk == 0 || q.w0 != p.w0 || q.w1 != p.w1);
        const int tot = s_part[buf][k] + f0;
        before += k < wid ? tot : 0;
        tile += tot;
        lead = k == wid ? f0 : lead;
        mine = k == wid ? tot : mine;
        p = s_last[buf][k];
      }
    }
    carry = p;
    if (lane == 0) m |= lead;
    const int slot = (lane ? lead : 0) + inc - cnt;   // in the warp's records
    if (m) {
#pragma unroll
      for (int c = 0; c < kSpan; ++c) {
        if ((m >> c) & 1) {
          const int i = slot + __popc(m & ((1u << c) - 1));
          const Column col = column_at(R, c >> 2, c & 3);
          stage[i + (i >> 4)] = make_int2(
              (int)col.w0, (int)(col.w1 | (uint32_t)(x0 + c) << 16));
        }
      }
    }
    __syncwarp();
    const int base = s_base + running + before;
    for (int i = lane; i < mine && base + i < n; i += 32)
      __stcs(out + base + i, stage[i + (i >> 4)]);
    running += tile;
  }
  // the frame's zero tail, a share a band, two records a store
  const int total = s_total;
  if (total < n) {
    const int per = (n - total + P.nb - 1) / P.nb;
    long long lo = (long long)f * n + total + (long long)band * per;
    long long hi = (long long)f * n + min(n, total + (band + 1) * per);
    int2* rec = (int2*)records;
    if (lo < hi && (lo & 1)) {
      if (threadIdx.x == 0) __stcs(rec + lo, make_int2(0, 0));
      ++lo;
    }
    if (lo < hi && (hi & 1)) {
      if (threadIdx.x == 0) __stcs(rec + hi - 1, make_int2(0, 0));
      --hi;
    }
    int4* rec4 = (int4*)records;
    for (long long i = lo / 2 + threadIdx.x; i < hi / 2; i += blockDim.x)
      __stcs(rec4 + i, make_int4(0, 0, 0, 0));
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
  const int nbands = b * P.nb;
  band_run_counts<<<(nbands + kCountWarps - 1) / kCountWarps,
                    32 * kCountWarps, 0, (cudaStream_t)stream>>>(
      P, nbands, (int32_t*)counts);
  return (int)cudaGetLastError();
}

// counts: the [B, nb] int32 of timg_band_run_counts on these planes;
// records: [B, n, 2] int32, every element written (records past a
// frame's count are 0; records at or past n are dropped).
extern "C" int timg_compact_runs(const void* planes, int b, int h, int w,
                                 long long frame_stride,
                                 long long row_stride, const void* counts,
                                 int n, void* records, void* stream) {
  const Planes P{(const uint8_t*)planes, frame_stride, row_stride, h, w,
                 (h + 5) / 6};
  const int warps = min(kMaxWarps, (w + kWarpCols - 1) / kWarpCols);
  compact_runs<<<dim3(P.nb, b), 32 * warps, 0, (cudaStream_t)stream>>>(
      P, (const int32_t*)counts, n, (int32_t*)records);
  return (int)cudaGetLastError();
}

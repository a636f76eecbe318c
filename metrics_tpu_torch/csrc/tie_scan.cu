// Segmented tie-group scan for exact AUROC / average precision (sm_90a).
//
// Replaces metrics_tpu/ops/tie_scan_pallas.py::_tie_scan_kernel (launched by
// tie_group_reduce there), both as one call and as jax.vmap of it over the
// classes of an (N, C) input. It takes a (rows, n) batch of streams, each
// row already sorted by key, and returns [area, ap_sum, n_pos, n_neg] per
// row:
//   * each tie group starts where key[i] != key[i-1] and is closed by the
//     next group start, whose exclusive prefix counts (tp, fp) are the closed
//     group's end counts;
//   * the end counts of the group before that (mt, mf) are the latest earlier
//     group start's prefix counts (counts never decrease, so a max-scan
//     forward-fills them);
//   * a group start emits the AUROC chord 0.5*(tp+mt)*(fp-mf) and the AP
//     term (tp-mt) * (tp+off_p) / max(tp+fp+off_p+off_n, 1);
//   * the last group is closed after the row's end.
// Only code 3 (relevant, valid) and code 2 (irrelevant, valid) move counts;
// codes 0 and 1 (weight 0: masked or padding) are inert. Counts are i32 per
// row (n < 2^31): an f32 cumulant stops moving at 2^24. Offsets into the
// batch are 64-bit, so rows * n may exceed 2^31.
//
// The Pallas kernel walks its grid in order and carries 8 scalars between
// steps. CUDA blocks run in no order, so this is reduce-then-scan over tiles
// of 256 threads x 16 elements, with the row as the second grid dimension:
//   (a) tile_summary_kernel, grid (tiles, rows): per-tile class counts and
//       the tile-local prefix at the tile's last group start;
//   (b) tile_scan_kernel, one block per row: each tile's exclusive counts
//       and the latest group-start prefix before it, plus the row's totals;
//   (c) tile_emit_kernel, grid (tiles, rows): per-thread warp-shuffle +
//       shared-memory block scans rebuild every element's prefix; each tile
//       writes one (area, ap) partial;
//   (d) finalize_kernel, one block per row: sums the row's partials in a
//       fixed order and adds its last group's closing term. No float
//       atomics, so a result is the same from run to run.
// gridDim.y stops at 65535, so more rows go in groups of 65535, four
// launches each; the results do not depend on the grouping. One stream is
// the batch of one row.
//
// Bound on an H100 SXM: the function reads 8 bytes per element once (4-byte
// key + 4-byte payload), so 1M elements are 8 MB, about 2.4 us at
// 3.35 TB/s, and a (1000, 50000) batch 400 MB, about 0.119 ms. This design
// reads the stream twice (passes a and c) and launches four kernels, so at
// 1M its launch latency, not bandwidth, sets its time.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kItems = 16;
constexpr int kTile = kThreads * kItems;          // elements per tile
constexpr int kPadded = kTile + kTile / kItems;   // one pad slot per thread run
constexpr int kScanThreads = 1024;
constexpr long long kMaxGridY = 65535;  // rows per launch group (gridDim.y)

// shared-memory slot of tile element e: a pad after every 16 elements puts
// the runs of neighbouring threads in different banks
__device__ __forceinline__ int slot(int e) { return e + e / kItems; }

// The sorted stream: 4-byte keys (u32 or i32; only equality is read) and
// the f32 payload rel + 2*weight, decoded to code 3, 2 or 0 (inert).
struct Stream {
  const int32_t* key;
  const float* payload;
  // row r of a row-major (rows, n) batch
  __device__ __forceinline__ Stream row(long long r, long long n) const { return {key + r * n, payload + r * n}; }
  __device__ __forceinline__ void load(long long i, int32_t& k, int& code) const {
    k = key[i];
    const float p = payload[i];
    code = p == 3.0f ? 3 : (p == 2.0f ? 2 : 0);
  }
};

struct SumOp {
  __device__ __forceinline__ static int2 apply(int2 a, int2 b) {
    return make_int2(a.x + b.x, a.y + b.y);
  }
};

struct MaxOp {
  __device__ __forceinline__ static int2 apply(int2 a, int2 b) {
    return make_int2(max(a.x, b.x), max(a.y, b.y));
  }
};

// Exclusive block scan of an int2 under Op; 0 is the identity of both ops
// here (all values are counts >= 0). Writes the block total to *total.
template <class Op, int NT>
__device__ int2 block_exclusive_scan(int2 v, int2* s_warp, int2* total) {
  constexpr int kW = NT / 32;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int2 inc = v;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    int2 o;
    o.x = __shfl_up_sync(0xffffffffu, inc.x, d);
    o.y = __shfl_up_sync(0xffffffffu, inc.y, d);
    if (lane >= d) inc = Op::apply(inc, o);
  }
  if (lane == 31) s_warp[warp] = inc;
  __syncthreads();
  if (warp == 0) {
    int2 w = lane < kW ? s_warp[lane] : make_int2(0, 0);
#pragma unroll
    for (int d = 1; d < kW; d <<= 1) {
      int2 o;
      o.x = __shfl_up_sync(0xffffffffu, w.x, d);
      o.y = __shfl_up_sync(0xffffffffu, w.y, d);
      if (lane >= d) w = Op::apply(w, o);
    }
    if (lane < kW) s_warp[lane] = w;
  }
  __syncthreads();
  int2 ex;
  ex.x = __shfl_up_sync(0xffffffffu, inc.x, 1);
  ex.y = __shfl_up_sync(0xffffffffu, inc.y, 1);
  if (lane == 0) ex = make_int2(0, 0);
  if (warp > 0) ex = Op::apply(s_warp[warp - 1], ex);
  *total = s_warp[kW - 1];
  __syncthreads();  // s_warp is reused by the next scan
  return ex;
}

// Fixed-order block sum of a double2 (tree over lanes, then over warps).
template <int NT>
__device__ double2 block_sum(double2 v, double2* s_warp) {
  constexpr int kW = NT / 32;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) {
    v.x += __shfl_down_sync(0xffffffffu, v.x, d);
    v.y += __shfl_down_sync(0xffffffffu, v.y, d);
  }
  if (lane == 0) s_warp[warp] = v;
  __syncthreads();
  double2 r = make_double2(0.0, 0.0);
  if (warp == 0) {
    r = lane < kW ? s_warp[lane] : make_double2(0.0, 0.0);
#pragma unroll
    for (int d = 16; d > 0; d >>= 1) {
      r.x += __shfl_down_sync(0xffffffffu, r.x, d);
      r.y += __shfl_down_sync(0xffffffffu, r.y, d);
    }
  }
  return r;  // valid in thread 0
}

// One thread's run of kItems consecutive elements, as bit masks.
struct Run {
  unsigned first, pos, neg;
};

// Stage tile blockIdx.x of one row in shared memory with coalesced loads,
// then read this thread's run. A group starts at the row's element 0 and
// wherever the key differs from the previous element's; the previous key
// across the tile edge is read straight from global memory, and the row's
// first tile reads none (never the previous row's last key). Elements past
// n are inert and start nothing.
__device__ Run load_run(const Stream& in, long long n, int32_t* sk, uint8_t* sc) {
  const long long base = (long long)blockIdx.x * kTile;
#pragma unroll 4
  for (int r = 0; r < kItems; ++r) {
    const int e = r * kThreads + threadIdx.x;
    const long long i = base + e;
    int32_t k = 0;
    int code = 0;
    if (i < n) in.load(i, k, code);
    sk[slot(e)] = k;
    sc[slot(e)] = (uint8_t)code;
  }
  __syncthreads();
  const int t0 = threadIdx.x * kItems;
  const long long g0 = base + t0;
  int32_t prev = 0;
  bool have_prev = false;
  if (threadIdx.x > 0) {
    prev = sk[slot(t0 - 1)];
    have_prev = true;
  } else if (base > 0) {
    prev = in.key[base - 1];
    have_prev = true;
  }
  Run run = {0u, 0u, 0u};
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    if (g0 + j >= n) break;
    const int32_t k = sk[slot(t0 + j)];
    const int code = sc[slot(t0 + j)];
    if (!have_prev || k != prev) run.first |= 1u << j;
    if (code == 3) run.pos |= 1u << j;
    if (code == 2) run.neg |= 1u << j;
    prev = k;
    have_prev = true;
  }
  return run;
}

// (a) per tile of row row0 + blockIdx.y: (n_pos, n_neg, tp, fp) where
// tp/fp are the tile-local exclusive counts at the tile's last group start,
// -1 if it has none.
__global__ void __launch_bounds__(kThreads)
    tile_summary_kernel(Stream in, long long n, long long row0, int4* summary) {
  __shared__ int32_t sk[kPadded];
  __shared__ uint8_t sc[kPadded];
  __shared__ int2 s_warp[kThreads / 32];
  const long long row = row0 + blockIdx.y;
  const Run run = load_run(in.row(row, n), n, sk, sc);
  int2 total;
  const int2 ex = block_exclusive_scan<SumOp, kThreads>(
      make_int2(__popc(run.pos), __popc(run.neg)), s_warp, &total);
  // this thread's last group start, as prefix + 1 (0 = none)
  int2 c = ex;
  int2 last = make_int2(0, 0);
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    if (run.first >> j & 1u) last = make_int2(c.x + 1, c.y + 1);
    c.x += run.pos >> j & 1u;
    c.y += run.neg >> j & 1u;
  }
  int2 last_max;
  block_exclusive_scan<MaxOp, kThreads>(last, s_warp, &last_max);
  if (threadIdx.x == 0) {
    summary[row * gridDim.x + blockIdx.x] = make_int4(total.x, total.y, last_max.x - 1, last_max.y - 1);
  }
}

// (b) one block per row (row0 + blockIdx.x): carry[t] = (exclusive n_pos,
// exclusive n_neg, tp, fp at the latest group start before tile t, 0 if
// none); totals = (n_pos, n_neg, tp, fp at the row's last group start).
__global__ void __launch_bounds__(kScanThreads)
    tile_scan_kernel(const int4* summary, int num_tiles, long long row0, int4* carry, int* totals) {
  __shared__ int2 s_warp[kScanThreads / 32];
  const long long row = row0 + blockIdx.x;
  summary += row * num_tiles;
  carry += row * num_tiles;
  totals += 4 * row;
  const int per = (num_tiles + kScanThreads - 1) / kScanThreads;
  const int lo = min(num_tiles, (int)threadIdx.x * per);
  const int hi = min(num_tiles, lo + per);
  int2 own = make_int2(0, 0);
  for (int t = lo; t < hi; ++t) {
    own.x += summary[t].x;
    own.y += summary[t].y;
  }
  int2 count_total;
  const int2 base0 = block_exclusive_scan<SumOp, kScanThreads>(own, s_warp, &count_total);
  int2 base = base0;
  int2 latest = make_int2(0, 0);
  for (int t = lo; t < hi; ++t) {
    const int4 s = summary[t];
    if (s.z >= 0) latest = make_int2(max(latest.x, base.x + s.z), max(latest.y, base.y + s.w));
    base.x += s.x;
    base.y += s.y;
  }
  int2 latest_total;
  const int2 incoming = block_exclusive_scan<MaxOp, kScanThreads>(latest, s_warp, &latest_total);
  base = base0;
  int2 m = incoming;
  for (int t = lo; t < hi; ++t) {
    const int4 s = summary[t];
    carry[t] = make_int4(base.x, base.y, m.x, m.y);
    if (s.z >= 0) m = make_int2(max(m.x, base.x + s.z), max(m.y, base.y + s.w));
    base.x += s.x;
    base.y += s.y;
  }
  if (threadIdx.x == 0) {
    totals[0] = count_total.x;
    totals[1] = count_total.y;
    totals[2] = latest_total.x;
    totals[3] = latest_total.y;
  }
}

// (c) per tile of row row0 + blockIdx.y: every group start closes the
// previous group; the tile's sum of chords and AP terms goes to its partial.
__global__ void __launch_bounds__(kThreads) tile_emit_kernel(
    Stream in, long long n, long long row0, const int4* carry, float off_p, float off_n, double2* partial) {
  __shared__ int32_t sk[kPadded];
  __shared__ uint8_t sc[kPadded];
  __shared__ int2 s_warp[kThreads / 32];
  __shared__ double2 s_sum[kThreads / 32];
  const long long row = row0 + blockIdx.y;
  const long long tile = row * gridDim.x + blockIdx.x;
  const Run run = load_run(in.row(row, n), n, sk, sc);
  const int4 tc = carry[tile];
  int2 total;
  int2 ex = block_exclusive_scan<SumOp, kThreads>(
      make_int2(__popc(run.pos), __popc(run.neg)), s_warp, &total);
  ex.x += tc.x;
  ex.y += tc.y;
  int2 c = ex;
  int2 last = make_int2(0, 0);
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    if (run.first >> j & 1u) last = c;
    c.x += run.pos >> j & 1u;
    c.y += run.neg >> j & 1u;
  }
  const int2 in_tile = block_exclusive_scan<MaxOp, kThreads>(last, s_warp, &total);
  int2 m = make_int2(max(in_tile.x, tc.z), max(in_tile.y, tc.w));
  c = ex;
  double2 acc = make_double2(0.0, 0.0);
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    if (run.first >> j & 1u) {
      const float tp = (float)c.x, fp = (float)c.y, mt = (float)m.x, mf = (float)m.y;
      const float chord = 0.5f * (tp + mt) * (fp - mf);
      const float prec = (tp + off_p) / fmaxf(tp + fp + off_p + off_n, 1.0f);
      acc.x += (double)chord;
      acc.y += (double)((tp - mt) * prec);
      m = c;
    }
    c.x += run.pos >> j & 1u;
    c.y += run.neg >> j & 1u;
  }
  const double2 r = block_sum<kThreads>(acc, s_sum);
  if (threadIdx.x == 0) partial[tile] = r;
}

// (d) one block per row (row0 + blockIdx.x): fixed-order sum of the row's
// partials plus the closing term of its last group; out row = [area,
// ap_sum, n_pos, n_neg].
__global__ void __launch_bounds__(kThreads) finalize_kernel(
    const double2* partial, int num_tiles, long long row0, const int* totals, float off_p, float off_n,
    float* out) {
  __shared__ double2 s_sum[kThreads / 32];
  const long long row = row0 + blockIdx.x;
  partial += row * num_tiles;
  totals += 4 * row;
  out += 4 * row;
  double2 acc = make_double2(0.0, 0.0);
  for (int t = threadIdx.x; t < num_tiles; t += kThreads) {
    acc.x += partial[t].x;
    acc.y += partial[t].y;
  }
  const double2 r = block_sum<kThreads>(acc, s_sum);
  if (threadIdx.x == 0) {
    const float tp = (float)totals[0], fp = (float)totals[1];
    const float mt = (float)totals[2], mf = (float)totals[3];
    const float area_close = 0.5f * (tp + mt) * (fp - mf);
    const float ap_close = (tp - mt) * ((tp + off_p) / fmaxf(tp + fp + off_p + off_n, 1.0f));
    out[0] = (float)(r.x + (double)area_close);
    out[1] = (float)(r.y + (double)ap_close);
    out[2] = tp;
    out[3] = fp;
  }
}

int num_tiles_for(long long n) { return n > 0 ? (int)((n + kTile - 1) / kTile) : 1; }

int launch(Stream in, long long rows, long long n, float off_p, float off_n, void* scratch, void* partial,
           void* out, cudaStream_t stream) {
  const int tiles = num_tiles_for(n);
  int4* summary = static_cast<int4*>(scratch);
  int4* carry = summary + rows * tiles;
  int* totals = reinterpret_cast<int*>(carry + rows * tiles);
  double2* parts = static_cast<double2*>(partial);
  float* result = static_cast<float*>(out);
  cudaError_t err;
  for (long long row0 = 0; row0 < rows; row0 += kMaxGridY) {
    const int group = (int)(rows - row0 < kMaxGridY ? rows - row0 : kMaxGridY);
    const dim3 grid(tiles, group);
    tile_summary_kernel<<<grid, kThreads, 0, stream>>>(in, n, row0, summary);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    tile_scan_kernel<<<group, kScanThreads, 0, stream>>>(summary, tiles, row0, carry, totals);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    tile_emit_kernel<<<grid, kThreads, 0, stream>>>(in, n, row0, carry, off_p, off_n, parts);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    finalize_kernel<<<group, kThreads, 0, stream>>>(parts, tiles, row0, totals, off_p, off_n, result);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  return 0;
}

}  // namespace

extern "C" {

// Elements per tile; the caller sizes the scratch buffers from it:
// scratch holds rows * (8 * tiles + 4) int32, partial rows * 2 * tiles
// float64, with tiles = max(1, ceil(n / tile_elems)).
int tie_scan_tile_elems(void) { return kTile; }

// key: (rows, n) 4-byte keys, payload: (rows, n) f32, both row-major and
// sorted by key within each row; out: (rows, 4) f32; all on CUDA device
// `device`. Launches on `stream`; returns the first CUDA error (0 when every
// launch was accepted).
int tie_scan_rows(int device, const void* key, const void* payload, long long rows, long long n, float off_p,
                  float off_n, void* scratch, void* partial, void* out, void* stream) {
  // this library links its own CUDA runtime, whose current device is not
  // the caller's: select the tensors' device before launching
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  Stream in = {static_cast<const int32_t*>(key), static_cast<const float*>(payload)};
  return launch(in, rows, n, off_p, off_n, scratch, partial, out, static_cast<cudaStream_t>(stream));
}

// One stream of n elements: the batch of one row.
int tie_scan(int device, const void* key, const void* payload, long long n, float off_p, float off_n,
             void* scratch, void* partial, void* out, void* stream) {
  return tie_scan_rows(device, key, payload, 1, n, off_p, off_n, scratch, partial, out, stream);
}

}  // extern "C"

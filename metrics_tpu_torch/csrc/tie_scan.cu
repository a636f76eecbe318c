// Segmented tie-group scan for exact AUROC / average precision (sm_90a).
//
// Replaces metrics_tpu/ops/tie_scan_pallas.py::_tie_scan_kernel (launched by
// tie_group_reduce there) in each of its call shapes: one stream, jax.vmap of
// it over the classes of an (N, C) input, with the bucket offsets of the
// distributed sample sort, and weighted (weights_s=). It takes a (rows, n)
// batch of streams, each row already sorted by key, and returns
// [area, ap_sum, pos, neg] per row:
//   * each tie group starts where key[i] != key[i-1] and is closed by the
//     next group start, whose exclusive prefix sums (tp, fp) are the closed
//     group's end sums;
//   * the end sums of the group before that (mt, mf) are the latest earlier
//     group start's prefix sums (sums of non-negative terms never decrease,
//     so a max-scan forward-fills them);
//   * a group start emits the AUROC chord 0.5*(tp+mt)*(fp-mf) and the AP
//     term (tp-mt) * (tp+off_p) / max(tp+fp+off_p+off_n, floor);
//   * the last group is closed after the row's end.
// Only code 3 (relevant, valid) and code 2 (irrelevant, valid) move the sums;
// codes 0 and 1 (masked or padding) are inert, whatever their weight.
//
// Two accumulators, one copy of the code (template <bool W>):
//   * unweighted (tie_scan, tie_scan_rows): i32 counts per row (n < 2^31: an
//     f32 cumulant stops moving at 2^24), f32 terms, floor 1;
//   * weighted (tie_scan_w, tie_scan_rows_w): one f32 weight per element,
//     pos = w where code 3 and neg = w where code 2. Prefix sums, tile sums
//     and terms are f64 (the Pallas kernel pins its f32 prefix products to
//     precision=HIGHEST because bf16-rounded operands cost about 1e-3; f64
//     keeps the sums far below one f32 ulp), floor 1e-30 (weighted totals
//     may sit below 1). Reassociated prefix sums may dip by an f64 ulp at a
//     thread or tile edge; the forward fill is a max, which repairs that as
//     JAX's cummax does. The "no group start in this tile" sentinel is -1
//     and the fill's identity 0: both lie below every real prefix because
//     weights are non-negative, which the metrics check at update.
// Offsets into the batch are 64-bit, so rows * n may exceed 2^31.
//
// The Pallas kernel walks its grid in order and carries 8 scalars between
// steps. CUDA blocks run in no order, so this is reduce-then-scan over tiles
// of 256 threads x 16 elements, with the row as the second grid dimension:
//   (a) tile_summary_kernel, grid (tiles, rows): per-tile class sums and
//       the tile-local prefix at the tile's last group start;
//   (b) tile_scan_kernel, one block per row: each tile's exclusive sums and
//       the latest group-start prefix before it, plus the row's totals;
//   (c) tile_emit_kernel, grid (tiles, rows): per-thread warp-shuffle +
//       shared-memory block scans rebuild every element's prefix; each tile
//       writes one (area, ap) partial;
//   (d) finalize_kernel, one block per row: sums the row's partials in a
//       fixed order and adds its last group's closing term. No float
//       atomics, so a result is the same from run to run, and a row of a
//       batch equals the one-stream launch of that row bit for bit.
// A tile is staged in shared memory: keys, codes and, weighted, weights
// (39 KB with the padding, under the 48 KB static limit). gridDim.y stops at
// 65535, so more rows go in groups of 65535, four launches each; the
// results do not depend on the grouping. One stream is the batch of one row.
//
// Bound on an H100 SXM: the function reads each element once, 8 bytes
// unweighted (4-byte key + 4-byte payload) and 12 weighted (+ 4-byte
// weight). At 3.35 TB/s that is about 2.4 us for 1M unweighted elements,
// 0.119 ms for an unweighted (1000, 50000) batch, 0.179 ms weighted, and
// 0.164 ms for 45,840,617 weighted elements. This design reads the stream
// twice (passes a and c) and launches four kernels, so at 1M its launch
// latency, not bandwidth, sets its time.
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

// The (pos, neg) pair each variant sums: counts, or weight sums.
template <bool W>
struct Acc;
template <>
struct Acc<false> {
  using T = int;
  using V = int2;
};
template <>
struct Acc<true> {
  using T = double;
  using V = double2;
};

template <class V>
__device__ __forceinline__ V splat(int x);
template <>
__device__ __forceinline__ int2 splat<int2>(int x) {
  return make_int2(x, x);
}
template <>
__device__ __forceinline__ double2 splat<double2>(int x) {
  return make_double2(x, x);
}

struct SumOp {
  __device__ __forceinline__ static int2 apply(int2 a, int2 b) { return make_int2(a.x + b.x, a.y + b.y); }
  __device__ __forceinline__ static double2 apply(double2 a, double2 b) {
    return make_double2(a.x + b.x, a.y + b.y);
  }
};

struct MaxOp {
  __device__ __forceinline__ static int2 apply(int2 a, int2 b) { return make_int2(max(a.x, b.x), max(a.y, b.y)); }
  __device__ __forceinline__ static double2 apply(double2 a, double2 b) {
    return make_double2(fmax(a.x, b.x), fmax(a.y, b.y));
  }
};

// tile t's class sums and the tile-local prefix at its last group start
// (-1 if it has none)
template <class V>
struct Summary {
  V tot, last;
};

// the sums before tile t and the prefix at the latest group start before
// it (0 if none)
template <class V>
struct Carry {
  V base, m;
};

// Exclusive block scan of a pair under Op, whose identity is `identity`.
// Writes the block total to *total.
template <class Op, int NT, class V>
__device__ V block_exclusive_scan(V v, V identity, V* s_warp, V* total) {
  constexpr int kW = NT / 32;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  V inc = v;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    V o;
    o.x = __shfl_up_sync(0xffffffffu, inc.x, d);
    o.y = __shfl_up_sync(0xffffffffu, inc.y, d);
    if (lane >= d) inc = Op::apply(inc, o);
  }
  if (lane == 31) s_warp[warp] = inc;
  __syncthreads();
  if (warp == 0) {
    V w = lane < kW ? s_warp[lane] : identity;
#pragma unroll
    for (int d = 1; d < kW; d <<= 1) {
      V o;
      o.x = __shfl_up_sync(0xffffffffu, w.x, d);
      o.y = __shfl_up_sync(0xffffffffu, w.y, d);
      if (lane >= d) w = Op::apply(w, o);
    }
    if (lane < kW) s_warp[lane] = w;
  }
  __syncthreads();
  V ex;
  ex.x = __shfl_up_sync(0xffffffffu, inc.x, 1);
  ex.y = __shfl_up_sync(0xffffffffu, inc.y, 1);
  if (lane == 0) ex = identity;
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

// The sorted stream: 4-byte keys (u32 or i32; only equality is read), the
// f32 payload rel + 2*valid, decoded to code 3, 2 or 0 (inert), and in the
// weighted variant the f32 weights.
struct Stream {
  const int32_t* key;
  const float* payload;
  const float* weight;  // null in the unweighted variant
  // row r of a row-major (rows, n) batch
  __device__ __forceinline__ Stream row(long long r, long long n) const {
    return {key + r * n, payload + r * n, weight ? weight + r * n : nullptr};
  }
};

// One thread's run of kItems consecutive elements, as bit masks; t0 is its
// first element in the tile (its weights are sw[slot(t0 + j)]).
struct Run {
  unsigned first, pos, neg;
  int t0;
};

// Stage tile blockIdx.x of one row in shared memory with coalesced loads,
// then read this thread's run. A group starts at the row's element 0 and
// wherever the key differs from the previous element's; the previous key
// across the tile edge is read straight from global memory, and the row's
// first tile reads none (never the previous row's last key). Elements past
// n are inert and start nothing.
template <bool W>
__device__ Run load_run(const Stream& in, long long n, int32_t* sk, uint8_t* sc, float* sw) {
  const long long base = (long long)blockIdx.x * kTile;
#pragma unroll 4
  for (int r = 0; r < kItems; ++r) {
    const int e = r * kThreads + threadIdx.x;
    const long long i = base + e;
    int32_t k = 0;
    int code = 0;
    float w = 0.0f;
    if (i < n) {
      k = in.key[i];
      const float p = in.payload[i];
      code = p == 3.0f ? 3 : (p == 2.0f ? 2 : 0);
      if constexpr (W) w = in.weight[i];
    }
    sk[slot(e)] = k;
    sc[slot(e)] = (uint8_t)code;
    if constexpr (W) sw[slot(e)] = w;
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
  Run run = {0u, 0u, 0u, t0};
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

// What element j of the run adds to the (pos, neg) prefix. A weight is read
// only where the code is 3 or 2, so an inert element's weight never counts.
template <bool W>
__device__ __forceinline__ typename Acc<W>::V step(const Run& run, int j, const float* sw) {
  if constexpr (W) {
    const double w = (double)sw[slot(run.t0 + j)];
    return make_double2(run.pos >> j & 1u ? w : 0.0, run.neg >> j & 1u ? w : 0.0);
  } else {
    return make_int2(run.pos >> j & 1u, run.neg >> j & 1u);
  }
}

// The run's (pos, neg) sums.
template <bool W>
__device__ __forceinline__ typename Acc<W>::V run_total(const Run& run, const float* sw) {
  if constexpr (W) {
    double2 s = make_double2(0.0, 0.0);
#pragma unroll
    for (int j = 0; j < kItems; ++j) s = SumOp::apply(s, step<W>(run, j, sw));
    return s;
  } else {
    return make_int2(__popc(run.pos), __popc(run.neg));
  }
}

// The chord and AP term of a group start at prefix c whose previous group
// start had prefix m: f32 terms of exact counts, or f64 terms of weight sums.
__device__ __forceinline__ void add_terms(int2 c, int2 m, float off_p, float off_n, double2& acc) {
  const float tp = (float)c.x, fp = (float)c.y, mt = (float)m.x, mf = (float)m.y;
  const float chord = 0.5f * (tp + mt) * (fp - mf);
  const float prec = (tp + off_p) / fmaxf(tp + fp + off_p + off_n, 1.0f);
  acc.x += (double)chord;
  acc.y += (double)((tp - mt) * prec);
}

__device__ __forceinline__ void add_terms(double2 c, double2 m, float off_p, float off_n, double2& acc) {
  const double op = off_p, on = off_n;
  acc.x += 0.5 * (c.x + m.x) * (c.y - m.y);
  acc.y += (c.x - m.x) * ((c.x + op) / fmax(c.x + c.y + op + on, 1e-30));
}

// (a) per tile of row row0 + blockIdx.y: its class sums and the tile-local
// exclusive prefix at its last group start, -1 if it has none.
template <bool W>
__global__ void __launch_bounds__(kThreads)
    tile_summary_kernel(Stream in, long long n, long long row0, Summary<typename Acc<W>::V>* summary) {
  using V = typename Acc<W>::V;
  __shared__ int32_t sk[kPadded];
  __shared__ uint8_t sc[kPadded];
  __shared__ float sw[W ? kPadded : 1];
  __shared__ V s_warp[kThreads / 32];
  const long long row = row0 + blockIdx.y;
  const Run run = load_run<W>(in.row(row, n), n, sk, sc, sw);
  V total;
  const V ex = block_exclusive_scan<SumOp, kThreads>(run_total<W>(run, sw), splat<V>(0), s_warp, &total);
  // this thread's last group start
  V c = ex;
  V last = splat<V>(-1);
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    if (run.first >> j & 1u) last = c;
    c = SumOp::apply(c, step<W>(run, j, sw));
  }
  V last_max;
  block_exclusive_scan<MaxOp, kThreads>(last, splat<V>(-1), s_warp, &last_max);
  if (threadIdx.x == 0) summary[row * gridDim.x + blockIdx.x] = {total, last_max};
}

// (b) one block per row (row0 + blockIdx.x): each tile's carry, and the
// row's totals = (pos, neg, the prefix at the row's last group start).
template <bool W>
__global__ void __launch_bounds__(kScanThreads)
    tile_scan_kernel(const Summary<typename Acc<W>::V>* summary, int num_tiles, long long row0,
                     Carry<typename Acc<W>::V>* carry, typename Acc<W>::T* totals) {
  using V = typename Acc<W>::V;
  __shared__ V s_warp[kScanThreads / 32];
  const long long row = row0 + blockIdx.x;
  summary += row * num_tiles;
  carry += row * num_tiles;
  totals += 4 * row;
  const V zero = splat<V>(0);
  const int per = (num_tiles + kScanThreads - 1) / kScanThreads;
  const int lo = min(num_tiles, (int)threadIdx.x * per);
  const int hi = min(num_tiles, lo + per);
  V own = zero;
  for (int t = lo; t < hi; ++t) own = SumOp::apply(own, summary[t].tot);
  V sum_total;
  const V base0 = block_exclusive_scan<SumOp, kScanThreads>(own, zero, s_warp, &sum_total);
  V base = base0;
  V latest = zero;
  for (int t = lo; t < hi; ++t) {
    const Summary<V> s = summary[t];
    if (s.last.x >= 0) latest = MaxOp::apply(latest, SumOp::apply(base, s.last));
    base = SumOp::apply(base, s.tot);
  }
  V latest_total;
  const V incoming = block_exclusive_scan<MaxOp, kScanThreads>(latest, zero, s_warp, &latest_total);
  base = base0;
  V m = incoming;
  for (int t = lo; t < hi; ++t) {
    const Summary<V> s = summary[t];
    carry[t] = {base, m};
    if (s.last.x >= 0) m = MaxOp::apply(m, SumOp::apply(base, s.last));
    base = SumOp::apply(base, s.tot);
  }
  if (threadIdx.x == 0) {
    totals[0] = sum_total.x;
    totals[1] = sum_total.y;
    totals[2] = latest_total.x;
    totals[3] = latest_total.y;
  }
}

// (c) per tile of row row0 + blockIdx.y: every group start closes the
// previous group; the tile's sum of chords and AP terms goes to its partial.
template <bool W>
__global__ void __launch_bounds__(kThreads)
    tile_emit_kernel(Stream in, long long n, long long row0, const Carry<typename Acc<W>::V>* carry, float off_p,
                     float off_n, double2* partial) {
  using V = typename Acc<W>::V;
  __shared__ int32_t sk[kPadded];
  __shared__ uint8_t sc[kPadded];
  __shared__ float sw[W ? kPadded : 1];
  __shared__ V s_warp[kThreads / 32];
  __shared__ double2 s_sum[kThreads / 32];
  const long long row = row0 + blockIdx.y;
  const long long tile = row * gridDim.x + blockIdx.x;
  const Run run = load_run<W>(in.row(row, n), n, sk, sc, sw);
  const Carry<V> tc = carry[tile];
  const V zero = splat<V>(0);
  V total;
  const V ex = SumOp::apply(
      block_exclusive_scan<SumOp, kThreads>(run_total<W>(run, sw), zero, s_warp, &total), tc.base);
  V c = ex;
  V last = zero;
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    if (run.first >> j & 1u) last = c;
    c = SumOp::apply(c, step<W>(run, j, sw));
  }
  const V in_tile = block_exclusive_scan<MaxOp, kThreads>(last, zero, s_warp, &total);
  V m = MaxOp::apply(in_tile, tc.m);
  c = ex;
  double2 acc = make_double2(0.0, 0.0);
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    if (run.first >> j & 1u) {
      add_terms(c, m, off_p, off_n, acc);
      m = c;
    }
    c = SumOp::apply(c, step<W>(run, j, sw));
  }
  const double2 r = block_sum<kThreads>(acc, s_sum);
  if (threadIdx.x == 0) partial[tile] = r;
}

// (d) one block per row (row0 + blockIdx.x): fixed-order sum of the row's
// partials plus the closing term of its last group; out row = [area,
// ap_sum, pos, neg].
template <bool W>
__global__ void __launch_bounds__(kThreads)
    finalize_kernel(const double2* partial, int num_tiles, long long row0, const typename Acc<W>::T* totals,
                    float off_p, float off_n, float* out) {
  using V = typename Acc<W>::V;
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
    const V tot = {totals[0], totals[1]};
    const V last = {totals[2], totals[3]};
    double2 close = make_double2(0.0, 0.0);
    add_terms(tot, last, off_p, off_n, close);
    out[0] = (float)(r.x + close.x);
    out[1] = (float)(r.y + close.y);
    out[2] = (float)tot.x;
    out[3] = (float)tot.y;
  }
}

int num_tiles_for(long long n) { return n > 0 ? (int)((n + kTile - 1) / kTile) : 1; }

template <bool W>
int launch(Stream in, long long rows, long long n, float off_p, float off_n, void* scratch, void* partial,
           void* out, cudaStream_t stream) {
  using V = typename Acc<W>::V;
  using T = typename Acc<W>::T;
  const int tiles = num_tiles_for(n);
  Summary<V>* summary = static_cast<Summary<V>*>(scratch);
  Carry<V>* carry = reinterpret_cast<Carry<V>*>(summary + rows * tiles);
  T* totals = reinterpret_cast<T*>(carry + rows * tiles);
  double2* parts = static_cast<double2*>(partial);
  float* result = static_cast<float*>(out);
  cudaError_t err;
  for (long long row0 = 0; row0 < rows; row0 += kMaxGridY) {
    const int group = (int)(rows - row0 < kMaxGridY ? rows - row0 : kMaxGridY);
    const dim3 grid(tiles, group);
    tile_summary_kernel<W><<<grid, kThreads, 0, stream>>>(in, n, row0, summary);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    tile_scan_kernel<W><<<group, kScanThreads, 0, stream>>>(summary, tiles, row0, carry, totals);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    tile_emit_kernel<W><<<grid, kThreads, 0, stream>>>(in, n, row0, carry, off_p, off_n, parts);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    finalize_kernel<W><<<group, kThreads, 0, stream>>>(parts, tiles, row0, totals, off_p, off_n, result);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  return 0;
}

// this library links its own CUDA runtime, whose current device is not the
// caller's: select the tensors' device before launching
template <bool W>
int run_on(int device, Stream in, long long rows, long long n, float off_p, float off_n, void* scratch,
           void* partial, void* out, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  return launch<W>(in, rows, n, off_p, off_n, scratch, partial, out, static_cast<cudaStream_t>(stream));
}

}  // namespace

extern "C" {

// Elements per tile; the caller sizes the buffers from it: scratch holds
// rows * (8 * tiles + 4) int32 (float64 for the weighted entries), partial
// rows * 2 * tiles float64, with tiles = max(1, ceil(n / tile_elems)).
int tie_scan_tile_elems(void) { return kTile; }

// key: (rows, n) 4-byte keys, payload: (rows, n) f32, both row-major and
// sorted by key within each row; out: (rows, 4) f32; all on CUDA device
// `device`. Launches on `stream`; returns the first CUDA error (0 when every
// launch was accepted).
int tie_scan_rows(int device, const void* key, const void* payload, long long rows, long long n, float off_p,
                  float off_n, void* scratch, void* partial, void* out, void* stream) {
  const Stream in = {static_cast<const int32_t*>(key), static_cast<const float*>(payload), nullptr};
  return run_on<false>(device, in, rows, n, off_p, off_n, scratch, partial, out, stream);
}

// One stream of n elements: the batch of one row.
int tie_scan(int device, const void* key, const void* payload, long long n, float off_p, float off_n,
             void* scratch, void* partial, void* out, void* stream) {
  return tie_scan_rows(device, key, payload, 1, n, off_p, off_n, scratch, partial, out, stream);
}

// The weighted variant: weight is a (rows, n) f32 array co-sorted with the
// keys, non-negative; out row = [area, ap_sum, w_pos, w_neg].
int tie_scan_rows_w(int device, const void* key, const void* payload, const void* weight, long long rows,
                    long long n, float off_p, float off_n, void* scratch, void* partial, void* out, void* stream) {
  const Stream in = {static_cast<const int32_t*>(key), static_cast<const float*>(payload),
                     static_cast<const float*>(weight)};
  return run_on<true>(device, in, rows, n, off_p, off_n, scratch, partial, out, stream);
}

int tie_scan_w(int device, const void* key, const void* payload, const void* weight, long long n, float off_p,
               float off_n, void* scratch, void* partial, void* out, void* stream) {
  return tie_scan_rows_w(device, key, payload, weight, 1, n, off_p, off_n, scratch, partial, out, stream);
}

}  // extern "C"

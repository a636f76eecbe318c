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
// Offsets into the batch are 64-bit, so rows * n may exceed 2^31.
//
// Two designs, one per accumulator. Both work on tiles of 256 threads x 16
// elements, with no float atomics, so a result repeats bit for bit and a
// row of a batch equals the one-stream launch of that row.
//
// Unweighted (tie_scan, tie_scan_rows): i32 counts per row (n < 2^31: an f32
// cumulant stops moving at 2^24), f32 terms, floor 1. Reduce-then-scan in
// four launches per group of up to 65535 rows (gridDim.y):
//   (a) tile_summary_kernel: per-tile counts and the tile-local prefix at
//       the tile's last group start;
//   (b) tile_scan_kernel, one block per row: each tile's carry;
//   (c) tile_emit_kernel: rebuilds every element's prefix, one (area, ap)
//       partial per tile;
//   (d) finalize_kernel, one block per row: fixed-order sum of the partials
//       plus the closing term.
// It reads the stream twice (a and c), so at (1000, 50000) it takes 3.4x its
// byte bound, and at 1M its launch latency sets its time.
//
// Weighted (tie_scan_w, tie_scan_rows_w): one f32 weight per element, pos = w
// where code 3 and neg = w where code 2. Prefix sums, tile sums and terms are
// f64 (the Pallas kernel pins its f32 prefix products to precision=HIGHEST
// because bf16-rounded operands cost about 1e-3; f64 keeps the sums far below
// one f32 ulp), floor 1e-30 (weighted totals may sit below 1). What bounds
// it on an H100 SXM: it reads 12 bytes per element (key, payload, weight),
// so 0.164 ms at 45,840,617 elements and 0.179 ms at (1000, 50000) at
// 3.35 TB/s; its f64 work (about 15 DADD-class operations per element and a
// reciprocal, about 0.05 ms at 45.8M) stays under that if it overlaps the
// loads. So it is one launch (plus one memset of its scratch) that reads
// each element from device memory once:
//   * a flattened grid of (row, tile), one 4096-element tile per block; a
//     block takes its tile from an atomic ticket, so a tile it waits on is
//     held by a block already running;
//   * the tile (48 KB) is copied to shared memory by TMA bulk copies (its
//     16-byte aligned body) and per-thread cp.async (up to 3 elements at
//     each end, where a row starts misaligned), and each thread takes its
//     16 elements from there once per pass; four blocks fit on an SM, so one
//     block's look-back overlaps the others' loads;
//   * each tile publishes its aggregate (f64 sums and the tile-local prefix
//     at its last group start), then one warp looks back over its row's
//     predecessors, 64 per read, until it meets one with its inclusive
//     carry, and folds the aggregates after it LEFT TO RIGHT onto that
//     carry. f64 + is not associative, so a tree over the window would make
//     the bits depend on the schedule; the left fold gives exactly
//     inc(t) = combine(inc(t-1), S_t) whatever the window, the order in
//     which the Pallas kernel carries its scalars across its grid;
//   * the tile then emits from its exclusive carry and publishes one
//     (area, ap) partial; the row's last tile sums the row's partials in
//     tile order and closes the last group.
// Nothing a tile publishes needs a flag or a fence: the launch fills the
// scratch with 0xff bytes, each published double is written once by a
// single-copy-atomic store, and a reader takes it once it no longer reads
// that pattern (a NaN no arithmetic produces). Flags written with release
// semantics would cost each tile two fences, and an arrival counter a fence
// and an atomic, each a round trip to L2.
// What holds it on one long row: the carry is a chain of one f64 addition
// per tile (11,192 at 45.8M) that only one lane can walk, on an FP64 pipe
// the other blocks keep busy; a tile folds the ~100 aggregates between it
// and the nearest inclusive carry, so the chain, not the bytes, sets the
// single stream's time (0.38 ms, 2.3x the bound). A row of a few tiles folds
// a handful and runs at 1.9x the bound.
// Reassociated prefix sums may dip by an f64 ulp at a thread or tile edge;
// the forward fill is a max, which repairs that as JAX's cummax does. The
// "no group start" sentinel is -1 and the fill's identity 0: both lie below
// every real prefix because weights are non-negative, which the metrics
// check at update.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kItems = 16;
constexpr int kTile = kThreads * kItems;          // elements per tile
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;

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
    o.x = __shfl_up_sync(kFull, inc.x, d);
    o.y = __shfl_up_sync(kFull, inc.y, d);
    if (lane >= d) inc = Op::apply(inc, o);
  }
  if (lane == 31) s_warp[warp] = inc;
  __syncthreads();
  if (warp == 0) {
    V w = lane < kW ? s_warp[lane] : identity;
#pragma unroll
    for (int d = 1; d < kW; d <<= 1) {
      V o;
      o.x = __shfl_up_sync(kFull, w.x, d);
      o.y = __shfl_up_sync(kFull, w.y, d);
      if (lane >= d) w = Op::apply(w, o);
    }
    if (lane < kW) s_warp[lane] = w;
  }
  __syncthreads();
  V ex;
  ex.x = __shfl_up_sync(kFull, inc.x, 1);
  ex.y = __shfl_up_sync(kFull, inc.y, 1);
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
    v.x += __shfl_down_sync(kFull, v.x, d);
    v.y += __shfl_down_sync(kFull, v.y, d);
  }
  if (lane == 0) s_warp[warp] = v;
  __syncthreads();
  double2 r = make_double2(0.0, 0.0);
  if (warp == 0) {
    r = lane < kW ? s_warp[lane] : make_double2(0.0, 0.0);
#pragma unroll
    for (int d = 16; d > 0; d >>= 1) {
      r.x += __shfl_down_sync(kFull, r.x, d);
      r.y += __shfl_down_sync(kFull, r.y, d);
    }
  }
  return r;  // valid in thread 0
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

int tiles_for(long long n) { return n > 0 ? (int)((n + kTile - 1) / kTile) : 1; }

// ---- unweighted: reduce-then-scan in four launches -------------------------

constexpr int kPadded = kTile + kTile / kItems;   // one pad slot per thread run
constexpr int kScanThreads = 1024;
constexpr long long kMaxGridY = 65535;  // rows per launch group (gridDim.y)

// shared-memory slot of tile element e: a pad after every 16 elements puts
// the runs of neighbouring threads in different banks
__device__ __forceinline__ int slot(int e) { return e + e / kItems; }

// tile t's counts and the tile-local prefix at its last group start (-1 if
// it has none)
struct Summary {
  int2 tot, last;
};

// the counts before tile t and the prefix at the latest group start before
// it (0 if none)
struct Carry {
  int2 base, m;
};

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
    if (i < n) {
      k = in.key[i];
      const float p = in.payload[i];
      code = p == 3.0f ? 3 : (p == 2.0f ? 2 : 0);
    }
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

__device__ __forceinline__ int2 step(const Run& run, int j) {
  return make_int2(run.pos >> j & 1u, run.neg >> j & 1u);
}

// (a) per tile of row row0 + blockIdx.y: its counts and the tile-local
// exclusive prefix at its last group start, -1 if it has none.
__global__ void __launch_bounds__(kThreads)
    tile_summary_kernel(Stream in, long long n, long long row0, Summary* summary) {
  __shared__ int32_t sk[kPadded];
  __shared__ uint8_t sc[kPadded];
  __shared__ int2 s_warp[kWarps];
  const long long row = row0 + blockIdx.y;
  const Run run = load_run(in.row(row, n), n, sk, sc);
  int2 total;
  const int2 own = make_int2(__popc(run.pos), __popc(run.neg));
  const int2 ex = block_exclusive_scan<SumOp, kThreads>(own, make_int2(0, 0), s_warp, &total);
  // this thread's last group start
  int2 c = ex;
  int2 last = make_int2(-1, -1);
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    if (run.first >> j & 1u) last = c;
    c = SumOp::apply(c, step(run, j));
  }
  int2 last_max;
  block_exclusive_scan<MaxOp, kThreads>(last, make_int2(-1, -1), s_warp, &last_max);
  if (threadIdx.x == 0) summary[row * gridDim.x + blockIdx.x] = {total, last_max};
}

// (b) one block per row (row0 + blockIdx.x): each tile's carry, and the
// row's totals = (pos, neg, the prefix at the row's last group start).
__global__ void __launch_bounds__(kScanThreads)
    tile_scan_kernel(const Summary* summary, int num_tiles, long long row0, Carry* carry, int* totals) {
  __shared__ int2 s_warp[kScanThreads / 32];
  const long long row = row0 + blockIdx.x;
  summary += row * num_tiles;
  carry += row * num_tiles;
  totals += 4 * row;
  const int2 zero = make_int2(0, 0);
  const int per = (num_tiles + kScanThreads - 1) / kScanThreads;
  const int lo = min(num_tiles, (int)threadIdx.x * per);
  const int hi = min(num_tiles, lo + per);
  int2 own = zero;
  for (int t = lo; t < hi; ++t) own = SumOp::apply(own, summary[t].tot);
  int2 sum_total;
  const int2 base0 = block_exclusive_scan<SumOp, kScanThreads>(own, zero, s_warp, &sum_total);
  int2 base = base0;
  int2 latest = zero;
  for (int t = lo; t < hi; ++t) {
    const Summary s = summary[t];
    if (s.last.x >= 0) latest = MaxOp::apply(latest, SumOp::apply(base, s.last));
    base = SumOp::apply(base, s.tot);
  }
  int2 latest_total;
  const int2 incoming = block_exclusive_scan<MaxOp, kScanThreads>(latest, zero, s_warp, &latest_total);
  base = base0;
  int2 m = incoming;
  for (int t = lo; t < hi; ++t) {
    const Summary s = summary[t];
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
__global__ void __launch_bounds__(kThreads)
    tile_emit_kernel(Stream in, long long n, long long row0, const Carry* carry, float off_p, float off_n,
                     double2* partial) {
  __shared__ int32_t sk[kPadded];
  __shared__ uint8_t sc[kPadded];
  __shared__ int2 s_warp[kWarps];
  __shared__ double2 s_sum[kWarps];
  const long long row = row0 + blockIdx.y;
  const long long tile = row * gridDim.x + blockIdx.x;
  const Run run = load_run(in.row(row, n), n, sk, sc);
  const Carry tc = carry[tile];
  const int2 zero = make_int2(0, 0);
  int2 total;
  const int2 own = make_int2(__popc(run.pos), __popc(run.neg));
  const int2 ex = SumOp::apply(block_exclusive_scan<SumOp, kThreads>(own, zero, s_warp, &total), tc.base);
  int2 c = ex;
  int2 last = zero;
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    if (run.first >> j & 1u) last = c;
    c = SumOp::apply(c, step(run, j));
  }
  const int2 in_tile = block_exclusive_scan<MaxOp, kThreads>(last, zero, s_warp, &total);
  int2 m = MaxOp::apply(in_tile, tc.m);
  c = ex;
  double2 acc = make_double2(0.0, 0.0);
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    if (run.first >> j & 1u) {
      add_terms(c, m, off_p, off_n, acc);
      m = c;
    }
    c = SumOp::apply(c, step(run, j));
  }
  const double2 r = block_sum<kThreads>(acc, s_sum);
  if (threadIdx.x == 0) partial[tile] = r;
}

// (d) one block per row (row0 + blockIdx.x): fixed-order sum of the row's
// partials plus the closing term of its last group; out row = [area,
// ap_sum, pos, neg].
__global__ void __launch_bounds__(kThreads)
    finalize_kernel(const double2* partial, int num_tiles, long long row0, const int* totals, float off_p,
                    float off_n, float* out) {
  __shared__ double2 s_sum[kWarps];
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
    const int2 tot = {totals[0], totals[1]};
    const int2 last = {totals[2], totals[3]};
    double2 close = make_double2(0.0, 0.0);
    add_terms(tot, last, off_p, off_n, close);
    out[0] = (float)(r.x + close.x);
    out[1] = (float)(r.y + close.y);
    out[2] = (float)tot.x;
    out[3] = (float)tot.y;
  }
}

int launch(Stream in, long long rows, long long n, float off_p, float off_n, void* scratch, void* partial,
           void* out, cudaStream_t stream) {
  const int tiles = tiles_for(n);
  Summary* summary = static_cast<Summary*>(scratch);
  Carry* carry = reinterpret_cast<Carry*>(summary + rows * tiles);
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

// ---- weighted: one pass, ordered decoupled look-back -----------------------

// words per staged array: the tile plus room to shift a misaligned row's
// body onto a 16-byte boundary (kWords * 4 is a multiple of 16)
constexpr int kWords = kTile + 4;
constexpr int kWSmemBytes = 3 * kWords * 4;  // key, payload, weight: 49,200 B
constexpr int kWBlocksPerSM = 4;
// predecessors a look-back may fold at once, their aggregates kept where
// the tile's keys were (16 KB)
constexpr int kWindow = 512;
// threads that copy a tile's unaligned ends (3 + 3 per array) with cp.async
constexpr int kCopyThread0 = 32, kCopyThreads = 18;
// Published values start as this bit pattern (the launch fills its scratch
// with 0xff bytes, a NaN no arithmetic produces) and are written once, each
// double by one single-copy-atomic store, so a reader takes a value as soon
// as it no longer sees the pattern: no flag, and so no fence, is needed.
constexpr long long kUnset = -1;

// A tile's (or a thread run's) summary: its f64 (pos, neg) sums and the
// local prefix at its last group start (-1 if it has none).
struct WSummary {
  double2 tot, last;
};

// A carry: the sums before (exclusive) or through (inclusive) a tile, and
// the prefix at the latest group start so far (0 if none).
struct WCarry {
  double2 base, m;
};

// One tile's published record: its aggregate, its inclusive carry and its
// (area, ap) partial, each published as soon as it is known.
struct WTileState {
  WSummary agg;
  WCarry inc;
  double2 partial;
};

// The fold step. Sequential over tiles, it is the Pallas kernel's carry;
// the max repairs an ulp dip as the fill does.
__device__ __forceinline__ WCarry combine(const WCarry& c, const WSummary& s) {
  WCarry r;
  r.base = SumOp::apply(c.base, s.tot);
  r.m = s.last.x >= 0 ? MaxOp::apply(c.m, SumOp::apply(c.base, s.last)) : c.m;
  return r;
}

// The same step between two runs within a tile: the run a then the run b.
__device__ __forceinline__ WSummary join(const WSummary& a, const WSummary& b) {
  return {SumOp::apply(a.tot, b.tot), b.last.x >= 0 ? MaxOp::apply(a.last, SumOp::apply(a.tot, b.last)) : a.last};
}

__device__ __forceinline__ double2 shfl(double2 v, int src) {
  return make_double2(__shfl_sync(kFull, v.x, src), __shfl_sync(kFull, v.y, src));
}

__device__ __forceinline__ double2 shfl_up(double2 v, int d) {
  return make_double2(__shfl_up_sync(kFull, v.x, d), __shfl_up_sync(kFull, v.y, d));
}

__device__ __forceinline__ double2 shfl_xor(double2 v, int d) {
  return make_double2(__shfl_xor_sync(kFull, v.x, d), __shfl_xor_sync(kFull, v.y, d));
}

// Exclusive scan of the threads' run summaries under join, in thread order
// (a fixed tree, so the same bits every run); writes the tile's summary.
__device__ WSummary block_scan_runs(WSummary v, WSummary* s_warp, WSummary* tile) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const WSummary identity = {make_double2(0.0, 0.0), make_double2(-1.0, -1.0)};
  WSummary inc = v;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const WSummary o = {shfl_up(inc.tot, d), shfl_up(inc.last, d)};
    if (lane >= d) inc = join(o, inc);
  }
  if (lane == 31) s_warp[warp] = inc;
  __syncthreads();
  if (warp == 0) {
    WSummary w = lane < kWarps ? s_warp[lane] : identity;
#pragma unroll
    for (int d = 1; d < kWarps; d <<= 1) {
      const WSummary o = {shfl_up(w.tot, d), shfl_up(w.last, d)};
      if (lane >= d) w = join(o, w);
    }
    if (lane < kWarps) s_warp[lane] = w;
  }
  __syncthreads();
  WSummary ex = {shfl_up(inc.tot, 1), shfl_up(inc.last, 1)};
  if (lane == 0) ex = identity;
  if (warp > 0) ex = join(s_warp[warp - 1], ex);
  *tile = s_warp[kWarps - 1];
  __syncthreads();
  return ex;
}

// 1 / d: the hardware's approximate reciprocal refined by one Newton step,
// far below the f32 ulp the result is rounded to, for a fraction of a
// correctly rounded divide. d >= 1e-30 is normal.
__device__ __forceinline__ double reciprocal(double d) {
  double r;
  asm("rcp.approx.ftz.f64 %0, %1;" : "=d"(r) : "d"(d));
  return fma(r, fma(-d, r, 1.0), r);
}

__device__ __forceinline__ bool is_set(double2 v) {
  return __double_as_longlong(v.x) != kUnset && __double_as_longlong(v.y) != kUnset;
}

// Loads and stores of published values: strong (volatile), so a spin sees a
// value another block wrote; each double is single-copy atomic.
__device__ __forceinline__ double2 load_published(const double2* p) {
  double2 v;
  asm volatile("ld.volatile.global.v2.f64 {%0, %1}, [%2];" : "=d"(v.x), "=d"(v.y) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void publish(double2* p, double2 v) {
  asm volatile("st.volatile.global.v2.f64 [%0], {%1, %2};" ::"l"(p), "d"(v.x), "d"(v.y) : "memory");
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(smem_addr(bar)) : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_addr(bar)), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar) {
  unsigned done;
  do {
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], 0;\n selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar))
        : "memory");
  } while (!done);
}

// TMA 1-D bulk copy of `bytes` (a multiple of 16, both ends 16-byte aligned)
// into shared memory, completing on `bar`.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, unsigned bytes, uint64_t* bar) {
  asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(bytes), "r"(smem_addr(bar))
               : "memory");
}

__device__ __forceinline__ void copy4_async(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(smem_addr(dst)), "l"(src) : "memory");
}

// How one array of a tile is staged: element i lands at word pad + i of its
// buffer, so the body [head, head + body) is 16-byte aligned at both ends and
// goes by TMA; the head and tail (up to 3 elements each, where a row starts
// misaligned) go by cp.async.
struct Part {
  const uint32_t* src;
  int pad, head, body;
  __device__ Part(const void* p, int count) : src(static_cast<const uint32_t*>(p)) {
    pad = (int)(reinterpret_cast<uintptr_t>(p) >> 2 & 3);
    head = min((4 - pad) & 3, count);
    body = (count - head) & ~3;
  }
};

// This thread's 16 words [16 tid, 16 tid + 16) of a staged array. Aligned:
// four 16-byte reads, rotated so that the 8 threads of a quarter-warp hit 8
// different bank groups, then rotated back. Misaligned (a row that starts
// off a 16-byte boundary): word by word.
__device__ __forceinline__ void read_run(const uint32_t* buf, int pad, uint32_t v[kItems]) {
  const int tid = threadIdx.x;
  if (pad == 0) {
    const uint4* src = reinterpret_cast<const uint4*>(buf) + 4 * tid;
    const int rot = (tid >> 1) & 3;
    uint4 x[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) x[j] = src[(j + rot) & 3];
    if (rot & 1) {
      const uint4 y = x[3];
      x[3] = x[2];
      x[2] = x[1];
      x[1] = x[0];
      x[0] = y;
    }
    if (rot & 2) {
      uint4 y = x[0];
      x[0] = x[2];
      x[2] = y;
      y = x[1];
      x[1] = x[3];
      x[3] = y;
    }
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      v[4 * q] = x[q].x;
      v[4 * q + 1] = x[q].y;
      v[4 * q + 2] = x[q].z;
      v[4 * q + 3] = x[q].w;
    }
  } else {
#pragma unroll
    for (int j = 0; j < kItems; ++j) v[j] = buf[pad + kItems * tid + j];
  }
}

// The element's (pos, neg) weights: a weight is read only where the code is
// 3 or 2, so an inert element's weight, even NaN, never counts.
__device__ __forceinline__ double2 wstep(unsigned pos, unsigned neg, int j, float w) {
  const double x = (double)w;
  return make_double2(pos >> j & 1u ? x : 0.0, neg >> j & 1u ? x : 0.0);
}

// Warp 0 of tile t > 0 of a row: walk back over the row's predecessors, 64
// per read, nearest first, until one has its inclusive carry and every tile
// after it its aggregate; then fold those aggregates in order onto that
// carry. A predecessor's ticket is older, so its block is running. Returns
// the exclusive carry of tile t (the same in every lane).
__device__ WCarry look_back(WTileState* state, long long t, WSummary* s_window) {
  const int lane = threadIdx.x & 31;
  const double2 zero = make_double2(0.0, 0.0);
  WCarry c = {zero, zero};
  int k = -1;  // distance of the nearest inclusive predecessor (0 is t - 1)
  unsigned pause = 16, spins = 0;
  for (int q = 0; k < 0;) {
    // two blocks of 32 predecessors per read: distances 32 q + lane and
    // 32 (q + 1) + lane; before the row's first tile is the identity, as
    // good as inclusive
    bool has_inc[2], has_agg[2];
    WCarry inc[2];
    WSummary agg[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const long long p = t - 1 - (32 * (q + h) + lane);
      has_inc[h] = p < 0;
      has_agg[h] = false;
      inc[h] = {zero, zero};
      agg[h] = {zero, zero};
      if (p >= 0 && q + h < kWindow / 32) {
        inc[h] = {load_published(&state[p].inc.base), load_published(&state[p].inc.m)};
        agg[h] = {load_published(&state[p].agg.tot), load_published(&state[p].agg.last)};
        has_inc[h] = is_set(inc[h].base) && is_set(inc[h].m);
        has_agg[h] = is_set(agg[h].tot) && is_set(agg[h].last);
      }
    }
    bool waiting = false;
    const int q0 = q;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (k >= 0 || waiting || q0 + h == kWindow / 32) break;
      const unsigned inclusive = __ballot_sync(kFull, has_inc[h]);
      const unsigned ready = __ballot_sync(kFull, has_inc[h] || has_agg[h]);
      const unsigned below = inclusive ? (1u << (__ffs(inclusive) - 1)) - 1u : kFull;
      if ((ready & below) != below) {
        waiting = true;  // a tile nearer than any inclusive one lacks its aggregate
        break;
      }
      if (inclusive == 0 || lane < __ffs(inclusive) - 1) s_window[32 * (q0 + h) + lane] = agg[h];
      if (inclusive) {
        const int src = __ffs(inclusive) - 1;
        k = 32 * (q0 + h) + src;
        c = {shfl(inc[h].base, src), shfl(inc[h].m, src)};
      } else {
        q = q0 + h + 1;
      }
    }
    if (k >= 0) break;
    if (!waiting) {
      if (q < kWindow / 32) continue;
      q = 0;  // no inclusive carry within the window yet: start over
    }
    __nanosleep(pause);
    if (pause < 128) pause *= 2;
    // over a minute waiting on tiles that take microseconds means one was
    // never scheduled: fail the launch rather than hang the card
    if (++spins == 1u << 26) __trap();
  }
  __syncwarp();
  // the left fold, nearest-last: one lane chains the sums in order (eight
  // read ahead of the chain) and leaves in each window slot the sums before
  // that tile; the max over the group-start candidates is exact, so the
  // lanes take it in any order
  if (lane == 0) {
    double2 base = c.base;
    int d = k - 1;
    for (; d >= 7; d -= 8) {
      double2 tot[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) tot[i] = s_window[d - i].tot;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        s_window[d - i].tot = base;
        base = SumOp::apply(base, tot[i]);
      }
    }
    for (; d >= 0; --d) {
      const double2 tot = s_window[d].tot;
      s_window[d].tot = base;
      base = SumOp::apply(base, tot);
    }
    c.base = base;
  }
  __syncwarp();
  c.base = shfl(c.base, 0);
  double2 m = c.m;
  for (int d = lane; d < k; d += 32) {
    const WSummary s = s_window[d];
    if (s.last.x >= 0) m = MaxOp::apply(m, SumOp::apply(s.tot, s.last));
  }
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) m = MaxOp::apply(m, shfl_xor(m, d));
  c.m = m;
  return c;
}

// One tile per block, taken by ticket in the order the blocks start.
__global__ void __launch_bounds__(kThreads, kWBlocksPerSM)
    tie_scan_w_kernel(Stream in, long long n, long long tiles_per_row, float off_p, float off_n,
                      WTileState* state, unsigned* ticket, float* out) {
  extern __shared__ __align__(128) uint32_t s_words[];  // kWords each: keys, payloads, weights
  __shared__ __align__(8) uint64_t s_bar;
  __shared__ WSummary s_warp[kWarps];
  __shared__ long long s_tile;
  __shared__ WCarry s_carry, s_inc;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const double2 zero = make_double2(0.0, 0.0), none = make_double2(-1.0, -1.0);
  if (tid == 0) {
    s_tile = (unsigned)(atomicAdd(ticket, 1u) + 1u);  // the ticket starts at all ones
    mbar_init(&s_bar);
  }
  __syncthreads();
  const long long g = s_tile;
  const long long row = g / tiles_per_row, t = g - row * tiles_per_row;
  const Stream rin = in.row(row, n);
  const long long first = t * kTile;  // the tile's first element, within its row
  const int count = (int)min((long long)kTile, n - first);  // 0 for the one tile of an empty row
  const Part parts[3] = {Part(rin.key + first, count), Part(rin.payload + first, count),
                         Part(rin.weight + first, count)};

  // ---- stage the tile: TMA for the aligned bodies, cp.async for the ends
  if (tid == 0) {
    mbar_expect_tx(&s_bar, 4u * (parts[0].body + parts[1].body + parts[2].body));
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      const Part& q = parts[a];
      if (q.body > 0) bulk_copy(s_words + a * kWords + q.pad + q.head, q.src + q.head, 4u * q.body, &s_bar);
    }
  } else if (tid >= kCopyThread0 && tid < kCopyThread0 + kCopyThreads) {
    const int a = (tid - kCopyThread0) / 6, k = (tid - kCopyThread0) % 6;
    const Part q = a == 0 ? parts[0] : (a == 1 ? parts[1] : parts[2]);
    const int e = k < 3 ? k : q.head + q.body + (k - 3);
    if (k < 3 ? e < q.head : e < count) copy4_async(s_words + a * kWords + q.pad + e, q.src + e);
  }
  // the key before the tile, for its first element (none at a row's start)
  const int32_t before = first > 0 && tid == 0 ? rin.key[first - 1] : 0;
  asm volatile("cp.async.wait_all;" ::: "memory");
  mbar_wait(&s_bar);
  __syncthreads();

  // ---- this thread's run, elements [16 tid, 16 tid + 16), as bit masks
  unsigned fmask = 0, pmask = 0, nmask = 0;
  uint32_t v[kItems];
  {
    read_run(s_words + kWords, parts[1].pad, v);
#pragma unroll
    for (int j = 0; j < kItems; ++j) {
      const float p = __uint_as_float(v[j]);
      pmask |= (p == 3.0f ? 1u : 0u) << j;
      nmask |= (p == 2.0f ? 1u : 0u) << j;
    }
    read_run(s_words, parts[0].pad, v);
    // the key before this run: the previous thread's last; a warp's first
    // thread reads it from the tile; a row's element 0 starts a group
    int32_t prev = (int32_t)__shfl_up_sync(kFull, v[kItems - 1], 1);
    if (lane == 0 && tid > 0) prev = (int32_t)s_words[parts[0].pad + kItems * tid - 1];
    const bool start = tid == 0 ? first == 0 || (int32_t)v[0] != before : (int32_t)v[0] != prev;
    fmask = start ? 1u : 0u;
#pragma unroll
    for (int j = 1; j < kItems; ++j) fmask |= (v[j] != v[j - 1] ? 1u : 0u) << j;
    // elements past the row's end are inert and start nothing
    const int valid = min(max(count - kItems * tid, 0), kItems);
    const unsigned keep = valid == kItems ? 0xffffu : (1u << valid) - 1u;
    fmask &= keep;
    pmask &= keep;
    nmask &= keep;
  }

  // ---- local reduction: the run's sums and its last group start's prefix,
  // then the scan over the tile's runs. The weights are read from the tile
  // here and again for the emit, which spares their registers in between.
  read_run(s_words + 2 * kWords, parts[2].pad, v);
  WSummary own = {zero, none};
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    if (fmask >> j & 1u) own.last = own.tot;
    own.tot = SumOp::apply(own.tot, wstep(pmask, nmask, j, __uint_as_float(v[j])));
  }
  WSummary agg;
  const WSummary ex = block_scan_runs(own, s_warp, &agg);  // ends in __syncthreads

  // ---- publish the aggregate, look back, publish the inclusive carry; the
  // look-back window lives where the tile's keys were
  WTileState* row_state = state + row * tiles_per_row;
  if (warp == 0) {
    WCarry carry = {zero, zero};
    if (t > 0) {
      if (lane == 0) {
        publish(&row_state[t].agg.tot, agg.tot);
        publish(&row_state[t].agg.last, agg.last);
      }
      carry = look_back(row_state, t, reinterpret_cast<WSummary*>(s_words));
    }
    if (lane == 0) {
      const WCarry inc = combine(carry, agg);
      publish(&row_state[t].inc.base, inc.base);
      publish(&row_state[t].inc.m, inc.m);
      s_carry = carry;
      s_inc = inc;
    }
  }
  __syncthreads();
  const WCarry carry = s_carry;

  // ---- emit from the exclusive carry: every group start closes the
  // previous group. Every element's terms are computed and the starts'
  // kept, so the 16 terms have no branch between them; the chords are
  // summed doubled and halved once (exact).
  double2 c = SumOp::apply(carry.base, ex.tot);
  double2 m = ex.last.x >= 0 ? MaxOp::apply(carry.m, SumOp::apply(carry.base, ex.last)) : carry.m;
  const double op = off_p, opn = (double)off_p + (double)off_n;
  read_run(s_words + 2 * kWords, parts[2].pad, v);
  double2 acc = zero;
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    const bool is_start = fmask >> j & 1u;
    const double rise = is_start ? c.x - m.x : 0.0;
    const double chord = (c.x + m.x) * (c.y - m.y);
    acc.x += is_start ? chord : 0.0;
    acc.y = fma(rise, (c.x + op) * reciprocal(fmax(c.x + c.y + opn, 1e-30)), acc.y);
    m = is_start ? c : m;
    c = SumOp::apply(c, wstep(pmask, nmask, j, __uint_as_float(v[j])));
  }
  double2 part = block_sum<kThreads>(acc, reinterpret_cast<double2*>(s_warp));
  part.x *= 0.5;
  if (tid == 0) publish(&row_state[t].partial, part);
  if (t != tiles_per_row - 1) return;

  // ---- the row's last tile: the row's partials in tile order (each waited
  // for; they come from older tickets), then the closing term
  __syncthreads();
  double2 sum = zero;
  for (long long i = tid; i < tiles_per_row; i += kThreads) {
    double2 v = load_published(&row_state[i].partial);
    while (!is_set(v)) {
      __nanosleep(64);
      v = load_published(&row_state[i].partial);
    }
    sum = SumOp::apply(sum, v);
  }
  const double2 total = block_sum<kThreads>(sum, reinterpret_cast<double2*>(s_warp));
  if (tid == 0) {
    const WCarry inc = s_inc;
    double2 close = zero;
    add_terms(inc.base, inc.m, off_p, off_n, close);
    float* o = out + 4 * row;
    o[0] = (float)(total.x + close.x);
    o[1] = (float)(total.y + close.y);
    o[2] = (float)inc.base.x;
    o[3] = (float)inc.base.y;
  }
}

// Scratch of one weighted launch: the tiles' records, then the ticket; the
// launch fills all of it with 0xff bytes.
struct WLayout {
  long long tiles_per_row, tiles, ticket_off;
  WLayout(long long rows, long long n) {
    tiles_per_row = tiles_for(n);
    tiles = rows * tiles_per_row;
    ticket_off = tiles * (long long)sizeof(WTileState);
  }
  long long bytes() const { return ticket_off + (long long)sizeof(unsigned); }
};

int launch_w(Stream in, long long rows, long long n, float off_p, float off_n, void* scratch, void* out,
             cudaStream_t stream) {
  const WLayout layout(rows, n);
  if (layout.tiles > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  char* base = static_cast<char*>(scratch);
  cudaError_t err = cudaMemsetAsync(scratch, 0xff, layout.bytes(), stream);
  if (err != cudaSuccess) return (int)err;
  if ((err = cudaFuncSetAttribute(tie_scan_w_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  kWSmemBytes)) != cudaSuccess ||
      (err = cudaFuncSetAttribute(tie_scan_w_kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                                  cudaSharedmemCarveoutMaxShared)) != cudaSuccess)
    return (int)err;
  tie_scan_w_kernel<<<(unsigned)layout.tiles, kThreads, kWSmemBytes, stream>>>(
      in, n, layout.tiles_per_row, off_p, off_n, reinterpret_cast<WTileState*>(base),
      reinterpret_cast<unsigned*>(base + layout.ticket_off), static_cast<float*>(out));
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Elements per tile; the caller sizes the unweighted buffers from it:
// scratch holds rows * (8 * tiles + 4) int32, partial rows * 2 * tiles
// float64, with tiles = max(1, ceil(n / tile_elems)).
int tie_scan_tile_elems(void) { return kTile; }

// Bytes of scratch one weighted launch over (rows, n) takes.
long long tie_scan_w_scratch_bytes(long long rows, long long n) { return WLayout(rows, n).bytes(); }

// key: (rows, n) 4-byte keys, payload: (rows, n) f32, both row-major and
// sorted by key within each row; out: (rows, 4) f32; all on CUDA device
// `device`. This library links its own CUDA runtime, whose current device is
// not the caller's, so each entry selects the tensors' device first. Launches
// on `stream`; returns the first CUDA error (0 when every launch was
// accepted).
int tie_scan_rows(int device, const void* key, const void* payload, long long rows, long long n, float off_p,
                  float off_n, void* scratch, void* partial, void* out, void* stream) {
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const Stream in = {static_cast<const int32_t*>(key), static_cast<const float*>(payload), nullptr};
  return launch(in, rows, n, off_p, off_n, scratch, partial, out, static_cast<cudaStream_t>(stream));
}

// One stream of n elements: the batch of one row.
int tie_scan(int device, const void* key, const void* payload, long long n, float off_p, float off_n,
             void* scratch, void* partial, void* out, void* stream) {
  return tie_scan_rows(device, key, payload, 1, n, off_p, off_n, scratch, partial, out, stream);
}

// The weighted variant: weight is a (rows, n) f32 array co-sorted with the
// keys, non-negative; out row = [area, ap_sum, w_pos, w_neg]; scratch holds
// tie_scan_w_scratch_bytes(rows, n) bytes.
int tie_scan_rows_w(int device, const void* key, const void* payload, const void* weight, long long rows,
                    long long n, float off_p, float off_n, void* scratch, void* out, void* stream) {
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const Stream in = {static_cast<const int32_t*>(key), static_cast<const float*>(payload),
                     static_cast<const float*>(weight)};
  return launch_w(in, rows, n, off_p, off_n, scratch, out, static_cast<cudaStream_t>(stream));
}

int tie_scan_w(int device, const void* key, const void* payload, const void* weight, long long n, float off_p,
               float off_n, void* scratch, void* out, void* stream) {
  return tie_scan_rows_w(device, key, payload, weight, 1, n, off_p, off_n, scratch, out, stream);
}

}  // extern "C"

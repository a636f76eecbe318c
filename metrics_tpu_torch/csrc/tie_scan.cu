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
// One design, two accumulators. Every entry is one launch (plus one memset
// of its scratch) that reads each element from device memory once, since a
// stream the size of the paths' (400-550 MB) does not stay in the 50 MB L2:
//   * a flattened grid of (row, tile), one 4096-element tile per block, with
//     no limit on the rows; a block takes its tile from an atomic ticket, so
//     a tile it waits on is held by a block already running;
//   * the tile's arrays are copied to shared memory by TMA bulk copies (each
//     array's 16-byte aligned body) and per-thread cp.async (up to 3 elements
//     at each end, where a row starts misaligned); each thread takes its 16
//     elements from there as bit masks (group starts, code 3, code 2);
//   * each tile publishes its aggregate (its sums and the tile-local prefix
//     at its last group start), then one warp looks back over its row's
//     predecessors, 64 per read, until it meets one with its inclusive
//     carry, folds the aggregates after it onto that carry and publishes its
//     own inclusive carry;
//   * the tile then emits from its exclusive carry: each thread sums its
//     terms in f64 in element order, the block in a fixed tree, into one
//     (area, ap) partial; the row's last tile sums the row's partials with a
//     fixed stride and tree and closes the last group.
// No float atomics and no sum whose order depends on the schedule, so a
// result repeats bit for bit and a row of a batch equals the one-stream
// launch of that row.
// Nothing a tile publishes needs a flag or a fence: the launch fills the
// scratch with 0xff bytes, each published 8-byte word is written once by a
// single-copy-atomic store, and a reader takes it once it no longer reads
// that pattern, which no published word has. Flags written with release
// semantics would cost each tile two fences, and an arrival counter a fence
// and an atomic, each a round trip to L2.
//
// Unweighted (tie_scan, tie_scan_rows): i32 counts per row (n < 2^31: an f32
// cumulant stops moving at 2^24), f32 terms of exact counts, floor 1. What
// bounds it on an H100 SXM: it reads 8 bytes per element, 0.119 ms at
// (1000, 50000) and 0.0024 ms at 1M at 3.35 TB/s; its operations (decode and
// prefix steps, one divide per group start) stay under that. The tile stages
// 32.8 KB (keys, payloads) and five blocks share an SM, 48 registers a
// thread (six would leave 40 and spill, and ran slower), so one block's
// look-back and emit overlap the others' loads. The carry is int32 counts
// and an int32 max, exact and associative, so the look-back joins its window
// by a warp tree in any shape and the counts cannot depend on the schedule:
// no tile walks a serial chain. Each int2 is published as one 8-byte word;
// an aggregate's "no group start" (-1, -1) is published as last + 1 =
// (0, 0), so no published word is all ones. The f32 terms, their f64 sums
// in element order and the fixed trees are those of a reduce-then-scan in
// separate launches, so the bits do not depend on the design either. What
// holds it: a tile holds its block while it waits on its predecessors'
// aggregates, which wait on their loads; on one long row the nearest
// inclusive carry lies ~65 tiles back, two reads. At 1M (245 tiles, one
// wave) the launch latency and those reads set its time.
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
// loads. The tile stages 48 KB and four blocks fit on an SM. f64 + is not
// associative, so a tree over the look-back window would make the bits
// depend on the schedule: the aggregates after the inclusive carry found are
// folded LEFT TO RIGHT onto it, which gives exactly inc(t) = combine(inc(t-1),
// S_t) whatever the window, the order in which the Pallas kernel carries its
// scalars across its grid. What holds it on one long row: that fold is a
// chain of one f64 addition per tile (11,192 at 45.8M) that only one lane
// can walk, on an FP64 pipe the other blocks keep busy; a tile folds the
// ~100 aggregates between it and the nearest inclusive carry, so the chain,
// not the bytes, sets the single stream's time (0.38 ms on an H100 80GB HBM3
// at 700 W, 2.3x the bound). A row of a few tiles folds a handful and runs
// at 1.9x the bound.
// Reassociated prefix sums may dip by an f64 ulp at a thread or tile edge;
// the forward fill is a max, which repairs that as JAX's cummax does. The
// "no group start" sentinel is -1 and the fill's identity 0: both lie below
// every real prefix because weights are non-negative, which the metrics
// check at update.
#include <cuda_runtime.h>
#include <stdint.h>

// Phase marks, empty here: scripts/torch_tie_scan_phases.py builds a copy
// that defines them to record each tile's clock at its phase boundaries and
// how far its look-back went.
#ifndef TIE_SCAN_PHASE
#define TIE_SCAN_PHASE(k)
#define TIE_SCAN_LOOK_BACK(distance, waits)
#endif

namespace {

constexpr int kThreads = 256;
constexpr int kItems = 16;
constexpr int kTile = kThreads * kItems;          // elements per tile
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;
// words per staged array: the tile plus room to shift a misaligned row's
// body onto a 16-byte boundary (kWords * 4 is a multiple of 16)
constexpr int kWords = kTile + 4;
// the first of the threads that copy a tile's unaligned ends (3 + 3 per
// array) with cp.async
constexpr int kCopyThread0 = 32;

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

// A tile's (or a thread run's) summary: its (pos, neg) sums and the local
// prefix at its last group start (-1 if it has none).
template <class V>
struct Summary {
  V tot, last;
};

// A carry: the sums before (exclusive) or through (inclusive) a tile, and
// the prefix at the latest group start so far (0 if none).
template <class V>
struct Carry {
  V base, m;
};

// The step of the carry over one tile. Sequential over a row's tiles, it is
// the Pallas kernel's carry; the max repairs an ulp dip as the fill does.
template <class V>
__device__ __forceinline__ Carry<V> combine(const Carry<V>& c, const Summary<V>& s) {
  return {SumOp::apply(c.base, s.tot), s.last.x >= 0 ? MaxOp::apply(c.m, SumOp::apply(c.base, s.last)) : c.m};
}

// The same step between two runs or tiles: a, then b.
template <class V>
__device__ __forceinline__ Summary<V> join(const Summary<V>& a, const Summary<V>& b) {
  return {SumOp::apply(a.tot, b.tot), b.last.x >= 0 ? MaxOp::apply(a.last, SumOp::apply(a.tot, b.last)) : a.last};
}

__device__ __forceinline__ int2 shfl(int2 v, int src) {
  return make_int2(__shfl_sync(kFull, v.x, src), __shfl_sync(kFull, v.y, src));
}

__device__ __forceinline__ double2 shfl(double2 v, int src) {
  return make_double2(__shfl_sync(kFull, v.x, src), __shfl_sync(kFull, v.y, src));
}

__device__ __forceinline__ int2 shfl_up(int2 v, int d) {
  return make_int2(__shfl_up_sync(kFull, v.x, d), __shfl_up_sync(kFull, v.y, d));
}

__device__ __forceinline__ double2 shfl_up(double2 v, int d) {
  return make_double2(__shfl_up_sync(kFull, v.x, d), __shfl_up_sync(kFull, v.y, d));
}

__device__ __forceinline__ int2 shfl_xor(int2 v, int d) {
  return make_int2(__shfl_xor_sync(kFull, v.x, d), __shfl_xor_sync(kFull, v.y, d));
}

__device__ __forceinline__ double2 shfl_xor(double2 v, int d) {
  return make_double2(__shfl_xor_sync(kFull, v.x, d), __shfl_xor_sync(kFull, v.y, d));
}

// Exclusive scan of the threads' run summaries under join, in thread order
// (a fixed tree, so the same bits every run); writes the tile's summary.
template <class V>
__device__ __forceinline__ Summary<V> block_scan_runs(Summary<V> v, Summary<V> identity, Summary<V>* s_warp,
                                                      Summary<V>* tile) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  Summary<V> inc = v;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const Summary<V> o = {shfl_up(inc.tot, d), shfl_up(inc.last, d)};
    if (lane >= d) inc = join(o, inc);
  }
  if (lane == 31) s_warp[warp] = inc;
  __syncthreads();
  if (warp == 0) {
    Summary<V> w = lane < kWarps ? s_warp[lane] : identity;
#pragma unroll
    for (int d = 1; d < kWarps; d <<= 1) {
      const Summary<V> o = {shfl_up(w.tot, d), shfl_up(w.last, d)};
      if (lane >= d) w = join(o, w);
    }
    if (lane < kWarps) s_warp[lane] = w;
  }
  __syncthreads();
  Summary<V> ex = {shfl_up(inc.tot, 1), shfl_up(inc.last, 1)};
  if (lane == 0) ex = identity;
  if (warp > 0) ex = join(s_warp[warp - 1], ex);
  *tile = s_warp[kWarps - 1];
  __syncthreads();
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

// ---- the one-pass skeleton: ticket, staging, decode, publishing, closing --

// Loads and stores of published values: strong (volatile), so a spin sees a
// value another block wrote; each 8-byte element is single-copy atomic.
__device__ __forceinline__ double2 load_published(const double2* p) {
  double2 v;
  asm volatile("ld.volatile.global.v2.f64 {%0, %1}, [%2];" : "=d"(v.x), "=d"(v.y) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void publish(double2* p, double2 v) {
  asm volatile("st.volatile.global.v2.f64 [%0], {%1, %2};" ::"l"(p), "d"(v.x), "d"(v.y) : "memory");
}

__device__ __forceinline__ ulonglong2 load_published(const ulonglong2* p) {
  ulonglong2 v;
  asm volatile("ld.volatile.global.v2.u64 {%0, %1}, [%2];" : "=l"(v.x), "=l"(v.y) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void publish(ulonglong2* p, ulonglong2 v) {
  asm volatile("st.volatile.global.v2.u64 [%0], {%1, %2};" ::"l"(p), "l"(v.x), "l"(v.y) : "memory");
}

// Published values start as all-ones words (the launch's memset) and are
// written once, so a word is there as soon as it no longer reads so.
constexpr unsigned long long kUnset = ~0ull;

__device__ __forceinline__ bool is_set(double2 v) {
  return (unsigned long long)__double_as_longlong(v.x) != kUnset &&
         (unsigned long long)__double_as_longlong(v.y) != kUnset;
}

__device__ __forceinline__ bool is_set(ulonglong2 v) { return v.x != kUnset && v.y != kUnset; }

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
};

// Array a (0 keys, 1 payloads, 2 weights) of a tile of `count` elements
// from element `first` of stream row s. A select, not an array of parts,
// so that nothing of it lands in local memory.
__device__ __forceinline__ Part part_of(const Stream& s, int a, long long first, int count) {
  Part q;
  q.src = a == 0 ? reinterpret_cast<const uint32_t*>(s.key + first)
                 : reinterpret_cast<const uint32_t*>((a == 1 ? s.payload : s.weight) + first);
  q.pad = (int)(reinterpret_cast<uintptr_t>(q.src) >> 2 & 3);
  q.head = min((4 - q.pad) & 3, count);
  q.body = (count - q.head) & ~3;
  return q;
}

// The tile a block works on.
struct Tile {
  long long row, t;  // its row, and its index within the row
  long long first;   // its first element, within the row
  int count;         // its elements (0 for the one tile of an empty row)
  int32_t before;    // the key before it (read by thread 0; none at a row's start)
  int pad[3];        // where each staged array's element 0 lies in its buffer
};

// Take a tile by ticket, in the order the blocks start, and stage its A
// arrays (keys, payloads and, weighted, weights) in s_words, kWords each:
// TMA for the aligned bodies, cp.async for the ends. Returns with the tile in
// shared memory.
template <int A>
__device__ __forceinline__ Tile stage_tile(const Stream& in, long long n, long long tiles_per_row, unsigned* ticket,
                                           uint32_t* s_words) {
  __shared__ __align__(8) uint64_t s_bar;
  __shared__ long long s_ticket;
  const int tid = threadIdx.x;
  if (tid == 0) {
    s_ticket = (unsigned)(atomicAdd(ticket, 1u) + 1u);  // the ticket starts at all ones
    mbar_init(&s_bar);
  }
  __syncthreads();
  const long long g = s_ticket;
  TIE_SCAN_PHASE(0);
  Tile tile;
  tile.row = g / tiles_per_row;
  tile.t = g - tile.row * tiles_per_row;
  tile.first = tile.t * kTile;
  tile.count = (int)min((long long)kTile, n - tile.first);
  const Stream rin = in.row(tile.row, n);
  unsigned bytes = 0;
#pragma unroll
  for (int a = 0; a < A; ++a) {
    const Part q = part_of(rin, a, tile.first, tile.count);
    tile.pad[a] = q.pad;
    bytes += 4u * q.body;
  }
  if (tid == 0) {
    mbar_expect_tx(&s_bar, bytes);
#pragma unroll
    for (int a = 0; a < A; ++a) {
      const Part q = part_of(rin, a, tile.first, tile.count);
      if (q.body > 0) bulk_copy(s_words + a * kWords + q.pad + q.head, q.src + q.head, 4u * q.body, &s_bar);
    }
  } else if (tid >= kCopyThread0 && tid < kCopyThread0 + 6 * A) {
    const int a = (tid - kCopyThread0) / 6, k = (tid - kCopyThread0) % 6;
    const Part q = part_of(rin, a, tile.first, tile.count);
    const int e = k < 3 ? k : q.head + q.body + (k - 3);
    if (k < 3 ? e < q.head : e < tile.count) copy4_async(s_words + a * kWords + q.pad + e, q.src + e);
  }
  TIE_SCAN_PHASE(1);
  tile.before = tile.first > 0 && tid == 0 ? rin.key[tile.first - 1] : 0;
  asm volatile("cp.async.wait_all;" ::: "memory");
  mbar_wait(&s_bar);
  __syncthreads();
  TIE_SCAN_PHASE(2);
  return tile;
}

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

// One thread's run of kItems consecutive elements, as bit masks: group
// starts, code 3 and code 2.
struct Run {
  unsigned first, pos, neg;
};

// This thread's run, elements [16 tid, 16 tid + 16) of the staged tile. A
// group starts at a row's element 0 and wherever the key differs from the
// one before; elements past the row's end are inert and start nothing.
__device__ __forceinline__ Run decode_run(const uint32_t* s_words, const Tile& tile) {
  const int tid = threadIdx.x, lane = tid & 31;
  Run run = {0u, 0u, 0u};
  uint32_t v[kItems];
  read_run(s_words + kWords, tile.pad[1], v);
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    const float p = __uint_as_float(v[j]);
    run.pos |= (p == 3.0f ? 1u : 0u) << j;
    run.neg |= (p == 2.0f ? 1u : 0u) << j;
  }
  read_run(s_words, tile.pad[0], v);
  // the key before this run: the previous thread's last; a warp's first
  // thread reads it from the tile
  int32_t prev = (int32_t)__shfl_up_sync(kFull, v[kItems - 1], 1);
  if (lane == 0 && tid > 0) prev = (int32_t)s_words[tile.pad[0] + kItems * tid - 1];
  const bool start = tid == 0 ? tile.first == 0 || (int32_t)v[0] != tile.before : (int32_t)v[0] != prev;
  run.first = start ? 1u : 0u;
#pragma unroll
  for (int j = 1; j < kItems; ++j) run.first |= (v[j] != v[j - 1] ? 1u : 0u) << j;
  const int valid = min(max(tile.count - kItems * tid, 0), kItems);
  const unsigned keep = valid == kItems ? 0xffffu : (1u << valid) - 1u;
  run.first &= keep;
  run.pos &= keep;
  run.neg &= keep;
  return run;
}

// The row's last tile: the row's partials summed with a fixed stride and
// tree (each waited for; they come from older tickets), then the closing
// term from the row's inclusive carry; out row = [area, ap_sum, pos, neg].
template <class V>
__device__ __forceinline__ void close_row(const double2* partial, long long tiles_per_row, const Carry<V>& inc,
                                          float off_p, float off_n, double2* s_sum, float* out) {
  __syncthreads();  // s_sum is reused
  double2 sum = make_double2(0.0, 0.0);
  for (long long i = threadIdx.x; i < tiles_per_row; i += kThreads) {
    double2 v = load_published(&partial[i]);
    while (!is_set(v)) {
      __nanosleep(64);
      v = load_published(&partial[i]);
    }
    sum = SumOp::apply(sum, v);
  }
  const double2 total = block_sum<kThreads>(sum, s_sum);
  if (threadIdx.x == 0) {
    double2 close = make_double2(0.0, 0.0);
    add_terms(inc.base, inc.m, off_p, off_n, close);
    out[0] = (float)(total.x + close.x);
    out[1] = (float)(total.y + close.y);
    out[2] = (float)inc.base.x;
    out[3] = (float)inc.base.y;
  }
}

// ---- unweighted: int32 carries, the look-back joined by a warp tree -------

constexpr int kSmemBytes = 2 * kWords * 4;  // keys, payloads: 32,800 B
constexpr int kBlocksPerSM = 5;

// One tile's published record, each int2 packed into one 8-byte word: its
// aggregate (counts; the prefix at its last group start plus one, (0, 0) if
// none) and its inclusive carry.
struct TileState {
  ulonglong2 agg, inc;
};

__device__ __forceinline__ unsigned long long pack(int2 v) {
  return (unsigned long long)(unsigned)v.y << 32 | (unsigned)v.x;
}

__device__ __forceinline__ int2 unpack(unsigned long long w) { return make_int2((int)(unsigned)w, (int)(w >> 32)); }

// The join of a warp's summaries in tile order, a higher lane holding an
// older tile; every lane ends with the whole join.
__device__ __forceinline__ Summary<int2> warp_join(Summary<int2> s) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const Summary<int2> o = {shfl_xor(s.tot, d), shfl_xor(s.last, d)};
    s = lane & d ? join(s, o) : join(o, s);
  }
  return s;
}

// 32 predecessors of a tile as one warp reads them, one per lane.
struct Window {
  Carry<int2> inc;    // the lane's inclusive carry, where has_inc
  Summary<int2> agg;  // its aggregate, where has_agg
  bool has_inc, has_agg;
};

// This lane's read of predecessor p of its row (p < 0: before the row's
// first tile, the identity, as good as inclusive).
__device__ __forceinline__ Window read_window(const TileState* state, long long p) {
  const int2 zero = make_int2(0, 0), none = make_int2(-1, -1);
  Window w = {{zero, zero}, {zero, none}, p < 0, false};
  if (p >= 0) {
    const ulonglong2 a = load_published(&state[p].agg), c = load_published(&state[p].inc);
    w.has_inc = is_set(c);
    w.has_agg = is_set(a);
    w.inc = {unpack(c.x), unpack(c.y)};
    w.agg = {unpack(a.x), SumOp::apply(unpack(a.y), none)};
  }
  return w;
}

// Take one window, lane i at distance d + i: false if a tile nearer than
// any inclusive one lacks its aggregate (wait); else join its aggregates
// up to the nearest inclusive lane by a warp tree onto `after` and, where
// there is one, set `found` and its carry in `c`.
__device__ __forceinline__ bool take_window(const Window& w, Summary<int2>& after, bool& found, Carry<int2>& c,
                                            int& k) {
  const int lane = threadIdx.x & 31;
  const unsigned inclusive = __ballot_sync(kFull, w.has_inc);
  const unsigned ready = __ballot_sync(kFull, w.has_inc || w.has_agg);
  k = inclusive ? __ffs(inclusive) - 1 : 32;  // the nearest inclusive lane
  const unsigned below = k < 32 ? (1u << k) - 1u : kFull;
  if ((ready & below) != below) return false;
  const Summary<int2> identity = {make_int2(0, 0), make_int2(-1, -1)};
  after = join(warp_join(lane < k ? w.agg : identity), after);
  found = k < 32;
  if (found) c = {shfl(w.inc.base, k), shfl(w.inc.m, k)};
  return true;
}

// Warp 0 of tile t > 0 of a row: the exclusive carry of tile t (the same in
// every lane). It reads the row's predecessors 64 per read, nearest first,
// until one has its inclusive carry and every tile nearer than that its
// aggregate; joins each window of 32 by a warp tree onto the join of the
// nearer windows, and combines the whole onto that carry. A predecessor's
// ticket is older, so its block is running.
__device__ Carry<int2> look_back(const TileState* state, long long t) {
  const int lane = threadIdx.x & 31;
  // the join of the tiles between the windows taken and t
  Summary<int2> after = {make_int2(0, 0), make_int2(-1, -1)};
  Carry<int2> c;
  bool found = false;
  int k;
  unsigned pause = 16, waits = 0;
  for (long long d = 0;;) {  // distance of the next window's nearest tile (0 is t - 1)
    const Window w0 = read_window(state, t - 1 - (d + lane));
    const Window w1 = read_window(state, t - 1 - (d + 32 + lane));
    bool ready = take_window(w0, after, found, c, k);
    if (ready && !found) {
      d += 32;
      ready = take_window(w1, after, found, c, k);
    }
    if (found) {
      TIE_SCAN_LOOK_BACK(d + k, waits);
      return combine(c, after);
    }
    if (ready) {
      d += 32;
      continue;
    }
    __nanosleep(pause);
    if (pause < 128) pause *= 2;
    // over a minute waiting on tiles that take microseconds means one was
    // never scheduled: fail the launch rather than hang the card
    if (++waits == 1u << 26) __trap();
  }
}

// One tile per block, taken by ticket in the order the blocks start.
__global__ void __launch_bounds__(kThreads, kBlocksPerSM)
    tie_scan_kernel(Stream in, long long n, long long tiles_per_row, float off_p, float off_n, void* states,
                    double2* partial, unsigned* ticket, float* out) {
  extern __shared__ __align__(128) uint32_t s_words[];  // kWords each: keys, payloads
  __shared__ __align__(16) Summary<int2> s_warp[kWarps];
  __shared__ Carry<int2> s_carry, s_inc;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int2 zero = make_int2(0, 0), none = make_int2(-1, -1);
  const Tile tile = stage_tile<2>(in, n, tiles_per_row, ticket, s_words);
  const Run run = decode_run(s_words, tile);
  TIE_SCAN_PHASE(3);

  // ---- the run's counts and the prefix at its last group start, then the
  // scan over the tile's runs
  Summary<int2> own = {make_int2(__popc(run.pos), __popc(run.neg)), none};
  if (run.first) {
    const unsigned before_last = (1u << (31 - __clz(run.first))) - 1u;
    own.last = make_int2(__popc(run.pos & before_last), __popc(run.neg & before_last));
  }
  Summary<int2> agg;
  const Summary<int2> ex = block_scan_runs(own, {zero, none}, s_warp, &agg);  // ends in __syncthreads
  TIE_SCAN_PHASE(4);

  // ---- publish the aggregate, look back, publish the inclusive carry
  TileState* row_state = static_cast<TileState*>(states) + tile.row * tiles_per_row;
  if (warp == 0) {
    Carry<int2> carry = {zero, zero};
    if (tile.t > 0) {
      if (lane == 0) {
        const int2 last = SumOp::apply(agg.last, make_int2(1, 1));  // (0, 0): no group start
        publish(&row_state[tile.t].agg, make_ulonglong2(pack(agg.tot), pack(last)));
      }
      carry = look_back(row_state, tile.t);
    }
    if (lane == 0) {
      const Carry<int2> inc = combine(carry, agg);
      publish(&row_state[tile.t].inc, make_ulonglong2(pack(inc.base), pack(inc.m)));
      s_carry = carry;
      s_inc = inc;
    }
  }
  __syncthreads();
  const Carry<int2> carry = s_carry;
  TIE_SCAN_PHASE(5);

  // ---- emit from the exclusive carry: every group start closes the
  // previous group; the terms are summed in element order
  int2 c = SumOp::apply(carry.base, ex.tot);
  int2 m = ex.last.x >= 0 ? MaxOp::apply(carry.m, SumOp::apply(carry.base, ex.last)) : carry.m;
  double2 acc = make_double2(0.0, 0.0);
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    if (run.first >> j & 1u) {
      add_terms(c, m, off_p, off_n, acc);
      m = c;
    }
    c = SumOp::apply(c, make_int2(run.pos >> j & 1u, run.neg >> j & 1u));
  }
  double2* s_sum = reinterpret_cast<double2*>(s_warp);
  const double2 part = block_sum<kThreads>(acc, s_sum);
  double2* row_partial = partial + tile.row * tiles_per_row;
  if (tid == 0) publish(&row_partial[tile.t], part);
  TIE_SCAN_PHASE(6);
  if (tile.t == tiles_per_row - 1) {
    close_row(row_partial, tiles_per_row, s_inc, off_p, off_n, s_sum, out + 4 * tile.row);
  }
  TIE_SCAN_PHASE(7);
}

// ---- weighted: f64 carries, the look-back folded left to right ------------

constexpr int kWSmemBytes = 3 * kWords * 4;  // key, payload, weight: 49,200 B
constexpr int kWBlocksPerSM = 4;
// predecessors a look-back may fold at once, their aggregates kept where
// the tile's keys were (16 KB)
constexpr int kWindow = 512;

using WSummary = Summary<double2>;
using WCarry = Carry<double2>;

// One tile's published record: its aggregate and its inclusive carry, each
// published as soon as it is known.
struct WTileState {
  WSummary agg;
  WCarry inc;
};

// 1 / d: the hardware's approximate reciprocal refined by one Newton step,
// far below the f32 ulp the result is rounded to, for a fraction of a
// correctly rounded divide. d >= 1e-30 is normal.
__device__ __forceinline__ double reciprocal(double d) {
  double r;
  asm("rcp.approx.ftz.f64 %0, %1;" : "=d"(r) : "d"(d));
  return fma(r, fma(-d, r, 1.0), r);
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
  TIE_SCAN_LOOK_BACK(k, spins);
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
    tie_scan_w_kernel(Stream in, long long n, long long tiles_per_row, float off_p, float off_n, void* states,
                      double2* partial, unsigned* ticket, float* out) {
  extern __shared__ __align__(128) uint32_t s_words[];  // kWords each: keys, payloads, weights
  __shared__ WSummary s_warp[kWarps];
  __shared__ WCarry s_carry, s_inc;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const double2 zero = make_double2(0.0, 0.0), none = make_double2(-1.0, -1.0);
  const Tile tile = stage_tile<3>(in, n, tiles_per_row, ticket, s_words);
  const Run run = decode_run(s_words, tile);
  TIE_SCAN_PHASE(3);

  // ---- local reduction: the run's sums and its last group start's prefix,
  // then the scan over the tile's runs. The weights are read from the tile
  // here and again for the emit, which spares their registers in between.
  uint32_t v[kItems];
  read_run(s_words + 2 * kWords, tile.pad[2], v);
  WSummary own = {zero, none};
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    if (run.first >> j & 1u) own.last = own.tot;
    own.tot = SumOp::apply(own.tot, wstep(run.pos, run.neg, j, __uint_as_float(v[j])));
  }
  WSummary agg;
  const WSummary ex = block_scan_runs(own, {zero, none}, s_warp, &agg);  // ends in __syncthreads
  TIE_SCAN_PHASE(4);

  // ---- publish the aggregate, look back, publish the inclusive carry; the
  // look-back window lives where the tile's keys were
  WTileState* row_state = static_cast<WTileState*>(states) + tile.row * tiles_per_row;
  if (warp == 0) {
    WCarry carry = {zero, zero};
    if (tile.t > 0) {
      if (lane == 0) {
        publish(&row_state[tile.t].agg.tot, agg.tot);
        publish(&row_state[tile.t].agg.last, agg.last);
      }
      carry = look_back(row_state, tile.t, reinterpret_cast<WSummary*>(s_words));
    }
    if (lane == 0) {
      const WCarry inc = combine(carry, agg);
      publish(&row_state[tile.t].inc.base, inc.base);
      publish(&row_state[tile.t].inc.m, inc.m);
      s_carry = carry;
      s_inc = inc;
    }
  }
  __syncthreads();
  const WCarry carry = s_carry;
  TIE_SCAN_PHASE(5);

  // ---- emit from the exclusive carry: every group start closes the
  // previous group. Every element's terms are computed and the starts'
  // kept, so the 16 terms have no branch between them; the chords are
  // summed doubled and halved once (exact).
  double2 c = SumOp::apply(carry.base, ex.tot);
  double2 m = ex.last.x >= 0 ? MaxOp::apply(carry.m, SumOp::apply(carry.base, ex.last)) : carry.m;
  const double op = off_p, opn = (double)off_p + (double)off_n;
  read_run(s_words + 2 * kWords, tile.pad[2], v);
  double2 acc = zero;
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    const bool is_start = run.first >> j & 1u;
    const double rise = is_start ? c.x - m.x : 0.0;
    const double chord = (c.x + m.x) * (c.y - m.y);
    acc.x += is_start ? chord : 0.0;
    acc.y = fma(rise, (c.x + op) * reciprocal(fmax(c.x + c.y + opn, 1e-30)), acc.y);
    m = is_start ? c : m;
    c = SumOp::apply(c, wstep(run.pos, run.neg, j, __uint_as_float(v[j])));
  }
  double2* s_sum = reinterpret_cast<double2*>(s_warp);
  double2 part = block_sum<kThreads>(acc, s_sum);
  part.x *= 0.5;
  double2* row_partial = partial + tile.row * tiles_per_row;
  if (tid == 0) publish(&row_partial[tile.t], part);
  TIE_SCAN_PHASE(6);
  if (tile.t == tiles_per_row - 1) {
    close_row(row_partial, tiles_per_row, s_inc, off_p, off_n, s_sum, out + 4 * tile.row);
  }
  TIE_SCAN_PHASE(7);
}

// ---- launch -----------------------------------------------------------------

// Scratch of one launch: the tiles' records, their partials, then the
// ticket; the launch fills all of it with 0xff bytes.
struct Layout {
  long long tiles_per_row, tiles, partial_off, ticket_off;
  Layout(long long rows, long long n, bool weighted) {
    tiles_per_row = tiles_for(n);
    tiles = rows * tiles_per_row;
    partial_off = tiles * (long long)(weighted ? sizeof(WTileState) : sizeof(TileState));
    ticket_off = partial_off + tiles * (long long)sizeof(double2);
  }
  long long bytes() const { return ticket_off + (long long)sizeof(unsigned); }
};

int launch(bool weighted, Stream in, long long rows, long long n, float off_p, float off_n, void* scratch, void* out,
           cudaStream_t stream) {
  const Layout layout(rows, n, weighted);
  if (layout.tiles > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  char* base = static_cast<char*>(scratch);
  cudaError_t err = cudaMemsetAsync(scratch, 0xff, layout.bytes(), stream);
  if (err != cudaSuccess) return (int)err;
  const auto kernel = weighted ? tie_scan_w_kernel : tie_scan_kernel;
  const int smem = weighted ? kWSmemBytes : kSmemBytes;
  if ((err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem)) != cudaSuccess ||
      (err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                                  cudaSharedmemCarveoutMaxShared)) != cudaSuccess)
    return (int)err;
  kernel<<<(unsigned)layout.tiles, kThreads, smem, stream>>>(
      in, n, layout.tiles_per_row, off_p, off_n, base, reinterpret_cast<double2*>(base + layout.partial_off),
      reinterpret_cast<unsigned*>(base + layout.ticket_off), static_cast<float*>(out));
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Elements per tile: a launch over (rows, n) runs rows * max(1, ceil(n /
// tile)) tiles, one per block.
int tie_scan_tile_elems(void) { return kTile; }

// Bytes of scratch one launch over (rows, n) takes: of the weighted entries
// if `weighted` is nonzero, else of the unweighted ones.
long long tie_scan_scratch_bytes(long long rows, long long n, int weighted) {
  return Layout(rows, n, weighted != 0).bytes();
}

// key: (rows, n) 4-byte keys, payload: (rows, n) f32, both row-major and
// sorted by key within each row; out: (rows, 4) f32; scratch:
// tie_scan_scratch_bytes(rows, n, 0) bytes; all on CUDA device `device`.
// This library links its own CUDA runtime, whose current device is not the
// caller's, so each entry selects the tensors' device first. Launches on
// `stream`; returns the first CUDA error (0 when the launch was accepted).
int tie_scan_rows(int device, const void* key, const void* payload, long long rows, long long n, float off_p,
                  float off_n, void* scratch, void* out, void* stream) {
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const Stream in = {static_cast<const int32_t*>(key), static_cast<const float*>(payload), nullptr};
  return launch(false, in, rows, n, off_p, off_n, scratch, out, static_cast<cudaStream_t>(stream));
}

// One stream of n elements: the batch of one row.
int tie_scan(int device, const void* key, const void* payload, long long n, float off_p, float off_n,
             void* scratch, void* out, void* stream) {
  return tie_scan_rows(device, key, payload, 1, n, off_p, off_n, scratch, out, stream);
}

// The weighted variant: weight is a (rows, n) f32 array co-sorted with the
// keys, non-negative; out row = [area, ap_sum, w_pos, w_neg]; scratch holds
// tie_scan_scratch_bytes(rows, n, 1) bytes.
int tie_scan_rows_w(int device, const void* key, const void* payload, const void* weight, long long rows,
                    long long n, float off_p, float off_n, void* scratch, void* out, void* stream) {
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const Stream in = {static_cast<const int32_t*>(key), static_cast<const float*>(payload),
                     static_cast<const float*>(weight)};
  return launch(true, in, rows, n, off_p, off_n, scratch, out, static_cast<cudaStream_t>(stream));
}

int tie_scan_w(int device, const void* key, const void* payload, const void* weight, long long n, float off_p,
               float off_n, void* scratch, void* out, void* stream) {
  return tie_scan_rows_w(device, key, payload, weight, 1, n, off_p, off_n, scratch, out, stream);
}

}  // extern "C"

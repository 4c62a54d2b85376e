// Per-component row/column membership counts and peaks, for Hopper (sm_90a).
//
// Replaces two Pallas kernels of the JAX package:
//   * tt_component_stats_nopeak replaces component_stats_nopeak
//     (tuatara_tpu/ops/pallas/stats.py:172): for K selected roots, fp32
//     counts of each component's pixels per row (row [H, K]) and per column
//     (col [W, K]), and the same for the component minus its link-only
//     pixels (`keep` set: rrow, rcol);
//   * tt_component_stats replaces component_stats (stats.py:120): the same
//     counts plus peak [K], the max of the normalized region map `tn` over
//     each component (the branch text_threshold < low_text).
//
// What bounds them here: bytes, and at the main path's size the latency of
// one short launch. They read labels (4 B/pixel), keep (1 B/pixel) and,
// for the peak, tn (4 B/pixel) and write four count planes of (H + W) x K
// fp32; at a 512x384 heatmap and K = 256 that is ~1-1.8 MB in and ~1.8 MB
// out, about a microsecond at 3.35 TB/s.
//
// Design. The TPU kernel compares every label against every root in a
// [rows, W, K] one-hot tile; here that would be H*W*K compares for a
// result that touches each pixel once. Each call is one launch, with no
// memset and no scratch map of the image:
//   1. label -> slot: every CTA builds an open-addressed hash table of the
//      K roots in shared memory (2^bits >= 2K entries of {root, slot},
//      double hashing from two multiplicative hashes, insertion by
//      atomicCAS). Roots outside [0, H*W) are padding and are not
//      inserted; a label that is no root misses at the first empty
//      bucket. Roots below H*W must be unique (a duplicate would lose its
//      counts to the first copy); their order does not matter.
//   2. each output written once, by its owner, without global atomics. The
//      work items are column strips (BW whole columns: col and rcol, a
//      contiguous [BW, K] block of each) and row bands (BH whole rows: row
//      and rrow). A CTA counts its item in shared int32 [lines, K], then
//      writes its whole block, zeros included. A thread takes runs of 8
//      pixels along a line (down a strip's column, along a band's row);
//      neighbouring pixels mostly share a label, so it looks the slot up
//      only where the label changes and adds each stretch of one slot with
//      one shared atomic. Every pixel is read twice (once per role); the
//      planes are written once. The grid is persistent: at most the CTAs
//      the card holds at once (asked on every call), walking the items
//      strips first. `plan` below sizes the items from H, W and K: strips
//      of up to 8 columns (a strip row of labels is one 32-byte sector)
//      while two CTAs still share an SM, and bands of about a strip's
//      pixels.
//   3. peak (K5): a band CTA also takes each slot's max of tn in shared
//      memory, as an int whose signed order is the float order, starting
//      at -1e30, and writes it to a partial row [bands, K]. After one grid
//      barrier (cooperative launch, cooperative_groups grid sync) the CTAs
//      reduce 32-slot slices of the partials over the bands and write peak;
//      a slot no pixel reached is exactly -1e30. K3 needs no barrier and
//      takes a plain launch of the same template.
// Counts are integers below 2^24 and a max does not depend on order, so
// the results equal the TPU kernels' bit for bit.
//
// Each entry point launches on the caller's stream, allocates nothing,
// does not synchronise, and returns cudaGetLastError().

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kRun = 8;  // pixels of one line a thread reads before it counts them
constexpr int kMinBits = 8;  // 256 buckets: 2 KB, also the peak reduction's scratch
constexpr int kMaxStrip = 8;  // columns of a strip
// Dynamic shared memory (H100: 228 KB an SM, 1 KB of it reserved per CTA).
constexpr size_t kSmemBlockMax = 232448;             // the most one CTA may opt into
constexpr size_t kSmemTwoPerSm = 233472 / 2 - 1024;  // each of two CTAs on one SM
constexpr unsigned kHashMul = 0x9E3779B1u;  // 2^32 / golden ratio: the home bucket
constexpr unsigned kStepMul = 0x85EBCA6Bu;  // an independent odd multiplier: the probe step
constexpr float kEmptyPeak = -1e30f;

// The table's size for K roots: the least 2^bits >= 2K, at least 2^8.
__host__ __device__ inline int table_bits(int k) {
  int b = kMinBits;
  while ((1 << b) < 2 * k) ++b;
  return b;
}

// The i-th bucket a key probes: double hashing from the top `bits` bits of
// two multiplicative hashes, the step made odd so that it visits every
// bucket. Keys that share a home bucket part at the next probe, so they
// form no run that a lookup would have to walk. kernels/stats.py
// `table_probe` computes the same (checked through tt_stats_table_probe).
__host__ __device__ __forceinline__ int table_probe(int key, int bits, int i) {
  const unsigned home = ((unsigned)key * kHashMul) >> (32 - bits);
  const unsigned step = (((unsigned)key * kStepMul) >> (32 - bits)) | 1u;
  return (int)((home + (unsigned)i * step) & ((1u << bits) - 1));
}

// Dynamic shared memory of a CTA: the table, K5's peak row, and two int32
// count planes of `lines` x K.
inline size_t smem_bytes(int k, int lines, bool peak) {
  return ((size_t)8 << table_bits(k)) + (peak ? 4 * (size_t)k : 0) + 8 * (size_t)lines * k;
}

// The work items of an [h, w] image for k roots: strips of bw columns and
// bands of bh rows.
struct Plan {
  int bh, bw, bands;
  size_t smem;
};

// Strips take up to kMaxStrip columns while two CTAs still share an SM,
// else what one CTA can hold; a band holds about a strip's pixels. False
// when the table and one column of counts do not fit one CTA.
inline bool plan(int h, int w, int k, bool peak, Plan* q) {
  if (h < 1 || w < 1 || k < 1 || smem_bytes(k, 1, peak) > kSmemBlockMax) return false;
  const int strip = w < kMaxStrip ? w : kMaxStrip;
  const size_t budget =
      smem_bytes(k, strip, peak) <= kSmemTwoPerSm ? kSmemTwoPerSm : kSmemBlockMax;
  const int lines = (int)((budget - smem_bytes(k, 0, peak)) / (8 * (size_t)k));
  q->bw = strip < lines ? strip : lines;
  const int bh = h * q->bw / w;
  q->bh = bh < 1 ? 1 : bh < lines ? bh : lines;
  q->bands = (h + q->bh - 1) / q->bh;
  q->smem = smem_bytes(k, q->bh > q->bw ? q->bh : q->bw, peak);
  return true;
}

// An int whose signed order is the float order (-0.0 just below +0.0), so
// a max of floats is a max of ints; the map is its own inverse.
__device__ __forceinline__ int ordered(int bits) { return bits >= 0 ? bits : bits ^ 0x7fffffff; }

__device__ __forceinline__ int slot_of(const int2* table, int bits, int lab) {
  if (lab < 0) return -1;
  for (int i = 0;; ++i) {
    const int2 e = table[table_probe(lab, bits, i)];
    if (e.x == lab) return e.y;
    if (e.x < 0) return -1;
  }
}

struct StatsArgs {
  const int* labels;
  const uint8_t* keep;
  const float* tn;  // K5 only
  const int* roots;
  float *row, *col, *rrow, *rcol;
  int* partial;  // [bands, k] ordered ints, K5 only
  float* peak;   // K5 only
  int h, w, k, bh, bw, bits;
};

// One work item: a strip of columns [first, first + nl) or a band of rows
// [first, first + nl). A task is a run of up to kRun pixels along one line
// of the item: down a column of a strip, along a row of a band. Tasks are
// numbered so that a warp's lanes read neighbouring columns of a strip's
// rows (32-byte sectors) or neighbouring runs of a band's row.
struct Item {
  bool strip;
  int first, nl, chunks, tasks;  // chunks: runs per line
};

__device__ __forceinline__ Item item_of(const StatsArgs& p, int item, int strips) {
  Item it;
  it.strip = item < strips;
  it.first = it.strip ? item * p.bw : (item - strips) * p.bh;
  it.nl = it.strip ? min(p.bw, p.w - it.first) : min(p.bh, p.h - it.first);
  it.chunks = ((it.strip ? p.h : p.w) + kRun - 1) / kRun;
  it.tasks = it.nl * it.chunks;
  return it;
}

// A thread's task read into registers: its line of the item and up to
// kRun labels (-1 past the end), keep bits and, for a K5 band, tn.
struct Run {
  int line, lab[kRun], tv[kRun];
  unsigned keep;
};

template <bool kPeak>
__device__ __forceinline__ void load_run(const StatsArgs& p, const Item& it, int task, int empty,
                                         Run& r) {
  int pix0, step, n;
  if (it.strip) {  // task = chunk * nl + column
    const int c = task / it.nl, x = task - c * it.nl;
    r.line = x;
    pix0 = c * kRun * p.w + it.first + x;
    step = p.w;
    n = min(kRun, p.h - c * kRun);
  } else {  // task = line * chunks + chunk
    const int y = task / it.chunks, c = task - y * it.chunks;
    r.line = y;
    pix0 = (it.first + y) * p.w + c * kRun;
    step = 1;
    n = min(kRun, p.w - c * kRun);
  }
  r.keep = 0;
#pragma unroll
  for (int u = 0; u < kRun; ++u) {
    const int pix = pix0 + u * step;
    r.lab[u] = u < n ? __ldg(p.labels + pix) : -1;
    r.keep |= (u < n && p.keep[pix] ? 1u : 0u) << u;
    r.tv[u] = kPeak && !it.strip && u < n ? ordered(__float_as_int(__ldg(p.tn + pix))) : empty;
  }
}

// Count a run: neighbouring pixels of a line mostly share a label, so the
// slot is looked up when the label changes and each stretch of one slot
// adds its count (and its max of tn) with one shared atomic.
template <bool kPeak>
__device__ __forceinline__ void count_run(const Run& r, const int2* table, int bits, int k,
                                          bool band_peak, int empty, int* cnt, int* rcnt,
                                          int* pk) {
  int cur = -1, s = -1, n = 0, rn = 0, mx = empty;
#pragma unroll
  for (int u = 0; u <= kRun; ++u) {
    const int lab = u < kRun ? r.lab[u] : -2;  // -2 flushes the last stretch
    if (lab != cur) {
      if (s >= 0) {
        atomicAdd(cnt + r.line * k + s, n);
        if (rn) atomicAdd(rcnt + r.line * k + s, rn);
        if (kPeak && band_peak) atomicMax(pk + s, mx);
      }
      cur = lab;
      s = slot_of(table, bits, lab);
      n = rn = 0;
      mx = empty;
    }
    if (u < kRun && s >= 0) {
      ++n;
      rn += r.keep >> u & 1u;
      if (kPeak) mx = max(mx, r.tv[u]);
    }
  }
}

template <bool kPeak>
__global__ void __launch_bounds__(kThreads, 2) component_stats(const StatsArgs p) {
  extern __shared__ int2 table[];
  const int cap = 1 << p.bits, k = p.k;
  int* pk = reinterpret_cast<int*>(table + cap);
  int* cnt = pk + (kPeak ? k : 0);
  int* rcnt = cnt + max(p.bh, p.bw) * k;
  const int tid = threadIdx.x;
  const int empty = ordered(__float_as_int(kEmptyPeak));
  const int strips = (p.w + p.bw - 1) / p.bw, bands = (p.h + p.bh - 1) / p.bh;
  const int items = strips + bands;

  // 1. The roots' table.
  for (int i = tid; i < cap; i += kThreads) table[i] = make_int2(-1, -1);
  __syncthreads();
  for (int j = tid; j < k; j += kThreads) {
    const int root = __ldg(p.roots + j);
    if (root < 0 || root >= p.h * p.w) continue;
    int i = 0;
    while (atomicCAS(&table[table_probe(root, p.bits, i)].x, -1, root) != -1) ++i;
    table[table_probe(root, p.bits, i)].y = j;
  }
  __syncthreads();

  // 2. Strips, then bands: count in shared memory, write the block once.
  for (int item = blockIdx.x; item < items; item += gridDim.x) {
    const Item it = item_of(p, item, strips);
    const bool band_peak = kPeak && !it.strip;
    for (int i = tid; i < it.nl * k; i += kThreads) cnt[i] = rcnt[i] = 0;
    if (band_peak)
      for (int j = tid; j < k; j += kThreads) pk[j] = empty;
    __syncthreads();
    for (int task = tid; task < it.tasks; task += kThreads) {
      Run r;
      load_run<kPeak>(p, it, task, empty, r);
      count_run<kPeak>(r, table, p.bits, k, band_peak, empty, cnt, rcnt, pk);
    }
    __syncthreads();
    float* out = (it.strip ? p.col : p.row) + (size_t)it.first * k;
    float* rout = (it.strip ? p.rcol : p.rrow) + (size_t)it.first * k;
    for (int i = tid; i < it.nl * k; i += kThreads) {
      out[i] = (float)cnt[i];
      rout[i] = (float)rcnt[i];
    }
    if (band_peak)
      for (int j = tid; j < k; j += kThreads) p.partial[(size_t)(item - strips) * k + j] = pk[j];
    __syncthreads();
  }
  if constexpr (kPeak) {
    // 3. Peak: every band's partial row is written; reduce 32-slot slices.
    cg::this_grid().sync();
    int* red = reinterpret_cast<int*>(table);  // kWarps x 32 ints fit in 2^kMinBits buckets
    const int lane = tid & 31, warp = tid >> 5;
    for (int c = blockIdx.x; c * 32 < k; c += gridDim.x) {
      const int j = c * 32 + lane;
      int m = empty;
      if (j < k) {
#pragma unroll 4
        for (int r = warp; r < bands; r += kWarps)
          m = max(m, __ldcg(p.partial + (size_t)r * k + j));
      }
      red[warp * 32 + lane] = m;
      __syncthreads();
      if (warp == 0) {
        for (int q = 1; q < kWarps; ++q) m = max(m, red[q * 32 + lane]);
        if (j < k) p.peak[j] = __int_as_float(ordered(m));
      }
      __syncthreads();
    }
  }
}

template <bool kPeak>
cudaError_t launch(StatsArgs p, cudaStream_t stream) {
  Plan q;
  if (!plan(p.h, p.w, p.k, kPeak, &q)) return cudaErrorInvalidValue;
  p.bh = q.bh;
  p.bw = q.bw;
  p.bits = table_bits(p.k);
  // The grid: at most the CTAs the current device holds at once.
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(component_stats<kPeak>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)q.smem);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, component_stats<kPeak>, kThreads,
                                                      q.smem);
  if (e != cudaSuccess) return e;
  if (per_sm < 1) return cudaErrorLaunchOutOfResources;
  const int items = (p.w + q.bw - 1) / q.bw + q.bands;
  const int grid = items < sms * per_sm ? items : sms * per_sm;
  if constexpr (kPeak) {
    void* params[] = {&p};
    e = cudaLaunchCooperativeKernel((const void*)component_stats<kPeak>, dim3(grid),
                                    dim3(kThreads), params, q.smem, stream);
    if (e != cudaSuccess) return e;
  } else {
    component_stats<kPeak><<<grid, kThreads, q.smem, stream>>>(p);
  }
  return cudaGetLastError();
}

}  // namespace

// Roots below h*w unique.
extern "C" int tt_component_stats_nopeak(const int* labels, const uint8_t* keep, const int* roots,
                                         float* row, float* col, float* rrow, float* rcol, int h,
                                         int w, int k, cudaStream_t stream) {
  StatsArgs p{labels, keep, nullptr, roots, row, col, rrow, rcol, nullptr, nullptr, h, w, k};
  return (int)launch<false>(p, stream);
}

// partial: int32 scratch [tt_component_stats_bands(h, w, k, 1), k]. peak
// [k] fp32: the max of tn over each slot's pixels, exactly -1e30 for a slot
// with none.
extern "C" int tt_component_stats(const int* labels, const float* tn, const uint8_t* keep,
                                  const int* roots, int* partial, float* row, float* col,
                                  float* rrow, float* rcol, float* peak, int h, int w, int k,
                                  cudaStream_t stream) {
  StatsArgs p{labels, keep, tn, roots, row, col, rrow, rcol, partial, peak, h, w, k};
  return (int)launch<true>(p, stream);
}

// The row bands of an [h, w] image for k roots (with peak: K5's partial
// rows), or 0 when k roots do not fit one CTA's shared memory.
extern "C" int tt_component_stats_bands(int h, int w, int k, int peak) {
  Plan q;
  return plan(h, w, k, peak != 0, &q) ? q.bands : 0;
}

// The i-th bucket that `key` probes in the table built for k roots, for
// the checks of kernels/stats.py's mirror of the hash.
extern "C" int tt_stats_table_probe(int key, int k, int i) {
  return table_probe(key, table_bits(k), i);
}

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
// What bounds them here: bytes. They read labels (4 B/pixel), keep
// (1 B/pixel) and, for the peak, tn (4 B/pixel) once and write four count
// planes of (H + W) x K fp32; at the main path's 512x384 heatmap and
// K = 256 that is ~1-1.8 MB in and ~1.8 MB out, a floor of about a
// microsecond at 3.35 TB/s.
//
// Design. The TPU kernel compares every label against every root in a
// [rows, W, K] one-hot tile, which its vector unit streams; here that
// would be H*W*K compares for a result that touches each pixel once. So:
//   1. a label -> slot map: scratch [H*W] set to -1, then map[roots[k]] = k
//      for roots[k] < H*W (padding roots are 2^30 and never match);
//   2. each foreground pixel with a slot adds 1.0 to row[y, slot] and
//      col[x, slot], and to rrow/rcol when keep is set. A warp covers 32
//      pixels of one row, so the row adds are aggregated per slot with
//      __match_any_sync before the atomicAdd;
//   3. for the peak, the warp's pixels of one slot take their max with
//      __reduce_max_sync and one lane atomicMax-es it into peak[slot], as
//      an int whose order is the float order. Every slot starts at -1e30
//      (JAX's fill for non-members), so a slot with no pixel ends there.
// Counts are integers below 2^24, so fp32 atomics give the exact sums in
// any order, and a max does not depend on order: the results equal the TPU
// kernels' bit for bit.
//
// Launches on the caller's stream, allocates nothing, does not synchronise,
// and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr float kEmptyPeak = -1e30f;

__global__ void slots_fill(int* __restrict__ slot, int n) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) slot[i] = -1;
}

__global__ void slots_set(const int* __restrict__ roots, int* __restrict__ slot, int k, int n) {
  int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= k) return;
  int r = roots[j];
  if (r >= 0 && r < n) slot[r] = j;
}

__device__ __forceinline__ void add_row(float* plane, int key, bool on) {
  unsigned live = __ballot_sync(0xffffffffu, on);
  if (!on) return;
  unsigned peers = __match_any_sync(live, key);
  if ((threadIdx.x & 31) == __ffs(peers) - 1) atomicAdd(plane + key, (float)__popc(peers));
}

// An int whose signed order is the float order (-0.0 just below +0.0), so
// a max of floats is an atomicMax of ints; the map is its own inverse.
__device__ __forceinline__ int ordered(int bits) { return bits >= 0 ? bits : bits ^ 0x7fffffff; }

__global__ void peak_fill(int* __restrict__ peak, int k) {
  int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j < k) peak[j] = ordered(__float_as_int(kEmptyPeak));
}

__global__ void peak_decode(int* __restrict__ peak, int k) {
  int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j < k) peak[j] = ordered(peak[j]);
}

// tn and peak are null for the counts-only entry (K3).
__global__ void stats_accumulate(const int* __restrict__ labels, const uint8_t* __restrict__ keep,
                                 const float* __restrict__ tn, const int* __restrict__ slot,
                                 float* row, float* col, float* rrow, float* rcol, int* peak,
                                 int h, int w, int k) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  int n = h * w;
  int s = -1;
  bool kp = false;
  if (i < n) {
    int lab = labels[i];
    if (lab >= 0) s = slot[lab];
    kp = keep[i] != 0;
  }
  int y = i / w;
  int x = i - y * w;
  bool on = s >= 0;
  bool ron = on && kp;
  add_row(row, y * k + s, on);
  add_row(rrow, y * k + s, ron);
  if (on) atomicAdd(col + x * k + s, 1.0f);
  if (ron) atomicAdd(rcol + x * k + s, 1.0f);
  if (peak) {
    unsigned live = __ballot_sync(0xffffffffu, on);
    if (on) {
      unsigned peers = __match_any_sync(live, s);
      int v = __reduce_max_sync(peers, ordered(__float_as_int(tn[i])));
      if ((threadIdx.x & 31) == __ffs(peers) - 1) atomicMax(peak + s, v);
    }
  }
}

inline int blocks(int n) { return (n + kThreads - 1) / kThreads; }

void counts(const int* labels, const uint8_t* keep, const float* tn, const int* roots, int* slot,
            float* row, float* col, float* rrow, float* rcol, int* peak, int h, int w, int k,
            cudaStream_t stream) {
  int n = h * w;
  size_t hk = sizeof(float) * (size_t)h * k, wk = sizeof(float) * (size_t)w * k;
  cudaMemsetAsync(row, 0, hk, stream);
  cudaMemsetAsync(rrow, 0, hk, stream);
  cudaMemsetAsync(col, 0, wk, stream);
  cudaMemsetAsync(rcol, 0, wk, stream);
  if (peak) peak_fill<<<blocks(k), kThreads, 0, stream>>>(peak, k);
  slots_fill<<<blocks(n), kThreads, 0, stream>>>(slot, n);
  slots_set<<<blocks(k), kThreads, 0, stream>>>(roots, slot, k, n);
  stats_accumulate<<<blocks(n), kThreads, 0, stream>>>(labels, keep, tn, slot, row, col, rrow,
                                                       rcol, peak, h, w, k);
  if (peak) peak_decode<<<blocks(k), kThreads, 0, stream>>>(peak, k);
}

}  // namespace

extern "C" int tt_component_stats_nopeak(const int* labels, const uint8_t* keep, const int* roots,
                                         int* slot_scratch, float* row, float* col, float* rrow,
                                         float* rcol, int h, int w, int k, cudaStream_t stream) {
  counts(labels, keep, nullptr, roots, slot_scratch, row, col, rrow, rcol, nullptr, h, w, k,
         stream);
  return (int)cudaGetLastError();
}

// peak [k] fp32 is written through its int bits: the max of tn over each
// slot's pixels, exactly -1e30 for a slot with none (padding roots).
extern "C" int tt_component_stats(const int* labels, const float* tn, const uint8_t* keep,
                                  const int* roots, int* slot_scratch, float* row, float* col,
                                  float* rrow, float* rcol, float* peak, int h, int w, int k,
                                  cudaStream_t stream) {
  counts(labels, keep, tn, roots, slot_scratch, row, col, rrow, rcol, reinterpret_cast<int*>(peak),
         h, w, k, stream);
  return (int)cudaGetLastError();
}

// Per-component row/column membership counts, for Hopper (sm_90a).
//
// Replaces component_stats_nopeak (tuatara_tpu/ops/pallas/stats.py:172):
// for K selected roots, fp32 counts of each component's pixels per row
// (row [H, K]) and per column (col [W, K]), and the same for the component
// minus its link-only pixels (`keep` set: rrow, rcol).
//
// What bounds it here: bytes. It reads labels (4 B/pixel) and keep
// (1 B/pixel) once and writes four count planes of (H + W) x K fp32; at the
// main path's 512x384 heatmap and K = 256 that is ~1 MB in and ~1.8 MB out,
// a floor of about a microsecond at 3.35 TB/s.
//
// Design. The TPU kernel compares every label against every root in a
// [rows, W, K] one-hot tile, which its vector unit streams; here that
// would be H*W*K compares for a result that touches each pixel once. So:
//   1. a label -> slot map: scratch [H*W] set to -1, then map[roots[k]] = k
//      for roots[k] < H*W (padding roots are 2^30 and never match);
//   2. each foreground pixel with a slot adds 1.0 to row[y, slot] and
//      col[x, slot], and to rrow/rcol when keep is set. A warp covers 32
//      pixels of one row, so the row adds are aggregated per slot with
//      __match_any_sync before the atomicAdd.
// Counts are integers below 2^24, so fp32 atomics give the exact sums in
// any order: the result equals the TPU kernel's bit for bit.
//
// Launches on the caller's stream, allocates nothing, does not synchronise,
// and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

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

__global__ void stats_accumulate(const int* __restrict__ labels, const uint8_t* __restrict__ keep,
                                 const int* __restrict__ slot, float* row, float* col, float* rrow,
                                 float* rcol, int h, int w, int k) {
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
}

inline int blocks(int n) { return (n + kThreads - 1) / kThreads; }

}  // namespace

extern "C" int tt_component_stats_nopeak(const int* labels, const uint8_t* keep, const int* roots,
                                         int* slot_scratch, float* row, float* col, float* rrow,
                                         float* rcol, int h, int w, int k, cudaStream_t stream) {
  int n = h * w;
  size_t hk = sizeof(float) * (size_t)h * k, wk = sizeof(float) * (size_t)w * k;
  cudaMemsetAsync(row, 0, hk, stream);
  cudaMemsetAsync(rrow, 0, hk, stream);
  cudaMemsetAsync(col, 0, wk, stream);
  cudaMemsetAsync(rcol, 0, wk, stream);
  slots_fill<<<blocks(n), kThreads, 0, stream>>>(slot_scratch, n);
  slots_set<<<blocks(k), kThreads, 0, stream>>>(roots, slot_scratch, k, n);
  stats_accumulate<<<blocks(n), kThreads, 0, stream>>>(labels, keep, slot_scratch, row, col, rrow,
                                                       rcol, h, w, k);
  return (int)cudaGetLastError();
}

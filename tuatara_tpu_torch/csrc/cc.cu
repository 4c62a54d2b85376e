// Connected components of the detection heatmap, for Hopper (sm_90a).
//
// Replaces three Pallas kernels of the JAX package:
//   * tt_label_components_aux replaces label_components_pallas_aux
//     (tuatara_tpu/ops/pallas/cc.py:213): 4-connected labels of `mask`,
//     each the smallest raster index of its component (-1 on background),
//     plus `auxmin`, the smallest raster index of the component's `aux`
//     pixels (exactly 2^30 on background and where the component has none).
//   * tt_label_components replaces label_components_pallas (cc.py:89): the
//     same labels without the aux channel (the branch text_threshold <
//     low_text). The TPU kernel also returns its sweep count; union-find
//     has none.
//   * tt_area_ok replaces area_ok_pallas (cc.py:146): per pixel, whether its
//     component's area is >= min_area.
//
// What bounds them here: memory traffic and atomics, not arithmetic. At the
// main path's 512x384 heatmap one int32 plane is 0.8 MB, far below the
// 50 MB L2, so the passes below run mostly out of L2; the floor is the
// bytes each function must move (mask + aux in, labels + auxmin out:
// 10 B/pixel; mask in, labels out: 5 B/pixel; labels in, a byte out:
// 5 B/pixel) at 3.35 TB/s.
//
// Design. The TPU kernel sweeps a doubling segmented min over the whole
// image in VMEM until nothing changes; a GPU block cannot hold the image
// and blocks run in no order, so the labels come from union-find instead:
//   1. init:  parent[i] = i on foreground, -1 elsewhere; auxmin = 2^30.
//   2. merge: each pixel unites with its left and upper neighbour. A union
//      links the larger root under the smaller with atomicMin and retries
//      from the value it found when another thread got there first, so
//      parent[i] <= i always and each root ends as the minimum index of its
//      component (Playne & Hawick 2018). Finds read through L2 (__ldcg):
//      other SMs' atomics never sit stale in this SM's L1.
//   3. flatten: parent[i] = find(i); hot pixels atomicMin their index into
//      auxmin[root], which serves as the root-indexed scratch.
//   4. gather: non-root pixels copy auxmin[root]; roots keep their own.
// The labels-only entry runs passes 1-3 without the aux channel.
// Union-find reaches the true components in one pass, with no sweep cap.
// The area filter is a label-indexed histogram (warp-aggregated atomicAdd:
// neighbouring pixels of a row mostly share a label) and a gather-compare,
// exact for every component size.
//
// Each entry point launches on the caller's stream, allocates nothing,
// does not synchronise, and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBig = 1 << 30;
constexpr int kThreads = 256;

__device__ __forceinline__ int find_root(const int* parent, int x) {
  int p = __ldcg(parent + x);
  while (p != x) {
    x = p;
    p = __ldcg(parent + x);
  }
  return x;
}

__device__ __forceinline__ void unite(int* parent, int a, int b) {
  while (true) {
    a = find_root(parent, a);
    b = find_root(parent, b);
    if (a == b) return;
    if (a > b) {
      int t = a;
      a = b;
      b = t;
    }
    int old = atomicMin(parent + b, a);
    if (old == b) return;  // b was a root and now hangs under a
    b = old;               // b had been linked meanwhile: unite a with that
  }
}

// auxmin and aux may be null (labels only).
__global__ void cc_init(const uint8_t* __restrict__ mask, int* __restrict__ parent,
                        int* __restrict__ auxmin, int n) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  parent[i] = mask[i] ? i : -1;
  if (auxmin) auxmin[i] = kBig;
}

__global__ void cc_merge(const uint8_t* __restrict__ mask, int* parent, int h, int w) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= h * w || !mask[i]) return;
  int x = i % w;
  if (x > 0 && mask[i - 1]) unite(parent, i, i - 1);
  if (i >= w && mask[i - w]) unite(parent, i, i - w);
}

__global__ void cc_flatten(const uint8_t* __restrict__ mask, const uint8_t* __restrict__ aux,
                           int* parent, int* auxmin, int n) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n || !mask[i]) return;
  int r = find_root(parent, i);
  parent[i] = r;
  if (aux && aux[i]) atomicMin(auxmin + r, i);
}

__global__ void cc_gather_aux(const int* __restrict__ labels, int* auxmin, int n) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  int r = labels[i];
  if (r >= 0 && r != i) auxmin[i] = auxmin[r];
}

__global__ void area_hist(const int* __restrict__ labels, int* __restrict__ area, int n) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  int lab = i < n ? labels[i] : -1;
  unsigned live = __ballot_sync(0xffffffffu, lab >= 0);
  if (lab < 0) return;
  unsigned peers = __match_any_sync(live, lab);
  if ((threadIdx.x & 31) == __ffs(peers) - 1) atomicAdd(area + lab, __popc(peers));
}

__global__ void area_compare(const int* __restrict__ labels, const int* __restrict__ area,
                             uint8_t* __restrict__ out, int n, int min_area) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  int lab = labels[i];
  out[i] = (lab >= 0 && area[lab] >= min_area) ? 1 : 0;
}

inline int blocks(int n) { return (n + kThreads - 1) / kThreads; }

}  // namespace

extern "C" int tt_label_components_aux(const uint8_t* mask, const uint8_t* aux, int* labels,
                                       int* auxmin, int h, int w, cudaStream_t stream) {
  int n = h * w;
  cc_init<<<blocks(n), kThreads, 0, stream>>>(mask, labels, auxmin, n);
  cc_merge<<<blocks(n), kThreads, 0, stream>>>(mask, labels, h, w);
  cc_flatten<<<blocks(n), kThreads, 0, stream>>>(mask, aux, labels, auxmin, n);
  cc_gather_aux<<<blocks(n), kThreads, 0, stream>>>(labels, auxmin, n);
  return (int)cudaGetLastError();
}

extern "C" int tt_label_components(const uint8_t* mask, int* labels, int h, int w,
                                   cudaStream_t stream) {
  int n = h * w;
  cc_init<<<blocks(n), kThreads, 0, stream>>>(mask, labels, nullptr, n);
  cc_merge<<<blocks(n), kThreads, 0, stream>>>(mask, labels, h, w);
  cc_flatten<<<blocks(n), kThreads, 0, stream>>>(mask, nullptr, labels, nullptr, n);
  return (int)cudaGetLastError();
}

extern "C" int tt_area_ok(const int* labels, int* area_scratch, uint8_t* out, int h, int w,
                          int min_area, cudaStream_t stream) {
  int n = h * w;
  cudaMemsetAsync(area_scratch, 0, sizeof(int) * (size_t)n, stream);
  area_hist<<<blocks(n), kThreads, 0, stream>>>(labels, area_scratch, n);
  area_compare<<<blocks(n), kThreads, 0, stream>>>(labels, area_scratch, out, n, min_area);
  return (int)cudaGetLastError();
}

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
//     component's area is >= min_area, for 1 <= min_area <= 16.
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
// and blocks run in no order, so the labels come from union-find instead,
// in one cooperative launch whose phases are separated by grid-wide
// barriers (cooperative_groups grid sync; the grid is as many CTAs as the
// card holds at once, and each phase walks the image with a grid stride):
//   1. run starts: a warp takes 32 pixels of one row (a segment). The
//      ballot of the mask and a __clz over the bits below a lane give each
//      foreground pixel the first pixel of its run inside the segment,
//      which becomes its parent (-1 on background; auxmin = 2^30). A run
//      start is its run's smallest index, so parent[i] <= i, and a
//      horizontal run is a tree of depth one, not a chain as long as the
//      run.
//   2. unions: a segment's first lane unites its pixel with the previous
//      segment's last one when both are set (a run crossing a segment
//      border); no other pixel needs a horizontal union. A pixel unites
//      with the one above only when both are set and its left neighbour
//      and that one's upper neighbour are not both set (else the two are
//      joined already through the left neighbours). A union links the
//      larger root under the smaller with atomicMin and retries from the
//      value it found when another thread got there first, so every root
//      ends as the minimum index of its component in any order of unions
//      (Playne & Hawick 2018). Finds read through L2 (__ldcg): other SMs'
//      atomics never sit stale in this SM's L1.
//   3. flatten: label[i] = find(i); aux pixels atomicMin their index into
//      auxmin[root], which serves as the root-indexed scratch.
//   4. gather (aux entry only): non-root pixels copy auxmin[root]; roots
//      keep their own.
// One launch per call for either entry (it was 4 for K1, 3 for K4).
// Union-find reaches the true components in one pass, with no sweep cap.
//
// The area filter needs no image-wide histogram (and so no root-indexed
// scratch plane, no memset and no atomics in global memory). As in the TPU
// kernel, the window of m-1 pixels around a pixel decides (m = min_area):
// a component of area >= m holds, from any of its pixels, m-1 other
// members within graph distance m-1 (a breadth-first search reaches them),
// and graph distance bounds the Chebyshev distance, so the (2m-1)^2 window
// holds at least min(area, m) of its pixels, and never more than its area.
// One launch: a CTA stages a 32x32 tile of labels and its halo of m-1
// pixels (-1 beyond the image) in shared memory, counts each label over
// that whole region in a shared-memory hash table (one atomic per run of
// equal labels in a warp), and writes ok = count >= m at each tile pixel
// (0 at background). The region holds the window of every tile pixel and lies
// inside the image, so its count of a label sits between the window count
// and the area: count >= m exactly when area >= m. Exact for any H and W,
// without the TPU version's circular wrap. The kernel writes the byte plane
// and nothing else.
//
// Each entry point launches on the caller's stream, allocates nothing,
// does not synchronise, and returns cudaGetLastError().

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

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

struct LabelArgs {
  const uint8_t* mask;
  const uint8_t* aux;  // null: labels only
  int* labels;         // the parent array while the phases run
  int* auxmin;
  int h, w;
};

__global__ void __launch_bounds__(kThreads) cc_label(const LabelArgs p) {
  cg::grid_group grid = cg::this_grid();
  const int w = p.w, n = p.h * w, segs = (w + 31) / 32, n_segs = p.h * segs;
  const int lane = threadIdx.x & 31;
  const int warp0 = (blockIdx.x * kThreads + threadIdx.x) >> 5;
  const int n_warps = gridDim.x * (kThreads / 32);
  const int* parent = p.labels;

  // 1. Run starts inside each 32-pixel segment.
  for (int s = warp0; s < n_segs; s += n_warps) {
    const int y = s / segs, x = (s % segs) * 32 + lane, i = y * w + x;
    const bool in = x < w;
    const bool m = in && p.mask[i];
    const unsigned bits = __ballot_sync(0xffffffffu, m);
    if (!in) continue;
    const unsigned gaps = ~bits & ((1u << lane) - 1);  // background lanes below this one
    const int start = gaps ? 32 - __clz(gaps) : 0;
    p.labels[i] = m ? i - (lane - start) : -1;
    if (p.aux) p.auxmin[i] = kBig;
  }
  grid.sync();

  // 2. Segment-border and reduced vertical unions.
  for (int s = warp0; s < n_segs; s += n_warps) {
    const int y = s / segs, x = (s % segs) * 32 + lane, i = y * w + x;
    if (x >= w || !p.mask[i]) continue;
    const bool left = x > 0 && p.mask[i - 1];
    if (lane == 0 && left) unite(p.labels, i, i - 1);
    if (y > 0 && p.mask[i - w] && !(left && p.mask[i - w - 1])) unite(p.labels, i, i - w);
  }
  grid.sync();

  // 3. Flatten; the aux minimum of each root.
  const int stride = gridDim.x * kThreads;
  for (int i = blockIdx.x * kThreads + threadIdx.x; i < n; i += stride) {
    if (!p.mask[i]) continue;
    const int r = find_root(parent, i);
    p.labels[i] = r;
    if (p.aux && p.aux[i]) atomicMin(p.auxmin + r, i);
  }
  if (!p.aux) return;
  grid.sync();

  // 4. Every pixel of a component takes its root's aux minimum.
  for (int i = blockIdx.x * kThreads + threadIdx.x; i < n; i += stride) {
    const int r = __ldcg(p.labels + i);
    if (r >= 0 && r != i) p.auxmin[i] = __ldcg(p.auxmin + r);
  }
}

// The cooperative launch of cc_label: as many CTAs as the card holds at
// once (its grid barriers need every CTA resident), at most one per 256
// pixels.
cudaError_t launch_label(const LabelArgs& p, cudaStream_t stream) {
  static int slots = 0;
  if (!slots) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, cc_label, kThreads, 0);
    if (e != cudaSuccess) return e;
    if (per_sm < 1) return cudaErrorLaunchOutOfResources;
    slots = sms * per_sm;
  }
  const int need = (p.h * p.w + kThreads - 1) / kThreads;
  const int grid = need < slots ? need : slots;
  LabelArgs args = p;
  void* params[] = {&args};
  cudaError_t e = cudaLaunchCooperativeKernel((const void*)cc_label, dim3(grid), dim3(kThreads),
                                              params, 0, stream);
  return e != cudaSuccess ? e : cudaGetLastError();
}

constexpr int kAreaTile = 32;  // a CTA's tile: 32x32 pixels, a thread each
constexpr int kAreaThreads = kAreaTile * kAreaTile;
constexpr int kMaxMinArea = 16;  // region <= (32 + 30)^2 labels + a 4096-slot table: 47 KB

// Hash-table slots for a region: the least power of two >= its pixels, so
// the table never fills (a region holds at most its pixels' labels).
inline int area_table_bits(int region) {
  int bits = 0;
  while ((1 << bits) < region) ++bits;
  return bits;
}

__global__ void __launch_bounds__(kAreaThreads)
area_ok_region(const int* __restrict__ labels, uint8_t* __restrict__ out, int h, int w,
               int min_area, int bits) {
  extern __shared__ int smem[];
  const int r = min_area - 1, side = kAreaTile + 2 * r, region = side * side;
  const int slots = 1 << bits;
  int* tile = smem;             // [side * side] labels, -1 beyond the image
  int* keys = tile + region;    // [slots] labels, -1 free
  int* counts = keys + slots;   // [slots] pixels of the label in the region
  const int bx = blockIdx.x * kAreaTile, by = blockIdx.y * kAreaTile;
  for (int k = threadIdx.x; k < slots; k += kAreaThreads) {
    keys[k] = -1;
    counts[k] = 0;
  }
  for (int k = threadIdx.x; k < region; k += kAreaThreads) {
    const int y = by - r + k / side, x = bx - r + k % side;
    tile[k] = (y >= 0 && y < h && x >= 0 && x < w) ? __ldg(labels + (size_t)y * w + x) : -1;
  }
  __syncthreads();
  // Count the region's labels: a warp's 32 consecutive labels split into
  // runs of equal ones (a shuffle and a ballot), each run one insert.
  const int lane = threadIdx.x & 31;
  for (int base = 0; base < region; base += kAreaThreads) {
    const int k = base + threadIdx.x;
    const int lab = k < region ? tile[k] : -1;
    const int prev = __shfl_up_sync(0xffffffffu, lab, 1);
    const unsigned starts = __ballot_sync(0xffffffffu, lane == 0 || prev != lab);
    if (lab < 0 || !(starts >> lane & 1)) continue;
    const unsigned after = starts & ~((2u << lane) - 1u);  // the next run's start
    const int run = (after ? __ffs(after) - 1 : 32) - lane;
    unsigned slot = ((unsigned)lab * 2654435761u) >> (32 - bits);
    while (true) {
      const int prev_key = atomicCAS(keys + slot, -1, lab);
      if (prev_key == -1 || prev_key == lab) {
        atomicAdd(counts + slot, run);
        break;
      }
      slot = (slot + 1) & (slots - 1);
    }
  }
  __syncthreads();
  const int tx = threadIdx.x % kAreaTile, ty = threadIdx.x / kAreaTile;
  const int x = bx + tx, y = by + ty;
  if (y >= h || x >= w) return;
  const int lab = tile[(ty + r) * side + tx + r];
  bool ok = false;
  if (lab >= 0) {
    unsigned slot = ((unsigned)lab * 2654435761u) >> (32 - bits);
    while (keys[slot] != lab) slot = (slot + 1) & (slots - 1);
    ok = counts[slot] >= min_area;
  }
  out[(size_t)y * w + x] = ok;
}

}  // namespace

extern "C" int tt_label_components_aux(const uint8_t* mask, const uint8_t* aux, int* labels,
                                       int* auxmin, int h, int w, cudaStream_t stream) {
  if (!aux || h < 1 || w < 1) return (int)cudaErrorInvalidValue;
  return (int)launch_label(LabelArgs{mask, aux, labels, auxmin, h, w}, stream);
}

extern "C" int tt_label_components(const uint8_t* mask, int* labels, int h, int w,
                                   cudaStream_t stream) {
  if (h < 1 || w < 1) return (int)cudaErrorInvalidValue;
  return (int)launch_label(LabelArgs{mask, nullptr, labels, nullptr, h, w}, stream);
}

extern "C" int tt_area_ok(const int* labels, uint8_t* out, int h, int w, int min_area,
                          cudaStream_t stream) {
  if (h < 1 || w < 1 || min_area < 1 || min_area > kMaxMinArea) return (int)cudaErrorInvalidValue;
  const int side = kAreaTile + 2 * (min_area - 1), region = side * side;
  const int bits = area_table_bits(region);
  const size_t smem = sizeof(int) * ((size_t)region + 2 * ((size_t)1 << bits));
  const dim3 grid((w + kAreaTile - 1) / kAreaTile, (h + kAreaTile - 1) / kAreaTile);
  area_ok_region<<<grid, kAreaThreads, smem, stream>>>(labels, out, h, w, min_area, bits);
  return (int)cudaGetLastError();
}

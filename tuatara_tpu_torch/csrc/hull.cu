// H1: the monotone-chain hulls of the rotated box fit, for Hopper (sm_90a).
//
// Replaces no TPU kernel. The JAX package builds these chains outside
// Pallas (tuatara_tpu/ops/minarearect.py:117 _lower_chains) as a lax.scan
// over the heatmap rows with a data-dependent while_loop of pops. Ported
// to eager PyTorch that is a host read per pop test (thousands a page), so
// the chains are walked here, one warp a chain.
//
// tt_lower_chains: inputs are a page's dilated row profiles dmin, dmax
// [H, K] fp32 and dval [H, K] bool (K components). Chain b < K is the left
// boundary of component b, over the points (dmin[y, b], y); chain K + b is
// that of the mirrored component, over (-dmax[y, b], y), whose left
// boundary is the right boundary of the real one. Each chain runs JAX's
// loop over y in order: on a valid row it pops while the stack holds two
// points and the turn (top-1, top, new) is not strictly convex toward -x
// (cross >= 0), then pushes. Outputs: hx, hy [2K, H] (row b: the stack
// array as the walk leaves it: entries past the final count keep what was
// last written there, as in JAX's scan, and entries never written are 0)
// and cnt [2K], its final height; equal to the plain version bit for bit,
// every entry written by the kernel (no memset). Coordinates are integers
// below 2^12 held in fp32 and the products below 2^24, so the cross
// product is exact; the __f*_rn intrinsics keep nvcc from contracting it.
//
// What bounds it: the bytes it must move (the profiles in, 9 B a cell; the
// stacks out, 8 B a cell of 2K x H; cnt) take ~1 us at 3.35 TB/s for
// H = 512, K = 256; the walk itself is serial over a chain's valid rows.
// The design spreads the 2K chains over the whole card and keeps each
// chain's serial part short:
// - A warp walks a chain, 4 chains (neighbouring components, so their
//   rows share sectors in L1) a block: 128 blocks at K = 256.
// - Its 32 lanes read 32 rows at a time (the validity and the coordinate
//   of each), 8 such groups a round of 256 rows, and the next round's
//   loads are in flight while the current one is walked. `__ballot_sync`
//   gives the valid rows of 32 at once, and each valid lane writes its
//   point to shared memory at its rank among them: a round's valid points,
//   compacted in row order. So a chain whose component spans a narrow band
//   of rows costs that band.
// - Lane 0 walks the compacted points, the next one's load issued ahead
//   of the current one's pops. The stack lives in shared memory (2 x H
//   floats a warp), its top three points in registers: a push is one
//   shared store, a pop a register move (and one shared load, off the
//   path unless another pop follows).
// - At the end the warp writes its chain's whole rows of hx and hy,
//   coalesced: the stack array up to the highest position ever written,
//   zeros past it; lane 0 writes the count.
//
// The entry point launches on the caller's stream, allocates nothing, does
// not synchronise, and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxWarps = 4;     // chains a block
constexpr int kGroups = 8;       // groups of 32 rows a round
constexpr int kRound = 32 * kGroups;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxSmem = 227 * 1024;

__device__ __forceinline__ float cross(float ox, float oy, float ax, float ay,
                                       float bx, float by) {
  return __fsub_rn(__fmul_rn(__fsub_rn(ax, ox), __fsub_rn(by, oy)),
                   __fmul_rn(__fsub_rn(ay, oy), __fsub_rn(bx, ox)));
}

// Loads round y0's validity and coordinates of column col (rows y0 + 32 g
// + lane); rows past H read as not valid.
__device__ __forceinline__ void load_round(const bool* __restrict__ dval,
                                           const float* __restrict__ src, int y0, int lane,
                                           int H, int K, int col, bool (&v)[kGroups],
                                           float (&x)[kGroups]) {
#pragma unroll
  for (int g = 0; g < kGroups; ++g) {
    const int y = y0 + 32 * g + lane;
    const bool in = y < H;
    const size_t at = (size_t)(in ? y : 0) * K + col;
    v[g] = in && dval[at];
    x[g] = in ? src[at] : 0.f;
  }
}

__global__ void lower_chains_kernel(const float* __restrict__ dmin,
                                    const float* __restrict__ dmax,
                                    const bool* __restrict__ dval,
                                    float* __restrict__ hx, float* __restrict__ hy,
                                    int* __restrict__ cnt, int H, int K) {
  extern __shared__ float smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int b = blockIdx.x * (blockDim.x >> 5) + warp;
  if (b >= 2 * K) return;  // a whole warp; nothing below synchronises the block
  const bool right = b >= K;
  const int col = right ? b - K : b;
  const float* src = right ? dmax : dmin;
  float* sx = smem + (size_t)warp * (2 * H + 2 * kRound);  // the stack array
  float* sy = sx + H;
  float* qx = sy + H;  // a round's valid points, in row order
  float* qy = qx + kRound;
  // The walk's state, kept by lane 0: the stack's height, the highest
  // position written + 1, and its top three points (a on top, then o, u).
  int n = 0, top = 0;
  float ax = 0.f, ay = 0.f, ox = 0.f, oy = 0.f, ux = 0.f, uy = 0.f;
  bool v[kGroups], nv[kGroups];
  float x[kGroups], nx[kGroups];
  load_round(dval, src, 0, lane, H, K, col, v, x);
  for (int y0 = 0; y0 < H; y0 += kRound) {
    if (y0 + kRound < H) load_round(dval, src, y0 + kRound, lane, H, K, col, nv, nx);
    int m = 0;  // the round's valid points
#pragma unroll
    for (int g = 0; g < kGroups; ++g) {
      const unsigned bits = __ballot_sync(kFull, v[g]);
      if (v[g]) {
        const int at = m + __popc(bits & ((1u << lane) - 1));
        qx[at] = right ? -x[g] : x[g];
        qy[at] = (float)(y0 + 32 * g + lane);
      }
      m += __popc(bits);
    }
    __syncwarp();
    if (lane == 0 && m > 0) {
      float px = qx[0], py = qy[0];
      for (int k = 0; k < m; ++k) {
        const float cx = px, cy = py;
        if (k + 1 < m) {  // the next point's load, ahead of this one's pops
          px = qx[k + 1];
          py = qy[k + 1];
        }
        while (n >= 2 && cross(ox, oy, ax, ay, cx, cy) >= 0.0f) {
          --n;
          ax = ox;
          ay = oy;
          ox = ux;
          oy = uy;
          if (n >= 3) {
            ux = sx[n - 3];
            uy = sy[n - 3];
          }
        }
        sx[n] = cx;
        sy[n] = cy;
        ux = ox;
        uy = oy;
        ox = ax;
        oy = ay;
        ax = cx;
        ay = cy;
        ++n;
        top = max(top, n);
      }
    }
    __syncwarp();  // the round's points read before the next round writes them
#pragma unroll
    for (int g = 0; g < kGroups; ++g) {
      v[g] = nv[g];
      x[g] = nx[g];
    }
  }
  top = __shfl_sync(kFull, top, 0);
  float* rx = hx + (size_t)b * H;
  float* ry = hy + (size_t)b * H;
  for (int i = lane; i < H; i += 32) {
    const bool w = i < top;
    rx[i] = w ? sx[i] : 0.f;
    ry[i] = w ? sy[i] : 0.f;
  }
  if (lane == 0) cnt[b] = n;
}

}  // namespace

extern "C" int tt_lower_chains(const void* dmin, const void* dmax, const void* dval,
                               void* hx, void* hy, void* cnt, int H, int K, void* stream) {
  if (H <= 0 || K <= 0) return (int)cudaErrorInvalidValue;
  const long long per_chain = (2LL * H + 2 * kRound) * (long long)sizeof(float);
  if (per_chain > kMaxSmem) return (int)cudaErrorInvalidValue;
  const int warps = (int)(kMaxSmem / per_chain < kMaxWarps ? kMaxSmem / per_chain : kMaxWarps);
  const int smem = (int)(warps * per_chain);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        lower_chains_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int blocks = (2 * K + warps - 1) / warps;
  lower_chains_kernel<<<blocks, warps * 32, smem, (cudaStream_t)stream>>>(
      (const float*)dmin, (const float*)dmax, (const bool*)dval, (float*)hx, (float*)hy,
      (int*)cnt, H, K);
  return (int)cudaGetLastError();
}

// H1: the monotone-chain hulls of the rotated box fit, for Hopper (sm_90a).
//
// Replaces no TPU kernel. The JAX package builds these chains outside
// Pallas (tuatara_tpu/ops/minarearect.py:117 _lower_chains) as a lax.scan
// over the heatmap rows with a data-dependent while_loop of pops. Ported
// to eager PyTorch that is a host read per pop test (thousands a page), so
// the chains are walked here, one thread a chain.
//
// tt_lower_chains: inputs are a page's dilated row profiles dmin, dmax
// [H, K] fp32 and dval [H, K] bool (K components). Chain b < K is the left
// boundary of component b, over the points (dmin[y, b], y); chain K + b is
// that of the mirrored component, over (-dmax[y, b], y), whose left
// boundary is the right boundary of the real one. Each thread runs JAX's
// loop over y in order: on a valid row it pops while the stack holds two
// points and the turn (top-1, top, new) is not strictly convex toward -x
// (cross >= 0), then pushes. The stack lives in the outputs hx, hy [2K, H]
// (row b, zeroed by the caller), and cnt[b] is its final height; entries
// past it keep what was last written there, as in JAX's scan, so the
// outputs equal the plain version bit for bit. Coordinates are integers
// below 2^12 held in fp32 and the products below 2^24, so the cross
// product is exact; the __f*_rn intrinsics keep nvcc from contracting it.
//
// What bounds it: each chain is serial over H rows, so the time is the
// row loop's latency, not bandwidth: the bytes it must move (the profiles
// in, 9 B a cell; the stacks out, 8 B a cell of 2K x H; cnt) take ~0.6 us
// at 3.35 TB/s for H = 512, K = 256. Reads of a row are coalesced (a warp
// takes 32 neighbouring components of one row); the stack tops are
// re-read from L1. One launch a page; 2K threads in blocks of 128.
//
// The entry point launches on the caller's stream, allocates nothing, does
// not synchronise, and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float cross(float ox, float oy, float ax, float ay,
                                       float bx, float by) {
  return __fsub_rn(__fmul_rn(__fsub_rn(ax, ox), __fsub_rn(by, oy)),
                   __fmul_rn(__fsub_rn(ay, oy), __fsub_rn(bx, ox)));
}

__global__ void lower_chains_kernel(const float* __restrict__ dmin,
                                    const float* __restrict__ dmax,
                                    const bool* __restrict__ dval,
                                    float* __restrict__ hx, float* __restrict__ hy,
                                    int* __restrict__ cnt, int H, int K) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= 2 * K) return;
  const bool right = b >= K;
  const int col = right ? b - K : b;
  float* sx = hx + (size_t)b * H;
  float* sy = hy + (size_t)b * H;
  int n = 0;
  for (int y = 0; y < H; ++y) {
    const size_t at = (size_t)y * K + col;
    if (!dval[at]) continue;
    const float x = right ? -dmax[at] : dmin[at];
    const float yf = (float)y;
    while (n >= 2 && cross(sx[n - 2], sy[n - 2], sx[n - 1], sy[n - 1], x, yf) >= 0.0f) --n;
    sx[n] = x;
    sy[n] = yf;
    ++n;
  }
  cnt[b] = n;
}

}  // namespace

extern "C" int tt_lower_chains(const void* dmin, const void* dmax, const void* dval,
                               void* hx, void* hy, void* cnt, int H, int K, void* stream) {
  const int threads = 128;
  const int blocks = (2 * K + threads - 1) / threads;
  lower_chains_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (const float*)dmin, (const float*)dmax, (const bool*)dval, (float*)hx, (float*)hy,
      (int*)cnt, H, K);
  return (int)cudaGetLastError();
}

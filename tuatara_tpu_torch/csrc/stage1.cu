// Fused CRAFT stage-1 tail: conv3x3 + bias + ReLU + 2x2/2 max-pool, for
// Hopper (sm_90a).
//
// Replaces fused_conv_pool (tuatara_tpu/ops/pallas/stage1.py:134): conv1_2
// (3x3, SAME zero padding) over x [B, C, H, W] bf16, + bias, ReLU, and a
// 2x2 stride-2 max-pool, writing only the pooled [B, O, H/2, W/2] bf16.
// x and out are channels_last (memory [B, H, W, C]): the port's trunk holds
// that layout (the canvas is NHWC and the convolutions keep it), so the
// kernel reads and writes it with no permute on either side.
// Numerics as the TPU kernel's: bf16 inputs and weights, fp32 accumulation,
// fp32 bias and ReLU, one rounding to bf16 at the end. ReLU and the bias
// add are monotone, so relu(max(acc) + b) equals max(relu(acc + b)) exactly
// and the pool runs before them.
//
// What bounds it here: operations, barely. At a 1024x768 canvas, B = 1,
// C = O = 64: 2 * 9 * C * O * H * W = 58 GFLOP (0.059 ms at 989 TFLOP/s
// bf16) against (B*H*W*C + B*H/2*W/2*O) * 2 B = 126 MB (0.038 ms at
// 3.35 TB/s).
//
// Design. An implicit GEMM on tensor cores (WMMA m16n16k16, bf16 -> fp32):
// M = the conv output pixels of a 4-row x 64-column tile, N = O = 64,
// K = 9 * C, ordered (tap, channel).
//   * Each CTA is persistent: it stages the [9C, O] weights in shared
//     memory once (74 KB at C = O = 64) and walks tiles with a grid stride.
//   * Per tile, its haloed input band (6 rows x 66 columns x C) is staged
//     in shared memory with channels innermost, zero outside the image, so
//     the A fragment of a tap is 16 neighbouring pixels' 16 channels: a
//     strided load with no im2col buffer. The next tile's band is loaded
//     into registers with 16-byte loads (8 channels of one pixel) while the
//     current tile's products run, and written to shared memory after.
//   * 8 warps; warp w owns conv row w / 2 and 32 of its columns: 2 x 4
//     accumulator tiles over all 9C of K.
//   * Epilogue: the accumulators go to shared memory (over the band, which
//     is dead by then), each thread takes the max of a 2x2 quad, adds the
//     bias, applies ReLU and writes bf16, neighbouring threads on
//     neighbouring channels of one output pixel.
// The TPU kernel's pack-2 im2col layout answers Mosaic's lane-tiling rules
// and is not carried over. Later work: wgmma/TMA, and more than one CTA per
// SM (the weights take 92 KB of shared memory in each).
//
// Launches on the caller's stream, allocates nothing, does not synchronise,
// and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

namespace {

constexpr int kThreads = 256;
constexpr int TH = 4, TW = 64;               // conv output rows x columns per tile
constexpr int BH = TH + 2, BW = TW + 2;      // haloed input band
constexpr int kMaxC = 64, O = 64;  // O: conv1_2's width, the one the path has

__host__ __device__ constexpr int pitch(int c) { return c + 16; }  // 32-byte rows for WMMA
__host__ __device__ constexpr int cpitch(int o) { return o + 4; }  // fp32 epilogue rows

__host__ __device__ constexpr size_t weight_bytes(int c, int o) {
  return sizeof(bf16) * 9 * c * pitch(o);
}

__host__ __device__ constexpr size_t region_bytes(int c, int o) {
  return sizeof(bf16) * BH * BW * pitch(c) > sizeof(float) * TH * TW * cpitch(o)
             ? sizeof(bf16) * BH * BW * pitch(c)
             : sizeof(float) * TH * TW * cpitch(o);
}

__host__ __device__ constexpr size_t smem_bytes(int c, int o) {
  return (weight_bytes(c, o) + 127) / 128 * 128 + region_bytes(c, o);
}

// The band loader. Each thread holds its share of the next tile's band in
// registers (kRegs 16-byte pieces); the loads are issued before the current
// tile's products, so their latency hides under the tensor-core work, and
// the pieces go to shared memory after. Piece i is (row, col, k8) with k8
// fastest: 8 channels of one pixel, so a warp reads neighbouring 16-byte
// pieces of a row and writes them to neighbouring shared words.
constexpr int kRegs = (BH * BW * (kMaxC / 8) + kThreads - 1) / kThreads;  // 13

__device__ __forceinline__ void prefetch(uint4 (&pf)[kRegs], const bf16* xb, int c, int h,
                                         int wd, int y0, int x0) {
  const int k8s = c / 8;
#pragma unroll
  for (int u = 0; u < kRegs; ++u) {
    int i = threadIdx.x + u * kThreads;
    pf[u] = make_uint4(0, 0, 0, 0);
    if (i >= BH * BW * k8s) continue;
    int k8 = i % k8s, rc = i / k8s;
    int col = rc % BW, row = rc / BW;
    int gy = y0 - 1 + row, gx = x0 - 1 + col;
    if (gy < 0 || gy >= h || gx < 0 || gx >= wd) continue;
    pf[u] = __ldg(reinterpret_cast<const uint4*>(xb + ((size_t)gy * wd + gx) * c + 8 * k8));
  }
}

// Band [BH][BW][C] with row pitch pitch(c); written as 16-byte pieces.
__device__ __forceinline__ void store_band(const uint4 (&pf)[kRegs], uint32_t* band, int c) {
  const int wp = pitch(c) / 2;
  const int k8s = c / 8;
#pragma unroll
  for (int u = 0; u < kRegs; ++u) {
    int i = threadIdx.x + u * kThreads;
    if (i >= BH * BW * k8s) continue;
    int k8 = i % k8s, pix = i / k8s;
    *reinterpret_cast<uint4*>(band + pix * wp + 4 * k8) = pf[u];
  }
}

__global__ void __launch_bounds__(kThreads)
    fused_conv_pool(const bf16* __restrict__ x, const bf16* __restrict__ w,
                    const float* __restrict__ bias, bf16* __restrict__ out, int nb, int c, int h,
                    int wd) {
  constexpr int NT = O / 16, OP = pitch(O), CO = cpitch(O);
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* wsm = reinterpret_cast<bf16*>(smem);
  unsigned char* region = smem + (weight_bytes(c, O) + 127) / 128 * 128;
  bf16* band = reinterpret_cast<bf16*>(region);
  float* cbuf = reinterpret_cast<float*>(region);
  const int cp = pitch(c);
  const int warp = threadIdx.x >> 5;

  // Weights [O, C, 3, 3] -> wsm[(tap * C + ci) * OP + o].
  for (int i = threadIdx.x; i < O * c * 9; i += kThreads) {
    int tap = i % 9, oc = i / 9;
    int ci = oc % c, o = oc / c;
    wsm[(tap * c + ci) * OP + o] = w[i];
  }

  const int tiles_x = (wd + TW - 1) / TW, tiles_y = h / TH;
  const int n_tiles = nb * tiles_y * tiles_x;
  const int r = warp >> 1, xs0 = (warp & 1) * 32;
  const size_t image = (size_t)c * h * wd;
  const int ho = h / 2, wo = wd / 2;
  auto origin = [&](int tile, int& b, int& y0, int& x0) {
    const int tx = tile % tiles_x, rest = tile / tiles_x;
    b = rest / tiles_y;
    y0 = (rest % tiles_y) * TH;
    x0 = tx * TW;
  };

  uint4 pf[kRegs];
  if (blockIdx.x < n_tiles) {
    int b, y0, x0;
    origin(blockIdx.x, b, y0, x0);
    prefetch(pf, x + b * image, c, h, wd, y0, x0);
  }
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    int b, y0, x0;
    origin(tile, b, y0, x0);
    __syncthreads();  // the previous tile's epilogue has read cbuf (over band)
    store_band(pf, reinterpret_cast<uint32_t*>(band), c);
    __syncthreads();
    if (tile + gridDim.x < n_tiles) {  // next tile's loads fly during the products
      int nb_, ny0, nx0;
      origin(tile + gridDim.x, nb_, ny0, nx0);
      prefetch(pf, x + nb_ * image, c, h, wd, ny0, nx0);
    }

    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][NT];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int n = 0; n < NT; ++n) wmma::fill_fragment(acc[i][n], 0.f);
    for (int tap = 0; tap < 9; ++tap) {
      const int ky = tap / 3, kx = tap % 3;
      for (int c0 = 0; c0 < c; c0 += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a[2];
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> bw[NT];
#pragma unroll
        for (int i = 0; i < 2; ++i)
          wmma::load_matrix_sync(a[i], &band[((r + ky) * BW + xs0 + 16 * i + kx) * cp + c0], cp);
#pragma unroll
        for (int n = 0; n < NT; ++n)
          wmma::load_matrix_sync(bw[n], &wsm[(tap * c + c0) * OP + 16 * n], OP);
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int n = 0; n < NT; ++n) wmma::mma_sync(acc[i][n], a[i], bw[n], acc[i][n]);
      }
    }
    __syncthreads();  // every warp is done with the band before cbuf overwrites it
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int n = 0; n < NT; ++n)
        wmma::store_matrix_sync(&cbuf[(r * TW + xs0 + 16 * i) * CO + 16 * n], acc[i][n], CO,
                                wmma::mem_row_major);
    __syncthreads();

    // Pool: neighbouring threads on neighbouring channels of one output
    // pixel, so the bf16 stores of a warp are contiguous.
    for (int i = threadIdx.x; i < O * (TH / 2) * (TW / 2); i += kThreads) {
      const int o = i % O, pc = (i / O) % (TW / 2), pr = i / (O * (TW / 2));
      int gx = x0 / 2 + pc, gy = y0 / 2 + pr;
      if (gx >= wo) continue;
      int m = (2 * pr) * TW + 2 * pc;
      float v = fmaxf(fmaxf(cbuf[m * CO + o], cbuf[(m + 1) * CO + o]),
                      fmaxf(cbuf[(m + TW) * CO + o], cbuf[(m + TW + 1) * CO + o]));
      v = fmaxf(v + bias[o], 0.f);
      out[(((size_t)b * ho + gy) * wo + gx) * O + o] = __float2bfloat16(v);
    }
  }
}

}  // namespace

// x [b, c, h, w] bf16, w [64, c, 3, 3] bf16, bias [64] fp32 ->
// out [b, 64, h/2, w/2] bf16; x and out channels_last, x 16-byte aligned.
// c a multiple of 16 up to 64, h % 4 == 0, w even.
extern "C" int tt_fused_conv_pool(const bf16* x, const bf16* w, const float* bias, bf16* out,
                                  int nb, int c, int h, int wd, int o, cudaStream_t stream) {
  if (c % 16 || c < 16 || c > kMaxC || o != O || h % TH || wd % 2 || nb < 1 ||
      reinterpret_cast<uintptr_t>(x) % 16)
    return (int)cudaErrorInvalidValue;
  static bool attr_set = false;
  if (!attr_set) {
    cudaError_t e = cudaFuncSetAttribute(fused_conv_pool,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem_bytes(kMaxC, O));
    if (e != cudaSuccess) return (int)e;
    attr_set = true;
  }
  static int sms = 0;
  if (!sms) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  const int n_tiles = nb * (h / TH) * ((wd + TW - 1) / TW);
  const int grid = n_tiles < sms ? n_tiles : sms;
  fused_conv_pool<<<grid, kThreads, smem_bytes(c, O), stream>>>(x, w, bias, out, nb, c, h, wd);
  return (int)cudaGetLastError();
}

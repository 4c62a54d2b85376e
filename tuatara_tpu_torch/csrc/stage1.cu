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
// Design: an implicit GEMM on wgmma. M = the conv output pixels of a tile
// of 4 rows x 64 columns, N = O = 64, K = 9 taps x C, one 64-channel
// (128-byte) K chunk per tap.
//   * Weights: packed once on the host side (kernels/stage1.py
//     pack_conv_pool_weights) as [9 taps][O][C], each tap an O x 128-byte
//     block already in the 128-byte swizzle that a K-major wgmma B operand
//     reads. Each CTA brings the 72 KB in with nine bulk copies
//     (cp.async.bulk) on one mbarrier and keeps them for every tile.
//   * Bands: a 4-D TMA map over the NHWC activation (C, W, H, B), box
//     (64, 66, 6, 1), 128-byte swizzle: one copy brings a tile's haloed
//     6 x 66-pixel band, each pixel one 128-byte row. The box starts at
//     (x0 - 1, y0 - 1); TMA writes zeros where it lies outside the image,
//     which is the SAME padding with no branch.
//   * Warp roles: one producer warp issues the weight copies and the band
//     copies into a ring of two stages (full / empty mbarriers), so the next
//     tile's band arrives while this one's products run. Two consumer
//     warpgroups: warpgroup g owns conv rows 2g and 2g + 1 of the tile (one
//     pooled row), two m64n64k16 accumulators of 64 pixels each.
//   * A from registers: a tap's A tile is 64 consecutive band pixels
//     starting ky * 66 + kx pixel rows into the band, which is off the
//     1024-byte period of the swizzle for most taps. Each warp loads its
//     16 rows with ldmatrix (the swizzled address computed per lane, no
//     bank conflicts: 8 neighbouring pixels XOR onto 8 different 16-byte
//     columns) and issues wgmma in its A-from-registers form; B (the
//     weights) comes through a shared-memory descriptor. A warpgroup
//     loads a tap's fragments once its previous tap's group has retired;
//     meanwhile the other warpgroup's products keep the tensor cores busy.
//     (Holding a second set of fragments to overlap the loads inside one
//     warpgroup needed more registers than the warpgroup has, spilled, and
//     measured slower.)
//   * Epilogue in registers: the vertical max between the two
//     accumulators, the horizontal max with the neighbouring pixel (row
//     m + 1 of the fragment, held by lane + 4) by a shuffle, then bias and
//     ReLU; the pooled bf16 row (32 pixels x 128 bytes) goes through a
//     4 KB swizzled staging buffer so that the stores to memory are whole
//     128-byte pixel rows, 16 bytes a thread.
//   * Grid: persistent, one CTA per SM (the weights, two band stages and
//     the staging take 181 KB, so a second CTA does not fit), walking tiles
//     with a grid stride.
// The TPU kernel's pack-2 im2col layout answers Mosaic's lane-tiling rules
// and is not carried over.
//
// Launches on the caller's stream, allocates nothing, does not synchronise,
// and returns cudaGetLastError().

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

typedef __nv_bfloat16 bf16;

namespace {

constexpr int C = 64, O = 64;           // conv1_2's widths, the ones the path has
constexpr int TH = 4, TW = 64;          // conv output rows x columns per tile
constexpr int BH = TH + 2, BW = TW + 2;  // haloed band
constexpr int kConsumers = 2;           // warpgroups, one pooled row each
constexpr int kThreads = 128 * kConsumers + 32;
constexpr int kStages = 2;
constexpr uint32_t kTapBytes = O * C * 2;                 // 8 KB: one tap's B
constexpr uint32_t kWeightBytes = 9 * kTapBytes;          // 72 KB
constexpr uint32_t kBandBytes = BH * BW * C * 2;          // 50,688 B
constexpr uint32_t kBandStride = (kBandBytes + 1023) / 1024 * 1024;
constexpr uint32_t kStageOutBytes = (TW / 2) * O * 2;     // one pooled row, 4 KB
constexpr size_t kSmem = 1024 + kWeightBytes + kStages * kBandStride +
                         kConsumers * kStageOutBytes + 8 * (2 * kStages + 1);

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---- mbarrier, bulk copies, ldmatrix and wgmma.

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  const uint32_t a = smem_u32(bar);
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
  } while (!done);
}

// A contiguous global -> shared copy completing on an mbarrier.
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3)
      : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// Shared-memory matrix descriptor, 128-byte swizzle (addresses and offsets
// in bytes, stored in 16-byte units).
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Orders the accumulator registers against the asynchronous wgmma (no
// instruction: the in-out operands keep the compiler from moving reads or
// writes of d across a wgmma fence or wait).
__device__ __forceinline__ void fence_acc(float* d) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// D[64 x 64] += A[64 x 16] (registers, this warp's 16 rows as ldmatrix
// gives them) * B[16 x 64] (K-major, descriptor db); fp32 accumulators.
__device__ __forceinline__ void wgmma_rs(float* d, const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void wg_barrier(int g) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(g + 1) : "memory");
}

// This warp's A fragments of one tap for both of its warpgroup's conv rows:
// a[r][kk] holds band pixels (row0 + r + ky, col + kx), channels
// 16 kk .. 16 kk + 15. Lane l addresses pixel row l % 16 and channel half
// l / 16 of the 16 x 16 tile; the band's 16-byte chunk q of pixel p sits
// at chunk q ^ (p % 8) (TMA's 128-byte swizzle on a 1024-aligned stage).
__device__ __forceinline__ void load_tap(uint32_t (&a)[2][4][4], uint32_t band, int row0,
                                         int col, int tap, int lane) {
  const int ky = tap / 3, kx = tap % 3;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int p = (row0 + r + ky) * BW + col + kx + (lane & 15);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const int q = 2 * kk + (lane >> 4);
      ldsm_x4(a[r][kk], band + p * 128 + ((q ^ (p & 7)) << 4));
    }
  }
}

__global__ void __launch_bounds__(kThreads, 1)
    fused_conv_pool(const __grid_constant__ CUtensorMap xmap, const bf16* __restrict__ wpk,
                    const void* __restrict__ bias, int bias_bf16, bf16* __restrict__ out,
                    int nb, int h, int wd) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* wsm = smem;
  unsigned char* bands = smem + kWeightBytes;
  unsigned char* staging = bands + kStages * kBandStride;
  uint64_t* full = reinterpret_cast<uint64_t*>(staging + kConsumers * kStageOutBytes);
  uint64_t* empty = full + kStages;
  uint64_t* wbar = empty + kStages;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  const int tiles_x = (wd + TW - 1) / TW, tiles_y = h / TH;
  const int n_tiles = nb * tiles_y * tiles_x;
  auto origin = [&](int tile, int& b, int& y0, int& x0) {
    const int tx = tile % tiles_x, rest = tile / tiles_x;
    b = rest / tiles_y;
    y0 = (rest % tiles_y) * TH;
    x0 = tx * TW;
  };

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumers);
    }
    mbar_init(wbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == 4 * kConsumers) {  // producer
    if (lane == 0) {
      mbar_expect_tx(wbar, kWeightBytes);
      for (int t = 0; t < 9; ++t)
        bulk_load(wsm + t * kTapBytes, wpk + t * (kTapBytes / 2), kTapBytes, wbar);
      int it = 0;
      for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x, ++it) {
        const int s = it % kStages;
        if (it >= kStages) mbar_wait(&empty[s], ((it / kStages) & 1) ^ 1);
        int b, y0, x0;
        origin(tile, b, y0, x0);
        mbar_expect_tx(&full[s], kBandBytes);
        tma_load_4d(bands + s * kBandStride, &xmap, &full[s], 0, x0 - 1, y0 - 1, b);
      }
    }
    return;
  }

  // Consumers: warpgroup g, warp wi of it.
  const int g = warp >> 2, wi = warp & 3, tid = threadIdx.x & 127;
  const int ho = h / 2, wo = wd / 2;
  float2 bb[8];  // bias of the channels this lane's fragment holds, in fp32
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int ch = 8 * j + 2 * (lane & 3);
    bb[j] = bias_bf16 ? __bfloat1622float2(reinterpret_cast<const __nv_bfloat162*>(bias)[ch / 2])
                      : reinterpret_cast<const float2*>(bias)[ch / 2];
  }
  const uint32_t w0 = smem_u32(wsm);
  unsigned char* stage_out = staging + g * kStageOutBytes;
  mbar_wait(wbar, 0);

  int it = 0;
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x, ++it) {
    const int s = it % kStages;
    int b, y0, x0;
    origin(tile, b, y0, x0);
    mbar_wait(&full[s], (it / kStages) & 1);
    const uint32_t band = smem_u32(bands + s * kBandStride);

    float acc0[32], acc1[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) acc0[i] = acc1[i] = 0.f;
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      uint32_t a[2][4][4];
      load_tap(a, band, 2 * g, 16 * wi, tap, lane);
      wgmma_fence();
      fence_acc(acc0);
      fence_acc(acc1);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const uint64_t db = smem_desc(w0 + tap * kTapBytes + kk * 32, 16, 1024);
        wgmma_rs(acc0, a[0][kk], db);
        wgmma_rs(acc1, a[1][kk], db);
      }
      wgmma_commit();
      wgmma_wait<0>();  // the group has read a before the next tap overwrites it
      fence_acc(acc0);
      fence_acc(acc1);
    }
    // Every warp of this warpgroup is done with the band, and with the
    // staging buffer of the previous tile.
    wg_barrier(g);
    if (tid == 0) mbar_arrive(&empty[s]);

    // Pool. Lane l holds fragment rows (pixels) m = 16 wi + l / 4 and m + 8,
    // channels 8 j + 2 (l % 4) + {0, 1}: acc[4 j + {0, 1}] row m,
    // acc[4 j + {2, 3}] row m + 8. Pixel m + 1 sits in lane l + 4.
    const bool keeper = !(lane & 4);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      float v[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        v[e] = fmaxf(acc0[4 * j + e], acc1[4 * j + e]);
        v[e] = fmaxf(v[e], __shfl_xor_sync(0xffffffffu, v[e], 4));
      }
      if (keeper) {
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int px = 8 * wi + (lane >> 3) + 4 * hh;
          const __nv_bfloat162 r = __floats2bfloat162_rn(fmaxf(v[2 * hh] + bb[j].x, 0.f),
                                                         fmaxf(v[2 * hh + 1] + bb[j].y, 0.f));
          *reinterpret_cast<__nv_bfloat162*>(stage_out + px * 128 + ((j ^ (px & 7)) << 4) +
                                             (lane & 3) * 4) = r;
        }
      }
    }
    wg_barrier(g);
    // Whole pixel rows out: 32 pooled pixels x 8 16-byte chunks.
    const int gy = y0 / 2 + g;
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const int q = tid + 128 * k, px = q >> 3, ch = q & 7, gx = x0 / 2 + px;
      if (gx < wo)
        *reinterpret_cast<uint4*>(out + (((size_t)b * ho + gy) * wo + gx) * O + 8 * ch) =
            *reinterpret_cast<const uint4*>(stage_out + px * 128 + ((ch ^ (px & 7)) << 4));
    }
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver, through the runtime's entry-point
// query (no link against libcuda).
EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (!fn) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult q = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    cudaError_t e =
        cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &ptr, 12000, cudaEnableDefault, &q);
#else
    cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &q);
#endif
    if (e == cudaSuccess && q == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiled>(ptr);
  }
  return fn;
}

}  // namespace

// x [b, 64, h, w] bf16 channels_last, wpk the packed weights
// ([9][64][64] bf16, pack_conv_pool_weights), bias [64] bf16 (bias_bf16 != 0)
// or fp32 -> out [b, 64, h/2, w/2] bf16 channels_last. h % 4 == 0, w even;
// x, wpk and out 16-byte aligned, bias 8-byte aligned.
extern "C" int tt_fused_conv_pool(const bf16* x, const bf16* wpk, const void* bias, bf16* out,
                                  int nb, int c, int h, int wd, int o, int bias_bf16,
                                  cudaStream_t stream) {
  if (c != C || o != O || h % TH || wd % 2 || nb < 1 ||
      (reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(wpk) |
       reinterpret_cast<uintptr_t>(out)) % 16 ||
      reinterpret_cast<uintptr_t>(bias) % 8)
    return (int)cudaErrorInvalidValue;
  static int sms = 0;
  if (!sms) {
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(fused_conv_pool, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)kSmem);
    if (e != cudaSuccess) {
      sms = 0;
      return (int)e;
    }
  }
  EncodeTiled enc = encoder();
  if (!enc) return (int)cudaErrorNotSupported;
  CUtensorMap xmap;
  const cuuint64_t dims[4] = {(cuuint64_t)C, (cuuint64_t)wd, (cuuint64_t)h, (cuuint64_t)nb};
  const cuuint64_t strides[3] = {(cuuint64_t)C * 2, (cuuint64_t)wd * C * 2,
                                 (cuuint64_t)h * wd * C * 2};
  const cuuint32_t box[4] = {C, BW, BH, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  if (enc(&xmap, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<bf16*>(x), dims, strides, box,
          unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
          CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return (int)cudaErrorNotSupported;
  const int n_tiles = nb * (h / TH) * ((wd + TW - 1) / TW);
  const int grid = n_tiles < sms ? n_tiles : sms;
  fused_conv_pool<<<grid, kThreads, kSmem, stream>>>(xmap, wpk, bias, bias_bf16, out, nb, h,
                                                     wd);
  return (int)cudaGetLastError();
}

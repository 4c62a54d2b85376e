// Fused ViT encoder blocks (PARSEQ's ViT-S), for Hopper (sm_90a).
//
// Replaces vit_blocks_pallas (tuatara_tpu/ops/pallas/vit.py:181): every
// stacked pre-norm block over x [N, S, D] fp32,
//   h = LN1(x) -> bf16;  qkv = h @ Wqkv + b -> bf16
//   per crop and head: P = softmax(q k^T / sqrt(hd)) (fp32) -> bf16;
//                      att = P v -> bf16
//   x += att @ Wo + bo
//   h = LN2(x) -> bf16;  hmid = gelu_tanh(h @ W1 + b1) -> bf16
//   x += hmid @ W2 + b2
// with bf16 operands, fp32 accumulation, fp32 LayerNorm and softmax and
// the fp32 residual stream, as the TPU kernel's body computes it.
//
// What bounds it here: operations. One block over one crop is
// 2 * (12 * S * D^2 + 2 * S^2 * D) = 0.478 GFLOP at S = 128, D = 384; twelve
// blocks over N = 32 crops are 184 GFLOP for ~55 MB of weights and fp32
// activations in and out, far above the card's 295 FLOP/byte balance point,
// so the tensor cores set the floor (0.19 ms at N = 32, 989 TFLOP/s bf16).
//
// Design. The TPU kernel keeps a tile of crops resident in VMEM across
// blocks; on this card one crop's fp32 residual (196 KB) plus its MLP
// intermediate (393 KB) exceed a block's 227 KB of shared memory, so each
// block is five launches over activations that stay in L2 / HBM:
//   gemm (LN1)   qkv = LN1(x) @ Wqkv + b: the LayerNorm runs in the GEMM's
//                prologue. A CTA reads its 64-row fp32 panel of x, computes
//                each row's mean and rstd in fp32 and writes the normalised
//                panel once as bf16 into shared memory (64 rows x D), in the
//                128-byte swizzled K-major layout wgmma reads; the panel
//                stays for the whole K loop, and for every column tile the
//                CTA computes, while only B streams;
//   attention    one CTA per (crop, head): Q, K, V [S x 64] bf16 in shared
//                memory, S = Q K^T and P V on tensor cores (mma.sync), the
//                fp32 softmax between them in registers; instantiated for
//                S = 64 and 128;
//   gemm         x += att @ Wo + bo;
//   gemm (LN2)   hmid = gelu_tanh(LN2(x) @ W1 + b1);
//   gemm         x += hmid @ W2 + b2.
// Every GEMM is wgmma.mma_async (m64nNk16, bf16 operands, fp32
// accumulators in registers) on tiles that TMA (cp.async.bulk.tensor)
// brings into a ring of 128-byte swizzled shared-memory stages: one
// producer warp starts the copies and completes each stage on an mbarrier,
// one consumer warpgroup multiplies and releases the stage on a second
// mbarrier once the wgmma group that read it has retired. The weights are
// [in, out] with the output columns contiguous (N-major), which wgmma reads
// as a transposed B operand; the activations are K-major. Tiles: 64 x 192
// for the LN GEMMs (64 x 128 for an MLP width that 192 does not divide;
// two CTAs per SM), each CTA taking the fewest
// neighbouring column tiles that keep the grid within one wave, so that a
// panel is normalised once for several tiles (the prologue is bound by the
// latency of its row loads and reductions, not by the tensor cores); 64 x 64
// for the two D-wide products, whose A also streams (192 CTAs at N = 16
// crops, three a SM). Epilogues straight from the accumulator fragment:
// bias -> bf16, bias + tanh-GELU -> bf16, or bias + residual into the fp32
// stream (each element owned by one thread, no atomics, so the sums are the
// same in every run). TMA descriptors are encoded on the host for each call
// (cuTensorMapEncodeTiled, obtained from the runtime with
// cudaGetDriverEntryPoint, so no -lcuda) and passed as __grid_constant__
// parameters. N * S must be a multiple of 128 (an even N at S = 64).
//
// Launches on the caller's stream, allocates nothing, does not synchronise,
// and returns cudaGetLastError().

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

typedef __nv_bfloat16 bf16;

namespace {

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// 0.5 v (1 + tanh(u)) with u = sqrt(2 / pi) (v + 0.044715 v^3), written as
// v / (1 + exp(-2 u)) (the same function; tanhf costs ~20 instructions).
// u is held above -40 (the result is then below 1e-33 in magnitude) so the
// divisor stays finite and the fast division applies: an IEEE division by
// a huge divisor takes a slow path many times longer.
__device__ __forceinline__ float gelu_tanh(float v) {
  const float u = fmaxf(0.7978845608028654f * (v + 0.044715f * v * v * v), -40.0f);
  return __fdividef(v, 1.0f + __expf(-2.0f * u));
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(smem)), "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// ---- mbarrier, TMA and wgmma primitives.

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
// Spin until the phase of the given parity has completed.
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

__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1)
      : "memory");
}
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// Shared-memory matrix descriptor, 128-byte swizzle: start address, leading
// and stride byte offsets (all in bytes here, stored in 16-byte units).
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
// instruction: the asm's in-out operands keep the compiler from moving
// reads or writes of d across a wgmma fence or wait).
template <int N>
__device__ __forceinline__ void fence_acc(float* d) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// D[64 x N] += A[64 x 16] (K-major, descriptor da) * B[16 x N] (N-major,
// the transposed operand, descriptor db); fp32 accumulators, d[N / 2] per
// thread of the warpgroup.
__device__ __forceinline__ void wgmma_n64(float* d, uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_n128(float* d, uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_n192(float* d, uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %98, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95"
      "}, %96, %97, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95])
      : "l"(da), "l"(db), "r"(1));
}

template <int BN>
__device__ __forceinline__ void wgmma_tile(float* d, uint64_t da, uint64_t db) {
  if constexpr (BN == 64) wgmma_n64(d, da, db);
  else if constexpr (BN == 128) wgmma_n128(d, da, db);
  else wgmma_n192(d, da, db);
}

// ---- GEMM: out[M, N] (+)= A[M, K] @ B[K, N] + bias, B one block's slice
// of the stacked [blocks, K, N] weights.
enum { kEpiBf16 = 0, kEpiGeluBf16 = 1, kEpiResidual = 2 };
constexpr int BK = 64;  // one 128-byte swizzle row of bf16
constexpr int BM = 64;  // rows of a CTA's tiles: one consumer warpgroup
constexpr int kGemmThreads = 160;  // the consumer warpgroup and a producer warp
// Ring depth: A and B stream through 4 stages; with the LN panel resident
// only B streams, and 2 stages keep up with its short K loop (K = D).
__host__ __device__ constexpr int stages(bool ln) { return ln ? 2 : 4; }
constexpr int kLnRows = 8;  // rows whose loads a warp keeps in flight in the LN prologue

struct GemmArgs {
  const float* x;  // LN prologue: the fp32 stream [M, K], normalised into A
  const float* ln_g;
  const float* ln_b;
  const float* bias;  // [N]
  void* out;          // [M, N] bf16, or the fp32 stream for kEpiResidual
  int n, k, blk;
  float eps;
  int tiles;  // neighbouring column tiles a CTA computes
};

// Bytes of dynamic shared memory: the 1024-byte alignment slack, A (the
// whole normalised panel for LN, else a ring of BM x 64 stages), the ring
// of 64 x BN stages of B, and the full / empty barriers.
constexpr size_t gemm_smem(int bn, bool ln, int k) {
  return 1024 + (ln ? (size_t)BM * k * 2 : (size_t)stages(ln) * BM * 128) +
         (size_t)stages(ln) * bn * 128 + 2 * stages(ln) * 8;
}

// LN prologue: the CTA's BM rows of x, normalised in fp32 and rounded once
// to bf16, written into the panel in the 128-byte swizzled K-major layout
// wgmma reads (64-column chunks of BM rows x 128 bytes, 16-byte groups
// XOR-ed with row % 8). Each consumer warp takes 16 rows, kLnRows at a time
// with all their loads in flight (the prologue is bound by the latency of
// those loads and of the row reductions, so rows are batched, not looped).
__device__ __forceinline__ void ln_panel(const GemmArgs& p, int m0, unsigned char* panel) {
  const int lane = threadIdx.x & 31, K = p.k, kq = K / 128;
  const int row_base = (threadIdx.x >> 5) * 16;
  for (int rb = 0; rb < 16; rb += kLnRows) {
    float4 v[kLnRows][3];
    float mean[kLnRows], rstd[kLnRows];
    // Pass 1: sums over segments of 384 columns (3 float4 a lane).
    float s[kLnRows];
#pragma unroll
    for (int r = 0; r < kLnRows; ++r) s[r] = 0.f;
    for (int seg = 0; seg < kq; seg += 3) {
#pragma unroll
      for (int r = 0; r < kLnRows; ++r) {
        const float4* xr = reinterpret_cast<const float4*>(
            p.x + (size_t)(m0 + row_base + rb + r) * K);
#pragma unroll
        for (int q = 0; q < 3; ++q) {
          v[r][q] = seg + q < kq ? xr[lane + 32 * (seg + q)] : make_float4(0.f, 0.f, 0.f, 0.f);
          s[r] += (v[r][q].x + v[r][q].y) + (v[r][q].z + v[r][q].w);
        }
      }
    }
#pragma unroll
    for (int r = 0; r < kLnRows; ++r) mean[r] = warp_sum(s[r]) / K;
    // Pass 2: the biased variance about the mean; a row wider than one
    // segment is read again.
#pragma unroll
    for (int r = 0; r < kLnRows; ++r) s[r] = 0.f;
    for (int seg = 0; seg < kq; seg += 3) {
#pragma unroll
      for (int r = 0; r < kLnRows; ++r) {
        const float4* xr = reinterpret_cast<const float4*>(
            p.x + (size_t)(m0 + row_base + rb + r) * K);
#pragma unroll
        for (int q = 0; q < 3; ++q) {
          if (seg + q >= kq) continue;
          if (kq > 3) v[r][q] = xr[lane + 32 * (seg + q)];
          const float a = v[r][q].x - mean[r], b = v[r][q].y - mean[r];
          const float c = v[r][q].z - mean[r], e = v[r][q].w - mean[r];
          s[r] += (a * a + b * b) + (c * c + e * e);
        }
      }
    }
#pragma unroll
    for (int r = 0; r < kLnRows; ++r) rstd[r] = rsqrtf(warp_sum(s[r]) / K + p.eps);
    // Pass 3: (x - mean) * rstd * g + b, rounded once to bf16.
    for (int seg = 0; seg < kq; seg += 3) {
#pragma unroll
      for (int q = 0; q < 3; ++q) {
        if (seg + q >= kq) continue;
        const int c4 = lane + 32 * (seg + q);
        const float4 g = reinterpret_cast<const float4*>(p.ln_g)[c4];
        const float4 b = reinterpret_cast<const float4*>(p.ln_b)[c4];
        const int col = 4 * c4, chunk = col >> 6, grp = (col & 63) >> 3, half = (col >> 2) & 1;
#pragma unroll
        for (int r = 0; r < kLnRows; ++r) {
          const int lr = row_base + rb + r;
          float4 x = v[r][q];
          if (kq > 3)
            x = reinterpret_cast<const float4*>(p.x + (size_t)(m0 + lr) * K)[c4];
          __nv_bfloat162 lo = __floats2bfloat162_rn((x.x - mean[r]) * rstd[r] * g.x + b.x,
                                                    (x.y - mean[r]) * rstd[r] * g.y + b.y);
          __nv_bfloat162 hi = __floats2bfloat162_rn((x.z - mean[r]) * rstd[r] * g.z + b.z,
                                                    (x.w - mean[r]) * rstd[r] * g.w + b.w);
          uint2 packed;
          packed.x = *reinterpret_cast<uint32_t*>(&lo);
          packed.y = *reinterpret_cast<uint32_t*>(&hi);
          const size_t off = (size_t)chunk * BM * 128 + lr * 128 + ((grp ^ (lr & 7)) << 4) +
                             half * 8;
          *reinterpret_cast<uint2*>(panel + off) = packed;
        }
      }
    }
  }
}

// Epilogue of one 64 x BN accumulator fragment (rows r0.., columns n0..):
// thread (warp w, lane l) holds rows 16 w + l / 4 (+ 8) and columns
// 8 j + 2 (l % 4) (+ 1).
template <int BN, int EPI>
__device__ __forceinline__ void epilogue(const GemmArgs& p, const float* acc, int r0, int n0) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row0 = r0 + (warp & 3) * 16 + (lane >> 2), col0 = n0 + 2 * (lane & 3);
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int col = col0 + 8 * j;
    const float2 bb = *reinterpret_cast<const float2*>(p.bias + col);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const size_t o = (size_t)(row0 + 8 * h) * p.n + col;
      const float v0 = acc[4 * j + 2 * h] + bb.x, v1 = acc[4 * j + 2 * h + 1] + bb.y;
      if constexpr (EPI == kEpiResidual) {
        float2* y = reinterpret_cast<float2*>(static_cast<float*>(p.out) + o);
        float2 t = *y;
        t.x += v0;
        t.y += v1;
        *y = t;
      } else if constexpr (EPI == kEpiGeluBf16) {
        *reinterpret_cast<__nv_bfloat162*>(static_cast<bf16*>(p.out) + o) =
            __floats2bfloat162_rn(gelu_tanh(v0), gelu_tanh(v1));
      } else {
        *reinterpret_cast<__nv_bfloat162*>(static_cast<bf16*>(p.out) + o) =
            __floats2bfloat162_rn(v0, v1);
      }
    }
  }
}

// One CTA: p.tiles neighbouring 64 x BN output tiles of the same rows, one
// consumer warpgroup and one producer warp. LN: A is
// LN(x) built once in shared memory (K = D) and kept for every tile;
// otherwise A streams through the ring with B. The ring runs on across the
// tiles, so the next tile's B loads overlap this tile's epilogue.
template <int BN, bool LN, int EPI>
__global__ void __launch_bounds__(kGemmThreads)
    gemm_kernel(const __grid_constant__ CUtensorMap tma_a,
                const __grid_constant__ CUtensorMap tma_b, const GemmArgs p) {
  constexpr int kStages = stages(LN);
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const int K = p.k, nk = K / BK;
  unsigned char* a_buf = smem;
  unsigned char* b_buf = smem + (LN ? (size_t)BM * K * 2 : (size_t)kStages * BM * 128);
  uint64_t* full = reinterpret_cast<uint64_t*>(b_buf + kStages * BN * 128);
  uint64_t* empty = full + kStages;
  const int m0 = blockIdx.y * BM, tile0 = blockIdx.x * p.tiles;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 1);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == 4) {  // producer
    if (lane == 0) {
      for (int it = 0; it < p.tiles * nk; ++it) {  // k-tile it % nk of tile it / nk
        const int s = it % kStages, kt = it % nk, n0 = (tile0 + it / nk) * BN;
        if (it >= kStages) mbar_wait(&empty[s], ((it / kStages) & 1) ^ 1);
        mbar_expect_tx(&full[s], (LN ? 0 : BM * 128) + BN * 128);
        if (!LN) tma_load_2d(a_buf + s * BM * 128, &tma_a, &full[s], kt * BK, m0);
#pragma unroll
        for (int j = 0; j < BN / 64; ++j)
          tma_load_3d(b_buf + (size_t)(s * BN + j * 64) * 128, &tma_b, &full[s], n0 + j * 64,
                      kt * BK, p.blk);
      }
    }
    return;
  }

  if constexpr (LN) {
    ln_panel(p, m0, a_buf);
    // The panel's generic-proxy stores must be visible to wgmma (async
    // proxy), and every consumer warp's rows written.
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    asm volatile("bar.sync 1, 128;\n" ::: "memory");
  }

  const uint32_t a0 = smem_u32(a_buf), b0 = smem_u32(b_buf);
  for (int t = 0; t < p.tiles; ++t) {
    float acc[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
    fence_acc<BN / 2>(acc);
    for (int kt = 0; kt < nk; ++kt) {
      const int it = t * nk + kt, s = it % kStages;
      mbar_wait(&full[s], (it / kStages) & 1);
      const uint32_t a_addr = a0 + (LN ? kt : s) * BM * 128;
      const uint32_t b_addr = b0 + s * BN * 128;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
        wgmma_tile<BN>(acc, smem_desc(a_addr + kk * 32, 16, 1024),
                       smem_desc(b_addr + kk * 2048, 64 * 128, 1024));
      wgmma_commit();
      wgmma_wait<1>();  // the group of k-tile it - 1 has retired: release its stage
      if (kt > 0 && threadIdx.x == 0) mbar_arrive(&empty[(it - 1) % kStages]);
    }
    wgmma_wait<0>();
    fence_acc<BN / 2>(acc);
    if (threadIdx.x == 0) mbar_arrive(&empty[(t * nk + nk - 1) % kStages]);
    epilogue<BN, EPI>(p, acc, m0, (tile0 + t) * BN);
  }
}

// ---- Attention: one CTA per (crop, head), S tokens (64 or 128), head width
// 64; one warp per 16 query rows, so S / 16 warps. Q, K, V [S x 64] bf16 in
// shared memory; a warp's scores (16 x S), the softmax and the
// probabilities stay in the registers of its mma.sync fragments (m16n8k16,
// operands loaded with ldmatrix): the score fragment of two neighbouring
// 8-key tiles is the A fragment of P V.
constexpr int HD = 64;
constexpr int LDQ = HD + 8;

template <int S>
struct Attn {
  static constexpr int kWarps = S / 16;
  static constexpr int kThreads = kWarps * 32;
  static constexpr size_t kSmem = sizeof(bf16) * 3 * S * LDQ;
};

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}
// d[0..4) += A (16 x 16, fragment a) * B (16 x 8, fragment b0, b1).
__device__ __forceinline__ void mma16816(float* d, const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

template <int S>
__global__ void __launch_bounds__(Attn<S>::kThreads)
    attention(const bf16* __restrict__ qkv, bf16* __restrict__ att, int d, int heads,
              float scale) {
  constexpr int nthreads = Attn<S>::kThreads, NT = S / 8;  // 8-key tiles
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* Ks = Qs + S * LDQ;
  bf16* Vs = Ks + S * LDQ;

  const int crop = blockIdx.x / heads, h = blockIdx.x % heads;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const bf16* base = qkv + (size_t)crop * S * 3 * d;
  for (int c = threadIdx.x; c < 3 * S * HD / 8; c += nthreads) {
    int mat = c / (S * HD / 8), rem = c % (S * HD / 8);
    int r = rem >> 3, cc = (rem & 7) * 8;
    cp_async16(&Qs[mat * S * LDQ + r * LDQ + cc], base + (size_t)r * 3 * d + mat * d + h * HD + cc);
  }
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  // Scores: this warp's 16 query rows against every key. Lane l holds rows
  // l / 4 and l / 4 + 8, keys 8 j + 2 (l % 4) (+ 1) of tile j.
  const int r0 = warp * 16;
  float sc[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j) sc[j][0] = sc[j][1] = sc[j][2] = sc[j][3] = 0.f;
#pragma unroll
  for (int kk = 0; kk < HD; kk += 16) {
    uint32_t a[4];
    ldsm_x4(a, Qs + (r0 + (lane & 15)) * LDQ + kk + (lane >> 4) * 8);
#pragma unroll
    for (int j = 0; j < NT; j += 2) {  // keys 8 j .. 8 j + 16: K rows are B's columns
      uint32_t b[4];
      ldsm_x4(b, Ks + (8 * j + (lane & 7) + ((lane >> 4) << 3)) * LDQ + kk + ((lane >> 3) & 1) * 8);
      mma16816(sc[j], a, b[0], b[1]);
      mma16816(sc[j + 1], a, b[2], b[3]);
    }
  }

  // Softmax in fp32 over each row (its keys spread over the lane's quad),
  // then the probabilities rounded to bf16 as P V's A fragments.
  float mx[2] = {-INFINITY, -INFINITY}, sum[2] = {0.f, 0.f};
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      sc[j][e] *= scale;
      mx[e >> 1] = fmaxf(mx[e >> 1], sc[j][e]);
    }
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int o = 1; o < 4; o <<= 1) mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], o));
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      sc[j][e] = expf(sc[j][e] - mx[e >> 1]);
      sum[e >> 1] += sc[j][e];
    }
  // Times the reciprocal: a division whose quotient is subnormal (the far
  // tail of a peaked softmax) takes a slow path many times longer.
  float inv[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int o = 1; o < 4; o <<= 1) sum[i] += __shfl_xor_sync(0xffffffffu, sum[i], o);
    inv[i] = 1.0f / sum[i];
  }

  // att = P V: keys are P's columns (A fragments from two score tiles) and
  // V's rows (B fragments, transposed loads of the row-major V).
  float o[HD / 8][4];
#pragma unroll
  for (int n = 0; n < HD / 8; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
#pragma unroll
  for (int j = 0; j < NT; j += 2) {
    uint32_t a[4] = {pack_bf16(sc[j][0] * inv[0], sc[j][1] * inv[0]),
                     pack_bf16(sc[j][2] * inv[1], sc[j][3] * inv[1]),
                     pack_bf16(sc[j + 1][0] * inv[0], sc[j + 1][1] * inv[0]),
                     pack_bf16(sc[j + 1][2] * inv[1], sc[j + 1][3] * inv[1])};
#pragma unroll
    for (int n = 0; n < HD / 8; n += 2) {
      uint32_t b[4];
      ldsm_x4_t(b, Vs + (8 * j + (lane & 15)) * LDQ + 8 * n + (lane >> 4) * 8);
      mma16816(o[n], a, b[0], b[1]);
      mma16816(o[n + 1], a, b[2], b[3]);
    }
  }
  bf16* dst = att + ((size_t)crop * S + r0 + (lane >> 2)) * d + h * HD + 2 * (lane & 3);
#pragma unroll
  for (int n = 0; n < HD / 8; ++n) {
    *reinterpret_cast<__nv_bfloat162*>(dst + 8 * n) = __floats2bfloat162_rn(o[n][0], o[n][1]);
    *reinterpret_cast<__nv_bfloat162*>(dst + 8 * (size_t)d + 8 * n) =
        __floats2bfloat162_rn(o[n][2], o[n][3]);
  }
}

template <int S>
cudaError_t set_attention_smem() {
  return cudaFuncSetAttribute(attention<S>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)Attn<S>::kSmem);
}

template <int S>
void launch_attention(const bf16* qkv, bf16* att, int n, int d, int heads, float scale,
                      cudaStream_t stream) {
  attention<S><<<n * heads, Attn<S>::kThreads, Attn<S>::kSmem, stream>>>(qkv, att, d, heads,
                                                                        scale);
}

// ---- Host: TMA descriptors and GEMM launches.

constexpr size_t kMaxSmem = 232448;  // a block's opt-in shared memory on sm_90

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

// A bf16 [depth, rows, cols] tensor (rank 2 when depth is 0), read in
// boxes of 64 columns (128 bytes, swizzled) x box_rows rows.
bool make_map(CUtensorMap* map, const void* base, int cols, int rows, int depth, int box_rows) {
  EncodeTiled enc = encoder();
  if (!enc) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)cols, (cuuint64_t)rows, (cuuint64_t)(depth ? depth : 1)};
  const cuuint64_t strides[2] = {(cuuint64_t)cols * 2, (cuuint64_t)rows * cols * 2};
  const cuuint32_t box[3] = {64, (cuuint32_t)box_rows, 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, depth ? 3 : 2, const_cast<void*>(base), dims,
             strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int BN, bool LN, int EPI>
cudaError_t launch_gemm(const CUtensorMap& a, const CUtensorMap& b, const GemmArgs& p, int m,
                        cudaStream_t stream) {
  const size_t smem = gemm_smem(BN, LN, p.k);
  static size_t attr_bytes = 0;
  if (smem > attr_bytes) {
    cudaError_t e = cudaFuncSetAttribute(gemm_kernel<BN, LN, EPI>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
    attr_bytes = smem;
  }
  gemm_kernel<BN, LN, EPI><<<dim3(p.n / BN / p.tiles, m / BM), kGemmThreads, smem, stream>>>(a, b,
                                                                                            p);
  return cudaGetLastError();
}

// The LN-prologue GEMMs. A CTA normalises its 64 rows once and computes
// the fewest neighbouring column tiles that keep the grid within one wave
// of resident CTAs (SMs x CTAs per SM): more tiles per CTA means fewer
// recomputed panels, fewer means more CTAs in flight.
template <int BN, int EPI>
cudaError_t launch_ln_gemm(const CUtensorMap& b, GemmArgs p, int m, cudaStream_t stream) {
  const size_t smem = gemm_smem(BN, true, p.k);
  static int slots = 0;
  if (!slots) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(gemm_kernel<BN, true, EPI>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kMaxSmem);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, gemm_kernel<BN, true, EPI>,
                                                        kGemmThreads, smem);
    if (e != cudaSuccess) return e;
    slots = sms * (per_sm > 0 ? per_sm : 1);
  }
  const int n_tiles = p.n / BN;
  p.tiles = n_tiles;
  for (int t = 1; t <= n_tiles; ++t)
    if (n_tiles % t == 0 && (n_tiles / t) * (m / BM) <= slots) {
      p.tiles = t;
      break;
    }
  return launch_gemm<BN, true, EPI>(b, b, p, m, stream);
}

}  // namespace

// x [n*s, d] fp32 (s = 64 or 128 tokens per crop, n*s a multiple of 128) is
// updated in place; qkv, att, hmid are scratch.
// Weights carry a leading block dimension (stack_vit_block_weights).
extern "C" int tt_vit_blocks(float* x, bf16* qkv, bf16* att, bf16* hmid, const bf16* qkv_w,
                             const float* qkv_b, const bf16* o_w, const float* o_b,
                             const bf16* f1_w, const float* f1_b, const bf16* f2_w,
                             const float* f2_b, const float* ln1_g, const float* ln1_b,
                             const float* ln2_g, const float* ln2_b, int n_blocks, int n, int s,
                             int d, int heads, int hidden, float eps, cudaStream_t stream) {
  if (d != heads * HD || d % 128 || hidden % 128 || d > 1024 || (s != 64 && s != 128) ||
      (n * s) % 128 || n_blocks < 1 || gemm_smem(192, true, d) > kMaxSmem)
    return (int)cudaErrorInvalidValue;
  static bool attr_set[2] = {false, false};
  if (!attr_set[s == 128]) {
    cudaError_t e = s == 128 ? set_attention_smem<128>() : set_attention_smem<64>();
    if (e != cudaSuccess) return (int)e;
    attr_set[s == 128] = true;
  }
  const int m = n * s;
  CUtensorMap m_att, m_hmid, m_qkv_w, m_o_w, m_f1_w, m_f2_w;
  if (!make_map(&m_att, att, d, m, 0, 64) || !make_map(&m_hmid, hmid, hidden, m, 0, 64) ||
      !make_map(&m_qkv_w, qkv_w, 3 * d, d, n_blocks, BK) ||
      !make_map(&m_o_w, o_w, d, d, n_blocks, BK) ||
      !make_map(&m_f1_w, f1_w, hidden, d, n_blocks, BK) ||
      !make_map(&m_f2_w, f2_w, d, hidden, n_blocks, BK))
    return (int)cudaErrorNotSupported;
  const float scale = 1.0f / sqrtf((float)HD);
  cudaError_t e = cudaSuccess;
  for (int blk = 0; blk < n_blocks && e == cudaSuccess; ++blk) {
    const GemmArgs pq{x, ln1_g + (size_t)blk * d, ln1_b + (size_t)blk * d,
                      qkv_b + (size_t)blk * 3 * d, qkv, 3 * d, d, blk, eps};
    e = launch_ln_gemm<192, kEpiBf16>(m_qkv_w, pq, m, stream);
    if (e != cudaSuccess) break;
    if (s == 128)
      launch_attention<128>(qkv, att, n, d, heads, scale, stream);
    else
      launch_attention<64>(qkv, att, n, d, heads, scale, stream);
    const GemmArgs po{nullptr, nullptr, nullptr, o_b + (size_t)blk * d, x, d, d, blk, eps, 1};
    e = launch_gemm<64, false, kEpiResidual>(m_att, m_o_w, po, m, stream);
    if (e != cudaSuccess) break;
    const GemmArgs p1{x, ln2_g + (size_t)blk * d, ln2_b + (size_t)blk * d,
                      f1_b + (size_t)blk * hidden, hmid, hidden, d, blk, eps};
    e = hidden % 192 == 0 ? launch_ln_gemm<192, kEpiGeluBf16>(m_f1_w, p1, m, stream)
                          : launch_ln_gemm<128, kEpiGeluBf16>(m_f1_w, p1, m, stream);
    if (e != cudaSuccess) break;
    const GemmArgs p2{nullptr, nullptr, nullptr, f2_b + (size_t)blk * d, x, d, hidden, blk, eps, 1};
    e = launch_gemm<64, false, kEpiResidual>(m_hmid, m_f2_w, p2, m, stream);
  }
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

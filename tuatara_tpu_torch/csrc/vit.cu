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
// blocks over N = 32 crops are 184 GFLOP for ~55 MB of weights (42.5 MB)
// and fp32 activations in and out, far above the card's 295 FLOP/byte
// balance point, so the tensor cores set the floor (0.19 ms at N = 32,
// 989 TFLOP/s bf16).
//
// Design. The TPU kernel keeps a tile of crops resident in VMEM across
// blocks; on this card one crop's fp32 residual (196 KB) plus its MLP
// intermediate (393 KB) exceed a block's 227 KB of shared memory, so each
// block is seven launches over activations that stay in L2 / HBM:
//   ln_bf16      one warp per row;
//   gemm_bf16    128x128x32 tiles on tensor cores (WMMA m16n16k16 bf16,
//                fp32 accumulators), cp.async double buffering, and an
//                epilogue of bias -> bf16, bias + tanh-GELU -> bf16, or
//                bias + residual add into the fp32 stream;
//   attention    one CTA per (crop, head): Q, K, V [S x 64] bf16 in
//                shared memory, S = Q K^T and P V on tensor cores, the
//                fp32 softmax between them; instantiated for S = 64 and
//                128 tokens per crop (the 32x64 and 32x128 crops).
// The GEMM tiles need N * S to be a multiple of 128 (an even N at S = 64).
// Later work: wgmma/TMA GEMMs and LayerNorm fused into the GEMM prologue.
//
// Launches on the caller's stream, allocates nothing, does not synchronise,
// and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

namespace {

constexpr int kThreads = 256;

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

__device__ __forceinline__ float gelu_tanh(float v) {
  return 0.5f * v * (1.0f + tanhf(0.7978845608028654f * (v + 0.044715f * v * v * v)));
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// ---- LayerNorm: x [rows, d] fp32 -> out bf16; one warp per row, d <= 1024.
__global__ void ln_bf16(const float* __restrict__ x, const float* __restrict__ g,
                        const float* __restrict__ b, bf16* __restrict__ out, int rows, int d,
                        float eps) {
  int row = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  int lane = threadIdx.x & 31;
  if (row >= rows) return;
  const float* xr = x + (size_t)row * d;
  float v[32];
  float s = 0.f;
#pragma unroll
  for (int k = 0; k < 32; ++k) {
    int c = lane + 32 * k;
    v[k] = c < d ? xr[c] : 0.f;
    s += v[k];
  }
  float mean = warp_sum(s) / d;
  float q = 0.f;
#pragma unroll
  for (int k = 0; k < 32; ++k) {
    int c = lane + 32 * k;
    float t = v[k] - mean;
    if (c < d) q += t * t;
  }
  float rstd = rsqrtf(warp_sum(q) / d + eps);
  bf16* o = out + (size_t)row * d;
#pragma unroll
  for (int k = 0; k < 32; ++k) {
    int c = lane + 32 * k;
    if (c < d) o[c] = __float2bfloat16((v[k] - mean) * rstd * g[c] + b[c]);
  }
}

// ---- GEMM: C[M, N] = A[M, K] (bf16, row-major) @ B[K, N] (bf16, row-major)
// + bias, with M % 128 == 0, N % 128 == 0, K % 32 == 0.
enum { kEpiBf16 = 0, kEpiGeluBf16 = 1, kEpiResidual = 2 };
constexpr int BM = 128, BN = 128, BK = 32;
constexpr int LDA = BK + 8, LDB = BN + 8;

template <int EPI>
__global__ void __launch_bounds__(kThreads)
    gemm_bf16(const bf16* __restrict__ A, const bf16* __restrict__ B,
              const float* __restrict__ bias, void* __restrict__ out, int M, int N, int K) {
  __shared__ __align__(128) bf16 As[2][BM * LDA];
  __shared__ __align__(128) bf16 Bs[2][BK * LDB];
  __shared__ __align__(128) float Cs[kThreads / 32][16 * 16];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm = warp >> 2, wn = warp & 3;  // 2 x 4 warps, 64 x 32 each
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[4][2];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  auto load_tile = [&](int stage, int k0) {
    for (int c = threadIdx.x; c < BM * BK / 8; c += kThreads) {
      int r = c >> 2, cc = (c & 3) * 8;
      cp_async16(&As[stage][r * LDA + cc], A + (size_t)(m0 + r) * K + k0 + cc);
    }
    for (int c = threadIdx.x; c < BK * BN / 8; c += kThreads) {
      int r = c >> 4, cc = (c & 15) * 8;
      cp_async16(&Bs[stage][r * LDB + cc], B + (size_t)(k0 + r) * N + n0 + cc);
    }
    cp_async_commit();
  };

  const int nk = K / BK;
  load_tile(0, 0);
  for (int kt = 0; kt < nk; ++kt) {
    if (kt + 1 < nk) {
      load_tile((kt + 1) & 1, (kt + 1) * BK);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int st = kt & 1;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a[4];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b[2];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        wmma::load_matrix_sync(a[i], &As[st][(wm * 64 + i * 16) * LDA + kk], LDA);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(b[j], &Bs[st][kk * LDB + wn * 32 + j * 16], LDB);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

  float* cs = Cs[warp];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      wmma::store_matrix_sync(cs, acc[i][j], 16, wmma::mem_row_major);
      __syncwarp();
      const int row0 = m0 + wm * 64 + i * 16, col0 = n0 + wn * 32 + j * 16;
      for (int e = lane; e < 256; e += 32) {
        int r = e >> 4, c = e & 15;
        float v = cs[e] + bias[col0 + c];
        size_t o = (size_t)(row0 + r) * N + col0 + c;
        if (EPI == kEpiBf16) {
          static_cast<bf16*>(out)[o] = __float2bfloat16(v);
        } else if (EPI == kEpiGeluBf16) {
          static_cast<bf16*>(out)[o] = __float2bfloat16(gelu_tanh(v));
        } else {
          float* y = static_cast<float*>(out);
          y[o] = y[o] + v;
        }
      }
      __syncwarp();
    }
  }
}

// ---- Attention: one CTA per (crop, head), S tokens (64 or 128), head width
// 64; one warp per 16 query rows, so S / 16 warps.
constexpr int HD = 64;
constexpr int LDQ = HD + 8;

template <int S>
struct Attn {
  static constexpr int kWarps = S / 16;
  static constexpr int kThreads = kWarps * 32;
  static constexpr int LDS = S + 4, LDP = S + 8;
  static constexpr size_t kSmem = sizeof(bf16) * 3 * S * LDQ +
                                  sizeof(float) * kWarps * 16 * LDS +
                                  sizeof(bf16) * kWarps * 16 * LDP;
};

template <int S>
__global__ void __launch_bounds__(Attn<S>::kThreads)
    attention(const bf16* __restrict__ qkv, bf16* __restrict__ att, int d, int heads,
              float scale) {
  constexpr int kWarps = Attn<S>::kWarps, nthreads = Attn<S>::kThreads;
  constexpr int LDS = Attn<S>::LDS, LDP = Attn<S>::LDP;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* Ks = Qs + S * LDQ;
  bf16* Vs = Ks + S * LDQ;
  float* Ss = reinterpret_cast<float*>(Vs + S * LDQ);
  bf16* Ps = reinterpret_cast<bf16*>(Ss + kWarps * 16 * LDS);

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

  const int r0 = warp * 16;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> s[S / 16];
#pragma unroll
  for (int j = 0; j < S / 16; ++j) wmma::fill_fragment(s[j], 0.f);
#pragma unroll
  for (int kk = 0; kk < HD; kk += 16) {
    wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
    wmma::load_matrix_sync(a, &Qs[r0 * LDQ + kk], LDQ);
#pragma unroll
    for (int j = 0; j < S / 16; ++j) {
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> b;
      wmma::load_matrix_sync(b, &Ks[(j * 16) * LDQ + kk], LDQ);
      wmma::mma_sync(s[j], a, b, s[j]);
    }
  }
  float* sw = Ss + warp * 16 * LDS;
#pragma unroll
  for (int j = 0; j < S / 16; ++j)
    wmma::store_matrix_sync(sw + j * 16, s[j], LDS, wmma::mem_row_major);
  __syncwarp();

  bf16* pw = Ps + warp * 16 * LDP;
  for (int r = 0; r < 16; ++r) {
    float v[S / 32];
#pragma unroll
    for (int t = 0; t < S / 32; ++t) v[t] = sw[r * LDS + lane + 32 * t] * scale;
    float mx = v[0];
#pragma unroll
    for (int t = 1; t < S / 32; ++t) mx = fmaxf(mx, v[t]);
    mx = warp_max(mx);
    float sum = 0.f;
#pragma unroll
    for (int t = 0; t < S / 32; ++t) {
      v[t] = expf(v[t] - mx);
      sum += v[t];
    }
    sum = warp_sum(sum);
#pragma unroll
    for (int t = 0; t < S / 32; ++t) pw[r * LDP + lane + 32 * t] = __float2bfloat16(v[t] / sum);
  }
  __syncwarp();

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> o[HD / 16];
#pragma unroll
  for (int j = 0; j < HD / 16; ++j) wmma::fill_fragment(o[j], 0.f);
#pragma unroll
  for (int kk = 0; kk < S; kk += 16) {
    wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
    wmma::load_matrix_sync(a, &pw[kk], LDP);
#pragma unroll
    for (int j = 0; j < HD / 16; ++j) {
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b;
      wmma::load_matrix_sync(b, &Vs[kk * LDQ + j * 16], LDQ);
      wmma::mma_sync(o[j], a, b, o[j]);
    }
  }
#pragma unroll
  for (int j = 0; j < HD / 16; ++j)
    wmma::store_matrix_sync(sw + j * 16, o[j], LDS, wmma::mem_row_major);
  __syncwarp();
  bf16* dst = att + ((size_t)crop * S + r0) * d + h * HD;
  for (int e = lane; e < 16 * HD; e += 32) {
    int r = e / HD, c = e % HD;
    dst[(size_t)r * d + c] = __float2bfloat16(sw[r * LDS + c]);
  }
}

template <int EPI>
void gemm(const bf16* A, const bf16* B, const float* bias, void* out, int M, int N, int K,
          cudaStream_t stream) {
  gemm_bf16<EPI><<<dim3(N / BN, M / BM), kThreads, 0, stream>>>(A, B, bias, out, M, N, K);
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

}  // namespace

// x [n*s, d] fp32 (s = 64 or 128 tokens per crop, n*s a multiple of 128) is
// updated in place; h, qkv, att, hmid are scratch.
// Weights carry a leading block dimension (stack_vit_block_weights).
extern "C" int tt_vit_blocks(float* x, bf16* h, bf16* qkv, bf16* att, bf16* hmid,
                             const bf16* qkv_w, const float* qkv_b, const bf16* o_w,
                             const float* o_b, const bf16* f1_w, const float* f1_b,
                             const bf16* f2_w, const float* f2_b, const float* ln1_g,
                             const float* ln1_b, const float* ln2_g, const float* ln2_b,
                             int n_blocks, int n, int s, int d, int heads, int hidden,
                             float eps, cudaStream_t stream) {
  if (d != heads * HD || d % 128 || hidden % 128 || d > 1024 || (s != 64 && s != 128) ||
      (n * s) % BM)
    return (int)cudaErrorInvalidValue;
  static bool attr_set[2] = {false, false};
  if (!attr_set[s == 128]) {
    cudaError_t e = s == 128 ? set_attention_smem<128>() : set_attention_smem<64>();
    if (e != cudaSuccess) return (int)e;
    attr_set[s == 128] = true;
  }
  const int m = n * s;
  const int ln_blocks = (m + kThreads / 32 - 1) / (kThreads / 32);
  const float scale = 1.0f / sqrtf((float)HD);
  for (int blk = 0; blk < n_blocks; ++blk) {
    ln_bf16<<<ln_blocks, kThreads, 0, stream>>>(x, ln1_g + (size_t)blk * d, ln1_b + (size_t)blk * d,
                                                h, m, d, eps);
    gemm<kEpiBf16>(h, qkv_w + (size_t)blk * d * 3 * d, qkv_b + (size_t)blk * 3 * d, qkv, m, 3 * d,
                   d, stream);
    if (s == 128)
      launch_attention<128>(qkv, att, n, d, heads, scale, stream);
    else
      launch_attention<64>(qkv, att, n, d, heads, scale, stream);
    gemm<kEpiResidual>(att, o_w + (size_t)blk * d * d, o_b + (size_t)blk * d, x, m, d, d, stream);
    ln_bf16<<<ln_blocks, kThreads, 0, stream>>>(x, ln2_g + (size_t)blk * d, ln2_b + (size_t)blk * d,
                                                h, m, d, eps);
    gemm<kEpiGeluBf16>(h, f1_w + (size_t)blk * d * hidden, f1_b + (size_t)blk * hidden, hmid, m,
                       hidden, d, stream);
    gemm<kEpiResidual>(hmid, f2_w + (size_t)blk * hidden * d, f2_b + (size_t)blk * d, x, m, d,
                       hidden, stream);
  }
  return (int)cudaGetLastError();
}

// Fused KV-cached greedy decode (PARSEQ's depth-1 decoder), for Hopper
// (sm_90a).
//
// Replaces greedy_decode_pallas (tuatara_tpu/ops/pallas/decode.py:271): for
// a tile of up to 16 crops (the engine uses 4, kernels/decode.py TB), the
// whole T-step greedy loop in one CTA. Step i:
//   self-attention  position query qh_all[i] over the content K/V of
//                   positions j <= i, the rows k_tab[j, tok_j], v_tab[j, tok_j]
//                   of the [T, V, D] table (tok_0 = BOS);
//   x = pos_q[i] + attn @ Wo + bo
//   cross-attention LN1(x) @ Wq + bq over the memory K/V [S, D] of the crop;
//   x += ctx @ Wco + bco;  x += gelu_tanh(LN2(x) @ W1 + b1) @ W2 + b2
//   logits = LN(x) @ Wh + bh  -> out[crop, i, :];  tok_{i+1} = argmax
// with bf16 operands, fp32 products and sums, fp32 LayerNorm and softmax and
// the attention probabilities rounded to bf16 before they weight V. A tile
// stops once every crop in it has emitted EOS (id 0); positions it never
// reaches keep EOS-certain logits (+30 at id 0, -30 elsewhere).
//
// What bounds it here: bytes, by the count of each input read once: the
// memory K/V (N * 196 KB at S = 128, D = 384), the matmul weights (3.3 MB),
// the K/V table rows (j, tok_j) and position-query rows that the steps run
// actually read (at most steps * N * 1.5 KB, of the table's 3.9 MB), and
// the logits; about 10.6 MB at N = 32 with 13 steps, a floor of ~3 us at
// 3.35 TB/s. The loop is sequential in the step, and every step streams
// ~3.3 MB of matmul weights and 196 KB of memory K/V per crop through the
// one SM that runs the tile, so this kernel is bound by the latency of
// those loads, hundreds of times above that floor.
//
// Design. The TPU kernel holds a tile's K/V cache in VMEM and gathers with a
// one-hot matmul; here only the token history [16, T] sits in shared memory
// and the self-attention K/V rows are gathered from the L2-resident table,
// so no [TB, T, D] cache is stored. One warp per (crop, head) pair runs the
// attentions: scores with one lane per key (or position), the weighted sum
// of V rows with each lane reading 16-byte pieces of every eighth row, so
// every lane keeps several independent loads in flight; the per-step
// [16, D] x [D, X] products run on tensor cores (WMMA m16n16k16 bf16, fp32
// accumulators) with the activations in shared memory and the weights read
// straight from global memory; LayerNorms are one warp per row. Crops of a
// partial last tile are masked. No launch per step and no host sync.
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

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 16;  // crops per tile, the mma row count
constexpr int HD = 32;     // head width
constexpr int TMAX = 32;   // steps: one lane per position
constexpr int CPAD = 128;  // classes
constexpr float kNeg = -1e30f;

struct Params {
  const bf16 *mem_k, *mem_v;
  const float* pos_q;
  const bf16 *qh_all, *k_tab, *v_tab;
  const bf16* o_w;
  const float* o_b;
  const bf16* cq_w;
  const float* cq_b;
  const bf16* co_w;
  const float* co_b;
  const bf16* f1_w;
  const float* f1_b;
  const bf16* f2_w;
  const float* f2_b;
  const bf16* h_w;
  const float* h_b;
  const float *n1_g, *n1_b, *n2_g, *n2_b, *dn_g, *dn_b;
  float* out;
  int n, s, d, heads, t, v, c, hidden, bos, tb;
  float eps, scale;
};

struct Layout {
  size_t xs, a0, a1, hm, stage, pbuf, lg, hist, seen, bytes;
};

__host__ __device__ inline size_t up128(size_t b) { return (b + 127) & ~size_t(127); }

__host__ __device__ inline Layout layout(int d, int hidden, int s) {
  Layout L;
  size_t o = 0;
  L.xs = o;    o = up128(o + sizeof(float) * kRows * d);
  L.a0 = o;    o = up128(o + sizeof(bf16) * kRows * (d + 8));
  L.a1 = o;    o = up128(o + sizeof(bf16) * kRows * (d + 8));
  L.hm = o;    o = up128(o + sizeof(bf16) * kRows * (hidden + 8));
  L.stage = o; o = up128(o + sizeof(float) * kWarps * 256);
  L.pbuf = o;  o = up128(o + sizeof(float) * kWarps * s);
  L.lg = o;    o = up128(o + sizeof(float) * kRows * CPAD);
  L.hist = o;  o = up128(o + sizeof(int) * kRows * (TMAX + 1));
  L.seen = o;  o = up128(o + sizeof(int) * kRows);
  L.bytes = o;
  return L;
}

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

__device__ __forceinline__ int warp_min(int v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = min(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float bf(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float round_bf(float v) { return bf(__float2bfloat16(v)); }

__device__ __forceinline__ float gelu_tanh(float v) {
  return 0.5f * v * (1.0f + tanhf(0.7978845608028654f * (v + 0.044715f * v * v * v)));
}

// 8 bf16 of a against 8 bf16 of b, 16-byte aligned: fp32 sum of products.
__device__ __forceinline__ float dot8(const bf16* a, const bf16* b) {
  uint4 ua = *reinterpret_cast<const uint4*>(a);
  uint4 ub = *reinterpret_cast<const uint4*>(b);
  const __nv_bfloat162* x = reinterpret_cast<const __nv_bfloat162*>(&ua);
  const __nv_bfloat162* y = reinterpret_cast<const __nv_bfloat162*>(&ub);
  float s = 0.f;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    float2 fx = __bfloat1622float2(x[k]);
    float2 fy = __bfloat1622float2(y[k]);
    s += fx.x * fy.x;
    s += fx.y * fy.y;
  }
  return s;
}

// o[0..8) += w * v[0..8) for 8 bf16 of v, 16-byte aligned.
__device__ __forceinline__ void axpy8(float* o, float w, const bf16* v) {
  uint4 u = *reinterpret_cast<const uint4*>(v);
  const __nv_bfloat162* y = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    float2 f = __bfloat1622float2(y[k]);
    o[2 * k] += w * f.x;
    o[2 * k + 1] += w * f.y;
  }
}

// A head's weighted sum of V rows, split as lane = 4 * row group + dim
// group: lanes with the same (lane & 3) hold partial sums of dims
// 8 * (lane & 3) .. +8 over rows (lane >> 2) mod 8. Sums them over the 8
// row groups and stores the head's 32 dims as bf16.
__device__ __forceinline__ void store8(float* o, bf16* dst) {
#pragma unroll
  for (int off = 4; off < 32; off <<= 1)
#pragma unroll
    for (int k = 0; k < 8; ++k) o[k] += __shfl_xor_sync(0xffffffffu, o[k], off);
  const int lane = threadIdx.x & 31;
  if (lane < 4)
#pragma unroll
    for (int k = 0; k < 8; ++k) dst[lane * 8 + k] = __float2bfloat16(o[k]);
}

// out[r, n] = sum_k A[r, k] B[k, n] for the 16 rows of A (shared memory,
// leading dimension lda) and B [K, N] row-major in global memory; each warp
// owns 16-column tiles and hands every element to epi(r, n, value).
template <class Epi>
__device__ __forceinline__ void row16_gemm(const bf16* A, int lda, const bf16* __restrict__ B,
                                           int K, int N, float* stage, Epi epi) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* cs = stage + warp * 256;
  for (int n0 = warp * 16; n0 < N; n0 += kWarps * 16) {
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
    wmma::fill_fragment(acc, 0.f);
#pragma unroll 4
    for (int k0 = 0; k0 < K; k0 += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b;
      wmma::load_matrix_sync(a, A + k0, lda);
      wmma::load_matrix_sync(b, B + (size_t)k0 * N + n0, N);
      wmma::mma_sync(acc, a, b, acc);
    }
    wmma::store_matrix_sync(cs, acc, 16, wmma::mem_row_major);
    __syncwarp();
    for (int e = lane; e < 256; e += 32) epi(e >> 4, n0 + (e & 15), cs[e]);
    __syncwarp();
  }
}

// dst[r, :] = bf16(LN(x[r, :])) for r < rows; one warp per row, d <= 512.
__device__ __forceinline__ void ln_rows(const float* xs, int d, const float* __restrict__ g,
                                        const float* __restrict__ b, bf16* dst, int ld, int rows,
                                        float eps) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int r = warp; r < rows; r += kWarps) {
    float v[16];
    float s = 0.f;
#pragma unroll
    for (int k = 0; k < 16; ++k) {
      int c = lane + 32 * k;
      v[k] = c < d ? xs[r * d + c] : 0.f;
      s += v[k];
    }
    float mean = warp_sum(s) / d;
    float q = 0.f;
#pragma unroll
    for (int k = 0; k < 16; ++k) {
      int c = lane + 32 * k;
      float t = v[k] - mean;
      if (c < d) q += t * t;
    }
    float rstd = rsqrtf(warp_sum(q) / d + eps);
#pragma unroll
    for (int k = 0; k < 16; ++k) {
      int c = lane + 32 * k;
      if (c < d) dst[r * ld + c] = __float2bfloat16((v[k] - mean) * rstd * g[c] + b[c]);
    }
  }
}

__global__ void __launch_bounds__(kThreads, 1) decode_kernel(Params p) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int D = p.d, H = p.heads, F = p.hidden, C = p.c, S = p.s, T = p.t, V = p.v;
  const Layout L = layout(D, F, S);
  float* xs = reinterpret_cast<float*>(smem + L.xs);
  bf16* a0 = reinterpret_cast<bf16*>(smem + L.a0);
  bf16* a1 = reinterpret_cast<bf16*>(smem + L.a1);
  bf16* hm = reinterpret_cast<bf16*>(smem + L.hm);
  float* stage = reinterpret_cast<float*>(smem + L.stage);
  float* pbuf = reinterpret_cast<float*>(smem + L.pbuf);
  float* lg = reinterpret_cast<float*>(smem + L.lg);
  int* hist = reinterpret_cast<int*>(smem + L.hist);
  int* seen = reinterpret_cast<int*>(smem + L.seen);

  const int tile0 = blockIdx.x * p.tb;
  const int tb = min(p.tb, p.n - tile0);
  const int lda = D + 8, ldh = F + 8;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const bf16 zero = __float2bfloat16(0.f);

  for (int e = threadIdx.x; e < kRows * lda; e += kThreads) a0[e] = a1[e] = zero;
  for (int e = threadIdx.x; e < kRows * ldh; e += kThreads) hm[e] = zero;
  if (threadIdx.x < kRows) {
    hist[threadIdx.x * (TMAX + 1)] = p.bos;
    seen[threadIdx.x] = threadIdx.x >= tb;  // padding rows never hold the tile
  }
  float* out = p.out + (size_t)tile0 * T * C;
  for (int e = threadIdx.x; e < tb * T * C; e += kThreads) out[e] = e % C == 0 ? 30.f : -30.f;
  __syncthreads();

  for (int i = 0; i < T; ++i) {
    // x = pos_q[i]; self-attention of query i over positions <= i -> a0.
    for (int e = threadIdx.x; e < tb * D; e += kThreads) xs[e] = p.pos_q[(size_t)i * D + e % D];
    for (int pr = warp; pr < tb * H; pr += kWarps) {
      const int b = pr / H, h = pr % H;
      const bf16* q = p.qh_all + (size_t)i * D + h * HD;
      float l = kNeg;
      int tok = 0;
      if (lane <= i) {
        tok = hist[b * (TMAX + 1) + lane];
        const bf16* kr = p.k_tab + ((size_t)lane * V + tok) * D + h * HD;
        float acc = 0.f;
#pragma unroll
        for (int dd = 0; dd < HD; dd += 8) acc += dot8(q + dd, kr + dd);
        l = acc * p.scale;
      }
      const float mx = warp_max(l);
      const float e = lane <= i ? expf(l - mx) : 0.f;
      const float pj = round_bf(e / warp_sum(e));
      float o[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
      for (int j0 = 0; j0 <= i; j0 += 8) {
        const int j = j0 + (lane >> 2);
        const float pjj = __shfl_sync(0xffffffffu, pj, j & 31);
        const int tk = __shfl_sync(0xffffffffu, tok, j & 31);
        if (j <= i) axpy8(o, pjj, p.v_tab + ((size_t)j * V + tk) * D + h * HD + (lane & 3) * 8);
      }
      store8(o, a0 + b * lda + h * HD);
    }
    __syncthreads();

    row16_gemm(a0, lda, p.o_w, D, D, stage, [&](int r, int c, float v) {
      if (r < tb) xs[r * D + c] += v + p.o_b[c];
    });
    __syncthreads();
    ln_rows(xs, D, p.n1_g, p.n1_b, a1, lda, tb, p.eps);
    __syncthreads();
    row16_gemm(a1, lda, p.cq_w, D, D, stage, [&](int r, int c, float v) {
      if (r < tb) a0[r * lda + c] = __float2bfloat16(v + p.cq_b[c]);
    });
    __syncthreads();

    // Cross-attention of each crop's query over its memory K/V -> a1.
    for (int pr = warp; pr < tb * H; pr += kWarps) {
      const int b = pr / H, h = pr % H;
      const size_t mem0 = (size_t)(tile0 + b) * S * D + h * HD;
      const bf16* mk = p.mem_k + mem0;
      const bf16* mv = p.mem_v + mem0;
      const bf16* q = a0 + b * lda + h * HD;
      float* pw = pbuf + warp * S;
      float mx = kNeg;
      for (int s0 = lane; s0 < S; s0 += 32) {
        const bf16* kr = mk + (size_t)s0 * D;
        float acc = 0.f;
#pragma unroll
        for (int dd = 0; dd < HD; dd += 8) acc += dot8(q + dd, kr + dd);
        const float l = acc * p.scale;
        pw[s0] = l;
        mx = fmaxf(mx, l);
      }
      mx = warp_max(mx);
      float sum = 0.f;
      for (int s0 = lane; s0 < S; s0 += 32) {
        const float e = expf(pw[s0] - mx);
        pw[s0] = e;
        sum += e;
      }
      sum = warp_sum(sum);
      for (int s0 = lane; s0 < S; s0 += 32) pw[s0] = round_bf(pw[s0] / sum);
      __syncwarp();
      float o[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
#pragma unroll 4
      for (int s0 = lane >> 2; s0 < S; s0 += 8) axpy8(o, pw[s0], mv + (size_t)s0 * D + (lane & 3) * 8);
      store8(o, a1 + b * lda + h * HD);
      __syncwarp();
    }
    __syncthreads();

    row16_gemm(a1, lda, p.co_w, D, D, stage, [&](int r, int c, float v) {
      if (r < tb) xs[r * D + c] += v + p.co_b[c];
    });
    __syncthreads();
    ln_rows(xs, D, p.n2_g, p.n2_b, a0, lda, tb, p.eps);
    __syncthreads();
    row16_gemm(a0, lda, p.f1_w, D, F, stage, [&](int r, int c, float v) {
      if (r < tb) hm[r * ldh + c] = __float2bfloat16(gelu_tanh(v + p.f1_b[c]));
    });
    __syncthreads();
    row16_gemm(hm, ldh, p.f2_w, F, D, stage, [&](int r, int c, float v) {
      if (r < tb) xs[r * D + c] += v + p.f2_b[c];
    });
    __syncthreads();
    ln_rows(xs, D, p.dn_g, p.dn_b, a1, lda, tb, p.eps);
    __syncthreads();

    // Head: logits of step i for every crop of the tile.
    for (int e = threadIdx.x; e < tb * C; e += kThreads) {
      const int b = e / C, c = e % C;
      const bf16* y = a1 + b * lda;
      float acc = 0.f;
      for (int k = 0; k < D; ++k) acc += bf(y[k]) * bf(p.h_w[(size_t)k * C + c]);
      acc += p.h_b[c];
      lg[b * CPAD + c] = acc;
      out[((size_t)b * T + i) * C + c] = acc;
    }
    __syncthreads();

    // Argmax, first index on ties, feeds step i + 1.
    for (int b = warp; b < tb; b += kWarps) {
      float best = kNeg;
      int bi = C;
      for (int c = lane; c < C; c += 32) {
        const float v = lg[b * CPAD + c];
        if (v > best) {
          best = v;
          bi = c;
        }
      }
      const float m = warp_max(best);
      const int idx = warp_min(best == m ? bi : C);
      if (lane == 0) {
        hist[b * (TMAX + 1) + i + 1] = idx < C ? idx : 0;
        if (idx == 0) seen[b] = 1;
      }
    }
    __syncthreads();
    int all = 1;
    for (int b = 0; b < kRows; ++b) all &= seen[b];
    if (all) break;
  }
}

}  // namespace

extern "C" int tt_greedy_decode(const bf16* mem_k, const bf16* mem_v, const float* pos_q,
                                const bf16* qh_all, const bf16* k_tab, const bf16* v_tab,
                                const bf16* o_w, const float* o_b, const bf16* cq_w,
                                const float* cq_b, const bf16* co_w, const float* co_b,
                                const bf16* f1_w, const float* f1_b, const bf16* f2_w,
                                const float* f2_b, const bf16* h_w, const float* h_b,
                                const float* n1_g, const float* n1_b, const float* n2_g,
                                const float* n2_b, const float* dn_g, const float* dn_b,
                                float* out, int n, int s, int d, int heads, int t, int v, int c,
                                int hidden, int bos, int tb, float eps, float scale,
                                cudaStream_t stream) {
  if (d != heads * HD || t > TMAX || s % 32 || d % 16 || d > 512 || hidden % 16 || c > CPAD ||
      tb < 1 || tb > kRows || n < 1)
    return (int)cudaErrorInvalidValue;
  Params p{mem_k, mem_v, pos_q, qh_all, k_tab, v_tab, o_w, o_b, cq_w, cq_b, co_w, co_b,
           f1_w,  f1_b,  f2_w,  f2_b,   h_w,   h_b,   n1_g, n1_b, n2_g, n2_b, dn_g, dn_b,
           out,   n,     s,     d,      heads, t,     v,    c,    hidden, bos, tb, eps, scale};
  const size_t bytes = layout(d, hidden, s).bytes;
  static size_t attr_bytes = 0;
  if (bytes > attr_bytes) {
    cudaError_t e = cudaFuncSetAttribute(decode_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (e != cudaSuccess) return (int)e;
    attr_bytes = bytes;
  }
  decode_kernel<<<(n + tb - 1) / tb, kThreads, bytes, stream>>>(p);
  return (int)cudaGetLastError();
}

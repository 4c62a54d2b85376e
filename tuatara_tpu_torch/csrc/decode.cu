// Fused KV-cached greedy decode (PARSEQ's depth-1 decoder), for Hopper
// (sm_90a).
//
// Replaces greedy_decode_pallas (tuatara_tpu/ops/pallas/decode.py:271): for
// a tile of up to 16 crops, the whole T-step greedy loop in one launch.
// Step i:
//   self-attention  position query qh_all[i] over the content K/V of
//                   positions j <= i, the rows k_tab[j, tok_j], v_tab[j, tok_j]
//                   of the [T, V, D] table (tok_0 = BOS);
//   x = pos_q[i] + attn @ Wo + bo
//   cross-attention LN1(x) @ Wq + bq over the memory K/V [S, D] of the crop;
//   x += ctx @ Wco + bco;  x += gelu_tanh(LN2(x) @ W1 + b1) @ W2 + b2
//   logits = LN(x) @ Wh + bh  -> out[crop, i, :];  tok_{i+1} = argmax
// with bf16 operands, fp32 LayerNorm and softmax, the attention
// probabilities rounded to bf16 before they weight V, each attention
// product (q * k, p * v) rounded to bf16 before its fp32 sum, as the TPU
// kernel computes them, and the products of the matmuls exact. A tile
// stops once every crop in it has emitted EOS (id 0); positions it never
// reaches keep EOS-certain logits (+30 at id 0, -30 elsewhere).
//
// What bounds it here: bytes, by the count of each input read once: the
// memory K/V (N * 196 KB at S = 128, D = 384), the matmul weights (3.3 MB),
// the K/V table rows (j, tok_j) and position-query rows that the steps run
// actually read, and the logits; about 10.6 MB at N = 32 with 13 steps, a
// floor of ~3 us at 3.35 TB/s. The loop is sequential in the step, so each
// step's weights and memory K/V are read again from L2 at every step; the
// time goes to how fast the SMs that run a tile can stream them.
//
// Design. A tile of up to 16 crops (the mma row count; the engine takes 4)
// is one thread-block cluster of CS CTAs (4 or 6, the engine 6: the
// decoder's 12 heads divide evenly among either). Each CTA owns H / CS heads
// of both attentions (its crops' memory K/V for those heads only) and a
// 1 / CS slice of the output columns of every product: Wo, Wq, Wco and W2
// (D / CS columns), W1 (F / CS) and the head (ceil(C / CS) classes). A
// step's weights are thus read once per cluster for all its crops, split
// over CS SMs. After each product the CTAs exchange the [TB, D] (or
// [TB, F]) activations through distributed shared memory
// (cooperative_groups map_shared_rank) under the cluster barrier
// (barrier.cluster.arrive.release / wait.acquire): every CTA keeps the full
// fp32 stream x and computes the LayerNorms on its own copy; the argmax is
// reduced across the cluster from each CTA's best class of its slice.
// Seven cluster barriers a step. The weight slices stream through a
// three-slot cp.async ring in shared memory, two stages (about 24 KB each)
// ahead of the products; the stream is the same at every step, so the loads
// run on across products and into the next step. The weights arrive
// tile-major (the weight bundle holds them so), so a stage is a contiguous run
// per 16-column tile. The products run on tensor cores (mma.sync m16n8k16
// bf16, fp32 accumulators, fragments loaded with ldmatrix: one instruction
// a fragment, so fewer of them queue beside the ring's copies), one warp per
// 16-column tile, summing K in the same order for every CS and TB, and the
// epilogue reads the accumulator fragment directly; the head by FMA from
// its class slice, held in shared memory. Attentions: one warp per (crop,
// head). The softmaxes multiply by the reciprocal of the sum: a division
// whose quotient is subnormal (the far tail of a peaked softmax) takes a
// slow path many times longer.
//
// Launches on the caller's stream (cudaLaunchKernelEx with a cluster
// dimension), allocates nothing, does not synchronise, and returns
// cudaGetLastError().

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;
typedef __nv_bfloat16 bf16;

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 16;  // crops per tile, the mma row count
constexpr int HD = 32;     // head width
constexpr int TMAX = 32;   // steps: one lane per position
constexpr int kSlots = 3;     // weight ring: kSlots - 1 stages in flight beside the one in use
constexpr int kSlotRows = 32;  // a slot holds kSlotRows rows of W1's slice (or 4x of a D-wide one)
constexpr int kPad = 8;    // bf16 padding of shared-memory rows (bank spread)
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
  int n, s, d, heads, t, v, c, hidden, bos, tb, cs;
  float eps, scale;
};

// Column slices of one CTA of the cluster.
struct Slices {
  int ds, fs, cw;  // D / CS, F / CS, ceil(C / CS)
};

__host__ __device__ inline Slices slices(int d, int hidden, int c, int cs) {
  return {d / cs, hidden / cs, (c + cs - 1) / cs};
}

// The products of a step whose weights stream through the ring, in order.
enum { kWo = 0, kWq, kWco, kW1, kW2, kProducts };

// Rows of a product's k-slices: the most (a power of two, <= 128) whose
// stage fits a ring slot and divides K.
__host__ __device__ inline int stage_rows(int k, int width, size_t slot_bytes) {
  int r = 128;
  while (r > 16 && ((size_t)r * width * 2 > slot_bytes || k % r)) r >>= 1;
  return r;
}

struct Layout {
  size_t x, es, eh, ln, q, ring, pbuf, bias, wh, lg, arg, hist, seen, bytes, slot;
};

__host__ __device__ inline size_t up128(size_t b) { return (b + 127) & ~size_t(127); }

__host__ __device__ inline Layout layout(int d, int hidden, int s, int c, int cs) {
  const Slices sl = slices(d, hidden, c, cs);
  Layout L;
  // A slot holds a W1 stage of kSlotRows rows or a D-wide product's of 4x.
  const int w1 = kSlotRows * sl.fs, wd = 4 * kSlotRows * sl.ds;
  L.slot = up128((size_t)2 * (w1 > wd ? w1 : wd));
  size_t o = 0;
  L.x = o;     o = up128(o + sizeof(float) * kRows * d);             // the fp32 stream
  L.es = o;    o = up128(o + sizeof(bf16) * kRows * (d + kPad));     // attn / ctx
  L.eh = o;    o = up128(o + sizeof(bf16) * kRows * (hidden + kPad));  // MLP middle
  L.ln = o;    o = up128(o + sizeof(bf16) * kRows * (d + kPad));     // LayerNorm out
  L.q = o;     o = up128(o + sizeof(bf16) * kRows * (sl.ds + kPad));  // cross query
  L.ring = o;  o = up128(o + L.slot * kSlots);
  L.pbuf = o;  o = up128(o + sizeof(float) * kWarps * s);             // softmax weights
  L.bias = o;  o = up128(o + sizeof(float) * (5 * sl.ds + sl.fs));  // pos_q[i], o, cq, co, f2; f1
  L.wh = o;    o = up128(o + sizeof(bf16) * d * sl.cw);               // the head's classes
  L.lg = o;    o = up128(o + sizeof(float) * kRows * sl.cw);
  L.arg = o;   o = up128(o + sizeof(float2) * 8 * kRows);            // per rank: (max, idx)
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

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(smem)), "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The product of two bf16 values (exact in fp32) rounded to bf16, as the
// TPU kernel's bf16 `q * k` and `p * v` are. __fmul_rn keeps nvcc from
// contracting the product into the add that follows.
__device__ __forceinline__ float mul_bf(float a, float b) {
  return __bfloat162float(__float2bfloat16_rn(__fmul_rn(a, b)));
}

// 8 bf16 of a against 8 bf16 of b, 16-byte aligned: the fp32 sum of the
// products, each rounded to bf16 first.
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
    s += mul_bf(fx.x, fy.x);
    s += mul_bf(fx.y, fy.y);
  }
  return s;
}

// o[0..8) += bf16(w * v[0..8)) for 8 bf16 of v, 16-byte aligned; w is
// bf16-valued.
__device__ __forceinline__ void axpy8(float* o, float w, const bf16* v) {
  uint4 u = *reinterpret_cast<const uint4*>(v);
  const __nv_bfloat162* y = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    float2 f = __bfloat1622float2(y[k]);
    o[2 * k] += mul_bf(w, f.x);
    o[2 * k + 1] += mul_bf(w, f.y);
  }
}

// A head's weighted sum of V rows, split as lane = 4 * row group + dim
// group: lanes with the same (lane & 3) hold partial sums of dims
// 8 * (lane & 3) .. +8 over rows (lane >> 2) mod 8. Sums them over the 8
// row groups and stores the head's 32 dims as bf16 at dst in every CTA of
// the cluster (16-byte stores).
__device__ __forceinline__ void store8_cluster(float* o, bf16* dst, cg::cluster_group& cluster,
                                               int cs) {
#pragma unroll
  for (int off = 4; off < 32; off <<= 1)
#pragma unroll
    for (int k = 0; k < 8; ++k) o[k] += __shfl_xor_sync(0xffffffffu, o[k], off);
  const int lane = threadIdx.x & 31;
  if (lane < 4) {
    __align__(16) bf16 v[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) v[k] = __float2bfloat16(o[k]);
    const uint4 u = *reinterpret_cast<const uint4*>(v);
    for (int r = 0; r < cs; ++r)
      *reinterpret_cast<uint4*>(cluster.map_shared_rank(dst + lane * 8, r)) = u;
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

// Copies rows [0, rows) x bytes [off, off + width) of a local shared-memory
// array with row pitch `pitch` bytes into the same place in every other CTA
// of the cluster, 16 bytes at a time.
__device__ __forceinline__ void share_slice(void* base, int pitch, int off, int width, int rows,
                                            cg::cluster_group& cluster, int cs, int rank) {
  const int per_row = width / 16, per_peer = rows * per_row;
  unsigned char* b = static_cast<unsigned char*>(base);
  for (int e = threadIdx.x; e < per_peer * (cs - 1); e += kThreads) {
    const int peer = e / per_peer, rem = e % per_peer;
    const int r = rem / per_row, c = rem % per_row;
    unsigned char* src = b + r * pitch + off + c * 16;
    const int dst_rank = peer < rank ? peer : peer + 1;
    *reinterpret_cast<uint4*>(cluster.map_shared_rank(src, dst_rank)) =
        *reinterpret_cast<const uint4*>(src);
  }
}

// The weight stream of one CTA: the step's products in order, each its
// column slice in k-slices of `rows` rows; stage g of the endless stream is
// stage g % per_step of the step, in ring slot g % kSlots. The weights are
// tile-major ([N / 16, K, 16], as the bundle holds them), so a stage is one
// contiguous run of rows x 32 bytes for each 16-column tile of the slice:
// strided row segments of a row-major matrix stream several times slower.
// Every thread copies 16-byte chunks of it (cp.async) and commits one group.
struct Stream {
  const bf16* w[kProducts];
  int k[kProducts], tile0[kProducts], tiles[kProducts], rows[kProducts], shift[kProducts];
  int first[kProducts + 1];  // first stage of each product within a step
  unsigned char* ring;
  size_t slot;

  __device__ void fetch(int g) const {
    const int u = g % first[kProducts];
    int p = 0;
    while (u >= first[p + 1]) ++p;
    const int k0 = (u - first[p]) * rows[p], per_tile = rows[p] * 2;  // chunks of a tile
    bf16* dst = reinterpret_cast<bf16*>(ring + (size_t)(g % kSlots) * slot);
    const bf16* src = w[p] + ((size_t)tile0[p] * k[p] + k0) * 16;
    for (int e = threadIdx.x; e < tiles[p] * per_tile; e += kThreads) {
      const int t = e >> shift[p], c = e & (per_tile - 1);
      cp_async16(dst + (size_t)t * rows[p] * 16 + c * 8, src + (size_t)t * k[p] * 16 + c * 8);
    }
    cp_async_commit();
  }
};

// Tensor-core fragments (mma.sync m16n8k16, bf16 in, fp32 out), loaded
// with ldmatrix: A is 16 x 16 row-major (leading dimension lda), B a 16 x 16
// row-major [k][n] tile with rows 16 wide; d holds the two 16 x 8 halves.
__device__ __forceinline__ void mma16x16(float (&d)[8], const bf16* A, int lda, const bf16* B) {
  const int lane = threadIdx.x & 31;
  uint32_t a[4], b[4];
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
               : "r"(smem_u32(A + (lane & 15) * lda + (lane >> 4) * 8)));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(b[0]), "=r"(b[1]), "=r"(b[2]), "=r"(b[3])
               : "r"(smem_u32(B + (lane & 15) * 16 + (lane >> 4) * 8)));
#pragma unroll
  for (int h = 0; h < 2; ++h)
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
        "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(d[4 * h]), "+f"(d[4 * h + 1]), "+f"(d[4 * h + 2]), "+f"(d[4 * h + 3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[2 * h]), "r"(b[2 * h + 1]));
}

// One product's column slice: out[r, n] = sum_k A[r, k] W[k, col0 + n] for
// the 16 rows of A (shared memory, leading dimension lda), from the ring (a
// stage: per 16-column tile, rows x 16 row-major); g is the stream's stage
// counter (advanced past the product). Warp w owns 16-column tiles w,
// w + 16; each element goes to epi(r, n, value), from the accumulator
// fragment: lane l holds rows l / 4 (+ 8), columns 8 h + 2 (l % 4) (+ 1).
template <class Epi>
__device__ __forceinline__ void product(const Stream& st, int p, int& g, const bf16* A, int lda,
                                        Epi epi) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int rows = st.rows[p], tiles = st.tiles[p], n_stages = st.k[p] / rows;
  float acc[2][8] = {};
  for (int j = 0; j < n_stages; ++j, ++g) {
    cp_async_wait<kSlots - 2>();  // stage g has landed (the later ones may be in flight)
    __syncthreads();  // ... for every thread's share; stage g - 1's slot takes the next
    st.fetch(g + kSlots - 1);
    const bf16* slot = reinterpret_cast<const bf16*>(st.ring + (size_t)(g % kSlots) * st.slot);
#pragma unroll
    for (int t = 0; t < 2; ++t) {
      const int tile = warp + t * kWarps;
      if (tile >= tiles) break;
      for (int kk = 0; kk < rows; kk += 16)
        mma16x16(acc[t], A + j * rows + kk, lda, slot + (tile * rows + kk) * 16);
    }
  }
#pragma unroll
  for (int t = 0; t < 2; ++t) {
    const int tile = warp + t * kWarps;
    if (tile >= tiles) break;
#pragma unroll
    for (int e = 0; e < 8; ++e)
      epi((lane >> 2) + 8 * ((e >> 1) & 1), tile * 16 + 8 * (e >> 2) + 2 * (lane & 3) + (e & 1),
          acc[t][e]);
  }
}

__global__ void __launch_bounds__(kThreads, 1) decode_kernel(const Params p) {
  extern __shared__ __align__(128) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int CS = p.cs, rank = (int)cluster.block_rank();
  const int D = p.d, H = p.heads, F = p.hidden, C = p.c, S = p.s, T = p.t, V = p.v;
  const Slices sl = slices(D, F, C, CS);
  const Layout L = layout(D, F, S, C, CS);
  float* xs = reinterpret_cast<float*>(smem + L.x);
  bf16* es = reinterpret_cast<bf16*>(smem + L.es);
  bf16* eh = reinterpret_cast<bf16*>(smem + L.eh);
  bf16* ln = reinterpret_cast<bf16*>(smem + L.ln);
  bf16* qs = reinterpret_cast<bf16*>(smem + L.q);
  float* pbuf = reinterpret_cast<float*>(smem + L.pbuf);
  float* bias = reinterpret_cast<float*>(smem + L.bias);
  float *spos = bias, *sbo = bias + sl.ds, *sbq = bias + 2 * sl.ds, *sbco = bias + 3 * sl.ds;
  float *sbf2 = bias + 4 * sl.ds, *sbf1 = bias + 5 * sl.ds;
  bf16* wh = reinterpret_cast<bf16*>(smem + L.wh);
  float* lg = reinterpret_cast<float*>(smem + L.lg);
  float2* arg = reinterpret_cast<float2*>(smem + L.arg);
  int* hist = reinterpret_cast<int*>(smem + L.hist);
  int* seen = reinterpret_cast<int*>(smem + L.seen);

  const int tile0 = (blockIdx.x / CS) * p.tb;
  const int tb = min(p.tb, p.n - tile0);
  const int lda = D + kPad, ldh = F + kPad, ldq = sl.ds + kPad;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int hpc = H / CS, h0 = rank * hpc;         // this CTA's heads
  const int d0 = rank * sl.ds, f0 = rank * sl.fs;  // its column slices
  const int c0 = rank * sl.cw, c1 = min(C, c0 + sl.cw);
  const bf16 zero = __float2bfloat16(0.f);

  __shared__ Stream st;
  if (threadIdx.x == 0) {
    const bf16* w[kProducts] = {p.o_w, p.cq_w, p.co_w, p.f1_w, p.f2_w};
    const int col0[kProducts] = {d0, d0, d0, f0, d0};
    const int width[kProducts] = {sl.ds, sl.ds, sl.ds, sl.fs, sl.ds};
    const int k[kProducts] = {D, D, D, D, F};
    st.first[0] = 0;
    for (int q = 0; q < kProducts; ++q) {
      st.w[q] = w[q];
      st.k[q] = k[q];
      st.tile0[q] = col0[q] / 16;
      st.tiles[q] = width[q] / 16;
      st.rows[q] = stage_rows(k[q], width[q], L.slot);
      st.shift[q] = __ffs(st.rows[q] * 2) - 1;
      st.first[q + 1] = st.first[q] + k[q] / st.rows[q];
    }
    st.ring = smem + L.ring;
    st.slot = L.slot;
  }
  __syncthreads();
  int g = 0;  // stream stage of the next product
  for (int q = 0; q < kSlots - 1; ++q) st.fetch(q);

  for (int e = threadIdx.x; e < kRows * lda; e += kThreads) es[e] = ln[e] = zero;
  for (int e = threadIdx.x; e < kRows * ldh; e += kThreads) eh[e] = zero;
  for (int e = threadIdx.x; e < kRows * ldq; e += kThreads) qs[e] = zero;
  for (int e = threadIdx.x; e < kRows * D; e += kThreads) xs[e] = 0.f;
  for (int e = threadIdx.x; e < sl.ds; e += kThreads) {  // this CTA's columns of the biases
    sbo[e] = p.o_b[d0 + e];
    sbq[e] = p.cq_b[d0 + e];
    sbco[e] = p.co_b[d0 + e];
    sbf2[e] = p.f2_b[d0 + e];
  }
  for (int e = threadIdx.x; e < sl.fs; e += kThreads) sbf1[e] = p.f1_b[f0 + e];
  for (int e = threadIdx.x; e < D * sl.cw; e += kThreads) {  // the head's classes, zero past C
    const int k = e / sl.cw, c = c0 + e % sl.cw;
    wh[e] = c < C ? p.h_w[(size_t)k * C + c] : zero;
  }
  if (threadIdx.x < kRows) {
    hist[threadIdx.x * (TMAX + 1)] = p.bos;
    seen[threadIdx.x] = threadIdx.x >= tb;  // padding rows never hold the tile
  }
  // EOS-certain logits in this CTA's classes; the steps run overwrite them.
  float* out = p.out + (size_t)tile0 * T * C;
  for (int e = threadIdx.x; c1 > c0 && e < tb * T * (c1 - c0); e += kThreads) {
    const int c = c0 + e % (c1 - c0), bt = e / (c1 - c0);
    out[(size_t)bt * C + c] = c == 0 ? 30.f : -30.f;
  }
  cluster.sync();  // every CTA of the cluster runs: peers' shared memory may be written

  for (int i = 0; i < T; ++i) {
    for (int e = threadIdx.x; e < sl.ds; e += kThreads) spos[e] = p.pos_q[(size_t)i * D + d0 + e];
    // Self-attention of query i over positions <= i, this CTA's heads -> es
    // in every CTA.
    for (int pr = warp; pr < tb * hpc; pr += kWarps) {
      const int b = pr / hpc, h = h0 + pr % hpc;
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
      // Times the reciprocal: a subnormal quotient would take the slow path.
      const float pj = round_bf(e * (1.0f / warp_sum(e)));
      float o[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
#pragma unroll 4
      for (int j0 = 0; j0 <= i; j0 += 8) {
        const int j = j0 + (lane >> 2);
        const float pjj = __shfl_sync(0xffffffffu, pj, j & 31);
        const int tk = __shfl_sync(0xffffffffu, tok, j & 31);
        if (j <= i) axpy8(o, pjj, p.v_tab + ((size_t)j * V + tk) * D + h * HD + (lane & 3) * 8);
      }
      store8_cluster(o, es + b * lda + h * HD, cluster, CS);
    }
    cluster.sync();

    // x = pos_q[i] + attn @ Wo + bo (this CTA's columns), then shared.
    product(st, kWo, g, es, lda, [&](int r, int c, float v) {
      if (r < tb) xs[r * D + d0 + c] = spos[c] + (v + sbo[c]);
    });
    __syncthreads();
    share_slice(xs, D * 4, d0 * 4, sl.ds * 4, tb, cluster, CS, rank);
    cluster.sync();

    // Cross query of this CTA's heads: LN1(x) @ Wq + bq (its columns).
    ln_rows(xs, D, p.n1_g, p.n1_b, ln, lda, tb, p.eps);
    __syncthreads();
    product(st, kWq, g, ln, lda, [&](int r, int c, float v) {
      if (r < tb) qs[r * ldq + c] = __float2bfloat16(v + sbq[c]);
    });
    __syncthreads();

    // Cross-attention of each crop's query over its memory K/V, this CTA's
    // heads -> es in every CTA.
    for (int pr = warp; pr < tb * hpc; pr += kWarps) {
      const int b = pr / hpc, hl = pr % hpc, h = h0 + hl;
      const size_t mem0 = (size_t)(tile0 + b) * S * D + h * HD;
      const bf16* mk = p.mem_k + mem0;
      const bf16* mv = p.mem_v + mem0;
      const bf16* q = qs + b * ldq + hl * HD;
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
      const float inv = 1.0f / warp_sum(sum);
      for (int s0 = lane; s0 < S; s0 += 32) pw[s0] = round_bf(pw[s0] * inv);
      __syncwarp();
      float o[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
#pragma unroll 16
      for (int s0 = lane >> 2; s0 < S; s0 += 8) axpy8(o, pw[s0], mv + (size_t)s0 * D + (lane & 3) * 8);
      store8_cluster(o, es + b * lda + h * HD, cluster, CS);
      __syncwarp();
    }
    cluster.sync();

    // x += ctx @ Wco + bco, shared.
    product(st, kWco, g, es, lda, [&](int r, int c, float v) {
      if (r < tb) xs[r * D + d0 + c] += v + sbco[c];
    });
    __syncthreads();
    share_slice(xs, D * 4, d0 * 4, sl.ds * 4, tb, cluster, CS, rank);
    cluster.sync();

    // hmid = gelu_tanh(LN2(x) @ W1 + b1) (this CTA's columns), shared.
    ln_rows(xs, D, p.n2_g, p.n2_b, ln, lda, tb, p.eps);
    __syncthreads();
    product(st, kW1, g, ln, lda, [&](int r, int c, float v) {
      if (r < tb) eh[r * ldh + f0 + c] = __float2bfloat16(gelu_tanh(v + sbf1[c]));
    });
    __syncthreads();
    share_slice(eh, ldh * 2, f0 * 2, sl.fs * 2, tb, cluster, CS, rank);
    cluster.sync();

    // x += hmid @ W2 + b2, shared.
    product(st, kW2, g, eh, ldh, [&](int r, int c, float v) {
      if (r < tb) xs[r * D + d0 + c] += v + sbf2[c];
    });
    __syncthreads();
    share_slice(xs, D * 4, d0 * 4, sl.ds * 4, tb, cluster, CS, rank);
    cluster.sync();

    // Head: logits of this CTA's classes, one thread per (crop, class).
    ln_rows(xs, D, p.dn_g, p.dn_b, ln, lda, tb, p.eps);
    __syncthreads();
    for (int e = threadIdx.x; e < tb * sl.cw; e += kThreads) {
      const int b = e / sl.cw, c = c0 + e % sl.cw;
      if (c >= C) continue;
      const bf16* y = ln + b * lda;
      const bf16* w = wh + (c - c0);
      float acc = 0.f;
#pragma unroll 8
      for (int k = 0; k < D; ++k) acc += bf(y[k]) * bf(w[k * sl.cw]);
      acc += p.h_b[c];
      lg[b * sl.cw + (c - c0)] = acc;
      out[((size_t)b * T + i) * C + c] = acc;
    }
    __syncthreads();

    // Argmax, first index on ties: this CTA's best class per crop to every
    // CTA, then the cluster's best.
    for (int b = warp; b < tb; b += kWarps) {
      float best = kNeg;
      int bi = C;
      for (int c = c0 + lane; c < c1; c += 32) {
        const float v = lg[b * sl.cw + (c - c0)];
        if (v > best) {
          best = v;
          bi = c;
        }
      }
      const float m = warp_max(best);
      const int idx = warp_min(best == m ? bi : C);
      if (lane < CS)
        *cluster.map_shared_rank(&arg[rank * kRows + b], lane) = make_float2(m, __int_as_float(idx));
    }
    cluster.sync();
    if (threadIdx.x < tb) {
      const int b = threadIdx.x;
      float best = kNeg;
      int bi = C;
      for (int r = 0; r < CS; ++r) {  // ranks hold increasing classes: ties keep the first
        const float2 a = arg[r * kRows + b];
        if (a.x > best) {
          best = a.x;
          bi = __float_as_int(a.y);
        }
      }
      const int tok = bi < C ? bi : 0;
      hist[b * (TMAX + 1) + i + 1] = tok;
      if (tok == 0) seen[b] = 1;
    }
    __syncthreads();
    int all = 1;
    for (int b = 0; b < kRows; ++b) all &= seen[b];
    if (all) break;
  }
  cp_async_wait<0>();  // the stream's prefetched stages land before the CTA exits
  cluster.sync();      // no CTA leaves while a peer may still write to it
}

}  // namespace

// tb: crops per tile, cs: CTAs per tile (its cluster). o_w, cq_w, co_w,
// f1_w and f2_w come tile-major ([N / 16, K, 16]); every other weight as
// stack_decode_weights lays it out.
extern "C" int tt_greedy_decode(const bf16* mem_k, const bf16* mem_v, const float* pos_q,
                                const bf16* qh_all, const bf16* k_tab, const bf16* v_tab,
                                const bf16* o_w, const float* o_b, const bf16* cq_w,
                                const float* cq_b, const bf16* co_w, const float* co_b,
                                const bf16* f1_w, const float* f1_b, const bf16* f2_w,
                                const float* f2_b, const bf16* h_w, const float* h_b,
                                const float* n1_g, const float* n1_b, const float* n2_g,
                                const float* n2_b, const float* dn_g, const float* dn_b,
                                float* out, int n, int s, int d, int heads, int t, int v, int c,
                                int hidden, int bos, int tb, int cs, float eps, float scale,
                                cudaStream_t stream) {
  if (cs < 1 || cs > 8 || d != heads * HD || heads % cs || d % (16 * cs) ||
      hidden % (16 * cs) || hidden / cs > 2 * kWarps * 16 || d / cs > 2 * kWarps * 16 ||
      t > TMAX || s % 32 || d > 512 || c < 1 || tb < 1 ||
      tb > kRows || n < 1)
    return (int)cudaErrorInvalidValue;
  Params p{mem_k, mem_v, pos_q, qh_all, k_tab, v_tab, o_w, o_b,  cq_w,   cq_b, co_w, co_b,
           f1_w,  f1_b,  f2_w,  f2_b,   h_w,   h_b,   n1_g, n1_b, n2_g,   n2_b, dn_g, dn_b,
           out,   n,     s,     d,      heads, t,     v,    c,    hidden, bos,  tb,   cs,
           eps,   scale};
  const size_t bytes = layout(d, hidden, s, c, cs).bytes;
  if (bytes > 232448) return (int)cudaErrorInvalidValue;
  static size_t attr_bytes = 0;
  if (bytes > attr_bytes) {
    cudaError_t e = cudaFuncSetAttribute(decode_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (e != cudaSuccess) return (int)e;
    attr_bytes = bytes;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(((n + tb - 1) / tb) * cs);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = bytes;
  cfg.stream = stream;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = cs;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  cudaError_t e = cudaLaunchKernelEx(&cfg, decode_kernel, p);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// BA: a product's bias add and the activation after it, at a 16-bit
// compute dtype, for Hopper (sm_90a).
//
// Replaces no TPU kernel. The JAX package's conv2d and linear
// (tuatara_tpu/models/layers.py:84-95, 387-393) round a bf16 product to
// bf16 and then add the bias cast to bf16, with a second rounding. cuBLAS
// adds a bias in fp32 before its one rounding (and PyTorch adds a cuDNN
// convolution's in an op of its own), so the port asks the libraries for
// the product alone and adds the bias here, in the same pass as the ReLU
// (CRAFT) or the exact GELU (PARSEQ) that follows it.
//
// tt_bias_act: p [n] in T (bf16 or fp16), the product, in any memory
// order where the channel of element i is (i / div) % C (div = 1 for a
// Linear's [..., C] and for NCHW tensors in channels_last memory, H * W
// for contiguous NCHW); b [C] in T or null. Per element:
//   v = T(float(p) + float(b[c]))            (v = p with no bias)
//   y = ReLU(v) | T(T(0.5f * float(v)) * float(T(erfcf(a)))),  a = -float(v) * s
// with s = T(sqrt(0.5)) passed in, a rounded to T for fp16 only (as XLA's
// fp16 graph keeps it, not its bf16 graph), and the denormals flushed at
// the input, at a, at erfcf's result and at the output, as XLA's CPU
// backend flushes them; pre (optional) gets v. The __f*_rn
// intrinsics keep nvcc from contracting the products into fused
// multiply-adds, so the kernel equals the plain PyTorch version
// (kernels/bias_act.py bias_act_plain) bit for bit. A bias add that no
// activation follows is torch.add in the port where its sum is rounded to
// T, and tt_bias_add_f32 (below) where it is not.
//
// tt_bias_add_f32: the fp32-output mode, for a product whose sum goes
// straight into an fp32 op (PARSEQ's residual adds, patch_embed +
// pos_embed; in the training graph the PLM loss's head, and CRAFT's convs
// before a BatchNorm or the loss). There XLA's CPU backend adds the bias
// in fp32 and never rounds the sum to T, so nor does this mode. y [n] in T
// (already rounded), the channel of element i as above; b [C] in T,
// widened in registers; r in fp32 or null, the residual, one period of
// `period` elements repeated over y's leading dimensions (period = n for
// a residual of y's shape; S * D for pos_embed [1, S, D]; channels
// innermost only). Per element:
//   out = r[i % period] + (float(y) + float(b[c]))   (fp32, that order)
// with __fadd_rn, bit-equal to kernels/bias_act.py bias_add_f32_plain.
//
// tt_gelu_grad (GG): the GELU mode's backward for the training graph. g [n]
// and v [n] in T, the output's gradient and the pre-activation value, any
// memory order (elementwise) -> gv [n] in T, XLA's CPU gradient of JAX's
// jax.nn.gelu(approximate=False) (kernels/bias_act.py gelu_plain_grad):
//   gv = T(T(T(g * e) * 0.5) - T(T(T(T(T(0.5 v) * g) * k) * ex) * s))
// with k = T(-2/sqrt(pi)) and s = T(sqrt(1/2)) passed in, every product
// flushed and rounded to T, and e = T(erfc(a)), ex = T(exp(-T(T(a)^2)))
// (a = -v * s) the terms that depend on v alone: one 32-bit entry (e low,
// ex high) of a table of all 65,536 bit patterns, written by XLA itself
// (tests/gen_torch_gelu_table.py), so no erfcf or expf runs here. The
// entries are constant for magnitudes below lo and above hi (each sign), so
// a bf16 CTA stages table[lo..hi] and table[0x8000 + lo..hi] (~13 KB) in
// shared memory once (whole 16-byte loads, every one in flight before any
// is stored) and reads v's entry at its magnitude clamped to [lo, hi].
// A thread takes 8 values of g and v in one 16-byte load each. Where all 16
// are regular (`regular8`: no zero, denormal, Inf or NaN can arise in the
// chain), a bf16 group runs the chain in bf16x2 arithmetic, one rounded
// instruction a step for two values (`packed8`); any other group runs it in
// fp32 with mul.rn.ftz (denormal operands and results flushed, as XLA's
// CPU backend runs) and one cvt a pair after each product (`grad2`), its
// entries from the window, or from the whole table in global memory where
// the group holds an Inf or NaN. fp16 always takes that fp32 chain and the
// table in global memory (its window would take ~120 KB).
// The ReLU mode's backward is one torch threshold_backward, and the bias's
// gradient a sum over the other dimensions, in the port.
//
// What bounds the three: bytes. Each element is read once and written once
// or twice (bias_act: 2 + 2 or 2 + 4 bytes; the fp32 mode 2 + 4, + 4 with
// a residual read once a period; gelu_grad 2 + 2 + 2), the bias a few
// hundred bytes: ~0.6 us a MiB at 3.35 TB/s. The GELU mode's erfcf costs
// ~116 instructions an element and can reach the issue rate instead;
// gelu_grad's table and bf16x2 chain keep it near 20. There is no product,
// so tensor cores, wgmma and TMA have no part; the design is about keeping
// enough 16-byte loads in flight and doing no per-element index arithmetic.
// For bias_act and the fp32 mode, plan() picks one of three work
// assignments for a call:
// - rows (div = 1, C % 8 == 0, C <= 2048, 16-byte aligned pointers): the
//   tensor as rows of C. A CTA holds rpc = 256 / G rows of G = C / 8
//   threads (every width of the path: CRAFT's 32-512, PARSEQ's 96, 384,
//   1536); a thread owns the fixed channels [(tid % G) * 8, + 8), loads
//   their 8 bias values once before its loop, and walks rows with a stride
//   of a whole number of rows (gridDim.x * rpc), kUnroll rows at a time
//   with their 16-byte loads issued together. The fp32 mode reads residual
//   row row % (period / C): one remainder a row, then two float4 loads.
// - planes (div > 1, div % 8 == 0, aligned, no residual: a contiguous
//   NCHW map): blockIdx.y is an (n, c) plane, whose one bias value the CTA
//   reads once; blockIdx.x a chunk of it, kUnroll 16-byte loads a thread.
// - scalar (anything else: C % 8 != 0, a view off 16-byte alignment, a
//   channel stride that is not a multiple of 8): one element a thread and
//   iteration, the channel (i / div) % C computed for each. Part of this
//   kernel, not a route to the plain version.
// Offsets are 32-bit where n <= 2^30 (the grid-stride loops then cannot
// overflow), 64-bit beyond. The rows and scalar grids are the CTAs that fit
// on the card at once (cudaOccupancyMaxActiveBlocksPerMultiprocessor x the
// SM count, read once per kernel and CTA size), or fewer for a small n.
// tests/test_torch_bias_act_model.py mirrors plan() and the three index
// maps in numpy.
//
// The entry points launch on the caller's stream, allocate nothing, do not
// synchronise, and return cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>
#include <type_traits>

namespace {

enum Act { kRelu = 0, kGelu = 1 };
enum Route { kRows = 0, kPlanes = 1, kScalar = 2 };

constexpr int kUnroll = 4;                 // 16-byte loads in flight a thread
constexpr int kRowThreads = 256;           // a rows CTA: 256 / G rows of G threads
constexpr int kMaxGroups = kRowThreads;    // G <= 256: C <= 2048 takes the rows route
constexpr int kThreads = 256;              // planes and scalar CTAs
constexpr int kPlaneChunk = kThreads * 8 * kUnroll;  // a plane's elements a CTA
constexpr long long kMaxI32 = 1LL << 30;   // n up to this: 32-bit offsets

__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f(__half v) { return __half2float(v); }
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}
template <> __device__ __forceinline__ __half from_f<__half>(float v) {
  return __float2half_rn(v);
}

// fp32 products and differences with denormal operands and results flushed
// to zero of the same sign (PTX .ftz), as XLA's CPU backend computes; the
// rest of the file keeps denormals.
__device__ __forceinline__ float mul_ftz(float a, float b) {
  float d;
  asm("mul.rn.ftz.f32 %0, %1, %2;" : "=f"(d) : "f"(a), "f"(b));
  return d;
}
__device__ __forceinline__ float sub_ftz(float a, float b) {
  float d;
  asm("sub.rn.ftz.f32 %0, %1, %2;" : "=f"(d) : "f"(a), "f"(b));
  return d;
}
__device__ __forceinline__ float ftz(float a) { return mul_ftz(a, 1.0f); }

template <typename T>
struct alignas(16) V8 {
  T v[8];
};

template <typename T>
__device__ __forceinline__ V8<T> ld8(const T* p) {
  V8<T> x;
  *reinterpret_cast<uint4*>(&x) = __ldg(reinterpret_cast<const uint4*>(p));
  return x;
}

template <typename T>
__device__ __forceinline__ void st8(T* p, const V8<T>& x) {
  *reinterpret_cast<uint4*>(p) = *reinterpret_cast<const uint4*>(&x);
}

__device__ __forceinline__ void ld8f(const float* p, float* x) {
  *reinterpret_cast<float4*>(x) = __ldg(reinterpret_cast<const float4*>(p));
  *reinterpret_cast<float4*>(x + 4) = __ldg(reinterpret_cast<const float4*>(p + 4));
}

__device__ __forceinline__ void st8f(float* p, const float* x) {
  *reinterpret_cast<float4*>(p) = *reinterpret_cast<const float4*>(x);
  *reinterpret_cast<float4*>(p + 4) = *reinterpret_cast<const float4*>(x + 4);
}

template <typename T, int kAct>
__device__ __forceinline__ T activate(T v, float s) {
  const float f = to_f(v);
  if (kAct == kRelu) return f < 0.0f ? from_f<T>(0.0f) : v;
  constexpr bool kHalf = std::is_same<T, __half>::value;
  float a = mul_ftz(f, -s);
  if (kHalf) a = to_f(from_f<T>(a));
  const float e = to_f(from_f<T>(ftz(erfcf(a))));
  float hx = mul_ftz(0.5f, f);  // exact in bf16
  if (kHalf) hx = to_f(from_f<T>(hx));
  return from_f<T>(mul_ftz(hx, e));
}

// Eight elements of tt_bias_act: o = act(v), m = v = T(x + bias).
template <typename T, int kAct>
__device__ __forceinline__ void act8(const V8<T>& x, const T* bt, bool bias, float s,
                                     V8<T>& o, V8<T>& m) {
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    T v = x.v[k];
    if (bias) v = from_f<T>(__fadd_rn(to_f(v), to_f(bt[k])));
    m.v[k] = v;
    o.v[k] = activate<T, kAct>(v, s);
  }
}

// Eight elements of tt_bias_add_f32: o = r + (x + bias), or x + bias.
template <typename T>
__device__ __forceinline__ void f32x8(const V8<T>& x, const T* bt, const float* r,
                                      bool res, float* o) {
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const float s = __fadd_rn(to_f(x.v[k]), to_f(bt[k]));
    o[k] = res ? __fadd_rn(r[k], s) : s;
  }
}

// The thread's 8 channels of the bias, read once (zeros without one) and
// widened where they are used, so the wait for them overlaps the first
// loads of the data.
template <typename T>
__device__ __forceinline__ void bias8(const T* b, int c0, T* bt) {
#pragma unroll
  for (int k = 0; k < 8; ++k) bt[k] = b ? b[c0 + k] : from_f<T>(0.0f);
}

// ---- tt_bias_act --------------------------------------------------------

template <typename T, typename I, int kAct>
__global__ void __launch_bounds__(kRowThreads)
bias_act_rows(const T* __restrict__ p, const T* __restrict__ b, T* __restrict__ y,
              T* __restrict__ pre, I rows, int G, int rpc, float s) {
  const int g = threadIdx.x % G, rr = threadIdx.x / G;
  if (rr >= rpc) return;
  const I C = (I)G * 8, c0 = (I)g * 8;
  T bt[8];
  bias8(b, g * 8, bt);
  const I step = (I)gridDim.x * rpc;
  for (I r = (I)blockIdx.x * rpc + rr; r < rows; r += step * kUnroll) {
    V8<T> x[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      if (r + u * step < rows) x[u] = ld8(p + (r + u * step) * C + c0);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const I ru = r + u * step;
      if (ru < rows) {
        V8<T> o, m;
        act8<T, kAct>(x[u], bt, b != nullptr, s, o, m);
        st8(y + ru * C + c0, o);
        if (pre) st8(pre + ru * C + c0, m);
      }
    }
  }
}

template <typename T, typename I, int kAct>
__global__ void __launch_bounds__(kThreads)
bias_act_planes(const T* __restrict__ p, const T* __restrict__ b, T* __restrict__ y,
                T* __restrict__ pre, I planes, int C, I hw, float s) {
  for (I pl = blockIdx.y; pl < planes; pl += gridDim.y) {
    T bt[8];
    const T bias = b ? b[pl % C] : from_f<T>(0.0f);
#pragma unroll
    for (int k = 0; k < 8; ++k) bt[k] = bias;
    const I base = pl * hw, i0 = (I)blockIdx.x * kPlaneChunk + (I)threadIdx.x * 8;
    V8<T> x[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      if (i0 + u * (kThreads * 8) < hw) x[u] = ld8(p + base + i0 + u * (kThreads * 8));
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const I i = base + i0 + u * (kThreads * 8);
      if (i0 + u * (kThreads * 8) < hw) {
        V8<T> o, m;
        act8<T, kAct>(x[u], bt, b != nullptr, s, o, m);
        st8(y + i, o);
        if (pre) st8(pre + i, m);
      }
    }
  }
}

template <typename T, typename I, int kAct>
__global__ void __launch_bounds__(kThreads)
bias_act_scalar(const T* __restrict__ p, const T* __restrict__ b, T* __restrict__ y,
                T* __restrict__ pre, I n, int C, I div, float s) {
  const I step = (I)gridDim.x * kThreads;
  for (I i = (I)blockIdx.x * kThreads + threadIdx.x; i < n; i += step) {
    T v = p[i];
    if (b) v = from_f<T>(__fadd_rn(to_f(v), to_f(b[(i / div) % C])));
    if (pre) pre[i] = v;
    y[i] = activate<T, kAct>(v, s);
  }
}

// ---- tt_bias_add_f32 ----------------------------------------------------

template <typename T, typename I>
__global__ void __launch_bounds__(kRowThreads)
bias_add_f32_rows(const T* __restrict__ y, const T* __restrict__ b, const float* __restrict__ r,
                  float* __restrict__ out, I rows, int G, int rpc, I prow) {
  const int g = threadIdx.x % G, rr = threadIdx.x / G;
  if (rr >= rpc) return;
  const I C = (I)G * 8, c0 = (I)g * 8;
  T bt[8];
  bias8(b, g * 8, bt);
  const I step = (I)gridDim.x * rpc;
  for (I row = (I)blockIdx.x * rpc + rr; row < rows; row += step * kUnroll) {
    V8<T> x[kUnroll];
    float res[kUnroll][8];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const I ru = row + u * step;
      if (ru < rows) {
        x[u] = ld8(y + ru * C + c0);
        if (r) ld8f(r + (ru % prow) * C + c0, res[u]);
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const I ru = row + u * step;
      if (ru < rows) {
        float o[8];
        f32x8(x[u], bt, res[u], r != nullptr, o);
        st8f(out + ru * C + c0, o);
      }
    }
  }
}

template <typename T, typename I>
__global__ void __launch_bounds__(kThreads)
bias_add_f32_planes(const T* __restrict__ y, const T* __restrict__ b, float* __restrict__ out,
                    I planes, int C, I hw) {
  for (I pl = blockIdx.y; pl < planes; pl += gridDim.y) {
    T bt[8];
    const T bias = b[pl % C];
#pragma unroll
    for (int k = 0; k < 8; ++k) bt[k] = bias;
    const I base = pl * hw, i0 = (I)blockIdx.x * kPlaneChunk + (I)threadIdx.x * 8;
    V8<T> x[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      if (i0 + u * (kThreads * 8) < hw) x[u] = ld8(y + base + i0 + u * (kThreads * 8));
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (i0 + u * (kThreads * 8) < hw) {
        float o[8];
        f32x8(x[u], bt, nullptr, false, o);
        st8f(out + base + i0 + u * (kThreads * 8), o);
      }
    }
  }
}

template <typename T, typename I>
__global__ void __launch_bounds__(kThreads)
bias_add_f32_scalar(const T* __restrict__ y, const T* __restrict__ b,
                    const float* __restrict__ r, float* __restrict__ out, I n, int C, I div,
                    I period) {
  const I step = (I)gridDim.x * kThreads;
  for (I i = (I)blockIdx.x * kThreads + threadIdx.x; i < n; i += step) {
    const float s = __fadd_rn(to_f(y[i]), to_f(b[(i / div) % C]));
    out[i] = r ? __fadd_rn(r[i % period], s) : s;
  }
}

// ---- tt_gelu_grad -------------------------------------------------------

constexpr int kGradThreads = 256;
constexpr uint32_t kSignBit = 0x8000;
constexpr int kStage = 4;  // 16-byte loads a thread to stage the window
// Staged entries a sign, at most: kStage loads of 4 entries by every
// thread, over both signs (16 KB).
constexpr int kMaxWindow = kStage * kGradThreads * 4 / 2;

// Two values of T packed in 32 bits <-> fp32; rnd2 rounds a pair to T with
// one cvt.
template <typename T> struct Pair;
template <> struct Pair<__nv_bfloat16> {
  static constexpr uint32_t kInf = 0x7f80;  // bit magnitude of Inf
  static __device__ __forceinline__ float lo(uint32_t w) { return __uint_as_float(w << 16); }
  static __device__ __forceinline__ float hi(uint32_t w) {
    return __uint_as_float(w & 0xffff0000u);
  }
  static __device__ __forceinline__ uint32_t pack(float a, float b) {
    const __nv_bfloat162 p = __floats2bfloat162_rn(a, b);
    return *reinterpret_cast<const uint32_t*>(&p);
  }
};
template <> struct Pair<__half> {
  static constexpr uint32_t kInf = 0x7c00;
  static __device__ __forceinline__ float lo(uint32_t w) {
    return __half2float(__ushort_as_half((unsigned short)(w & 0xffffu)));
  }
  static __device__ __forceinline__ float hi(uint32_t w) {
    return __half2float(__ushort_as_half((unsigned short)(w >> 16)));
  }
  static __device__ __forceinline__ uint32_t pack(float a, float b) {
    const __half2 p = __floats2half2_rn(a, b);
    return *reinterpret_cast<const uint32_t*>(&p);
  }
};

template <typename T>
__device__ __forceinline__ void rnd2(float& a, float& b) {
  const uint32_t w = Pair<T>::pack(a, b);
  a = Pair<T>::lo(w);
  b = Pair<T>::hi(w);
}

// A pair of gradients: gw and vw hold two values each (low half first),
// ta and tb the table entries of vw's two values -> two gradients packed.
template <typename T>
__device__ __forceinline__ uint32_t grad2(uint32_t gw, uint32_t vw, uint32_t ta, uint32_t tb,
                                          float s, float k) {
  using P = Pair<T>;
  constexpr bool kHalf = std::is_same<T, __half>::value;
  const float ga = P::lo(gw), gb = P::hi(gw);
  float xa = mul_ftz(P::lo(vw), 0.5f), xb = mul_ftz(P::hi(vw), 0.5f);  // T(0.5 v)
  if (kHalf) rnd2<T>(xa, xb);
  xa = mul_ftz(xa, ga), xb = mul_ftz(xb, gb);  // T(T(0.5 v) * g)
  rnd2<T>(xa, xb);
  xa = mul_ftz(xa, k), xb = mul_ftz(xb, k);
  rnd2<T>(xa, xb);
  xa = mul_ftz(xa, P::hi(ta)), xb = mul_ftz(xb, P::hi(tb));  // * ex
  rnd2<T>(xa, xb);
  xa = mul_ftz(xa, s), xb = mul_ftz(xb, s);
  rnd2<T>(xa, xb);
  float ma = mul_ftz(ga, P::lo(ta)), mb = mul_ftz(gb, P::lo(tb));  // T(g * e)
  rnd2<T>(ma, mb);
  ma = mul_ftz(ma, 0.5f), mb = mul_ftz(mb, 0.5f);  // exact in bf16
  if (kHalf) rnd2<T>(ma, mb);
  return P::pack(sub_ftz(ma, xa), sub_ftz(mb, xb));
}

// True if any of the 8 values in x (4 words of 2) is Inf or NaN: a 16-bit
// magnitude m >= kInf carries into bit 15 of its half when kInf's
// complement is added (no carry leaves the half: m < 0x8000).
template <typename T>
__device__ __forceinline__ bool special8(const uint4& x) {
  constexpr uint32_t add = ((0x8000u - Pair<T>::kInf) << 16) | (0x8000u - Pair<T>::kInf);
  const uint32_t m = ((x.x & 0x7fff7fffu) + add) | ((x.y & 0x7fff7fffu) + add) |
                     ((x.z & 0x7fff7fffu) + add) | ((x.w & 0x7fff7fffu) + add);
  return (m & 0x80008000u) != 0;
}

// The table entries of the two 16-bit patterns in w from the staged window
// (`win` points at the entry of magnitude 0, outside the staged range; the
// negative half lies span entries after the positive one): both magnitudes
// clamped to [lo, hi] in 16-bit lanes, then span added to a negative one's
// (lo2, hi2: lo and hi in both lanes; no lane carries into the other).
__device__ __forceinline__ void window_pair(const uint32_t* win, uint32_t w, uint32_t lo2,
                                            uint32_t hi2, int span, uint32_t& a, uint32_t& b) {
  uint32_t c, m = w & 0x7fff7fffu;
  asm("max.u16x2 %0, %1, %2;" : "=r"(c) : "r"(m), "r"(lo2));
  asm("min.u16x2 %0, %1, %2;" : "=r"(m) : "r"(c), "r"(hi2));
  m += ((w >> 15) & 0x00010001u) * (uint32_t)span;
  a = win[m & 0xffffu];
  b = win[m >> 16];
}

// True if the 8 values of g and of v in a group are all regular: every
// magnitude of g in [2^-30, 2^60), every one of v in [2^-30, 8). Then no
// product of the GELU gradient's chain, nor the difference, is zero,
// denormal, infinite or NaN (the least is t3 >= 2^-61 * exp(-32.1) * 2^-1
// > 2^-110, the most 2^63), so flushing changes nothing and each fp32
// product, exact, rounded once to bf16 equals the bf16 product rounded
// once. Per half, bit 15 of m + (0x8000 - L) is set iff m >= L.
__device__ __forceinline__ bool regular8(const uint4& g, const uint4& v) {
  constexpr uint32_t kLo = 0x8000u - 0x3080u;     // 2^-30
  constexpr uint32_t kHiV = 0x8000u - 0x4100u;    // 8
  constexpr uint32_t kHiG = 0x8000u - 0x5d80u;    // 2^60
  const uint32_t lo2 = kLo << 16 | kLo, hv2 = kHiV << 16 | kHiV, hg2 = kHiG << 16 | kHiG;
  const uint32_t gw[4] = {g.x, g.y, g.z, g.w}, vw[4] = {v.x, v.y, v.z, v.w};
  uint32_t all_lo = 0xffffffffu, any_hi = 0;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const uint32_t mg = gw[j] & 0x7fff7fffu, mv = vw[j] & 0x7fff7fffu;
    all_lo &= (mg + lo2) & (mv + lo2);
    any_hi |= (mg + hg2) | (mv + hv2);
  }
  return ((all_lo & ~any_hi) & 0x80008000u) == 0x80008000u;
}

// bf16x2 product and difference, each half rounded once to nearest even;
// the explicit .rn keeps them from being contracted into one fma.
__device__ __forceinline__ uint32_t bmul2(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("mul.rn.bf16x2 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b));
  return d;
}
__device__ __forceinline__ uint32_t bsub2(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("sub.rn.bf16x2 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b));
  return d;
}

// Eight gradients of a regular bf16 group (`regular8`): each pair's chain in
// bf16x2 arithmetic, one instruction a step for two values; e and ex of a
// pair gathered from its two table entries by one byte permute each.
__device__ __forceinline__ uint4 packed8(const uint4& g, const uint4& v, const uint32_t* t,
                                        float s, float k) {
  const uint32_t half2 = 0x3f003f00u;  // 0.5, 0.5
  const uint32_t s2 = Pair<__nv_bfloat16>::pack(s, s), k2 = Pair<__nv_bfloat16>::pack(k, k);
  const uint32_t gw[4] = {g.x, g.y, g.z, g.w}, vw[4] = {v.x, v.y, v.z, v.w};
  uint32_t o[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const uint32_t e2 = __byte_perm(t[2 * j], t[2 * j + 1], 0x5410);
    const uint32_t ex2 = __byte_perm(t[2 * j], t[2 * j + 1], 0x7632);
    const uint32_t tt = bmul2(bmul2(bmul2(bmul2(bmul2(vw[j], half2), gw[j]), k2), ex2), s2);
    o[j] = bsub2(bmul2(bmul2(gw[j], e2), half2), tt);
  }
  return make_uint4(o[0], o[1], o[2], o[3]);
}

// Eight gradients of a group: g and v as 4 words each. The entries come
// from the window (kWindow and no Inf or NaN in v) or from the table in
// global memory, read once for either path; a regular bf16 group then
// takes `packed8`, any other the fp32 chain (`grad2`) with its flushes.
template <typename T, bool kWindow>
__device__ __forceinline__ uint4 grad8(const uint4& g, const uint4& v, const uint32_t* win,
                                       const uint32_t* __restrict__ table, int lo, int hi,
                                       int span, float s, float k) {
  const uint32_t gw[4] = {g.x, g.y, g.z, g.w}, vw[4] = {v.x, v.y, v.z, v.w};
  constexpr bool kPacked = kWindow && std::is_same<T, __nv_bfloat16>::value;
  const bool fast = kPacked && regular8(g, v);
  uint32_t t[8];
  if (fast || (kWindow && !special8<T>(v))) {
    const uint32_t lo2 = (uint32_t)lo << 16 | (uint32_t)lo, hi2 = (uint32_t)hi << 16 | (uint32_t)hi;
#pragma unroll
    for (int j = 0; j < 4; ++j) window_pair(win, vw[j], lo2, hi2, span, t[2 * j], t[2 * j + 1]);
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      t[2 * j] = __ldg(table + (vw[j] & 0xffffu));
      t[2 * j + 1] = __ldg(table + (vw[j] >> 16));
    }
  }
  if (fast) return packed8(g, v, t, s, k);
  uint32_t o[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) o[j] = grad2<T>(gw[j], vw[j], t[2 * j], t[2 * j + 1], s, k);
  return make_uint4(o[0], o[1], o[2], o[3]);
}

// A group of up to 8 elements at i0 (cnt of them), loaded 16 bytes at a
// time where kVec and the group is whole, else element by element with the
// rest zero (their results are not stored); cnt is 8, a constant, in the
// main loop.
template <typename T, bool kVec, typename I>
__device__ __forceinline__ void load8(const T* __restrict__ p, I i0, int cnt, uint4& x) {
  if (kVec && cnt == 8) {
    x = __ldg(reinterpret_cast<const uint4*>(p + i0));
  } else {
    uint16_t h[8] = {0, 0, 0, 0, 0, 0, 0, 0};
    for (int j = 0; j < cnt; ++j) h[j] = reinterpret_cast<const uint16_t*>(p)[i0 + j];
    x = make_uint4(h[0] | (uint32_t)h[1] << 16, h[2] | (uint32_t)h[3] << 16,
                   h[4] | (uint32_t)h[5] << 16, h[6] | (uint32_t)h[7] << 16);
  }
}

template <typename T, bool kVec, typename I>
__device__ __forceinline__ void store8(T* __restrict__ p, I i0, int cnt, const uint4& x) {
  if (kVec && cnt == 8) {
    *reinterpret_cast<uint4*>(p + i0) = x;
  } else {
    const uint32_t w[4] = {x.x, x.y, x.z, x.w};
    for (int j = 0; j < cnt; ++j)
      reinterpret_cast<uint16_t*>(p)[i0 + j] = (uint16_t)(w[j / 2] >> (16 * (j % 2)));
  }
}

// The window as staged: table[lo4..hi4) and table[0x8000 + lo4..hi4), lo4 and
// hi4 the window's ends rounded out to multiples of 4 entries (16 bytes).
__host__ __device__ __forceinline__ int stage_lo(int lo) { return lo & ~3; }
__host__ __device__ __forceinline__ int stage_span(int lo, int hi) {
  return ((hi | 3) + 1) - stage_lo(lo);
}

// A persistent grid: each thread walks whole groups of 8 elements and loads
// its next group before it computes the current one, so a load stays in
// flight while it computes and stores; its first loads go out before the
// window is staged (every thread's kStage 16-byte loads issued before any is
// stored), so those waits overlap too. The last n % 8 elements, if any, are
// one thread's after its loop. Offsets are I: int where n < 2^31.
template <typename T, typename I, bool kVec, bool kWindow>
__global__ void __launch_bounds__(kGradThreads)
gelu_grad_kernel(const T* __restrict__ g, const T* __restrict__ v, T* __restrict__ out,
                 const uint32_t* __restrict__ table, I n, int lo, int hi, float s, float k) {
  extern __shared__ uint4 win4[];
  const uint32_t* win = reinterpret_cast<const uint32_t*>(win4);
  const int lo4 = stage_lo(lo), span = stage_span(lo, hi);
  const I full = n / 8, step = (I)gridDim.x * kGradThreads;
  I q = (I)blockIdx.x * kGradThreads + threadIdx.x;
  uint4 gi, vi;
  if (q < full) {
    load8<T, kVec>(g, q * 8, 8, gi);
    load8<T, kVec>(v, q * 8, 8, vi);
  }
  if (kWindow) {
    const int n4 = span / 4;
    const uint4* t4 = reinterpret_cast<const uint4*>(table);
    uint4 w[kStage];
#pragma unroll
    for (int j = 0; j < kStage; ++j) {
      const int i = threadIdx.x + j * kGradThreads;
      if (i < 2 * n4) w[j] = __ldg(t4 + (i < n4 ? lo4 / 4 + i : (kSignBit + lo4) / 4 + i - n4));
    }
#pragma unroll
    for (int j = 0; j < kStage; ++j) {
      const int i = threadIdx.x + j * kGradThreads;
      if (i < 2 * n4) win4[i] = w[j];
    }
    __syncthreads();
  }
  for (; q < full; q += step) {
    uint4 gn, vn;
    if (q + step < full) {
      load8<T, kVec>(g, (q + step) * 8, 8, gn);
      load8<T, kVec>(v, (q + step) * 8, 8, vn);
    }
    store8<T, kVec>(out, q * 8, 8, grad8<T, kWindow>(gi, vi, win - lo4, table, lo, hi, span, s, k));
    gi = gn;
    vi = vn;
  }
  const int rem = (int)(n - full * 8);
  if (rem && blockIdx.x == 0 && threadIdx.x == 0) {
    uint4 gt, vt;
    load8<T, false>(g, full * 8, rem, gt);
    load8<T, false>(v, full * 8, rem, vt);
    store8<T, false>(out, full * 8, rem,
                     grad8<T, kWindow>(gt, vt, win - lo4, table, lo, hi, span, s, k));
  }
}

// ---- launch plans -------------------------------------------------------

bool aligned16(const void* a) { return ((uintptr_t)a & 15) == 0; }

// The work assignment of a call (see the note at the top); `aligned`:
// every pointer read or written in 16-byte units is 16-byte aligned (null
// ones count as aligned); `res`: a residual is given.
int plan(long long n, int C, long long div, long long period, bool aligned, bool res) {
  if (!aligned) return kScalar;
  if (div == 1 && C % 8 == 0 && C / 8 <= kMaxGroups && n % C == 0 && (!res || period % C == 0))
    return kRows;
  if (div > 1 && div % 8 == 0 && !res && n % (div * C) == 0) return kPlanes;
  return kScalar;
}

int sm_count() {
  static std::atomic<int> sms{0};
  int v = sms.load(std::memory_order_relaxed);
  if (!v) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&v, cudaDevAttrMultiProcessorCount, dev);
    if (v <= 0) v = 132;
    sms.store(v, std::memory_order_relaxed);
  }
  return v;
}

// The CTAs of `threads` threads of `kernel` that fit on the card at once;
// `cache` (one a kernel, indexed by CTA size) keeps the occupancy query to
// the first launch of each size.
template <typename Kernel>
long long resident(Kernel kernel, int threads, std::atomic<int>* cache) {
  int v = cache[threads].load(std::memory_order_relaxed);
  if (!v) {
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&v, kernel, threads, 0);
    if (v <= 0) v = 1;
    cache[threads].store(v, std::memory_order_relaxed);
  }
  return (long long)v * sm_count();
}

long long min_ll(long long a, long long b) { return a < b ? a : b; }

// A rows CTA: rpc rows of G threads.
void row_shape(int C, int* G, int* rpc) {
  *G = C / 8;
  *rpc = kRowThreads / *G;
}

template <typename T, typename I, int kAct>
void launch_act(int route, const T* p, const T* b, T* y, T* pre, long long n, int C,
                long long div, float s, cudaStream_t st) {
  if (route == kRows) {
    static std::atomic<int> occ[kMaxGroups + 1];
    int G, rpc;
    row_shape(C, &G, &rpc);
    const long long rows = n / C;
    const long long grid = min_ll((rows + rpc - 1) / rpc,
                                  resident(bias_act_rows<T, I, kAct>, G * rpc, occ));
    bias_act_rows<T, I, kAct><<<(unsigned)grid, G * rpc, 0, st>>>(p, b, y, pre, (I)rows, G, rpc,
                                                                  s);
  } else if (route == kPlanes) {
    const long long planes = n / div;
    const dim3 grid((unsigned)((div + kPlaneChunk - 1) / kPlaneChunk),
                    (unsigned)min_ll(planes, 65535));
    bias_act_planes<T, I, kAct><<<grid, kThreads, 0, st>>>(p, b, y, pre, (I)planes, C, (I)div,
                                                           s);
  } else {
    static std::atomic<int> occ[kMaxGroups + 1];
    const long long grid = min_ll((n + kThreads - 1) / kThreads,
                                  resident(bias_act_scalar<T, I, kAct>, kThreads, occ));
    bias_act_scalar<T, I, kAct><<<(unsigned)grid, kThreads, 0, st>>>(p, b, y, pre, (I)n, C,
                                                                     (I)div, s);
  }
}

template <typename T, typename I>
void launch_f32(int route, const T* y, const T* b, const float* r, float* out, long long n,
                int C, long long div, long long period, cudaStream_t st) {
  if (route == kRows) {
    static std::atomic<int> occ[kMaxGroups + 1];
    int G, rpc;
    row_shape(C, &G, &rpc);
    const long long rows = n / C;
    const long long grid = min_ll((rows + rpc - 1) / rpc,
                                  resident(bias_add_f32_rows<T, I>, G * rpc, occ));
    bias_add_f32_rows<T, I><<<(unsigned)grid, G * rpc, 0, st>>>(y, b, r, out, (I)rows, G, rpc,
                                                                (I)(r ? period / C : 1));
  } else if (route == kPlanes) {
    const long long planes = n / div;
    const dim3 grid((unsigned)((div + kPlaneChunk - 1) / kPlaneChunk),
                    (unsigned)min_ll(planes, 65535));
    bias_add_f32_planes<T, I><<<grid, kThreads, 0, st>>>(y, b, out, (I)planes, C, (I)div);
  } else {
    static std::atomic<int> occ[kMaxGroups + 1];
    const long long grid = min_ll((n + kThreads - 1) / kThreads,
                                  resident(bias_add_f32_scalar<T, I>, kThreads, occ));
    bias_add_f32_scalar<T, I><<<(unsigned)grid, kThreads, 0, st>>>(y, b, r, out, (I)n, C,
                                                                   (I)div, (I)period);
  }
}

template <typename T, typename I>
void act_by_kind(int act, int route, const void* p, const void* b, void* y, void* pre,
                 long long n, int C, long long div, float s, cudaStream_t st) {
  if (act == kRelu)
    launch_act<T, I, kRelu>(route, (const T*)p, (const T*)b, (T*)y, (T*)pre, n, C, div, s, st);
  else
    launch_act<T, I, kGelu>(route, (const T*)p, (const T*)b, (T*)y, (T*)pre, n, C, div, s, st);
}

template <typename T>
void act_by_index(int act, int route, const void* p, const void* b, void* y, void* pre,
                  long long n, int C, long long div, float s, cudaStream_t st) {
  if (n <= kMaxI32) act_by_kind<T, int>(act, route, p, b, y, pre, n, C, div, s, st);
  else act_by_kind<T, long long>(act, route, p, b, y, pre, n, C, div, s, st);
}

template <typename T>
void f32_by_index(int route, const void* y, const void* b, const void* r, void* out,
                  long long n, int C, long long div, long long period, cudaStream_t st) {
  if (n <= kMaxI32)
    launch_f32<T, int>(route, (const T*)y, (const T*)b, (const float*)r, (float*)out, n, C, div,
                       period, st);
  else
    launch_f32<T, long long>(route, (const T*)y, (const T*)b, (const float*)r, (float*)out, n,
                             C, div, period, st);
}

template <typename T, typename I, bool kVec, bool kWindow>
void launch_grad_as(const T* g, const T* v, T* out, const uint32_t* table, long long n, int lo,
                    int hi, float s, float k, cudaStream_t st) {
  static std::atomic<int> occ{0};
  const size_t smem = kWindow ? 2 * (size_t)stage_span(lo, hi) * sizeof(uint32_t) : 0;
  // The occupancy query runs at the first launch: the window's size is
  // fixed for a dtype, so its answer holds for the later ones.
  int blocks = occ.load(std::memory_order_relaxed);
  if (!blocks) {
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, gelu_grad_kernel<T, I, kVec, kWindow>,
                                                  kGradThreads, smem);
    if (blocks <= 0) blocks = 1;
    occ.store(blocks, std::memory_order_relaxed);
  }
  const long long want = (n / 8 + kGradThreads - 1) / kGradThreads;
  const long long grid = want < 1 ? 1 : min_ll(want, (long long)blocks * sm_count());
  gelu_grad_kernel<T, I, kVec, kWindow><<<(unsigned)grid, kGradThreads, smem, st>>>(
      g, v, out, table, (I)n, lo, hi, s, k);
}

template <typename T, bool kWindow>
void launch_grad(const void* g, const void* v, void* out, const void* table, long long n, int lo,
                 int hi, float s, float k, cudaStream_t st) {
  const T *gt = (const T*)g, *vt = (const T*)v;
  const uint32_t* tab = (const uint32_t*)table;
  const bool vec = aligned16(g) && aligned16(v) && aligned16(out);
  if (n < (1LL << 31)) {
    if (vec) launch_grad_as<T, int, true, kWindow>(gt, vt, (T*)out, tab, n, lo, hi, s, k, st);
    else launch_grad_as<T, int, false, kWindow>(gt, vt, (T*)out, tab, n, lo, hi, s, k, st);
  } else {
    if (vec) launch_grad_as<T, long long, true, kWindow>(gt, vt, (T*)out, tab, n, lo, hi, s, k, st);
    else launch_grad_as<T, long long, false, kWindow>(gt, vt, (T*)out, tab, n, lo, hi, s, k, st);
  }
}

}  // namespace

// dtype 0 bf16, 1 fp16; table: the dtype's 65,536 entries (e | ex << 16);
// lo <= hi: the window of bit magnitudes outside which the entries of each
// sign are constant (bf16 stages it; fp16 reads the table directly).
extern "C" int tt_gelu_grad(const void* g, const void* v, void* out, const void* table,
                            int dtype, int lo, int hi, long long n, float s, float k,
                            void* stream) {
  if (n <= 0 || dtype < 0 || dtype > 1 || !table ||
      (dtype == 0 && (lo < 0 || hi < lo || hi >= 0x7f80 || stage_span(lo, hi) > kMaxWindow)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0) launch_grad<__nv_bfloat16, true>(g, v, out, table, n, lo, hi, s, k, st);
  else launch_grad<__half, false>(g, v, out, table, n, lo, hi, s, k, st);
  return (int)cudaGetLastError();
}

// mode = dtype * 4 + act: dtype 0 bf16, 1 fp16; act 0 ReLU, 1 GELU.
extern "C" int tt_bias_act(const void* p, const void* b, void* y, void* pre, int C, int mode,
                           long long n, long long div, float s, void* stream) {
  if (n <= 0 || C <= 0 || div <= 0 || (mode & 3) > kGelu || mode / 4 > 1)
    return (int)cudaErrorInvalidValue;
  const int route = plan(n, C, div, 0, aligned16(p) && aligned16(y) && aligned16(pre), false);
  cudaStream_t st = (cudaStream_t)stream;
  if (mode / 4 == 0) act_by_index<__nv_bfloat16>(mode & 3, route, p, b, y, pre, n, C, div, s, st);
  else act_by_index<__half>(mode & 3, route, p, b, y, pre, n, C, div, s, st);
  return (int)cudaGetLastError();
}

// dtype 0 bf16, 1 fp16; r may be null (period ignored), else div = 1 and
// period > 0.
extern "C" int tt_bias_add_f32(const void* y, const void* b, const void* r, void* out, int C,
                               int dtype, long long n, long long div, long long period,
                               void* stream) {
  if (!b || n <= 0 || C <= 0 || div <= 0 || dtype < 0 || dtype > 1 || (r && period <= 0) ||
      (r && div != 1))
    return (int)cudaErrorInvalidValue;
  const int route = plan(n, C, div, period, aligned16(y) && aligned16(r) && aligned16(out),
                         r != nullptr);
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0) f32_by_index<__nv_bfloat16>(route, y, b, r, out, n, C, div, period, st);
  else f32_by_index<__half>(route, y, b, r, out, n, C, div, period, st);
  return (int)cudaGetLastError();
}

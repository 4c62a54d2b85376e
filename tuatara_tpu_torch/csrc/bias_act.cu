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
//   y = ReLU(v) | T(0.5f * float(v) * float(T(erfcf(-float(v) * s))))
// with s = T(sqrt(0.5)) passed in; pre (optional) gets v. The __f*_rn
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
// tt_gelu_grad: the GELU mode's backward for the training graph. g [n] and
// v [n] in T, the output's gradient and the pre-activation value, any
// memory order (elementwise) -> gv [n] in T, the gradient autograd takes
// through the plain version (kernels/bias_act.py gelu_plain_grad), op for
// op in fp32 with that version's roundings to T:
//   a = f * c, c = -s                          (f = float(v))
//   e = float(T(erfcf(a)))
//   ge = float(T(g * (f * 0.5f)))
//   ga = (expf(-(a * a)) * k) * ge,  k = float(-2 / sqrt(pi)) passed in
//   gv = T(ga * c + (g * e) * 0.5f)
// The ReLU mode's backward is one torch threshold_backward, and the bias's
// gradient a sum over the other dimensions, in the port.
//
// What bounds the three: bytes. Each element is read once and written once
// or twice (bias_act: 2 + 2 or 2 + 4 bytes; the fp32 mode 2 + 4, + 4 with
// a residual read once a period), the bias a few hundred bytes: ~0.6 us a
// MiB at 3.35 TB/s. There is no product, so tensor cores, wgmma and TMA
// have no part; the design is about keeping enough 16-byte loads in flight
// and doing no per-element index arithmetic. plan() picks one of three
// work assignments for a call:
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
  const float e = to_f(from_f<T>(erfcf(__fmul_rn(f, -s))));
  return from_f<T>(__fmul_rn(__fmul_rn(0.5f, f), e));
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

template <typename T>
__device__ __forceinline__ T gelu_grad(T gt, T vt, float s, float k) {
  const float f = to_f(vt);
  const float c = -s;
  const float a = __fmul_rn(f, c);
  const float e = to_f(from_f<T>(erfcf(a)));
  const float g = to_f(gt);
  const float ge = to_f(from_f<T>(__fmul_rn(g, __fmul_rn(f, 0.5f))));
  const float ga = __fmul_rn(__fmul_rn(expf(-__fmul_rn(a, a)), k), ge);
  return from_f<T>(__fadd_rn(__fmul_rn(ga, c), __fmul_rn(__fmul_rn(g, e), 0.5f)));
}

template <typename T, bool kVec>
__global__ void __launch_bounds__(kThreads)
gelu_grad_kernel(const T* __restrict__ g, const T* __restrict__ v, T* __restrict__ out,
                 int64_t n, float s, float k) {
  const int64_t groups = (n + 7) / 8;
  for (int64_t grp = blockIdx.x * (int64_t)kThreads + threadIdx.x; grp < groups;
       grp += (int64_t)gridDim.x * kThreads) {
    const int64_t i0 = grp * 8;
    const int cnt = n - i0 < 8 ? (int)(n - i0) : 8;
    V8<T> gi, vi, oi;
    if (kVec && cnt == 8) {
      gi = ld8(g + i0);
      vi = ld8(v + i0);
    } else {
      for (int j = 0; j < cnt; ++j) {
        gi.v[j] = g[i0 + j];
        vi.v[j] = v[i0 + j];
      }
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      if (j < cnt) oi.v[j] = gelu_grad<T>(gi.v[j], vi.v[j], s, k);
    }
    if (kVec && cnt == 8) {
      st8(out + i0, oi);
    } else {
      for (int j = 0; j < cnt; ++j) out[i0 + j] = oi.v[j];
    }
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

template <typename T>
void launch_grad(const void* g, const void* v, void* out, int64_t n, float s, float k,
                 cudaStream_t st) {
  static std::atomic<int> occ_vec[kMaxGroups + 1], occ_any[kMaxGroups + 1];
  const long long groups = (n + 7) / 8;
  if (aligned16(g) && aligned16(v) && aligned16(out)) {
    const long long grid = min_ll((groups + kThreads - 1) / kThreads,
                                  resident(gelu_grad_kernel<T, true>, kThreads, occ_vec));
    gelu_grad_kernel<T, true><<<(unsigned)grid, kThreads, 0, st>>>(
        (const T*)g, (const T*)v, (T*)out, n, s, k);
  } else {
    const long long grid = min_ll((groups + kThreads - 1) / kThreads,
                                  resident(gelu_grad_kernel<T, false>, kThreads, occ_any));
    gelu_grad_kernel<T, false><<<(unsigned)grid, kThreads, 0, st>>>(
        (const T*)g, (const T*)v, (T*)out, n, s, k);
  }
}

}  // namespace

// dtype 0 bf16, 1 fp16.
extern "C" int tt_gelu_grad(const void* g, const void* v, void* out, int dtype, long long n,
                            float s, float k, void* stream) {
  if (n <= 0 || dtype < 0 || dtype > 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0) launch_grad<__nv_bfloat16>(g, v, out, n, s, k, st);
  else launch_grad<__half>(g, v, out, n, s, k, st);
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

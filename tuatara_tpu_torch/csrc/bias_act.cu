// BA: a product's bias add and the activation after it, at a 16-bit
// compute dtype, for Hopper (sm_90a).
//
// Replaces no TPU kernel. The JAX package's conv2d and linear
// (tuatara_tpu/models/layers.py:84-95, 387-393) round a bf16 product to
// bf16 and then add the bias cast to bf16, with a second rounding. cuDNN
// and cuBLAS add a bias in fp32 before their one rounding, so the port
// asks them for the product alone and adds the bias here, in the same
// pass as the ReLU (CRAFT) or the exact GELU (PARSEQ) that follows it.
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
// What bounds it: bytes. Each element is read once and written once or
// twice (2 + 2 or 2 + 4 bytes), the bias stays in L1: ~0.9 us for a 1 MiB
// activation at 3.35 TB/s. A thread moves 8 elements as one 16-byte load
// and store when the pointers allow it; the channel of each element is
// stepped from the group's first, so a group costs two divisions.
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
// tt_bias_add_f32: the fp32-output mode, for a Linear whose sum goes
// straight into an fp32 op (PARSEQ's residual adds, patch_embed +
// pos_embed; in the training graph also the head before the PLM loss's
// fp32 log-softmax). There XLA's CPU backend adds the bias in fp32 and
// never rounds the sum to T, so nor does this mode. y [n] in T, a Linear's
// product [..., C] (contiguous, already rounded to T); b [C] in T,
// widened in registers; r in fp32 or null, the residual, one period of
// `period` elements repeated over y's leading dimensions (period = n for
// a residual of y's shape; S * D for pos_embed [1, S, D]). Per element:
//   out = r[i % period] + (float(y) + float(b[i % C]))   (fp32, that order)
// with __fadd_rn, so the kernel equals the plain version
// (kernels/bias_act.py bias_add_f32_plain) bit for bit. Its backward is
// casts and sums in the port. What bounds it: bytes (2 + 4 read, 4
// written an element: ~4.7 us for a [32, 128, 384] slab at 3.35 TB/s);
// a thread moves 8 elements as one 16-byte load of y, two of r and two
// 16-byte stores when the pointers and the period allow it.
//
// The entry points launch on the caller's stream, allocate nothing, do not
// synchronise, and return cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

enum Act { kRelu = 0, kGelu = 1 };

__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f(__half v) { return __half2float(v); }
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}
template <> __device__ __forceinline__ __half from_f<__half>(float v) {
  return __float2half_rn(v);
}

template <typename T, int kAct>
__device__ __forceinline__ T activate(T v, float s) {
  const float f = to_f(v);
  if (kAct == kRelu) return f < 0.0f ? from_f<T>(0.0f) : v;
  const float e = to_f(from_f<T>(erfcf(__fmul_rn(f, -s))));
  return from_f<T>(__fmul_rn(__fmul_rn(0.5f, f), e));
}

template <typename T, int kAct, bool kBias, bool kPre, bool kVec>
__global__ void bias_act_kernel(const T* __restrict__ p, const T* __restrict__ b,
                                T* __restrict__ y, T* __restrict__ pre, int64_t n, int C,
                                int64_t div, float s) {
  const int64_t groups = (n + 7) / 8;
  for (int64_t g = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; g < groups;
       g += (int64_t)gridDim.x * blockDim.x) {
    const int64_t i0 = g * 8;
    const int cnt = n - i0 < 8 ? (int)(n - i0) : 8;
    alignas(16) T in[8];
    alignas(16) T out[8];
    alignas(16) T mid[8];
    if (kVec && cnt == 8) {
      *reinterpret_cast<uint4*>(in) = __ldg(reinterpret_cast<const uint4*>(p + i0));
    } else {
      for (int k = 0; k < cnt; ++k) in[k] = p[i0 + k];
    }
    const int64_t q = i0 / div;
    int64_t r = i0 - q * div;
    int c = (int)(q % C);
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      if (k < cnt) {
        T v = in[k];
        if (kBias) v = from_f<T>(__fadd_rn(to_f(v), to_f(b[c])));
        mid[k] = v;
        out[k] = activate<T, kAct>(v, s);
      }
      if (++r == div) {
        r = 0;
        if (++c == C) c = 0;
      }
    }
    if (kVec && cnt == 8) {
      *reinterpret_cast<uint4*>(y + i0) = *reinterpret_cast<const uint4*>(out);
      if (kPre) *reinterpret_cast<uint4*>(pre + i0) = *reinterpret_cast<const uint4*>(mid);
    } else {
      for (int k = 0; k < cnt; ++k) {
        y[i0 + k] = out[k];
        if (kPre) pre[i0 + k] = mid[k];
      }
    }
  }
}

template <typename T, int kAct, bool kBias, bool kPre>
void launch(const void* p, const void* b, void* y, void* pre, int64_t n, int C, int64_t div,
            float s, cudaStream_t stream) {
  const int threads = 256;
  const int64_t groups = (n + 7) / 8;
  int64_t blocks = (groups + threads - 1) / threads;
  if (blocks > 132 * 32) blocks = 132 * 32;
  const bool vec = ((uintptr_t)p | (uintptr_t)y | (uintptr_t)pre) % 16 == 0;
  if (vec) {
    bias_act_kernel<T, kAct, kBias, kPre, true><<<(int)blocks, threads, 0, stream>>>(
        (const T*)p, (const T*)b, (T*)y, (T*)pre, n, C, div, s);
  } else {
    bias_act_kernel<T, kAct, kBias, kPre, false><<<(int)blocks, threads, 0, stream>>>(
        (const T*)p, (const T*)b, (T*)y, (T*)pre, n, C, div, s);
  }
}

template <typename T, int kAct>
void dispatch_flags(const void* p, const void* b, void* y, void* pre, int64_t n, int C,
                    int64_t div, float s, cudaStream_t stream) {
  if (b && pre) launch<T, kAct, true, true>(p, b, y, pre, n, C, div, s, stream);
  else if (b) launch<T, kAct, true, false>(p, b, y, pre, n, C, div, s, stream);
  else if (pre) launch<T, kAct, false, true>(p, b, y, pre, n, C, div, s, stream);
  else launch<T, kAct, false, false>(p, b, y, pre, n, C, div, s, stream);
}

template <typename T>
void dispatch_act(int act, const void* p, const void* b, void* y, void* pre, int64_t n, int C,
                  int64_t div, float s, cudaStream_t stream) {
  if (act == kRelu) dispatch_flags<T, kRelu>(p, b, y, pre, n, C, div, s, stream);
  else dispatch_flags<T, kGelu>(p, b, y, pre, n, C, div, s, stream);
}

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
__global__ void gelu_grad_kernel(const T* __restrict__ g, const T* __restrict__ v,
                                 T* __restrict__ out, int64_t n, float s, float k) {
  const int64_t groups = (n + 7) / 8;
  for (int64_t grp = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; grp < groups;
       grp += (int64_t)gridDim.x * blockDim.x) {
    const int64_t i0 = grp * 8;
    const int cnt = n - i0 < 8 ? (int)(n - i0) : 8;
    alignas(16) T gi[8];
    alignas(16) T vi[8];
    alignas(16) T oi[8];
    if (kVec && cnt == 8) {
      *reinterpret_cast<uint4*>(gi) = __ldg(reinterpret_cast<const uint4*>(g + i0));
      *reinterpret_cast<uint4*>(vi) = __ldg(reinterpret_cast<const uint4*>(v + i0));
    } else {
      for (int j = 0; j < cnt; ++j) {
        gi[j] = g[i0 + j];
        vi[j] = v[i0 + j];
      }
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      if (j < cnt) oi[j] = gelu_grad<T>(gi[j], vi[j], s, k);
    }
    if (kVec && cnt == 8) {
      *reinterpret_cast<uint4*>(out + i0) = *reinterpret_cast<const uint4*>(oi);
    } else {
      for (int j = 0; j < cnt; ++j) out[i0 + j] = oi[j];
    }
  }
}

template <typename T>
void launch_grad(const void* g, const void* v, void* out, int64_t n, float s, float k,
                 cudaStream_t stream) {
  const int threads = 256;
  int64_t blocks = ((n + 7) / 8 + threads - 1) / threads;
  if (blocks > 132 * 32) blocks = 132 * 32;
  if (((uintptr_t)g | (uintptr_t)v | (uintptr_t)out) % 16 == 0) {
    gelu_grad_kernel<T, true><<<(int)blocks, threads, 0, stream>>>(
        (const T*)g, (const T*)v, (T*)out, n, s, k);
  } else {
    gelu_grad_kernel<T, false><<<(int)blocks, threads, 0, stream>>>(
        (const T*)g, (const T*)v, (T*)out, n, s, k);
  }
}

template <typename T, bool kRes, bool kVec>
__global__ void bias_add_f32_kernel(const T* __restrict__ y, const T* __restrict__ b,
                                    const float* __restrict__ r, float* __restrict__ out,
                                    int64_t n, int C, int64_t period) {
  const int64_t groups = (n + 7) / 8;
  for (int64_t g = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; g < groups;
       g += (int64_t)gridDim.x * blockDim.x) {
    const int64_t i0 = g * 8;
    const int cnt = n - i0 < 8 ? (int)(n - i0) : 8;
    alignas(16) T in[8];
    alignas(16) float res[8];
    alignas(16) float o[8];
    int64_t j = kRes ? i0 % period : 0;
    if (kVec && cnt == 8) {
      *reinterpret_cast<uint4*>(in) = __ldg(reinterpret_cast<const uint4*>(y + i0));
      if (kRes) {
        // period % 8 == 0 here, so the group does not wrap.
        *reinterpret_cast<float4*>(res) = __ldg(reinterpret_cast<const float4*>(r + j));
        *reinterpret_cast<float4*>(res + 4) = __ldg(reinterpret_cast<const float4*>(r + j + 4));
      }
    } else {
      for (int k = 0; k < cnt; ++k) {
        in[k] = y[i0 + k];
        if (kRes) {
          res[k] = r[j];
          if (++j == period) j = 0;
        }
      }
    }
    int c = (int)(i0 % C);
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      if (k < cnt) {
        float s = __fadd_rn(to_f(in[k]), to_f(b[c]));
        if (kRes) s = __fadd_rn(res[k], s);
        o[k] = s;
      }
      if (++c == C) c = 0;
    }
    if (kVec && cnt == 8) {
      *reinterpret_cast<float4*>(out + i0) = *reinterpret_cast<const float4*>(o);
      *reinterpret_cast<float4*>(out + i0 + 4) = *reinterpret_cast<const float4*>(o + 4);
    } else {
      for (int k = 0; k < cnt; ++k) out[i0 + k] = o[k];
    }
  }
}

template <typename T, bool kRes>
void launch_f32(const void* y, const void* b, const void* r, void* out, int64_t n, int C,
                int64_t period, cudaStream_t stream) {
  const int threads = 256;
  int64_t blocks = ((n + 7) / 8 + threads - 1) / threads;
  if (blocks > 132 * 32) blocks = 132 * 32;
  const bool vec = ((uintptr_t)y | (uintptr_t)r | (uintptr_t)out) % 16 == 0 &&
                   (!kRes || period % 8 == 0);
  if (vec) {
    bias_add_f32_kernel<T, kRes, true><<<(int)blocks, threads, 0, stream>>>(
        (const T*)y, (const T*)b, (const float*)r, (float*)out, n, C, period);
  } else {
    bias_add_f32_kernel<T, kRes, false><<<(int)blocks, threads, 0, stream>>>(
        (const T*)y, (const T*)b, (const float*)r, (float*)out, n, C, period);
  }
}

template <typename T>
void dispatch_f32(const void* y, const void* b, const void* r, void* out, int64_t n, int C,
                  int64_t period, cudaStream_t stream) {
  if (r) launch_f32<T, true>(y, b, r, out, n, C, period, stream);
  else launch_f32<T, false>(y, b, r, out, n, C, period, stream);
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
  cudaStream_t st = (cudaStream_t)stream;
  if (mode / 4 == 0) dispatch_act<__nv_bfloat16>(mode & 3, p, b, y, pre, n, C, div, s, st);
  else dispatch_act<__half>(mode & 3, p, b, y, pre, n, C, div, s, st);
  return (int)cudaGetLastError();
}

// dtype 0 bf16, 1 fp16; r may be null; period > 0 (ignored without r).
extern "C" int tt_bias_add_f32(const void* y, const void* b, const void* r, void* out, int C,
                               int dtype, long long n, long long period, void* stream) {
  if (!b || n <= 0 || C <= 0 || period <= 0 || dtype < 0 || dtype > 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0) dispatch_f32<__nv_bfloat16>(y, b, r, out, n, C, period, st);
  else dispatch_f32<__half>(y, b, r, out, n, C, period, st);
  return (int)cudaGetLastError();
}

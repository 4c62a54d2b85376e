// SC: int8 CRAFT's float first convolution (conv1_1, 3x3, "SAME") at bf16,
// summed in the order XLA's CPU backend sums JAX's, with its bias and ReLU,
// for Hopper (sm_90a).
//
// Replaces no TPU kernel: JAX's conv1_1 is an XLA convolution
// (tuatara_tpu/models/layers.py:84-95, called by models/craft.py _conv_or_q).
// Under production() every later layer of the trunk is int8 with a dynamic
// per-tensor scale, so one output of conv1_1 that rounds to another bf16
// value can move an int8 value of conv1_2's input, and from there the
// int32 sums and the scales of the layers after it. XLA's CPU backend
// computes a bf16 convolution as an fp32 convolution of the bf16 values:
// each output is a chain of fp32 sums over its taps in (kh, kw, ci) order,
// each product exact (two 8-bit significands), then rounded once to bf16.
// cuDNN's bf16 convolution sums in another order (and oneDNN's on the CPU),
// so on ~1.5e-6 of a page's outputs its rounding differs. This kernel sums
// in XLA's order, so the int8 trunk that follows sees the values JAX's
// graph sees (tests/test_torch_int8.py).
//
// tt_stem_conv: x [B, H, W, cx] fp32, NHWC (the canvas), cx = cin, or 1 for
// a gray canvas that JAX broadcasts to conv1_1's cin; w [cout, 3, 3, cin]
// fp32 holding bf16 values (the bf16 weights, widened); b [cout] fp32
// holding bf16 values; y [B, H, W, cout] bf16, all on the card. cin <= 4,
// cout a multiple of 8 up to 256. Per output (pixel p, channel o), with X
// = bf16(x) and zero outside the image:
//   acc = 0; for kh, kw, ci: acc = fma(X[p + (kh-1, kw-1), ci], w[o, kh, kw, ci], acc)
//   v = bf16(float(bf16(acc)) + b[o]);  y = v > 0 ? v : 0
// The fma adds an exact product, so it equals XLA's add of a product;
// __fmaf_rn and __fadd_rn keep nvcc from reordering or contracting
// anything else. Equal bit for bit to kernels/stem.py stem_conv_plain, the
// same sums in PyTorch ops.
//
// Work: a thread computes a 4 x 4 tile, 4 output channels of 4 adjacent
// pixels of one row: it holds its channels' 9 cin weights in registers
// for the whole launch, and for each of the 3 input rows it loads the 6
// columns x cin values its 4 pixels' taps need, once, rounded once; each
// loaded value feeds up to 12 fma and each weight 4, so the fma units, not
// the loads, set the pace. The accumulator of each output still takes its
// taps in (kh, kw, ci) order. Consecutive threads take a pixel group's
// channel quads, then the next group, so a warp's 8-byte stores of one
// pixel fill its channels contiguously. The grid is the CTAs that fit on
// the card at once, each thread keeping its channel quad while it strides
// over the pixel groups. What bounds it: its operations, 9 cin fp32 fma a
// value (no tensor core: the order of the sums is the point), 0.81 ps a
// value at 67 TFLOP/s for cin = 3, against 0.60 ps for the value's 2
// bytes written at 3.35 TB/s.
//
// The entry point launches on the caller's stream, allocates nothing and
// returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxCin = 4;
constexpr int kMaxCout = 256;
constexpr int kQuad = 4;  // output channels, and pixels, of a thread's tile

template <int CIN>
__global__ void __launch_bounds__(kThreads)
stem_kernel(const float* __restrict__ x, const float* __restrict__ w,
            const float* __restrict__ b, __nv_bfloat16* __restrict__ y, int H, int W, int cx,
            int cout, long long n_groups) {
  const int quads = cout / kQuad;
  const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const int q = (int)(tid % quads);  // fixed for the launch: blockDim.x is a multiple of quads
  float wr[kQuad][9][CIN], br[kQuad];
#pragma unroll
  for (int c = 0; c < kQuad; ++c) {
    br[c] = b[q * kQuad + c];
#pragma unroll
    for (int k = 0; k < 9; ++k)
#pragma unroll
      for (int ci = 0; ci < CIN; ++ci) wr[c][k][ci] = w[((q * kQuad + c) * 9 + k) * CIN + ci];
  }
  const int groups_w = (W + kQuad - 1) / kQuad;
  const long long stride = (long long)gridDim.x * blockDim.x / quads;
  for (long long grp = tid / quads; grp < n_groups; grp += stride) {
    const int x0 = (int)(grp % groups_w) * kQuad;
    const long long t = grp / groups_w;
    const int yy = (int)(t % H);
    const long long bb = t / H;
    float acc[kQuad][kQuad];  // [channel][pixel]
#pragma unroll
    for (int c = 0; c < kQuad; ++c)
#pragma unroll
      for (int p = 0; p < kQuad; ++p) acc[c][p] = 0.f;
#pragma unroll
    for (int kh = 0; kh < 3; ++kh) {
      const int iy = yy + kh - 1;
      const bool row = iy >= 0 && iy < H;
      float xr[kQuad + 2][CIN];  // columns x0 - 1 .. x0 + 4 of input row iy
#pragma unroll
      for (int j = 0; j < kQuad + 2; ++j) {
        const int ix = x0 - 1 + j;
        const bool in = row && ix >= 0 && ix < W;
        const float* px = in ? x + ((bb * H + iy) * W + ix) * cx : x;
#pragma unroll
        for (int ci = 0; ci < CIN; ++ci)
          xr[j][ci] = __bfloat162float(__float2bfloat16_rn(in ? px[cx == 1 ? 0 : ci] : 0.f));
      }
#pragma unroll
      for (int kw = 0; kw < 3; ++kw)
#pragma unroll
        for (int ci = 0; ci < CIN; ++ci)
#pragma unroll
          for (int c = 0; c < kQuad; ++c)
#pragma unroll
            for (int p = 0; p < kQuad; ++p)
              acc[c][p] = __fmaf_rn(xr[p + kw][ci], wr[c][kh * 3 + kw][ci], acc[c][p]);
    }
#pragma unroll
    for (int p = 0; p < kQuad; ++p) {
      if (x0 + p >= W) break;
      __align__(8) __nv_bfloat16 v4[kQuad];
#pragma unroll
      for (int c = 0; c < kQuad; ++c) {
        const float s = __fadd_rn(__bfloat162float(__float2bfloat16_rn(acc[c][p])), br[c]);
        const __nv_bfloat16 v = __float2bfloat16_rn(s);
        v4[c] = __bfloat162float(v) > 0.f ? v : __float2bfloat16_rn(0.f);
      }
      const long long pix = (bb * H + yy) * W + x0 + p;
      *reinterpret_cast<uint2*>(y + pix * cout + q * kQuad) = *reinterpret_cast<const uint2*>(v4);
    }
  }
}

template <int CIN>
void launch(const float* x, const float* w, const float* b, __nv_bfloat16* y, int B, int H,
            int W, int cx, int cout, cudaStream_t stream) {
  static int sms = 0, per_sm = 0;
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, stem_kernel<CIN>, kThreads, 0);
  }
  const int quads = cout / kQuad;
  const int threads = kThreads / quads * quads;  // whole channel-quad sets a block
  const long long n_groups = (long long)B * H * ((W + kQuad - 1) / kQuad);
  const long long need = (n_groups * quads + threads - 1) / threads;
  const long long fit = (long long)sms * (per_sm > 0 ? per_sm : 1);
  stem_kernel<CIN><<<(int)(need < fit ? need : fit), threads, 0, stream>>>(x, w, b, y, H, W, cx,
                                                                         cout, n_groups);
}

}  // namespace

extern "C" int tt_stem_conv(const void* x, const void* w, const void* b, void* y, int B, int H,
                            int W, int cx, int cin, int cout, void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || cin <= 0 || cin > kMaxCin || (cx != 1 && cx != cin) ||
      cout <= 0 || cout % 8 || cout > kMaxCout || (reinterpret_cast<uintptr_t>(y) & 15))
    return (int)cudaErrorInvalidValue;
  const float *xf = (const float*)x, *wf = (const float*)w, *bf = (const float*)b;
  __nv_bfloat16* yb = (__nv_bfloat16*)y;
  cudaStream_t st = (cudaStream_t)stream;
  switch (cin) {
    case 1: launch<1>(xf, wf, bf, yb, B, H, W, cx, cout, st); break;
    case 2: launch<2>(xf, wf, bf, yb, B, H, W, cx, cout, st); break;
    case 3: launch<3>(xf, wf, bf, yb, B, H, W, cx, cout, st); break;
    default: launch<4>(xf, wf, bf, yb, B, H, W, cx, cout, st); break;
  }
  return (int)cudaGetLastError();
}

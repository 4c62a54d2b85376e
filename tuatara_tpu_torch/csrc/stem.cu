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
// tt_stem_conv: x [B, H, W, cx] fp32 read through its element strides (sb,
// sh, sw, sc: the NHWC canvas, or its gray plane, with no copy), cx = cin,
// or 1 for a gray canvas that JAX broadcasts to conv1_1's cin; w [cout, 3,
// 3, cin] fp32 holding bf16 values (the bf16 weights, widened, packed once
// with the engine); b [cout] fp32 holding bf16 values; y [B, H, W, cout]
// bf16, all on the card. cin <= 4, cout a multiple of 8 up to 256. Per
// output (pixel p, channel o), with X = bf16(x) and zero outside the image:
//   acc = 0; for kh, kw, ci: acc = fma(X[p + (kh-1, kw-1), ci], w[o, kh, kw, ci], acc)
//   v = bf16(float(bf16(acc)) + b[o]);  y = v > 0 ? v : 0
// The fma adds an exact product, so it equals XLA's add of a product;
// __fmaf_rn and __fadd_rn keep nvcc from reordering or contracting
// anything else. The ReLU is taken on the fp32 sum before its rounding:
// max(s, 0) rounds to what the rounded value's ReLU gives for every s (the
// sum is never -0: the chain starts at +0 and adds exact products). Equal
// bit for bit to kernels/stem.py stem_conv_plain, the same sums in PyTorch
// ops.
//
// What bounds it: its operations, 27 fp32 fma an output at cin = 3 (no
// tensor core: the order of the sums is the point), against the output's
// 2 bytes written. So the design keeps the fma units fed and little else
// in the instruction stream:
// - A block of 128 threads owns a tile of 8 x 32 pixels and every output
//   channel. The tile and its one-pixel halo (10 x 34 pixels, cx channels
//   each, a 16-byte slot a pixel) are copied into shared memory by
//   cp.async, a thread whole slots, zero outside the image (the copy's
//   zero fill), and each thread rounds its own slots to bf16 in place
//   once: the inner loop has no bounds checks and no conversions.
// - A thread owns 4 output channels for the whole launch, their 108
//   weights and 4 biases in registers, and computes a strip of 4 adjacent
//   pixels of one row at a time: 16 accumulators, 432 fma. It walks the 6
//   input columns of each of the 3 rows once (one 16-byte shared load a
//   column, the next row's loaded while the current one is summed); each
//   column feeds the pixels whose kw it is, so every accumulator still
//   takes its taps in (kh, kw, ci) order. The epilogue rounds two
//   channels a conversion and stores a pixel's 4 channels as 8 bytes: the
//   16 threads of a pixel write its 128 bytes whole.
// - The grid is persistent, as many blocks as fit (two a multiprocessor
//   at cin = 3: ~215 registers a thread, no spills), each walking tiles
//   with the next tile's copy in flight (a double buffer) while it
//   computes the current one; the tile count is spread evenly over the
//   blocks.
// On an NVIDIA H100 80GB HBM3 (700 W) it sits at about half of its
// operation bound (PERF.md); where the other half goes is not measured
// (the card's stall counters are not readable).
//
// The entry point launches on the caller's stream, allocates nothing and
// returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kMaxCin = 4;
constexpr int kMaxCout = 256;
constexpr int kTileH = 8, kTileW = 32;       // output pixels of a block's tile
constexpr int kStrip = 4;                     // output pixels of a thread's strip (one row)
constexpr int kCg = 4;                        // output channels of a thread (`store4`)
constexpr int kRowsS = kTileH + 2, kColsS = kTileW + 2;  // the tile with its halo
constexpr int kSlots = kRowsS * kColsS;       // 16-byte pixel slots a buffer
constexpr int kStripsRow = kTileW / kStrip;
constexpr int kStrips = kTileH * kStripsRow;

__device__ __forceinline__ void copy4(float* dst, const float* src, bool in) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src),
               "r"(in ? 4 : 0));
}

__device__ __forceinline__ void store4(__nv_bfloat16* p, const __nv_bfloat162 (&v)[2]) {
  uint2 u;
  u.x = *reinterpret_cast<const uint32_t*>(&v[0]);
  u.y = *reinterpret_cast<const uint32_t*>(&v[1]);
  *reinterpret_cast<uint2*>(p) = u;
}

struct Geometry {
  const float* x;
  long long sb, sh, sw, sc;
  int H, W, tiles_w, tiles_hw;
};

// Copies tile t's pixels and halo into buf (channel ci of slot s at float
// 4 * s + ci), zero outside the image. A thread copies whole slots, the
// same ones `round_tile` rounds: it waits only for its own copies.
template <int CX>
__device__ __forceinline__ void load_tile(float4* buf, const Geometry& g, int t) {
  const int bb = t / g.tiles_hw, rem = t - bb * g.tiles_hw;
  const int y0 = (rem / g.tiles_w) * kTileH - 1, x0 = (rem % g.tiles_w) * kTileW - 1;
  const float* base = g.x + bb * g.sb;
  for (int s = threadIdx.x; s < kSlots; s += blockDim.x) {
    const int r = s / kColsS, c = s - r * kColsS;
    const int iy = y0 + r, ix = x0 + c;
    const bool in = iy >= 0 && iy < g.H && ix >= 0 && ix < g.W;
    const float* src = in ? base + iy * g.sh + ix * g.sw : g.x;
    float* dst = reinterpret_cast<float*>(buf + s);
#pragma unroll
    for (int ci = 0; ci < CX; ++ci) copy4(dst + ci, in ? src + ci * g.sc : src, in);
  }
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int CX>
__device__ __forceinline__ void round_tile(float4* buf) {
  for (int s = threadIdx.x; s < kSlots; s += blockDim.x) {
    float4 v = buf[s];
    v.x = __bfloat162float(__float2bfloat16_rn(v.x));
    if (CX > 1) v.y = __bfloat162float(__float2bfloat16_rn(v.y));
    if (CX > 2) v.z = __bfloat162float(__float2bfloat16_rn(v.z));
    if (CX > 3) v.w = __bfloat162float(__float2bfloat16_rn(v.w));
    buf[s] = v;
  }
}

template <int CIN, int CX>
__global__ void __launch_bounds__(kThreads)  // no cap on registers: one of 168 spills
stem_kernel(Geometry g, const float* __restrict__ w, const float* __restrict__ b,
            __nv_bfloat16* __restrict__ y, int cout, int n_tiles) {
  __shared__ float4 buf[2][kSlots];
  const int groups = cout / kCg;
  const int q = threadIdx.x % groups;    // the thread's channel group, fixed for the launch
  const int s0 = threadIdx.x / groups;   // its first strip of a tile
  const int spc = blockDim.x / groups;   // strips in flight in a block (blockDim.x: whole groups)
  float wr[kCg][3][3][CIN], br[kCg];
#pragma unroll
  for (int c = 0; c < kCg; ++c) {
    br[c] = b[kCg * q + c];
#pragma unroll
    for (int kh = 0; kh < 3; ++kh)
#pragma unroll
      for (int kw = 0; kw < 3; ++kw)
#pragma unroll
        for (int ci = 0; ci < CIN; ++ci)
          wr[c][kh][kw][ci] = w[(((kCg * q + c) * 3 + kh) * 3 + kw) * CIN + ci];
  }
  int t = blockIdx.x;
  if (t < n_tiles) load_tile<CX>(buf[0], g, t);
  for (int i = 0; t < n_tiles; t += gridDim.x, i ^= 1) {
    if (t + (int)gridDim.x < n_tiles) {
      load_tile<CX>(buf[i ^ 1], g, t + gridDim.x);
      asm volatile("cp.async.wait_group 1;\n" ::);  // tile t's copies (this thread's) done
    } else {
      asm volatile("cp.async.wait_group 0;\n" ::);
    }
    round_tile<CX>(buf[i]);
    __syncthreads();
    const int bb = t / g.tiles_hw, rem = t - bb * g.tiles_hw;
    const int ty = (rem / g.tiles_w) * kTileH, tx = (rem % g.tiles_w) * kTileW;
    for (int s = s0; s < kStrips; s += spc) {
      const int r = s / kStripsRow, cb = s - r * kStripsRow;
      const float4* base = buf[i] + r * kColsS + cb * kStrip;
      float acc[kCg][kStrip];
#pragma unroll
      for (int c = 0; c < kCg; ++c)
#pragma unroll
        for (int p = 0; p < kStrip; ++p) acc[c][p] = 0.f;
      float4 cur[kStrip + 2], nxt[kStrip + 2];  // a row's input columns, and the next row's
#pragma unroll
      for (int j = 0; j < kStrip + 2; ++j) cur[j] = base[j];
#pragma unroll
      for (int kh = 0; kh < 3; ++kh) {
        asm volatile("" ::: "memory");  // loads stay a row ahead: fewer live registers
        if (kh < 2) {
#pragma unroll
          for (int j = 0; j < kStrip + 2; ++j) nxt[j] = base[(kh + 1) * kColsS + j];
        }
#pragma unroll
        for (int j = 0; j < kStrip + 2; ++j) {  // input column j feeds pixel p at kw = j - p
          const float xv[4] = {cur[j].x, cur[j].y, cur[j].z, cur[j].w};
#pragma unroll
          for (int ci = 0; ci < CIN; ++ci)  // an accumulator takes one kw of a column
#pragma unroll
            for (int kw = 0; kw < 3; ++kw) {
              const int p = j - kw;
              if (p < 0 || p >= kStrip) continue;
#pragma unroll
              for (int c = 0; c < kCg; ++c)
                acc[c][p] = __fmaf_rn(xv[CX == 1 ? 0 : ci], wr[c][kh][kw][ci], acc[c][p]);
            }
        }
        if (kh < 2) {
#pragma unroll
          for (int j = 0; j < kStrip + 2; ++j) cur[j] = nxt[j];
        }
      }
      const int yy = ty + r, xx = tx + cb * kStrip;
      if (yy >= g.H) continue;
      __nv_bfloat16* out = y + (((long long)bb * g.H + yy) * g.W + xx) * cout + kCg * q;
#pragma unroll
      for (int p = 0; p < kStrip; ++p) {
        if (xx + p >= g.W) break;
        __nv_bfloat162 v[kCg / 2];
#pragma unroll
        for (int c = 0; c < kCg; c += 2) {  // two channels a conversion
          const float2 a = __bfloat1622float2(__floats2bfloat162_rn(acc[c][p], acc[c + 1][p]));
          v[c / 2] = __floats2bfloat162_rn(fmaxf(__fadd_rn(a.x, br[c]), 0.f),
                                           fmaxf(__fadd_rn(a.y, br[c + 1]), 0.f));
        }
        store4(out + (long long)p * cout, v);
      }
    }
    __syncthreads();  // buf[i] is the next copy's target
  }
}

template <int CIN, int CX>
void launch(const Geometry& g, const float* w, const float* b, __nv_bfloat16* y, int B,
            int cout, cudaStream_t stream) {
  static int sms = 0, per_sm = 0;
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, stem_kernel<CIN, CX>, kThreads, 0);
  }
  const int groups = cout / kCg;
  const int threads = kThreads / groups * groups;  // whole channel-group sets a block
  const int n_tiles = B * g.tiles_hw;
  const int fit = sms * (per_sm > 0 ? per_sm : 1);
  const int rounds = (n_tiles + fit - 1) / fit;
  const int grid = (n_tiles + rounds - 1) / rounds;  // the tiles spread evenly
  stem_kernel<CIN, CX><<<grid, threads, 0, stream>>>(g, w, b, y, cout, n_tiles);
}

}  // namespace

extern "C" int tt_stem_conv(const void* x, const void* w, const void* b, void* y, int B, int H,
                            int W, int cx, int cin, int cout, long long sb, long long sh,
                            long long sw, long long sc, void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || cin <= 0 || cin > kMaxCin || (cx != 1 && cx != cin) ||
      cout <= 0 || cout % 8 || cout > kMaxCout || (reinterpret_cast<uintptr_t>(y) & 7))
    return (int)cudaErrorInvalidValue;
  const int tiles_w = (W + kTileW - 1) / kTileW, tiles_h = (H + kTileH - 1) / kTileH;
  if ((long long)B * tiles_w * tiles_h > 0x7fffffff) return (int)cudaErrorInvalidValue;
  const Geometry g{(const float*)x, sb, sh, sw, sc, H, W, tiles_w, tiles_w * tiles_h};
  const float *wf = (const float*)w, *bf = (const float*)b;
  __nv_bfloat16* yb = (__nv_bfloat16*)y;
  cudaStream_t st = (cudaStream_t)stream;
  const bool gray = cx == 1;
  switch (cin) {
    case 1: launch<1, 1>(g, wf, bf, yb, B, cout, st); break;
    case 2: gray ? launch<2, 1>(g, wf, bf, yb, B, cout, st)
                 : launch<2, 2>(g, wf, bf, yb, B, cout, st); break;
    case 3: gray ? launch<3, 1>(g, wf, bf, yb, B, cout, st)
                 : launch<3, 3>(g, wf, bf, yb, B, cout, st); break;
    default: gray ? launch<4, 1>(g, wf, bf, yb, B, cout, st)
                  : launch<4, 4>(g, wf, bf, yb, B, cout, st); break;
  }
  return (int)cudaGetLastError();
}

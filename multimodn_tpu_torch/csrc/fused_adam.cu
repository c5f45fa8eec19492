// One-pass 8-bit blockwise Adam update of one parameter leaf, for Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernel multimodn_tpu/ops/fused_adam.py::
// _make_leaf_pallas. The leaf is seen as (rows, cols); the moments m and v
// are 8-bit codes (float8_e4m3fn or int8) with one float32 absmax scale per
// row. Per element, all in float32 and each operation rounded on its own:
//   m = code(mq) * ms, v = code(vq) * vs
//   m' = b1*m + (1-b1)*g,  v' = b2*v + ((1-b2)*g)*g
//     (gated: m' = m + (gate*(1-b1))*(g-m), v' = v + (gate*(1-b2))*(g*g-v))
//   p' = p + ((-lr [*gate]) * (m'/c1)) / (sqrt(v'/c2) + eps)
// then each row of m' and v' is requantized by its absmax:
//   inv = absmax > 0 ? q_top/absmax : 0, code = cast(clip(x*inv [rint]))
//   scale = absmax/q_top, q_top = 448 (fp8) or 127 (int8).
// p, mq, ms, vq and vs are written in place.
//
// What bounds it on an H100: per parameter it reads p, g, mq, vq (10 B) and
// writes p, mq, vq (6 B), plus 16 B per row of scales, for ~30 flops: far
// below the card's ~20 flop/byte ridge, so a large leaf is bound by bytes at
// 3.35 TB/s. The MIMIC model's leaves are small (83,742 parameters in 37
// leaves, ~1.3 MB a step): there one launch per leaf is bound by launch
// latency, not by the card.
//
// Design (simple and correct first): the row absmax needs all of a row's m'
// and v' before any code can be written, and the TPU kernel's VMEM held a
// whole row tile. Here a row is walked twice: a first pass computes m', v'
// and their absmax without writing; a second pass recomputes them from the
// unchanged inputs (bit-identical) and writes. Rows of up to 1024 columns
// take one warp each (shuffle reduction); wider rows take one 256-thread
// block each (shared-memory reduction), with no limit on the width. Every
// element is read and written by the same thread in both passes, and the
// old row scales are read before the reduction's barrier, so writing in
// place is safe. __fmul_rn/__fadd_rn/__fsub_rn/__fdiv_rn/__fsqrt_rn keep
// nvcc from contracting into FMAs, so the result equals the plain PyTorch
// version bit for bit; max and clip propagate NaN like jnp.max/jnp.clip.
#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kWarp = 32;
constexpr int kThreads = 256;
constexpr int kMaxWarpCols = 1024;   // wider rows take a block each
enum Format { kFp8 = 0, kInt8 = 1 };

struct AdamArgs {
  float* p;
  const float* g;
  uint8_t* mq;
  float* ms;
  uint8_t* vq;
  float* vs;
  const float* c12;    // (c1, c2) on the device
  const float* gate;   // nullptr: ungated
  int rows, cols;
  float lr, b1, omb1, b2, omb2, eps;
  int fmt;
};

__device__ __forceinline__ float nan_max(float a, float b) {
  return (a != a) ? a : ((b != b) ? b : fmaxf(a, b));
}

__device__ __forceinline__ float decode(uint8_t code, int fmt) {
  if (fmt == kInt8) return (float)(int8_t)code;
  const __half_raw h = __nv_cvt_fp8_to_halfraw(code, __NV_E4M3);
  return __half2float(__half(h));
}

__device__ __forceinline__ uint8_t encode(float x, float inv, int fmt) {
  float s = __fmul_rn(x, inv);
  const float top = fmt == kInt8 ? 127.0f : 448.0f;
  if (fmt == kInt8) s = rintf(s);
  s = s > top ? top : (s < -top ? -top : s);   // NaN passes through
  if (fmt == kInt8) return (uint8_t)(int8_t)(s != s ? 0 : (int)s);
  return (uint8_t)__nv_cvt_float_to_fp8(s, __NV_SATFINITE, __NV_E4M3);
}

struct Moments {
  float m, v;
};

__device__ __forceinline__ Moments moments(const AdamArgs& a, long i,
                                           float ms, float vs, float gate) {
  const float g = a.g[i];
  const float m = __fmul_rn(decode(a.mq[i], a.fmt), ms);
  const float v = __fmul_rn(decode(a.vq[i], a.fmt), vs);
  Moments r;
  if (a.gate == nullptr) {
    r.m = __fadd_rn(__fmul_rn(a.b1, m), __fmul_rn(a.omb1, g));
    r.v = __fadd_rn(__fmul_rn(a.b2, v), __fmul_rn(__fmul_rn(a.omb2, g), g));
  } else {
    r.m = __fadd_rn(m, __fmul_rn(__fmul_rn(gate, a.omb1), __fsub_rn(g, m)));
    r.v = __fadd_rn(v, __fmul_rn(__fmul_rn(gate, a.omb2),
                                 __fsub_rn(__fmul_rn(g, g), v)));
  }
  return r;
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = kWarp / 2; off > 0; off /= 2)
    x = nan_max(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

// One row, walked by `nthreads` threads of which this is `lane`. With
// kBlock the threads are the whole block and `red` is shared scratch of
// kThreads / kWarp floats per moment.
template <bool kBlock>
__device__ void update_row(const AdamArgs& a, int row, int lane,
                           int nthreads, float* red) {
  const long base = (long)row * a.cols;
  const float ms = a.ms[row], vs = a.vs[row];
  const float gate = a.gate == nullptr ? 1.0f : *a.gate;
  const float c1 = a.c12[0], c2 = a.c12[1];

  float amax_m = 0.0f, amax_v = 0.0f;
  for (int j = lane; j < a.cols; j += nthreads) {
    const Moments r = moments(a, base + j, ms, vs, gate);
    amax_m = nan_max(amax_m, fabsf(r.m));
    amax_v = nan_max(amax_v, fabsf(r.v));
  }
  amax_m = warp_max(amax_m);
  amax_v = warp_max(amax_v);
  if (kBlock) {
    const int warp = threadIdx.x / kWarp, nwarps = blockDim.x / kWarp;
    if (threadIdx.x % kWarp == 0) {
      red[warp] = amax_m;
      red[kThreads / kWarp + warp] = amax_v;
    }
    __syncthreads();
    amax_m = red[0];
    amax_v = red[kThreads / kWarp];
    for (int w = 1; w < nwarps; ++w) {
      amax_m = nan_max(amax_m, red[w]);
      amax_v = nan_max(amax_v, red[kThreads / kWarp + w]);
    }
  }

  const float top = a.fmt == kInt8 ? 127.0f : 448.0f;
  const float inv_m = amax_m > 0.0f ? __fdiv_rn(top, amax_m) : 0.0f;
  const float inv_v = amax_v > 0.0f ? __fdiv_rn(top, amax_v) : 0.0f;
  const float neg_lr = a.gate == nullptr ? -a.lr : __fmul_rn(-a.lr, gate);
  for (int j = lane; j < a.cols; j += nthreads) {
    const long i = base + j;
    const Moments r = moments(a, i, ms, vs, gate);
    const float denom = __fadd_rn(__fsqrt_rn(__fdiv_rn(r.v, c2)), a.eps);
    const float upd = __fdiv_rn(__fmul_rn(neg_lr, __fdiv_rn(r.m, c1)), denom);
    a.p[i] = __fadd_rn(a.p[i], upd);
    a.mq[i] = encode(r.m, inv_m, a.fmt);
    a.vq[i] = encode(r.v, inv_v, a.fmt);
  }
  if (lane == 0) {
    a.ms[row] = __fdiv_rn(amax_m, top);
    a.vs[row] = __fdiv_rn(amax_v, top);
  }
}

__global__ void __launch_bounds__(kThreads)
    fused_adam_warp_rows(AdamArgs a) {
  const int row = blockIdx.x * (kThreads / kWarp) + threadIdx.x / kWarp;
  if (row >= a.rows) return;   // whole warps leave together
  update_row<false>(a, row, threadIdx.x % kWarp, kWarp, nullptr);
}

__global__ void __launch_bounds__(kThreads)
    fused_adam_block_rows(AdamArgs a) {
  __shared__ float red[2 * kThreads / kWarp];
  update_row<true>(a, blockIdx.x, threadIdx.x, kThreads, red);
}

}  // namespace

extern "C" {

// Launches the update of one (rows, cols) leaf on `stream`; returns
// cudaGetLastError() after launch (0 on success). All pointers are device
// pointers; `gate` may be null (ungated). mq/vq hold float8_e4m3fn codes for
// fmt 0 and int8 codes for fmt 1; ms/vs hold one scale per row.
int mmn_fused_adam_update(float* p, const float* g, uint8_t* mq, float* ms,
                          uint8_t* vq, float* vs, const float* c12,
                          const float* gate, int rows, int cols, float lr,
                          float b1, float omb1, float b2, float omb2,
                          float eps, int fmt, void* stream) {
  if (rows <= 0 || cols <= 0 || (fmt != kFp8 && fmt != kInt8))
    return (int)cudaErrorInvalidValue;
  const AdamArgs a{p, g, mq, ms, vq, vs, c12, gate, rows, cols,
                   lr, b1, omb1, b2, omb2, eps, fmt};
  if (cols <= kMaxWarpCols) {
    const int rows_per_block = kThreads / kWarp;
    const dim3 grid((rows + rows_per_block - 1) / rows_per_block);
    fused_adam_warp_rows<<<grid, kThreads, 0, (cudaStream_t)stream>>>(a);
  } else {
    fused_adam_block_rows<<<rows, kThreads, 0, (cudaStream_t)stream>>>(a);
  }
  return (int)cudaGetLastError();
}

const char* mmn_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"

// One fp32 Adam step over many parameter leaves in one launch (K3), for
// Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package's fp32 Adam
// (multimodn_tpu/optim.py::Adam) is plain jnp that XLA fuses into one loop
// per leaf. It was added because the port's per-leaf PyTorch update
// (multimodn_tpu_torch/optim.py::Adam._leaf, then core/step.py::
// gated_update's p.add_) launches 14 kernels per leaf, 1,862 of the 3,527
// kernels of a ResNet-18 image-model training step, each costing the host
// a few microseconds to issue.
//
// Per element, every float32 operation rounded on its own, in _leaf's order:
//   m' = b1*m + (1-b1)*g,  v' = b2*v + ((1-b2)*g)*g
//   p' = p + ((-lr) * (m'/c1)) / (sqrt(v'/c2) + eps)
// and in a gated encoder group (gate 0 or 1, on the device):
//   m' = m + (gate*(1-b1))*(g-m),  v' = v + (gate*(1-b2))*(g*g-v)
//   p' = p + ((-lr*gate) * (m'/c1)) / (sqrt(v'/c2) + eps)
// c1, c2 = 1 - b1^t, 1 - b2^t are read from the device, one pair per group.
// The moments are stored as float32 or bfloat16 (the template parameter,
// which the wrapper reads from the state's dtype): bfloat16 is widened
// exactly, the step runs in float32, and m', v' are rounded back to nearest
// even as PyTorch's cast does. p, m and v are written in place.
//
// What bounds it on an H100: per parameter it reads p, g, m, v and writes
// p, m, v (28 B with float32 moments, 20 B with bfloat16), for ~13 float32
// operations: far below the card's ~20 flop/byte ridge, so bytes at 3.35
// TB/s. The ResNet-18 image model's step moves 315.3 MB (11,260,898
// parameters in 133 leaves): 0.094 ms. Its leaves are uneven: 110 hold
// under 4,096 elements, three hold 2,359,296.
//
// Design:
// - A flat chunk table: every leaf is cut into chunks of kChunk elements,
//   one block each, so the small leaves and the large ones share one launch
//   and the large ones spread over every SM. A block finds its leaf by a
//   binary search of the leaves' first chunks.
// - The leaf table (6 pointers and 2 ints a leaf) travels by value in the
//   kernel's parameters (__grid_constant__; up to kMaxLeaves leaves, ~29 KB
//   of the 32,764 bytes CUDA 12.1+ allows on Hopper), so a step copies no
//   table from the host, which would wait for the card. More leaves take
//   one launch per kMaxLeaves.
// - A thread issues the loads of its kRuns runs of kVec elements of all
//   four arrays before it computes (16-byte loads of p, g and float32
//   moments, 8-byte loads of bfloat16 ones, where the leaf's base addresses
//   allow; element by element otherwise and at a leaf's ragged end), so
//   16 loads are in flight per thread.
// __fmul_rn/__fadd_rn/__fsub_rn/__fdiv_rn/__fsqrt_rn keep nvcc from
// contracting into FMAs under -fmad=true, so the result equals the per-leaf
// PyTorch update on the card bit for bit.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <cstring>

namespace {

constexpr int kThreads = 256;
constexpr int kVec = 4;                            // elements per run
constexpr int kRuns = 4;                           // runs per thread
constexpr int kChunk = kThreads * kVec * kRuns;    // 4096 elements a block
constexpr int kMaxLeaves = 512;
constexpr int kPtrFields = 6;     // p, g, m, v, c12, gate
constexpr int kGeomFields = 2;    // elements, first chunk
enum StateType { kFp32 = 0, kBf16 = 1 };

struct Args {
  float* p[kMaxLeaves];
  const float* g[kMaxLeaves];
  void* m[kMaxLeaves];
  void* v[kMaxLeaves];
  const float* c12[kMaxLeaves];    // (c1, c2) of the leaf's group
  const float* gate[kMaxLeaves];   // nullptr: ungated
  int n[kMaxLeaves];
  int first[kMaxLeaves];           // the leaf's first chunk, increasing
  int count;
  float lr, b1, omb1, b2, omb2, eps;
};
static_assert(sizeof(Args) <= 32764, "kernel parameters exceed 32,764 B");

// Loads and stores of the moments' storage type.
template <typename S>
struct Moments;

template <>
struct Moments<float> {
  static constexpr int kAlign = 16;
  static __device__ __forceinline__ float load(const float* x, int i) {
    return x[i];
  }
  static __device__ __forceinline__ void store(float* x, int i, float y) {
    x[i] = y;
  }
  static __device__ __forceinline__ void load4(const float* x, int i,
                                               float (&y)[kVec]) {
    const float4 q = *reinterpret_cast<const float4*>(x + i);
    y[0] = q.x; y[1] = q.y; y[2] = q.z; y[3] = q.w;
  }
  static __device__ __forceinline__ void store4(float* x, int i,
                                                const float (&y)[kVec]) {
    *reinterpret_cast<float4*>(x + i) = make_float4(y[0], y[1], y[2], y[3]);
  }
};

template <>
struct Moments<__nv_bfloat16> {
  static constexpr int kAlign = 8;
  static __device__ __forceinline__ float load(const __nv_bfloat16* x,
                                               int i) {
    return __bfloat162float(x[i]);
  }
  static __device__ __forceinline__ void store(__nv_bfloat16* x, int i,
                                               float y) {
    x[i] = __float2bfloat16(y);
  }
  static __device__ __forceinline__ void load4(const __nv_bfloat16* x, int i,
                                               float (&y)[kVec]) {
    const uint2 q = *reinterpret_cast<const uint2*>(x + i);
    const float2 lo = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&q.x));
    const float2 hi = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&q.y));
    y[0] = lo.x; y[1] = lo.y; y[2] = hi.x; y[3] = hi.y;
  }
  static __device__ __forceinline__ void store4(__nv_bfloat16* x, int i,
                                                const float (&y)[kVec]) {
    const __nv_bfloat162 lo = __halves2bfloat162(__float2bfloat16(y[0]),
                                                 __float2bfloat16(y[1]));
    const __nv_bfloat162 hi = __halves2bfloat162(__float2bfloat16(y[2]),
                                                 __float2bfloat16(y[3]));
    uint2 q;
    q.x = *reinterpret_cast<const unsigned*>(&lo);
    q.y = *reinterpret_cast<const unsigned*>(&hi);
    *reinterpret_cast<uint2*>(x + i) = q;
  }
};

// The group's scalars, read once per block.
struct Step {
  bool gated;
  float c1, c2;
  float neg_lr;   // -lr, or (-lr)*gate
  float gm, gv;   // gate*(1-b1), gate*(1-b2)
};

__device__ __forceinline__ void adam(const Args& a, const Step& s, float& p,
                                     float g, float& m, float& v) {
  if (!s.gated) {
    m = __fadd_rn(__fmul_rn(a.b1, m), __fmul_rn(a.omb1, g));
    v = __fadd_rn(__fmul_rn(a.b2, v), __fmul_rn(__fmul_rn(a.omb2, g), g));
  } else {
    m = __fadd_rn(m, __fmul_rn(s.gm, __fsub_rn(g, m)));
    v = __fadd_rn(v, __fmul_rn(s.gv, __fsub_rn(__fmul_rn(g, g), v)));
  }
  const float denom = __fadd_rn(__fsqrt_rn(__fdiv_rn(v, s.c2)), a.eps);
  p = __fadd_rn(p, __fdiv_rn(__fmul_rn(s.neg_lr, __fdiv_rn(m, s.c1)), denom));
}

template <typename S>
__global__ void __launch_bounds__(kThreads)
    adam_fp32_kernel(const __grid_constant__ Args a) {
  using M = Moments<S>;
  // The leaf that owns this chunk: the last whose first chunk is <= it.
  const int chunk = blockIdx.x;
  int l = 0, hi = a.count - 1;
  while (l < hi) {
    const int mid = (l + hi + 1) / 2;
    if (a.first[mid] <= chunk)
      l = mid;
    else
      hi = mid - 1;
  }
  const long base = (long)(chunk - a.first[l]) * kChunk;
  const int len = (int)min((long)kChunk, (long)a.n[l] - base);
  float* p = a.p[l] + base;
  const float* g = a.g[l] + base;
  S* m = static_cast<S*>(a.m[l]) + base;
  S* v = static_cast<S*>(a.v[l]) + base;

  Step s;
  const float* gate = a.gate[l];
  s.gated = gate != nullptr;
  const float gt = s.gated ? *gate : 1.0f;
  s.c1 = a.c12[l][0];
  s.c2 = a.c12[l][1];
  s.neg_lr = s.gated ? __fmul_rn(-a.lr, gt) : -a.lr;
  s.gm = __fmul_rn(gt, a.omb1);
  s.gv = __fmul_rn(gt, a.omb2);
  // Chunks start at multiples of kChunk, so the leaf's base decides.
  const bool vec = ((reinterpret_cast<uintptr_t>(p) |
                     reinterpret_cast<uintptr_t>(g)) % 16 == 0) &&
                   ((reinterpret_cast<uintptr_t>(m) |
                     reinterpret_cast<uintptr_t>(v)) % M::kAlign == 0);

  float rp[kRuns][kVec] = {}, rg[kRuns][kVec] = {}, rm[kRuns][kVec] = {},
        rv[kRuns][kVec] = {};
#pragma unroll
  for (int k = 0; k < kRuns; ++k) {
    const int j = (k * kThreads + threadIdx.x) * kVec;
    if (vec && j + kVec <= len) {
      Moments<float>::load4(p, j, rp[k]);
      Moments<float>::load4(g, j, rg[k]);
      M::load4(m, j, rm[k]);
      M::load4(v, j, rv[k]);
    } else {
#pragma unroll
      for (int t = 0; t < kVec; ++t) {
        if (j + t < len) {
          rp[k][t] = p[j + t];
          rg[k][t] = g[j + t];
          rm[k][t] = M::load(m, j + t);
          rv[k][t] = M::load(v, j + t);
        }
      }
    }
  }
#pragma unroll
  for (int k = 0; k < kRuns; ++k) {
#pragma unroll
    for (int t = 0; t < kVec; ++t) adam(a, s, rp[k][t], rg[k][t], rm[k][t],
                                        rv[k][t]);
  }
#pragma unroll
  for (int k = 0; k < kRuns; ++k) {
    const int j = (k * kThreads + threadIdx.x) * kVec;
    if (vec && j + kVec <= len) {
      Moments<float>::store4(p, j, rp[k]);
      M::store4(m, j, rm[k]);
      M::store4(v, j, rv[k]);
    } else {
#pragma unroll
      for (int t = 0; t < kVec; ++t) {
        if (j + t < len) {
          p[j + t] = rp[k][t];
          M::store(m, j + t, rm[k][t]);
          M::store(v, j + t, rv[k][t]);
        }
      }
    }
  }
}

}  // namespace

extern "C" {

// Launches one update of `count` leaves on `stream`; returns
// cudaGetLastError() after the launch (0 on success). `ptrs` holds
// kPtrFields device pointers per leaf (p, g, m, v, c12, gate; gate may be
// 0), `geom` kGeomFields ints per leaf (elements, first chunk) as
// multimodn_tpu_torch/ops/fused_adam_fp32.py::chunk_table lays them out,
// `blocks` the chunks in all. p and g are float32; m and v float32 for
// state_type 0 and bfloat16 for 1.
int mmn_adam_fp32_multi(const int64_t* ptrs, const int* geom, int count,
                        int blocks, float lr, float b1, float omb1, float b2,
                        float omb2, float eps, int state_type, void* stream) {
  if (count <= 0 || count > kMaxLeaves || blocks <= 0 ||
      (state_type != kFp32 && state_type != kBf16))
    return (int)cudaErrorInvalidValue;
  Args a;
  std::memset(&a, 0, sizeof(a));
  long chunks = 0;
  for (int l = 0; l < count; ++l) {
    const int64_t* q = ptrs + kPtrFields * l;
    const int* gm = geom + kGeomFields * l;
    if (gm[0] <= 0 || gm[1] != chunks || q[0] == 0 || q[1] == 0 ||
        q[2] == 0 || q[3] == 0 || q[4] == 0)
      return (int)cudaErrorInvalidValue;
    a.p[l] = reinterpret_cast<float*>(q[0]);
    a.g[l] = reinterpret_cast<const float*>(q[1]);
    a.m[l] = reinterpret_cast<void*>(q[2]);
    a.v[l] = reinterpret_cast<void*>(q[3]);
    a.c12[l] = reinterpret_cast<const float*>(q[4]);
    a.gate[l] = reinterpret_cast<const float*>(q[5]);
    a.n[l] = gm[0];
    a.first[l] = gm[1];
    chunks += (gm[0] + kChunk - 1) / kChunk;
  }
  if (chunks != blocks) return (int)cudaErrorInvalidValue;
  a.count = count;
  a.lr = lr;
  a.b1 = b1;
  a.omb1 = omb1;
  a.b2 = b2;
  a.omb2 = omb2;
  a.eps = eps;
  if (state_type == kFp32)
    adam_fp32_kernel<float><<<blocks, kThreads, 0, (cudaStream_t)stream>>>(a);
  else
    adam_fp32_kernel<__nv_bfloat16>
        <<<blocks, kThreads, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

const char* mmn_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"

// One-pass 8-bit blockwise Adam update of many parameter leaves in one
// launch, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel multimodn_tpu/ops/fused_adam.py::
// _make_leaf_pallas. Each leaf is seen as (rows, cols); the moments m and v
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
// writes p, mq, vq (6 B), plus 16 B per row of scales, for ~22 flops: far
// below the card's ~20 flop/byte ridge, so a large leaf is bound by bytes at
// 3.35 TB/s. A step of the MIMIC model is small (83,742 parameters in 37
// leaves, ~1.4 MB): there the bound is the launch itself.
//
// Design:
// - One launch updates up to kMaxLeaves leaves. The host passes a leaf
//   table by value (__grid_constant__): per leaf its 8 device pointers
//   (gate may be null, c12 and gate are per leaf because every encoder group
//   has its own step count), rows, cols, lanes per row and the index of its
//   first block. A block finds its leaf from those offsets; a block never
//   spans two leaves.
// - A row of up to kFitCols columns is held by a group of `lanes` threads
//   (a power of two, several rows per block when rows are narrow; the host
//   gives a lane one run where that spreads a small leaf over more blocks,
//   up to kFitGroups on a large leaf); a lane loads runs of 4 consecutive
//   elements (16-byte loads of p and g, 4-byte loads of the codes when the
//   leaf is aligned),
//   computes m', v' and p', writes p' at once and keeps m', v' in registers
//   across the row's absmax (a segmented shuffle reduction, or shared memory
//   when a row spans warps), then writes the codes: one read of device
//   memory.
// - A wider row is split into chunks of kSplitCols columns, one block each.
//   Pass 1 writes p' and takes the chunk's absmax into the row's scratch
//   words with atomicMax on the bits of |x| (exact in any order, and a
//   positive NaN's bits exceed +inf's, so NaN still wins); the chunk-0 block
//   also copies the row's old scales into scratch. Pass 2, a second launch,
//   recomputes m', v' from the unchanged g and codes and the old scales in
//   scratch (bit-identical), writes the codes, and the chunk-0 block writes
//   the new scales: no block of a row reads a scale another block wrote.
// __fmul_rn/__fadd_rn/__fsub_rn/__fdiv_rn/__fsqrt_rn keep nvcc from
// contracting into FMAs, so the result equals the plain PyTorch version bit
// for bit; max and clip propagate NaN like jnp.max/jnp.clip.
#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <cstring>

namespace {

constexpr int kWarp = 32;
constexpr int kThreads = 256;
constexpr int kVec = 4;                                   // elements per run
constexpr int kFitGroups = 4;                             // runs per lane
constexpr int kFitCols = kThreads * kVec * kFitGroups;    // 4096
constexpr int kSplitCols = kThreads * kVec;               // 1024 per block
constexpr int kMaxLeaves = 40;
constexpr int kGeomFields = 6;   // rows, cols, lanes, first, first2, srow
constexpr int kScratchWords = 4; // per split row: |m'|, |v'| max, old ms, vs
enum Format { kFp8 = 0, kInt8 = 1 };

struct Leaf {
  float* p;
  const float* g;
  uint8_t* mq;
  float* ms;
  uint8_t* vq;
  float* vs;
  const float* c12;    // (c1, c2) on the device
  const float* gate;   // nullptr: ungated
  int rows, cols;
  int lanes;           // threads per row; 0: the row is split across blocks
  int first_block;     // in pass 1
  int first_block2;    // in pass 2 (split leaves only)
  int scratch_row0;    // first split row's index in scratch
  int vec;             // aligned for vector loads
};

struct MultiArgs {
  Leaf leaf[kMaxLeaves];
  unsigned* scratch;
  int n;
  float lr, b1, omb1, b2, omb2, eps;
  int fmt;
};
static_assert(sizeof(MultiArgs) <= 4096, "kernel parameters exceed 4 KB");

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

// One run of up to kVec elements starting at column j of a row.
struct Run {
  float p[kVec], g[kVec];
  uint8_t mq[kVec], vq[kVec];
};

__device__ __forceinline__ void load_run(const Leaf& L, long i, int n,
                                         bool with_p, Run& r) {
  if (L.vec && n == kVec) {
    if (with_p) {
      const float4 p4 = *reinterpret_cast<const float4*>(L.p + i);
      r.p[0] = p4.x; r.p[1] = p4.y; r.p[2] = p4.z; r.p[3] = p4.w;
    }
    const float4 g4 = *reinterpret_cast<const float4*>(L.g + i);
    r.g[0] = g4.x; r.g[1] = g4.y; r.g[2] = g4.z; r.g[3] = g4.w;
    const uchar4 m4 = *reinterpret_cast<const uchar4*>(L.mq + i);
    const uchar4 v4 = *reinterpret_cast<const uchar4*>(L.vq + i);
    r.mq[0] = m4.x; r.mq[1] = m4.y; r.mq[2] = m4.z; r.mq[3] = m4.w;
    r.vq[0] = v4.x; r.vq[1] = v4.y; r.vq[2] = v4.z; r.vq[3] = v4.w;
    return;
  }
#pragma unroll
  for (int t = 0; t < kVec; ++t) {
    if (t < n) {
      if (with_p) r.p[t] = L.p[i + t];
      r.g[t] = L.g[i + t];
      r.mq[t] = L.mq[i + t];
      r.vq[t] = L.vq[i + t];
    }
  }
}

__device__ __forceinline__ void store_p(const Leaf& L, long i, int n,
                                       const float (&p)[kVec]) {
  if (L.vec && n == kVec) {
    *reinterpret_cast<float4*>(L.p + i) = make_float4(p[0], p[1], p[2], p[3]);
    return;
  }
#pragma unroll
  for (int t = 0; t < kVec; ++t)
    if (t < n) L.p[i + t] = p[t];
}

__device__ __forceinline__ void store_codes(const Leaf& L, long i, int n,
                                            const uint8_t (&mq)[kVec],
                                            const uint8_t (&vq)[kVec]) {
  if (L.vec && n == kVec) {
    *reinterpret_cast<uchar4*>(L.mq + i) = make_uchar4(mq[0], mq[1], mq[2],
                                                       mq[3]);
    *reinterpret_cast<uchar4*>(L.vq + i) = make_uchar4(vq[0], vq[1], vq[2],
                                                       vq[3]);
    return;
  }
#pragma unroll
  for (int t = 0; t < kVec; ++t) {
    if (t < n) {
      L.mq[i + t] = mq[t];
      L.vq[i + t] = vq[t];
    }
  }
}

// The row's scalars: old scales, gate, bias corrections.
struct RowScalars {
  float ms, vs, gate, c1, c2;
};

// m', v' of one element.
__device__ __forceinline__ void moments(const MultiArgs& a, const Leaf& L,
                                        const RowScalars& s, float g,
                                        uint8_t mq, uint8_t vq, float& m_new,
                                        float& v_new) {
  const float m = __fmul_rn(decode(mq, a.fmt), s.ms);
  const float v = __fmul_rn(decode(vq, a.fmt), s.vs);
  if (L.gate == nullptr) {
    m_new = __fadd_rn(__fmul_rn(a.b1, m), __fmul_rn(a.omb1, g));
    v_new = __fadd_rn(__fmul_rn(a.b2, v), __fmul_rn(__fmul_rn(a.omb2, g), g));
  } else {
    m_new = __fadd_rn(m, __fmul_rn(__fmul_rn(s.gate, a.omb1), __fsub_rn(g, m)));
    v_new = __fadd_rn(v, __fmul_rn(__fmul_rn(s.gate, a.omb2),
                                   __fsub_rn(__fmul_rn(g, g), v)));
  }
}

// p' of one element from its m', v'.
__device__ __forceinline__ float step(const MultiArgs& a, const Leaf& L,
                                      const RowScalars& s, float p,
                                      float m_new, float v_new) {
  const float neg_lr = L.gate == nullptr ? -a.lr : __fmul_rn(-a.lr, s.gate);
  const float denom = __fadd_rn(__fsqrt_rn(__fdiv_rn(v_new, s.c2)), a.eps);
  return __fadd_rn(p, __fdiv_rn(__fmul_rn(neg_lr, __fdiv_rn(m_new, s.c1)),
                                denom));
}

__device__ __forceinline__ RowScalars row_scalars(const Leaf& L, float ms,
                                                  float vs) {
  RowScalars s;
  s.ms = ms;
  s.vs = vs;
  s.gate = L.gate == nullptr ? 1.0f : *L.gate;
  s.c1 = L.c12[0];
  s.c2 = L.c12[1];
  return s;
}

// Max of (am, av) over each group of `lanes` consecutive threads (a power
// of two, the same for the whole block). Every thread of the block calls it.
__device__ __forceinline__ void group_max(float& am, float& av, int lanes,
                                          float* red) {
  const int width = lanes < kWarp ? lanes : kWarp;
  for (int off = width / 2; off > 0; off /= 2) {
    am = nan_max(am, __shfl_xor_sync(0xffffffffu, am, off));
    av = nan_max(av, __shfl_xor_sync(0xffffffffu, av, off));
  }
  if (lanes > kWarp) {
    const int warp = threadIdx.x / kWarp;
    if (threadIdx.x % kWarp == 0) {
      red[warp] = am;
      red[kThreads / kWarp + warp] = av;
    }
    __syncthreads();
    const int w0 = (threadIdx.x / lanes) * (lanes / kWarp);
    am = red[w0];
    av = red[kThreads / kWarp + w0];
    for (int w = 1; w < lanes / kWarp; ++w) {
      am = nan_max(am, red[w0 + w]);
      av = nan_max(av, red[kThreads / kWarp + w0 + w]);
    }
  }
}

__device__ __forceinline__ float q_top(int fmt) {
  return fmt == kInt8 ? 127.0f : 448.0f;
}

// Rows that fit a block: one group of L.lanes threads per row, one read.
__device__ void fit_rows(const MultiArgs& a, const Leaf& L, int blk,
                         float* red) {
  const int lanes = L.lanes;
  const int grp = threadIdx.x / lanes, lane = threadIdx.x % lanes;
  const int row = blk * (kThreads / lanes) + grp;
  const bool active = row < L.rows;
  const long base = (long)row * L.cols;
  float m[kFitGroups][kVec] = {}, v[kFitGroups][kVec] = {};
  float amax_m = 0.0f, amax_v = 0.0f;
  RowScalars s;
  if (active) {
    s = row_scalars(L, L.ms[row], L.vs[row]);
#pragma unroll
    for (int k = 0; k < kFitGroups; ++k) {
      const int j = (k * lanes + lane) * kVec;
      if (j < L.cols) {
        const int n = min(kVec, L.cols - j);
        Run r;
        load_run(L, base + j, n, true, r);
        float p[kVec];
#pragma unroll
        for (int t = 0; t < kVec; ++t) {
          if (t < n) {
            moments(a, L, s, r.g[t], r.mq[t], r.vq[t], m[k][t], v[k][t]);
            p[t] = step(a, L, s, r.p[t], m[k][t], v[k][t]);
            amax_m = nan_max(amax_m, fabsf(m[k][t]));
            amax_v = nan_max(amax_v, fabsf(v[k][t]));
          }
        }
        store_p(L, base + j, n, p);
      }
    }
  }
  group_max(amax_m, amax_v, lanes, red);
  if (!active) return;
  const float top = q_top(a.fmt);
  const float inv_m = amax_m > 0.0f ? __fdiv_rn(top, amax_m) : 0.0f;
  const float inv_v = amax_v > 0.0f ? __fdiv_rn(top, amax_v) : 0.0f;
#pragma unroll
  for (int k = 0; k < kFitGroups; ++k) {
    const int j = (k * lanes + lane) * kVec;
    if (j < L.cols) {
      const int n = min(kVec, L.cols - j);
      uint8_t mq[kVec], vq[kVec];
#pragma unroll
      for (int t = 0; t < kVec; ++t) {
        mq[t] = encode(m[k][t], inv_m, a.fmt);
        vq[t] = encode(v[k][t], inv_v, a.fmt);
      }
      store_codes(L, base + j, n, mq, vq);
    }
  }
  // Every lane of the row read the old scales before group_max.
  if (lane == 0) {
    L.ms[row] = __fdiv_rn(amax_m, top);
    L.vs[row] = __fdiv_rn(amax_v, top);
  }
}

// A chunk of a split row: pass 1 writes p' and the chunk's absmax.
__device__ void split_pass1(const MultiArgs& a, const Leaf& L, int blk,
                            float* red) {
  const int chunks = (L.cols + kSplitCols - 1) / kSplitCols;
  const int row = blk / chunks, chunk = blk % chunks;
  const long base = (long)row * L.cols;
  const int j = chunk * kSplitCols + threadIdx.x * kVec;
  unsigned* sc = a.scratch + (size_t)(L.scratch_row0 + row) * kScratchWords;
  const float ms = L.ms[row], vs = L.vs[row];
  float amax_m = 0.0f, amax_v = 0.0f;
  if (j < L.cols) {
    const RowScalars s = row_scalars(L, ms, vs);
    const int n = min(kVec, L.cols - j);
    Run r;
    load_run(L, base + j, n, true, r);
    float p[kVec];
#pragma unroll
    for (int t = 0; t < kVec; ++t) {
      if (t < n) {
        float m_new, v_new;
        moments(a, L, s, r.g[t], r.mq[t], r.vq[t], m_new, v_new);
        p[t] = step(a, L, s, r.p[t], m_new, v_new);
        amax_m = nan_max(amax_m, fabsf(m_new));
        amax_v = nan_max(amax_v, fabsf(v_new));
      }
    }
    store_p(L, base + j, n, p);
  }
  group_max(amax_m, amax_v, kThreads, red);
  if (threadIdx.x == 0) {
    atomicMax(sc + 0, __float_as_uint(amax_m));
    atomicMax(sc + 1, __float_as_uint(amax_v));
    if (chunk == 0) {
      sc[2] = __float_as_uint(ms);
      sc[3] = __float_as_uint(vs);
    }
  }
}

// A chunk of a split row: pass 2 writes the codes, chunk 0 the scales.
__device__ void split_pass2(const MultiArgs& a, const Leaf& L, int blk) {
  const int chunks = (L.cols + kSplitCols - 1) / kSplitCols;
  const int row = blk / chunks, chunk = blk % chunks;
  const long base = (long)row * L.cols;
  const int j = chunk * kSplitCols + threadIdx.x * kVec;
  const unsigned* sc =
      a.scratch + (size_t)(L.scratch_row0 + row) * kScratchWords;
  const float amax_m = __uint_as_float(sc[0]);
  const float amax_v = __uint_as_float(sc[1]);
  const float top = q_top(a.fmt);
  if (j < L.cols) {
    const RowScalars s =
        row_scalars(L, __uint_as_float(sc[2]), __uint_as_float(sc[3]));
    const float inv_m = amax_m > 0.0f ? __fdiv_rn(top, amax_m) : 0.0f;
    const float inv_v = amax_v > 0.0f ? __fdiv_rn(top, amax_v) : 0.0f;
    const int n = min(kVec, L.cols - j);
    Run r;
    load_run(L, base + j, n, false, r);
    uint8_t mq[kVec], vq[kVec];
#pragma unroll
    for (int t = 0; t < kVec; ++t) {
      float m_new = 0.0f, v_new = 0.0f;
      if (t < n) moments(a, L, s, r.g[t], r.mq[t], r.vq[t], m_new, v_new);
      mq[t] = encode(m_new, inv_m, a.fmt);
      vq[t] = encode(v_new, inv_v, a.fmt);
    }
    store_codes(L, base + j, n, mq, vq);
  }
  if (chunk == 0 && threadIdx.x == 0) {
    L.ms[row] = __fdiv_rn(amax_m, top);
    L.vs[row] = __fdiv_rn(amax_v, top);
  }
}

// The leaf that owns `block`: the last one whose first block is <= it
// (first blocks are non-decreasing; a leaf with no blocks in this pass
// shares its first block with the next).
__device__ __forceinline__ int find_leaf(const MultiArgs& a, int block,
                                         bool pass2) {
  int l = 0;
  for (int i = 1; i < a.n; ++i) {
    const int first = pass2 ? a.leaf[i].first_block2 : a.leaf[i].first_block;
    if (first <= block) l = i;
  }
  return l;
}

__global__ void __launch_bounds__(kThreads)
    fused_adam_pass1(const __grid_constant__ MultiArgs a) {
  __shared__ float red[2 * kThreads / kWarp];
  const int l = find_leaf(a, blockIdx.x, false);
  const Leaf& L = a.leaf[l];
  const int blk = blockIdx.x - L.first_block;
  if (L.lanes > 0)
    fit_rows(a, L, blk, red);
  else
    split_pass1(a, L, blk, red);
}

__global__ void __launch_bounds__(kThreads)
    fused_adam_pass2(const __grid_constant__ MultiArgs a) {
  const int l = find_leaf(a, blockIdx.x, true);
  const Leaf& L = a.leaf[l];
  split_pass2(a, L, blockIdx.x - L.first_block2);
}

}  // namespace

extern "C" {

// Launches pass `pass` (1 or 2) of the update of `n` leaves on `stream`;
// returns cudaGetLastError() after launch (0 on success). `ptrs` holds 8
// device pointers per leaf (p, g, mq, ms, vq, vs, c12, gate; gate may be
// 0), `geom` kGeomFields ints per leaf as
// multimodn_tpu_torch/ops/fused_adam.py::leaf_table lays them out, `blocks`
// the pass's grid. mq/vq hold float8_e4m3fn codes for fmt 0 and int8 codes
// for fmt 1; ms/vs one scale per row. `scratch` holds kScratchWords zeroed
// words per split row (may be null when no row is split).
int mmn_fused_adam_multi(const int64_t* ptrs, const int* geom, int n,
                         int pass, int blocks, unsigned* scratch, float lr,
                         float b1, float omb1, float b2, float omb2,
                         float eps, int fmt, void* stream) {
  if (n <= 0 || n > kMaxLeaves || blocks <= 0 || (pass != 1 && pass != 2) ||
      (fmt != kFp8 && fmt != kInt8))
    return (int)cudaErrorInvalidValue;
  MultiArgs a;
  std::memset(&a, 0, sizeof(a));
  for (int l = 0; l < n; ++l) {
    const int64_t* q = ptrs + 8 * l;
    const int* gm = geom + kGeomFields * l;
    Leaf& L = a.leaf[l];
    L.p = reinterpret_cast<float*>(q[0]);
    L.g = reinterpret_cast<const float*>(q[1]);
    L.mq = reinterpret_cast<uint8_t*>(q[2]);
    L.ms = reinterpret_cast<float*>(q[3]);
    L.vq = reinterpret_cast<uint8_t*>(q[4]);
    L.vs = reinterpret_cast<float*>(q[5]);
    L.c12 = reinterpret_cast<const float*>(q[6]);
    L.gate = reinterpret_cast<const float*>(q[7]);
    L.rows = gm[0];
    L.cols = gm[1];
    L.lanes = gm[2];
    L.first_block = gm[3];
    L.first_block2 = gm[4];
    L.scratch_row0 = gm[5];
    if (L.rows <= 0 || L.cols <= 0 || L.lanes < 0 || L.lanes > kThreads ||
        (L.lanes & (L.lanes - 1)) != 0 ||
        (L.lanes > 0 && L.cols > L.lanes * kVec * kFitGroups) ||
        (L.lanes == 0 && scratch == nullptr))
      return (int)cudaErrorInvalidValue;
    L.vec = L.cols % kVec == 0 && ((q[0] | q[1]) & 15) == 0 &&
            ((q[2] | q[4]) & 3) == 0;
  }
  a.scratch = scratch;
  a.n = n;
  a.lr = lr;
  a.b1 = b1;
  a.omb1 = omb1;
  a.b2 = b2;
  a.omb2 = omb2;
  a.eps = eps;
  a.fmt = fmt;
  if (pass == 1)
    fused_adam_pass1<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(a);
  else
    fused_adam_pass2<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

const char* mmn_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"

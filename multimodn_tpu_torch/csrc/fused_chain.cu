// The whole MultiModN forward in two CUDA stages, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel multimodn_tpu/ops/fused_chain.py::
// make_fused_chain_forward: broadcast one init-state row, run E MLP-family
// encoders (first- or last-concat, the concat split as x@Wx + s@Ws + b),
// keep each sample's old state where its modality is invalid, and evaluate
// every dense decoder after the initial state and after each encoder.
//
// What bounds it on an H100: at the MIMIC width a sample costs ~105k MACs
// against ~8.7 KB of input and output, ~24 FLOP per byte, just above the
// fp32 CUDA-core ridge (67 TFLOP/s over 3.35 TB/s, ~20 FLOP per byte): a
// large batch is bound by operations with bytes close behind, a small one
// by latency. The model splits where the work splits: 58% of the MACs and
// nearly all the bytes are the x-parts of the concat layers (and, for a
// last-concat encoder, the layers before it), which never read the state;
// the rest is a chain of small products on the state.
//
// Design:
// - Stage A (stage_a_gemm): every state-independent product, as a batched
//   tiled fp32 GEMM over (job, 128-row tile, 32-column tile, K split)
//   blocks, so even one request of 16 rows spreads over many SMs (61 blocks
//   at the MIMIC width). A job is a projection x@Wx (no bias) or a
//   data-only hidden layer of a last-concat encoder (bias and activation in
//   the epilogue; jobs that feed each other are separate launches, one per
//   depth; a softmax hidden layer gets a row pass, row_softmax, after its
//   GEMM). Jobs read each layer's weights where the parameter tensors hold
//   them. The first launch also runs copy blocks, which pack the state-path
//   weights from the parameters into one padded region for Stage B, so the
//   host concatenates nothing. X and W tiles stream through shared memory with cp.async (16
//   bytes where rows are aligned), double-buffered; each thread keeps a
//   4-row x 4-column register tile. At small B a projection's K range is
//   split across blocks: each split writes its own partial, and the last
//   block of the output tile to take a ticket sums the partials in split
//   order, so there are no float atomics and the result is deterministic.
// - Stage B (chain_kernel): one block per batch tile, persistent over tiles
//   at large B. The state-path weights (each concat layer's s@Ws, the
//   layers after a first-concat layer, every decoder; 92 KB at MIMIC width,
//   packed by Stage A padded to 4 columns) come into shared memory with one bulk
//   copy (TMA, completing on an mbarrier) that overlaps the tile's set-up;
//   where they do not fit beside the tiles, the same code reads them
//   through L1/L2. The block runs the E steps on shared-memory tiles, each
//   concat layer adding Stage A's projection (loaded while the state
//   product runs), and every decoder. An output item is a few rows x 4
//   columns read with 16-byte loads. Small batches take 16-row tiles and
//   keep all E+1 state tiles in shared memory, so each decoder layer runs
//   once over all of them instead of after every encoder: one SM walks the
//   chain, and the count of dependent layers is what costs. Large batches
//   take 128-row tiles on 512 threads (2 rows per item), one block per SM,
//   with the decoders after every encoder.
// - The ragged last tile is masked in both stages, so the caller pads
//   nothing. relu passes NaN (as torch.relu), gelu is the tanh form.
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>
#include <cstring>
#include <type_traits>

namespace {

constexpr int kThreads = 256;
constexpr int kWarp = 32;

__host__ __device__ __forceinline__ int round4(int x) {
  return (x + 3) & ~3;
}
enum Activation { kIdentity = 0, kRelu, kSigmoid, kTanh, kGelu, kSoftmax };

__device__ __forceinline__ float activate(int act, float v) {
  switch (act) {
    case kRelu: return v < 0.f ? 0.f : v;  // NaN passes, as torch.relu
    case kSigmoid: return 1.f / (1.f + expf(-v));
    case kTanh: return tanhf(v);
    case kGelu: {  // tanh form, as jax.nn.gelu
      const float c = 0.7978845608028654f;  // sqrt(2 / pi)
      return 0.5f * v * (1.f + tanhf(c * (v + 0.044715f * v * v * v)));
    }
    default: return v;  // identity; softmax is a row pass
  }
}

// ---------------------------------------------------------------------------
// Stage A: state-independent products
// ---------------------------------------------------------------------------

constexpr int kBM = 128, kBN = 32, kBK = 32;
constexpr int kThreadsA = 256;                     // Stage A's block
constexpr int kRowsA = kBM / (kThreadsA / (kBN / 4));  // rows per thread
constexpr int kXld = kBK + 4;   // keeps 16-byte rows, spreads banks
constexpr int kMaxJobs = 32;
constexpr int kMaxSplit = 32;
// Job layout; multimodn_tpu_torch/ops/fused_chain.py::ChainSpec.stage_a_plan
// writes it as int64 words: in, out, w, bias, counters (device pointers;
// bias and counters may be 0), ld_in, K, N, act, ksplit, chunks per split,
// m tiles, n tiles, first block, split stride (elements between partial
// outputs).
constexpr int kJobFields = 15;
// Copy layout, int64 words: w, b, dst (device pointers), K, N, first copy
// block. A copy block writes kCopySpan floats of one layer's padded matrix
// and bias.
constexpr int kCopyFields = 6;
constexpr int kMaxCopies = 24;
constexpr int kCopySpan = 4096;

struct GemmJob {
  const float* in;
  float* out;
  const float* w;      // (K, N) row-major
  const float* bias;   // nullptr: a projection (no bias, no activation)
  int* counters;       // one ticket per output tile when K is split, 0
                       // before the launch and 0 again after it
  long long split_stride;
  int ld_in, K, N, act;
  int ksplit, chunks, m_tiles, n_tiles, first_block;
};

// One state-path layer packed for Stage B: w (K, N) row-major and b (N,)
// become (round4(K), round4(N)) row-major then round4(N) floats at dst,
// zeros in the pads.
struct CopyJob {
  const float* w;
  const float* b;
  float* dst;
  int K, N, first_block;
};

struct StageAArgs {
  GemmJob job[kMaxJobs];
  CopyJob copy[kMaxCopies];
  int n_jobs, n_copies;
  int gemm_blocks;   // blocks from here on are copy blocks
  int batch;
};
static_assert(sizeof(StageAArgs) <= 4096, "kernel parameters exceed 4 KB");

__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool valid) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  const int n = valid ? 4 : 0;   // 0: fill with zeros, read nothing
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(src), "r"(n));
}

__device__ __forceinline__ void cp_async16z(float* dst, const float* src,
                                            bool valid) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  const int n = valid ? 16 : 0;   // 0: fill with zeros, read nothing
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending));
}

__device__ __forceinline__ void copy_block(const StageAArgs& a, int local) {
  int c = 0;
  for (int i = 1; i < a.n_copies; ++i)
    if (a.copy[i].first_block <= local) c = i;
  const CopyJob& C = a.copy[c];
  const int kp = round4(C.K), np = round4(C.N);
  const int d0 = (local - C.first_block) * kCopySpan;
  const int d1 = min(d0 + kCopySpan, kp * np + np);
  for (int d = d0 + threadIdx.x; d < d1; d += kThreadsA) {
    float v;
    if (d < kp * np) {
      const int r = d / np, col = d % np;
      v = r < C.K && col < C.N ? C.w[(size_t)r * C.N + col] : 0.f;
    } else {
      const int col = d - kp * np;
      v = col < C.N ? C.b[col] : 0.f;
    }
    C.dst[d] = v;
  }
}

__global__ void __launch_bounds__(kThreadsA)
    stage_a_gemm(const __grid_constant__ StageAArgs a) {
  if ((int)blockIdx.x >= a.gemm_blocks) {
    copy_block(a, blockIdx.x - a.gemm_blocks);
    return;
  }
  __shared__ __align__(16) float xs[2][kBM][kXld];
  __shared__ __align__(16) float ws[2][kBK][kBN];
  int j = 0;
  for (int i = 1; i < a.n_jobs; ++i)
    if (a.job[i].first_block <= (int)blockIdx.x) j = i;
  const GemmJob& J = a.job[j];
  const int B = a.batch;
  int local = blockIdx.x - J.first_block;
  const int ks = local % J.ksplit;
  local /= J.ksplit;
  const int nt = local % J.n_tiles, mt = local / J.n_tiles;
  const int m0 = mt * kBM, n0 = nt * kBN;
  const int n_chunks = (J.K + kBK - 1) / kBK;
  const int c0 = ks * J.chunks;
  const int c1 = min(c0 + J.chunks, n_chunks);
  const int tx = threadIdx.x % (kBN / 4), ty = threadIdx.x / (kBN / 4);

  // X rows load 16 bytes at a time where every row start is 16-byte
  // aligned (K and the row stride multiples of 4), else 4 bytes.
  const bool vec = (J.ld_in % 4 == 0) && (J.K % 4 == 0) &&
                   (reinterpret_cast<size_t>(J.in) % 16 == 0);
  auto load = [&](int c, int buf) {
    const int k0 = c * kBK;
    if (vec) {
#pragma unroll
      for (int q = 0; q < kBM * kBK / (4 * kThreadsA); ++q) {
        const int e = threadIdx.x + kThreadsA * q;
        const int r = e / (kBK / 4), kk = 4 * (e % (kBK / 4));
        const bool valid = m0 + r < B && k0 + kk < J.K;
        cp_async16z(&xs[buf][r][kk],
                    valid ? J.in + (size_t)(m0 + r) * J.ld_in + k0 + kk
                          : J.in,
                    valid);
      }
    } else {
#pragma unroll
      for (int q = 0; q < kBM * kBK / kThreadsA; ++q) {
        const int e = threadIdx.x + kThreadsA * q;
        const int r = e / kBK, kk = e % kBK;
        const bool valid = m0 + r < B && k0 + kk < J.K;
        cp_async4(&xs[buf][r][kk],
                  valid ? J.in + (size_t)(m0 + r) * J.ld_in + k0 + kk : J.in,
                  valid);
      }
    }
#pragma unroll
    for (int q = 0; q < kBK * kBN / kThreadsA; ++q) {
      const int e = threadIdx.x + kThreadsA * q;
      const int kr = e / kBN, n = e % kBN;
      const bool valid = k0 + kr < J.K && n0 + n < J.N;
      cp_async4(&ws[buf][kr][n],
                valid ? J.w + (size_t)(k0 + kr) * J.N + n0 + n : J.w, valid);
    }
    cp_async_commit();
  };

  float acc[kRowsA][4];
#pragma unroll
  for (int i = 0; i < kRowsA; ++i)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[i][c] = 0.f;

  if (c0 < c1) load(c0, 0);
  for (int c = c0; c < c1; ++c) {
    const int buf = (c - c0) & 1;
    if (c + 1 < c1) {
      load(c + 1, buf ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 4) {
      float4 x4[kRowsA], w4[4];
#pragma unroll
      for (int i = 0; i < kRowsA; ++i)
        x4[i] = *reinterpret_cast<const float4*>(&xs[buf][ty + (kBM / kRowsA) * i][kk]);
#pragma unroll
      for (int u = 0; u < 4; ++u)
        w4[u] = *reinterpret_cast<const float4*>(&ws[buf][kk + u][4 * tx]);
#pragma unroll
      for (int i = 0; i < kRowsA; ++i) {
        const float xv[4] = {x4[i].x, x4[i].y, x4[i].z, x4[i].w};
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          acc[i][0] = fmaf(xv[u], w4[u].x, acc[i][0]);
          acc[i][1] = fmaf(xv[u], w4[u].y, acc[i][1]);
          acc[i][2] = fmaf(xv[u], w4[u].z, acc[i][2]);
          acc[i][3] = fmaf(xv[u], w4[u].w, acc[i][3]);
        }
      }
    }
    __syncthreads();   // this buffer is refilled two chunks on
  }

  float* out = J.out + (size_t)ks * J.split_stride;
#pragma unroll
  for (int i = 0; i < kRowsA; ++i) {
    const int row = m0 + ty + (kBM / kRowsA) * i;
    if (row >= B) continue;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int col = n0 + 4 * tx + c;
      if (col >= J.N) continue;
      float v = acc[i][c];
      if (J.bias != nullptr) v = activate(J.act, v + J.bias[col]);
      out[(size_t)row * J.N + col] = v;
    }
  }
  if (J.ksplit == 1) return;

  // K was split: the last block of this output tile to finish sums the
  // partials in split order into the first one, whichever block it is.
  __shared__ bool last;
  __threadfence();
  __syncthreads();
  int* const ticket = J.counters + mt * J.n_tiles + nt;
  if (threadIdx.x == 0) last = atomicAdd(ticket, 1) == J.ksplit - 1;
  __syncthreads();
  if (!last) return;
  if (threadIdx.x == 0) *ticket = 0;   // every block has taken its ticket
  __threadfence();
  const int rows = min(kBM, B - m0), cols = min(kBN, J.N - n0);
  for (int e = threadIdx.x; e < rows * cols; e += kThreadsA) {
    float* o = J.out + (size_t)(m0 + e / cols) * J.N + n0 + e % cols;
    float part[kMaxSplit];
#pragma unroll
    for (int s = 0; s < kMaxSplit; ++s)
      part[s] = s < J.ksplit ? __ldcg(o + s * J.split_stride) : 0.f;
    float v = part[0];
#pragma unroll
    for (int s = 1; s < kMaxSplit; ++s)
      if (s < J.ksplit) v += part[s];
    *o = v;
  }
}

// Row softmax in place over a (rows, n) buffer: one warp per row.
__global__ void __launch_bounds__(kThreads)
    row_softmax(float* x, int rows, int n) {
  const int row = blockIdx.x * (kThreads / kWarp) + threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  if (row >= rows) return;   // whole warps leave together
  float* r = x + (size_t)row * n;
  float m = __int_as_float(0xff800000);   // -inf
  for (int c = lane; c < n; c += kWarp) m = fmaxf(m, r[c]);
  for (int off = kWarp / 2; off > 0; off /= 2)
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
  float s = 0.f;
  for (int c = lane; c < n; c += kWarp) {
    const float e = expf(r[c] - m);
    r[c] = e;
    s += e;
  }
  for (int off = kWarp / 2; off > 0; off /= 2)
    s += __shfl_xor_sync(0xffffffffu, s, off);
  for (int c = lane; c < n; c += kWarp) r[c] /= s;
}

// ---------------------------------------------------------------------------
// Stage B: the state chain
// ---------------------------------------------------------------------------

constexpr int kMaxPlan = 640;
constexpr int kMaxEnc = 32;
constexpr int kMaxDec = 32;
// Plan layout; multimodn_tpu_torch/ops/fused_chain.py::ChainSpec writes it.
//   header: E, D, S, n_layers, state row stride, hidden row stride,
//           state-path region length (floats)
//   E encoder records: first layer, n_layers
//   D decoder records: first layer, n_layers, n_classes
//   layer records: source, K, N, activation, w offset, bias offset,
//                  adds the encoder's Stage A projection (0/1)
// Weights are (K rounded up to 4, N rounded up to 4) row-major with zero
// pads, biases N rounded up to 4, offsets from the region's start (Stage
// A's copy blocks write it).
constexpr int kHeader = 7;
constexpr int kEncFields = 2;
constexpr int kDecFields = 3;
constexpr int kLayerFields = 7;
enum Source { kSrcPrev = 1, kSrcState = 2 };

struct ChainArgs {
  int plan[kMaxPlan];
  const float* proj[kMaxEnc];   // Stage A's summed projections, (B, N)
  float* dec_out[kMaxDec];
  const float* weights;         // the state-path region
  const float* valid;
  const float* init;
  float* states;
  int batch;
};
static_assert(sizeof(ChainArgs) <= 4096, "kernel parameters exceed 4 KB");

template <bool kSmemW>
__device__ __forceinline__ float4 load_w4(const float* w) {
  if (kSmemW) return *reinterpret_cast<const float4*>(w);
  return __ldg(reinterpret_cast<const float4*>(w));
}

// out[0:R, 0:N] = act(in @ W + b [+ P]) over R = groups * kRows rows of
// shared memory, kThreads threads; an item is kRows rows (rg + groups * i)
// x 4 columns, and neighbouring lanes take neighbouring rows, so a warp's
// 16-byte loads of the input rows are distinct and conflict-free. P (Stage
// A's projection, rows of p_ld) is read for rows below p_rows. Columns
// N..round4(N) of out are written as 0; in's columns K..round4(K) must be
// 0. Ends synchronised.
template <int kRows, int kThreads, bool kSmemW>
__device__ __forceinline__ void dense(const float* in, int ld_in, int K,
                                      const float* W, const float* b, int N,
                                      int act, int groups, const float* P,
                                      int p_ld, int p_rows, float* out,
                                      int ld_out) {
  const int kp = round4(K), np = round4(N), ncq = np / 4;
  const int items = groups * ncq;
  for (int it = threadIdx.x; it < items; it += kThreads) {
    const int rg = it % groups, cq = it / groups;
    float acc[kRows][4], pv[kRows][4];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[i][c] = pv[i][c] = 0.f;
    // The projection, in flight while the state product runs.
    if (P != nullptr) {
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        const int r = rg + groups * i;
#pragma unroll
        for (int c = 0; c < 4; ++c)
          if (r < p_rows && 4 * cq + c < N)
            pv[i][c] = P[(size_t)r * p_ld + 4 * cq + c];
      }
    }
#pragma unroll 4
    for (int k = 0; k < kp; k += 4) {
      float4 w4[4];
#pragma unroll
      for (int u = 0; u < 4; ++u)
        w4[u] = load_w4<kSmemW>(W + (size_t)(k + u) * np + 4 * cq);
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        const float4 x4 = *reinterpret_cast<const float4*>(
            in + (rg + groups * i) * ld_in + k);
        const float xv[4] = {x4.x, x4.y, x4.z, x4.w};
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          acc[i][0] = fmaf(xv[u], w4[u].x, acc[i][0]);
          acc[i][1] = fmaf(xv[u], w4[u].y, acc[i][1]);
          acc[i][2] = fmaf(xv[u], w4[u].z, acc[i][2]);
          acc[i][3] = fmaf(xv[u], w4[u].w, acc[i][3]);
        }
      }
    }
    const float4 b4 = load_w4<kSmemW>(b + 4 * cq);
    const float bv[4] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      float* o = out + (rg + groups * i) * ld_out + 4 * cq;
#pragma unroll
      for (int c = 0; c < 4; ++c)
        o[c] = 4 * cq + c < N ? activate(act, acc[i][c] + bv[c] + pv[i][c])
                              : 0.f;
    }
  }
  __syncthreads();
  if (act == kSoftmax) {
    for (int r = threadIdx.x; r < groups * kRows; r += kThreads) {
      float* row = out + r * ld_out;
      float m = row[0];
      for (int c = 1; c < N; ++c) m = fmaxf(m, row[c]);
      float s = 0.f;
      for (int c = 0; c < N; ++c) {
        row[c] = expf(row[c] - m);
        s += row[c];
      }
      for (int c = 0; c < N; ++c) row[c] /= s;
    }
    __syncthreads();
  }
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

// One thread starts bulk copies (the Tensor Memory Accelerator) of
// `bytes` from global to shared memory, completing on `bar`.
__device__ __forceinline__ void bulk_load(float* dst, const float* src,
                                          unsigned bytes,
                                          unsigned long long* bar) {
  constexpr unsigned kPiece = 32768;
  const unsigned b = smem_addr(bar);
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(b)
               : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               ::"r"(b), "r"(bytes) : "memory");
  for (unsigned off = 0; off < bytes; off += kPiece) {
    const unsigned n = bytes - off < kPiece ? bytes - off : kPiece;
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
        "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst) + off),
        "l"(reinterpret_cast<const char*>(src) + off), "r"(n), "r"(b)
        : "memory");
  }
}

__device__ __forceinline__ void bulk_wait(unsigned long long* bar) {
  asm volatile(
      "{\n"
      ".reg .pred done;\n"
      "WAIT_%=:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], 0;\n"
      "@!done bra WAIT_%=;\n"
      "}\n" ::"r"(smem_addr(bar))
      : "memory");
}

// Stage B's shapes. A tile is kGroups * kRows batch rows on kThreads
// threads. kBatchDec keeps all E+1 states of the tile in shared memory and
// evaluates each decoder layer once over all of them (kDecRows rows per
// item), instead of after every encoder.
template <int kRows, int kGroups, int kThreads, bool kBatchDec>
struct Tiling {
  static constexpr int rows = kRows, groups = kGroups, threads = kThreads;
  static constexpr int tile = kRows * kGroups, dec_rows = 4;
  static constexpr bool batch_dec = kBatchDec;
};
// Latency, small batches: 16-row tiles, decoders batched.
using SmallTiles = Tiling<1, 16, 256, true>;
// Where the batched buffers do not fit: decoders after every encoder.
using SmallTilesInterleaved = Tiling<1, 16, 256, false>;
// Throughput, large batches: 128-row tiles, 2 rows per item, one block per
// SM, persistent over tiles.
using LargeTiles = Tiling<2, 64, 512, false>;

// Floats of Stage B's shared memory besides the weights: the state tiles
// (E+1 with batched decoders, else 1), two hidden buffers (as many rows),
// and the tile's validity mask.
template <class Tl>
__host__ __device__ __forceinline__ size_t tile_floats(int E, int ldS,
                                                       int ldH) {
  const size_t rows = (size_t)Tl::tile * (Tl::batch_dec ? E + 1 : 1);
  return rows * (ldS + 2 * (size_t)ldH) + round4(Tl::tile * E);
}

template <class Tl, bool kSmemW>
__global__ void __launch_bounds__(Tl::threads, 1)
    chain_kernel(const __grid_constant__ ChainArgs a) {
  extern __shared__ __align__(16) float smem[];
  __shared__ __align__(8) unsigned long long wbar;
  constexpr int T = Tl::tile, kT = Tl::threads;
  const int* p = a.plan;
  const int E = p[0], D = p[1], S = p[2];
  const int ldS = p[4], ldH = p[5], region = p[6];
  const int* enc = p + kHeader;
  const int* dec = enc + E * kEncFields;
  const int* lay = dec + D * kDecFields;
  const int B = a.batch;
  const int slots = Tl::batch_dec ? E + 1 : 1;

  // The state-path weights: bulk-copied into shared memory (the copy
  // overlaps the first tile's set-up), or read through L1/L2.
  const float* const W = kSmemW ? smem : a.weights;
  float* const states = smem + (kSmemW ? region : 0);
  if (kSmemW && threadIdx.x == 0)
    bulk_load(smem, a.weights, sizeof(float) * region, &wbar);
  float* const hb0 = states + (size_t)slots * T * ldS;
  float* const hb1 = hb0 + (size_t)slots * T * ldH;
  float* const vmask = hb1 + (size_t)slots * T * ldH;
  bool weights_ready = !kSmemW;

  const int n_tiles = (B + T - 1) / T;
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int row0 = tile * T;
    const int rows = min(T, B - row0);

    // Runs layers [first, first + n) over `groups` x kR rows from `in`;
    // returns the last output. An encoder's first layer adds P.
    auto run_layers = [&](auto rows_per_item, int first, int n,
                          const float* in, int groups,
                          const float* P) -> const float* {
      constexpr int kR = decltype(rows_per_item)::value;
      const float* prev = hb1;
      int pi = 0;
      for (int l = first; l < first + n; ++l) {
        const int* L = lay + l * kLayerFields;
        const int K = L[1], N = L[2];
        const bool from_in = L[0] == kSrcState;
        dense<kR, kT, kSmemW>(from_in ? in : prev, from_in ? ldS : ldH, K,
                              W + L[4], W + L[5], N, L[3], groups,
                              L[6] ? P : nullptr, N, rows, pi ? hb1 : hb0,
                              ldH);
        prev = pi ? hb1 : hb0;
        pi ^= 1;
      }
      return prev;
    };
    using TileRows = std::integral_constant<int, Tl::rows>;
    using DecRows = std::integral_constant<int, Tl::dec_rows>;

    auto store_state = [&](const float* st, int row_idx) {
      float* dst = a.states + ((size_t)row_idx * B + row0) * S;
      for (int t = threadIdx.x; t < rows * S; t += kT)
        dst[t] = st[(t / S) * ldS + t % S];
    };

    // Every decoder on `n_slots` consecutive state tiles from slot0.
    auto run_decoders = [&](const float* st, int slot0, int n_slots) {
      for (int d = 0; d < D; ++d) {
        const int* R = dec + d * kDecFields;
        const int C = R[2];
        const float* h;
        if constexpr (Tl::batch_dec)
          h = run_layers(DecRows(), R[0], R[1], st,
                         n_slots * T / Tl::dec_rows, nullptr);
        else
          h = run_layers(TileRows(), R[0], R[1], st, Tl::groups, nullptr);
        for (int t = threadIdx.x; t < n_slots * T * C; t += kT) {
          const int q = t / C, r = q % T;
          if (r < rows)
            a.dec_out[d][(((size_t)(slot0 + q / T)) * B + row0 + r) * C +
                         t % C] = h[q * ldH + t % C];
        }
      }
    };

    __syncthreads();   // the last tile is done; the barrier is set up
    for (int t = threadIdx.x; t < T * ldS; t += kT) {
      const int c = t % ldS;
      states[t] = c < S ? a.init[c] : 0.f;
    }
    for (int t = threadIdx.x; t < rows * E; t += kT)
      vmask[t] = a.valid[(size_t)row0 * E + t];
    if (!weights_ready) {
      bulk_wait(&wbar);
      weights_ready = true;
    }
    __syncthreads();
    if (!Tl::batch_dec) {
      store_state(states, 0);
      run_decoders(states, 0, 1);
    }

    for (int e = 0; e < E; ++e) {
      const int* R = enc + e * kEncFields;
      const int N = lay[R[0] * kLayerFields + 2];
      float* cur = states + (Tl::batch_dec ? (size_t)e * T * ldS : 0);
      float* nxt = cur + (Tl::batch_dec ? (size_t)T * ldS : 0);
      const float* h = run_layers(TileRows(), R[0], R[1], cur, Tl::groups,
                                  a.proj[e] + (size_t)row0 * N);
      for (int t = threadIdx.x; t < T * ldS; t += kT) {
        const int r = t / ldS, c = t % ldS;
        nxt[t] = c < S && r < rows && vmask[r * E + e] > 0.f
                     ? h[r * ldH + c]
                     : cur[t];
      }
      __syncthreads();
      if (!Tl::batch_dec) {
        store_state(nxt, e + 1);
        run_decoders(nxt, e + 1, 1);
      }
    }
    if (Tl::batch_dec) {
      for (int e = 0; e <= E; ++e)
        store_state(states + (size_t)e * T * ldS, e);
      run_decoders(states, 0, E + 1);
    }
  }
}

int sm_count() {
  int dev = 0, n = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess)
    return 0;
  return n;
}

int max_smem_optin() {
  int dev = 0, n = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&n, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev) != cudaSuccess)
    return 0;
  return n;
}

template <class Tl, bool kSmemW>
int launch_chain(const ChainArgs& a, size_t smem, int n_sm,
                 cudaStream_t stream) {
  auto kernel = chain_kernel<Tl, kSmemW>;
  // Set up once per device and shared-memory size, not on every call.
  static int set_device = -1;
  static size_t set_smem = 0;
  static int per_sm = 0;
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return (int)err;
  if (device != set_device || smem != set_smem) {
    if (smem > 48 * 1024) {
      err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (err != cudaSuccess) return (int)err;
    }
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        Tl::threads, smem);
    if (err != cudaSuccess) return (int)err;
    set_device = device;
    set_smem = smem;
  }
  const int tiles = (a.batch + Tl::tile - 1) / Tl::tile;
  const int grid = per_sm > 0 && tiles > per_sm * n_sm ? per_sm * n_sm
                                                       : tiles;
  chain_kernel<Tl, kSmemW><<<grid, Tl::threads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Launches Stage A on `stream`: `n_jobs` jobs (kJobFields int64 words
// each, see GemmJob) over `gemm_blocks` blocks, then `n_copies` copies
// (kCopyFields words each, see CopyJob) over `copy_blocks` more; either
// part may be empty. Returns cudaGetLastError() after launch (0 on
// success).
int mmn_chain_stage_a(const int64_t* jobs, int n_jobs, int gemm_blocks,
                      const int64_t* copies, int n_copies, int copy_blocks,
                      int batch, void* stream) {
  if (n_jobs < 0 || n_jobs > kMaxJobs || n_copies < 0 ||
      n_copies > kMaxCopies || (n_jobs > 0) != (gemm_blocks > 0) ||
      (n_copies > 0) != (copy_blocks > 0) || n_jobs + n_copies == 0 ||
      batch <= 0)
    return (int)cudaErrorInvalidValue;
  StageAArgs a;
  std::memset(&a, 0, sizeof(a));
  for (int j = 0; j < n_jobs; ++j) {
    const int64_t* q = jobs + kJobFields * j;
    GemmJob& J = a.job[j];
    J.in = reinterpret_cast<const float*>(q[0]);
    J.out = reinterpret_cast<float*>(q[1]);
    J.w = reinterpret_cast<const float*>(q[2]);
    J.bias = reinterpret_cast<const float*>(q[3]);
    J.counters = reinterpret_cast<int*>(q[4]);
    J.ld_in = (int)q[5];
    J.K = (int)q[6];
    J.N = (int)q[7];
    J.act = (int)q[8];
    J.ksplit = (int)q[9];
    J.chunks = (int)q[10];
    J.m_tiles = (int)q[11];
    J.n_tiles = (int)q[12];
    J.first_block = (int)q[13];
    J.split_stride = q[14];
    if (J.K <= 0 || J.N <= 0 || J.ksplit <= 0 || J.ksplit > kMaxSplit ||
        J.chunks <= 0 || J.m_tiles <= 0 || J.n_tiles <= 0 ||
        J.act == kSoftmax || (J.ksplit > 1 && J.counters == nullptr))
      return (int)cudaErrorInvalidValue;
  }
  for (int c = 0; c < n_copies; ++c) {
    const int64_t* q = copies + kCopyFields * c;
    CopyJob& C = a.copy[c];
    C.w = reinterpret_cast<const float*>(q[0]);
    C.b = reinterpret_cast<const float*>(q[1]);
    C.dst = reinterpret_cast<float*>(q[2]);
    C.K = (int)q[3];
    C.N = (int)q[4];
    C.first_block = (int)q[5];
    if (C.K <= 0 || C.N <= 0 || C.first_block < 0 ||
        C.first_block >= copy_blocks)
      return (int)cudaErrorInvalidValue;
  }
  a.n_jobs = n_jobs;
  a.n_copies = n_copies;
  a.gemm_blocks = gemm_blocks;
  a.batch = batch;
  stage_a_gemm<<<gemm_blocks + copy_blocks, kThreadsA, 0,
                 (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

// Row softmax in place over a (rows, n) float32 buffer on `stream`.
int mmn_chain_softmax(float* x, int rows, int n, void* stream) {
  if (rows <= 0 || n <= 0) return (int)cudaErrorInvalidValue;
  const int per_block = kThreads / kWarp;
  row_softmax<<<(rows + per_block - 1) / per_block, kThreads, 0,
                (cudaStream_t)stream>>>(x, rows, n);
  return (int)cudaGetLastError();
}

// Launches Stage B on `stream`; returns cudaGetLastError() after launch (0
// on success). Pointers are device pointers except `plan`, `proj` and
// `dec_out`, which are host arrays (of E and D device pointers for the
// last two). `weights` is the state-path region, proj[e] (B, N_e), `valid`
// (B, E), `init` (S,), `states` (E+1, B, S) and dec_out[d] (E+1, B, C_d),
// all float32 and contiguous. `large_tiles` 0 keeps the 16-row tiles at
// any batch (to time them against the 128-row ones).
int mmn_chain_stage_b(const int* plan, int plan_len,
                      const float* const* proj, const float* weights,
                      const float* valid, const float* init, float* states,
                      float* const* dec_out, int batch, int large_tiles,
                      void* stream) {
  if (plan_len < kHeader || plan_len > kMaxPlan || batch <= 0)
    return (int)cudaErrorInvalidValue;
  const int E = plan[0], D = plan[1], S = plan[2];
  const int ldS = plan[4], ldH = plan[5], region = plan[6];
  if (E < 0 || E > kMaxEnc || D < 0 || D > kMaxDec || S <= 0 ||
      ldS % 4 != 0 || ldH % 4 != 0 || region % 4 != 0)
    return (int)cudaErrorInvalidValue;
  ChainArgs a;
  std::memset(&a, 0, sizeof(a));
  std::memcpy(a.plan, plan, sizeof(int) * plan_len);
  for (int e = 0; e < E; ++e) a.proj[e] = proj[e];
  for (int d = 0; d < D; ++d) a.dec_out[d] = dec_out[d];
  a.weights = weights;
  a.valid = valid;
  a.init = init;
  a.states = states;
  a.batch = batch;
  const int n_sm = sm_count();
  const size_t max_smem = (size_t)max_smem_optin();
  if (n_sm <= 0 || max_smem == 0) return (int)cudaErrorInvalidDevice;
  const size_t w = sizeof(float) * (size_t)region;
  const size_t large = sizeof(float) * tile_floats<LargeTiles>(E, ldS, ldH);
  const size_t batched = sizeof(float) * tile_floats<SmallTiles>(E, ldS, ldH);
  const size_t small =
      sizeof(float) * tile_floats<SmallTilesInterleaved>(E, ldS, ldH);
  const cudaStream_t s = (cudaStream_t)stream;
  // Large tiles only when they alone fill the card.
  if (large_tiles &&
      (batch + LargeTiles::tile - 1) / LargeTiles::tile >= n_sm &&
      large + w <= max_smem)
    return launch_chain<LargeTiles, true>(a, large + w, n_sm, s);
  if (batched + w <= max_smem)
    return launch_chain<SmallTiles, true>(a, batched + w, n_sm, s);
  if (small + w <= max_smem)
    return launch_chain<SmallTilesInterleaved, true>(a, small + w, n_sm, s);
  if (small <= max_smem)
    return launch_chain<SmallTilesInterleaved, false>(a, small, n_sm, s);
  return (int)cudaErrorInvalidValue;
}

const char* mmn_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"

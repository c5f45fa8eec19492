// The whole MultiModN forward in CUDA stages, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel multimodn_tpu/ops/fused_chain.py::
// make_fused_chain_forward: broadcast one init-state row, run E MLP-family
// encoders (first- or last-concat, the concat split as x@Wx + s@Ws + b),
// keep each sample's old state where its modality is invalid, and evaluate
// every dense decoder after the initial state and after each encoder. Like
// the TPU kernel it takes any number of encoders and decoders and any layer
// width.
//
// What bounds it on an H100: at the MIMIC width a sample costs ~105k MACs
// against ~8.7 KB of input and output, ~24 FLOP per byte, just above the
// fp32 CUDA-core ridge (67 TFLOP/s over 3.35 TB/s, ~20 FLOP per byte): a
// large batch is bound by operations with bytes close behind, a small one
// by latency. The model splits where the work splits: 58% of the MACs and
// nearly all the bytes are the x-parts of the concat layers (and, for a
// last-concat encoder, the layers before it), which never read the state;
// the rest is a chain of small products on the state. Two shapes bound it
// otherwise. A long chain (the featurewise MIMIC model: 1,901 one-feature
// encoders, 12.97 M MACs per sample) is 1,901 dependent state products, its
// 19.4 MB of state-path weights streamed once per batch tile through L2:
// the count of dependent steps, not bytes or operations, sets its time. A
// wide one (hidden 2048: 70.6 MB of state-path weights, more than L2) is
// bound by operations at large B, and a per-tile design would read its
// weights again for every tile of rows.
//
// Design:
// - Every table lives in device memory, uploaded once per model (Stage B's
//   int32 plan, the copies) or per batch size (Stage A's jobs, one block
//   map per launch), and addresses the data, the workspace, the region and
//   the outputs by offsets, the layers' weights through one table of
//   pointers. So a call is the same few launches at any E: one Stage A
//   launch per dependent depth, one softmax row pass per depth that needs
//   one, and one Stage B launch. A model of a few modalities takes its
//   tables in the launches' parameters instead (a Stage A level of up to
//   kInlineJobs jobs, resolved into pointers on the host; a plan of up to
//   kInlinePlan ints for the tile variants): read from the constant bank,
//   they cost a small batch no dependent load from device memory and
//   Stage A no registers through its main loop, and unpacked modalities
//   are read where they lie.
// - Stage A (stage_a_gemm): every state-independent product, as a batched
//   tiled fp32 GEMM over (job, 128-row tile, 32-column tile, K split)
//   blocks, so even one request of 16 rows spreads over many SMs (61 blocks
//   at the MIMIC width). A job is a projection x@Wx (no bias) or a
//   data-only hidden layer of a last-concat encoder (bias and activation in
//   the epilogue; jobs that feed each other are separate launches, one per
//   depth; a depth with softmax hidden layers gets one row pass,
//   segment_softmax, after its GEMM). Jobs read the packed data and each
//   layer's weights where the parameter tensors hold them. The first launch
//   also runs copy blocks, which pack the state-path weights into one
//   padded region for Stage B. X and W tiles stream through shared memory
//   with cp.async (16 bytes where rows are aligned), double-buffered; each
//   thread keeps a 4-row x 4-column register tile. At small B a
//   projection's K range is split across blocks: each split writes its own
//   partial, and the last block of the output tile to take a ticket sums
//   the partials in split order, so there are no float atomics and the
//   result is deterministic.
// - Stage B (chain_kernel): one block per batch tile, persistent over tiles
//   at large B, the state tile in shared memory throughout. Where the
//   region (92 KB at MIMIC width) fits beside the tiles, one bulk copy
//   (TMA, completing on an mbarrier) brings it into shared memory while the
//   tile is set up. Small batches take 16-row tiles and keep all E+1 state
//   tiles, so each decoder layer runs once over all of them: one SM walks
//   the chain, and the count of dependent layers is what costs. Large
//   batches take 128-row tiles on 512 threads (2 rows per item), one block
//   per SM, with the decoders after every encoder. An output item is a few
//   rows x 4 columns read with 16-byte loads.
// - The long chain (ring variant): the region does not fit, so each
//   encoder's block of it (its state-path layers, 11 KB at the featurewise
//   shape), the tile's rows of its Stage A projection and its plan records
//   come through a ring of up to 4 shared-memory stages by bulk copies on
//   one mbarrier each, started by one producer thread that a small layer
//   leaves idle; up to three encoders are in flight while a step runs, so
//   the 19.4 MB reach the SM from L2 behind the dependent products and a
//   step reads nothing from device memory. The step's last layer selects
//   the state in its epilogue. The validity mask comes 32 encoders at a
//   time. The decoders run every `chunk` encoders (up to 32; 16 at the
//   featurewise shape, as many state tiles as fit beside the ring) over
//   the new state tiles at once (their weights through L1), so they add
//   parallel work, not dependent steps, to the chain; decoding in chunks
//   instead of off the chain in a launch of its own keeps the launch count
//   independent of E.
// - Past the widths the 16-row tiles hold (layered variant): every layer
//   is one tiled GEMM over the whole batch (Stage A's tile code, each
//   weight tile read once per 128 rows), the activations in a device
//   scratch buffer, the card kept in step by a grid barrier in a
//   cooperative launch; an encoder's last layer selects the state in its
//   epilogue, and the decoders run over all (E+1)B rows at the end. Tiles
//   of 8 or 4 rows would fit the activations in shared memory at hidden
//   2048, but would read the 70.6 MB of weights once per 8 or 4 rows (36
//   GB at B = 4096).
// - The ragged last tile is masked in every stage, so the caller pads
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
// Tiled fp32 GEMM (Stage A and the layered variant)
// ---------------------------------------------------------------------------

constexpr int kBM = 128, kBN = 32, kBK = 32;
constexpr int kThreadsA = 256;                     // a GEMM block
constexpr int kRowsA = kBM / (kThreadsA / (kBN / 4));  // rows per thread
constexpr int kXld = kBK + 4;   // keeps 16-byte rows, spreads banks
constexpr int kMaxSplit = 32;
// Job layout; multimodn_tpu_torch/ops/fused_chain.py::ChainSpec.stage_a_plan
// writes it as int64 words: input source (0 data, 1 workspace), input
// offset, output offset, first partial's offset, layer, ticket (-1 none),
// input row stride, K, N, activation, bias (0/1), ksplit, chunks per split,
// m tiles, n tiles, first block, split stride.
constexpr int kJobFields = 17;
// Copy layout, int64 words: layer, first row, K, N, region offset, first
// copy block. A copy block writes kCopySpan floats of one layer's padded
// matrix and bias.
constexpr int kCopyFields = 6;
constexpr int kCopySpan = 4096;

struct GemmSmem {
  float xs[2][kBM][kXld];
  float ws[2][kBK][kBN];
};

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

// acc += in[m0:m0+128, k] @ w[k, n0:n0+32] over K chunks [c0, c1) of kBK,
// rows below M, columns below N; w's rows are ld_w apart. kCoherent keeps
// the input out of L1 (the layered variant reads what other blocks of the
// same launch wrote). Ends synchronised.
template <bool kCoherent>
__device__ __forceinline__ void gemm_tile(const float* in, int ld_in, int K,
                                          int M, const float* w, int ld_w,
                                          int N, int m0, int n0, int c0,
                                          int c1, GemmSmem& sm,
                                          float (&acc)[kRowsA][4]) {
  const int tx = threadIdx.x % (kBN / 4), ty = threadIdx.x / (kBN / 4);
  // X rows load 16 bytes at a time where every row start is 16-byte
  // aligned (K and the row stride multiples of 4), else 4 bytes.
  const bool vec = (ld_in % 4 == 0) && (K % 4 == 0) &&
                   (reinterpret_cast<size_t>(in) % 16 == 0);
  auto load = [&](int c, int buf) {
    const int k0 = c * kBK;
    if (vec) {
#pragma unroll
      for (int q = 0; q < kBM * kBK / (4 * kThreadsA); ++q) {
        const int e = threadIdx.x + kThreadsA * q;
        const int r = e / (kBK / 4), kk = 4 * (e % (kBK / 4));
        const bool valid = m0 + r < M && k0 + kk < K;
        cp_async16z(&sm.xs[buf][r][kk],
                    valid ? in + (size_t)(m0 + r) * ld_in + k0 + kk : in,
                    valid);
      }
    } else {
#pragma unroll
      for (int q = 0; q < kBM * kBK / kThreadsA; ++q) {
        const int e = threadIdx.x + kThreadsA * q;
        const int r = e / kBK, kk = e % kBK;
        const bool valid = m0 + r < M && k0 + kk < K;
        const float* src = in + (size_t)(m0 + r) * ld_in + k0 + kk;
        if (kCoherent)
          sm.xs[buf][r][kk] = valid ? __ldcg(src) : 0.f;
        else
          cp_async4(&sm.xs[buf][r][kk], valid ? src : in, valid);
      }
    }
#pragma unroll
    for (int q = 0; q < kBK * kBN / kThreadsA; ++q) {
      const int e = threadIdx.x + kThreadsA * q;
      const int kr = e / kBN, n = e % kBN;
      const bool valid = k0 + kr < K && n0 + n < N;
      cp_async4(&sm.ws[buf][kr][n],
                valid ? w + (size_t)(k0 + kr) * ld_w + n0 + n : w, valid);
    }
    cp_async_commit();
  };

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
        x4[i] = *reinterpret_cast<const float4*>(
            &sm.xs[buf][ty + (kBM / kRowsA) * i][kk]);
#pragma unroll
      for (int u = 0; u < 4; ++u)
        w4[u] = *reinterpret_cast<const float4*>(&sm.ws[buf][kk + u][4 * tx]);
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
}

__device__ __forceinline__ void zero_acc(float (&acc)[kRowsA][4]) {
#pragma unroll
  for (int i = 0; i < kRowsA; ++i)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[i][c] = 0.f;
}

// ---------------------------------------------------------------------------
// Stage A: state-independent products
// ---------------------------------------------------------------------------

struct StageAArgs {
  const long long* jobs;       // this level's job rows
  const int* job_map;          // GEMM block -> job row
  const long long* copies;     // copy rows (first launch only)
  const int* copy_map;         // copy block -> copy row
  const long long* layers;     // w and b device pointers per dense layer
  const float* data;           // the packed modalities
  float* ws;                   // workspace: projections, outputs, partials
  int* tickets;
  float* region;               // the packed state-path region
  int gemm_blocks, batch;
};

__device__ __forceinline__ void copy_block(const StageAArgs& a, int local) {
  const long long* q = a.copies + kCopyFields * a.copy_map[local];
  const int layer = (int)q[0], row0 = (int)q[1], K = (int)q[2],
            N = (int)q[3];
  const float* w = reinterpret_cast<const float*>(a.layers[2 * layer]) +
                   (size_t)row0 * N;
  const float* b = reinterpret_cast<const float*>(a.layers[2 * layer + 1]);
  float* dst = a.region + q[4];
  const int kp = round4(K), np = round4(N);
  const int d0 = (local - (int)q[5]) * kCopySpan;
  const int d1 = min(d0 + kCopySpan, kp * np + np);
  for (int d = d0 + threadIdx.x; d < d1; d += kThreadsA) {
    float v;
    if (d < kp * np) {
      const int r = d / np, col = d % np;
      v = r < K && col < N ? w[(size_t)r * N + col] : 0.f;
    } else {
      const int col = d - kp * np;
      v = col < N ? b[col] : 0.f;
    }
    dst[d] = v;
  }
}

// One Stage A block of a job: output tile (mt, nt), K split ks of ksplit,
// from `local`, the block's index within the job. The first split writes
// `out`, split s > 0 the partial at partials + (s - 1) * stride; where K is
// split, the last block of the output tile to take its ticket sums the
// partials in split order into `out`, whichever block it is.
__device__ __forceinline__ void stage_a_block(
    const float* in, int ld_in, int K, const float* w, int N,
    const float* bias, int act, float* out0, const float* partials,
    long long stride, int* tickets, int ksplit, int chunks, int n_tiles,
    int local, int B, GemmSmem& sm) {
  const int ks = local % ksplit;
  local /= ksplit;
  const int nt = local % n_tiles, mt = local / n_tiles;
  const int m0 = mt * kBM, n0 = nt * kBN;
  const int c0 = ks * chunks;
  const int c1 = min(c0 + chunks, (K + kBK - 1) / kBK);
  const int tx = threadIdx.x % (kBN / 4), ty = threadIdx.x / (kBN / 4);

  float acc[kRowsA][4];
  zero_acc(acc);
  gemm_tile<false>(in, ld_in, K, B, w, N, N, m0, n0, c0, c1, sm, acc);

  float* out = ks == 0 ? out0
                       : const_cast<float*>(partials) + (ks - 1) * stride;
#pragma unroll
  for (int i = 0; i < kRowsA; ++i) {
    const int row = m0 + ty + (kBM / kRowsA) * i;
    if (row >= B) continue;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int col = n0 + 4 * tx + c;
      if (col >= N) continue;
      float v = acc[i][c];
      if (bias != nullptr) v = activate(act, v + bias[col]);
      out[(size_t)row * N + col] = v;
    }
  }
  if (ksplit == 1) return;

  __shared__ bool last;
  __threadfence();
  __syncthreads();
  int* const ticket = tickets + mt * n_tiles + nt;
  if (threadIdx.x == 0) last = atomicAdd(ticket, 1) == ksplit - 1;
  __syncthreads();
  if (!last) return;
  if (threadIdx.x == 0) *ticket = 0;   // every block has taken its ticket
  __threadfence();
  const int rows = min(kBM, B - m0), cols = min(kBN, N - n0);
  for (int e = threadIdx.x; e < rows * cols; e += kThreadsA) {
    const size_t at = (size_t)(m0 + e / cols) * N + n0 + e % cols;
    float part[kMaxSplit];
    part[0] = __ldcg(out0 + at);
#pragma unroll
    for (int s = 1; s < kMaxSplit; ++s)
      part[s] = s < ksplit ? __ldcg(partials + (s - 1) * stride + at) : 0.f;
    float v = part[0];
#pragma unroll
    for (int s = 1; s < kMaxSplit; ++s)
      if (s < ksplit) v += part[s];
    out0[at] = v;
  }
}

// The table form: a level of any number of jobs, each block's job row read
// from device memory.
__global__ void __launch_bounds__(kThreadsA, 2)
    stage_a_gemm(const __grid_constant__ StageAArgs a) {
  if ((int)blockIdx.x >= a.gemm_blocks) {
    copy_block(a, blockIdx.x - a.gemm_blocks);
    return;
  }
  __shared__ __align__(16) GemmSmem sm;
  const long long* q = a.jobs + kJobFields * a.job_map[blockIdx.x];
  const int layer = (int)q[4];
  stage_a_block(
      (q[0] == 0 ? a.data : a.ws) + q[1], (int)q[6], (int)q[7],
      reinterpret_cast<const float*>(a.layers[2 * layer]), (int)q[8],
      q[10] ? reinterpret_cast<const float*>(a.layers[2 * layer + 1])
            : nullptr,
      (int)q[9], a.ws + q[2], a.ws + q[3], q[16],
      q[5] >= 0 ? a.tickets + q[5] : nullptr, (int)q[11], (int)q[12],
      (int)q[14], blockIdx.x - (int)q[15], a.batch, sm);
}

// The inline form, for a level of at most kInlineJobs jobs (every level of
// a model of a few modalities): the host resolves each job row into
// pointers and puts them in the kernel's parameters, so a block finds its
// job and reads its fields from the constant bank, with no dependent load
// from device memory before its first tile. Both forms are held to 128
// registers (two blocks per SM); they spill a few words (88 and 184 bytes
// by ptxas). On the card that is faster than the earlier single-body form
// at 101 registers where K is split (B = 16 and 1024), and slower by 4%
// at B = 65536 (PERF.md).
struct InlineJob {
  const float* in;
  float* out;
  const float* partials;
  const float* w;
  const float* bias;   // nullptr: a projection (no bias, no activation)
  int* tickets;        // nullptr: K not split
  long long stride;
  int ld_in, K, N, act, ksplit, chunks, n_tiles, first_block;
};
constexpr int kInlineJobs = 32;
struct StageAInline {
  StageAArgs t;   // the copies, the batch, the GEMM block count
  InlineJob job[kInlineJobs];
  int n_jobs;
};
static_assert(sizeof(StageAInline) <= 4096, "kernel parameters exceed 4 KB");

__global__ void __launch_bounds__(kThreadsA, 2)
    stage_a_gemm_inline(const __grid_constant__ StageAInline a) {
  if ((int)blockIdx.x >= a.t.gemm_blocks) {
    copy_block(a.t, blockIdx.x - a.t.gemm_blocks);
    return;
  }
  __shared__ __align__(16) GemmSmem sm;
  int j = 0;
  for (int i = 1; i < a.n_jobs; ++i)
    if (a.job[i].first_block <= (int)blockIdx.x) j = i;
  const InlineJob& J = a.job[j];
  stage_a_block(J.in, J.ld_in, J.K, J.w, J.N, J.bias, J.act, J.out,
                J.partials, J.stride, J.tickets, J.ksplit, J.chunks,
                J.n_tiles, blockIdx.x - J.first_block, a.t.batch, sm);
}

// Row softmax in place over segments of the workspace: segment s is (rows,
// n) floats at offset segs[2s] with n = segs[2s + 1]; one warp per row.
__global__ void __launch_bounds__(kThreads)
    segment_softmax(const long long* segs, float* ws, int n_segs, int rows) {
  const long long g =
      (long long)blockIdx.x * (kThreads / kWarp) + threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  if (g >= (long long)n_segs * rows) return;   // whole warps leave together
  const int s = (int)(g / rows), row = (int)(g % rows);
  const int n = (int)segs[2 * s + 1];
  float* r = ws + segs[2 * s] + (size_t)row * n;
  float m = __int_as_float(0xff800000);   // -inf
  for (int c = lane; c < n; c += kWarp) m = fmaxf(m, r[c]);
  for (int off = kWarp / 2; off > 0; off /= 2)
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
  float sum = 0.f;
  for (int c = lane; c < n; c += kWarp) {
    const float e = expf(r[c] - m);
    r[c] = e;
    sum += e;
  }
  for (int off = kWarp / 2; off > 0; off /= 2)
    sum += __shfl_xor_sync(0xffffffffu, sum, off);
  for (int c = lane; c < n; c += kWarp) r[c] /= sum;
}

// ---------------------------------------------------------------------------
// Stage B: the state chain
// ---------------------------------------------------------------------------

// Plan layout; multimodn_tpu_torch/ops/fused_chain.py::ChainSpec writes it.
//   header: E, D, S, n_layers, state row stride, hidden row stride,
//           state-path region length, largest encoder block, widest
//           projection (both floats, multiples of 4), largest encoder
//           record with its layer records (ints, a multiple of 4)
//   E encoder records: first layer, n_layers, projection column, block
//                      offset and length in the region, projection width
//   D decoder records: first layer, n_layers, n_classes, class column
//   layer records: source, K, N, activation, w offset, bias offset,
//                  adds the encoder's Stage A projection (0/1)
// Weights are (K rounded up to 4, N rounded up to 4) row-major with zero
// pads, biases N rounded up to 4, offsets from the region's start (Stage
// A's copy blocks write it). Encoder e's projection is (B, N) at
// proj + B * column; decoder d's output (E+1, B, C) at dec_out + (E+1) * B *
// column.
constexpr int kHeader = 10;
constexpr int kEncFields = 6;
constexpr int kDecFields = 4;
constexpr int kLayerFields = 7;
constexpr int kVChunk = 32;     // validity columns a tile holds at a time
constexpr int kMaxStages = 4;   // ring stages
constexpr int kPTile = 16;      // rows of a ring stage's projection tile
constexpr int kInlinePlan = 768;  // plan ints the parameters carry
enum Source { kSrcPrev = 1, kSrcState = 2 };
// Stage B's variants; ChainSpec.stage_b_config picks one.
enum StageBVariant {
  kLarge = 0, kBatched, kInterleaved, kInterleavedL2, kRing, kLayered
};
// Where a tile's state-path weights live.
enum WeightHome { kWSmem = 0, kWRing, kWGlobal };

struct ChainArgs {
  const int* plan;              // the device plan, header included
  const int* ring_recs;         // per encoder: its record and its layers'
                                // records, rec_max ints (the ring's copy)
  const float* proj;            // Stage A's projections
  const float* weights;         // the state-path region
  const float* valid;
  const float* init;
  float* states;
  float* dec_out;
  float* scratch;               // layered: two activation buffers
  unsigned* barrier;            // layered: arrival count, generation
  long long scratch_half;
  int batch, E, D, S, ldS, ldH, region, chunk, stages, blk_max, proj_max,
      rec_max;
  int plan_in_smem;             // ints of the plan staged in shared memory
  // A plan of at most kInlinePlan ints rides here too, for the tile
  // variants' inline form: read from the constant bank, as fast as a
  // register operand and with no load before the first step.
  int iplan[kInlinePlan];
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
// 0. kSelect (not for softmax): row r keeps keep[r * ld_out + col] unless
// r < p_rows and sel[r * sel_ld] > 0, the state select fused. Ends
// synchronised.
template <int kRows, int kThreads, bool kSmemW, bool kSelect = false>
__device__ __forceinline__ void dense(const float* in, int ld_in, int K,
                                      const float* W, const float* b, int N,
                                      int act, int groups, const float* P,
                                      int p_ld, int p_rows, float* out,
                                      int ld_out,
                                      const float* sel = nullptr,
                                      int sel_ld = 0,
                                      const float* keep = nullptr) {
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
      const int r = rg + groups * i;
      float* o = out + r * ld_out + 4 * cq;
      if (kSelect && !(r < p_rows && sel[r * sel_ld] > 0.f)) {
#pragma unroll
        for (int c = 0; c < 4; ++c) o[c] = keep[r * ld_out + 4 * cq + c];
        continue;
      }
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

// Bulk copies (the Tensor Memory Accelerator) from global to shared memory,
// completing on an mbarrier: one thread inits the barriers once, arms a
// barrier with the bytes it expects, then starts the copies (16-byte
// aligned, sizes multiples of 16); every thread waits on the barrier's
// phase parity.
__device__ __forceinline__ void mbar_init(unsigned long long* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}

__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void bulk_expect(unsigned long long* bar,
                                            unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               ::"r"(smem_addr(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void bulk_arm(unsigned long long* bar,
                                         unsigned bytes) {
  // The stage's earlier contents were read through the generic proxy.
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  bulk_expect(bar, bytes);
}


__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          unsigned bytes,
                                          unsigned long long* bar) {
  constexpr unsigned kPiece = 32768;
  for (unsigned off = 0; off < bytes; off += kPiece) {
    const unsigned n = bytes - off < kPiece ? bytes - off : kPiece;
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
        "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst) + off),
        "l"(reinterpret_cast<const char*>(src) + off), "r"(n),
        "r"(smem_addr(bar))
        : "memory");
  }
}

__device__ __forceinline__ void bulk_wait(unsigned long long* bar,
                                          unsigned parity) {
  asm volatile(
      "{\n"
      ".reg .pred done;\n"
      "WAIT_%=:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT_%=;\n"
      "}\n" ::"r"(smem_addr(bar)), "r"(parity)
      : "memory");
}

// Stage B's shapes. A tile is kGroups * kRows batch rows on kThreads
// threads. kBatchDec keeps up to chunk + 1 state tiles in shared memory
// and evaluates each decoder layer once over a chunk of them (kDecRows rows
// per item), instead of after every encoder.
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

template <class Tl, int kW>
__global__ void __launch_bounds__(Tl::threads, 1)
    chain_kernel(const __grid_constant__ ChainArgs a) {
  extern __shared__ __align__(16) float smem[];
  __shared__ __align__(8) unsigned long long bars[kMaxStages];
  constexpr int T = Tl::tile, kT = Tl::threads;
  const int E = a.E, D = a.D, S = a.S, ldS = a.ldS, ldH = a.ldH;
  const int B = a.batch;
  const int chunk = Tl::batch_dec ? a.chunk : 1;
  const int slots = Tl::batch_dec ? chunk + 1 : 1;
  const int vc = min(E, kVChunk);
  const int stages = a.stages;
  const int stage_floats = a.blk_max + kPTile * a.proj_max + a.rec_max;
  // The ring's producer: the last thread, which a small layer leaves idle.
  constexpr int kProducer = kT - 1;

  // The state-path weights: bulk-copied whole into shared memory (the copy
  // overlaps the first tile's set-up), streamed one encoder block at a
  // time through the ring, or read through L1/L2.
  float* const ring = smem;
  const size_t pre = kW == kWSmem   ? (size_t)a.region
                     : kW == kWRing ? (size_t)stages * stage_floats
                                    : 0;
  float* const states = smem + pre;
  float* const hb0 = states + (size_t)slots * T * ldS;
  float* const hb1 = hb0 + (size_t)slots * T * ldH;
  float* const vmask = hb1 + (size_t)slots * T * ldH;
  if (threadIdx.x == 0) {
    if (kW == kWSmem) {
      mbar_init(&bars[0]);
      mbar_init_fence();
      bulk_arm(&bars[0], sizeof(float) * a.region);
      bulk_copy(smem, a.weights, sizeof(float) * a.region, &bars[0]);
    } else if (kW == kWRing) {
      for (int s = 0; s < stages; ++s) mbar_init(&bars[s]);
      mbar_init_fence();
    }
  }
  // A plan that fits after the tiles is staged there, so no step waits on
  // device memory for its records (read after the tile loop's first
  // barrier).
  int* const splan = reinterpret_cast<int*>(vmask + round4(T * vc));
  for (int i = threadIdx.x; i < a.plan_in_smem; i += kT) splan[i] = a.plan[i];
  const int* enc = (a.plan_in_smem > 0 ? splan : a.plan) + kHeader;
  const int* dec = enc + E * kEncFields;
  const int* lay = dec + D * kDecFields;
  bool weights_ready = kW != kWSmem;
  int loads = 0;   // ring loads of the tiles before this one
  int rec[kEncFields];   // the producer's next encoder record

  const int n_tiles = (B + T - 1) / T;
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int row0 = tile * T;
    const int rows = min(T, B - row0);

    // Runs the n layers whose records start at `recs` over `groups` x kR
    // rows from `in`, weights at W (in shared memory if kS); returns the
    // last output. An encoder's first layer adds P. With `to`, the last
    // layer (if not softmax) writes the selected state there (the select
    // fused, against `in`, by the tile's validity column `sel`); the
    // return value is then `to`.
    auto run_layers = [&](auto rows_per_item, auto smem_w, const float* W,
                          const int* recs, int n, const float* in,
                          int groups, const float* P, int p_ld,
                          float* to = nullptr,
                          const float* sel = nullptr) -> const float* {
      constexpr int kR = decltype(rows_per_item)::value;
      constexpr bool kS = decltype(smem_w)::value;
      const float* prev = hb1;
      int pi = 0;
      for (int l = 0; l < n; ++l) {
        const int* L = recs + l * kLayerFields;
        const int K = L[1], N = L[2];
        const bool from_in = L[0] == kSrcState;
        const bool fuse = kW == kWRing && to != nullptr && l == n - 1 &&
                          L[3] != kSoftmax;
        float* out = fuse ? to : pi ? hb1 : hb0;
        if constexpr (kW == kWRing) {
          if (fuse) {
            dense<kR, kT, kS, true>(from_in ? in : prev,
                                    from_in ? ldS : ldH, K, W + L[4],
                                    W + L[5], N, L[3], groups,
                                    L[6] ? P : nullptr, p_ld, rows, out, ldS,
                                    sel, vc, in);
            prev = out;
            continue;
          }
        }
        dense<kR, kT, kS>(from_in ? in : prev, from_in ? ldS : ldH, K,
                          W + L[4], W + L[5], N, L[3], groups,
                          L[6] ? P : nullptr, p_ld, rows, out, ldH);
        prev = out;
        pi ^= 1;
      }
      return prev;
    };
    using TileRows = std::integral_constant<int, Tl::rows>;
    using DecRows = std::integral_constant<int, Tl::dec_rows>;
    using EncInSmem = std::integral_constant<bool, kW != kWGlobal>;
    using DecInSmem = std::integral_constant<bool, kW == kWSmem>;
    const float* const w_dec = kW == kWSmem ? smem : a.weights;

    auto store_state = [&](const float* st, int row_idx) {
      float* dst = a.states + ((size_t)row_idx * B + row0) * S;
      for (int t = threadIdx.x; t < rows * S; t += kT)
        dst[t] = st[(t / S) * ldS + t % S];
    };

    // Every decoder on `n_slots` consecutive state tiles from `st`, the
    // first of them state row_idx0.
    auto run_decoders = [&](const float* st, int row_idx0, int n_slots) {
      for (int d = 0; d < D; ++d) {
        const int* R = dec + d * kDecFields;
        const int C = R[2];
        float* out = a.dec_out + (size_t)(E + 1) * B * R[3];
        const float* h;
        const int* recs = lay + R[0] * kLayerFields;
        if constexpr (Tl::batch_dec)
          h = run_layers(DecRows(), DecInSmem(), w_dec, recs, R[1], st,
                         n_slots * T / Tl::dec_rows, nullptr, 0);
        else
          h = run_layers(TileRows(), DecInSmem(), w_dec, recs, R[1], st,
                         Tl::groups, nullptr, 0);
        for (int t = threadIdx.x; t < n_slots * T * C; t += kT) {
          const int q = t / C, r = q % T;
          if (r < rows)
            out[(((size_t)(row_idx0 + q / T)) * B + row0 + r) * C + t % C] =
                h[q * ldH + t % C];
        }
        __syncthreads();   // the next layer rewrites h
      }
    };

    // The producer starts encoder e's block of the region, its projection's
    // rows of this tile and its records (its own and its layers') into ring
    // stage `idx` mod stages, so a step reads nothing of the plan from
    // device memory; `rec`, encoder e's record, was loaded a step ahead,
    // and the next encoder's is loaded now.
    auto ring_issue = [&](int e, int idx) {
      const int N = rec[5];
      float* dst = ring + (size_t)(idx % stages) * stage_floats;
      const unsigned w_bytes = sizeof(float) * rec[4];
      const unsigned p_bytes = sizeof(float) * round4(rows * N);
      const unsigned r_bytes = sizeof(int) * a.rec_max;
      unsigned long long* bar = &bars[idx % stages];
      bulk_arm(bar, w_bytes + p_bytes + r_bytes);
      bulk_copy(dst, a.weights + rec[3], w_bytes, bar);
      bulk_copy(dst + a.blk_max,
                a.proj + (size_t)B * rec[2] + (size_t)row0 * N, p_bytes, bar);
      bulk_copy(dst + a.blk_max + kPTile * a.proj_max,
                a.ring_recs + (size_t)e * a.rec_max, r_bytes, bar);
      if (e + 1 < E) {
#pragma unroll
        for (int f = 0; f < kEncFields; ++f)
          rec[f] = enc[(e + 1) * kEncFields + f];
      }
    };

    auto fill_vmask = [&](int e0) {
      for (int t = threadIdx.x; t < T * vc; t += kT) {
        const int r = t / vc, c = t % vc;
        vmask[t] = r < rows && e0 + c < E
                       ? a.valid[(size_t)(row0 + r) * E + e0 + c]
                       : 0.f;
      }
    };

    __syncthreads();   // the last tile is done; the barriers are set up
    // The ring keeps stages - 1 encoders ahead of the step: at step e the
    // producer refills the stage that step e - 1 read.
    if (kW == kWRing && threadIdx.x == kProducer) {
#pragma unroll
      for (int f = 0; f < kEncFields; ++f) rec[f] = enc[f];
      for (int i = 0; i < min(stages - 1, E); ++i) ring_issue(i, loads + i);
    }
    for (int t = threadIdx.x; t < T * ldS; t += kT) {
      const int c = t % ldS;
      states[t] = c < S ? a.init[c] : 0.f;
    }
    fill_vmask(0);
    if (!weights_ready) {
      bulk_wait(&bars[0], 0);
      weights_ready = true;
    }
    __syncthreads();
    store_state(states, 0);
    if (!Tl::batch_dec || E == 0) run_decoders(states, 0, 1);

    int j = 0;                  // the current state's slot
    bool first_chunk = true;    // slot 0 holds the undecoded initial state
    for (int e = 0; e < E; ++e) {
      if (e > 0 && e % vc == 0) fill_vmask(e);   // read after the layers
      if (kW == kWRing && threadIdx.x == kProducer && e + stages - 1 < E)
        ring_issue(e + stages - 1, loads + e + stages - 1);
      const int* R = enc + e * kEncFields;
      const float* W = kW == kWSmem ? smem : a.weights;
      const float* P = nullptr;
      if (kW == kWRing) {
        const int idx = loads + e;
        bulk_wait(&bars[idx % stages], (unsigned)(idx / stages) & 1u);
        float* stage = ring + (size_t)(idx % stages) * stage_floats;
        R = reinterpret_cast<const int*>(stage + a.blk_max +
                                         kPTile * a.proj_max);
        W = stage - R[3];
        P = stage + a.blk_max;
      }
      const int N = R[5];
      if (kW != kWRing) P = a.proj + (size_t)B * R[2] + (size_t)row0 * N;
      const int* recs =
          kW == kWRing ? R + kEncFields : lay + R[0] * kLayerFields;
      float* cur = states + (Tl::batch_dec ? (size_t)j * T * ldS : 0);
      float* nxt = cur + (Tl::batch_dec ? (size_t)T * ldS : 0);
      // The ring's step selects the state in its last layer's epilogue
      // (nxt is a slot of its own); the others in a pass after it.
      const float* h = run_layers(
          TileRows(), EncInSmem(), W, recs, R[1], cur, Tl::groups, P, N,
          kW == kWRing ? nxt : nullptr, vmask + e % vc);
      if (h != nxt) {
        for (int t = threadIdx.x; t < T * ldS; t += kT) {
          const int r = t / ldS, c = t % ldS;
          nxt[t] = c < S && r < rows && vmask[r * vc + e % vc] > 0.f
                       ? h[r * ldH + c]
                       : cur[t];
        }
        __syncthreads();
      }
      store_state(nxt, e + 1);
      if (!Tl::batch_dec) {
        run_decoders(nxt, e + 1, 1);
      } else if (++j == chunk || e == E - 1) {
        const int from = first_chunk ? 0 : 1;
        run_decoders(states + (size_t)from * T * ldS, e + 1 - j + from,
                     j + 1 - from);
        if (e < E - 1) {
          for (int t = threadIdx.x; t < T * ldS; t += kT)
            states[t] = states[(size_t)j * T * ldS + t];
          __syncthreads();
        }
        j = 0;
        first_chunk = false;
      }
    }
    loads += E;
  }
}

// The tile variants with the region in shared memory, for a plan that rides
// in the parameters (at most kInlinePlan ints, E <= kVChunk): the chain of
// chain_kernel without the ring's and the long chain's machinery, every
// record read from the constant bank, the validity mask loaded whole, and
// where the decoders are batched the states stored after the chain. Kept
// apart because that machinery, compiled into one kernel, made these
// shapes' Stage B 15-50% slower on the card (PERF.md).
template <class Tl>
__global__ void __launch_bounds__(Tl::threads, 1)
    chain_kernel_small(const __grid_constant__ ChainArgs a) {
  extern __shared__ __align__(16) float smem[];
  __shared__ __align__(8) unsigned long long wbar;
  constexpr int T = Tl::tile, kT = Tl::threads;
  const int* p = a.iplan;
  const int E = p[0], D = p[1], S = p[2];
  const int ldS = p[4], ldH = p[5], region = p[6];
  const int* enc = p + kHeader;
  const int* dec = enc + E * kEncFields;
  const int* lay = dec + D * kDecFields;
  const int B = a.batch;
  const int slots = Tl::batch_dec ? E + 1 : 1;

  // The state-path weights, bulk-copied into shared memory; the copy
  // overlaps the first tile's set-up.
  const float* const W = smem;
  float* const states = smem + region;
  if (threadIdx.x == 0) {
    mbar_init(&wbar);
    mbar_init_fence();
    bulk_expect(&wbar, sizeof(float) * region);
    bulk_copy(smem, a.weights, sizeof(float) * region, &wbar);
  }
  float* const hb0 = states + (size_t)slots * T * ldS;
  float* const hb1 = hb0 + (size_t)slots * T * ldH;
  float* const vmask = hb1 + (size_t)slots * T * ldH;
  bool weights_ready = false;

  const int n_tiles = (B + T - 1) / T;
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int row0 = tile * T;
    const int rows = min(T, B - row0);

    // Runs layers [first, first + n) over `groups` x kR rows from `in`;
    // returns the last output. An encoder's first layer adds P.
    auto run_layers = [&](auto rows_per_item, int first, int n,
                          const float* in, int groups, const float* P,
                          int p_ld) -> const float* {
      constexpr int kR = decltype(rows_per_item)::value;
      const float* prev = hb1;
      int pi = 0;
      for (int l = first; l < first + n; ++l) {
        const int* L = lay + l * kLayerFields;
        const int K = L[1], N = L[2];
        const bool from_in = L[0] == kSrcState;
        dense<kR, kT, true>(from_in ? in : prev, from_in ? ldS : ldH, K,
                            W + L[4], W + L[5], N, L[3], groups,
                            L[6] ? P : nullptr, p_ld, rows, pi ? hb1 : hb0,
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
        float* out = a.dec_out + (size_t)(E + 1) * B * R[3];
        const float* h;
        if constexpr (Tl::batch_dec)
          h = run_layers(DecRows(), R[0], R[1], st,
                         n_slots * T / Tl::dec_rows, nullptr, 0);
        else
          h = run_layers(TileRows(), R[0], R[1], st, Tl::groups, nullptr,
                         0);
        for (int t = threadIdx.x; t < n_slots * T * C; t += kT) {
          const int q = t / C, r = q % T;
          if (r < rows)
            out[(((size_t)(slot0 + q / T)) * B + row0 + r) * C + t % C] =
                h[q * ldH + t % C];
        }
        if (d + 1 < D) __syncthreads();   // the next decoder rewrites h
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
      bulk_wait(&wbar, 0);
      weights_ready = true;
    }
    __syncthreads();
    if (!Tl::batch_dec) {
      store_state(states, 0);
      run_decoders(states, 0, 1);
    }

    for (int e = 0; e < E; ++e) {
      const int* R = enc + e * kEncFields;
      const int N = R[5];
      float* cur = states + (Tl::batch_dec ? (size_t)e * T * ldS : 0);
      float* nxt = cur + (Tl::batch_dec ? (size_t)T * ldS : 0);
      if (!Tl::batch_dec) __syncthreads();   // the decoders read h
      const float* h = run_layers(
          TileRows(), R[0], R[1], cur, Tl::groups,
          a.proj + (size_t)B * R[2] + (size_t)row0 * N, N);
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

// ---------------------------------------------------------------------------
// The layered variant: every layer one GEMM over the whole batch
// ---------------------------------------------------------------------------

__device__ __forceinline__ unsigned ld_volatile(const unsigned* p) {
  return *reinterpret_cast<const volatile unsigned*>(p);
}

// All blocks of a cooperative launch meet here; the writes of every block
// before it are visible to every block after it. bar[0] counts arrivals
// (0 between barriers), bar[1] is the generation, read by thread 0 at the
// kernel's start into gen.
__device__ __forceinline__ void grid_sync(unsigned* bar, unsigned& gen) {
  __syncthreads();
  if (threadIdx.x == 0) {
    const unsigned target = gen + 1;
    __threadfence();
    if (atomicAdd(bar, 1u) == gridDim.x - 1) {
      atomicExch(bar, 0u);
      __threadfence();
      atomicExch(bar + 1, target);
    } else {
      while (ld_volatile(bar + 1) != target) __nanosleep(64);
    }
    __threadfence();
    gen = target;
  }
  __syncthreads();
}

// out[0:M, 0:N] = act(in @ W + b [+ P]), tiles of kBM x kBN over the grid;
// with `sel`, a row whose valid[row * E] is 0 keeps prev[row * S + col]
// instead (the state select). W is region-packed: rows round4(N) apart.
// softmax writes the logits (a row pass follows).
__device__ void layer_gemm(const float* in, int ld_in, int K, int M,
                           const float* W, const float* bias, int N, int act,
                           const float* P, const float* sel, int E,
                           const float* prev, int S, float* out, int ld_out,
                           GemmSmem& sm) {
  const int m_tiles = (M + kBM - 1) / kBM, n_tiles = (N + kBN - 1) / kBN;
  const int chunks = (K + kBK - 1) / kBK;
  const int tx = threadIdx.x % (kBN / 4), ty = threadIdx.x / (kBN / 4);
  for (int t = blockIdx.x; t < m_tiles * n_tiles; t += gridDim.x) {
    const int m0 = (t / n_tiles) * kBM, n0 = (t % n_tiles) * kBN;
    float acc[kRowsA][4];
    zero_acc(acc);
    gemm_tile<true>(in, ld_in, K, M, W, round4(N), N, m0, n0, 0, chunks, sm,
                    acc);
#pragma unroll
    for (int i = 0; i < kRowsA; ++i) {
      const int row = m0 + ty + (kBM / kRowsA) * i;
      if (row >= M) continue;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int col = n0 + 4 * tx + c;
        if (col >= N) continue;
        float v = acc[i][c] + bias[col];
        if (P != nullptr) v += __ldcg(P + (size_t)row * N + col);
        if (act != kSoftmax) v = activate(act, v);
        if (sel != nullptr && !(sel[(size_t)row * E] > 0.f))
          v = __ldcg(prev + (size_t)row * S + col);
        out[(size_t)row * ld_out + col] = v;
      }
    }
  }
}

// Row softmax of x (M, N) into out (rows ld_out apart; out may be x), one
// warp per row over the grid, with the state select as in layer_gemm.
__device__ void rows_softmax(const float* x, int M, int N, float* out,
                             int ld_out, const float* sel, int E,
                             const float* prev, int S) {
  const int warps = gridDim.x * (kThreadsA / kWarp);
  const int lane = threadIdx.x % kWarp;
  for (int row = blockIdx.x * (kThreadsA / kWarp) + threadIdx.x / kWarp;
       row < M; row += warps) {
    const float* r = x + (size_t)row * N;
    float m = __int_as_float(0xff800000);   // -inf
    for (int c = lane; c < N; c += kWarp) m = fmaxf(m, __ldcg(r + c));
    for (int off = kWarp / 2; off > 0; off /= 2)
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
    float s = 0.f;
    for (int c = lane; c < N; c += kWarp) s += expf(__ldcg(r + c) - m);
    for (int off = kWarp / 2; off > 0; off /= 2)
      s += __shfl_xor_sync(0xffffffffu, s, off);
    const bool keep = sel != nullptr && !(sel[(size_t)row * E] > 0.f);
    __syncwarp();
    for (int c = lane; c < N; c += kWarp)
      out[(size_t)row * ld_out + c] =
          keep ? __ldcg(prev + (size_t)row * S + c)
               : expf(__ldcg(r + c) - m) / s;
  }
}

__global__ void __launch_bounds__(kThreadsA)
    layered_kernel(const __grid_constant__ ChainArgs a) {
  __shared__ __align__(16) GemmSmem sm;
  unsigned gen = 0;
  if (threadIdx.x == 0) gen = ld_volatile(a.barrier + 1);
  const int E = a.E, D = a.D, S = a.S, B = a.batch;
  const int* enc = a.plan + kHeader;
  const int* dec = enc + E * kEncFields;
  const int* lay = dec + D * kDecFields;
  const float* W = a.weights;
  float* const hid[2] = {a.scratch, a.scratch + a.scratch_half};
  const size_t BS = (size_t)B * S;
  for (size_t i = (size_t)blockIdx.x * kThreadsA + threadIdx.x; i < BS;
       i += (size_t)gridDim.x * kThreadsA)
    a.states[i] = a.init[i % S];
  grid_sync(a.barrier, gen);

  // Layers [first, first + n) over M rows from `in` (rows S apart); the
  // last writes `out` (rows ld_out apart), selecting against `prev` where
  // sel is given.
  auto run = [&](int first, int n, int M, const float* in, const float* P,
                 float* out, int ld_out, const float* sel,
                 const float* prev) {
    const float* h = nullptr;
    int pi = 0;
    for (int l = first; l < first + n; ++l) {
      const int* L = lay + l * kLayerFields;
      const int K = L[1], N = L[2], act = L[3];
      const bool last = l == first + n - 1;
      const bool from_in = L[0] == kSrcState;
      float* dst = last && act != kSoftmax ? out : hid[pi];
      layer_gemm(from_in ? in : h, from_in ? S : K, K, M, W + L[4], W + L[5],
                 N, act, L[6] ? P : nullptr, last ? sel : nullptr, E, prev,
                 S, dst, dst == out ? ld_out : N, sm);
      grid_sync(a.barrier, gen);
      if (act == kSoftmax) {
        float* to = last ? out : dst;
        rows_softmax(dst, M, N, to, last ? ld_out : N, last ? sel : nullptr,
                     E, prev, S);
        grid_sync(a.barrier, gen);
        dst = to;
      }
      h = dst;
      pi ^= 1;
    }
  };

  for (int e = 0; e < E; ++e) {
    const int* R = enc + e * kEncFields;
    const float* st = a.states + (size_t)e * BS;
    run(R[0], R[1], B, st, a.proj + (size_t)B * R[2], a.states + BS + e * BS,
        S, a.valid + e, st);
  }
  const int M = (E + 1) * B;
  for (int d = 0; d < D; ++d) {
    const int* R = dec + d * kDecFields;
    run(R[0], R[1], M, a.states, nullptr,
        a.dec_out + (size_t)M * R[3], R[2], nullptr, nullptr);
  }
}

int device_attribute(cudaDeviceAttr attr) {
  int dev = 0, n = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&n, attr, dev) != cudaSuccess)
    return 0;
  return n;
}

template <class Tl, int kW, bool kSmall = false>
int launch_chain(const ChainArgs& a, size_t smem, int n_sm,
                 cudaStream_t stream) {
  auto kernel = [] {
    if constexpr (kSmall) return chain_kernel_small<Tl>;
    else return chain_kernel<Tl, kW>;
  }();
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
  kernel<<<grid, Tl::threads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

int launch_layered(const ChainArgs& a, int n_sm, cudaStream_t stream) {
  static int set_device = -1;
  static int per_sm = 0;
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return (int)err;
  if (device != set_device) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, layered_kernel, kThreadsA, 0);
    if (err != cudaSuccess) return (int)err;
    if (per_sm <= 0) return (int)cudaErrorInvalidConfiguration;
    set_device = device;
  }
  // Two blocks per SM at most: the barrier's cost grows with the grid.
  const int grid = (per_sm < 2 ? per_sm : 2) * n_sm;
  ChainArgs args = a;
  void* params[] = {&args};
  err = cudaLaunchCooperativeKernel((const void*)layered_kernel, grid,
                                    kThreadsA, params, 0, stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Launches one level of Stage A on `stream`: `gemm_blocks` GEMM blocks, each
// running the job row (kJobFields int64 words) that job_map names, then
// `copy_blocks` copy blocks over the copy rows (kCopyFields words) that
// copy_map names; either part may be empty. Every table and pointer is on
// the device, except where `host_jobs` gives the level's `n_jobs` rows on
// the host with `host_layers`, the host copy of `layers`: a level of at
// most kInlineJobs jobs then runs in the inline form, its rows resolved
// here. There `job_in`, where given, holds per job a device pointer to its
// input (a modality of (B, K) floats, rows K apart) or 0 for the row's own
// source, so unpacked modalities need no packing copy. Returns
// cudaGetLastError() after launch (0 on success).
int mmn_chain_stage_a(const long long* jobs, const int* job_map,
                      int gemm_blocks, const long long* copies,
                      const int* copy_map, int copy_blocks,
                      const long long* layers, const float* data,
                      float* ws, int* tickets, float* region,
                      int batch, void* stream, const long long* host_jobs,
                      int n_jobs, const long long* host_layers,
                      const long long* job_in) {
  const bool inline_jobs = host_jobs != nullptr && gemm_blocks > 0;
  if (gemm_blocks < 0 || copy_blocks < 0 || gemm_blocks + copy_blocks == 0 ||
      (gemm_blocks > 0 && !inline_jobs &&
       (jobs == nullptr || job_map == nullptr || job_in != nullptr)) ||
      (inline_jobs && (n_jobs < 1 || n_jobs > kInlineJobs ||
                       host_layers == nullptr)) ||
      (copy_blocks > 0 && (copies == nullptr || copy_map == nullptr)) ||
      layers == nullptr || batch <= 0)
    return (int)cudaErrorInvalidValue;
  StageAArgs a;
  std::memset(&a, 0, sizeof(a));
  a.jobs = jobs;
  a.job_map = job_map;
  a.copies = copies;
  a.copy_map = copy_map;
  a.layers = layers;
  a.data = data;
  a.ws = ws;
  a.tickets = tickets;
  a.region = region;
  a.gemm_blocks = gemm_blocks;
  a.batch = batch;
  const cudaStream_t s = (cudaStream_t)stream;
  if (!inline_jobs) {
    stage_a_gemm<<<gemm_blocks + copy_blocks, kThreadsA, 0, s>>>(a);
    return (int)cudaGetLastError();
  }
  StageAInline b;
  std::memset(&b, 0, sizeof(b));
  b.t = a;
  b.n_jobs = n_jobs;
  for (int i = 0; i < n_jobs; ++i) {
    const long long* q = host_jobs + (size_t)kJobFields * i;
    InlineJob& J = b.job[i];
    const long long in = job_in != nullptr ? job_in[i] : 0;
    if (in != 0) {
      J.in = reinterpret_cast<const float*>(in);
      J.ld_in = (int)q[7];
    } else {
      if (q[0] == 0 && data == nullptr) return (int)cudaErrorInvalidValue;
      J.in = (q[0] == 0 ? data : ws) + q[1];
      J.ld_in = (int)q[6];
    }
    J.out = ws + q[2];
    J.partials = ws + q[3];
    J.w = reinterpret_cast<const float*>(host_layers[2 * q[4]]);
    J.bias = q[10] ? reinterpret_cast<const float*>(host_layers[2 * q[4] + 1])
                   : nullptr;
    J.tickets = q[5] >= 0 ? tickets + q[5] : nullptr;
    J.stride = q[16];
    J.K = (int)q[7];
    J.N = (int)q[8];
    J.act = (int)q[9];
    J.ksplit = (int)q[11];
    J.chunks = (int)q[12];
    J.n_tiles = (int)q[14];
    J.first_block = (int)q[15];
  }
  stage_a_gemm_inline<<<gemm_blocks + copy_blocks, kThreadsA, 0, s>>>(b);
  return (int)cudaGetLastError();
}

// Row softmax in place over `n_segs` workspace segments of `rows` rows
// (segs: int64 offset and width per segment, on the device) on `stream`.
int mmn_chain_softmax(const long long* segs, float* ws, int n_segs, int rows,
                      void* stream) {
  if (segs == nullptr || n_segs <= 0 || rows <= 0)
    return (int)cudaErrorInvalidValue;
  const long long warps = (long long)n_segs * rows;
  const int per_block = kThreads / kWarp;
  segment_softmax<<<(unsigned)((warps + per_block - 1) / per_block),
                    kThreads, 0, (cudaStream_t)stream>>>(segs, ws, n_segs,
                                                         rows);
  return (int)cudaGetLastError();
}

// Launches Stage B on `stream` as `variant` (StageBVariant) with `smem`
// bytes of dynamic shared memory, `chunk` state tiles between decoder
// passes and `stages` ring stages; returns cudaGetLastError() after launch
// (0 on success). `host_plan` is the plan's host copy (its header is read
// here), `plan` the device copy, `ring_recs` the ring's per-encoder
// records (ChainSpec.ring_records); every other pointer is on the device:
// `proj` Stage A's projections, `weights` the state-path region, `valid`
// (B, E), `init` (S,), `states` (E+1, B, S), `dec_out` every decoder's
// (E+1, B, C_d), all float32 and contiguous; the layered variant's
// `scratch` (2 x scratch_half floats) and `barrier` (2 words, the first
// 0).
int mmn_chain_stage_b(const int* host_plan, const int* plan,
                      const int* ring_recs, const float* proj,
                      const float* weights,
                      const float* valid, const float* init, float* states,
                      float* dec_out, float* scratch, long long scratch_half,
                      unsigned* barrier, int batch, int variant, int smem,
                      int chunk, int stages, void* stream) {
  if (host_plan == nullptr || plan == nullptr || batch <= 0)
    return (int)cudaErrorInvalidValue;
  ChainArgs a;
  std::memset(&a, 0, sizeof(a));
  a.E = host_plan[0];
  a.D = host_plan[1];
  a.S = host_plan[2];
  a.ldS = host_plan[4];
  a.ldH = host_plan[5];
  a.region = host_plan[6];
  a.blk_max = host_plan[7];
  a.proj_max = host_plan[8];
  a.rec_max = host_plan[9];
  if (a.E < 0 || a.D < 0 || a.S <= 0 || a.ldS % 4 != 0 || a.ldH % 4 != 0 ||
      a.region % 4 != 0 || a.blk_max % 4 != 0 || a.proj_max % 4 != 0 ||
      a.rec_max % 4 != 0 || smem < 0 || chunk < 1)
    return (int)cudaErrorInvalidValue;
  a.plan = plan;
  a.ring_recs = ring_recs;
  a.proj = proj;
  a.weights = weights;
  a.valid = valid;
  a.init = init;
  a.states = states;
  a.dec_out = dec_out;
  a.scratch = scratch;
  a.scratch_half = scratch_half;
  a.barrier = barrier;
  a.batch = batch;
  a.chunk = chunk;
  a.stages = stages;
  const int n_sm = device_attribute(cudaDevAttrMultiProcessorCount);
  const int max_smem =
      device_attribute(cudaDevAttrMaxSharedMemoryPerBlockOptin);
  if (n_sm <= 0 || max_smem <= 0) return (int)cudaErrorInvalidDevice;
  if (smem > max_smem) return (int)cudaErrorInvalidValue;
  // The tile variants with the region in shared memory take a small plan
  // in their parameters (chain_kernel_small); the others stage the plan
  // after their tiles where it fits.
  const int plan_len = kHeader + a.E * kEncFields + a.D * kDecFields +
                       host_plan[3] * kLayerFields;
  const bool inl = variant <= kInterleaved && plan_len <= kInlinePlan &&
                   a.E <= kVChunk;
  if (inl) {
    std::memcpy(a.iplan, host_plan, sizeof(int) * plan_len);
  } else if (variant <= kInterleavedL2 &&
             smem + (int)sizeof(int) * round4(plan_len) <= max_smem) {
    a.plan_in_smem = plan_len;
    smem += (int)sizeof(int) * round4(plan_len);
  }
  const cudaStream_t s = (cudaStream_t)stream;
  switch (variant) {
    case kLarge:
      return inl ? launch_chain<LargeTiles, kWSmem, true>(a, smem, n_sm, s)
                 : launch_chain<LargeTiles, kWSmem>(a, smem, n_sm, s);
    case kBatched:
      if (chunk != (a.E > 0 ? a.E : 1)) return (int)cudaErrorInvalidValue;
      return inl ? launch_chain<SmallTiles, kWSmem, true>(a, smem, n_sm, s)
                 : launch_chain<SmallTiles, kWSmem>(a, smem, n_sm, s);
    case kInterleaved:
      return inl ? launch_chain<SmallTilesInterleaved, kWSmem, true>(
                       a, smem, n_sm, s)
                 : launch_chain<SmallTilesInterleaved, kWSmem>(a, smem,
                                                              n_sm, s);
    case kInterleavedL2:
      return launch_chain<SmallTilesInterleaved, kWGlobal>(a, smem, n_sm, s);
    case kRing:
      if (stages < 2 || stages > kMaxStages || a.E < 1 ||
          ring_recs == nullptr)
        return (int)cudaErrorInvalidValue;
      return launch_chain<SmallTiles, kWRing>(a, smem, n_sm, s);
    case kLayered:
      if (scratch == nullptr || barrier == nullptr || scratch_half <= 0)
        return (int)cudaErrorInvalidValue;
      return launch_layered(a, n_sm, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// Shared memory a block of the current device may opt in to (bytes).
int mmn_chain_max_smem() {
  return device_attribute(cudaDevAttrMaxSharedMemoryPerBlockOptin);
}

const char* mmn_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"

// The whole MultiModN forward in one CUDA kernel, for Hopper (sm_90a).
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
// by launch latency. The weights (~335 KB fp32 at MIMIC width) do not fit in
// one block's 227 KB of shared memory, unlike the TPU kernel's VMEM-resident
// weights; here they are read through L1/L2 (they stay resident in the
// 50 MB L2), once per 32-row batch tile: ~10 KB of L2 traffic per sample,
// against the ~8.7 KB each sample must move to and from device memory.
//
// Design (simple and correct first; wgmma/TMA come later):
// - one block of 256 threads per tile of 32 batch rows; the ragged last tile
//   is masked, so the caller pads nothing;
// - the state tile and the hidden activations live in shared memory
//   (ping-pong buffers); layer inputs are staged in 32-wide K chunks with
//   coalesced loads;
// - each thread owns one output column and 4 rows of a layer, fp32 FMA;
// - the model arrives as a small int32 plan (per-layer source, dims,
//   activation and weight offsets) plus one flat weight buffer, so one
//   build serves every MLP-family model.
#include <cuda_runtime.h>

#include <cstddef>
#include <cstring>

namespace {

constexpr int kTile = 32;                          // batch rows per block
constexpr int kRowGroups = 8;                      // row groups per column
constexpr int kRowsPerThread = kTile / kRowGroups;
constexpr int kChunk = 32;                         // staged K chunk
constexpr int kThreads = 256;
constexpr int kMaxPlan = 768;
constexpr int kMaxEnc = 32;
constexpr int kMaxDec = 32;

// Plan layout; multimodn_tpu_torch/ops/fused_chain.py::ChainSpec writes it.
//   header: E, D, S, n_layers, hidden buffer width, n_weights
//   E encoder records: first layer, n_layers, data width
//   D decoder records: first layer, n_layers, n_classes
//   layer records: source, K, N, activation, w offset, w_state offset
//                  (-1: no state part), bias offset
constexpr int kHeader = 6;
constexpr int kEncFields = 3;
constexpr int kDecFields = 3;
constexpr int kLayerFields = 7;
enum Source { kSrcData = 0, kSrcPrev = 1, kSrcState = 2 };
enum Activation { kIdentity = 0, kRelu, kSigmoid, kTanh, kGelu, kSoftmax };

struct ChainArgs {
  int plan[kMaxPlan];
  const float* data[kMaxEnc];
  float* dec_out[kMaxDec];
  const float* weights;
  const float* valid;
  const float* init;
  float* states;
  int batch;
};

__device__ __forceinline__ float activate(int act, float v) {
  switch (act) {
    case kRelu: return v < 0.f ? 0.f : v;  // NaN passes, as torch.relu
    case kSigmoid: return 1.f / (1.f + expf(-v));
    case kTanh: return tanhf(v);
    case kGelu: {  // tanh form, as jax.nn.gelu
      const float c = 0.7978845608028654f;  // sqrt(2 / pi)
      return 0.5f * v * (1.f + tanhf(c * (v + 0.044715f * v * v * v)));
    }
    default: return v;  // identity; softmax is a row pass in dense()
  }
}

// acc[i] += xs[g + kRowGroups * i, 0:kc] . W[0:kc, j] for one staged chunk.
// Full chunks unroll completely, so the chunk's weight loads are all in
// flight at once instead of one L2 round trip per k.
template <int kUnroll>
__device__ __forceinline__ void fma_chunk(const float* xs,
                                          const float* __restrict__ wp, int N,
                                          int kc, int g,
                                          float (&acc)[kRowsPerThread]) {
#pragma unroll kUnroll
  for (int c = 0; c < kc; ++c) {
    const float w = __ldg(wp + (size_t)c * N);
#pragma unroll
    for (int i = 0; i < kRowsPerThread; ++i)
      acc[i] = fmaf(xs[(g + kRowGroups * i) * (kChunk + 1) + c], w, acc[i]);
  }
}

// acc[i] += in[g + kRowGroups * i, 0:K] . W[0:K, j]; `in` is global or
// shared memory with row stride ld, rows past `rows` read as zero.
// Every thread of the block must call it (it synchronises).
__device__ void accumulate(const float* in, int ld, int K, int rows,
                           const float* __restrict__ W, int N, int j, int g,
                           bool active, float (&acc)[kRowsPerThread],
                           float* xs) {
  for (int k0 = 0; k0 < K; k0 += kChunk) {
    const int kc = min(kChunk, K - k0);
    __syncthreads();  // earlier readers of xs are done
    for (int t = threadIdx.x; t < kTile * kChunk; t += blockDim.x) {
      const int r = t / kChunk, c = t % kChunk;
      xs[r * (kChunk + 1) + c] =
          (r < rows && c < kc) ? in[(size_t)r * ld + k0 + c] : 0.f;
    }
    __syncthreads();
    if (active) {
      const float* wp = W + (size_t)k0 * N + j;
      if (kc == kChunk)
        fma_chunk<kChunk>(xs, wp, N, kChunk, g, acc);
      else
        fma_chunk<1>(xs, wp, N, kc, g, acc);
    }
  }
}

// out[0:kTile, 0:N] = act(in @ W (+ st @ Ws) + b). Ends synchronised.
__device__ void dense(const float* in, int in_ld, int K, int rows,
                      const float* st, int st_ld, int S,
                      const float* W, const float* Ws, const float* b,
                      int N, int act, float* out, int out_ld, float* xs) {
  const int items = N * kRowGroups;
  for (int base = 0; base < items; base += blockDim.x) {
    const int w = base + threadIdx.x;
    const bool active = w < items;
    const int j = active ? w % N : 0;
    const int g = active ? w / N : 0;
    float acc[kRowsPerThread];
#pragma unroll
    for (int i = 0; i < kRowsPerThread; ++i) acc[i] = 0.f;
    accumulate(in, in_ld, K, rows, W, N, j, g, active, acc, xs);
    if (Ws != nullptr)
      accumulate(st, st_ld, S, kTile, Ws, N, j, g, active, acc, xs);
    if (active) {
      const float bj = __ldg(b + j);
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i)
        out[(g + kRowGroups * i) * out_ld + j] = activate(act, acc[i] + bj);
    }
  }
  __syncthreads();
  if (act == kSoftmax) {
    for (int r = threadIdx.x; r < kTile; r += blockDim.x) {
      float* row = out + r * out_ld;
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

__global__ void __launch_bounds__(kThreads)
    fused_chain_kernel(const __grid_constant__ ChainArgs a) {
  extern __shared__ float smem[];
  const int* p = a.plan;
  const int E = p[0], D = p[1], S = p[2], H = p[4];
  const int B = a.batch;
  const int row0 = blockIdx.x * kTile;
  const int rows = min(kTile, B - row0);
  const int sld = S + 1, hld = H + 1;
  float* state = smem;
  float* hb[2] = {state + kTile * sld, state + kTile * sld + kTile * hld};
  float* xs = hb[1] + kTile * hld;
  const int* enc = p + kHeader;
  const int* dec = enc + E * kEncFields;
  const int* lay = dec + D * kDecFields;
  const float* wts = a.weights;

  // Runs layers [first, first + n) from `src_data` (width F) or the state
  // tile; returns the buffer holding the last layer's output.
  auto run_layers = [&](int first, int n, const float* src_data,
                        int F) -> const float* {
    const float* prev = nullptr;
    int pi = 0;
    for (int l = first; l < first + n; ++l) {
      const int* L = lay + l * kLayerFields;
      const int src = L[0], K = L[1], N = L[2], act = L[3];
      const float* in;
      int ld, in_rows;
      if (src == kSrcData) {
        in = src_data; ld = F; in_rows = rows;
      } else if (src == kSrcPrev) {
        in = prev; ld = hld; in_rows = kTile;
      } else {
        in = state; ld = sld; in_rows = kTile;
      }
      float* out = hb[pi];
      dense(in, ld, K, in_rows, state, sld, S, wts + L[4],
            L[5] >= 0 ? wts + L[5] : nullptr, wts + L[6], N, act, out, hld,
            xs);
      prev = out;
      pi ^= 1;
    }
    return prev;
  };

  auto store_state = [&](int row_idx) {
    float* dst = a.states + ((size_t)row_idx * B + row0) * S;
    for (int t = threadIdx.x; t < rows * S; t += blockDim.x)
      dst[t] = state[(t / S) * sld + t % S];
  };

  auto run_decoders = [&](int row_idx) {
    for (int d = 0; d < D; ++d) {
      const int* R = dec + d * kDecFields;
      const int C = R[2];
      const float* h = run_layers(R[0], R[1], nullptr, 0);
      float* dst = a.dec_out[d] + ((size_t)row_idx * B + row0) * C;
      for (int t = threadIdx.x; t < rows * C; t += blockDim.x)
        dst[t] = h[(t / C) * hld + t % C];
    }
  };

  for (int t = threadIdx.x; t < kTile * S; t += blockDim.x)
    state[(t / S) * sld + t % S] = a.init[t % S];
  __syncthreads();
  store_state(0);
  run_decoders(0);

  for (int e = 0; e < E; ++e) {
    const int* R = enc + e * kEncFields;
    const int F = R[2];
    const float* h =
        run_layers(R[0], R[1], a.data[e] + (size_t)row0 * F, F);
    for (int t = threadIdx.x; t < rows * S; t += blockDim.x) {
      const int r = t / S;
      if (a.valid[(size_t)(row0 + r) * E + e] > 0.f)
        state[r * sld + t % S] = h[r * hld + t % S];
    }
    __syncthreads();
    store_state(e + 1);
    run_decoders(e + 1);
  }
}

}  // namespace

extern "C" {

// Launches the kernel on `stream`; returns cudaGetLastError() after launch
// (0 on success). Pointers are device pointers except `plan`, `data` and
// `dec_out`, which are host arrays (of E and D device pointers for the
// latter two). `valid` is (B, E), `init` (S,), `states` (E+1, B, S) and
// dec_out[d] (E+1, B, C_d), all float32 and contiguous.
int mmn_fused_chain_forward(const int* plan, int plan_len,
                            const float* weights, const float* const* data,
                            const float* valid, const float* init,
                            float* states, float* const* dec_out, int batch,
                            void* stream) {
  if (plan_len < kHeader || plan_len > kMaxPlan || batch <= 0)
    return (int)cudaErrorInvalidValue;
  const int E = plan[0], D = plan[1], S = plan[2], H = plan[4];
  if (E < 0 || E > kMaxEnc || D < 0 || D > kMaxDec || S <= 0 || H <= 0)
    return (int)cudaErrorInvalidValue;
  ChainArgs a;
  std::memset(&a, 0, sizeof(a));
  std::memcpy(a.plan, plan, sizeof(int) * plan_len);
  for (int e = 0; e < E; ++e) a.data[e] = data[e];
  for (int d = 0; d < D; ++d) a.dec_out[d] = dec_out[d];
  a.weights = weights;
  a.valid = valid;
  a.init = init;
  a.states = states;
  a.batch = batch;
  const size_t smem =
      sizeof(float) *
      ((size_t)kTile * (S + 1) + 2 * (size_t)kTile * (H + 1) +
       (size_t)kTile * (kChunk + 1));
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        fused_chain_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid((batch + kTile - 1) / kTile);
  fused_chain_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

const char* mmn_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"

// CTC alpha and beta recursions over the blank-interleaved label lattice,
// for Hopper (sm_90a), CUDA C++.
//
// Replaces: pytorch_asr_tpu/ops/ctc_pallas.py::ctc_loss_pallas, its two
// kernels _fwd_kernel (alpha) and _bwd_kernel (beta -> state posteriors).
// Python side: ops/ctc_cuda.py; plain version: ops/ctc.py.
//
// Inputs are the lattice log-probabilities logp_tbs (T, B, S) fp32, already
// gathered and masked to NEG_INF beyond each row's lattice, and per-row
// masks as bytes.  Log-softmax, the gather, beta_T, the S -> V scatter and
// the gradient assembly stay in PyTorch, as they stay in XLA on the TPU.
//
//   ctc_alpha:  alpha_0[s] = logp[0, s] for s < 2, else NEG_INF;
//               alpha_t[s] = max(lse(alpha[s], alpha[s-1], skip[s] ? alpha[s-2]
//                            : NEG_INF), NEG_INF) + logp[t, s]   for t < len,
//               alpha_t = alpha_{t-1} for t >= len;  writes every alpha_t
//               (T, B, S) and the final row (B, S).
//   ctc_beta:   beta walks t = T-1 .. 0: at t == len-1 it is beta_T, before
//               it lse(term[s], term[s+1], skip_from[s] ? term[s+2] : NEG_INF)
//               with term = beta + logp[t+1]; writes the posteriors
//               w[t, b, s] = exp(max(alpha + beta - logz, NEG_INF)) for t < len,
//               0 elsewhere.  Infeasible rows come in with len = 0.
// Every log-sum-exp clamps its max and its result at NEG_INF = -1e30, as the
// reference does, so the exp of a sentinel is exactly 0.
//
// Bound on this card: bytes (T*B*S fp32 in and out, a few MB at the training
// shapes, against ~15 fp32 operations a lattice cell).  In practice the
// recursion is bound by latency: T serial steps of one barrier each.
//
// Design, first and simple: one block per utterance (the TPU grid carried
// the (B, S) alpha across sequential time chunks in VMEM scratch; GPU blocks
// carry nothing, so the time loop lives inside the block).  Each thread owns
// the lattice states s = tid + i * blockDim (i < kMaxPerThread) and keeps
// their alpha or beta in registers; neighbours s-1, s-2 (s+1, s+2) are read
// from a double-buffered shared row, so each step needs one barrier.

#include <cuda_runtime.h>

namespace {

constexpr float NEG_INF = -1.0e30f;
constexpr int kMaxPerThread = 4;  // S <= 4096: 32 KB of shared rows

__device__ __forceinline__ float lse3(float a, float b, float c) {
  const float m = fmaxf(fmaxf(fmaxf(a, b), c), NEG_INF);
  const float tot = m + logf(expf(a - m) + expf(b - m) + expf(c - m));
  return fmaxf(tot, NEG_INF);
}

__global__ void __launch_bounds__(1024) ctc_alpha_kernel(
    const float* __restrict__ logp, const unsigned char* __restrict__ skip,
    const int* __restrict__ lens, float* __restrict__ alphas,
    float* __restrict__ final_alpha, int T, int B, int S) {
  extern __shared__ float row[];  // (2, S): double-buffered alpha row
  const int b = blockIdx.x;
  const int len = lens[b];
  float a[kMaxPerThread];
  bool sk[kMaxPerThread];
#pragma unroll
  for (int i = 0; i < kMaxPerThread; ++i) {
    const int s = threadIdx.x + i * blockDim.x;
    a[i] = NEG_INF;
    sk[i] = false;
    if (s < S) {
      sk[i] = skip[(size_t)b * S + s] != 0 && s >= 2;
      if (s < 2) a[i] = logp[(size_t)b * S + s];
      alphas[(size_t)b * S + s] = a[i];
    }
  }
  for (int t = 1; t < T; ++t) {
    float* cur = row + (t & 1) * S;
#pragma unroll
    for (int i = 0; i < kMaxPerThread; ++i) {
      const int s = threadIdx.x + i * blockDim.x;
      if (s < S) cur[s] = a[i];
    }
    __syncthreads();
    const size_t base = ((size_t)t * B + b) * S;
#pragma unroll
    for (int i = 0; i < kMaxPerThread; ++i) {
      const int s = threadIdx.x + i * blockDim.x;
      if (s >= S) continue;
      if (t < len) {
        const float s1 = s >= 1 ? cur[s - 1] : NEG_INF;
        const float s2 = sk[i] ? cur[s - 2] : NEG_INF;
        a[i] = lse3(a[i], s1, s2) + logp[base + s];
      }
      alphas[base + s] = a[i];
    }
  }
#pragma unroll
  for (int i = 0; i < kMaxPerThread; ++i) {
    const int s = threadIdx.x + i * blockDim.x;
    if (s < S) final_alpha[(size_t)b * S + s] = a[i];
  }
}

__global__ void __launch_bounds__(1024) ctc_beta_kernel(
    const float* __restrict__ logp, const float* __restrict__ alphas,
    const unsigned char* __restrict__ skip_from, const float* __restrict__ beta_T,
    const int* __restrict__ lens, const float* __restrict__ logz,
    float* __restrict__ w, int T, int B, int S) {
  extern __shared__ float row[];  // (2, S): double-buffered beta + logp row
  const int b = blockIdx.x;
  const int len = lens[b];
  const float lz = logz[b];
  float beta[kMaxPerThread], lp_next[kMaxPerThread], bT[kMaxPerThread];
  bool sk[kMaxPerThread];
#pragma unroll
  for (int i = 0; i < kMaxPerThread; ++i) {
    const int s = threadIdx.x + i * blockDim.x;
    beta[i] = NEG_INF;
    lp_next[i] = NEG_INF;
    bT[i] = NEG_INF;
    sk[i] = false;
    if (s < S) {
      bT[i] = beta_T[(size_t)b * S + s];
      sk[i] = skip_from[(size_t)b * S + s] != 0 && s + 2 < S;
    }
  }
  for (int t = T - 1; t >= 0; --t) {
    float* cur = row + (t & 1) * S;
#pragma unroll
    for (int i = 0; i < kMaxPerThread; ++i) {
      const int s = threadIdx.x + i * blockDim.x;
      if (s < S) cur[s] = beta[i] + lp_next[i];
    }
    __syncthreads();
    const size_t base = ((size_t)t * B + b) * S;
#pragma unroll
    for (int i = 0; i < kMaxPerThread; ++i) {
      const int s = threadIdx.x + i * blockDim.x;
      if (s >= S) continue;
      if (t == len - 1) {
        beta[i] = bT[i];
      } else if (t < len - 1) {
        const float s1 = s + 1 < S ? cur[s + 1] : NEG_INF;
        const float s2 = sk[i] ? cur[s + 2] : NEG_INF;
        beta[i] = lse3(cur[s], s1, s2);
      }
      w[base + s] = t < len ? expf(fmaxf(alphas[base + s] + beta[i] - lz, NEG_INF)) : 0.f;
      lp_next[i] = logp[base + s];
    }
  }
}

int threads_for(int S) {
  const int t = (S + 31) / 32 * 32;
  return t > 1024 ? 1024 : t;
}

}  // namespace

// logp_tbs, alphas: (T, B, S) fp32; skip: (B, S) bytes; lens: (B) int32;
// final_alpha: (B, S).  S <= 4096 = 1024 * kMaxPerThread (the wrapper checks).
extern "C" int ctc_alpha(const float* logp_tbs, const unsigned char* skip, const int* lens,
                         float* alphas, float* final_alpha, int T, int B, int S,
                         void* stream) {
  if (T == 0 || B == 0 || S == 0) return 0;
  const int threads = threads_for(S);
  ctc_alpha_kernel<<<B, threads, 2 * S * sizeof(float), (cudaStream_t)stream>>>(
      logp_tbs, skip, lens, alphas, final_alpha, T, B, S);
  return cudaGetLastError();
}

// skip_from, beta_T: (B, S); lens: (B) int32, 0 for infeasible rows;
// logz: (B) fp32; w: (T, B, S) fp32.
extern "C" int ctc_beta(const float* logp_tbs, const float* alphas,
                        const unsigned char* skip_from, const float* beta_T,
                        const int* lens, const float* logz, float* w, int T, int B,
                        int S, void* stream) {
  if (T == 0 || B == 0 || S == 0) return 0;
  const int threads = threads_for(S);
  ctc_beta_kernel<<<B, threads, 2 * S * sizeof(float), (cudaStream_t)stream>>>(
      logp_tbs, alphas, skip_from, beta_T, lens, logz, w, T, B, S);
  return cudaGetLastError();
}

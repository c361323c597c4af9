// CTC alpha and beta recursions over the blank-interleaved label lattice,
// for Hopper (sm_90a), CUDA C++.
//
// Replaces: pytorch_asr_tpu/ops/ctc_pallas.py::ctc_loss_pallas, its two
// kernels _fwd_kernel (alpha) and _bwd_kernel (beta -> state posteriors),
// and the alpha kernel it runs instead when PAIRED_FWD is set,
// _fwd_kernel_paired :139 (ctc_alpha_paired below).
// Python side: ops/ctc_cuda.py; plain versions: ops/ctc.py.
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
//
// ctc_alpha_paired: the same alphas two frames an iteration, so one barrier
// covers two frames.  Two steps composed are one 5-term log-sum-exp over
// alpha[s-0..4] with weights W_0..W_4 built from frame t's emissions only
// (off the alpha chain; ops/ctc.py::alphas_paired_plain writes them out),
// plus frame t+1's emission.  The single step a1 is still computed: it is
// stored at t, and it is the output of a row whose length ends mid-pair.
// The pair at t = 0 applies the second step to alpha_0.  Each thread reads
// its states' emissions and their s-1, s-2 neighbours from device memory;
// only the alpha row goes through shared memory.  Twice K4's forward work a
// frame and half its barriers: the JAX study asked whether the recursion is
// bound by its chain's latency or by its throughput.

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

__device__ __forceinline__ float lse2(float a, float b) {  // torch/jnp logaddexp
  const float m = fmaxf(a, b);
  return m + log1pf(expf(-fabsf(a - b)));
}

__device__ __forceinline__ float lse5(float a, float b, float c, float d, float e) {
  const float m = fmaxf(fmaxf(fmaxf(fmaxf(a, b), fmaxf(c, d)), e), NEG_INF);
  const float tot =
      m + logf(expf(a - m) + expf(b - m) + expf(c - m) + expf(d - m) + expf(e - m));
  return fmaxf(tot, NEG_INF);
}

__global__ void __launch_bounds__(1024) ctc_alpha_paired_kernel(
    const float* __restrict__ logp, const unsigned char* __restrict__ skip,
    const int* __restrict__ lens, float* __restrict__ alphas,
    float* __restrict__ final_alpha, int T, int B, int S) {
  extern __shared__ float row[];  // (2, S): double-buffered alpha row
  const int b = blockIdx.x;
  const int len = lens[b];
  float a[kMaxPerThread];
  float k0[kMaxPerThread], k1[kMaxPerThread], k2[kMaxPerThread];  // K[s], K[s-1], K[s-2]
  const unsigned char* sk = skip + (size_t)b * S;
#pragma unroll
  for (int i = 0; i < kMaxPerThread; ++i) {
    const int s = threadIdx.x + i * blockDim.x;
    a[i] = NEG_INF;
    k0[i] = k1[i] = k2[i] = NEG_INF;
    if (s < S) {
      k0[i] = sk[s] != 0 ? 0.f : NEG_INF;
      k1[i] = s >= 1 && sk[s - 1] != 0 ? 0.f : NEG_INF;
      k2[i] = s >= 2 && sk[s - 2] != 0 ? 0.f : NEG_INF;
    }
  }
  for (int t = 0; t < T; t += 2) {
    float* cur = row + ((t >> 1) & 1) * S;
#pragma unroll
    for (int i = 0; i < kMaxPerThread; ++i) {
      const int s = threadIdx.x + i * blockDim.x;
      if (s < S) cur[s] = a[i];
    }
    __syncthreads();
    const bool second = t + 1 < T;
    const float* lp0 = logp + ((size_t)t * B + b) * S;
    const float* lp1 = lp0 + (size_t)B * S;
#pragma unroll
    for (int i = 0; i < kMaxPerThread; ++i) {
      const int s = threadIdx.x + i * blockDim.x;
      if (s >= S) continue;
      const float p0 = lp0[s];
      const float p0s1 = s >= 1 ? lp0[s - 1] : NEG_INF;
      const float p0s2 = s >= 2 ? lp0[s - 2] : NEG_INF;
      const float p1 = second ? lp1[s] : NEG_INF;
      const float x0 = a[i];
      const float x1 = s >= 1 ? cur[s - 1] : NEG_INF;
      const float x2 = s >= 2 ? cur[s - 2] : NEG_INF;
      const float x3 = s >= 3 ? cur[s - 3] : NEG_INF;
      const float x4 = s >= 4 ? cur[s - 4] : NEG_INF;
      // Emission-only pair weights.
      const float w1 = lse2(p0, p0s1);
      const float w2 = lse3(p0 + k0[i], p0s1, p0s2 + k0[i]);
      const float w3 = lse2(p0s1 + k1[i], p0s2 + k0[i]);
      const float w4 = p0s2 + k0[i] + k2[i];
      // The single step, stored at t.
      const float alpha0 = s < 2 ? p0 : NEG_INF;
      float a1 = fmaxf(lse3(x0, x1, x2 + k0[i]) + p0, NEG_INF);
      a1 = t == 0 ? alpha0 : (t < len ? a1 : x0);
      float out = a1;
      if (t + 1 < len) {
        if (t == 0) {  // the second step applied to alpha_0
          const float z1 = s == 1 || s == 2 ? p0s1 : NEG_INF;
          const float z2 = s == 2 || s == 3 ? p0s2 : NEG_INF;
          out = fmaxf(lse3(alpha0, z1, z2 + k0[i]) + p1, NEG_INF);
        } else {
          out = fmaxf(lse5(x0 + p0, x1 + w1, x2 + w2, x3 + w3, x4 + w4) + p1, NEG_INF);
        }
      }
      alphas[((size_t)t * B + b) * S + s] = a1;
      if (second) alphas[((size_t)(t + 1) * B + b) * S + s] = out;
      a[i] = out;
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

// The paired recursion (PAIRED_FWD): same arguments and outputs as ctc_alpha.
extern "C" int ctc_alpha_paired(const float* logp_tbs, const unsigned char* skip,
                                const int* lens, float* alphas, float* final_alpha, int T,
                                int B, int S, void* stream) {
  if (T == 0 || B == 0 || S == 0) return 0;
  const int threads = threads_for(S);
  ctc_alpha_paired_kernel<<<B, threads, 2 * S * sizeof(float), (cudaStream_t)stream>>>(
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

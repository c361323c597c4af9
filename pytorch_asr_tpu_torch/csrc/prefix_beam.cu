// CTC prefix beam search with dense n-gram shallow fusion, the whole
// utterance in one launch, for Hopper (sm_90a), CUDA C++.
//
// Replaces (one template, two instantiations):
//   K7  pytorch_asr_tpu/ops/beam_pallas.py:756 prefix_beam_fused_lanes
//       (_beam_kernel_lanes :601): extensions over all V chars;
//   K8  pytorch_asr_tpu/ops/beam_pallas.py:1566 prefix_beam_fused_lanes_topa
//       (_beam_kernel_lanes_topa :1153): extensions over each frame's top-A
//       chars, given by the caller.
// Python side: ops/beam_cuda.py; plain version:
// decoding/prefix_beam.py::beam_scan_plain, which it matches token for token.
//
// Inputs: logp (B, T, V) fp32, already log-softmaxed; for K8 the frame's
// top-A values and ids (B, T, A); lens (B) int32; the LM table (n_ctx, V)
// fp32 or null.  Outputs: the best beam's tokens (B, L) int32 left-packed
// with zeros after, its length (B) and fused score (B), plus the per-frame
// backpointers (B, T, K) parent and append as scratch.
//
// Per frame t < lens[b], with C = V (K7) or A (K8) candidate lanes a beam:
//   stays       stay_pb = lse(pb, pnb) + lp[blank];
//               stay_pnb = last >= 0 ? pnb + lp[last] : NEG_INF;
//   extensions  lane (k, a) appends c: (c == last ? pb : lse(pb, pnb)) + lp[c],
//               NEG_INF for the blank and for beams at length >= L;
//               ext_lm = lm_s + (alpha * table[ctx * V + c] + beta);
//               ctx' = (ctx * V + c) floor-mod n_ctx;
//   absorb      an extension of beam k whose hash equals an alive stay k'
//               adds its pnb into that stay by log-sum-exp and drops out;
//   top-K       the K best of the stays then the lanes in flat order k*C + a,
//               by fused score; stays win ties, else the lowest index;
//   dead        a pick with score <= NEG_INF / 2 gets pb = pnb = NEG_INF and
//               hash -(r + 1); lm_s and ctx are kept (as the reference does).
// At the end: score = lse(pb, pnb) + lm_s, best = the first argmax, and the
// tokens come from walking the backpointers from the row's last frame to 0.
//
// Parity traps (each decides token equality with the plain version):
//   hashes   h * 1000003 + c wraps mod 2^32: computed in uint32_t, since
//            signed overflow is undefined in C++;
//   mod      the next context is a floored mod; C++'s % truncates;
//   FMA      nvcc contracts a * b + c into one fused multiply-add unless
//            told not to, while torch rounds the product and the sum apart:
//            the fusion line is written with __fmul_rn / __fadd_rn;
//   lse      torch.logaddexp's formula, max + log1p(exp(-|a - b|)), with the
//            finite sentinel NEG_INF = -1e30 (never +-inf);
//   top-K    ties go to the lower flat index: the selection key is the
//            score's order-preserving bits above the inverted index;
//   empty    lens[b] = 0 gives the empty hypothesis with score 0.
//
// Bound on this card: bytes.  It reads logp (B*T*V*4), the table once, and
// writes the backpointers (2*B*T*K*4): about 5.3 MB at the serving shapes
// (B 16, T 400, V 31, K 16, a 4-gram table of 3.69 MB), 1.6 us at 3.35 TB/s;
// the operations are far below that.  In practice it is bound by the serial
// chain of T frames, each an absorb and K rounds of a block-wide argmax with
// a barrier each, on B = 16 of the 132 SMs.  Making it fast is later work.
//
// Design, first and simple: one block per utterance with the time loop
// inside (the beam is a serial chain over frames); one thread per candidate
// lane (K*C = 496 at V = 31, 128 at A = 8), looping when K*C > 1024.  The
// beam fields (pb, pnb, hash, last, length, lm score, context; double
// buffered), the candidate arrays and the frame's logp row live in shared
// memory; the table stays in device memory (L2-resident: 3.69 MB).  The
// TPU kernel's one-hot gathers, lane concatenations, masked-sum extractions
// and time chunks were Mosaic workarounds and have no counterpart here.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float NEG_INF = -1.0e30f;
constexpr uint32_t HASH_MULT = 1000003u;

__device__ __forceinline__ float lse(float a, float b) {
  const float m = fmaxf(a, b);
  return m + log1pf(expf(-fabsf(a - b)));
}

__device__ __forceinline__ int floor_mod(int x, int n) {
  const int r = x % n;
  return r < 0 ? r + n : r;
}

// Higher key = better candidate: the score's order-preserving bits, then the
// inverted flat index, so equal scores rank the lower index first.
__device__ __forceinline__ unsigned long long make_key(float s, int idx) {
  if (s == 0.0f) s = 0.0f;  // -0 ranks as +0, as float comparison has it
  uint32_t u = __float_as_uint(s);
  u = (u & 0x80000000u) ? ~u : (u | 0x80000000u);
  return ((unsigned long long)u << 32) | (0xFFFFFFFFu - (uint32_t)idx);
}

__device__ __forceinline__ float key_score(unsigned long long key) {
  const uint32_t u = (uint32_t)(key >> 32);
  return __uint_as_float((u & 0x80000000u) ? (u & 0x7FFFFFFFu) : ~u);
}

__device__ __forceinline__ int key_index(unsigned long long key) {
  return (int)(0xFFFFFFFFu - (uint32_t)key);
}

__device__ __forceinline__ unsigned long long umax(unsigned long long a,
                                                   unsigned long long b) {
  return a > b ? a : b;
}

template <bool kTopA>
__global__ void __launch_bounds__(1024) prefix_beam_kernel(
    const float* __restrict__ logp, const float* __restrict__ top_val,
    const int* __restrict__ top_idx, const int* __restrict__ lens,
    const float* __restrict__ table, int* parents, int* appends,
    int* __restrict__ tokens, int* __restrict__ out_len, float* __restrict__ out_score,
    int T, int V, int K, int C, int L, int n_ctx, float alpha, float beta) {
  const int KC = K * C, N = K + KC;
  extern __shared__ unsigned long long smem[];
  unsigned long long* key = smem;                         // (N) selection keys
  unsigned long long* wbest = key + N;                    // (2, 32) warp maxima
  float* pb = reinterpret_cast<float*>(wbest + 64);       // (2, K) beam fields,
  float* pnb = pb + 2 * K;                                //   double-buffered
  float* lms = pnb + 2 * K;
  float* spb = lms + 2 * K;                               // (K) stay candidates
  float* spnb = spb + K;
  float* epnb = spnb + K;                                 // (KC) extensions
  float* elm = epnb + KC;
  float* lp = elm + KC;                                   // (V) the frame's logp
  uint32_t* hsh = reinterpret_cast<uint32_t*>(lp + V);    // (2, K)
  int* last = reinterpret_cast<int*>(hsh + 2 * K);
  int* len = last + 2 * K;
  int* ctx = len + 2 * K;
  int* slot = ctx + 2 * K;                                // (V) K8: char -> slot
  unsigned char* absorbed = reinterpret_cast<unsigned char*>(slot + V);  // (KC)

  const int b = blockIdx.x, tid = threadIdx.x, nt = blockDim.x;
  const int warp = tid >> 5, nwarps = (nt + 31) >> 5;
  const int n_t = min(max(lens[b], 0), T);
  if (tid < K) {
    pb[tid] = tid == 0 ? 0.0f : NEG_INF;
    pnb[tid] = NEG_INF;
    lms[tid] = 0.0f;
    hsh[tid] = (uint32_t)(-(tid + 1));
    last[tid] = -1;
    len[tid] = 0;
    ctx[tid] = 0;
  }
  int cur = 0;
  for (int t = 0; t < n_t; ++t) {
    const float *pb_c = pb + cur * K, *pnb_c = pnb + cur * K, *lms_c = lms + cur * K;
    const uint32_t* hsh_c = hsh + cur * K;
    const int *last_c = last + cur * K, *len_c = len + cur * K, *ctx_c = ctx + cur * K;
    const size_t row = (size_t)b * T + t;

    // The frame's row; K8 clears its char -> slot map.
    for (int v = tid; v < V; v += nt) {
      lp[v] = logp[row * V + v];
      if (kTopA) slot[v] = -1;
    }
    __syncthreads();

    // Stays (a thread a beam) and extensions (a thread a lane).
    if (tid < K) {
      const float total = lse(pb_c[tid], pnb_c[tid]);
      spb[tid] = total + lp[0];
      spnb[tid] = last_c[tid] >= 0 ? pnb_c[tid] + lp[last_c[tid]] : NEG_INF;
    }
    for (int lane = tid; lane < KC; lane += nt) {
      const int k = lane / C, a = lane - k * C;
      int c;
      float lpc;
      if (kTopA) {
        c = top_idx[row * C + a];
        lpc = top_val[row * C + a];
        if (k == 0) slot[c] = a;
      } else {
        c = a;
        lpc = lp[c];
      }
      const float total = lse(pb_c[k], pnb_c[k]);
      float e = (c == last_c[k] ? pb_c[k] : total) + lpc;
      if (len_c[k] >= L || c == 0) e = NEG_INF;  // beam full, or the blank
      epnb[lane] = e;
      float l = lms_c[k];
      if (table != nullptr) {
        const float r = table[(size_t)ctx_c[k] * V + c];
        l = __fadd_rn(l, __fadd_rn(__fmul_rn(alpha, r), beta));  // no FMA
      }
      elm[lane] = l;
      absorbed[lane] = 0;
    }
    __syncthreads();

    // Absorb: the char that would turn beam k into alive stay k' is
    // c = h_k' - M h_k (mod 2^32); at most one lane of each beam k matches.
    if (tid < K) {
      const float sn = spnb[tid];
      float add = NEG_INF;
      if (lse(spb[tid], sn) > NEG_INF / 2) {
        const uint32_t h2 = hsh_c[tid];
        float m = NEG_INF;
        for (int k = 0; k < K; ++k) {
          const uint32_t c = h2 - HASH_MULT * hsh_c[k];
          const int s = (c >= 1u && c < (uint32_t)V) ? (kTopA ? slot[c] : (int)c) : -1;
          if (s >= 0) {
            absorbed[k * C + s] = 1;
            m = fmaxf(m, epnb[k * C + s]);
          }
        }
        if (m > NEG_INF / 2) {
          float sum = 0.0f;
          for (int k = 0; k < K; ++k) {
            const uint32_t c = h2 - HASH_MULT * hsh_c[k];
            const int s = (c >= 1u && c < (uint32_t)V) ? (kTopA ? slot[c] : (int)c) : -1;
            if (s >= 0) sum += expf(epnb[k * C + s] - m);
          }
          add = m + logf(sum);
        }
      }
      spnb[tid] = lse(sn, add);
    }
    __syncthreads();

    // Selection keys: stays are candidates 0..K-1, lane (k, a) is K + k*C + a.
    for (int j = tid; j < N; j += nt) {
      float s;
      if (j < K) {
        s = lse(spb[j], spnb[j]) + lms_c[j];
      } else {
        const int lane = j - K;
        s = absorbed[lane] ? NEG_INF : epnb[lane] + elm[lane];
      }
      key[j] = make_key(s, j);
    }

    // Top-K: K rounds of a block argmax; candidate j belongs to thread
    // j % nt, which alone reads and clears its keys.  Thread r keeps pick r.
    unsigned long long mine = 0;
    for (int r = 0; r < K; ++r) {
      unsigned long long best = 0;
      for (int j = tid; j < N; j += nt) best = umax(best, key[j]);
      for (int o = 16; o > 0; o >>= 1) best = umax(best, __shfl_xor_sync(0xffffffffu, best, o));
      if ((tid & 31) == 0) wbest[(r & 1) * 32 + warp] = best;
      __syncthreads();
      best = 0;
      for (int w = 0; w < nwarps; ++w) best = umax(best, wbest[(r & 1) * 32 + w]);
      const int j = key_index(best);
      if (j % nt == tid) key[j] = 0;
      if (tid == r) mine = best;
    }

    // The K picks become the next beams; record the backpointers.
    if (tid < K) {
      const int r = tid, j = key_index(mine), nx = (cur ^ 1) * K + r;
      int k, append;
      if (j < K) {
        k = j;
        append = -1;
        pb[nx] = spb[k];
        pnb[nx] = spnb[k];
        lms[nx] = lms_c[k];
        hsh[nx] = hsh_c[k];
        ctx[nx] = ctx_c[k];
        last[nx] = last_c[k];
        len[nx] = len_c[k];
      } else {
        const int lane = j - K;
        k = lane / C;
        const int a = lane - k * C;
        const int c = kTopA ? top_idx[row * C + a] : a;
        append = c;
        pb[nx] = NEG_INF;
        pnb[nx] = epnb[lane];
        lms[nx] = elm[lane];
        hsh[nx] = hsh_c[k] * HASH_MULT + (uint32_t)c;
        ctx[nx] = table != nullptr
                      ? floor_mod((int)((uint32_t)ctx_c[k] * (uint32_t)V + (uint32_t)c), n_ctx)
                      : ctx_c[k];
        last[nx] = c;
        len[nx] = len_c[k] + 1;
      }
      if (key_score(mine) <= NEG_INF / 2) {  // a dead filler
        pb[nx] = NEG_INF;
        pnb[nx] = NEG_INF;
        hsh[nx] = (uint32_t)(-(r + 1));
      }
      parents[row * K + r] = k;
      appends[row * K + r] = append;
    }
    __syncthreads();
    cur ^= 1;
  }

  for (int i = tid; i < L; i += nt) tokens[(size_t)b * L + i] = 0;
  __syncthreads();
  if (tid == 0) {
    const float *pb_c = pb + cur * K, *pnb_c = pnb + cur * K, *lms_c = lms + cur * K;
    int best = 0;
    float bs = lse(pb_c[0], pnb_c[0]) + lms_c[0];
    for (int k = 1; k < K; ++k) {
      const float s = lse(pb_c[k], pnb_c[k]) + lms_c[k];
      if (s > bs) {
        bs = s;
        best = k;
      }
    }
    out_score[b] = bs;
    out_len[b] = len[cur * K + best];
    // Count the chain's appends, then write them left-packed (at most L).
    int count = 0;
    for (int t = n_t - 1, k = best; t >= 0; --t) {
      const size_t at = ((size_t)b * T + t) * K + k;
      count += appends[at] >= 0;
      k = parents[at];
    }
    for (int t = n_t - 1, k = best, pos = count - 1; t >= 0; --t) {
      const size_t at = ((size_t)b * T + t) * K + k;
      if (appends[at] >= 0) {
        if (pos < L) tokens[(size_t)b * L + pos] = appends[at];
        --pos;
      }
      k = parents[at];
    }
  }
}

// Dynamic shared memory of one block, as ops/beam_cuda.py::smem_bytes
// computes it: keys 8 (K + K*C), warp maxima 512, 4 (16 K + 2 K*C + 2 V) of
// fields, candidates and the row, and K*C absorbed flags.
size_t smem_bytes(int K, int C, int V) {
  return 72 * (size_t)K + 17 * (size_t)K * C + 8 * (size_t)V + 512;
}

}  // namespace

// top_val/top_idx null: K7 over all V chars (C = V); else K8 over C = A.
// parents/appends: (B, T, K) int32 scratch; tokens (B, L); out_len,
// out_score (B).  The wrapper checks K <= 1024 and the shared-memory size.
extern "C" int prefix_beam(const float* logp, const float* top_val, const int* top_idx,
                           const int* lens, const float* table, int* parents, int* appends,
                           int* tokens, int* out_len, float* out_score, int B, int T, int V,
                           int K, int C, int L, int n_ctx, float alpha, float beta,
                           void* stream) {
  if (B == 0) return 0;
  const size_t smem = smem_bytes(K, C, V);
  int threads = (K * C + 31) / 32 * 32;
  threads = threads > 1024 ? 1024 : threads;
  auto kernel = top_idx != nullptr ? prefix_beam_kernel<true> : prefix_beam_kernel<false>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  kernel<<<B, threads, smem, (cudaStream_t)stream>>>(
      logp, top_val, top_idx, lens, table, parents, appends, tokens, out_len, out_score, T,
      V, K, C, L, n_ctx, alpha, beta);
  return cudaGetLastError();
}

// Two more designs of the CTC prefix beam search without an LM, for Hopper
// (sm_90a), CUDA C++: the whole search with each beam's tokens carried in
// the block (K13), and the search as one launch a frame with its state in
// device memory (K12).
//
// Replaces:
//   K13 pytorch_asr_tpu/ops/beam_pallas.py:313 prefix_beam_fused
//       (_beam_kernel :128): one program for the whole search, each beam's
//       token buffer (K, L) rebuilt every frame from its parent's, the best
//       beam's tokens returned directly;
//   K12 pytorch_asr_tpu/ops/beam_pallas.py:905 prefix_beam_lanes_stepwise
//       (_beam_kernel_lanes_onestep :842): one frame of the search a launch,
//       the (B, K) state read from and written to device memory, the frame's
//       (parent, append) written to (B, T, K); T launches, then a backtrace
//       (_backtrace :739).
// Python side: ops/beam_cuda.py (prefix_beam_fused, prefix_beam_lanes_stepwise).
// Plain version: decoding/prefix_beam.py::beam_scan_plain with no LM (K13,
// and K12 over the whole search), ::prefix_beam_stepwise_plain (K12's
// pointers every frame and its last state).  Both are bit-equal to them:
// tokens, lengths and scores, and K12's pointers and state, dead beams
// included.
//
// The function is K7's (csrc/prefix_beam.cu) with no LM.  Per frame t < len:
//   stays       stay_pb = lse(pb, pnb) + lp[blank];
//               stay_pnb = last >= 0 ? pnb + lp[last] : NEG_INF;
//   extensions  lane (k, c - 1) appends c = 1 .. V-1:
//               (c == last ? pb : lse(pb, pnb)) + lp[c], NEG_INF at length >= L;
//   absorb      an extension of beam k whose hash equals an alive stay k'
//               adds its pnb into that stay by log-sum-exp and drops out;
//   top-K       the K best of the stays then the lanes in flat order, stays
//               first on ties, then the lower index;
//   dead        a pick with score <= NEG_INF / 2 gets pb = pnb = NEG_INF and
//               hash -(r + 1).
// The lanes are the plain search's (V - 1 a beam, no dead blank lane, unlike
// K7's V), so every field of every pick, dead picks included, is the plain
// search's.  The arithmetic is K7's and K10's, copied: torch.logaddexp's
// formula with the finite NEG_INF, uint32_t hashes (int32 wraparound), the
// 64-bit selection key (the score's order-preserving bits above the
// inverted index).  A copy, and not a header shared with prefix_beam.cu:
// a shared function there moved ptxas's allocation of K9 (see that file).
//
// Bound on this card: bytes, as K7: logp read once (B T V 4 bytes); K12
// also reads and writes its (B, K) state of 5 fields every frame and writes
// (B, T, K) backpointers.  In practice both are bound by the serial chain of
// frames, each an absorb and K rounds of a block-wide argmax with a barrier
// each, on B of the 132 SMs.  K13 adds a copy of K x L token ints a frame in
// shared memory (the TPU kernel's one-hot token gather); K12 adds a launch a
// frame, the floor of any design that launches once a frame (the beam-
// sharded search does, around its exchange).
//
// Design, first and simple: one block per utterance, one thread per
// candidate lane (K (V-1) = 480 at V = 31), looping past 1024.  K13 keeps
// the time loop in the block, with the beam fields and the token buffers
// (2, K, L) int32 double-buffered in shared memory (32 KB at K 16, L 256).
// K12's block reads its row's state into shared memory, runs the frame,
// and writes the picks back over it (each block owns its row, so in place);
// rows past their length write the identity pointers and leave the state.
// The launcher queues the T launches itself, on one stream, in one call.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float NEG_INF = -1.0e30f;
constexpr uint32_t HASH_MULT = 1000003u;

__device__ __forceinline__ float lse(float a, float b) {
  const float m = fmaxf(a, b);
  return m + log1pf(expf(-fabsf(a - b)));
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

// Top-K: K rounds of a block argmax over the N keys; candidate j belongs to
// thread j % nt, which alone reads and clears its keys, so no barrier is
// needed before the first round.  Thread r < K gets pick r's key.
__device__ __forceinline__ unsigned long long select_topk(unsigned long long* key,
                                                          unsigned long long* wbest, int N,
                                                          int K, int tid, int nt) {
  const int warp = tid >> 5, nwarps = (nt + 31) >> 5;
  unsigned long long mine = 0;
  for (int r = 0; r < K; ++r) {
    unsigned long long best = 0;
    for (int j = tid; j < N; j += nt) best = umax(best, key[j]);
    for (int o = 16; o > 0; o >>= 1) best = umax(best, __shfl_xor_sync(0xffffffffu, best, o));
    if ((tid & 31) == 0) wbest[(r & 1) * 32 + warp] = best;  // double-buffered
    __syncthreads();
    best = 0;
    for (int w = 0; w < nwarps; ++w) best = umax(best, wbest[(r & 1) * 32 + w]);
    const int j = key_index(best);
    if (j % nt == tid) key[j] = 0;
    if (tid == r) mine = best;
  }
  return mine;
}

// One frame's scratch in shared memory.
struct Frame {
  unsigned long long* key;    // (K + K nb) selection keys
  unsigned long long* wbest;  // (2, 32) warp maxima
  float* spb;                 // (K) stay candidates
  float* spnb;
  float* epnb;                // (K nb) extension lanes
  float* lp;                  // (V) the frame's log-probs
  unsigned char* absorbed;    // (K nb)
};

// Shared memory of the frame scratch: keys 8 (K + K nb), warp maxima 512,
// 4 (2 K + K nb + V) of candidates and the row, K nb absorbed flags.  The
// kernels add their state after the floats (ops/beam_cuda.py mirrors this).
__host__ __device__ inline size_t frame_floats(int K, int nb, int V) {
  return 2 * (size_t)K + (size_t)K * nb + V;
}

// Carves the frame scratch from the front of smem; returns where the
// kernel's own arrays begin (4-byte aligned).  Each kernel places
// f.absorbed after its arrays.
__device__ __forceinline__ char* carve_frame(Frame& f, unsigned long long* smem, int K, int nb,
                                             int V) {
  const int KC = K * nb;
  f.key = smem;
  f.wbest = f.key + K + KC;
  f.spb = reinterpret_cast<float*>(f.wbest + 64);
  f.spnb = f.spb + K;
  f.epnb = f.spnb + K;
  f.lp = f.epnb + KC;
  return reinterpret_cast<char*>(f.lp + V);
}

// One frame of the search on the beams (pb, pnb, hsh, last, len) in shared
// memory, with the row already in f.lp: candidates, absorb, keys, top-K.
// Thread r < K returns pick r's key.
__device__ __forceinline__ unsigned long long search_frame(const Frame& f, const float* pb,
                                                           const float* pnb,
                                                           const uint32_t* hsh,
                                                           const int* last, const int* len,
                                                           int K, int nb, int L, int tid,
                                                           int nt) {
  const int KC = K * nb, N = K + KC;
  // Stays (a thread a beam) and extensions (a thread a lane).
  if (tid < K) {
    const float total = lse(pb[tid], pnb[tid]);
    f.spb[tid] = total + f.lp[0];
    f.spnb[tid] = last[tid] >= 0 ? pnb[tid] + f.lp[last[tid]] : NEG_INF;
  }
  for (int lane = tid; lane < KC; lane += nt) {
    const int k = lane / nb, c = lane - k * nb + 1;
    const float total = lse(pb[k], pnb[k]);
    float e = (c == last[k] ? pb[k] : total) + f.lp[c];
    if (len[k] >= L) e = NEG_INF;  // the beam is full
    f.epnb[lane] = e;
    f.absorbed[lane] = 0;
  }
  __syncthreads();
  // Absorb: the char that would turn beam k into alive stay k' is
  // c = h_k' - M h_k (mod 2^32); lane (k, c - 1) when 1 <= c <= nb.
  if (tid < K) {
    const float sn = f.spnb[tid];
    float add = NEG_INF;
    if (lse(f.spb[tid], sn) > NEG_INF / 2) {
      const uint32_t h2 = hsh[tid];
      float m = NEG_INF;
      for (int k = 0; k < K; ++k) {
        const uint32_t c = h2 - HASH_MULT * hsh[k];
        if (c >= 1u && c <= (uint32_t)nb) {
          f.absorbed[k * nb + c - 1] = 1;
          m = fmaxf(m, f.epnb[k * nb + c - 1]);
        }
      }
      if (m > NEG_INF / 2) {
        float sum = 0.0f;
        for (int k = 0; k < K; ++k) {
          const uint32_t c = h2 - HASH_MULT * hsh[k];
          if (c >= 1u && c <= (uint32_t)nb) sum += expf(f.epnb[k * nb + c - 1] - m);
        }
        add = m + logf(sum);
      }
    }
    f.spnb[tid] = lse(sn, add);
  }
  __syncthreads();
  // Selection keys: stays are candidates 0..K-1, lane l is K + l.
  for (int j = tid; j < N; j += nt) {
    float s;
    if (j < K) {
      s = lse(f.spb[j], f.spnb[j]);
    } else {
      const int lane = j - K;
      s = f.absorbed[lane] ? NEG_INF : f.epnb[lane];
    }
    f.key[j] = make_key(s, j);
  }
  return select_topk(f.key, f.wbest, N, K, tid, nt);
}

// A pick's fields: the stay or lane behind key `mine` as new beam r.
struct Pick {
  int parent, append, len;
  float pb, pnb;
  uint32_t hash;
  int last;
};

__device__ __forceinline__ Pick take_pick(const Frame& f, unsigned long long mine, int r,
                                          const uint32_t* hsh, const int* last, const int* len,
                                          int K, int nb) {
  Pick p;
  const int j = key_index(mine);
  if (j < K) {
    p.parent = j;
    p.append = -1;
    p.pb = f.spb[j];
    p.pnb = f.spnb[j];
    p.hash = hsh[j];
    p.last = last[j];
    p.len = len[j];
  } else {
    const int lane = j - K, k = lane / nb, c = lane - k * nb + 1;
    p.parent = k;
    p.append = c;
    p.pb = NEG_INF;
    p.pnb = f.epnb[lane];
    p.hash = hsh[k] * HASH_MULT + (uint32_t)c;
    p.last = c;
    p.len = len[k] + 1;
  }
  if (key_score(mine) <= NEG_INF / 2) {  // a dead filler carries no mass
    p.pb = NEG_INF;
    p.pnb = NEG_INF;
    p.hash = (uint32_t)(-(r + 1));
  }
  return p;
}

// K13: the whole search in one block an utterance, the tokens carried.
__global__ void __launch_bounds__(1024) beam_fused_kernel(const float* __restrict__ logp,
                                                          const int* __restrict__ lens,
                                                          int* __restrict__ tokens,
                                                          int* __restrict__ out_len,
                                                          float* __restrict__ out_score, int T,
                                                          int V, int K, int L) {
  const int nb = V - 1;
  extern __shared__ __align__(16) unsigned long long smem[];
  Frame f;
  float* pb = reinterpret_cast<float*>(carve_frame(f, smem, K, nb, V));  // (2, K) fields,
  float* pnb = pb + 2 * K;                                               //   double-buffered
  uint32_t* hsh = reinterpret_cast<uint32_t*>(pnb + 2 * K);
  int* last = reinterpret_cast<int*>(hsh + 2 * K);
  int* len = last + 2 * K;
  int* par = len + 2 * K;                  // (K) each pick's parent
  int* app = par + K;                      // (K) its appended char, or -1
  int* plen = app + K;                     // (K) its parent's length
  int* tok = plen + K;                     // (2, K, L) token buffers
  f.absorbed = reinterpret_cast<unsigned char*>(tok + 2 * (size_t)K * L);  // (K nb)

  const int b = blockIdx.x, tid = threadIdx.x, nt = blockDim.x;
  const int n_t = min(max(lens[b], 0), T);
  if (tid < K) {
    pb[tid] = tid == 0 ? 0.0f : NEG_INF;
    pnb[tid] = NEG_INF;
    hsh[tid] = (uint32_t)(-(tid + 1));
    last[tid] = -1;
    len[tid] = 0;
  }
  for (int i = tid; i < K * L; i += nt) tok[i] = 0;
  int cur = 0;
  for (int t = 0; t < n_t; ++t) {
    const int o = cur * K, n = (cur ^ 1) * K;
    for (int v = tid; v < V; v += nt) f.lp[v] = logp[((size_t)b * T + t) * V + v];
    __syncthreads();
    const unsigned long long mine =
        search_frame(f, pb + o, pnb + o, hsh + o, last + o, len + o, K, nb, L, tid, nt);
    if (tid < K) {
      const Pick p = take_pick(f, mine, tid, hsh + o, last + o, len + o, K, nb);
      pb[n + tid] = p.pb;
      pnb[n + tid] = p.pnb;
      hsh[n + tid] = p.hash;
      last[n + tid] = p.last;
      len[n + tid] = p.len;
      par[tid] = p.parent;
      app[tid] = p.append;
      plen[tid] = len[o + p.parent];
    }
    __syncthreads();
    // Each new beam's tokens: its parent's, with the appended char at the
    // parent's length (dropped past L).
    const int* src = tok + (size_t)cur * K * L;
    int* dst = tok + (size_t)(cur ^ 1) * K * L;
    for (int i = tid; i < K * L; i += nt) {
      const int r = i / L, at = i - r * L;
      dst[i] = (app[r] >= 0 && at == plen[r]) ? app[r] : src[par[r] * L + at];
    }
    cur ^= 1;
  }
  __syncthreads();
  // The best beam: the first of the highest lse(pb, pnb).
  const int o = cur * K;
  int best = 0;
  float bs = lse(pb[o], pnb[o]);
  for (int k = 1; k < K; ++k) {
    const float s = lse(pb[o + k], pnb[o + k]);
    if (s > bs) {
      bs = s;
      best = k;
    }
  }
  for (int i = tid; i < L; i += nt)
    tokens[(size_t)b * L + i] = tok[((size_t)cur * K + best) * L + i];
  if (tid == 0) {
    out_score[b] = bs;
    out_len[b] = len[o + best];
  }
}

// K12: one frame, state (B, K) in device memory updated in place;
// parents/appends (B, T, K) get this frame's pointers.
__global__ void __launch_bounds__(1024) beam_step_kernel(
    const float* __restrict__ logp, const int* __restrict__ lens, int t, float* pb_g,
    float* pnb_g, int* hash_g, int* last_g, int* len_g, int* __restrict__ parents,
    int* __restrict__ appends, int T, int V, int K, int L) {
  const int nb = V - 1;
  const int b = blockIdx.x, tid = threadIdx.x, nt = blockDim.x;
  const size_t row = (size_t)b * T + t;
  if (t >= lens[b]) {  // past the row's length: the state stays, the pointers are identity
    for (int r = tid; r < K; r += nt) {
      parents[row * K + r] = r;
      appends[row * K + r] = -1;
    }
    return;
  }
  extern __shared__ __align__(16) unsigned long long smem[];
  Frame f;
  float* pb = reinterpret_cast<float*>(carve_frame(f, smem, K, nb, V));  // (K) the state
  float* pnb = pb + K;
  uint32_t* hsh = reinterpret_cast<uint32_t*>(pnb + K);
  int* last = reinterpret_cast<int*>(hsh + K);
  int* len = last + K;
  f.absorbed = reinterpret_cast<unsigned char*>(len + K);
  const size_t so = (size_t)b * K;
  for (int k = tid; k < K; k += nt) {
    pb[k] = pb_g[so + k];
    pnb[k] = pnb_g[so + k];
    hsh[k] = (uint32_t)hash_g[so + k];
    last[k] = last_g[so + k];
    len[k] = len_g[so + k];
  }
  for (int v = tid; v < V; v += nt) f.lp[v] = logp[row * V + v];
  __syncthreads();
  const unsigned long long mine = search_frame(f, pb, pnb, hsh, last, len, K, nb, L, tid, nt);
  if (tid < K) {
    const Pick p = take_pick(f, mine, tid, hsh, last, len, K, nb);
    pb_g[so + tid] = p.pb;
    pnb_g[so + tid] = p.pnb;
    hash_g[so + tid] = (int)p.hash;
    last_g[so + tid] = p.last;
    len_g[so + tid] = p.len;
    parents[row * K + tid] = p.parent;
    appends[row * K + tid] = p.append;
  }
}

// K12's state before the first frame: beam 0 the empty prefix (pb 0), the
// rest dead, hashes -(k + 1), no last char, length 0.
__global__ void stepwise_init_kernel(float* pb, float* pnb, int* hash, int* last, int* len,
                                     int n, int K) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int k = i % K;
  pb[i] = k == 0 ? 0.0f : NEG_INF;
  pnb[i] = NEG_INF;
  hash[i] = -(k + 1);
  last[i] = -1;
  len[i] = 0;
}

// K12's end: each row's best beam (the first of the highest lse(pb, pnb)),
// and its tokens from walking the pointers back from the row's last frame,
// left-packed with zeros after (at most L), as K7's backtrace.
__global__ void stepwise_finish_kernel(const float* __restrict__ pb,
                                       const float* __restrict__ pnb,
                                       const int* __restrict__ len,
                                       const int* __restrict__ lens,
                                       const int* __restrict__ parents,
                                       const int* __restrict__ appends, int* __restrict__ tokens,
                                       int* __restrict__ out_len,
                                       float* __restrict__ out_score, int T, int K, int L) {
  const int b = blockIdx.x;
  for (int i = threadIdx.x; i < L; i += blockDim.x) tokens[(size_t)b * L + i] = 0;
  __syncthreads();
  if (threadIdx.x != 0) return;
  const size_t so = (size_t)b * K;
  int best = 0;
  float bs = lse(pb[so], pnb[so]);
  for (int k = 1; k < K; ++k) {
    const float s = lse(pb[so + k], pnb[so + k]);
    if (s > bs) {
      bs = s;
      best = k;
    }
  }
  out_score[b] = bs;
  out_len[b] = len[so + best];
  const int n_t = min(max(lens[b], 0), T);
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

// Shared memory of one block, as ops/beam_cuda.py computes it.
__host__ __device__ inline size_t fused_smem_bytes(int K, int V, int L) {
  const int nb = V - 1;
  return 8 * ((size_t)K + (size_t)K * nb) + 512 + 4 * frame_floats(K, nb, V) +
         4 * (10 * (size_t)K + 3 * (size_t)K + 2 * (size_t)K * L) + (size_t)K * nb;
}

__host__ __device__ inline size_t step_smem_bytes(int K, int V) {
  const int nb = V - 1;
  return 8 * ((size_t)K + (size_t)K * nb) + 512 + 4 * frame_floats(K, nb, V) +
         4 * 5 * (size_t)K + (size_t)K * nb;
}

int threads_for(int K, int V) {
  int threads = (K * (V - 1) + 31) / 32 * 32;
  return threads > 1024 ? 1024 : threads;
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

}  // namespace

// K13: logp (B, T, V) fp32 log-softmaxed, lens (B) int32 -> the best beam's
// tokens (B, L) int32 (zeros past its length), its length (B) and score (B).
// The wrapper checks 2 <= V, K <= 1024 and the shared-memory size.
extern "C" int prefix_beam_fused(const float* logp, const int* lens, int* tokens, int* out_len,
                                 float* out_score, int B, int T, int V, int K, int L,
                                 void* stream) {
  if (B == 0) return 0;
  const size_t smem = fused_smem_bytes(K, V, L);
  cudaError_t err = allow_smem(beam_fused_kernel, smem);
  if (err != cudaSuccess) return err;
  beam_fused_kernel<<<B, threads_for(K, V), smem, (cudaStream_t)stream>>>(
      logp, lens, tokens, out_len, out_score, T, V, K, L);
  return cudaGetLastError();
}

// K12: the whole search as T launches of one frame each, on one stream:
// the state (B, K) pb, pnb, hash, last, len and the pointers (B, T, K) are
// the caller's scratch; outputs as prefix_beam_fused.
extern "C" int prefix_beam_stepwise(const float* logp, const int* lens, float* pb, float* pnb,
                                    int* hash, int* last, int* len, int* parents, int* appends,
                                    int* tokens, int* out_len, float* out_score, int B, int T,
                                    int V, int K, int L, void* stream) {
  if (B == 0) return 0;
  const cudaStream_t st = (cudaStream_t)stream;
  const size_t smem = step_smem_bytes(K, V);
  cudaError_t err = allow_smem(beam_step_kernel, smem);
  if (err != cudaSuccess) return err;
  stepwise_init_kernel<<<(B * K + 255) / 256, 256, 0, st>>>(pb, pnb, hash, last, len, B * K, K);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  for (int t = 0; t < T; ++t) {
    beam_step_kernel<<<B, threads_for(K, V), smem, st>>>(logp, lens, t, pb, pnb, hash, last,
                                                         len, parents, appends, T, V, K, L);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  stepwise_finish_kernel<<<B, 32, 0, st>>>(pb, pnb, len, lens, parents, appends, tokens,
                                           out_len, out_score, T, K, L);
  return cudaGetLastError();
}

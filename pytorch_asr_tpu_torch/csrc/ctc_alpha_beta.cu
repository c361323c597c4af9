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
// recursion is bound by the latency of a frame, times T: the frames are
// serial, and one utterance's lattice is one block's work.
//
// Design (ctc_alpha, ctc_beta): one block of W warps an utterance; lane l of
// warp w owns the K consecutive states s0 = (32 w + l) K .. s0 + K - 1 and
// keeps their alpha (beta) in registers, so S <= 32 W K (ops/ctc_cuda.py::
// lane_plan picks W and K from S; K in {1, 2, 4}, W <= 32).  A frame needs no
// exchange inside a lane; its first two states take s-1 and s-2 from lane
// l-1 by __shfl_up_sync (the beta mirrors it: s+1, s+2 from lane l+1 by
// __shfl_down_sync).  Only a warp's edge goes through shared memory, and
// without a block-wide barrier: each warp publishes its two edge states a
// step into a ring of slots, each state in one 64-bit word with its step;
// one lane of its neighbour (w+1 for the alpha, w-1 for the beta) spins on
// those words alone until they carry the step and frees each word it has
// read, which the publisher waits for before it reuses the word kRing steps
// later (each word's own coherence orders the three).  Warp 0 (the last
// warp, for the beta) waits on no one, so the warps run as a wavefront
// instead of meeting at a barrier every frame.  Each lane's logp row (and,
// for the beta, its alphas row) is loaded two frames ahead into
// one of two register slots, reloaded in place once the frame has used it
// (the loop runs two frames an iteration), so the chain never waits on L2.
// Frames past a row's length carry alpha (give w = 0) with stores only.
// Every state computes lse3(a, s1, s2) + logp (the beta: lse3(term, term1,
// term2), then expf(fmaxf(alpha + beta - logz, NEG_INF))) with the same
// operands in the same order as the plain recursions' and the block-a-row
// kernel this replaced, so the outputs are the same bits.  ptxas emits a
// lane's K lse3 chains one after another (libdevice's expf and logf stay
// whole), so the chains of a frame overlap across warps, not inside a
// lane: the route takes as few states a lane as its 32 warps allow.
//
// trace, if not null: (T, 8) int64; thread 0 of block 0 writes, for each
// frame it recurses (row t; frames of the carry and the beta's install row
// stay 0), the global timer (ns) as the frame starts, the SM clock (cycles)
// then, after its rows are in registers (the wait for the loads issued two
// frames before), after the neighbour's edge (the wait for its slot; the
// beta publishes its own edge first), after the shuffles, after the lse3
// chain (the beta: and the posteriors' exp), after the alpha's publication,
// the stores and the next loads' issue, and the global timer at its end.
//
// The wide forms (ctc_alpha_wide, ctc_beta_wide), past 32 W K states in
// registers (ops/ctc_cuda.py::lane_plan: S > 4096): the same block an
// utterance, 1024 threads over the states s = tid + 1024 i, with the
// lattice row in device memory.  The forward reads alpha_{t-1} back from
// its own alphas output; the beta keeps term = beta + logp[t+1] in a
// (2, B, S) scratch.  One __syncthreads a frame; the same arithmetic, so the
// same bits as the register form where both run.
//
// ctc_alpha_paired (ctc_alpha_paired_lanes_kernel): the same alphas two
// frames an iteration, on the alpha's lanes and warps (the same lane_plan).
// Two steps composed are one 5-term log-sum-exp over alpha[s-0..4] with
// weights W_0..W_4 built from frame t's emissions only (ops/ctc.py::
// alphas_paired_plain writes them out), plus frame t+1's emission.  The
// single step a1 is still computed: it is stored at t, and it is the output
// of a row whose length ends mid-pair.  The pair at t = 0 applies the second
// step to alpha_0 and needs no neighbour.  Each lane loads its emissions at
// s0-2 .. s0+K-1 of frame t and s0 .. s0+K-1 of frame t+1 a pair ahead into
// a register slot and builds the weights from them before it waits for its
// neighbours, so only a1's lse3 and the lse5 follow the wait.  A pair needs
// alpha at s-1 .. s-4: inside a warp by __shfl_up_sync (by 1-4 lanes at K 1,
// 1-2 at K 2, 1 at K 4).  The lanes whose window reaches past the warp's
// edge (lanes 0-3 at K 1, 0-1 at K 2, 0 at K 4) take all four from the
// warp's block of the step in a ring of stamped words (a state and its step
// in one 64-bit word, as above): words 0-3 the left warp's last four
// states, which that warp publishes and lane 0 frees after a __syncwarp of
// the reading lanes; words 4 .. 7 - K the warp's own first states, which it
// stores there for its lanes 1-3, so a lane's window is four consecutive
// words and needs no select.  A reader spins until its four words carry the
// step.  One exchange and one wait a pair, no block barrier.  A pair is
// twice the alpha's two frames of log-sum-exp (13 expf, 5 logf/log1pf a
// state) for half their waits: the JAX study's question, whether the
// recursion is bound by its chain's latency or by its throughput.  On the
// H100 it is bound by the issue of that work on the block's SM.  The same
// operands in the same order as the block-a-row paired kernel it replaced,
// so the same bits; a row longer than T ends at T, so final_alpha is
// alphas[T - 1], as in the plain version and the wide form.  Past 4096
// states, ctc_alpha_paired_wide runs the same arithmetic with the carried
// row read back from alphas[t-1].  trace, if not null: (T, 8) int64; lane 0
// of block 0's last warp (the wavefront's tail) writes, at row t of each
// pair t > 0 it recurses, the global timer (ns) as the pair starts, then the
// SM clock then, after its rows are in registers, after the weights, after
// the shuffles, after the left warp's edge, after the lse chains, and after
// the edge's publication, the next loads and the stores.

#include <cuda_runtime.h>

namespace {

constexpr float NEG_INF = -1.0e30f;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float lse3(float a, float b, float c) {
  const float m = fmaxf(fmaxf(fmaxf(a, b), c), NEG_INF);
  const float tot = m + logf(expf(a - m) + expf(b - m) + expf(c - m));
  return fmaxf(tot, NEG_INF);
}

__device__ __forceinline__ long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return (long long)t;
}

// This lane's K states of a row (``row`` points at its first; n states of
// the row lie at and past it), NEG_INF past the row.
template <int K>
__device__ __forceinline__ void load_row(float (&v)[K], const float* __restrict__ row, int n) {
#pragma unroll
  for (int i = 0; i < K; ++i) v[i] = i < n ? __ldg(row + i) : NEG_INF;
}

template <int K>
__device__ __forceinline__ void store_row(float* __restrict__ row, const float (&v)[K], int n) {
#pragma unroll
  for (int i = 0; i < K; ++i)
    if (i < n) row[i] = v[i];
}

// A trace point that waits for v: a branch on it, so the clock that follows
// is read after v has arrived.
__device__ __forceinline__ void wait_for(float v, long long* rec) {
  if (v == 1.25f) rec[7] = 0;
}

template <int K>
__device__ __forceinline__ void wait_for(const float (&v)[K], long long* rec) {
  float x = 0.f;
#pragma unroll
  for (int i = 0; i < K; ++i) x += v[i];
  if (x == 1.25f) rec[7] = 0;
}

// The warps' edge slots: a warp publishes the two states at its edge each
// step into a ring of kRing steps, each state in one 64-bit word with the
// step it belongs to, so a state and its step are stored and read together.
// Its neighbour's reading lane spins on a word until it carries the step,
// then frees it (stores kFree there).  The publisher loads its word a frame
// before it stores the next step there, kRing steps later, and waits for it
// to be free only if that load found it taken.  The read, the freeing, the
// load and the next store of a word are ordered by that word's own
// coherence (each lane's accesses to it in program order), so the protocol
// needs no fence and no flag of its own.  No block-wide barrier: each warp
// waits only on its neighbour, which runs ahead of it in the recursion's
// direction.
constexpr int kRing = 32;
constexpr unsigned long long kFree = ~0ull;  // no step's word: a step < 2^32 - 1

constexpr int kPairRing = 16;  // the paired alpha's ring: 16 steps of 8-word blocks, 32 KB

// [step % kSteps][warp]: (state bits << 32) | step; kWords 2 for the alpha
// and beta, 8 for the paired alpha's blocks.
template <int kWords, int kSteps = kRing>
struct Edges {
  unsigned long long v[kSteps][32][kWords];
};

template <int kWords, int kSteps>
__device__ __forceinline__ void init_edges(Edges<kWords, kSteps>& e) {
  for (int i = threadIdx.x; i < kSteps * 32 * kWords; i += blockDim.x) (&e.v[0][0][0])[i] = kFree;
}

// A wait past ~2^36 cycles (half a minute) traps: a broken protocol fails
// the launch instead of hanging the card.
__device__ __forceinline__ void wait_free(const unsigned long long* p) {
  if (*(const volatile unsigned long long*)p == kFree) return;
  const long long start = clock64();
  while (*(const volatile unsigned long long*)p != kFree)
    if (clock64() - start > (1LL << 36)) __trap();
}

// The word at p, loaded ahead of the put it clears: its latency hides
// behind the frame between the two.
__device__ __forceinline__ unsigned long long peek(const unsigned long long* p) {
  return *(const volatile unsigned long long*)p;
}

// Store x as step n's at p, once the word is free: ``seen`` is what this
// lane's last load of it (peek) read.
__device__ __forceinline__ void put(unsigned long long* p, unsigned long long seen, float x,
                                    int n) {
  if (seen != kFree) wait_free(p);
  *(volatile unsigned long long*)p = (unsigned long long)__float_as_uint(x) << 32 | (unsigned)n;
}

// The state in *p once it is step n's; then frees the word.
__device__ __forceinline__ float take(unsigned long long* p, int n) {
  unsigned long long w = *(volatile unsigned long long*)p;
  if ((unsigned)w != (unsigned)n) {
    const long long start = clock64();
    while ((unsigned)(w = *(volatile unsigned long long*)p) != (unsigned)n)
      if (clock64() - start > (1LL << 36)) __trap();
  }
  *(volatile unsigned long long*)p = kFree;
  return __uint_as_float((unsigned)(w >> 32));
}

// The paired alpha's edge words by their shared-memory addresses, computed
// once; each word is one 64-bit access, as put, peek and take make them.
using SmemAddr = unsigned;

__device__ __forceinline__ SmemAddr smem_addr(const void* p) {
  return (SmemAddr)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ unsigned long long lds_word(SmemAddr a) {
  unsigned long long w;
  asm volatile("ld.volatile.shared.u64 %0, [%1];" : "=l"(w) : "r"(a) : "memory");
  return w;
}

__device__ __forceinline__ void sts_word(SmemAddr a, unsigned long long w) {
  asm volatile("st.volatile.shared.u64 [%0], %1;" ::"r"(a), "l"(w) : "memory");
}

// The four words at a, one 64-bit load each.
__device__ __forceinline__ void load_window(SmemAddr a, unsigned long long (&w)[4]) {
#pragma unroll
  for (int j = 0; j < 4; ++j) w[j] = lds_word(a + 8 * j);
}

// Frees the four words at a (16-byte aligned).
__device__ __forceinline__ void free_window(SmemAddr a) {
  asm volatile("st.volatile.shared.v2.u64 [%0], {%1, %1};" ::"r"(a), "l"(kFree) : "memory");
  asm volatile("st.volatile.shared.v2.u64 [%0+16], {%1, %1};" ::"r"(a), "l"(kFree) : "memory");
}

// put, at a shared-memory address.
__device__ __forceinline__ void put_word(SmemAddr a, unsigned long long seen, float x, int n) {
  if (seen != kFree && lds_word(a) != kFree) {
    const long long start = clock64();
    while (lds_word(a) != kFree)
      if (clock64() - start > (1LL << 36)) __trap();
  }
  sts_word(a, (unsigned long long)__float_as_uint(x) << 32 | (unsigned)n);
}

// kTrace: the traced launch (thread 0 of block 0 writes the phase clocks);
// the untraced one carries no trace code.
template <int K, bool kTrace>
__global__ void __launch_bounds__(1024) ctc_alpha_lanes_kernel(
    const float* __restrict__ logp, const unsigned char* __restrict__ skip,
    const int* __restrict__ lens, float* __restrict__ alphas, float* __restrict__ final_alpha,
    long long* __restrict__ trace, int T, int B, int S) {
  __shared__ Edges<2> edges;
  const int b = blockIdx.x, lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5, s0 = threadIdx.x * K, n = S - s0;
  const size_t row = (size_t)B * S, off = (size_t)b * S + s0;
  const int t_end = min(lens[b], T);
  init_edges(edges);
  float a[K];
  unsigned sk = 0;  // bit i: state s0 + i may take the skip from s0 + i - 2
#pragma unroll
  for (int i = 0; i < K; ++i) {
    const int s = s0 + i;
    a[i] = i < n && s < 2 ? logp[off + i] : NEG_INF;
    if (i < n && s >= 2 && skip[off + i] != 0) sk |= 1u << i;
  }
  float* out = alphas + off;
  store_row(out, a, n);
  __syncthreads();  // the slots are free
  // A warp's edge: its last lane's last two states (lanes 31 and 30 at K 1),
  // published into its own slots, read by warp + 1's lane 0.
  unsigned long long* mine = &edges.v[0][warp][K >= 2 ? 0 : 31 - lane];
  unsigned long long* left = &edges.v[0][warp > 0 ? warp - 1 : 0][0];
  const bool publishes = warp + 1 < warps && (lane == 31 || (K == 1 && lane == 30));
  // The next step's words as this lane last loaded them: step t + 1's are
  // loaded as step t's are stored, a frame before their own store.
  unsigned long long f0 = kFree, f1 = kFree;
  auto publish = [&](int t) {
    if (publishes && t + 1 < t_end) {
      unsigned long long* slot = mine + (t & (kRing - 1)) * 64;
      put(slot, f0, a[K - 1], t);
      if (K >= 2) put(slot + 1, f1, a[K >= 2 ? K - 2 : 0], t);
      slot = mine + ((t + 1) & (kRing - 1)) * 64;
      f0 = peek(slot);
      if (K >= 2) f1 = peek(slot + 1);
    }
  };
  publish(0);
  long long* tr = kTrace && blockIdx.x == 0 && threadIdx.x == 0 ? trace : nullptr;

  auto frame = [&](const float(&lpv)[K], int t) {
    long long* rec = kTrace && tr ? tr + 8 * (size_t)t : nullptr;
    if (kTrace && rec) {
      rec[0] = global_ns();
      rec[1] = clock64();
      wait_for(lpv, rec);
      rec[2] = clock64();
    }
    // The left warp's last two states of frame t - 1, read (and freed) by
    // lane 0 alone; at K 1 lane 1's s-2 is lane 0's s-1.
    float x0 = NEG_INF, x1 = NEG_INF;
    if (warp > 0 && lane == 0) {
      unsigned long long* slot = left + ((t - 1) & (kRing - 1)) * 64;
      x0 = take(slot, t - 1);
      x1 = take(slot + 1, t - 1);
    }
    if (kTrace && rec) rec[3] = clock64();
    float up1 = __shfl_up_sync(kFull, a[K - 1], 1);
    if (lane == 0) up1 = x0;
    float up2 = __shfl_up_sync(kFull, K >= 2 ? a[K >= 2 ? K - 2 : 0] : up1, 1);
    if (lane == 0) up2 = x1;
    if (kTrace && rec) {
      wait_for(up2, rec);
      rec[4] = clock64();
    }
    float nv[K];
#pragma unroll
    for (int i = 0; i < K; ++i) {
      const float s1 = i >= 1 ? a[i >= 1 ? i - 1 : 0] : (s0 >= 1 ? up1 : NEG_INF);
      const float s2 = (sk >> i) & 1u ? (i >= 2 ? a[i >= 2 ? i - 2 : 0] : i == 1 ? up1 : up2)
                                      : NEG_INF;
      nv[i] = lse3(a[i], s1, s2) + lpv[i];
    }
#pragma unroll
    for (int i = 0; i < K; ++i) a[i] = nv[i];
    if (kTrace && rec) {
      wait_for(a, rec);
      rec[5] = clock64();
    }
    publish(t);
    out += row;
    store_row(out, a, n);
  };
  auto stamp = [&](int t) {
    if (kTrace && tr) {
      tr[8 * (size_t)t + 6] = clock64();
      tr[8 * (size_t)t + 7] = global_ns();
    }
  };

  // Two register slots of logp rows, each loaded two frames before its use;
  // `next` is the row the next load reads.
  float pa[K], pb[K];
  const float* next = logp + off + row;
  if (1 < t_end) load_row(pa, next, n);
  next += row;
  if (2 < t_end) load_row(pb, next, n);
  next += row;
  int t = 1;
  for (; t + 1 < t_end; t += 2) {
    frame(pa, t);
    if (t + 2 < t_end) load_row(pa, next, n);
    next += row;
    stamp(t);
    frame(pb, t + 1);
    if (t + 3 < t_end) load_row(pb, next, n);
    next += row;
    stamp(t + 1);
  }
  if (t < t_end) {
    frame(pa, t);
    stamp(t);
    ++t;
  }
  for (; t < T; ++t) {  // carried past the length
    out += row;
    store_row(out, a, n);
  }
  store_row(final_alpha + off, a, n);
}

template <int K, bool kTrace>
__global__ void __launch_bounds__(1024) ctc_beta_lanes_kernel(
    const float* __restrict__ logp, const float* __restrict__ alphas,
    const unsigned char* __restrict__ skip_from, const float* __restrict__ beta_T,
    const int* __restrict__ lens, const float* __restrict__ logz, float* __restrict__ w,
    long long* __restrict__ trace, int T, int B, int S) {
  __shared__ Edges<2> edges;
  const int b = blockIdx.x, lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5, s0 = threadIdx.x * K, n = S - s0;
  const size_t row = (size_t)B * S, off = (size_t)b * S + s0;
  const float lz = logz[b];
  const int len = min(lens[b], T);
  float v[K];
#pragma unroll
  for (int i = 0; i < K; ++i) v[i] = 0.f;
  for (int t = T - 1; t >= len && t >= 0; --t) store_row(w + off + (size_t)t * row, v, n);
  if (len <= 0) return;
  init_edges(edges);

  float beta[K];
  unsigned sk = 0;  // bit i: the transition s0 + i -> s0 + i + 2 is allowed
#pragma unroll
  for (int i = 0; i < K; ++i) {
    const int s = s0 + i;
    beta[i] = i < n ? beta_T[off + i] : NEG_INF;
    if (i < n && s + 2 < S && skip_from[off + i] != 0) sk |= 1u << i;
  }
  // The row's last frame: beta is beta_T there.
  float* wo = w + off + (size_t)(len - 1) * row;
  load_row(v, alphas + off + (size_t)(len - 1) * row, n);
#pragma unroll
  for (int i = 0; i < K; ++i) v[i] = expf(fmaxf(v[i] + beta[i] - lz, NEG_INF));
  store_row(wo, v, n);
  __syncthreads();  // the slots are free
  long long* tr = kTrace && blockIdx.x == 0 && threadIdx.x == 0 ? trace : nullptr;
  // A warp's edge: its first lane's first two terms (lanes 0 and 1 at K 1),
  // published into its own slots, read by warp - 1's lane 31.
  unsigned long long* mine = &edges.v[0][warp][K >= 2 ? 0 : lane & 1];
  unsigned long long* right = &edges.v[0][warp + 1 < warps ? warp + 1 : warp][0];
  const bool publishes = warp > 0 && (lane == 0 || (K == 1 && lane == 1));
  unsigned long long f0 = kFree, f1 = kFree;  // as the alpha's

  // Frame t, step len - 2 - t: term = beta_{t+1} + logp[t+1] (lpv), beta_t,
  // then w[t] = exp(alphas[t] (alv) + beta_t - logz).
  auto frame = [&](const float(&alv)[K], const float(&lpv)[K], int t) {
    const int step = len - 2 - t;
    long long* rec = kTrace && tr ? tr + 8 * (size_t)t : nullptr;
    if (kTrace && rec) {
      rec[0] = global_ns();
      rec[1] = clock64();
      wait_for(lpv, rec);
      wait_for(alv, rec);
      rec[2] = clock64();
    }
    float term[K];
#pragma unroll
    for (int i = 0; i < K; ++i) term[i] = beta[i] + lpv[i];
    if (publishes) {
      unsigned long long* slot = mine + (step & (kRing - 1)) * 64;
      put(slot, f0, term[0], step);
      if (K >= 2) put(slot + 1, f1, term[K >= 2 ? 1 : 0], step);
      slot = mine + ((step + 1) & (kRing - 1)) * 64;
      f0 = peek(slot);
      if (K >= 2) f1 = peek(slot + 1);
    }
    // The right warp's first two terms of this frame, read (and freed) by
    // lane 31 alone.
    float x0 = NEG_INF, x1 = NEG_INF;
    if (warp + 1 < warps && lane == 31) {
      unsigned long long* slot = right + (step & (kRing - 1)) * 64;
      x0 = take(slot, step);
      x1 = take(slot + 1, step);
    }
    if (kTrace && rec) rec[3] = clock64();
    float dn1 = __shfl_down_sync(kFull, term[0], 1);
    if (lane == 31) dn1 = x0;
    float dn2 = __shfl_down_sync(kFull, K >= 2 ? term[K >= 2 ? 1 : 0] : dn1, 1);
    if (lane == 31) dn2 = x1;
    if (kTrace && rec) {
      wait_for(dn2, rec);
      rec[4] = clock64();
    }
#pragma unroll
    for (int i = 0; i < K; ++i) {
      const int s = s0 + i;
      const float s1 = s + 1 < S ? (i + 1 < K ? term[i + 1 < K ? i + 1 : 0] : dn1) : NEG_INF;
      const float s2 = (sk >> i) & 1u
                           ? (i + 2 < K ? term[i + 2 < K ? i + 2 : 0] : i + 2 == K ? dn1 : dn2)
                           : NEG_INF;
      beta[i] = lse3(term[i], s1, s2);
    }
    float wv[K];
#pragma unroll
    for (int i = 0; i < K; ++i) wv[i] = expf(fmaxf(alv[i] + beta[i] - lz, NEG_INF));
    if (kTrace && rec) {
      wait_for(wv, rec);
      rec[5] = clock64();
    }
    wo -= row;
    store_row(wo, wv, n);
  };
  auto stamp = [&](int t) {
    if (kTrace && tr) {
      tr[8 * (size_t)t + 6] = clock64();
      tr[8 * (size_t)t + 7] = global_ns();
    }
  };

  // Two register slots of (alphas[t], logp[t + 1]), each loaded two frames
  // before its use; `na`, `nl` are the rows the next loads read.
  float aa[K], la[K], ab[K], lb[K];
  const float* na = alphas + off + (size_t)(len - 2) * row;
  const float* nl = logp + off + (size_t)(len - 1) * row;
  if (len >= 2) {
    load_row(aa, na, n);
    load_row(la, nl, n);
  }
  na -= row;
  nl -= row;
  if (len >= 3) {
    load_row(ab, na, n);
    load_row(lb, nl, n);
  }
  int t = len - 2;
  for (; t >= 1; t -= 2) {
    na -= row;
    nl -= row;
    frame(aa, la, t);
    if (t >= 2) {
      load_row(aa, na, n);
      load_row(la, nl, n);
    }
    stamp(t);
    na -= row;
    nl -= row;
    frame(ab, lb, t - 1);
    if (t >= 3) {
      load_row(ab, na, n);
      load_row(lb, nl, n);
    }
    stamp(t - 1);
  }
  if (t == 0) {
    frame(aa, la, 0);
    stamp(0);
  }
}

__global__ void __launch_bounds__(1024) ctc_alpha_wide_kernel(
    const float* __restrict__ logp, const unsigned char* __restrict__ skip,
    const int* __restrict__ lens, float* alphas, float* __restrict__ final_alpha, int T, int B,
    int S) {
  const int b = blockIdx.x;
  const size_t row = (size_t)B * S;
  const float* lp = logp + (size_t)b * S;
  const unsigned char* sk = skip + (size_t)b * S;
  float* al = alphas + (size_t)b * S;  // written and read back: no __restrict__, no __ldg
  const int t_end = min(lens[b], T);
  for (int s = threadIdx.x; s < S; s += blockDim.x) al[s] = s < 2 ? lp[s] : NEG_INF;
  for (int t = 1; t < T; ++t) {
    const float* prev = al + (size_t)(t - 1) * row;
    float* cur = al + (size_t)t * row;
    if (t < t_end) {
      __syncthreads();  // every state of alpha_{t-1} is written
      for (int s = threadIdx.x; s < S; s += blockDim.x) {
        const float s1 = s >= 1 ? prev[s - 1] : NEG_INF;
        const float s2 = sk[s] != 0 && s >= 2 ? prev[s - 2] : NEG_INF;
        cur[s] = lse3(prev[s], s1, s2) + lp[(size_t)t * row + s];
      }
    } else {
      for (int s = threadIdx.x; s < S; s += blockDim.x) cur[s] = prev[s];  // this thread's own
    }
  }
  for (int s = threadIdx.x; s < S; s += blockDim.x)
    final_alpha[(size_t)b * S + s] = al[(size_t)(T - 1) * row + s];
}

__global__ void __launch_bounds__(1024) ctc_beta_wide_kernel(
    const float* __restrict__ logp, const float* __restrict__ alphas,
    const unsigned char* __restrict__ skip_from, const float* __restrict__ beta_T,
    const int* __restrict__ lens, const float* __restrict__ logz, float* __restrict__ w,
    float* scratch, int T, int B, int S) {
  const int b = blockIdx.x;
  const size_t row = (size_t)B * S, off = (size_t)b * S;
  const float lz = logz[b];
  const int len = min(lens[b], T);
  for (int t = T - 1; t >= len && t >= 0; --t)
    for (int s = threadIdx.x; s < S; s += blockDim.x) w[(size_t)t * row + off + s] = 0.f;
  if (len <= 0) return;
  // term_t = beta_t + logp[t], in the (2, B, S) scratch: buffer t & 1.
  float* terms[2] = {scratch + off, scratch + row + off};
  {
    const int t = len - 1;
    for (int s = threadIdx.x; s < S; s += blockDim.x) {
      const size_t i = (size_t)t * row + off + s;
      const float beta = beta_T[off + s];
      w[i] = expf(fmaxf(alphas[i] + beta - lz, NEG_INF));
      terms[t & 1][s] = beta + logp[i];
    }
  }
  for (int t = len - 2; t >= 0; --t) {
    __syncthreads();  // every term of frame t + 1 is written
    const float* nx = terms[(t + 1) & 1];
    float* cu = terms[t & 1];
    for (int s = threadIdx.x; s < S; s += blockDim.x) {
      const size_t i = (size_t)t * row + off + s;
      const float s1 = s + 1 < S ? nx[s + 1] : NEG_INF;
      const float s2 = skip_from[off + s] != 0 && s + 2 < S ? nx[s + 2] : NEG_INF;
      const float beta = lse3(nx[s], s1, s2);
      w[i] = expf(fmaxf(alphas[i] + beta - lz, NEG_INF));
      cu[s] = beta + logp[i];
    }
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

// The paired alpha on the alpha's lanes (the design note above).  Lane l of
// warp w holds states s0 = (32 w + l) K .. s0 + K - 1; a step of the edge
// ring is a pair.  kTrace as the alpha's (the traced lane: the design note).
template <int K, bool kTrace>
__global__ void __launch_bounds__(1024) ctc_alpha_paired_lanes_kernel(
    const float* __restrict__ logp, const unsigned char* __restrict__ skip,
    const int* __restrict__ lens, float* __restrict__ alphas, float* __restrict__ final_alpha,
    long long* __restrict__ trace, int T, int B, int S) {
  // Warp w's block of a step: its window past its edge, alpha at its states
  // -4 .. 3 - K (relative to the warp's first), each in one word with the
  // step: words 0-3 the left warp's last four states, which that warp
  // publishes and this warp frees; words 4 .. 7 - K this warp's own first
  // states, which it stores for its own lanes 1-3.
  constexpr int kSteps = kPairRing, kOwn = 4 - K;
  __shared__ __align__(16) Edges<8, kSteps> edges;
  const int b = blockIdx.x, lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5, s0 = threadIdx.x * K, n = S - s0;
  const size_t row = (size_t)B * S, off = (size_t)b * S + s0;
  const int t_end = min(lens[b], T);
  init_edges(edges);
  // K[s + j - 2] (0 or NEG_INF), j = 0 .. K + 1: state s0 + i's K[s], K[s-1]
  // and K[s-2] are kk[i + 2], kk[i + 1] and kk[i] (NEG_INF before the
  // lattice's start).
  float kk[K + 2];
#pragma unroll
  for (int j = 0; j < K + 2; ++j)
    kk[j] = s0 + j - 2 >= 0 && j - 2 < n && skip[off + j - 2] != 0 ? 0.f : NEG_INF;
  __syncthreads();  // the slots are free
  constexpr unsigned kBlock = 8 * 8, kStepBytes = 32 * kBlock;
  constexpr unsigned kEdgeLanes = (1u << (4 / K)) - 1;  // lanes with lane K < 4
  const SmemAddr ring = smem_addr(&edges.v[0][0][0]);
  // The lanes whose states are the warp's last four publish them into warp
  // + 1's block (words lane K + i - (32 K - 4)); those whose states are its
  // first kOwn store them into its own (words 4 + lane K + i); lanes with
  // lane K < 4 read words lane K .. lane K + 3 of their own block.
  const bool publishes = warp + 1 < warps && lane * K >= 32 * K - 4;
  const bool owns = warp > 0 && lane * K < kOwn;
  const bool reads = warp > 0 && lane * K < 4;
  SmemAddr pub = ring + (warp + 1) * kBlock + 8 * (lane * K - (32 * K - 4));
  SmemAddr own = ring + warp * kBlock + 8 * (4 + lane * K);
  SmemAddr rd = ring + warp * kBlock + 8 * lane * K;
  // Held in registers: ptxas would otherwise derive them again from the
  // thread's index every pair.
  asm volatile("" : "+r"(pub), "+r"(own), "+r"(rd));
  unsigned long long f[K];  // the next step's words as this lane last loaded them
#pragma unroll
  for (int i = 0; i < K; ++i) f[i] = kFree;
  float a[K];  // alpha at the pair's second row
  // Step q (alpha at row 2 q + 1), if the pair at 2 q + 2 recurses.
  auto publish = [&](int q) {
    if (2 * q + 2 >= t_end) return;
    const unsigned at = (q & (kSteps - 1)) * kStepBytes;
    if (publishes) {
#pragma unroll
      for (int i = 0; i < K; ++i)
        if (lane * K + i >= 32 * K - 4) put_word(pub + at + 8 * i, f[i], a[i], q);
      const unsigned nx = ((q + 1) & (kSteps - 1)) * kStepBytes;
#pragma unroll
      for (int i = 0; i < K; ++i)
        if (lane * K + i >= 32 * K - 4) f[i] = lds_word(pub + nx + 8 * i);
    }
    if (owns) {
#pragma unroll
      for (int i = 0; i < K; ++i)
        if (lane * K + i < kOwn)
          sts_word(own + at + 8 * i, (unsigned long long)__float_as_uint(a[i]) << 32 | (unsigned)q);
    }
  };
  long long* tr =
      kTrace && blockIdx.x == 0 && threadIdx.x == 32 * (warps - 1) ? trace : nullptr;
  // A pair's rows, loaded a pair ahead into one register slot (reloaded once
  // the pair has used it): e, logp[t] at s0 - 2 .. s0 + K - 1; p1, logp[t +
  // 1] at s0 .. s0 + K - 1 (NEG_INF where the pair has no second step).
  // `next` is the row the next load reads.
  float e[K + 2], p1[K];
  const float* next = logp + off;
  auto load = [&](int t) {
#pragma unroll
    for (int j = 0; j < K + 2; ++j)
      e[j] = s0 + j - 2 >= 0 && j - 2 < n ? __ldg(next + j - 2) : NEG_INF;
#pragma unroll
    for (int i = 0; i < K; ++i) p1[i] = t + 1 < t_end && i < n ? __ldg(next + row + i) : NEG_INF;
    next += 2 * row;
  };
  float* out = alphas + off;  // the pair's first row
  auto store_pair = [&](const float(&a1)[K], int t) {
    store_row(out, a1, n);
    out += row;
    if (t + 1 < T) store_row(out, a, n);
    out += row;
  };

  // The pair at t = 0: alpha_0, then the second step applied to it.
  load(0);
  {
    float a1[K];
#pragma unroll
    for (int i = 0; i < K; ++i) {
      const int s = s0 + i;
      const float alpha0 = s < 2 ? e[i + 2] : NEG_INF;
      a1[i] = alpha0;
      a[i] = alpha0;
      if (1 < t_end) {
        const float z1 = s == 1 || s == 2 ? e[i + 1] : NEG_INF;
        const float z2 = s == 2 || s == 3 ? e[i] : NEG_INF;
        a[i] = fmaxf(lse3(alpha0, z1, z2 + kk[i + 2]) + p1[i], NEG_INF);
      }
    }
    publish(0);
    if (2 < t_end) load(2);
    store_pair(a1, 0);
  }

  // The pairs at t > 0 that recurse (t < t_end).
  int t = 2;
  for (; t < t_end; t += 2) {
    const int q = t >> 1;
    long long* rec = kTrace && tr ? tr + 8 * (size_t)t : nullptr;
    if (kTrace && rec) {
      rec[0] = global_ns();
      rec[1] = clock64();
      wait_for(e, rec);
      wait_for(p1, rec);
      rec[2] = clock64();
    }
    // The emission-only weights, before the neighbours are awaited.
    float w1[K], w2[K], w3[K], w4[K];
#pragma unroll
    for (int i = 0; i < K; ++i) {
      const float p0 = e[i + 2], p0s1 = e[i + 1], p0s2 = e[i];
      const float k0 = kk[i + 2], k1 = kk[i + 1], k2 = kk[i];
      w1[i] = lse2(p0, p0s1);
      w2[i] = lse3(p0 + k0, p0s1, p0s2 + k0);
      w3[i] = lse2(p0s1 + k1, p0s2 + k0);
      w4[i] = p0s2 + k0 + k2;
    }
    if (kTrace && rec) {
      wait_for(w1, rec);
      wait_for(w2, rec);
      wait_for(w3, rec);
      rec[3] = clock64();
    }
    // x[4 - m]: alpha at s0 - m, from the lane ceil(m / K) to the left
    // (NEG_INF before the lattice) ...
    float x[4];
#pragma unroll
    for (int m = 1; m <= 4; ++m) {
      const int c = (m + K - 1) / K;
      x[4 - m] = __shfl_up_sync(kFull, a[K * c - m], c);
    }
    if (warp == 0) {
#pragma unroll
      for (int m = 1; m <= 4; ++m)
        if (lane * K < m) x[4 - m] = NEG_INF;
    }
    if (kTrace && rec) {
      wait_for(x, rec);
      rec[4] = clock64();
    }
    // ... or, for the lanes whose window reaches past the warp's edge, all
    // four from the warp's block of step q - 1, once each word carries the
    // step; lane 0 frees the left warp's words once every reading lane has
    // them.
    if (reads) {
      const SmemAddr at = rd + ((q - 1) & (kSteps - 1)) * kStepBytes;
      unsigned long long w[4];
      load_window(at, w);
      const unsigned step = (unsigned)(q - 1);
      auto carry = [&] {
        return ((unsigned)w[0] == step) & ((unsigned)w[1] == step) & ((unsigned)w[2] == step) &
               ((unsigned)w[3] == step);
      };
      if (!carry()) {
        const long long start = clock64();
        do {
          if (clock64() - start > (1LL << 36)) __trap();
          load_window(at, w);
        } while (!carry());
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) x[j] = __uint_as_float((unsigned)(w[j] >> 32));
      __syncwarp(kEdgeLanes);
      if (lane == 0) free_window(at);
    }
    if (kTrace && rec) {
      wait_for(x, rec);
      rec[5] = clock64();
    }
    float a1[K], nv[K];
#pragma unroll
    for (int i = 0; i < K; ++i) {
      float xm[5];  // alpha at s - m
#pragma unroll
      for (int m = 0; m <= 4; ++m)
        xm[m] = i >= m ? a[i >= m ? i - m : 0] : x[i >= m ? 0 : 4 + i - m];
      const float p0 = e[i + 2];
      a1[i] = fmaxf(lse3(xm[0], xm[1], xm[2] + kk[i + 2]) + p0, NEG_INF);
      nv[i] = t + 1 < t_end ? fmaxf(lse5(xm[0] + p0, xm[1] + w1[i], xm[2] + w2[i],
                                         xm[3] + w3[i], xm[4] + w4[i]) + p1[i],
                                    NEG_INF)
                            : a1[i];
    }
#pragma unroll
    for (int i = 0; i < K; ++i) a[i] = nv[i];
    if (kTrace && rec) {
      wait_for(a, rec);
      rec[6] = clock64();
    }
    publish(q);
    if (t + 2 < t_end) load(t + 2);
    store_pair(a1, t);
    if (kTrace && rec) rec[7] = clock64();
  }
  for (; t < T; ++t) {  // carried past the length
    store_row(out, a, n);
    out += row;
  }
  store_row(final_alpha + off, a, n);
}

// The paired arithmetic at any S, with the carried row alpha_{t-1} read back
// from its own alphas output: one __syncthreads a pair of frames.
__global__ void __launch_bounds__(1024) ctc_alpha_paired_wide_kernel(
    const float* __restrict__ logp, const unsigned char* __restrict__ skip,
    const int* __restrict__ lens, float* alphas, float* __restrict__ final_alpha, int T, int B,
    int S) {
  const int b = blockIdx.x;
  const int len = lens[b];
  const size_t row = (size_t)B * S;
  const unsigned char* sk = skip + (size_t)b * S;
  float* al = alphas + (size_t)b * S;  // written and read back: no __restrict__, no __ldg
  for (int t = 0; t < T; t += 2) {
    if (t > 0) __syncthreads();  // every state of the carried row alpha_{t-1} is written
    const bool second = t + 1 < T;
    const float* lp0 = logp + ((size_t)t * B + b) * S;
    const float* lp1 = lp0 + (size_t)B * S;
    const float* cur = al + (size_t)(t > 0 ? t - 1 : 0) * row;
    for (int s = threadIdx.x; s < S; s += blockDim.x) {
      const float k0 = sk[s] != 0 ? 0.f : NEG_INF;
      const float k1 = s >= 1 && sk[s - 1] != 0 ? 0.f : NEG_INF;
      const float k2 = s >= 2 && sk[s - 2] != 0 ? 0.f : NEG_INF;
      const float p0 = lp0[s];
      const float p0s1 = s >= 1 ? lp0[s - 1] : NEG_INF;
      const float p0s2 = s >= 2 ? lp0[s - 2] : NEG_INF;
      const float p1 = second ? lp1[s] : NEG_INF;
      const float x0 = t > 0 ? cur[s] : NEG_INF;
      const float x1 = t > 0 && s >= 1 ? cur[s - 1] : NEG_INF;
      const float x2 = t > 0 && s >= 2 ? cur[s - 2] : NEG_INF;
      const float x3 = t > 0 && s >= 3 ? cur[s - 3] : NEG_INF;
      const float x4 = t > 0 && s >= 4 ? cur[s - 4] : NEG_INF;
      // Emission-only pair weights.
      const float w1 = lse2(p0, p0s1);
      const float w2 = lse3(p0 + k0, p0s1, p0s2 + k0);
      const float w3 = lse2(p0s1 + k1, p0s2 + k0);
      const float w4 = p0s2 + k0 + k2;
      // The single step, stored at t.
      const float alpha0 = s < 2 ? p0 : NEG_INF;
      float a1 = fmaxf(lse3(x0, x1, x2 + k0) + p0, NEG_INF);
      a1 = t == 0 ? alpha0 : (t < len ? a1 : x0);
      float out = a1;
      if (t + 1 < len) {
        if (t == 0) {  // the second step applied to alpha_0
          const float z1 = s == 1 || s == 2 ? p0s1 : NEG_INF;
          const float z2 = s == 2 || s == 3 ? p0s2 : NEG_INF;
          out = fmaxf(lse3(alpha0, z1, z2 + k0) + p1, NEG_INF);
        } else {
          out = fmaxf(lse5(x0 + p0, x1 + w1, x2 + w2, x3 + w3, x4 + w4) + p1, NEG_INF);
        }
      }
      al[(size_t)t * row + s] = a1;
      if (second) al[(size_t)(t + 1) * row + s] = out;
    }
  }
  for (int s = threadIdx.x; s < S; s += blockDim.x)
    final_alpha[(size_t)b * S + s] = al[(size_t)(T - 1) * row + s];
}

int threads_for(int S) {
  const int t = (S + 31) / 32 * 32;
  return t > 1024 ? 1024 : t;
}

bool plan_ok(int warps, int k, int S) {
  return warps >= 1 && warps <= 32 && 32 * warps * k >= S;
}

}  // namespace

// logp_tbs, alphas: (T, B, S) fp32; skip: (B, S) bytes; lens: (B) int32;
// final_alpha: (B, S); trace: null or (T, 8) int64.  The register form:
// warps (at most 32) x 32 lanes of k states (k in 1, 2, 4) must cover S
// (ops/ctc_cuda.py::lane_plan).
extern "C" int ctc_alpha(const float* logp_tbs, const unsigned char* skip, const int* lens,
                         float* alphas, float* final_alpha, long long* trace, int T, int B,
                         int S, int warps, int k, void* stream) {
  if (T == 0 || B == 0 || S == 0) return 0;
  if (!plan_ok(warps, k, S)) return cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
#define CTC_ALPHA_CASE(K)                                                              \
  case K:                                                                              \
    if (trace)                                                                         \
      ctc_alpha_lanes_kernel<K, true><<<B, 32 * warps, 0, st>>>(                       \
          logp_tbs, skip, lens, alphas, final_alpha, trace, T, B, S);                  \
    else                                                                               \
      ctc_alpha_lanes_kernel<K, false><<<B, 32 * warps, 0, st>>>(                      \
          logp_tbs, skip, lens, alphas, final_alpha, trace, T, B, S);                  \
    break;
  switch (k) {
    CTC_ALPHA_CASE(1)
    CTC_ALPHA_CASE(2)
    CTC_ALPHA_CASE(4)
    default:
      return cudaErrorInvalidValue;
  }
#undef CTC_ALPHA_CASE
  return cudaGetLastError();
}

// The wide form: same arguments and outputs as ctc_alpha, any S.
extern "C" int ctc_alpha_wide(const float* logp_tbs, const unsigned char* skip, const int* lens,
                              float* alphas, float* final_alpha, int T, int B, int S,
                              void* stream) {
  if (T == 0 || B == 0 || S == 0) return 0;
  ctc_alpha_wide_kernel<<<B, threads_for(S), 0, (cudaStream_t)stream>>>(
      logp_tbs, skip, lens, alphas, final_alpha, T, B, S);
  return cudaGetLastError();
}

// The paired recursion (PAIRED_FWD): same arguments and outputs as
// ctc_alpha, its trace a record a pair (at the pair's first row).
extern "C" int ctc_alpha_paired(const float* logp_tbs, const unsigned char* skip,
                                const int* lens, float* alphas, float* final_alpha,
                                long long* trace, int T, int B, int S, int warps, int k,
                                void* stream) {
  if (T == 0 || B == 0 || S == 0) return 0;
  if (!plan_ok(warps, k, S)) return cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
#define CTC_PAIRED_CASE(K)                                                             \
  case K:                                                                              \
    if (trace)                                                                         \
      ctc_alpha_paired_lanes_kernel<K, true><<<B, 32 * warps, 0, st>>>(                \
          logp_tbs, skip, lens, alphas, final_alpha, trace, T, B, S);                  \
    else                                                                               \
      ctc_alpha_paired_lanes_kernel<K, false><<<B, 32 * warps, 0, st>>>(               \
          logp_tbs, skip, lens, alphas, final_alpha, trace, T, B, S);                  \
    break;
  switch (k) {
    CTC_PAIRED_CASE(1)
    CTC_PAIRED_CASE(2)
    CTC_PAIRED_CASE(4)
    default:
      return cudaErrorInvalidValue;
  }
#undef CTC_PAIRED_CASE
  return cudaGetLastError();
}

// The paired recursion at any S.
extern "C" int ctc_alpha_paired_wide(const float* logp_tbs, const unsigned char* skip,
                                     const int* lens, float* alphas, float* final_alpha, int T,
                                     int B, int S, void* stream) {
  if (T == 0 || B == 0 || S == 0) return 0;
  ctc_alpha_paired_wide_kernel<<<B, threads_for(S), 0, (cudaStream_t)stream>>>(
      logp_tbs, skip, lens, alphas, final_alpha, T, B, S);
  return cudaGetLastError();
}

// skip_from, beta_T: (B, S); lens: (B) int32, 0 for infeasible rows;
// logz: (B) fp32; w: (T, B, S) fp32; trace: null or (T, 8) int64; warps
// and k as ctc_alpha's.
extern "C" int ctc_beta(const float* logp_tbs, const float* alphas,
                        const unsigned char* skip_from, const float* beta_T,
                        const int* lens, const float* logz, float* w, long long* trace, int T,
                        int B, int S, int warps, int k, void* stream) {
  if (T == 0 || B == 0 || S == 0) return 0;
  if (!plan_ok(warps, k, S)) return cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
#define CTC_BETA_CASE(K)                                                                \
  case K:                                                                               \
    if (trace)                                                                          \
      ctc_beta_lanes_kernel<K, true><<<B, 32 * warps, 0, st>>>(                         \
          logp_tbs, alphas, skip_from, beta_T, lens, logz, w, trace, T, B, S);          \
    else                                                                                \
      ctc_beta_lanes_kernel<K, false><<<B, 32 * warps, 0, st>>>(                        \
          logp_tbs, alphas, skip_from, beta_T, lens, logz, w, trace, T, B, S);          \
    break;
  switch (k) {
    CTC_BETA_CASE(1)
    CTC_BETA_CASE(2)
    CTC_BETA_CASE(4)
    default:
      return cudaErrorInvalidValue;
  }
#undef CTC_BETA_CASE
  return cudaGetLastError();
}

// The wide form at any S: ctc_beta's arguments but the trace and the plan,
// and scratch: (2, B, S) fp32.
extern "C" int ctc_beta_wide(const float* logp_tbs, const float* alphas,
                             const unsigned char* skip_from, const float* beta_T,
                             const int* lens, const float* logz, float* w, float* scratch,
                             int T, int B, int S, void* stream) {
  if (T == 0 || B == 0 || S == 0) return 0;
  ctc_beta_wide_kernel<<<B, threads_for(S), 0, (cudaStream_t)stream>>>(
      logp_tbs, alphas, skip_from, beta_T, lens, logz, w, scratch, T, B, S);
  return cudaGetLastError();
}

// CTC prefix beam search with shallow fusion of a dense n-gram table or a
// char LSTM LM, the whole utterance in one launch, for Hopper (sm_90a),
// CUDA C++.
//
// Replaces (one frame function, search_frame, in three kernels):
//   K7  pytorch_asr_tpu/ops/beam_pallas.py:756 prefix_beam_fused_lanes
//       (_beam_kernel_lanes :601): extensions over all V chars;
//   K8  pytorch_asr_tpu/ops/beam_pallas.py:1566 prefix_beam_fused_lanes_topa
//       (_beam_kernel_lanes_topa :1153): extensions over each frame's top-A
//       chars, given by the caller;
//   K9  pytorch_asr_tpu/ops/beam_pallas.py:1452 prefix_beam_fused_lanes_topa_rnn
//       (_beam_kernel_lanes_topa_rnn :1286): either search, fused with a char
//       LSTM LM whose state every beam carries and the kernel advances: on a
//       co-resident grid (prefix_beam_rnn_grid_kernel) where its shapes fit,
//       else a block an utterance (prefix_beam_kernel<*, true>);
//   K10 pytorch_asr_tpu/ops/beam_pallas.py:1026 merge_topk_fused
//       (_merge_kernel :973): one frame's absorb and top-K over candidates
//       gathered from the beam shards, for the beam-sharded search (its own
//       kernel at the end of this file: K7's per-frame merge lifted out, on
//       search_frame's absorb and selection, the absorb written again).
// Python side: ops/beam_cuda.py; plain versions:
// decoding/prefix_beam.py::beam_scan_plain and, for K10, ::_merge_topk.
// K7, K8 and K10 match them token for token and bit for bit; K9 token for
// token (its LM products sum in another order than torch.matmul, so its
// scores agree to a few ulps a frame).
//
// Inputs: logp (B, T, V) fp32, already log-softmaxed; for the top-A search
// the frame's top-A values and ids (B, T, A); lens (B) int32; the LM table
// (n_ctx, V) fp32 or null (K7, K8), or the LM's weights and its state after
// <sos> (K9).  Outputs: the best beam's tokens (B, L) int32 left-packed
// with zeros after, its length (B) and fused score (B), plus the per-frame
// backpointers (B, T, K) parent and append as scratch.
//
// Per frame t < lens[b], with C = V or A candidate lanes a beam:
//   stays       stay_pb = lse(pb, pnb) + lp[blank];
//               stay_pnb = last >= 0 ? pnb + lp[last] : NEG_INF;
//   extensions  lane (k, a) appends c: (c == last ? pb : lse(pb, pnb)) + lp[c],
//               NEG_INF for the blank and for beams at length >= L;
//               ext_lm = lm_s + (alpha * row[c] + beta), row the beam's
//               table row table[ctx] or, for K9, its LM log-prob row;
//               ctx' = (ctx * V + c) floor-mod n_ctx (with a table);
//   absorb      an extension of beam k whose hash equals an alive stay k'
//               adds its pnb into that stay by log-sum-exp and drops out;
//   top-K       the K best of the stays then the lanes in flat order k*C + a,
//               by fused score; stays win ties, else the lowest index;
//   dead        a pick with score <= NEG_INF / 2 gets pb = pnb = NEG_INF and
//               hash -(r + 1); lm_s and ctx are kept (as the reference does).
//   K9's LM     after the picks, each new beam takes its parent's (h, c) of
//               every layer and its log-prob row; a beam that appended c
//               steps the LSTM from there with embed[c] (gates i, f, g, o;
//               c' = sigmoid(f + 1) c + sigmoid(i) tanh(g), h' = sigmoid(o)
//               tanh(c')) and gets row = log_softmax(h'_top w_out + b_out).
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
//            score's order-preserving bits above the inverted index, so
//            every key is unique and the K picks are the K largest keys in
//            descending order, whatever selection finds them;
//   empty    lens[b] = 0 gives the empty hypothesis with score 0.
//
//   sigmoid, tanh, exp and log are the precise expf/tanhf/logf (no fast
//   math); the LM products are fp32 FMA sums, no TF32, as the JAX kernel
//   computes them at Precision.HIGHEST.
//
// K10 reads the gathered fields once (7 stay and 6 lane fields, ~200 KB a
// frame at config 2) and writes 9 (B, K) outputs: bytes, ~0.06 us; it is
// bound by one launch and the latency of its few barrier-separated phases.
// Bound on this card, K7/K8: bytes.  It reads logp (B*T*V*4), the table
// once, and writes the backpointers (2*B*T*K*4): about 5.3 MB at the
// serving shapes (B 16, T 400, V 31, K 16, a 4-gram table of 3.69 MB), 1.6
// us at 3.35 TB/s; the operations are far below that.  In practice it is
// bound by the serial chain of T frames on B = 16 of the 132 SMs, each
// frame a few block barriers and the latency of its phases.
// K9: operations.  The LM step of a beam that appends is 2 * 4H * (E + H)
// FMA-operations for layer 0 and 2 * 4H * 2H for each further layer, plus
// 2 * H * V for w_out: up to ~29 MFLOP a frame and utterance at the default
// LM (E 128, H 256, 2 layers, K 16), ~190 GFLOP for 16 x 400 frames, ~2.8 ms
// at 67 TFLOP/s fp32 if every beam appended every frame; the data needs a
// few steps a frame, and the bound counts those.
//
// The frame (search_frame), a thread per candidate lane (K*C = 496 at V =
// 31, 128 at A = 8), looping where there are more lanes than threads.  The
// beam fields (pb, pnb, hash, last, length, lm score, context; double
// buffered), the candidate arrays and the frame's logp row (and K8's top-A
// values and ids) live in shared memory; the table stays in device memory
// (L2-resident: 3.69 MB).  Its phases, each ended by a block barrier:
//   1. stays (a thread a beam) and extensions (a thread a lane);
//   2. absorb, a thread a (stay, beam) test, the at most one match a stay
//      has found by shuffles (K <= 32; else a thread a stay); meanwhile the
//      next frame's row (and top-A values and ids) comes in by cp.async
//      into the same buffers, which no later phase of the frame reads;
//   3. selection keys and sort: warp w computes the keys of its own
//      contiguous segment of the N = K + K*C candidates (32 where the warps
//      suffice) and sorts them descending (a bitonic network in its flip
//      form: in registers by shuffles for 32 keys, else in place);
//   4. the merge tree (K <= 32): at each level list i takes list i + h, a
//      warp's lanes the lane-wise max of one list and the other reversed,
//      sorted by five half-cleaners, a barrier a level (4 levels at config
//      2); warp 0's lane r then holds pick r and writes the next beam r
//      and its backpointers.  Past K 32 each of the first K keys of a
//      segment counts the keys above it in every segment (binary searches)
//      and a key of rank r < K is pick r;
//   5. the row's copies are waited for.
// Since keys are unique the picks are the K largest in descending order,
// the same as K rounds of a block argmax.
// The TPU kernel's one-hot gathers, lane concatenations, masked-sum
// extractions and time chunks were Mosaic workarounds and have no
// counterpart here.
//
// K9 on the co-resident grid (prefix_beam_rnn_grid_kernel), where
// ops/beam_cuda.py::rnn_grid_route finds the shapes fit: one persistent CTA
// an SM under cudaLaunchCooperativeKernel, with the barrier of
// grid_sync.cuh.  The CTAs form `reps` runs (2 at config 2); in each run
// CTA j owns `units` hidden units and holds their gate columns j, H+j,
// 2H+j, 3H+j of every layer's weights in shared memory for the whole
// launch (layer 0's input product embed[c] wx0 as a (V, 4 units) table made
// in the prologue, so a step of layer 0 is h wh0).  Utterance b's search
// runs on CTA b mod ctas (more than one where B exceeds the grid).  Each
// utterance has 2K state slots: a beam points at one (a beam that did not
// append at its parent's, an appending beam at a slot no current beam
// holds), so no state is copied.  A frame:
//   search   each CTA runs search_frame for its utterances, each beam's LM
//            row from its slot's log-prob row in shared memory; it gives
//            its appending beams their slots and appends them to the
//            frame's list of rows (an atomic count);
//   barrier
//   layers   for each layer, every CTA of run q stages the q-th share of
//            the listed rows' inputs from L2 (cp.async.cg: the parent's h
//            of the layer, above layer 0 the row's new h of the layer
//            below, and the parent's c of its units), computes its units'
//            gate sums for those rows (a warp takes 8 rows and one unit,
//            its lanes split the inputs, a recursive halving leaves lane
//            4 q + g with row q's gate g) and its cells write h and c into
//            the rows' slots; a barrier after each layer;
//   logits   each search CTA computes h_top w_out + b_out for its own
//            appending beams (w_out, H x V, in its shared memory; a warp a
//            row, 32 chars at a time, the halving again), then the
//            log-softmax into their slots' rows; no barrier follows.
// The LM state (h and c of every slot, layer and unit) lies in a device
// scratch (1 MB at config 2, L2-resident).  Bound: the grid barriers (1 +
// layers a frame), the search and the logits (on B CTAs), and each CTA
// reading its run's share of the rows' inputs from L2.
// Past the grid (a CTA's weight columns, w_out and the staged rows past a
// block's shared memory: an LM of H 512 at beam 16 or more, thousands of
// utterances) K9 runs prefix_beam_kernel<*, true>, a block an utterance: it
// keeps every beam's LM state in shared memory for the whole utterance (h
// and c (layers, K, H) fp32, double-buffered for the parent reorder, and
// the log-prob rows (K, V); about 150 KB at the default LM), or where that
// does not fit beside the search in the block's slice of a device scratch,
// reads the weights (3.6 MB fp32) from L2 and steps the appending beams in
// groups of four: a thread takes one hidden unit j of one group, keeps the
// four gate sums of its four beams in registers, and reads the weight
// columns j, H+j, 2H+j and 3H+j (coalesced across the warp) once for the
// four beams; the beams' inputs sit in shared memory as float4 per input
// index.  Counted apart (prefix_beam_rnn_block); ptxas's allocation of that
// kernel moves with the code around it (a shared absorb function made it
// several times slower once), so its LM step stays as it was.
//
// Past a block's shared memory.  A block of K7/K8 needs 72 K + 17 K C +
// 8 V + 8 C + 512 bytes (beam 387 and up over the 31 chars passes the
// 232,448 a Hopper block may have), K9's block also the LM step's packed
// inputs (beam 64 with an LM of H 512 passes it with the state in a
// scratch).  Where a block does not fit (ops/beam_cuda.py::fits, from the
// shapes before the launch) the same kernel runs in its kInScratch form: the
// working set, laid out as in shared memory, lies in the block's slice of a
// device scratch (L1/L2-resident), and the next row comes in by plain loads.
// Same code, same order of operations, so the same result as the shared
// form; slower, as every access of the working set goes through L1.  It
// counts under its own names (prefix_beam_wide, ..._topa_wide,
// prefix_beam_rnn_wide, ..._rnn_topa_wide; K10's merge_topk_wide, below).
// No model configuration of the repo reaches it.
//
// The hashed n-gram LM (the kHash forms of K7 and K8; decoding/lm_hashed.py;
// JAX fuses it only in its scan, decoding/prefix_beam.py:375-401, so no TPU
// kernel is its counterpart).  Each beam carries a window of its last
// W = order - 1 ids (0 = no history) instead of a context id.  A frame first
// computes, a thread a (beam, level n = 2..order), the level's keys (two
// FNV-1a folds of the window's last n - 1 ids), whether they are all
// nonzero, and the context's backoff (uni_bo for one id, else one bucket
// row of its backoff table); then each lane folds its char into every
// level's keys and reads one 128-byte bucket row a level through L2,
// bottom-up: s = uni[c], then s = hit ? P_n : bo_n + s.  The keys are
// compared as int32 bits; a hit's value is 0 + P_n, as the plain version's
// masked sum gives it.  K7 with lm_top_k (exact != null) looks up only the
// frame's top chars (stamped with t in the slot map) and gives every other
// char the all-miss row (every level a backoff).  The window rolls where a
// beam appends.  The tables never enter shared memory: the working set
// grows by 24 K W bytes past the search's (hashed_smem_bytes), and the
// wrapper's scratch form takes it past a block (beam_cuda.fits with W).
// C entry prefix_beam_hashed; counted prefix_beam_hashed,
// prefix_beam_topa_hashed, their _carry and _wide forms.  K10's kWindow form
// (merge_topk with cols > 0) copies each pick's window of cols ids.
//
// A chunk of a stream (the kCarry forms of the block kernel and of K9's
// grid; JAX streams the search as decoding/prefix_beam.py:685
// prefix_beam_continue, a lax.scan of the offline step): the beams start as
// a BeamCarry in device memory holds them (pb, pnb, lm score, hash, last,
// length, context, and for K9 each beam's own (h, c) and log-prob row, in
// slot k of the grid's 2K) instead of search_init's fresh beams, and the
// state after the chunk goes back there, into other buffers: each beam's
// fields, its LM state out of the slot it points at, and its tokens, its
// ancestor's carried row (the beam at the chunk's start that its
// backpointers lead to) with the chunk's appends written over it from the
// ancestor's length on.  The best beam's tokens, length and score come out
// as finish_search gives them.  Nothing in a frame's arithmetic depends on
// T or on which slot holds a state, so chunks give the bits of one launch
// over their frames (ops/beam_cuda.py::prefix_beam_carry,
// prefix_beam_rnn_carry, counted *_carry).

#include <cuda_runtime.h>
#include <stdint.h>

#include <cstring>
#include <type_traits>

#include "grid_sync.cuh"

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
// inverted flat index, so equal scores rank the lower index first.  Never 0.
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

// The warp sort of the frame's selection.  Warp w's segment of the N keys
// is [w seg, min(N, (w + 1) seg)), seg = ceil(N / warps).
__device__ __forceinline__ int seg_len(int w, int seg, int N) {
  const int lo = w * seg, hi = min(N, lo + seg);
  return hi > lo ? hi - lo : 0;
}

__device__ __forceinline__ void order_desc(unsigned long long* key, int i, int j) {
  const unsigned long long a = key[i], b = key[j];
  if (b > a) {
    key[i] = b;
    key[j] = a;
  }
}

// Sorts key[0, n) descending, by the 32 lanes of one warp (all must call
// it): the bitonic network over the next power of two P >= n in its flip
// form, where every exchange (i, j), i < j, puts the larger key at i.  Keys
// past n count as 0, below every key, so an exchange whose j is past n
// leaves both in place and is skipped.
__device__ __forceinline__ void warp_sort_desc(unsigned long long* key, int n, int lane) {
  int lg = 0;
  while ((1 << lg) < n) ++lg;
  const int pairs = (1 << lg) >> 1;
  for (int s = 1; s <= lg; ++s) {
    // Flip: in each block of 2^s, i = base + o against base + 2^s - 1 - o.
    for (int q = lane; q < pairs; q += 32) {
      const int base = (q >> (s - 1)) << s, o = q & ((1 << (s - 1)) - 1);
      const int j = base + (1 << s) - 1 - o;
      if (j < n) order_desc(key, base + o, j);
    }
    __syncwarp();
    // Half-cleaners: i against i + 2^e, e = s - 2 down to 0.
    for (int e = s - 2; e >= 0; --e) {
      for (int q = lane; q < pairs; q += 32) {
        const int i = ((q >> e) << (e + 1)) | (q & ((1 << e) - 1));
        if (i + (1 << e) < n) order_desc(key, i, i + (1 << e));
      }
      __syncwarp();
    }
  }
}

// The same network on a segment of at most 32 keys, in registers: lane i
// holds key i (0 past n) and each exchange is a shuffle.
__device__ __forceinline__ unsigned long long warp_sort_desc_reg(unsigned long long v, int n,
                                                                 int lane) {
  for (int s = 1; (1 << (s - 1)) < n; ++s) {
    unsigned long long o = __shfl_xor_sync(0xffffffffu, v, (1 << s) - 1);  // the flip
    v = (lane & ((1 << s) - 1)) < (1 << (s - 1)) ? umax(v, o) : (v < o ? v : o);
    for (int e = s - 2; e >= 0; --e) {
      o = __shfl_xor_sync(0xffffffffu, v, 1 << e);
      v = (lane & (1 << e)) == 0 ? umax(v, o) : (v < o ? v : o);
    }
  }
  return v;
}

// The selection's merge tree over nw sorted segments `seg` keys apart (K
// <= 32 and K <= seg; each holds at least K keys, 0s past its end):
// at each level list i takes list i + h (h = ceil(m / 2) of m lists), warp
// i reading its list's K keys and the other's reversed, their lane-wise
// max a bitonic 32 that holds the top 32 of both, sorted by five
// half-cleaners; a block barrier a level.  All threads call it; lane r of
// warp 0 gets the r-th largest key.
__device__ __forceinline__ unsigned long long merge_tree(unsigned long long* key, int nw,
                                                         int seg, int K, int warp, int lane) {
  unsigned long long v = lane < K ? key[lane] : 0ull;  // a single list
  for (int m = nw; m > 1;) {
    const int h = (m + 1) >> 1;
    if (warp < m - h) {
      const unsigned long long a = lane < K ? key[warp * seg + lane] : 0ull;
      const unsigned long long b = 31 - lane < K ? key[(warp + h) * seg + 31 - lane] : 0ull;
      v = umax(a, b);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
        const unsigned long long u = __shfl_xor_sync(0xffffffffu, v, o);
        v = (lane & o) == 0 ? umax(v, u) : (v < u ? v : u);
      }
      if (lane < K) key[warp * seg + lane] = v;
    }
    m = h;
    __syncthreads();
  }
  return v;
}

// How many of the descending keys s[0, n) are above x, n <= P (a power of
// two): a binary search of log2(P) + 1 fixed steps.
__device__ __forceinline__ int count_above(const unsigned long long* s, int n, int P,
                                           unsigned long long x) {
  int i = 0;
  for (int step = P; step > 0; step >>= 1) {
    if (i + step <= n && s[i + step - 1] > x) i += step;
  }
  return i;
}

// K9's LM: the weights in device memory in the JAX layouts, and the state
// after <sos> that every beam starts from.  The layers' weights come by a
// table of 3 nl device pointers in device memory (any number of layers):
// wx of each layer, then wh of each, then b of each
// (ops/beam_cuda.py::lm_layer_table).
struct RnnLm {
  const float* embed;            // (V, E)
  const float* w_out;            // (H, V)
  const float* b_out;            // (V)
  const float* h0;               // (nl, H)
  const float* c0;               // (nl, H)
  const float* lmp0;             // (V) log-probs after <sos>
  const float* const* layer;     // (3 nl) the layers' weights
  int nl, E, H;
  __device__ __forceinline__ const float* wx(int l) const { return layer[l]; }  // (E or H, 4H)
  __device__ __forceinline__ const float* wh(int l) const { return layer[nl + l]; }  // (H, 4H)
  __device__ __forceinline__ const float* b(int l) const { return layer[2 * nl + l]; }  // (4H)
};

// K9's LM state and scratch in shared memory (the block kernel).
struct LmSmem {
  float* xin;   // (ceil(K/4), W, 4): inputs of the packed beams, W = max(E, H) + H
  float* h;     // (2, nl, K, H) double-buffered
  float* c;     // (2, nl, K, H)
  float* lmp;   // (2, K, V) each beam's log P(next char | prefix)
  int* par;     // (K) each pick's parent beam
  int* app;     // (K) each pick's appended char, -1 for none
  int* rows;    // (K) the picks that appended, packed
  int* n_app;   // (1) how many appended
};

// Dynamic shared memory of one block, as ops/beam_cuda.py computes it: the
// search's keys 8 (K + K*C), 512 of room past them, 4 (16 K + 2 K*C + 2 V + 2 C)
// of fields, candidates, the row and K8's top-A values and ids, and K*C
// absorbed flags; then, for K9 from the next 16-byte boundary, the LM's xin
// floats, its state (h, c and lmp floats) unless that lives in a global
// scratch, and 3 K + 1 ints.
__host__ __device__ inline size_t search_smem_bytes(int K, int C, int V) {
  return 72 * (size_t)K + 17 * (size_t)K * C + 8 * (size_t)V + 8 * (size_t)C + 512;
}

__host__ __device__ inline size_t lm_smem_offset(int K, int C, int V) {
  return (search_smem_bytes(K, C, V) + 15) / 16 * 16;
}

__host__ __device__ inline size_t lm_xin_floats(int K, int E, int H) {
  return (size_t)(K + 3) / 4 * 4 * ((E > H ? E : H) + H);
}

// One block's LM state: h and c (2, nl, K, H) each, lmp (2, K, V).
__host__ __device__ inline size_t lm_state_floats(int K, int V, int nl, int H) {
  return 4 * (size_t)nl * K * H + 2 * (size_t)K * V;
}

__host__ __device__ inline size_t lm_smem_bytes(int K, int V, int nl, int E, int H,
                                                bool state_in_smem) {
  return 4 * (lm_xin_floats(K, E, H) + (state_in_smem ? lm_state_floats(K, V, nl, H) : 0)) +
         4 * (3 * (size_t)K + 1);
}

// Where a block keeps its working set.  kShared: all of it in shared
// memory.  kLmStateInScratch (K9): the LM state in the block's slice of a
// device scratch of lm_state_floats, the rest in shared memory.  kInScratch:
// all of it, laid out as kShared lays it out, in the block's slice of a
// device scratch of scratch_block_bytes; no shared memory, and any beam,
// more beams than threads included.
enum Place { kShared = 0, kLmStateInScratch = 1, kInScratch = 2 };

// One block's slice of the kInScratch scratch: the working set as kShared
// lays it out (K9's with its LM state), to a 16-byte boundary.
// ops/beam_cuda.py::scratch_bytes computes the same.
__host__ __device__ inline size_t scratch_block_bytes(int K, int C, int V, bool rnn, int nl,
                                                      int E, int H) {
  const size_t work =
      rnn ? lm_smem_offset(K, C, V) + lm_smem_bytes(K, V, nl, E, H, true)
          : search_smem_bytes(K, C, V);
  return (work + 15) / 16 * 16;
}

// A hashed block's working set (the kHash forms of K7 and K8): the
// search's to a 16-byte boundary, then its HashWs of windows W = order - 1
// wide; its shared memory, and to 16 bytes its slice of the kInScratch
// scratch.  ops/beam_cuda.py::smem_bytes and scratch_bytes compute the same.
__host__ __device__ inline size_t hashed_smem_bytes(int K, int C, int V, int W) {
  return (search_smem_bytes(K, C, V) + 15) / 16 * 16 + 24 * (size_t)K * W;
}

__host__ __device__ inline size_t hashed_block_bytes(int K, int C, int V, int W) {
  return (hashed_smem_bytes(K, C, V, W) + 15) / 16 * 16;
}

// The search's working set of one utterance, laid out from a 16-byte
// aligned base as search_smem_bytes counts it.
struct SearchWs {
  unsigned long long* key;     // (N) selection keys
  unsigned long long* pad;     // (64) past the keys: room for the merge tree's zeros
  float *pb, *pnb, *lms;       // (2, K) beam fields, double-buffered
  float *spb, *spnb;           // (K) stay candidates
  float *epnb, *elm;           // (KC) extensions
  float* lp;                   // (V) the frame's logp
  float* tv;                   // (C) K8: the frame's top-A values
  int* ti;                     // (C) K8: the frame's top-A ids
  uint32_t* hsh;               // (2, K)
  int *last, *len, *ctx;       // (2, K)
  int* slot;                   // (V) K8: char -> slot
  unsigned char* absorbed;     // (KC)
};

__device__ __forceinline__ SearchWs search_ws(void* base, int K, int C, int V) {
  const int KC = K * C;
  SearchWs w;
  w.key = static_cast<unsigned long long*>(base);
  w.pad = w.key + K + KC;
  w.pb = reinterpret_cast<float*>(w.pad + 64);
  w.pnb = w.pb + 2 * K;
  w.lms = w.pnb + 2 * K;
  w.spb = w.lms + 2 * K;
  w.spnb = w.spb + K;
  w.epnb = w.spnb + K;
  w.elm = w.epnb + KC;
  w.lp = w.elm + KC;
  w.tv = w.lp + V;
  w.ti = reinterpret_cast<int*>(w.tv + C);
  w.hsh = reinterpret_cast<uint32_t*>(w.ti + C);
  w.last = reinterpret_cast<int*>(w.hsh + 2 * K);
  w.len = w.last + 2 * K;
  w.ctx = w.len + 2 * K;
  w.slot = w.ctx + 2 * K;
  w.absorbed = reinterpret_cast<unsigned char*>(w.slot + V);
  return w;
}

// What every frame of a search reads besides its working set.
struct SearchIn {
  const float* logp;     // (B, T, V)
  const float* top_val;  // (B, T, C) K8, else null
  const int* top_idx;    // (B, T, C) K8, else null
  const float* table;    // (n_ctx, V) or null
  int* parents;          // (B, T, K) backpointers
  int* appends;          // (B, T, K)
  int T, V, K, C, L, n_ctx;
  float alpha, beta;
};

// The hashed n-gram LM (the kHash forms of K7 and K8, in RnnLm's place):
// decoding/lm_hashed.py's tables in device memory.  A bucket row is 32
// words, [k1 x 8 | k2 x 8 | val x 8 | pad x 8], the int32 keys in float
// words; `tables` holds 2 (2N - 3) int64: the row arrays' addresses of the
// probs of orders 2..N, then of the backoffs of context lengths 2..N-1, then
// each array's bucket mask (buckets - 1) in that order
// (ops/beam_cuda.py::hash_table).  exact: K7 with lm_top_k, each frame's
// top n_exact chars (B, T, n_exact), whose rows are exact while the other
// chars take the all-miss row; null: every row exact.
struct HashLm {
  const float* uni;            // (V) log P(c), -20 where absent
  const float* uni_bo;         // (V) backoff of length-1 contexts
  const long long* tables;     // (2 (2N - 3))
  const int* exact;            // (B, T, n_exact) or null
  int order, n_exact;
};

// The hashed forms' part of the working set, from the 16-byte boundary past
// the search's: every beam's window of its last W = N - 1 ids (oldest
// first, 0 = no history; double-buffered), and each frame's context levels
// n = 2..N of each beam, (K, W): its two keys, its backoff (0 where the
// level is skipped or the context is absent) and whether the level is valid
// (the window's last n - 1 ids all nonzero).
struct HashWs {
  int* win;                    // (2, K, W)
  uint32_t *h1, *h2;           // (K, W)
  float* bo;                   // (K, W)
  int* valid;                  // (K, W)
};

__device__ __forceinline__ HashWs hash_ws(void* base, int K, int C, int V, int W) {
  HashWs h;
  h.win = reinterpret_cast<int*>(static_cast<char*>(base) +
                                 (search_smem_bytes(K, C, V) + 15) / 16 * 16);
  h.h1 = reinterpret_cast<uint32_t*>(h.win + 2 * K * W);
  h.h2 = h.h1 + K * W;
  h.bo = reinterpret_cast<float*>(h.h2 + K * W);
  h.valid = reinterpret_cast<int*>(h.bo + K * W);
  return h;
}

// FNV-1a's two 32-bit streams (lm_hashed.py's basis and prime pairs).
constexpr uint32_t kBasis1 = 0x811C9DC5u, kPrime1 = 0x01000193u;
constexpr uint32_t kBasis2 = 0x9747B28Cu, kPrime2 = 0x85EBCA6Bu;

__device__ __forceinline__ void fold(uint32_t& h1, uint32_t& h2, int x) {
  h1 = (h1 ^ (uint32_t)x) * kPrime1;
  h2 = (h2 ^ (uint32_t)x) * kPrime2;
}

// Table i's bucket of key (h1, h2): one 128-byte row through L2; the keys
// are compared as int32 bits.  Returns whether a way holds the key and, in
// *val, 0 + its value (the plain version's masked sum over the 8 ways, which
// turns a -0 into +0), 0 where none does.
__device__ __forceinline__ bool hash_find(const HashLm& hl, int i, uint32_t h1, uint32_t h2,
                                          float* val) {
  const int nt = 2 * hl.order - 3;
  const int* row = reinterpret_cast<const int*>(__ldg(hl.tables + i)) +
                   (size_t)(h1 & (uint32_t)__ldg(hl.tables + nt + i)) * 32;
  const int4 a = __ldg(reinterpret_cast<const int4*>(row));
  const int4 b = __ldg(reinterpret_cast<const int4*>(row) + 1);
  const int k1[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
  bool found = false;
  float v = 0.0f;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    if (k1[j] == (int)h1 && __ldg(row + 8 + j) == (int)h2) {
      found = true;
      v = __fadd_rn(v, __int_as_float(__ldg(row + 16 + j)));
    }
  }
  *val = v;
  return found;
}

// A carried search's state in device memory (the kCarry forms: a chunk of a
// stream, started from the state the last chunk handed on), passed to the
// kernel by value.  Its 22 pointers, in the order of the host array the C
// entries take (ops/beam_cuda.py::carry_table): the beams' fields before
// the chunk in BeamState's order, tokens (B, K, L), length, pb, pnb, lm_s,
// hash, ctx, last (B, K); the same after it (tokens into another buffer:
// new beams read their ancestors' rows); and K9's LM state of each beam
// before and after, h and c (nl, B, K, H) and logp (B, K, V) (null for K7
// and K8).
struct BeamCarry {
  const int* tokens;
  const int* len;
  const float *pb, *pnb, *lms;
  const int *hsh, *ctx, *last;
  int* tokens_o;
  int* len_o;
  float *pb_o, *pnb_o, *lms_o;
  int *hsh_o, *ctx_o, *last_o;
  const float *h, *c, *lmp;
  float *h_o, *c_o, *lmp_o;
};
static_assert(sizeof(BeamCarry) == 22 * sizeof(void*), "BeamCarry: 22 pointers");

// The kernels' last parameter: the trace, or for kCarry (which takes no
// trace) the BeamCarry.  The forms without the flag keep their parameters.
template <bool kCarry>
using TraceOr = std::conditional_t<kCarry, BeamCarry, long long*>;

// The block kernel's LM parameter: the hashed tables for kHash, else K9's
// RNN LM (unread by K7 and K8 without the hashed source).
template <bool kHash>
using LmOf = std::conditional_t<kHash, HashLm, RnnLm>;

// A C entry's carry (a host array of 22 pointers) as the struct.
inline BeamCarry beam_carry(const void* const* carry) {
  BeamCarry cy;
  std::memcpy(&cy, carry, sizeof cy);
  return cy;
}

// Every beam before the first frame: beam 0 the empty prefix, the rest dead.
__device__ __forceinline__ void search_init(const SearchWs& w, int K, int tid, int nt) {
  for (int r = tid; r < K; r += nt) {  // a thread a beam; more beams loop
    w.pb[r] = r == 0 ? 0.0f : NEG_INF;
    w.pnb[r] = NEG_INF;
    w.lms[r] = 0.0f;
    w.hsh[r] = (uint32_t)(-(r + 1));
    w.last[r] = -1;
    w.len[r] = 0;
    w.ctx[r] = 0;
  }
}

// The carried form's start: utterance b's beams as the state holds them,
// into buffer 0 (dead beams keep their hashes).  kCtx false (the hashed
// forms, which read their windows themselves): no context id.
template <bool kCtx = true>
__device__ __forceinline__ void carry_in(const SearchWs& w, const BeamCarry& cy, int b, int K,
                                         int tid, int nt) {
  for (int r = tid; r < K; r += nt) {
    const size_t at = (size_t)b * K + r;
    w.pb[r] = cy.pb[at];
    w.pnb[r] = cy.pnb[at];
    w.lms[r] = cy.lms[at];
    w.hsh[r] = (uint32_t)cy.hsh[at];
    w.last[r] = cy.last[at];
    w.len[r] = cy.len[at];
    w.ctx[r] = kCtx ? cy.ctx[at] : 0;
  }
}

// Frame `row`'s logp row (and K8's top-A values and ids) into the working
// set; K8 clears its char -> slot map.  The caller synchronises.
template <bool kTopA>
__device__ __forceinline__ void load_row(const SearchWs& w, const SearchIn& s, size_t row,
                                         int tid, int nt) {
  for (int v = tid; v < s.V; v += nt) {
    w.lp[v] = s.logp[row * s.V + v];
    if (kTopA) w.slot[v] = -1;
  }
  if constexpr (kTopA) {
    for (int a = tid; a < s.C; a += nt) {
      w.tv[a] = s.top_val[row * s.C + a];
      w.ti[a] = s.top_idx[row * s.C + a];
    }
  }
}

// The next frame's row into the same buffers while the frame's later
// phases run: by cp.async where they are shared memory (waited for before
// the frame's last barrier), else by plain loads.
template <bool kTopA, bool kAsync>
__device__ __forceinline__ void fetch_row(const SearchWs& w, const SearchIn& s, size_t row,
                                          int tid, int nt) {
  if constexpr (kAsync) {
    for (int v = tid; v < s.V; v += nt)
      asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(smem_addr(w.lp + v)),
                   "l"(s.logp + row * s.V + v)
                   : "memory");
    if constexpr (kTopA) {
      for (int a = tid; a < s.C; a += nt) {
        asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(smem_addr(w.tv + a)),
                     "l"(s.top_val + row * s.C + a)
                     : "memory");
        asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(smem_addr(w.ti + a)),
                     "l"(s.top_idx + row * s.C + a)
                     : "memory");
      }
    }
    cp_async_commit();
  } else {
    for (int v = tid; v < s.V; v += nt) w.lp[v] = s.logp[row * s.V + v];
    if constexpr (kTopA) {
      for (int a = tid; a < s.C; a += nt) {
        w.tv[a] = s.top_val[row * s.C + a];
        w.ti[a] = s.top_idx[row * s.C + a];
      }
    }
  }
}

// One frame t < n_t of utterance b's search, from the fields of buffer
// `cur` to those of cur ^ 1, by all threads of the block (or CTA).
// lm_rows: K9's log-prob rows, beam k's at row k, or with lm_slot at row
// lm_slot[k]; else null.  par and app (K9): each pick's parent and appended
// char (-1 for none).  tr: this frame's trace row (block 0's thread 0) or
// null: the global clock, then the clock at the frame's start and after its
// row (in by then), extensions, absorb, selection (keys, sort and the merge
// tree or ranks) and picks (warp 0's picks and the next row's wait).
// On entry the working set holds frame t's row and, for K8, a cleared char
// -> slot map; on return, frame t + 1's.
// kHash: the LM is the hashed tables `hl`, the windows and levels in `hw`.
template <bool kTopA, bool kRnn, bool kInScratch, bool kHash = false>
__device__ __forceinline__ void search_frame(const SearchWs& w, const SearchIn& s, int b, int t,
                                             int n_t, int cur, const float* lm_rows,
                                             const int* lm_slot, int* par, int* app,
                                             long long* tr, int tid, int nt,
                                             const HashLm* hl = nullptr,
                                             const HashWs* hw = nullptr) {
  const int K = s.K, C = s.C, V = s.V, KC = K * C, N = K + KC;
  const float *pb_c = w.pb + cur * K, *pnb_c = w.pnb + cur * K, *lms_c = w.lms + cur * K;
  const uint32_t* hsh_c = w.hsh + cur * K;
  const int *last_c = w.last + cur * K, *len_c = w.len + cur * K, *ctx_c = w.ctx + cur * K;
  const size_t row = (size_t)b * s.T + t;
  if (tr) {
    tr[0] = (long long)global_ns();
    tr[1] = clock64();
  }
  const int W = kHash ? hl->order - 1 : 0;
  if constexpr (kHash) {
    // Each beam's context levels, a thread a (beam, level): level n = l + 2
    // reads the window's last m = n - 1 ids; the backoff of a context of
    // one id is uni_bo's, of more a lookup in backoff table m - 2.  With
    // lm_top_k, the frame's top chars are stamped with t in the slot map.
    const int* win_c = hw->win + cur * K * W;
    for (int i = tid; i < K * W; i += nt) {
      const int k = i / W, m = i - k * W + 1;
      const int* suf = win_c + k * W + (W - m);
      uint32_t h1 = kBasis1, h2 = kBasis2;
      bool valid = true;
      for (int j = 0; j < m; ++j) {
        valid = valid && suf[j] != 0;
        fold(h1, h2, suf[j]);
      }
      float bo;
      bool found = true;
      if (m == 1) {
        bo = __ldg(hl->uni_bo + min(max(suf[0], 0), V - 1));
      } else {
        found = hash_find(*hl, (W) + m - 2, h1, h2, &bo);
      }
      hw->h1[i] = h1;
      hw->h2[i] = h2;
      hw->bo[i] = valid && found ? bo : 0.0f;
      hw->valid[i] = valid;
    }
    if (!kTopA && hl->exact != nullptr) {
      for (int a = tid; a < hl->n_exact; a += nt) w.slot[hl->exact[row * hl->n_exact + a]] = t;
    }
    __syncthreads();
  }
  if (tr) tr[2] = clock64();

  // Stays (a thread a beam) and extensions (a thread a lane).
  for (int r = tid; r < K; r += nt) {
    const float total = lse(pb_c[r], pnb_c[r]);
    w.spb[r] = total + w.lp[0];
    w.spnb[r] = last_c[r] >= 0 ? pnb_c[r] + w.lp[last_c[r]] : NEG_INF;
  }
  for (int lane = tid; lane < KC; lane += nt) {
    const int k = lane / C, a = lane - k * C;
    int c;
    float lpc;
    if (kTopA) {
      c = w.ti[a];
      lpc = w.tv[a];
      if (k == 0) w.slot[c] = a;
    } else {
      c = a;
      lpc = w.lp[c];
    }
    const float total = lse(pb_c[k], pnb_c[k]);
    float e = (c == last_c[k] ? pb_c[k] : total) + lpc;
    if (len_c[k] >= s.L || c == 0) e = NEG_INF;  // beam full, or the blank
    w.epnb[lane] = e;
    float l = lms_c[k];
    if constexpr (kHash) {
      // The hashed row's entry for c, bottom-up: the unigram, then at each
      // level the n-gram's log-prob where the level is valid and the table
      // holds it, else the context's backoff plus the level below (every
      // level a backoff for a char outside lm_top_k's set).
      const bool exact = kTopA || hl->exact == nullptr || w.slot[c] == t;
      float sc = __ldg(hl->uni + min(max(c, 0), V - 1));
      for (int j = 0; j < W; ++j) {
        const int i = k * W + j;
        float v;
        bool hit = false;
        if (exact && hw->valid[i]) {
          uint32_t h1 = hw->h1[i], h2 = hw->h2[i];
          fold(h1, h2, c);
          hit = hash_find(*hl, j, h1, h2, &v);
        }
        sc = hit ? v : __fadd_rn(hw->bo[i], sc);
      }
      l = __fadd_rn(l, __fadd_rn(__fmul_rn(s.alpha, sc), s.beta));
    } else {
      // The beam's LM row: K9's log-probs, else the table's context row.
      const float* lm_row =
          kRnn ? lm_rows + (lm_slot != nullptr ? lm_slot[k] : k) * V
               : (s.table != nullptr ? s.table + (size_t)ctx_c[k] * V : nullptr);
      if (lm_row != nullptr) l = __fadd_rn(l, __fadd_rn(__fmul_rn(s.alpha, lm_row[c]), s.beta));
    }
    w.elm[lane] = l;  // no FMA on the fusion line
    w.absorbed[lane] = 0;
  }
  __syncthreads();
  if (tr) tr[3] = clock64();
  if (t + 1 < n_t) fetch_row<kTopA, !kInScratch>(w, s, row + 1, tid, nt);

  // Absorb: the char that would turn beam k into alive stay k' is
  // c = h_k' - M h_k (mod 2^32); at most one lane of each beam k matches.
  // Where a stay's K tests fit a warp's aligned kp lanes and all K stays'
  // fit the block, a thread a test, the max and the sum by shuffles (the
  // prefixes are distinct, so a stay matches one lane at most and the sum
  // has one term); else a thread a stay.
  int kp = 1;
  while (kp < K) kp <<= 1;
  if (kp <= 32 && K * kp <= nt) {
    if ((tid >> 5) * 32 < K * kp) {  // warp-uniform: every lane shuffles
      const int r = min(tid / kp, K - 1), k = tid - (tid / kp) * kp;
      const bool mine = tid < K * kp && k < K;
      const float sn = w.spnb[r];
      float e = NEG_INF;
      bool hit = false;
      if (mine && lse(w.spb[r], sn) > NEG_INF / 2) {
        const uint32_t c = hsh_c[r] - HASH_MULT * hsh_c[k];
        const int sl = (c >= 1u && c < (uint32_t)V) ? (kTopA ? w.slot[c] : (int)c) : -1;
        if (sl >= 0) {
          w.absorbed[k * C + sl] = 1;
          e = w.epnb[k * C + sl];
          hit = true;
        }
      }
      float m = e;
      for (int o = kp >> 1; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
      float sum = hit && m > NEG_INF / 2 ? expf(e - m) : 0.0f;
      for (int o = kp >> 1; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
      if (mine && k == 0) w.spnb[r] = lse(sn, m > NEG_INF / 2 ? m + logf(sum) : NEG_INF);
    }
  } else {
    for (int r = tid; r < K; r += nt) {
      const float sn = w.spnb[r];
      float add = NEG_INF;
      if (lse(w.spb[r], sn) > NEG_INF / 2) {
        const uint32_t h2 = hsh_c[r];
        float m = NEG_INF;
        for (int k = 0; k < K; ++k) {
          const uint32_t c = h2 - HASH_MULT * hsh_c[k];
          const int sl = (c >= 1u && c < (uint32_t)V) ? (kTopA ? w.slot[c] : (int)c) : -1;
          if (sl >= 0) {
            w.absorbed[k * C + sl] = 1;
            m = fmaxf(m, w.epnb[k * C + sl]);
          }
        }
        if (m > NEG_INF / 2) {
          float sum = 0.0f;
          for (int k = 0; k < K; ++k) {
            const uint32_t c = h2 - HASH_MULT * hsh_c[k];
            const int sl = (c >= 1u && c < (uint32_t)V) ? (kTopA ? w.slot[c] : (int)c) : -1;
            if (sl >= 0) sum += expf(w.epnb[k * C + sl] - m);
          }
          add = m + logf(sum);
        }
      }
      w.spnb[r] = lse(sn, add);
    }
  }
  __syncthreads();
  if (tr) tr[4] = clock64();

  // Selection keys: stays are candidates 0..K-1, lane (k, a) is K + k*C + a.
  auto key_of = [&](int j) {
    float sc;
    if (j < K) {
      sc = lse(w.spb[j], w.spnb[j]) + lms_c[j];
    } else {
      const int lane = j - K;
      sc = w.absorbed[lane] ? NEG_INF : w.epnb[lane] + w.elm[lane];
    }
    return make_key(sc, j);
  };
  // Pick r (key `pick`) becomes next beam r; its backpointers are recorded.
  auto take = [&](int r, unsigned long long pick) {
    const int j = key_index(pick), nx = (cur ^ 1) * K + r;
    int k, append;
    if (j < K) {
      k = j;
      append = -1;
      w.pb[nx] = w.spb[k];
      w.pnb[nx] = w.spnb[k];
      w.lms[nx] = lms_c[k];
      w.hsh[nx] = hsh_c[k];
      w.ctx[nx] = ctx_c[k];
      w.last[nx] = last_c[k];
      w.len[nx] = len_c[k];
    } else {
      const int lane = j - K;
      k = lane / C;
      const int a = lane - k * C;
      const int c = kTopA ? s.top_idx[row * C + a] : a;
      append = c;
      w.pb[nx] = NEG_INF;
      w.pnb[nx] = w.epnb[lane];
      w.lms[nx] = w.elm[lane];
      w.hsh[nx] = hsh_c[k] * HASH_MULT + (uint32_t)c;
      w.ctx[nx] = s.table != nullptr
                      ? floor_mod((int)((uint32_t)ctx_c[k] * (uint32_t)V + (uint32_t)c), s.n_ctx)
                      : ctx_c[k];
      w.last[nx] = c;
      w.len[nx] = len_c[k] + 1;
    }
    if constexpr (kHash) {  // the parent's window, shifted by c where it appends
      const int* from = hw->win + (cur * K + k) * W;
      int* to = hw->win + nx * W;
      if (append < 0) {
        for (int i = 0; i < W; ++i) to[i] = from[i];
      } else {
        for (int i = 0; i + 1 < W; ++i) to[i] = from[i + 1];
        to[W - 1] = append;
      }
    }
    if (key_score(pick) <= NEG_INF / 2) {  // a dead filler
      w.pb[nx] = NEG_INF;
      w.pnb[nx] = NEG_INF;
      w.hsh[nx] = (uint32_t)(-(r + 1));
    }
    if constexpr (kRnn) {
      par[r] = k;
      app[r] = append;
    }
    s.parents[row * K + r] = k;
    s.appends[row * K + r] = append;
  };

  // Segments of 32 keys where the warps suffice (the rest idle in the
  // sort), else one a warp.  With K <= 32 and segments of at least K keys
  // the sorted segments' tops merge in a tree; else each key is ranked.
  const int nw = min(nt >> 5, (N + 31) >> 5), warp = tid >> 5, lane = tid & 31;
  const int seg = (N + nw - 1) / nw;
  const bool tree = K <= 32 && seg >= K;
  {
    const int s0 = warp * seg, sn = seg_len(warp, seg, N);
    // The tree reads K keys of every segment: a short last one gets 0s
    // (below every key) up to K, past N into the room after the keys.
    const int keep = tree && warp < nw ? max(sn, K) : sn;
    if (seg <= 32) {  // a key a lane, sorted in registers (0 past sn)
      const unsigned long long v = warp_sort_desc_reg(lane < sn ? key_of(s0 + lane) : 0ull,
                                                      sn, lane);
      if (lane < keep) w.key[s0 + lane] = v;
    } else {
      for (int j = s0 + lane; j < s0 + sn; j += 32) w.key[j] = key_of(j);
      __syncwarp();
      warp_sort_desc(w.key + s0, sn, lane);
      if (lane < keep - sn) w.key[s0 + sn + lane] = 0ull;
    }
  }
  __syncthreads();
  if (tree) {
    const unsigned long long v = merge_tree(w.key, nw, seg, K, warp, lane);
    if (tr) tr[5] = clock64();
    if (warp == 0 && lane < K) take(lane, v);
  } else {
    // Rank: only the first K keys of a segment can be picks, and none
    // below theta, the largest K-th key of a segment that has K (K keys
    // are at least it).  A key's rank is the count of keys above it in
    // every segment, its own included (there: its position).
    const int top = min(K, seg);
    int P = 1;
    while (P < top) P <<= 1;
    unsigned long long theta = 0;
    for (int o = 0; o < nw; ++o) {
      if (seg_len(o, seg, N) >= K) theta = umax(theta, w.key[o * seg + K - 1]);
    }
    for (int e = tid; e < nw * top; e += nt) {
      const int sw = e / top, p = e - sw * top;
      if (p >= seg_len(sw, seg, N)) continue;
      const unsigned long long x = w.key[sw * seg + p];
      if (x < theta) continue;
      int rank = 0;
      for (int o = 0; o < nw; ++o)
        rank += count_above(w.key + o * seg, min(top, seg_len(o, seg, N)), P, x);
      if (rank < K) take(rank, x);
    }
    if (tr) tr[5] = clock64();
  }
  if constexpr (kTopA) {  // the next frame's extensions fill it again
    for (int v = tid; v < V; v += nt) w.slot[v] = -1;
  }
  if constexpr (!kInScratch) cp_async_wait<0>();
  __syncthreads();
  if (tr) tr[6] = clock64();
}

// The best beam of utterance b after its n_t frames (fields in buffer cur):
// score, length, and its tokens from the backpointers.  All threads call it.
__device__ __forceinline__ void finish_search(const SearchWs& w, const SearchIn& s, int b, int n_t, int cur,
                              int* tokens, int* out_len, float* out_score, int tid, int nt) {
  const int K = s.K, L = s.L, T = s.T;
  for (int i = tid; i < L; i += nt) tokens[(size_t)b * L + i] = 0;
  __syncthreads();
  if (tid == 0) {
    const float *pb_c = w.pb + cur * K, *pnb_c = w.pnb + cur * K, *lms_c = w.lms + cur * K;
    int best = 0;
    float bs = lse(pb_c[0], pnb_c[0]) + lms_c[0];
    for (int k = 1; k < K; ++k) {
      const float sc = lse(pb_c[k], pnb_c[k]) + lms_c[k];
      if (sc > bs) {
        bs = sc;
        best = k;
      }
    }
    out_score[b] = bs;
    out_len[b] = w.len[cur * K + best];
    // Count the chain's appends, then write them left-packed (at most L).
    int count = 0;
    for (int t = n_t - 1, k = best; t >= 0; --t) {
      const size_t at = ((size_t)b * T + t) * K + k;
      count += s.appends[at] >= 0;
      k = s.parents[at];
    }
    for (int t = n_t - 1, k = best, pos = count - 1; t >= 0; --t) {
      const size_t at = ((size_t)b * T + t) * K + k;
      if (s.appends[at] >= 0) {
        if (pos < L) tokens[(size_t)b * L + pos] = s.appends[at];
        --pos;
      }
      k = s.parents[at];
    }
  }
}

// The carried form's end for utterance b after its n_t frames (fields in
// buffer cur): every beam's fields into the state handed on, and its
// tokens: its ancestor's carried row (the beam it descends from at the
// chunk's start, found by walking the backpointers; kept in the key array,
// free after the last frame) with the chunk's appends written over it from
// the ancestor's length on, below L, as the plain search writes each at its
// parent's length; then the best beam (the first of equal scores, as
// finish_search picks it) and its new row.  All threads call it.  kCtx
// false (the hashed forms, whose ctx is a window the caller writes): no
// context id.
template <bool kCtx = true>
__device__ __forceinline__ void carry_out(const SearchWs& w, const SearchIn& s,
                                          const BeamCarry& cy, int b, int n_t, int cur,
                                          int* tokens, int* out_len, float* out_score, int tid,
                                          int nt) {
  const int K = s.K, L = s.L, T = s.T;
  int* anc = reinterpret_cast<int*>(w.key);
  const float *pb_c = w.pb + cur * K, *pnb_c = w.pnb + cur * K, *lms_c = w.lms + cur * K;
  for (int r = tid; r < K; r += nt) {
    int k = r;
    for (int t = n_t - 1; t >= 0; --t) k = s.parents[((size_t)b * T + t) * K + k];
    anc[r] = k;
    const size_t at = (size_t)b * K + r;
    cy.pb_o[at] = pb_c[r];
    cy.pnb_o[at] = pnb_c[r];
    cy.lms_o[at] = lms_c[r];
    cy.hsh_o[at] = (int)w.hsh[cur * K + r];
    cy.last_o[at] = w.last[cur * K + r];
    cy.len_o[at] = w.len[cur * K + r];
    if constexpr (kCtx) cy.ctx_o[at] = w.ctx[cur * K + r];
  }
  __syncthreads();
  const size_t row0 = (size_t)b * K * L;
  for (int e = tid; e < K * L; e += nt) {
    const int r = e / L;
    cy.tokens_o[row0 + e] = cy.tokens[row0 + (size_t)anc[r] * L + (e - r * L)];
  }
  __syncthreads();
  for (int r = tid; r < K; r += nt) {
    for (int t = n_t - 1, k = r, pos = w.len[cur * K + r] - 1; t >= 0; --t) {
      const size_t at = ((size_t)b * T + t) * K + k;
      if (s.appends[at] >= 0) {
        if (pos >= 0 && pos < L) cy.tokens_o[row0 + (size_t)r * L + pos] = s.appends[at];
        --pos;
      }
      k = s.parents[at];
    }
  }
  __syncthreads();
  int best = 0;
  float bs = lse(pb_c[0], pnb_c[0]) + lms_c[0];
  for (int k = 1; k < K; ++k) {
    const float sc = lse(pb_c[k], pnb_c[k]) + lms_c[k];
    if (sc > bs) {
      bs = sc;
      best = k;
    }
  }
  if (tid == 0) {
    out_score[b] = bs;
    out_len[b] = w.len[cur * K + best];
  }
  for (int i = tid; i < L; i += nt)
    tokens[(size_t)b * L + i] = cy.tokens_o[row0 + (size_t)best * L + i];
}

__device__ __forceinline__ float sigmoid(float x) { return 1.0f / (1.0f + expf(-x)); }

// a[gate][q] += x.q * w[gate] for the four beams q of a packed group.
__device__ __forceinline__ void fma_group(float (&a)[4][4], float4 x, float w0, float w1,
                                          float w2, float w3) {
  const float xs[4] = {x.x, x.y, x.z, x.w};
  const float ws[4] = {w0, w1, w2, w3};
#pragma unroll
  for (int gate = 0; gate < 4; ++gate) {
#pragma unroll
    for (int q = 0; q < 4; ++q) a[gate][q] = fmaf(xs[q], ws[gate], a[gate][q]);
  }
}

// Packs the inputs of layer l's step, or with l == nl those of the output
// product: xin[(g * W' + i) * 4 + q] is input i of packed beam p = 4 g + q,
// where the first In entries are the layer's input (embed[c] for layer 0,
// else the beam's new h of layer l - 1) and, below the output product, the
// next H are its parent's h of layer l.  Beams past n_app read zeros.
__device__ void pack_inputs(const RnnLm& lm, const LmSmem& s, int l, int K, int groups,
                            const float* h_cur, const float* h_nxt, int tid, int nt) {
  const int H = lm.H, n = *s.n_app;
  const int In = l == 0 ? lm.E : H, W = In + (l < lm.nl ? H : 0);
  for (int idx = tid; idx < groups * W * 4; idx += nt) {
    const int q = idx & 3, i = (idx >> 2) % W, p = 4 * ((idx >> 2) / W) + q;
    float v = 0.0f;
    if (p < n) {
      const int r = s.rows[p];
      if (i >= In) {
        v = h_cur[((size_t)l * K + s.par[r]) * H + (i - In)];
      } else if (l == 0) {
        v = lm.embed[(size_t)s.app[r] * In + i];
      } else {
        v = h_nxt[((size_t)(l - 1) * K + r) * H + i];
      }
    }
    s.xin[idx] = v;
  }
}

// One LSTM layer for the packed beams: a work item is (hidden unit j,
// group g); its sixteen gate sums stay in registers.
__device__ void lstm_layer(const RnnLm& lm, const LmSmem& s, int l, int K, int groups,
                           const float* c_cur, float* h_nxt, float* c_nxt, int tid, int nt) {
  const int H = lm.H, n = *s.n_app, In = l == 0 ? lm.E : H, W = In + H;
  const float *wx = lm.wx(l), *wh = lm.wh(l), *bias = lm.b(l);
  const float4* xin = reinterpret_cast<const float4*>(s.xin);
  for (int it = tid; it < H * groups; it += nt) {
    const int j = it % H, g = it / H;
    const float4* x = xin + (size_t)g * W;
    float a[4][4] = {};
#pragma unroll 4
    for (int i = 0; i < In; ++i) {
      const float* w = wx + (size_t)i * 4 * H + j;
      fma_group(a, x[i], __ldg(w), __ldg(w + H), __ldg(w + 2 * H), __ldg(w + 3 * H));
    }
#pragma unroll 4
    for (int i = 0; i < H; ++i) {
      const float* w = wh + (size_t)i * 4 * H + j;
      fma_group(a, x[In + i], __ldg(w), __ldg(w + H), __ldg(w + 2 * H), __ldg(w + 3 * H));
    }
    const float bi = bias[j], bf = bias[H + j], bg = bias[2 * H + j], bo = bias[3 * H + j];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int p = 4 * g + q;
      if (p < n) {
        const int r = s.rows[p];
        const float cp = c_cur[((size_t)l * K + s.par[r]) * H + j];
        const float c_new = sigmoid(a[1][q] + bf + 1.0f) * cp +
                            sigmoid(a[0][q] + bi) * tanhf(a[2][q] + bg);
        const size_t at = ((size_t)l * K + r) * H + j;
        c_nxt[at] = c_new;
        h_nxt[at] = sigmoid(a[3][q] + bo) * tanhf(c_new);
      }
    }
  }
}

// Logits of the packed beams, h_top w_out + b_out: a work item is (char v,
// group g).
__device__ void lm_logits(const RnnLm& lm, const LmSmem& s, int V, int groups, float* lmp_nxt,
                          int tid, int nt) {
  const int H = lm.H, n = *s.n_app;
  const float4* xin = reinterpret_cast<const float4*>(s.xin);
  for (int it = tid; it < V * groups; it += nt) {
    const int v = it % V, g = it / V;
    const float4* x = xin + (size_t)g * H;
    float a0 = 0.0f, a1 = 0.0f, a2 = 0.0f, a3 = 0.0f;
#pragma unroll 4
    for (int i = 0; i < H; ++i) {
      const float w = __ldg(lm.w_out + (size_t)i * V + v);
      const float4 xv = x[i];
      a0 = fmaf(xv.x, w, a0);
      a1 = fmaf(xv.y, w, a1);
      a2 = fmaf(xv.z, w, a2);
      a3 = fmaf(xv.w, w, a3);
    }
    const float acc[4] = {a0, a1, a2, a3};
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      if (4 * g + q < n) lmp_nxt[s.rows[4 * g + q] * V + v] = acc[q] + lm.b_out[v];
    }
  }
}

// Log-softmax of each packed beam's logits in place, a warp a row:
// x - (max + log(sum(exp(x - max)))).
__device__ void log_softmax_rows(const LmSmem& s, int V, float* lmp_nxt, int tid, int nt) {
  const int lane = tid & 31, n = *s.n_app;
  for (int p = tid >> 5; p < n; p += nt >> 5) {
    float* row = lmp_nxt + s.rows[p] * V;
    float m = -3.402823466e38f;
    for (int v = lane; v < V; v += 32) m = fmaxf(m, row[v]);
    for (int o = 16; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
    float sum = 0.0f;
    for (int v = lane; v < V; v += 32) sum += expf(row[v] - m);
    for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
    const float lse_row = m + logf(sum);
    for (int v = lane; v < V; v += 32) row[v] -= lse_row;
  }
}

// Advances every new beam's LM state after the picks (s.par, s.app): the
// parent's state as it is for a beam that did not append; for the others
// nl LSTM layers from the parent's (h, c) with embed[c], then the log-prob
// row.  The caller synchronises after.
__device__ void advance_lm(const RnnLm& lm, const LmSmem& s, int cur, int K, int V, int tid,
                           int nt) {
  const int H = lm.H, nl = lm.nl, KH = K * H;
  const float* h_cur = s.h + (size_t)cur * nl * KH;
  const float* c_cur = s.c + (size_t)cur * nl * KH;
  const float* lmp_cur = s.lmp + (size_t)cur * K * V;
  float* h_nxt = s.h + (size_t)(cur ^ 1) * nl * KH;
  float* c_nxt = s.c + (size_t)(cur ^ 1) * nl * KH;
  float* lmp_nxt = s.lmp + (size_t)(cur ^ 1) * K * V;
  if (tid == 0) {
    int n = 0;
    for (int r = 0; r < K; ++r) {
      if (s.app[r] >= 0) s.rows[n++] = r;
    }
    *s.n_app = n;
  }
  for (int idx = tid; idx < nl * KH; idx += nt) {
    const int l = idx / KH, r = (idx / H) % K;
    if (s.app[r] < 0) {
      const size_t from = ((size_t)l * K + s.par[r]) * H + idx % H;
      h_nxt[idx] = h_cur[from];
      c_nxt[idx] = c_cur[from];
    }
  }
  for (int idx = tid; idx < K * V; idx += nt) {
    const int r = idx / V;
    if (s.app[r] < 0) lmp_nxt[idx] = lmp_cur[s.par[r] * V + idx % V];
  }
  __syncthreads();
  const int n = *s.n_app;
  if (n == 0) return;
  const int groups = (n + 3) / 4;
  for (int l = 0; l <= nl; ++l) {
    pack_inputs(lm, s, l, K, groups, h_cur, h_nxt, tid, nt);
    __syncthreads();
    if (l < nl) {
      lstm_layer(lm, s, l, K, groups, c_cur, h_nxt, c_nxt, tid, nt);
    } else {
      lm_logits(lm, s, V, groups, lmp_nxt, tid, nt);
    }
    __syncthreads();
  }
  log_softmax_rows(s, V, lmp_nxt, tid, nt);
}


// A search's threads: a thread a candidate (K stays and K*C lanes), and
// at least K kp (kp = K to a power of two, K <= 32) for the absorb's tests,
// to 32, at most 1024 (past that the phases loop).
int search_threads(int K, int C) {
  long long n = (long long)K + (long long)K * C;
  int kp = 1;
  while (kp < K) kp <<= 1;
  if (kp <= 32 && (long long)K * kp > n) n = (long long)K * kp;
  return n >= 1024 ? 1024 : (int)(n + 31) / 32 * 32;
}

// K7, K8 and K9's block form: one block per utterance with the time loop
// inside (the beam is a serial chain over frames).  trace (K7, K8; null
// for none): block 0's clocks of each frame, (T, 7) as search_frame
// records them.  kCarry: a chunk of a stream, which takes its BeamCarry
// where the others take the trace: every beam starts as the carry's state
// holds it (K9: its own LM state), and the state after the chunk, every
// beam's tokens included, goes back there.
// kHash (K7, K8): the LM is the hashed tables, `lm` a HashLm; each beam's
// context is its window of the last order - 1 ids, in the HashWs past the
// search's working set, and for kCarry the state's ctx is (B, K, order - 1).
template <bool kTopA, bool kRnn, int kPlace, bool kCarry = false, bool kHash = false>
__global__ void __launch_bounds__(1024) prefix_beam_kernel(
    SearchIn s, const int* __restrict__ lens, int* __restrict__ tokens,
    int* __restrict__ out_len, float* __restrict__ out_score, LmOf<kHash> lm, float* scratch,
    TraceOr<kCarry> trace) {
  const int K = s.K, C = s.C, V = s.V;
  extern __shared__ __align__(16) unsigned long long smem[];
  // The working set's base: shared memory, or (kInScratch) this block's
  // slice of the scratch.
  unsigned long long* base = smem;
  if constexpr (kPlace == kInScratch && kHash) {
    base = reinterpret_cast<unsigned long long*>(
        reinterpret_cast<char*>(scratch) +
        (size_t)blockIdx.x * hashed_block_bytes(K, C, V, lm.order - 1));
  } else if constexpr (kPlace == kInScratch) {
    char* slice = reinterpret_cast<char*>(scratch) +
                  (size_t)blockIdx.x * scratch_block_bytes(K, C, V, kRnn, lm.nl, lm.E, lm.H);
    base = reinterpret_cast<unsigned long long*>(slice);
  }
  const SearchWs w = search_ws(base, K, C, V);
  HashWs hw = {};
  int W = 0;
  if constexpr (kHash) {
    W = lm.order - 1;
    hw = hash_ws(base, K, C, V, W);
  }
  LmSmem rnn = {};                                        // K9's LM state
  if constexpr (kRnn) {
    // The state follows xin in the working set, or (kLmStateInScratch: it
    // does not fit beside the search) lies in this block's slice of the
    // wrapper's scratch.  The same LM code reads it either way; the place is
    // a template parameter because with generic pointers in the shared case
    // K9 ran slower on the H100.
    constexpr bool kStateApart = kPlace == kLmStateInScratch;
    char* at = reinterpret_cast<char*>(base) + lm_smem_offset(K, C, V);
    rnn.xin = reinterpret_cast<float*>(at);
    float* after_xin = rnn.xin + lm_xin_floats(K, lm.E, lm.H);
    if constexpr (kStateApart) {
      rnn.h = scratch + (size_t)blockIdx.x * lm_state_floats(K, V, lm.nl, lm.H);
    } else {
      rnn.h = after_xin;
    }
    rnn.c = rnn.h + 2 * (size_t)lm.nl * K * lm.H;
    rnn.lmp = rnn.c + 2 * (size_t)lm.nl * K * lm.H;
    rnn.par = reinterpret_cast<int*>(kStateApart ? after_xin : rnn.lmp + 2 * (size_t)K * V);
    rnn.app = rnn.par + K;
    rnn.rows = rnn.app + K;
    rnn.n_app = rnn.rows + K;
  }

  const int b = blockIdx.x, tid = threadIdx.x, nt = blockDim.x;
  const int n_t = min(max(lens[b], 0), s.T);
  if constexpr (kHash) {
    // The windows (the carry's (B, K, W) ctx, or zeros: no history), and
    // K7's slot map cleared for lm_top_k's frame stamps.
    for (int i = tid; i < K * W; i += nt) {
      if constexpr (kCarry) {
        hw.win[i] = trace.ctx[(size_t)b * K * W + i];
      } else {
        hw.win[i] = 0;
      }
    }
    if constexpr (!kTopA) {
      for (int v = tid; v < V; v += nt) w.slot[v] = -1;
    }
  }
  if constexpr (kCarry) {
    const BeamCarry& cy = trace;
    carry_in<!kHash>(w, cy, b, K, tid, nt);
    if constexpr (kRnn) {  // beam k's LM state, (nl, B, K, H) in the carry
      const int KH = K * lm.H;
      for (int idx = tid; idx < lm.nl * KH; idx += nt) {
        const int l = idx / KH;
        const size_t at = ((size_t)l * gridDim.x + b) * KH + (idx - l * KH);
        rnn.h[idx] = cy.h[at];
        rnn.c[idx] = cy.c[at];
      }
      for (int idx = tid; idx < K * V; idx += nt) rnn.lmp[idx] = cy.lmp[(size_t)b * K * V + idx];
    }
  } else {
    search_init(w, K, tid, nt);
    if constexpr (kRnn) {  // every beam starts from the state after <sos>
      for (int idx = tid; idx < lm.nl * K * lm.H; idx += nt) {
        const int at = (idx / (K * lm.H)) * lm.H + idx % lm.H;
        rnn.h[idx] = lm.h0[at];
        rnn.c[idx] = lm.c0[at];
      }
      for (int idx = tid; idx < K * V; idx += nt) rnn.lmp[idx] = lm.lmp0[idx % V];
    }
  }
  // The first frame's row; later ones come in ahead.
  if (n_t > 0) load_row<kTopA>(w, s, (size_t)b * s.T, tid, nt);
  __syncthreads();
  int cur = 0;
  for (int t = 0; t < n_t; ++t) {
    long long* tr = nullptr;
    if constexpr (!kCarry)
      tr = trace != nullptr && b == 0 && tid == 0 ? trace + 7 * (size_t)t : nullptr;
    if constexpr (kHash) {
      search_frame<kTopA, false, kPlace == kInScratch, true>(w, s, b, t, n_t, cur, nullptr,
                                                             nullptr, nullptr, nullptr, tr, tid,
                                                             nt, &lm, &hw);
    } else {
      search_frame<kTopA, kRnn, kPlace == kInScratch>(
          w, s, b, t, n_t, cur, kRnn ? rnn.lmp + (size_t)cur * K * V : nullptr, nullptr,
          rnn.par, rnn.app, tr, tid, nt);
    }
    if constexpr (kRnn) {
      advance_lm(lm, rnn, cur, K, V, tid, nt);
      __syncthreads();
    }
    cur ^= 1;
  }
  if constexpr (kCarry) {
    const BeamCarry& cy = trace;
    carry_out<!kHash>(w, s, cy, b, n_t, cur, tokens, out_len, out_score, tid, nt);
    if constexpr (kHash) {  // each beam's window out of buffer cur, over carry_out's ctx
      __syncthreads();
      for (int i = tid; i < K * W; i += nt)
        cy.ctx_o[(size_t)b * K * W + i] = hw.win[cur * K * W + i];
    }
    if constexpr (kRnn) {  // each beam's LM state out of buffer cur
      const int KH = K * lm.H;
      const float *h_c = rnn.h + (size_t)cur * lm.nl * KH, *c_c = rnn.c + (size_t)cur * lm.nl * KH;
      for (int idx = tid; idx < lm.nl * KH; idx += nt) {
        const int l = idx / KH;
        const size_t at = ((size_t)l * gridDim.x + b) * KH + (idx - l * KH);
        cy.h_o[at] = h_c[idx];
        cy.c_o[at] = c_c[idx];
      }
      for (int idx = tid; idx < K * V; idx += nt)
        cy.lmp_o[(size_t)b * K * V + idx] = rnn.lmp[(size_t)cur * K * V + idx];
    }
  } else {
    finish_search(w, s, b, n_t, cur, tokens, out_len, out_score, tid, nt);
  }
}

// Launches one block per utterance with the dynamic shared memory set.
// trace: the trace, or for kCarry the BeamCarry.
template <bool kTopA, bool kRnn, int kPlace = kShared, bool kCarry = false, bool kHash = false>
int launch(int B, int threads, size_t smem, void* stream, const SearchIn& s, const int* lens,
           int* tokens, int* out_len, float* out_score, const LmOf<kHash>& lm, float* scratch,
           TraceOr<kCarry> trace) {
  auto kernel = prefix_beam_kernel<kTopA, kRnn, kPlace, kCarry, kHash>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  kernel<<<B, threads, smem, (cudaStream_t)stream>>>(s, lens, tokens, out_len, out_score, lm,
                                                     scratch, trace);
  return cudaGetLastError();
}

// ---------------------------------------------- K9 on the co-resident grid

constexpr int kGridThreads = 512;
constexpr int kRowsPerWarp = 8;   // rows a warp's gate sums cover: 8 rows x 4 gates = 32 lanes

// A CTA's shared memory on the grid, as ops/beam_cuda.py::rnn_grid_smem_bytes
// computes it (tests/test_torch_beam_rnn_grid.py evaluates these functions'
// text): `rows` staged rows, each grid_row_floats of inputs and 16 bytes of
// (utterance, new slot, parent slot, char); the fixed floats: for each
// layer 4 units columns of its weights (H rows for layer 0, whose input
// product is the (V, 4 units) table, 2H above), that table, the biases,
// w_out (H, V) in rows of V | 1 floats (an odd stride: the 32 lanes of a
// warp reading one char of 32 rows hit 32 banks) and b_out (V), to a
// multiple of 4; the staged rows' parent cells of the CTA's units; the B
// lengths, to a multiple of 4; all that to 16 bytes; then per_cta
// utterances, each its search's working set, the log-prob rows of its 2K
// state slots (2K, V), and 7 K + 1 ints, to 16 bytes.
__host__ __device__ inline size_t grid_row_floats(int H) { return ((size_t)2 * H + 3) / 4 * 4; }

__host__ __device__ inline size_t grid_fixed_floats(int V, int nl, int H, int units) {
  return (4 * (size_t)units * (H + (size_t)(nl - 1) * 2 * H) + (size_t)V * 4 * units +
          (size_t)nl * 4 * units + (size_t)H * (V | 1) + (size_t)V + 3) / 4 * 4;
}

__host__ __device__ inline size_t grid_utt_bytes(int K, int C, int V) {
  return (lm_smem_offset(K, C, V) + 8 * (size_t)K * V + 4 * (7 * (size_t)K + 1) + 15) / 16 * 16;
}

__host__ __device__ inline size_t grid_shared_bytes(int B, int K, int V, int nl, int H, int units,
                                                    int rows) {
  return ((size_t)rows * (4 * grid_row_floats(H) + 16 + 4 * (size_t)units) +
          4 * grid_fixed_floats(V, nl, H, units) + 4 * (((size_t)B + 3) / 4 * 4) + 15) /
         16 * 16;
}

__host__ __device__ inline size_t rnn_grid_smem_bytes(int B, int K, int C, int V, int nl, int H,
                                                      int units, int rows, int per_cta) {
  return grid_shared_bytes(B, K, V, nl, H, units, rows) + (size_t)per_cta * grid_utt_bytes(K, C, V);
}

// The grid's buffers in device memory.
struct GridBufs {
  float* state;     // h then c, each (B, 2K slots, nl, H): the LM states the beams point to
  int4* rows;       // (B K) a frame's appending beams {utterance, new slot, parent slot, char}
  unsigned* sync;   // [0] the barrier's count, [1 + t % 2] frame t's rows
};

// One utterance's part of a search CTA's shared memory.  Beam k of frame
// parity p holds its LM state in slot sid[p K + k] of the utterance's 2K:
// a beam that did not append shares its parent's slot, one that appended
// gets a slot no current beam holds.
struct GridUtt {
  SearchWs ws;
  float* lmp;   // (2K, V) each slot's log-prob row
  int* par;     // (K) each pick's parent
  int* app;     // (K) each pick's appended char, -1 for none
  int* arow;    // (K) the picks that appended, packed
  int* sid;     // (2, K) each beam's slot, by frame parity
  int* used;    // (2K) frame t + 1 where a current beam holds the slot
  int* n_app;   // (1) how many appended
};

__device__ __forceinline__ GridUtt grid_utt(char* base, int K, int C, int V) {
  GridUtt z;
  z.ws = search_ws(base, K, C, V);
  z.lmp = reinterpret_cast<float*>(base + lm_smem_offset(K, C, V));
  z.par = reinterpret_cast<int*>(z.lmp + 2 * (size_t)K * V);
  z.app = z.par + K;
  z.arow = z.app + K;
  z.sid = z.arow + K;
  z.used = z.sid + 2 * K;
  z.n_app = z.used + 2 * K;
  return z;
}

// One step of warp_sums32 at lane offset O: a lane keeps the half of its O
// pairs of partial sums that its bit O selects and adds its partner's.
template <int O>
__device__ __forceinline__ void halve_sums(float (&a)[32], int lane) {
  const bool upper = (lane & O) != 0;
#pragma unroll
  for (int k = 0; k < O; ++k) {
    const float keep = upper ? a[k + O] : a[k];
    const float give = upper ? a[k] : a[k + O];
    a[k] = keep + __shfl_xor_sync(0xffffffffu, give, O);
  }
}

// The 32 sums a[j] (j = 8 rows x 4 gates) of a warp's lanes, each over all
// 32 lanes, by recursive halving (every index a compile-time constant, so a
// stays in registers).  Lane j ends with sum j.
__device__ __forceinline__ float warp_sums32(float (&a)[32], int lane) {
  halve_sums<16>(a, lane);
  halve_sums<8>(a, lane);
  halve_sums<4>(a, lane);
  halve_sums<2>(a, lane);
  halve_sums<1>(a, lane);
  return a[0];
}

// dst[0, n) in shared memory = src[0, n) from L2 (other SMs wrote it): by
// 16-byte cp.async.cg where both are 16-byte aligned, else 4-byte ones, as
// work item `e` of `items` = ceil(n / 4) or n; the caller commits and waits.
__device__ __forceinline__ void stage_copy(float* dst, const float* src, int e, bool wide) {
  if (wide) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(smem_addr(dst + 4 * e)),
                 "l"(src + 4 * e)
                 : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(smem_addr(dst + e)),
                 "l"(src + e)
                 : "memory");
  }
}

// K9 on the co-resident grid: see the design note at the top.  trace: CTA
// 0's clocks of each frame, (T, 5 + 3 nl): the global clock; the clock at
// the frame's start, after its search, after the barrier; for each layer
// after the first group's staging, after the products and cells, after the
// barrier; and after the logits.  kCarry: a chunk of a stream, as the block
// kernel's (its BeamCarry in the trace's place); beam k's
// carried LM state starts in slot k of its utterance's 2K, and each beam's
// state goes back out of the slot it points at after the chunk.
template <bool kTopA, bool kCarry = false>
__global__ void __launch_bounds__(kGridThreads, 1) prefix_beam_rnn_grid_kernel(
    SearchIn s, RnnLm lm, const int* __restrict__ lens, int* __restrict__ tokens,
    int* __restrict__ out_len, float* __restrict__ out_score, GridBufs g,
    TraceOr<kCarry> trace, int B, int units, int stage_rows, int per_cta, int reps) {
  extern __shared__ __align__(16) unsigned long long smem[];
  const int K = s.K, C = s.C, V = s.V, H = lm.H, nl = lm.nl, U4 = 4 * units, S2 = 2 * K;
  const int tid = threadIdx.x, nt = blockDim.x, lane = tid & 31, warp = tid >> 5, nw = nt >> 5;
  // reps replicas of the units' columns, each a contiguous run of CTAs that
  // covers H and steps its share of a frame's rows.
  const int ctas = gridDim.x, cpr = ctas / reps, rep = blockIdx.x / cpr;
  const int k0 = (blockIdx.x - rep * cpr) * units, nu = min(units, H - k0);
  const int SW = (int)grid_row_floats(H);
  const bool wide = H % 4 == 0;  // rows of 16-byte chunks
  float* stage = reinterpret_cast<float*>(smem);                          // (stage_rows, SW)
  int4* meta = reinterpret_cast<int4*>(stage + (size_t)stage_rows * SW);  // (stage_rows)
  float* w_s = reinterpret_cast<float*>(meta + stage_rows);  // the layers' columns, 16-aligned
  float* ex_s = w_s + (size_t)U4 * (H + (size_t)(nl - 1) * 2 * H);        // (V, U4)
  float* bias_s = ex_s + (size_t)V * U4;                                  // (nl, U4)
  const int VP = V | 1;
  float* wout_s = bias_s + nl * U4;                                       // (H, VP)
  float* bout_s = wout_s + (size_t)H * VP;                                // (V)
  float* cstage = w_s + grid_fixed_floats(V, nl, H, units);            // (stage_rows, units)
  int* lens_s = reinterpret_cast<int*>(cstage + (size_t)stage_rows * units);  // (B)
  char* utt0 = reinterpret_cast<char*>(smem) + grid_shared_bytes(B, K, V, nl, H, units,
                                                                   stage_rows);
  const size_t utt_bytes = grid_utt_bytes(K, C, V);
  const size_t plane = (size_t)B * S2 * nl * H;  // all of h (or c)
  // Layer l's row of h in slot `slot` of utterance b; c lies a plane on.
  auto hrow = [&](int b, int slot, int l) {
    return g.state + (((size_t)b * S2 + slot) * nl + l) * H;
  };
  auto crow = [&](int b, int slot, int l) { return hrow(b, slot, l) + plane; };

  // Prologue: this CTA's columns of every layer (units past H as zeros),
  // layer 0's input table, the biases, the lengths.
  for (int e = tid; e < U4 * H; e += nt) {
    const int cc = e / H, i = e - cc * H, u = cc >> 2, gate = cc & 3;
    w_s[e] = u < nu ? lm.wh(0)[(size_t)i * 4 * H + gate * H + k0 + u] : 0.0f;
  }
  for (int l = 1; l < nl; ++l) {
    float* wl = w_s + (size_t)U4 * H + (size_t)(l - 1) * U4 * 2 * H;
    for (int e = tid; e < U4 * 2 * H; e += nt) {
      const int cc = e / (2 * H), i = e - cc * 2 * H, u = cc >> 2, gate = cc & 3;
      const size_t col = (size_t)gate * H + k0 + u;
      wl[e] = u >= nu ? 0.0f
                      : i < H ? lm.wx(l)[(size_t)i * 4 * H + col]
                              : lm.wh(l)[(size_t)(i - H) * 4 * H + col];
    }
  }
  for (int e = tid; e < V * U4; e += nt) {  // embed[v] wx0[:, col], fmaf from 0 in order
    const int v = e / U4, cc = e - v * U4, u = cc >> 2, gate = cc & 3;
    float acc = 0.0f;
    if (u < nu) {
      const float* x = lm.embed + (size_t)v * lm.E;
      const float* wc = lm.wx(0) + (size_t)gate * H + k0 + u;
      for (int i = 0; i < lm.E; ++i) acc = fmaf(x[i], wc[(size_t)i * 4 * H], acc);
    }
    ex_s[e] = acc;
  }
  for (int e = tid; e < nl * U4; e += nt) {
    const int l = e / U4, cc = e - l * U4, u = cc >> 2, gate = cc & 3;
    bias_s[e] = u < nu ? lm.b(l)[gate * H + k0 + u] : 0.0f;
  }
  int steps = 0;
  for (int b = 0; b < B; ++b) {
    const int n_t = min(max(lens[b], 0), s.T);
    steps = max(steps, n_t);
    if (tid == 0) lens_s[b] = n_t;
  }
  // This CTA's utterances: their searches, first rows, and every beam in
  // slot 0, the LM state after <sos>.
  const int mine = blockIdx.x < B ? min(per_cta, (B - 1 - (int)blockIdx.x) / ctas + 1) : 0;
  if (mine > 0) {
    for (int e = tid; e < H * V; e += nt) wout_s[(e / V) * VP + e % V] = lm.w_out[e];
    for (int e = tid; e < V; e += nt) bout_s[e] = lm.b_out[e];
  }
  for (int u = 0; u < mine; ++u) {
    const int b = blockIdx.x + u * ctas, n_t = min(max(lens[b], 0), s.T);
    const GridUtt z = grid_utt(utt0 + u * utt_bytes, K, C, V);
    if constexpr (kCarry) {  // beam k in slot k, with its own LM state
      const BeamCarry& cy = trace;
      carry_in(z.ws, cy, b, K, tid, nt);
      for (int e = tid; e < K * V; e += nt) z.lmp[e] = cy.lmp[(size_t)b * K * V + e];
      for (int e = tid; e < K; e += nt) z.sid[e] = e;
      for (int e = tid; e < S2; e += nt) z.used[e] = 0;
      if (n_t > 0) load_row<kTopA>(z.ws, s, (size_t)b * s.T, tid, nt);
      for (int e = tid; e < nl * K * H; e += nt) {
        const int l = e / (K * H), k = (e / H) % K, j = e % H;
        const size_t at = (((size_t)l * B + b) * K + k) * H + j;
        hrow(b, k, l)[j] = cy.h[at];
        crow(b, k, l)[j] = cy.c[at];
      }
    } else {
      search_init(z.ws, K, tid, nt);
      for (int e = tid; e < V; e += nt) z.lmp[e] = lm.lmp0[e];
      for (int e = tid; e < K; e += nt) z.sid[e] = 0;
      for (int e = tid; e < S2; e += nt) z.used[e] = 0;
      if (n_t > 0) load_row<kTopA>(z.ws, s, (size_t)b * s.T, tid, nt);
      for (int e = tid; e < nl * H; e += nt) {
        hrow(b, 0, e / H)[e % H] = lm.h0[e];
        crow(b, 0, e / H)[e % H] = lm.c0[e];
      }
    }
  }
  __syncthreads();

  unsigned barriers = 0;
  for (int t = 0; t < steps; ++t) {
    const int cur = t & 1, nxt = cur ^ 1;
    long long* tr = nullptr;
    if constexpr (!kCarry)
      tr = trace != nullptr && blockIdx.x == 0 && tid == 0 ? trace + (size_t)t * (5 + 3 * nl)
                                                           : nullptr;
    if (tr) {
      tr[0] = (long long)global_ns();
      tr[1] = clock64();
    }
    // Search: each of this CTA's utterances still in its frames.
    for (int u = 0; u < mine; ++u) {
      const int b = blockIdx.x + u * ctas, n_t = lens_s[b];
      if (t >= n_t) continue;
      const GridUtt z = grid_utt(utt0 + u * utt_bytes, K, C, V);
      const int* sid_c = z.sid + cur * K;
      int* sid_n = z.sid + nxt * K;
      for (int r = tid; r < K; r += nt) z.used[sid_c[r]] = t + 1;  // seen after the search's barriers
      search_frame<kTopA, true, false>(z.ws, s, b, t, n_t, cur, z.lmp, sid_c, z.par,
                                       z.app, nullptr, tid, nt);
      for (int r = tid; r < K; r += nt) {
        if (z.app[r] < 0) sid_n[r] = sid_c[z.par[r]];
      }
      if (warp == 0) {
        // Pack the appending beams, give each a slot no current beam
        // holds (there are at least K), and list them for the grid.
        int n = 0;
        for (int r0 = 0; r0 < K; r0 += 32) {
          const int r = r0 + lane;
          const bool appended = r < K && z.app[r] >= 0;
          const unsigned m = __ballot_sync(0xffffffffu, appended);
          if (appended) z.arow[n + __popc(m & ((1u << lane) - 1u))] = r;
          n += __popc(m);
        }
        __syncwarp();
        for (int s0 = 0, f = 0; s0 < S2 && f < n; s0 += 32) {
          const int sl = s0 + lane;
          const bool free = sl < S2 && z.used[sl] != t + 1;
          const unsigned m = __ballot_sync(0xffffffffu, free);
          const int p = f + __popc(m & ((1u << lane) - 1u));
          if (free && p < n) sid_n[z.arow[p]] = sl;
          f += __popc(m);
        }
        unsigned at = 0;
        if (lane == 0) {
          *z.n_app = n;
          if (n > 0) at = atomicAdd(g.sync + 1 + cur, (unsigned)n);
        }
        at = __shfl_sync(0xffffffffu, at, 0);
        __syncwarp();
        for (int p = lane; p < n; p += 32) {
          const int r = z.arow[p];
          g.rows[at + p] = make_int4(b, sid_n[r], sid_c[z.par[r]], z.app[r]);
        }
      }
    }
    if (tr) tr[2] = clock64();
    __syncthreads();
    grid_wait(g.sync, ++barriers * ctas);
    if (tr) tr[3] = clock64();
    if (blockIdx.x == 0 && tid == 0) atomicExch(g.sync + 1 + nxt, 0u);  // the next frame's count
    const int total = (int)__ldcg(g.sync + 1 + cur);
    const int lo = (int)((long long)total * rep / reps);       // this replica's rows
    const int hi = (int)((long long)total * (rep + 1) / reps);

    // The rows' (utterance, slots, char) stay staged across the layers
    // where they fit at once.
    const bool meta_kept = hi - lo <= stage_rows;
    for (int l = 0; l < nl; ++l) {
      const int W = l == 0 ? H : 2 * H;
      const float* wl = l == 0 ? w_s : w_s + (size_t)U4 * H + (size_t)(l - 1) * U4 * 2 * H;
      if (tr) tr[4 + 3 * l] = clock64();  // no rows: no staging
      for (int g0 = lo; g0 < hi; g0 += stage_rows) {
        const int ng = min(stage_rows, hi - g0);
        if (g0 > lo) __syncthreads();  // the last group's products have read stage
        if (!meta_kept || l == 0) {
          for (int q = tid; q < ng; q += nt) meta[q] = __ldcg(g.rows + g0 + q);
          __syncthreads();
        }
        // Row q: [0, H) the parent's h of layer l (layer 0), or the row's
        // new h of layer l - 1 then [H, 2H) the parent's h of layer l; and
        // the parent's c of layer l at this CTA's units.
        const int parts = l == 0 ? 1 : 2, per = wide ? H / 4 : H;
        for (int e = tid; e < ng * parts * per; e += nt) {
          const int q = e / (parts * per), rem = e - q * parts * per, part = rem / per;
          const int4 m = meta[q];
          const float* src = l > 0 && part == 0 ? hrow(m.x, m.y, l - 1) : hrow(m.x, m.z, l);
          stage_copy(stage + (size_t)q * SW + part * H, src, rem - part * per, wide);
        }
        for (int e = tid; e < ng * nu; e += nt) {
          const int q = e / nu;
          const int4 m = meta[q];
          stage_copy(cstage + (size_t)q * units, crow(m.x, m.z, l) + k0, e - q * nu, false);
        }
        cp_async_commit();
        cp_async_wait<0>();
        __syncthreads();
        if (tr && g0 == lo) tr[4 + 3 * l] = clock64();
        // Gate sums: a warp takes kRowsPerWarp rows and one unit; lane i0
        // sums inputs i0, i0 + 32, ... of each (row, gate), and the halving
        // leaves lane 4 q + gate with that sum over all inputs.
        const int ngr = (ng + kRowsPerWarp - 1) / kRowsPerWarp;
        for (int it = warp; it < ngr * nu; it += nw) {
          const int u = it / ngr, q0 = (it - u * ngr) * kRowsPerWarp;
          const int q = lane >> 2, gate = lane & 3;
          const float* x[kRowsPerWarp];
#pragma unroll
          for (int r = 0; r < kRowsPerWarp; ++r) x[r] = stage + (size_t)min(q0 + r, ng - 1) * SW;
          const float* wc = wl + (size_t)(4 * u) * W;
          float a[4 * kRowsPerWarp] = {};
#pragma unroll 2
          for (int i = lane; i < W; i += 32) {
            const float w0 = wc[i], w1 = wc[W + i], w2 = wc[2 * W + i], w3 = wc[3 * W + i];
#pragma unroll
            for (int r = 0; r < kRowsPerWarp; ++r) {
              const float xv = x[r][i];
              a[4 * r] = fmaf(xv, w0, a[4 * r]);
              a[4 * r + 1] = fmaf(xv, w1, a[4 * r + 1]);
              a[4 * r + 2] = fmaf(xv, w2, a[4 * r + 2]);
              a[4 * r + 3] = fmaf(xv, w3, a[4 * r + 3]);
            }
          }
          float sum = warp_sums32(a, lane);
          const int qr = min(q0 + q, ng - 1);
          if (l == 0) sum = ex_s[(size_t)meta[qr].w * U4 + 4 * u + gate] + sum;  // embed[c] wx0
          const float* bias = bias_s + l * U4 + 4 * u;
          const float gf = __shfl_down_sync(0xffffffffu, sum, 1);
          const float gg = __shfl_down_sync(0xffffffffu, sum, 2);
          const float go = __shfl_down_sync(0xffffffffu, sum, 3);
          if (gate == 0 && q0 + q < ng) {
            const int4 m = meta[qr];
            const float c_new = sigmoid(gf + bias[1] + 1.0f) * cstage[(size_t)qr * units + u] +
                                sigmoid(sum + bias[0]) * tanhf(gg + bias[2]);
            hrow(m.x, m.y, l)[k0 + u] = sigmoid(go + bias[3]) * tanhf(c_new);
            crow(m.x, m.y, l)[k0 + u] = c_new;
          }
        }
      }
      __syncthreads();
      if (tr) tr[5 + 3 * l] = clock64();
      grid_wait(g.sync, ++barriers * ctas);
      if (tr) tr[6 + 3 * l] = clock64();
    }

    // Logits and log-softmax of this CTA's appending beams into their slots.
    for (int u = 0; u < mine; ++u) {
      const int b = blockIdx.x + u * ctas;
      if (t >= lens_s[b]) continue;
      const GridUtt z = grid_utt(utt0 + u * utt_bytes, K, C, V);
      const int n = *z.n_app;
      if (n == 0) continue;
      const int* sid_n = z.sid + nxt * K;
      const int per = wide ? H / 4 : H;
      for (int e = tid; e < n * per; e += nt) {  // h_top of each, from L2
        const int p = e / per;
        stage_copy(stage + (size_t)p * SW, hrow(b, sid_n[z.arow[p]], nl - 1), e - p * per, wide);
      }
      cp_async_commit();
      cp_async_wait<0>();
      __syncthreads();
      for (int p = warp; p < n; p += nw) {  // a warp a row
        // Logits 32 chars at a time: lane i0 sums inputs i0, i0 + 32, ...
        // of each char, and the halving leaves lane j with char c0 + j.
        const float* x = stage + (size_t)p * SW;
        float* row = z.lmp + (size_t)sid_n[z.arow[p]] * V;
        for (int c0 = 0; c0 < V; c0 += 32) {
          float a[32] = {};
          for (int i = lane; i < H; i += 32) {
            const float xv = x[i];
            const float* w = wout_s + (size_t)i * VP + c0;
#pragma unroll
            for (int j = 0; j < 32; ++j) a[j] = fmaf(xv, c0 + j < V ? w[j] : 0.0f, a[j]);
          }
          const float logit = warp_sums32(a, lane);
          if (c0 + lane < V) row[c0 + lane] = logit + bout_s[c0 + lane];
        }
        __syncwarp();  // then x - (max + log(sum(exp(x - max))))
        float m = -3.402823466e38f;
        for (int v = lane; v < V; v += 32) m = fmaxf(m, row[v]);
        for (int o = 16; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
        float sum = 0.0f;
        for (int v = lane; v < V; v += 32) sum += expf(row[v] - m);
        for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
        const float lse_row = m + logf(sum);
        __syncwarp();
        for (int v = lane; v < V; v += 32) row[v] -= lse_row;
      }
      __syncthreads();
    }
    if (tr) tr[4 + 3 * nl] = clock64();
  }

  for (int u = 0; u < mine; ++u) {
    const int b = blockIdx.x + u * ctas;
    const GridUtt z = grid_utt(utt0 + u * utt_bytes, K, C, V);
    if constexpr (kCarry) {
      // Each beam's LM state out of its slot (h and c from L2: other CTAs
      // wrote them before a grid barrier), then its fields and tokens.
      const BeamCarry& cy = trace;
      const int cur = lens_s[b] & 1;
      const int* sid = z.sid + cur * K;
      for (int e = tid; e < nl * K * H; e += nt) {
        const int l = e / (K * H), k = (e / H) % K, j = e % H;
        const size_t at = (((size_t)l * B + b) * K + k) * H + j;
        cy.h_o[at] = __ldcg(hrow(b, sid[k], l) + j);
        cy.c_o[at] = __ldcg(crow(b, sid[k], l) + j);
      }
      for (int e = tid; e < K * V; e += nt)
        cy.lmp_o[(size_t)b * K * V + e] = z.lmp[(size_t)sid[e / V] * V + e % V];
      carry_out(z.ws, s, cy, b, lens_s[b], cur, tokens, out_len, out_score, tid, nt);
    } else {
      finish_search(z.ws, s, b, lens_s[b], lens_s[b] & 1, tokens, out_len, out_score, tid, nt);
    }
    __syncthreads();
  }
}

// K9's LM from the wrapper's host array of device pointers embed, w_out,
// b_out, h0, c0, lmp0, and its device table of the layers' 3 nl pointers.
RnnLm rnn_lm(const float* const* weights, const float* const* layers, int nl, int E, int H) {
  RnnLm lm = {};
  lm.embed = weights[0];
  lm.w_out = weights[1];
  lm.b_out = weights[2];
  lm.h0 = weights[3];
  lm.c0 = weights[4];
  lm.lmp0 = weights[5];
  lm.layer = layers;
  lm.nl = nl;
  lm.E = E;
  lm.H = H;
  return lm;
}

SearchIn search_in(const float* logp, const float* top_val, const int* top_idx,
                   const float* table, int* parents, int* appends, int T, int V, int K, int C,
                   int L, int n_ctx, float alpha, float beta) {
  SearchIn s;
  s.logp = logp;
  s.top_val = top_val;
  s.top_idx = top_idx;
  s.table = table;
  s.parents = parents;
  s.appends = appends;
  s.T = T;
  s.V = V;
  s.K = K;
  s.C = C;
  s.L = L;
  s.n_ctx = n_ctx;
  s.alpha = alpha;
  s.beta = beta;
  return s;
}

// K10: one frame's merge and top-K over the candidates gathered from the
// beam shards (decoding/prefix_beam_sharded.py): K7's per-frame merge,
// lifted out of its time loop, on search_frame's design.  Ks stays and
// Ks*nb extension lanes, lane (k, c-1) beam k's extension by char c =
// 1..nb (the plain _merge_topk's layout); lanes' last char is their
// appended one.  One block a row, a thread a candidate (at least Ks kp for
// the absorb's tests, at most 1024; past that the phases loop: 512 threads
// at Ks 16 over 30 chars).  Its phases, each ended by a block barrier:
//   1. loads: the stays' pb, pnb and hashes and the lanes' pnb into the
//      working set, each candidate's LM term (a lane's pnb + lm) into its
//      key slot, the absorbed flags cleared;
//   2. absorb, K7's: a thread a (stay, beam) test, the at most one match a
//      stay has found by shuffles (Ks <= 32 and Ks kp <= threads; the
//      prefixes are distinct, so the sum has one term and m + logf(1) is
//      m, as a thread a stay gives it), else a thread a stay;
//   3. keys and sort: warp w computes the keys of its own contiguous
//      segment of the N = Ks + Ks*nb candidates (32 where the warps
//      suffice: 31 at Ks 16 over 30 chars) and sorts them descending in
//      registers (or in place past 32);
//   4. K <= 32: the merge tree, warp 0's lane r then holds pick r and
//      writes output r; else each of the first K keys of a segment is
//      ranked by counting the keys above it in every segment, and a key of
//      rank r < K writes output r.
// The absorb is written here again rather than shared with search_frame:
// a function shared with the search kernel, inlined or not, once changed
// how ptxas allocated K9's LM step.  The selection's functions (the warp
// sorts, merge_tree, count_above) are __forceinline__ and shared.
// Past a block's shared memory (merge_smem_bytes over 232,448 bytes, or Ks
// past 1024: ops/beam_cuda.py::merge_fits) the same kernel keeps its
// working set, laid out as in shared memory, in the block's slice of a
// device scratch (kInScratch, counted as merge_topk_wide): Ks 640 over 30
// chars needs 262,912 bytes.  trace (null in normal use): block 0's thread
// 0 writes the global clock at its start, its clock then and after the
// loads, the absorb, the keys and sort and its picks, and the global clock
// at its end ((7) int64).
struct MergeIn {
  const float *s_pb, *s_pnb, *s_lm;                      // (B, Ks)
  const int *s_hash, *s_last, *s_parent, *s_ctx;         // (B, Ks)
  const float *e_pnb, *e_lm;                             // (B, Ks * nb)
  const int *e_hash, *e_parent, *e_append, *e_ctx;       // (B, Ks * nb)
};

struct MergeOut {
  float *score, *pb, *pnb, *lm;                          // (B, K)
  int *hash, *last, *parent, *append, *ctx;              // (B, K), ctx (B, K, cols) windowed
};

// The window form's input (kWindow: the hashed LM's contexts): the same
// fields with ctx (B, Ks, cols) for the stays and (B, Ks * nb, cols) for the
// lanes; each pick copies its candidate's cols columns.
struct MergeWin : MergeIn {
  int cols;
};

template <bool kWindow>
using MergeInOf = std::conditional_t<kWindow, MergeWin, MergeIn>;

// One block's working set: keys 8 N, 512 bytes of room past them (the
// merge tree's zeros), 12 Ks of stays (pb, pnb, hash), 5 Ks*nb of lanes
// (pnb, absorbed); ops/beam_cuda.py mirrors it.  Its slice of the scratch
// is the same to a 16-byte boundary.
__host__ __device__ inline size_t merge_smem_bytes(int Ks, int nb) {
  const size_t KC = (size_t)Ks * nb, N = Ks + KC;
  return 8 * N + 512 + 12 * (size_t)Ks + 5 * KC;
}

__host__ __device__ inline size_t merge_slice_bytes(int Ks, int nb) {
  return (merge_smem_bytes(Ks, nb) + 15) / 16 * 16;
}

template <bool kInScratch, bool kWindow = false>
__global__ void __launch_bounds__(1024) merge_topk_kernel(MergeInOf<kWindow> in, MergeOut out,
                                                          int Ks, int nb, int K, char* scratch,
                                                          long long* trace) {
  const int KC = Ks * nb, N = Ks + KC;
  extern __shared__ __align__(16) unsigned long long smem[];
  char* base = kInScratch ? scratch + (size_t)blockIdx.x * merge_slice_bytes(Ks, nb)
                          : reinterpret_cast<char*>(smem);
  unsigned long long* key = reinterpret_cast<unsigned long long*>(base);  // (N + 64)
  float* spb = reinterpret_cast<float*>(key + N + 64);     // (Ks) stays
  float* spnb = spb + Ks;
  float* epnb = spnb + Ks;                                 // (KC) lanes
  uint32_t* hsh = reinterpret_cast<uint32_t*>(epnb + KC);  // (Ks)
  unsigned char* absorbed = reinterpret_cast<unsigned char*>(hsh + Ks);  // (KC)
  const int b = blockIdx.x, tid = threadIdx.x, nt = blockDim.x;
  const size_t so = (size_t)b * Ks, eo = (size_t)b * KC;
  long long* tr = trace != nullptr && b == 0 && tid == 0 ? trace : nullptr;
  if (tr) {
    tr[0] = (long long)global_ns();
    tr[1] = clock64();
  }
  // Candidate j's LM term rides in the first float of its key slot until
  // its key is made (only its own warp reads and then writes that slot): a
  // stay's lm, a lane's pnb + lm (its score unless absorbed).
  float* lm_in_key = reinterpret_cast<float*>(key);
  for (int k = tid; k < Ks; k += nt) {
    spb[k] = in.s_pb[so + k];
    spnb[k] = in.s_pnb[so + k];
    hsh[k] = (uint32_t)in.s_hash[so + k];
    lm_in_key[2 * k] = in.s_lm[so + k];
  }
  for (int l = tid; l < KC; l += nt) {
    const float e = in.e_pnb[eo + l];
    epnb[l] = e;
    lm_in_key[2 * ((size_t)Ks + l)] = e + in.e_lm[eo + l];
    absorbed[l] = 0;
  }
  __syncthreads();
  if (tr) tr[2] = clock64();

  // Absorb: the char that would turn beam k into alive stay k' is
  // c = h_k' - M h_k (mod 2^32); lane (k, c - 1) when 1 <= c <= nb.
  int kp = 1;
  while (kp < Ks) kp <<= 1;
  if (kp <= 32 && Ks * kp <= nt) {
    if ((tid >> 5) * 32 < Ks * kp) {  // warp-uniform: every lane shuffles
      const int r = min(tid / kp, Ks - 1), k = tid - (tid / kp) * kp;
      const bool mine = tid < Ks * kp && k < Ks;
      const float sn = spnb[r];
      float e = NEG_INF;
      bool hit = false;
      if (mine && lse(spb[r], sn) > NEG_INF / 2) {
        const uint32_t c = hsh[r] - HASH_MULT * hsh[k];
        if (c >= 1u && c <= (uint32_t)nb) {
          absorbed[k * nb + c - 1] = 1;
          e = epnb[k * nb + c - 1];
          hit = true;
        }
      }
      float m = e;
      for (int o = kp >> 1; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
      float sum = hit && m > NEG_INF / 2 ? expf(e - m) : 0.0f;
      for (int o = kp >> 1; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
      if (mine && k == 0) spnb[r] = lse(sn, m > NEG_INF / 2 ? m + logf(sum) : NEG_INF);
    }
  } else {
    for (int r = tid; r < Ks; r += nt) {
      const float sn = spnb[r];
      float add = NEG_INF;
      if (lse(spb[r], sn) > NEG_INF / 2) {
        const uint32_t h2 = hsh[r];
        float m = NEG_INF;
        for (int k = 0; k < Ks; ++k) {
          const uint32_t c = h2 - HASH_MULT * hsh[k];
          if (c >= 1u && c <= (uint32_t)nb) {
            absorbed[k * nb + c - 1] = 1;
            m = fmaxf(m, epnb[k * nb + c - 1]);
          }
        }
        if (m > NEG_INF / 2) {
          float sum = 0.0f;
          for (int k = 0; k < Ks; ++k) {
            const uint32_t c = h2 - HASH_MULT * hsh[k];
            if (c >= 1u && c <= (uint32_t)nb) sum += expf(epnb[k * nb + c - 1] - m);
          }
          add = m + logf(sum);
        }
      }
      spnb[r] = lse(sn, add);
    }
  }
  __syncthreads();
  if (tr) tr[3] = clock64();

  // Selection keys: stays are candidates 0..Ks-1, lane l is Ks + l.
  auto key_of = [&](int j) {
    const float lm = lm_in_key[2 * (size_t)j];
    const float sc = j < Ks ? lse(spb[j], spnb[j]) + lm : (absorbed[j - Ks] ? NEG_INF : lm);
    return make_key(sc, j);
  };
  // Pick r (key `pick`) becomes output r, every field from its candidate.
  auto take = [&](int r, unsigned long long pick) {
    const int j = key_index(pick);
    const size_t o = (size_t)b * K + r;
    const float score = key_score(pick);
    float pb, pnb;
    int hash;
    if (j < Ks) {
      pb = spb[j];
      pnb = spnb[j];
      hash = in.s_hash[so + j];
      out.lm[o] = in.s_lm[so + j];
      out.last[o] = in.s_last[so + j];
      out.parent[o] = in.s_parent[so + j];
      out.append[o] = -1;
      if constexpr (kWindow) {
        for (int i = 0; i < in.cols; ++i)
          out.ctx[o * in.cols + i] = in.s_ctx[(so + j) * in.cols + i];
      } else {
        out.ctx[o] = in.s_ctx[so + j];
      }
    } else {
      const size_t l = eo + (j - Ks);
      pb = NEG_INF;
      pnb = epnb[j - Ks];
      hash = in.e_hash[l];
      out.lm[o] = in.e_lm[l];
      out.last[o] = in.e_append[l];
      out.parent[o] = in.e_parent[l];
      out.append[o] = in.e_append[l];
      if constexpr (kWindow) {
        for (int i = 0; i < in.cols; ++i) out.ctx[o * in.cols + i] = in.e_ctx[l * in.cols + i];
      } else {
        out.ctx[o] = in.e_ctx[l];
      }
    }
    const bool dead = score <= NEG_INF / 2;  // a dead filler carries no mass
    out.score[o] = score;
    out.pb[o] = dead ? NEG_INF : pb;
    out.pnb[o] = dead ? NEG_INF : pnb;
    out.hash[o] = dead ? -(r + 1) : hash;
  };

  // Segments of 32 keys where the warps suffice (the rest idle in the
  // sort), else one a warp.  With K <= 32 and segments of at least K keys
  // the sorted segments' tops merge in a tree; else each key is ranked.
  const int nw = min(nt >> 5, (N + 31) >> 5), warp = tid >> 5, lane = tid & 31;
  const int seg = (N + nw - 1) / nw;
  const bool tree = K <= 32 && seg >= K;
  {
    const int s0 = warp * seg, sn = seg_len(warp, seg, N);
    // The tree reads K keys of every segment: a short last one gets 0s
    // (below every key) up to K, past N into the room after the keys.
    const int keep = tree && warp < nw ? max(sn, K) : sn;
    if (seg <= 32) {  // a key a lane, sorted in registers (0 past sn)
      const unsigned long long v = warp_sort_desc_reg(lane < sn ? key_of(s0 + lane) : 0ull,
                                                      sn, lane);
      if (lane < keep) key[s0 + lane] = v;
    } else {
      for (int j = s0 + lane; j < s0 + sn; j += 32) key[j] = key_of(j);
      __syncwarp();
      warp_sort_desc(key + s0, sn, lane);
      if (lane < keep - sn) key[s0 + sn + lane] = 0ull;
    }
  }
  __syncthreads();
  if (tr) tr[4] = clock64();
  if (tree) {
    const unsigned long long v = merge_tree(key, nw, seg, K, warp, lane);
    if (warp == 0 && lane < K) take(lane, v);
  } else {
    // Rank: only the first K keys of a segment can be picks, and none
    // below theta, the largest K-th key of a segment that has K (K keys
    // are at least it).  A key's rank is the count of keys above it in
    // every segment, its own included (there: its position).
    const int top = min(K, seg);
    int P = 1;
    while (P < top) P <<= 1;
    unsigned long long theta = 0;
    for (int o = 0; o < nw; ++o) {
      if (seg_len(o, seg, N) >= K) theta = umax(theta, key[o * seg + K - 1]);
    }
    for (int e = tid; e < nw * top; e += nt) {
      const int sw = e / top, p = e - sw * top;
      if (p >= seg_len(sw, seg, N)) continue;
      const unsigned long long x = key[sw * seg + p];
      if (x < theta) continue;
      int rank = 0;
      for (int o = 0; o < nw; ++o)
        rank += count_above(key + o * seg, min(top, seg_len(o, seg, N)), P, x);
      if (rank < K) take(rank, x);
    }
  }
  if (tr) {
    tr[5] = clock64();
    tr[6] = (long long)global_ns();
  }
}

// K10's launch: a block a row, in shared memory, or with `slices` (B
// merge_slice_bytes) its working set in a device scratch.
template <bool kWindow>
int launch_merge(const MergeInOf<kWindow>& in, const MergeOut& out, int B, int Ks, int nb, int K,
                 char* slices, long long* trace, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  const int threads = search_threads(Ks, nb);
  if (slices != nullptr) {
    merge_topk_kernel<true, kWindow><<<B, threads, 0, st>>>(in, out, Ks, nb, K, slices, trace);
    return cudaGetLastError();
  }
  const size_t smem = merge_smem_bytes(Ks, nb);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        merge_topk_kernel<false, kWindow>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return err;
  }
  merge_topk_kernel<false, kWindow><<<B, threads, smem, st>>>(in, out, Ks, nb, K, nullptr, trace);
  return cudaGetLastError();
}

}  // namespace

// top_val/top_idx null: K7 over all V chars (C = V); else K8 over C = A.
// parents/appends: (B, T, K) int32 scratch; tokens (B, L); out_len,
// out_score (B).  scratch: null keeps each block's working set in shared
// memory (the wrapper checks its size); else a device scratch of B *
// scratch_block_bytes(K, C, V, false, 0, 0, 0) bytes, 16-byte aligned,
// holds it (kInScratch: any K and C).  trace: null, or (T, 7) int64 for
// block 0's clocks of each frame (search_frame).  carry: null for a search
// from the initial beams, else a host array of BeamCarry's 22 device
// pointers: the kCarry form, a chunk of a stream from the state it holds
// to the state it hands on (no trace).
extern "C" int prefix_beam(const float* logp, const float* top_val, const int* top_idx,
                           const int* lens, const float* table, int* parents, int* appends,
                           int* tokens, int* out_len, float* out_score, int B, int T, int V,
                           int K, int C, int L, int n_ctx, float alpha, float beta,
                           float* scratch, long long* trace, const void* const* carry,
                           void* stream) {
  if (B == 0) return 0;
  if (carry != nullptr && trace != nullptr) return cudaErrorInvalidValue;
  const bool apart = scratch != nullptr, topa = top_idx != nullptr;
  const size_t smem = apart ? 0 : search_smem_bytes(K, C, V);
  const int threads = search_threads(K, C);
  const SearchIn s = search_in(logp, top_val, top_idx, table, parents, appends, T, V, K, C, L,
                               n_ctx, alpha, beta);
  const RnnLm none = {};
  if (carry != nullptr) {
    auto run = topa ? (apart ? launch<true, false, kInScratch, true>
                             : launch<true, false, kShared, true>)
                    : (apart ? launch<false, false, kInScratch, true>
                             : launch<false, false, kShared, true>);
    return run(B, threads, smem, stream, s, lens, tokens, out_len, out_score, none, scratch,
               beam_carry(carry));
  }
  auto run = topa ? (apart ? launch<true, false, kInScratch> : launch<true, false>)
                  : (apart ? launch<false, false, kInScratch> : launch<false, false>);
  return run(B, threads, smem, stream, s, lens, tokens, out_len, out_score, none, scratch,
             trace);
}

// K7 and K8 with the hashed n-gram LM (their kHash forms): as prefix_beam,
// the LM given as HashLm's fields (uni and uni_bo (V), tables: 2 (2 order -
// 3) int64 of row addresses and bucket masks; exact and n_exact: K7's
// lm_top_k chars (B, T, n_exact), or null).  scratch: null keeps each
// block's working set in shared memory (the wrapper checks its size), else
// a device scratch of B * hashed_block_bytes(K, C, V, order - 1) bytes.
// carry: as prefix_beam's, the state's ctx (B, K, order - 1) windows.
extern "C" int prefix_beam_hashed(const float* logp, const float* top_val, const int* top_idx,
                                  const int* lens, const float* uni, const float* uni_bo,
                                  const long long* tables, int order, const int* exact,
                                  int n_exact, int* parents, int* appends, int* tokens,
                                  int* out_len, float* out_score, int B, int T, int V, int K,
                                  int C, int L, float alpha, float beta, float* scratch,
                                  long long* trace, const void* const* carry, void* stream) {
  if (B == 0) return 0;
  const bool apart = scratch != nullptr, topa = top_idx != nullptr;
  if (order < 2 || (carry != nullptr && trace != nullptr) || (exact != nullptr && topa) ||
      (exact != nullptr) != (n_exact > 0))
    return cudaErrorInvalidValue;
  const size_t smem = apart ? 0 : hashed_smem_bytes(K, C, V, order - 1);
  const int threads = search_threads(K, C);
  const SearchIn s = search_in(logp, top_val, top_idx, nullptr, parents, appends, T, V, K, C, L,
                               1, alpha, beta);
  const HashLm hl = {uni, uni_bo, tables, exact, order, n_exact};
  if (carry != nullptr) {
    auto run = topa ? (apart ? launch<true, false, kInScratch, true, true>
                             : launch<true, false, kShared, true, true>)
                    : (apart ? launch<false, false, kInScratch, true, true>
                             : launch<false, false, kShared, true, true>);
    return run(B, threads, smem, stream, s, lens, tokens, out_len, out_score, hl, scratch,
               beam_carry(carry));
  }
  auto run = topa ? (apart ? launch<true, false, kInScratch, false, true>
                           : launch<true, false, kShared, false, true>)
                  : (apart ? launch<false, false, kInScratch, false, true>
                           : launch<false, false, kShared, false, true>);
  return run(B, threads, smem, stream, s, lens, tokens, out_len, out_score, hl, scratch, trace);
}

// K9's block form: the search fused with the char LSTM LM, a block an
// utterance.  weights: a host array of device pointers embed, w_out, b_out,
// h0, c0, lmp0; layers: a device array of 3 nl device pointers, wx of each
// of the nl layers, then wh of each, then b of each.  Same outputs
// and scratch as prefix_beam.  place (a Place) and scratch: kShared
// (scratch null) keeps every block's working set in shared memory;
// kLmStateInScratch keeps the LM state in a device scratch of B *
// lm_state_floats(K, V, nl, H) floats (for LMs or beams whose state does
// not fit beside the search); kInScratch keeps all of it in a device
// scratch of B * scratch_block_bytes(K, C, V, true, nl, E, H) bytes (where
// even the LM step's packed inputs do not fit, or K > 1024).  The wrapper
// checks, for the first two, the shared-memory size.  carry: as
// prefix_beam's (the LM state too; h0, c0 and lmp0 are not read).
extern "C" int prefix_beam_rnn(const float* logp, const float* top_val, const int* top_idx,
                               const int* lens, const float* const* weights,
                               const float* const* layers, int nl, int E, int H, int* parents, int* appends, int* tokens, int* out_len,
                               float* out_score, int B, int T, int V, int K, int C, int L,
                               float alpha, float beta, float* scratch, int place,
                               const void* const* carry, void* stream) {
  if (B == 0) return 0;
  if (nl < 1) return cudaErrorInvalidValue;
  const RnnLm lm = rnn_lm(weights, layers, nl, E, H);
  if (place < kShared || place > kInScratch || (place == kShared) != (scratch == nullptr))
    return cudaErrorInvalidValue;
  const size_t smem = place == kInScratch
                          ? 0
                          : lm_smem_offset(K, C, V) +
                                lm_smem_bytes(K, V, nl, E, H, place == kShared);
  const long long groups = (K + 3) / 4;
  long long work = search_threads(K, C);
  work = work > H * groups ? work : H * groups;
  work = work > V * groups ? work : V * groups;
  const int threads = work >= 1024 ? 1024 : (int)(work + 31) / 32 * 32;
  const bool topa = top_idx != nullptr;
  const SearchIn s = search_in(logp, top_val, top_idx, nullptr, parents, appends, T, V, K, C, L,
                               1, alpha, beta);
  if (carry != nullptr) {
    auto run = place == kShared ? (topa ? launch<true, true, kShared, true>
                                        : launch<false, true, kShared, true>)
               : place == kLmStateInScratch ? (topa ? launch<true, true, kLmStateInScratch, true>
                                                    : launch<false, true, kLmStateInScratch, true>)
                                            : (topa ? launch<true, true, kInScratch, true>
                                                    : launch<false, true, kInScratch, true>);
    return run(B, threads, smem, stream, s, lens, tokens, out_len, out_score, lm, scratch,
               beam_carry(carry));
  }
  auto run = place == kShared            ? (topa ? launch<true, true> : launch<false, true>)
             : place == kLmStateInScratch ? (topa ? launch<true, true, kLmStateInScratch>
                                                  : launch<false, true, kLmStateInScratch>)
                                          : (topa ? launch<true, true, kInScratch>
                                                  : launch<false, true, kInScratch>);
  return run(B, threads, smem, stream, s, lens, tokens, out_len, out_score, lm, scratch,
             nullptr);
}

// K9 on the co-resident grid (ops/beam_cuda.py::rnn_grid_route gives ctas,
// units, stage_rows, per_cta, reps and smem: reps runs of ctas / reps CTAs,
// each run covering H with `units` units a CTA).  Inputs and outputs as
// prefix_beam_rnn; state: 4 B K nl H floats (h and c of 2K slots an
// utterance); rows: 4 B K ints (a frame's row list); sync: 3 unsigned, zero;
// trace: null or (T, 5 + 3 nl) int64; carry: as prefix_beam_rnn's (the
// kCarry form; no trace).  Returns cudaErrorInvalidValue for a
// grid that does not cover H and B or smem below its need, and the
// cooperative launch's error where the grid cannot be resident at once.
extern "C" int prefix_beam_rnn_grid(const float* logp, const float* top_val,
                                    const int* top_idx, const int* lens,
                                    const float* const* weights, const float* const* layers,
                                    int nl, int E, int H,
                                    int* parents, int* appends, int* tokens, int* out_len,
                                    float* out_score, int B, int T, int V, int K, int C, int L,
                                    float alpha, float beta, float* state, int* rows,
                                    unsigned* sync, long long* trace, int ctas, int units,
                                    int stage_rows, int per_cta, int reps, int smem,
                                    const void* const* carry, void* stream) {
  if (B == 0) return 0;
  if (reps < 1 || ctas % reps != 0 || (carry != nullptr && trace != nullptr))
    return cudaErrorInvalidValue;
  const int cpr = ctas / reps;
  if (nl < 1 || units < 1 || (long long)cpr * units < H ||
      (long long)(cpr - 1) * units >= H || (long long)per_cta * ctas < B || stage_rows < K ||
      (size_t)smem < rnn_grid_smem_bytes(B, K, C, V, nl, H, units, stage_rows, per_cta))
    return cudaErrorInvalidValue;
  RnnLm lm = rnn_lm(weights, layers, nl, E, H);
  SearchIn s = search_in(logp, top_val, top_idx, nullptr, parents, appends, T, V, K, C, L, 1,
                         alpha, beta);
  GridBufs g = {state, reinterpret_cast<int4*>(rows), sync};
  const bool topa = top_idx != nullptr;
  const void* kernel =
      carry != nullptr
          ? (topa ? reinterpret_cast<const void*>(prefix_beam_rnn_grid_kernel<true, true>)
                  : reinterpret_cast<const void*>(prefix_beam_rnn_grid_kernel<false, true>))
          : (topa ? reinterpret_cast<const void*>(prefix_beam_rnn_grid_kernel<true>)
                  : reinterpret_cast<const void*>(prefix_beam_rnn_grid_kernel<false>));
  BeamCarry cy = {};
  if (carry != nullptr) cy = beam_carry(carry);
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  void* args[] = {&s, &lm, &lens, &tokens, &out_len, &out_score, &g,
                  carry != nullptr ? static_cast<void*>(&cy) : static_cast<void*>(&trace),
                  &B, &units, &stage_rows, &per_cta, &reps};
  return launch_cooperative(kernel, dim3(ctas), dim3(kGridThreads), args, (size_t)smem,
                            (cudaStream_t)stream);
}

// K10: the per-frame merge and top-K of the beam-sharded search.  Inputs
// (B, Ks) stays and (B, Ks * nb) lanes, outputs (B, K), all contiguous on
// one device; cols > 0: the window form, ctx (B, Ks, cols), (B, Ks * nb,
// cols) and out (B, K, cols) (the hashed LM's windows), else ctx as the
// other fields.  scratch: null keeps each block's working set in shared
// memory (the wrapper checks its size and Ks <= 1024); else a device
// scratch of B merge_slice_bytes(Ks, nb) bytes, 16-byte aligned, holds it
// (kInScratch).  trace: null, or (7) int64 for block 0's clocks.  The
// wrapper checks K <= Ks + Ks * nb and the candidates' int32 indices.
extern "C" int merge_topk(const float* s_pb, const float* s_pnb, const float* s_lm,
                          const int* s_hash, const int* s_last, const int* s_parent,
                          const int* s_ctx, const float* e_pnb, const float* e_lm,
                          const int* e_hash, const int* e_parent, const int* e_append,
                          const int* e_ctx, float* score, float* pb, float* pnb, float* lm,
                          int* hash, int* last, int* parent, int* append, int* ctx,
                          void* scratch, long long* trace, int B, int Ks, int nb, int K, int cols,
                          void* stream) {
  if (B == 0) return 0;
  const MergeIn in = {s_pb, s_pnb, s_lm, s_hash, s_last, s_parent, s_ctx,
                      e_pnb, e_lm, e_hash, e_parent, e_append, e_ctx};
  const MergeOut out = {score, pb, pnb, lm, hash, last, parent, append, ctx};
  char* slices = static_cast<char*>(scratch);
  if (cols > 0) {
    MergeWin win;
    static_cast<MergeIn&>(win) = in;
    win.cols = cols;
    return launch_merge<true>(win, out, B, Ks, nb, K, slices, trace, stream);
  }
  return launch_merge<false>(in, out, B, Ks, nb, K, slices, trace, stream);
}

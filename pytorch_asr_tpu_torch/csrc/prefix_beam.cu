// CTC prefix beam search with shallow fusion of a dense n-gram table or a
// char LSTM LM, the whole utterance in one launch, for Hopper (sm_90a),
// CUDA C++.
//
// Replaces (one template; the search over all chars or each frame's top-A):
//   K7  pytorch_asr_tpu/ops/beam_pallas.py:756 prefix_beam_fused_lanes
//       (_beam_kernel_lanes :601): extensions over all V chars;
//   K8  pytorch_asr_tpu/ops/beam_pallas.py:1566 prefix_beam_fused_lanes_topa
//       (_beam_kernel_lanes_topa :1153): extensions over each frame's top-A
//       chars, given by the caller;
//   K9  pytorch_asr_tpu/ops/beam_pallas.py:1452 prefix_beam_fused_lanes_topa_rnn
//       (_beam_kernel_lanes_topa_rnn :1286): either search, fused with a char
//       LSTM LM whose state every beam carries and the kernel advances;
//   K10 pytorch_asr_tpu/ops/beam_pallas.py:1026 merge_topk_fused
//       (_merge_kernel :973): one frame's absorb and top-K over candidates
//       gathered from the beam shards, for the beam-sharded search (its own
//       kernel at the end of this file: K7's per-frame merge lifted out; it
//       shares K7's top-K selection, select_topk, and repeats its absorb).
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
//            score's order-preserving bits above the inverted index;
//   empty    lens[b] = 0 gives the empty hypothesis with score 0.
//
//   sigmoid, tanh, exp and log are the precise expf/tanhf/logf (no fast
//   math); the LM products are fp32 FMA sums, no TF32, as the JAX kernel
//   computes them at Precision.HIGHEST.
//
// K10 reads the gathered fields once (7 stay and 6 lane fields, ~200 KB a
// frame at config 2) and writes 9 (B, K) outputs: bytes, ~0.06 us; it is
// bound by one launch and K barrier-separated selection rounds a frame.
// Bound on this card, K7/K8: bytes.  It reads logp (B*T*V*4), the table
// once, and writes the backpointers (2*B*T*K*4): about 5.3 MB at the
// serving shapes (B 16, T 400, V 31, K 16, a 4-gram table of 3.69 MB), 1.6
// us at 3.35 TB/s; the operations are far below that.  In practice it is
// bound by the serial chain of T frames, each an absorb and K rounds of a
// block-wide argmax with a barrier each, on B = 16 of the 132 SMs.
// K9: operations.  The LM step of a beam that appends is 2 * 4H * (E + H)
// FMA-operations for layer 0 and 2 * 4H * 2H for each further layer, plus
// 2 * H * V for w_out: up to ~29 MFLOP a frame and utterance at the default
// LM (E 128, H 256, 2 layers, K 16), ~190 GFLOP for 16 x 400 frames, ~2.8 ms
// at 67 TFLOP/s fp32 if every beam appended every frame; the data needs a
// few steps a frame, and the bound counts those.  Here it runs on B of the
// 132 SMs, one block an utterance, and a block re-reads the 3.6 MB of
// weights from L2 for each group of four stepping beams in a frame;
// spreading the step over a cluster or all SMs is later work.
//
// Design, first and simple: one block per utterance with the time loop
// inside (the beam is a serial chain over frames); one thread per candidate
// lane (K*C = 496 at V = 31, 128 at A = 8), looping when K*C > 1024.  The
// beam fields (pb, pnb, hash, last, length, lm score, context; double
// buffered), the candidate arrays and the frame's logp row live in shared
// memory; the table stays in device memory (L2-resident: 3.69 MB).  The
// TPU kernel's one-hot gathers, lane concatenations, masked-sum extractions
// and time chunks were Mosaic workarounds and have no counterpart here.
// K9 keeps every beam's LM state in shared memory for the whole utterance:
// h and c (layers, K, H) fp32, double-buffered for the parent reorder (an
// index), and the log-prob rows (K, V); about 150 KB at the default LM.
// Where that does not fit a block (more layers, a wider LM, a larger beam)
// the wrapper hands a device scratch, and the block keeps its state there
// (L2-resident) through the same generic pointers: same code, same order.
// The weights (3.6 MB fp32) stay in device memory, L2-resident.  The LM
// step runs only for the beams that appended, packed in groups of four: a
// thread takes one hidden unit j of one group, keeps the four gate sums of
// its four beams in registers, and reads the weight columns j, H+j, 2H+j
// and 3H+j (coalesced across the warp) once for the four beams; the beams'
// inputs sit in shared memory as float4 per input index.
//
// Past a block's shared memory.  A block of K7/K8 needs 72 K + 17 K C +
// 8 V + 512 bytes (beam 387 and up over the 31 chars passes the 232,448 a
// Hopper block may have), K9 also the LM step's packed inputs (beam 64 with
// an LM of H 512 passes it with the state in a scratch), and a thread holds
// one pick (K <= 1024).  Where a block does not fit (ops/beam_cuda.py::fits,
// from the shapes before the launch) the same kernel runs in its kInScratch
// form: the working set, laid out as in shared memory, lies in the block's
// slice of a device scratch (L1/L2-resident), the beams loop over the
// threads, and each frame's picks pass through the scratch.  Same code, same
// order of operations, so the same result as the shared form; slower, as
// every access of the working set goes through L1.  It counts under its own
// names (prefix_beam_wide, ..._topa_wide, prefix_beam_rnn_wide,
// ..._rnn_topa_wide).  No model configuration of the repo reaches it.

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

// Top-K: K rounds of a block argmax over the N keys; candidate j belongs to
// thread j % nt, which alone reads and clears its keys, so no barrier is
// needed before the first round.  Thread r < K gets pick r's key; with
// kPicks (more beams than threads) thread 0 also writes it to picks[r], and
// the caller synchronises before reading them.
template <bool kPicks = false>
__device__ __forceinline__ unsigned long long select_topk(unsigned long long* key,
                                                          unsigned long long* wbest, int N,
                                                          int K, int tid, int nt,
                                                          unsigned long long* picks = nullptr) {
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
    if (kPicks && tid == 0) picks[r] = best;
  }
  return mine;
}

constexpr int kMaxLayers = 8;

// K9's LM: the weights in device memory in the JAX layouts, and the state
// after <sos> that every beam starts from.
struct RnnLm {
  const float* embed;            // (V, E)
  const float* w_out;            // (H, V)
  const float* b_out;            // (V)
  const float* h0;               // (nl, H)
  const float* c0;               // (nl, H)
  const float* lmp0;             // (V) log-probs after <sos>
  const float* wx[kMaxLayers];   // (E for layer 0, else H; 4H)
  const float* wh[kMaxLayers];   // (H, 4H)
  const float* b[kMaxLayers];    // (4H)
  int nl, E, H;
};

// K9's LM state and scratch in shared memory.
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
// search's keys 8 (K + K*C), warp maxima 512, 4 (16 K + 2 K*C + 2 V) of
// fields, candidates and the row, and K*C absorbed flags; then, for K9 from
// the next 16-byte boundary, the LM's xin floats, its state (h, c and lmp
// floats) unless that lives in a global scratch, and 3 K + 1 ints.
__host__ __device__ inline size_t search_smem_bytes(int K, int C, int V) {
  return 72 * (size_t)K + 17 * (size_t)K * C + 8 * (size_t)V + 512;
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
// device scratch of scratch_block_bytes, then the K picks of a frame; no
// shared memory, and any beam, more beams than threads included.
enum Place { kShared = 0, kLmStateInScratch = 1, kInScratch = 2 };

// One block's slice of the kInScratch scratch: the working set as kShared
// lays it out (K9's with its LM state), then from the next 16 bytes the K
// picks (8 bytes each), to a 16-byte boundary.  ops/beam_cuda.py::
// scratch_bytes computes the same.
__host__ __device__ inline size_t picks_offset(int K, int C, int V, bool rnn, int nl, int E,
                                               int H) {
  const size_t work =
      rnn ? lm_smem_offset(K, C, V) + lm_smem_bytes(K, V, nl, E, H, true)
          : search_smem_bytes(K, C, V);
  return (work + 15) / 16 * 16;
}

__host__ __device__ inline size_t scratch_block_bytes(int K, int C, int V, bool rnn, int nl,
                                                      int E, int H) {
  return (picks_offset(K, C, V, rnn, nl, E, H) + 8 * (size_t)K + 15) / 16 * 16;
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
  const float *wx = lm.wx[l], *wh = lm.wh[l], *bias = lm.b[l];
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

template <bool kTopA, bool kRnn, int kPlace>
__global__ void __launch_bounds__(1024) prefix_beam_kernel(
    const float* __restrict__ logp, const float* __restrict__ top_val,
    const int* __restrict__ top_idx, const int* __restrict__ lens,
    const float* __restrict__ table, int* parents, int* appends,
    int* __restrict__ tokens, int* __restrict__ out_len, float* __restrict__ out_score,
    int T, int V, int K, int C, int L, int n_ctx, float alpha, float beta, RnnLm lm,
    float* scratch) {
  const int KC = K * C, N = K + KC;
  extern __shared__ __align__(16) unsigned long long smem[];
  // The working set's base: shared memory, or (kInScratch) this block's
  // slice of the scratch, followed there by the frame's picks.
  unsigned long long* base = smem;
  unsigned long long* picks = nullptr;                    // (K) kInScratch
  if constexpr (kPlace == kInScratch) {
    const size_t off = picks_offset(K, C, V, kRnn, lm.nl, lm.E, lm.H);
    char* slice = reinterpret_cast<char*>(scratch) +
                  (size_t)blockIdx.x * scratch_block_bytes(K, C, V, kRnn, lm.nl, lm.E, lm.H);
    base = reinterpret_cast<unsigned long long*>(slice);
    picks = reinterpret_cast<unsigned long long*>(slice + off);
  }
  unsigned long long* key = base;                         // (N) selection keys
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
  const int n_t = min(max(lens[b], 0), T);
  // A thread a beam; beams past the block's threads (kInScratch) loop.
  for (int r = tid; r < K; r += nt) {
    pb[r] = r == 0 ? 0.0f : NEG_INF;
    pnb[r] = NEG_INF;
    lms[r] = 0.0f;
    hsh[r] = (uint32_t)(-(r + 1));
    last[r] = -1;
    len[r] = 0;
    ctx[r] = 0;
  }
  if constexpr (kRnn) {  // every beam starts from the state after <sos>
    for (int idx = tid; idx < lm.nl * K * lm.H; idx += nt) {
      const int at = (idx / (K * lm.H)) * lm.H + idx % lm.H;
      rnn.h[idx] = lm.h0[at];
      rnn.c[idx] = lm.c0[at];
    }
    for (int idx = tid; idx < K * V; idx += nt) rnn.lmp[idx] = lm.lmp0[idx % V];
  }
  int cur = 0;
  for (int t = 0; t < n_t; ++t) {
    const float *pb_c = pb + cur * K, *pnb_c = pnb + cur * K, *lms_c = lms + cur * K;
    const uint32_t* hsh_c = hsh + cur * K;
    const int *last_c = last + cur * K, *len_c = len + cur * K, *ctx_c = ctx + cur * K;
    const size_t row = (size_t)b * T + t;
    const float* lmp_c = kRnn ? rnn.lmp + (size_t)cur * K * V : nullptr;

    // The frame's row; K8 clears its char -> slot map.
    for (int v = tid; v < V; v += nt) {
      lp[v] = logp[row * V + v];
      if (kTopA) slot[v] = -1;
    }
    __syncthreads();

    // Stays (a thread a beam) and extensions (a thread a lane).
    for (int r = tid; r < K; r += nt) {
      const float total = lse(pb_c[r], pnb_c[r]);
      spb[r] = total + lp[0];
      spnb[r] = last_c[r] >= 0 ? pnb_c[r] + lp[last_c[r]] : NEG_INF;
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
      // The beam's LM row: K9's log-probs, else the table's context row.
      const float* lm_row = kRnn ? lmp_c + k * V
                                 : (table != nullptr ? table + (size_t)ctx_c[k] * V : nullptr);
      float l = lms_c[k];
      if (lm_row != nullptr) l = __fadd_rn(l, __fadd_rn(__fmul_rn(alpha, lm_row[c]), beta));
      elm[lane] = l;  // no FMA on the fusion line
      absorbed[lane] = 0;
    }
    __syncthreads();

    // Absorb: the char that would turn beam k into alive stay k' is
    // c = h_k' - M h_k (mod 2^32); at most one lane of each beam k matches.
    for (int r = tid; r < K; r += nt) {
      const float sn = spnb[r];
      float add = NEG_INF;
      if (lse(spb[r], sn) > NEG_INF / 2) {
        const uint32_t h2 = hsh_c[r];
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
      spnb[r] = lse(sn, add);
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

    constexpr bool kPicks = kPlace == kInScratch;
    const unsigned long long mine = select_topk<kPicks>(key, wbest, N, K, tid, nt, picks);
    if constexpr (kPicks) __syncthreads();  // thread 0 wrote the last pick

    // The K picks become the next beams; record the backpointers.
    for (int r = tid; r < K; r += nt) {
      const unsigned long long pick = kPicks ? picks[r] : mine;
      const int j = key_index(pick), nx = (cur ^ 1) * K + r;
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
      if (key_score(pick) <= NEG_INF / 2) {  // a dead filler
        pb[nx] = NEG_INF;
        pnb[nx] = NEG_INF;
        hsh[nx] = (uint32_t)(-(r + 1));
      }
      if constexpr (kRnn) {
        rnn.par[r] = k;
        rnn.app[r] = append;
      }
      parents[row * K + r] = k;
      appends[row * K + r] = append;
    }
    __syncthreads();
    if constexpr (kRnn) {
      advance_lm(lm, rnn, cur, K, V, tid, nt);
      __syncthreads();
    }
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

// Launches one block per utterance with the dynamic shared memory set.
template <bool kTopA, bool kRnn, int kPlace = kShared>
int launch(int B, int threads, size_t smem, void* stream, const float* logp,
           const float* top_val, const int* top_idx, const int* lens, const float* table,
           int* parents, int* appends, int* tokens, int* out_len, float* out_score, int T,
           int V, int K, int C, int L, int n_ctx, float alpha, float beta, const RnnLm& lm,
           float* scratch) {
  auto kernel = prefix_beam_kernel<kTopA, kRnn, kPlace>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  kernel<<<B, threads, smem, (cudaStream_t)stream>>>(
      logp, top_val, top_idx, lens, table, parents, appends, tokens, out_len, out_score, T,
      V, K, C, L, n_ctx, alpha, beta, lm, scratch);
  return cudaGetLastError();
}

// K10: one frame's merge and top-K over the candidates gathered from the
// beam shards (decoding/prefix_beam_sharded.py): K7's per-frame merge,
// lifted out of its time loop.  Ks stays and Ks*nb extension lanes, lane
// (k, c-1) beam k's extension by char c = 1..nb; lanes' last char is their
// appended one.  One block a row, one thread a candidate.  The absorb is
// K7's written again: as a function shared with the search kernel, inlined
// or not, it changed how ptxas allocated K9's LM step, and K9 ran several
// times slower on the H100; so only the selection (select_topk) is shared.
struct MergeIn {
  const float *s_pb, *s_pnb, *s_lm;                      // (B, Ks)
  const int *s_hash, *s_last, *s_parent, *s_ctx;         // (B, Ks)
  const float *e_pnb, *e_lm;                             // (B, Ks * nb)
  const int *e_hash, *e_parent, *e_append, *e_ctx;       // (B, Ks * nb)
};

struct MergeOut {
  float *score, *pb, *pnb, *lm;                          // (B, K)
  int *hash, *last, *parent, *append, *ctx;              // (B, K)
};

__host__ __device__ inline size_t merge_smem_bytes(int Ks, int nb) {
  const size_t KC = (size_t)Ks * nb, N = Ks + KC;
  return 8 * N + 512 + 12 * (size_t)Ks + 5 * KC;
}

__global__ void __launch_bounds__(1024) merge_topk_kernel(MergeIn in, MergeOut out, int Ks,
                                                          int nb, int K) {
  const int KC = Ks * nb, N = Ks + KC;
  extern __shared__ __align__(16) unsigned long long smem[];
  unsigned long long* key = smem;                          // (N) selection keys
  unsigned long long* wbest = key + N;                     // (2, 32) warp maxima
  float* spb = reinterpret_cast<float*>(wbest + 64);       // (Ks) stays
  float* spnb = spb + Ks;
  float* epnb = spnb + Ks;                                 // (KC) lanes
  uint32_t* hsh = reinterpret_cast<uint32_t*>(epnb + KC);  // (Ks)
  unsigned char* absorbed = reinterpret_cast<unsigned char*>(hsh + Ks);  // (KC)
  const int b = blockIdx.x, tid = threadIdx.x, nt = blockDim.x;
  const size_t so = (size_t)b * Ks, eo = (size_t)b * KC;
  for (int k = tid; k < Ks; k += nt) {
    spb[k] = in.s_pb[so + k];
    spnb[k] = in.s_pnb[so + k];
    hsh[k] = (uint32_t)in.s_hash[so + k];
  }
  for (int l = tid; l < KC; l += nt) {
    epnb[l] = in.e_pnb[eo + l];
    absorbed[l] = 0;
  }
  __syncthreads();
  // Absorb: K7's, with lane (k, c - 1) for char c = h_k' - M h_k.
  if (tid < Ks) {
    const float sn = spnb[tid];
    float add = NEG_INF;
    if (lse(spb[tid], sn) > NEG_INF / 2) {
      const uint32_t h2 = hsh[tid];
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
    spnb[tid] = lse(sn, add);
  }
  __syncthreads();
  // Selection keys: stays are candidates 0..Ks-1, lane l is Ks + l.
  for (int j = tid; j < N; j += nt) {
    float s;
    if (j < Ks) {
      s = lse(spb[j], spnb[j]) + in.s_lm[so + j];
    } else {
      const int l = j - Ks;
      s = absorbed[l] ? NEG_INF : epnb[l] + in.e_lm[eo + l];
    }
    key[j] = make_key(s, j);
  }
  const unsigned long long mine = select_topk(key, wbest, N, K, tid, nt);
  if (tid < K) {
    const int r = tid, j = key_index(mine);
    const size_t o = (size_t)b * K + r;
    const float score = key_score(mine);
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
      out.ctx[o] = in.s_ctx[so + j];
    } else {
      const size_t l = eo + (j - Ks);
      pb = NEG_INF;
      pnb = epnb[j - Ks];
      hash = in.e_hash[l];
      out.lm[o] = in.e_lm[l];
      out.last[o] = in.e_append[l];
      out.parent[o] = in.e_parent[l];
      out.append[o] = in.e_append[l];
      out.ctx[o] = in.e_ctx[l];
    }
    const bool dead = score <= NEG_INF / 2;  // a dead filler carries no mass
    out.score[o] = score;
    out.pb[o] = dead ? NEG_INF : pb;
    out.pnb[o] = dead ? NEG_INF : pnb;
    out.hash[o] = dead ? -(r + 1) : hash;
  }
}

}  // namespace

// top_val/top_idx null: K7 over all V chars (C = V); else K8 over C = A.
// parents/appends: (B, T, K) int32 scratch; tokens (B, L); out_len,
// out_score (B).  scratch: null keeps each block's working set in shared
// memory (the wrapper checks K <= 1024 and its size); else a device scratch
// of B * scratch_block_bytes(K, C, V, false, 0, 0, 0) bytes, 16-byte
// aligned, holds it (kInScratch: any K and C).
extern "C" int prefix_beam(const float* logp, const float* top_val, const int* top_idx,
                           const int* lens, const float* table, int* parents, int* appends,
                           int* tokens, int* out_len, float* out_score, int B, int T, int V,
                           int K, int C, int L, int n_ctx, float alpha, float beta,
                           float* scratch, void* stream) {
  if (B == 0) return 0;
  const bool apart = scratch != nullptr;
  const size_t smem = apart ? 0 : search_smem_bytes(K, C, V);
  const long long lanes = (long long)K * C;
  const int threads = lanes >= 1024 ? 1024 : (int)(lanes + 31) / 32 * 32;
  const RnnLm none = {};
  return (top_idx != nullptr
              ? (apart ? launch<true, false, kInScratch> : launch<true, false>)
              : (apart ? launch<false, false, kInScratch> : launch<false, false>))(
      B, threads, smem, stream, logp, top_val, top_idx, lens, table, parents, appends, tokens,
      out_len, out_score, T, V, K, C, L, n_ctx, alpha, beta, none, scratch);
}

// K9: the search fused with the char LSTM LM.  weights: a host array of
// device pointers embed, w_out, b_out, h0, c0, lmp0, then wx, wh and b of
// each of the nl layers.  Same outputs and scratch as prefix_beam.
// place (a Place) and scratch: kShared (scratch null) keeps every block's
// working set in shared memory; kLmStateInScratch keeps the LM state in a
// device scratch of B * lm_state_floats(K, V, nl, H) floats (for LMs or
// beams whose state does not fit beside the search); kInScratch keeps all
// of it in a device scratch of B * scratch_block_bytes(K, C, V, true, nl,
// E, H) bytes (where even the LM step's packed inputs do not fit, or K >
// 1024).  The wrapper checks nl <= 8 and, for the first two, the
// shared-memory size.
extern "C" int prefix_beam_rnn(const float* logp, const float* top_val, const int* top_idx,
                               const int* lens, const float* const* weights, int nl, int E,
                               int H, int* parents, int* appends, int* tokens, int* out_len,
                               float* out_score, int B, int T, int V, int K, int C, int L,
                               float alpha, float beta, float* scratch, int place,
                               void* stream) {
  if (B == 0) return 0;
  if (nl < 1 || nl > kMaxLayers) return cudaErrorInvalidValue;
  RnnLm lm = {};
  lm.embed = weights[0];
  lm.w_out = weights[1];
  lm.b_out = weights[2];
  lm.h0 = weights[3];
  lm.c0 = weights[4];
  lm.lmp0 = weights[5];
  for (int l = 0; l < nl; ++l) {
    lm.wx[l] = weights[6 + l];
    lm.wh[l] = weights[6 + nl + l];
    lm.b[l] = weights[6 + 2 * nl + l];
  }
  lm.nl = nl;
  lm.E = E;
  lm.H = H;
  if (place < kShared || place > kInScratch || (place == kShared) != (scratch == nullptr))
    return cudaErrorInvalidValue;
  const size_t smem = place == kInScratch
                          ? 0
                          : lm_smem_offset(K, C, V) +
                                lm_smem_bytes(K, V, nl, E, H, place == kShared);
  const long long groups = (K + 3) / 4;
  long long work = (long long)K * C;
  work = work > H * groups ? work : H * groups;
  work = work > V * groups ? work : V * groups;
  const int threads = work >= 1024 ? 1024 : (int)(work + 31) / 32 * 32;
  const bool topa = top_idx != nullptr;
  auto run = place == kShared            ? (topa ? launch<true, true> : launch<false, true>)
             : place == kLmStateInScratch ? (topa ? launch<true, true, kLmStateInScratch>
                                                  : launch<false, true, kLmStateInScratch>)
                                          : (topa ? launch<true, true, kInScratch>
                                                  : launch<false, true, kInScratch>);
  return run(B, threads, smem, stream, logp, top_val, top_idx, lens, nullptr, parents, appends,
             tokens, out_len, out_score, T, V, K, C, L, 1, alpha, beta, lm, scratch);
}

// K10: the per-frame merge and top-K of the beam-sharded search.  Inputs
// (B, Ks) stays and (B, Ks * nb) lanes, outputs (B, K), all contiguous on
// one device.  The wrapper checks K <= Ks + Ks * nb, Ks <= 1024 and the
// shared-memory size.
extern "C" int merge_topk(const float* s_pb, const float* s_pnb, const float* s_lm,
                          const int* s_hash, const int* s_last, const int* s_parent,
                          const int* s_ctx, const float* e_pnb, const float* e_lm,
                          const int* e_hash, const int* e_parent, const int* e_append,
                          const int* e_ctx, float* score, float* pb, float* pnb, float* lm,
                          int* hash, int* last, int* parent, int* append, int* ctx, int B,
                          int Ks, int nb, int K, void* stream) {
  if (B == 0) return 0;
  const MergeIn in = {s_pb, s_pnb, s_lm, s_hash, s_last, s_parent, s_ctx,
                      e_pnb, e_lm, e_hash, e_parent, e_append, e_ctx};
  const MergeOut out = {score, pb, pnb, lm, hash, last, parent, append, ctx};
  const size_t smem = merge_smem_bytes(Ks, nb);
  int threads = (Ks + Ks * nb + 31) / 32 * 32;
  threads = threads > 1024 ? 1024 : threads;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        merge_topk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  merge_topk_kernel<<<B, threads, smem, (cudaStream_t)stream>>>(in, out, Ks, nb, K);
  return cudaGetLastError();
}

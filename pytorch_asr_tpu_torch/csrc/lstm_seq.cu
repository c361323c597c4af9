// One LSTM direction over a padded batch, for Hopper (sm_90a), CUDA C++:
// the inference forward (K2), and the training forward and backward (K3);
// and both directions of a BiLSTM layer in one launch (K11).
//
// Replaces: pytorch_asr_tpu/ops/lstm_pallas.py::lstm_seq.
//   lstm_seq_fwd        inference forward (_fwd_impl with save_residuals=False,
//                       kernel body _fwd_kernel);
//   lstm_seq_train_fwd  training forward (_fwd_impl(save_residuals=True),
//                       the residual writes of _fwd_kernel);
//   lstm_seq_bwd        backward (_vjp_bwd -> _bwd_kernel).
// And pytorch_asr_tpu/ops/lstm_pallas.py:703 bilstm_seq (K11):
//   bilstm_seq_fwd, bilstm_seq_train_fwd  _dual_fwd_impl :722 (_fwd_kernel_dual
//                       :495), without and with residuals;
//   bilstm_seq_bwd      _dual_vjp_bwd :822 (_bwd_kernel_dual :571).
// lstm_seq_per_utterance and bilstm_seq_per_utterance run the same forwards
// on the per-utterance kernel: the wide route below, and the oracle.
// lstm_seq_stream is K2 started from a carried (h, c) that hands its state
// on (the kCarry forms of both forward kernels): the chunk of the streaming
// recognizer, pytorch_asr_tpu/decoding/streaming.py:156 _lstm_chunk, a
// lax.scan there (no TPU kernel; K2 computes the same function).
// Python side: ops/lstm_cuda.py.
//
// Computes, for x (B, T, D) in fp32 or bf16, wih (D, 4H) in x's type, whh
// (H, 4H) fp32, bias (4H) fp32 and lengths (B) int32:
//   pre_t = (x_t @ wih + bias) + h_{t-1} @ whh        gates i, f, g, o
//   c_t = sig(f) c_{t-1} + sig(i) tanh(g),   h_t = sig(o) tanh(c_t)
// with the recurrence in fp32.  The carry is held where t >= len, and the
// output (B, T, H), in fp32 or bf16, is zero outside [0, len).  The reverse
// direction walks t = len-1 .. 0 inside the kernel; both directions share
// the [0, len) window, as in the Pallas kernel.
//
// Training forward residuals, time-major as in the Pallas kernel, in fp32 or
// bf16 (the residual type):
//   acts (T, B, 4H): the candidate gate activations (i, f, g, o) at every
//     step, valid or not.  At the steps outside the window the held state
//     enters: zeros for the reverse direction (those steps come first), the
//     last valid h for the forward one, so one extra h @ whh serves them all.
//   ct (T, B, H): the masked carry, the c that enters the next step.
// The Pallas kernel also wrote h/c snapshots at each time-chunk boundary,
// because its grid is chunked.  Here the whole time loop is in one launch,
// so the backward enters from zeros and needs no snapshots.
//
// The forward recurrence of K2 and K3 (lstm_grid_kernel) runs on a
// co-resident grid: one CTA an SM, launched with cudaLaunchCooperativeKernel
// so that all of them run at once.  CTA j owns the hidden units [j U, j U +
// U) and with them the gate columns k, H+k, 2H+k, 3H+k of each unit k, so a
// unit's cell update needs nothing from another CTA.  At launch each CTA
// copies its 4U columns of whh (all H rows, fp32) into shared memory, where
// they stay; ops/lstm_cuda.py::recurrence_grid picks U and checks that a
// CTA's bytes fit.  Every utterance of the launch then steps together: at
// step s, utterance b takes t = s forward or len_b - 1 - s reverse; each CTA
// stages h_{s-1} of all B utterances from a ping-pong buffer in device memory
// into shared memory; a thread runs one dot chain (b, gate column): r
// ascending, the order of recurrent_product, so every value equals the
// per-utterance kernel's bit for bit; the CTA updates its units' cells and
// writes their h to the other buffer; then the CTAs meet at a grid
// barrier.  K2 walks max(len) steps; K3's forward walks T, because its
// residuals cover every t: past its window a forward row computes its acts
// from the held h and c, a reverse row from zeros, as fill_invalid_residuals
// does below.  K11's forward is the same kernel on a grid of both
// directions (below).
//
// Backward, given gy (B, T, H) fp32 (the output's gradient):
//  1. the dh recurrence walks each utterance's valid window against the
//     forward's processing order.  Like _bwd_kernel it rebuilds c_prev from
//     ct and h_prev = o_prev * tanh(c_prev) from the stored residuals (so
//     bf16 residuals give the gradients of bf16 residuals), and the first
//     processed step enters from zeros.  dgates is 0 outside [0, len), and
//     the upstream gradient there never enters the chain (the output there
//     is a constant 0).  It writes dgates (B, T, 4H) and h_prev (B, T, H) in
//     fp32 to device memory; the TPU kept dgates in VMEM.  About 20 MB a
//     direction at the training shapes (B 8, T' 400, H 384).
//     lstm_bwd_grid_kernel runs it on a co-resident grid, as the forward:
//     CTA j owns the hidden units [j U, j U + U) and holds their rows of whh
//     (U x 4H fp32) in shared memory.  All utterances step together; a step
//     stages the dgates rows of the step before (B x 4H, written by every
//     CTA) from L2, computes dh of its units (dh[k] = dgates @ whh[k, :]^T),
//     runs their cell backward, writes their 4 dgates columns and h_prev,
//     and meets the other CTAs at the grid barrier.  Each dh chain sums in
//     lstm_bwd_recurrence_kernel's order (lane l takes columns l, l + 32,
//     ... with fmaf from 0, then the xor butterfly 16 .. 1) and both kernels
//     share the cell's arithmetic (cell_backward), so the two give the same
//     bits.  Where the grid cannot hold whh's rows and one staged row
//     (ops/lstm_cuda.py::backward_route: from H 1305 at B 8) the op takes
//     lstm_bwd_recurrence_kernel, a block an utterance that reads all of whh
//     (2.4 MB fp32 at H 384) from L2 every step: the backward's wide route.
//  2. products, each a tiled shared-memory GEMM (gemm_kernel, the style of
//     K2's projection) with fp32 FMA accumulation: dx = dgates @ wih^T in x's
//     type; dwih = x^T @ dgates in wih's type; dwhh = h_prev^T @ dgates fp32;
//     db = column sums of dgates (column_sum_kernel).  The weight gradients
//     reduce over B*T rows inside one block per output tile, with no atomics,
//     so they are the same from run to run.
//
// Bound on this card: operations.  At the training shapes the projection and
// the three backward products are each about 2 * B*T * 4H * D operations,
// against tens of MB of inputs and outputs.  In practice the recurrences are
// bound by latency: their steps are serial.  The forward's step is one dot
// chain of H dependent FMAs (the order that keeps it bit-equal admits no
// split of the sum), the staging of h from L2 and a grid barrier.  The
// backward's step is the same kind: the staging of B x 4H floats of dgates
// from L2, a dh chain of 4H / 32 dependent FMAs a lane, the cells and the
// barrier.  Later work: the products on tensor cores.
//
// K11 runs the two directions of a layer (weights stacked (2, ...): forward,
// then reverse).  Its forward recurrence is lstm_grid_kernel's dual form
// (kDual): a cooperative grid of (ctas, 2) CTAs, blockIdx.y the direction,
// each half holding its own direction's whh columns in shared memory
// (ops/lstm_cuda.py::recurrence_grid with directions 2 gives each direction
// half the SMs: 64 CTAs at H 384, 512 and 640).  A half reads its own
// xproj and keeps its own ping-pong h buffer, writes columns [d H, (d + 1)
// H) of the (B, T, 2H) output and its own residuals.  The two halves step
// in lockstep, max(len) steps without residuals and T with them, and one
// barrier a step counts the CTAs of both.  Every value is computed by the
// same operations in the same order as two K2 (K3) launches, so K11 equals
// them bit for bit.  Bound as K2/K3, twice their operations; in practice a
// step costs about one K2 step with twice the dot chains a CTA, the staging
// and barrier shared (PERF.md).  The input projections are K2's GEMM, once
// a direction.  The backward's dh recurrence is lstm_bwd_grid_kernel's
// dual form alike: a cooperative (ctas, 2) grid, each half holding its
// direction's rows of whh (ops/lstm_cuda.py::backward_grid with directions
// 2: 64 CTAs of 6 units a direction at H 384, of 8 at H 512), reading its
// own gy columns and residuals and writing its own dgates and hprev, one
// barrier a step counting the CTAs of both halves; every dh chain and cell
// is K3's, so the outputs equal two K3 backward launches bit for bit.  A
// step costs about one K3 backward step with twice the chains a CTA.  Past
// the dual grid (ops/lstm_cuda.py::backward_route: from H 925 at B 8) it
// runs both directions' per-utterance recurrences (lstm_bwd_recurrence_kernel
// with kDual: the grid (B, 2), the same bits), its wide route and the
// grid's oracle (bilstm_seq_bwd_per_utterance).  Then K3's products for
// each direction, and dx = dx_f + dx_b, each half in x's type (as the JAX
// kernel writes dxf and dxb in x's type and sums them).
//
// The oracle.  lstm_recurrence_kernel<..., kDual> walks each utterance of
// each direction in its own block and reads all of whh from L2 every step:
// K11's forward until the dual grid, and 3-5x slower than it.  It stays
// compiled as the bit-equality oracle of the grid kernel, reached as such
// only through bilstm_seq_per_utterance under the oracle's own launch count
// (ops/lstm_cuda.py::_bilstm_seq_per_utterance); the card tests and
// chip_smoke.py call it, and chip_smoke.py checks that no op or model path
// launches the oracle.
//
// The wide route.  The grid must hold a CTA's 4 units columns of whh (all H
// rows) in one SM's shared memory, with units = ceil(H / SMs): one direction
// fits up to H ~1300 at B 8-16, K11's dual grid (66 SMs a direction) up to
// H ~920, and a batch past a few hundred utterances at H 512-640 fits
// neither.  The JAX package runs those widths (its TPU kernel keeps whh in
// VMEM; its CPU path scans).  There the ops launch the per-utterance kernel
// instead, one direction (lstm_seq_per_utterance: grid (B, 1), the reverse
// flag passed) or both (bilstm_seq_per_utterance): the same dot order and
// cell update as the grid kernel, so the same bits, at 3-5x its time.  Its
// 6 H floats of shared memory a block run to H 9,685.  The route is chosen
// from the shapes before the launch (ops/lstm_cuda.py::forward_route) and
// counted under its own names (lstm_seq_wide, lstm_seq_train_wide,
// bilstm_seq_wide, bilstm_seq_train_wide; K3's backward past its grid,
// lstm_seq_bwd_wide).  No model configuration of the repo reaches it.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "grid_sync.cuh"

namespace {

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(bf16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ bf16 from_f32<bf16>(float v) {
  return __float2bfloat16(v);  // round to nearest even, as a JAX astype
}

__device__ __forceinline__ float sigmoid(float v) { return 1.f / (1.f + expf(-v)); }

// Activation of gate column col of 4H: sigmoid for i, f, o; tanh for g.
__device__ __forceinline__ float gate_act(float v, int col, int H) {
  return (col >= 2 * H && col < 3 * H) ? tanhf(v) : sigmoid(v);
}

constexpr int BM = 64, BN = 64, BK = 16, GEMM_THREADS = 256;

// C (M, N) = sum_k A(m, k) B(k, n) (+ bias[n]), with A(m, k) = A[m*sam + k*sak]
// and B(k, n) = B[k*sbk + n*sbn], accumulated in fp32 in k order.  Each
// thread owns rows ty + 16 i and columns tx + 16 j of the block's 64x64
// tile.  The loaders walk the unit-stride axis across threads.
template <typename AT, typename BT, typename OutT>
__global__ void __launch_bounds__(GEMM_THREADS) gemm_kernel(
    const AT* __restrict__ A, long sam, long sak, const BT* __restrict__ Bm, long sbk,
    long sbn, const float* __restrict__ bias, OutT* __restrict__ C, int M, int N, int K) {
  __shared__ float As[BK][BM + 4];
  __shared__ float Bs[BK][BN];
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const bool a_rows = sak != 1;  // A's unit stride runs along m
  const bool b_rows = sbn == 1;  // B's unit stride runs along n
  float acc[4][4] = {};
  for (int k0 = 0; k0 < K; k0 += BK) {
    for (int e = threadIdx.x; e < BM * BK; e += GEMM_THREADS) {
      const int r = a_rows ? e % BM : e / BK, kk = a_rows ? e / BM : e % BK;
      const int m = m0 + r, k = k0 + kk;
      As[kk][r] = (m < M && k < K) ? to_f32(A[(size_t)m * sam + (size_t)k * sak]) : 0.f;
    }
    for (int e = threadIdx.x; e < BK * BN; e += GEMM_THREADS) {
      const int c = b_rows ? e % BN : e / BK, kk = b_rows ? e / BN : e % BK;
      const int k = k0 + kk, n = n0 + c;
      Bs[kk][c] = (k < K && n < N) ? to_f32(Bm[(size_t)k * sbk + (size_t)n * sbn]) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float a[4], bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = As[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) bv[j] = Bs[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty + 16 * i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx + 16 * j;
      if (n < N) C[(size_t)m * N + n] = from_f32<OutT>(acc[i][j] + (bias ? bias[n] : 0.f));
    }
  }
}

// pre[col] = xp[col] + h @ whh[:, col] for every gate column (thread j takes
// columns j, j + blockDim, ...; whh columns are read from L2, coalesced).
__device__ __forceinline__ void recurrent_product(const float* h, const float* whh,
                                                  const float* xp, float* pre, int H) {
  const int G = 4 * H;
  for (int col = threadIdx.x; col < G; col += blockDim.x) {
    float acc = 0.f;
#pragma unroll 8
    for (int r = 0; r < H; ++r) acc = fmaf(h[r], whh[(size_t)r * G + col], acc);
    pre[col] = (xp ? xp[col] : 0.f) + acc;
  }
}

// Training residuals at the steps outside [0, len), from the held state h, c.
template <typename ResT>
__device__ void fill_invalid_residuals(const float* xproj_b, const float* whh, const float* h,
                                       const float* c, float* pre, ResT* acts, ResT* ct,
                                       int b, int B, int T, int H, int len) {
  const int G = 4 * H;
  recurrent_product(h, whh, nullptr, pre, H);  // the held h's part, the same at each step
  __syncthreads();
  for (int t = len; t < T; ++t) {
    const float* xp = xproj_b + (size_t)t * G;
    ResT* a = acts + ((size_t)t * B + b) * G;
    for (int col = threadIdx.x; col < G; col += blockDim.x)
      a[col] = from_f32<ResT>(gate_act(xp[col] + pre[col], col, H));
    for (int k = threadIdx.x; k < H; k += blockDim.x)
      ct[((size_t)t * B + b) * H + k] = from_f32<ResT>(c[k]);
  }
  __syncthreads();
}

// One block per utterance carries h and c in shared memory across all steps
// (GPU blocks run in no order, so the TPU grid's carry across sequential grid
// steps becomes a loop inside the block).  kSave adds the training residuals.
// kDual (K11): direction blockIdx.y of a BiLSTM layer; xproj (2, B, T, 4H),
// whh (2, H, 4H), out (B, T, 2H), acts (2, T, B, 4H), ct (2, T, B, H).
// kCarry (the streaming chunk, forward, no residuals): acts (2, B, H) holds
// the state carried in, h0 then c0, and ct (2, B, H) receives the state
// handed on, h then c after the row's last valid step.
template <typename OutT, typename ResT, bool kSave, bool kDual = false, bool kCarry = false>
__global__ void __launch_bounds__(1024) lstm_recurrence_kernel(
    const float* __restrict__ xproj, const float* __restrict__ whh,
    const int* __restrict__ lengths, OutT* __restrict__ out, ResT* __restrict__ acts,
    ResT* __restrict__ ct, int T, int B, int H, int reverse) {
  extern __shared__ float smem[];
  float* h = smem;            // (H) hidden carry
  float* c = smem + H;        // (H) cell carry
  float* pre = smem + 2 * H;  // (4H) gate pre-activations of this step
  static_assert(!(kCarry && (kSave || kDual)), "a carried state: one direction, no residuals");
  const int b = blockIdx.x;
  const int G = 4 * H;
  const int len = max(0, min(lengths[b], T));
  if constexpr (kDual) {
    const int dir = blockIdx.y;
    reverse = dir;
    xproj += (size_t)dir * B * T * G;
    whh += (size_t)dir * H * G;
    out += (size_t)dir * H;
    if constexpr (kSave) {
      acts += (size_t)dir * T * B * G;
      ct += (size_t)dir * T * B * H;
    }
  }
  constexpr int kRows = kDual ? 2 : 1;  // output row stride, in H
  const float* xproj_b = xproj + (size_t)b * T * G;
  OutT* ob = out + (size_t)b * T * H * kRows;

  for (int k = threadIdx.x; k < H; k += blockDim.x) {
    if constexpr (kCarry) {
      h[k] = acts[(size_t)b * H + k];
      c[k] = acts[((size_t)B + b) * H + k];
    } else {
      h[k] = 0.f;
      c[k] = 0.f;
    }
  }
  if constexpr (kDual) {
    for (size_t i = (size_t)len * H + threadIdx.x; i < (size_t)T * H; i += blockDim.x)
      ob[i / H * 2 * H + i % H] = from_f32<OutT>(0.f);
  } else {
    for (size_t i = (size_t)len * H + threadIdx.x; i < (size_t)T * H; i += blockDim.x)
      ob[i] = from_f32<OutT>(0.f);
  }
  __syncthreads();
  // The reverse direction meets its invalid steps first, from zeros.
  if constexpr (kSave) {
    if (reverse) fill_invalid_residuals(xproj_b, whh, h, c, pre, acts, ct, b, B, T, H, len);
  }

  for (int s = 0; s < len; ++s) {
    const int t = reverse ? len - 1 - s : s;
    recurrent_product(h, whh, xproj_b + (size_t)t * G, pre, H);
    __syncthreads();
    for (int k = threadIdx.x; k < H; k += blockDim.x) {
      const float ig = sigmoid(pre[k]);
      const float fg = sigmoid(pre[H + k]);
      const float gg = tanhf(pre[2 * H + k]);
      const float og = sigmoid(pre[3 * H + k]);
      const float cn = fg * c[k] + ig * gg;
      const float hn = og * tanhf(cn);
      c[k] = cn;
      h[k] = hn;
      ob[(size_t)t * H * kRows + k] = from_f32<OutT>(hn);
      if constexpr (kSave) {
        ResT* a = acts + ((size_t)t * B + b) * G;
        a[k] = from_f32<ResT>(ig);
        a[H + k] = from_f32<ResT>(fg);
        a[2 * H + k] = from_f32<ResT>(gg);
        a[3 * H + k] = from_f32<ResT>(og);
        ct[((size_t)t * B + b) * H + k] = from_f32<ResT>(cn);
      }
    }
    __syncthreads();
  }
  if constexpr (kSave) {
    if (!reverse) fill_invalid_residuals(xproj_b, whh, h, c, pre, acts, ct, b, B, T, H, len);
  }
  if constexpr (kCarry) {  // the loop's last barrier: h and c are the last valid step's
    for (int k = threadIdx.x; k < H; k += blockDim.x) {
      ct[(size_t)b * H + k] = h[k];
      ct[((size_t)B + b) * H + k] = c[k];
    }
  }
}

// Row stride, in floats, of the shared-memory rows of whh columns and of h:
// 4 mod 32, so that the 16-byte loads of 8 neighbouring rows fall in
// distinct banks.  ops/lstm_cuda.py::recurrence_grid uses the same rule.
__host__ __device__ __forceinline__ int padded_row(int H) { return (H + 31) / 32 * 32 + 4; }

// Bytes of a CTA's shared memory: whh columns (4 units rows of HP floats),
// staged h (rows rows), gate pre-activations (B x 4 units), cell carry (B x
// units), xproj of two steps (2 x B x 4 units), 16 floats that the last
// row's loads may run into (dot_chain); then the lengths, B ints.
__host__ __device__ __forceinline__ size_t grid_smem_bytes(int H, int B, int units, int rows) {
  const size_t hp = padded_row(H);
  return sizeof(float) * ((4 * (size_t)units + rows) * hp + 13 * (size_t)B * units + 16) +
         sizeof(int) * (size_t)B;
}

// dst (n, HP) in shared memory = src (n, H) from L2 (other SMs wrote it), or
// zeros where src is null.  With H a multiple of 4 every 16 bytes go by one
// cp.async.cg (L2 only, no registers), all in flight at once, as one group.
__device__ __forceinline__ void stage_rows(float* dst, const float* src, int n, int H, int HP) {
  if (src == nullptr) {
    for (int e = threadIdx.x; e < n * H; e += blockDim.x) dst[(e / H) * HP + e % H] = 0.f;
  } else if (H % 4 == 0) {
    const int q = H / 4;
    for (int e = threadIdx.x; e < n * q; e += blockDim.x)
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(
                       smem_addr(dst + (e / q) * HP + 4 * (e % q))),
                   "l"(src + 4 * e)
                   : "memory");
  } else {
    for (int e = threadIdx.x; e < n * H; e += blockDim.x)
      dst[(e / H) * HP + e % H] = __ldcg(src + e);
  }
  cp_async_commit();
}

// sum over r ascending of h[r] w[r], one fmaf a term from 0 (the order of
// recurrent_product).  Four registers of each row hold the terms of four
// steps of four; each is reloaded right after its FMAs, three steps ahead of
// its next use, so the chain never waits on shared memory (a rotation of
// registers would make it wait: ptxas keeps the moves, and a move waits for
// its load).  h and w: 16-byte aligned rows in shared memory, which the
// loads may run past by 16 floats (into the next row, or the tail that
// grid_smem_bytes adds).
__device__ __forceinline__ float dot_chain(const float* h, const float* w, int H) {
  const float4* h4 = reinterpret_cast<const float4*>(h);
  const float4* w4 = reinterpret_cast<const float4*>(w);
  const int n4 = H / 4;
  float4 hv[4], wv[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    hv[j] = h4[j];
    wv[j] = w4[j];
  }
  float acc = 0.f;
  int q = 0;
  for (; q + 4 <= n4; q += 4) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      acc = fmaf(hv[j].x, wv[j].x, acc);
      acc = fmaf(hv[j].y, wv[j].y, acc);
      acc = fmaf(hv[j].z, wv[j].z, acc);
      acc = fmaf(hv[j].w, wv[j].w, acc);
      hv[j] = h4[q + 4 + j];
      wv[j] = w4[q + 4 + j];
    }
  }
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    if (q + j < n4) {
      acc = fmaf(hv[j].x, wv[j].x, acc);
      acc = fmaf(hv[j].y, wv[j].y, acc);
      acc = fmaf(hv[j].z, wv[j].z, acc);
      acc = fmaf(hv[j].w, wv[j].w, acc);
    }
  }
  for (int r = 4 * n4; r < H; ++r) acc = fmaf(h[r], w[r], acc);
  return acc;
}

// K2 (kSave false) and K3's training forward (kSave true) on the co-resident
// grid: see the note at the top.  CTA j owns units [k0, k0 + nu), k0 = j
// units; local column jj < 4 nu is gate jj / nu of unit k0 + jj % nu, whh's
// column of which is row jj of w_s.  A thread takes one chain (b, jj): the
// threads of a warp take 8 neighbouring b and 4 neighbouring jj, so that the
// loads of a step of four fall in distinct banks or are broadcast.  hbuf (2,
// B, H) fp32: h of the step before, ping-pong; sync: the barrier's counter,
// 0 at launch.  Utterances are staged `rows` at a time; the xproj entries of
// a step are copied into shared memory a step ahead.  trace, if not null:
// (steps, 5) int64 where thread 0 of CTA 0 writes, each step, the global
// timer (ns) as the step starts and its clock (cycles) then, after the
// staging, after the dot chains and after the cell updates.
// kDual (K11): the grid is (ctas, 2) and blockIdx.y the direction, 0
// forward, 1 reverse; xproj (2, B, T, 4H), whh (2, H, 4H), hbuf (2, 2, B,
// H), out (B, T, 2H) (direction d writes columns [d H, (d + 1) H)), acts (2,
// T, B, 4H), ct (2, T, B, H).  Both halves step in lockstep, one barrier a
// step for all their CTAs; the trace is CTA (0, 0)'s.
// kCarry (the streaming chunk: K2 forward from a carried state): acts (2, B,
// H) holds h0 then c0, staged as step 0's h and loaded as the cell carry;
// ct (2, B, H) receives h then c at each row's last valid step (rows past
// their length write no hnext, so the state is stored then, not read from
// hbuf after the loop), and a row of no steps hands on h0 and c0.
template <typename OutT, typename ResT, bool kSave, bool kDual = false, bool kCarry = false>
__global__ void __launch_bounds__(1024) lstm_grid_kernel(
    const float* __restrict__ xproj, const float* __restrict__ whh,
    const int* __restrict__ lengths, OutT* __restrict__ out, ResT* __restrict__ acts,
    ResT* __restrict__ ct, float* hbuf, unsigned* sync, long long* trace, int T, int B, int H,
    int units, int rows, int reverse) {
  extern __shared__ __align__(16) float smem[];
  static_assert(!(kCarry && (kSave || kDual)), "a carried state: one direction, no residuals");
  const int G = 4 * H, HP = padded_row(H);
  if constexpr (kDual) {
    const int dir = blockIdx.y;
    reverse = dir;
    xproj += (size_t)dir * B * T * G;
    whh += (size_t)dir * H * G;
    out += (size_t)dir * H;
    hbuf += (size_t)dir * 2 * B * H;
    if constexpr (kSave) {
      acts += (size_t)dir * T * B * G;
      ct += (size_t)dir * T * B * H;
    }
  }
  constexpr int kRows = kDual ? 2 : 1;  // out's row stride, in H
  const int k0 = blockIdx.x * units, nu = min(units, H - k0), nc = 4 * nu;
  float* w_s = smem;                       // (nc, HP): whh[:, col] of each owned column
  float* h_s = w_s + 4 * units * HP;       // (rows, HP): h of the utterances staged
  float* pre_s = h_s + rows * HP;          // (B, nc): this step's gates
  float* c_s = pre_s + 4 * B * units;      // (B, nu): cell carry
  float* xp_s = c_s + B * units;           // (2, B, nc): xproj of a step, ping-pong
  int* len_s = reinterpret_cast<int*>(xp_s + 8 * B * units);
  // Copies the xproj entries of step s that this CTA's chains add into
  // xp_s[s % 2] (4-byte cp.async, one group).
  auto fetch_xproj = [&](int s) {
    float* dst = xp_s + (s & 1) * 4 * B * units;
    for (int i = threadIdx.x; i < B * nc; i += blockDim.x) {
      const int b = i / nc, jj = i % nc, len = len_s[b];
      if (!kSave && s >= len) continue;
      const int t = s < len && reverse ? len - 1 - s : s;
      const float* src = xproj + ((size_t)b * T + t) * G + (jj / nu) * H + k0 + jj % nu;
      asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(smem_addr(dst + i)),
                   "l"(src)
                   : "memory");
    }
    cp_async_commit();
  };

  for (int e = threadIdx.x; e < H * nc; e += blockDim.x) {
    const int r = e / nc, jj = e % nc;
    w_s[jj * HP + r] = whh[(size_t)r * G + (jj / nu) * H + k0 + jj % nu];
  }
  int steps = kSave ? T : 0;
  for (int b = 0; b < B; ++b) {
    const int len = max(0, min(lengths[b], T));
    if (!kSave) steps = max(steps, len);
    if (threadIdx.x == 0) len_s[b] = len;
    for (int e = threadIdx.x; e < (T - len) * nu; e += blockDim.x)
      out[((size_t)b * T + len + e / nu) * H * kRows + k0 + e % nu] = from_f32<OutT>(0.f);
  }
  for (int e = threadIdx.x; e < B * nu; e += blockDim.x) {
    if constexpr (kCarry) {
      const int b = e / nu, k = k0 + e % nu;
      c_s[e] = acts[((size_t)B + b) * H + k];
      if (min(lengths[b], T) <= 0) {
        ct[(size_t)b * H + k] = acts[(size_t)b * H + k];
        ct[((size_t)B + b) * H + k] = c_s[e];
      }
    } else {
      c_s[e] = 0.f;
    }
  }
  __syncthreads();
  fetch_xproj(0);

  long long* tr = blockIdx.x == 0 && blockIdx.y == 0 && threadIdx.x == 0 ? trace : nullptr;
  for (int s = 0; s < steps; ++s) {
    if (tr) {
      tr[5 * s] = (long long)global_ns();
      tr[5 * s + 1] = clock64();
    }
    const float* hcur = hbuf + (size_t)(s & 1) * B * H;
    float* hnext = hbuf + (size_t)((s + 1) & 1) * B * H;
    const float* xp = xp_s + (s & 1) * 4 * B * units;
    for (int b0 = 0; b0 < B; b0 += rows) {
      const int nb = min(rows, B - b0);
      if (b0 > 0) __syncthreads();  // the last group's chains have read h_s
      const float* h_first = nullptr;  // step 0's h: zeros, or the carried h0
      if constexpr (kCarry) h_first = acts + (size_t)b0 * H;
      stage_rows(h_s, s > 0 ? hcur + (size_t)b0 * H : h_first, nb, H, HP);
      if (b0 == 0 && s + 1 < steps) {
        fetch_xproj(s + 1);  // lands during this step; all older groups done
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
      if (tr && b0 == 0) tr[5 * s + 2] = clock64();
      const int nb8 = (nb + 7) / 8;
      for (int i = threadIdx.x; i < nb8 * 8 * nc; i += blockDim.x) {
        const int g = i / 8;  // 8 utterances x 4 columns a warp
        const int bl = 8 * (g / 4 % nb8) + i % 8, jj = 4 * (g / (4 * nb8)) + g % 4;
        if (bl >= nb) continue;
        const int b = b0 + bl, len = len_s[b];
        const bool valid = s < len;
        if (!kSave && !valid) continue;
        const float xv = xp[b * nc + jj];
        // A reverse row past its window enters from zeros.
        const float acc = valid || !reverse ? dot_chain(h_s + bl * HP, w_s + jj * HP, H) : 0.f;
        if (valid) {
          pre_s[b * nc + jj] = xv + acc;
        } else if constexpr (kSave) {  // as fill_invalid_residuals: pre = 0 + acc
          const int col = (jj / nu) * H + k0 + jj % nu;
          acts[((size_t)s * B + b) * G + col] = from_f32<ResT>(gate_act(xv + (0.f + acc), col, H));
        }
      }
    }
    __syncthreads();
    if (tr) tr[5 * s + 3] = clock64();
    for (int i = threadIdx.x; i < B * nu; i += blockDim.x) {
      const int b = i % B, u = i / B, k = k0 + u, len = len_s[b];
      float* c = c_s + b * nu + u;
      if (s < len) {
        const int t = reverse ? len - 1 - s : s;
        const float* p = pre_s + b * nc;
        const float ig = sigmoid(p[u]);
        const float fg = sigmoid(p[nu + u]);
        const float gg = tanhf(p[2 * nu + u]);
        const float og = sigmoid(p[3 * nu + u]);
        const float cn = fg * c[0] + ig * gg;
        const float hn = og * tanhf(cn);
        c[0] = cn;
        hnext[(size_t)b * H + k] = hn;
        out[((size_t)b * T + t) * H * kRows + k] = from_f32<OutT>(hn);
        if constexpr (kCarry) {
          if (s == len - 1) {
            ct[(size_t)b * H + k] = hn;
            ct[((size_t)B + b) * H + k] = cn;
          }
        }
        if constexpr (kSave) {
          ResT* a = acts + ((size_t)t * B + b) * G;
          a[k] = from_f32<ResT>(ig);
          a[H + k] = from_f32<ResT>(fg);
          a[2 * H + k] = from_f32<ResT>(gg);
          a[3 * H + k] = from_f32<ResT>(og);
          ct[((size_t)t * B + b) * H + k] = from_f32<ResT>(cn);
        }
      } else if constexpr (kSave) {  // past the window, t = s: the held state
        ct[((size_t)s * B + b) * H + k] = from_f32<ResT>(reverse ? 0.f : c[0]);
        if (!reverse) hnext[(size_t)b * H + k] = s > 0 ? __ldcg(hcur + (size_t)b * H + k) : 0.f;
      }
    }
    __syncthreads();
    if (tr) tr[5 * s + 4] = clock64();
    if (s + 1 < steps) grid_wait(sync, (unsigned)(s + 1) * gridDim.x * gridDim.y);
  }
}

// The backward of one unit's cell at one step: the gate gradients (i, f,
// g, o) and the cell gradient carried to the step before, from dh and dc
// carried in, the upstream gy, the gate activations, tanh(c_t) and c_prev.
// Both backward kernels call it, so they compute every value alike.
struct CellGrad {
  float di, df, dg, d_o, dc;
};

__device__ __forceinline__ CellGrad cell_backward(float dh, float dc, float gyv, float ig,
                                                  float fg, float gg, float og, float tanh_c,
                                                  float c_prev) {
  const float dh_tot = dh + gyv;
  const float d_o = dh_tot * tanh_c;
  const float dc_tot = dc + dh_tot * og * (1.f - tanh_c * tanh_c);
  return {dc_tot * gg * ig * (1.f - ig), dc_tot * c_prev * fg * (1.f - fg),
          dc_tot * ig * (1.f - gg * gg), d_o * og * (1.f - og), dc_tot * fg};
}

// kDual (K11): direction blockIdx.y; gy (B, T, 2H), acts (2, T, B, 4H), ct
// (2, T, B, H), whh (2, H, 4H), dgates (2, B, T, 4H), hprev (2, B, T, H).
template <typename ResT, bool kDual = false>
__global__ void __launch_bounds__(1024) lstm_bwd_recurrence_kernel(
    const float* __restrict__ gy, const ResT* __restrict__ acts, const ResT* __restrict__ ct,
    const float* __restrict__ whh, const int* __restrict__ lengths,
    float* __restrict__ dgates, float* __restrict__ hprev, int T, int B, int H, int reverse) {
  extern __shared__ float smem[];
  float* dh = smem;           // (H) gradient carried into h_prev
  float* dc = smem + H;       // (H) gradient carried into c_prev
  float* dg = smem + 2 * H;   // (4H) this step's gate gradients
  const int b = blockIdx.x;
  const int G = 4 * H;
  const int len = max(0, min(lengths[b], T));
  if constexpr (kDual) {
    const int dir = blockIdx.y;
    reverse = dir;
    gy += (size_t)dir * H;
    acts += (size_t)dir * T * B * G;
    ct += (size_t)dir * T * B * H;
    whh += (size_t)dir * H * G;
    dgates += (size_t)dir * B * T * G;
    hprev += (size_t)dir * B * T * H;
  }
  constexpr int kRows = kDual ? 2 : 1;  // gy's row stride, in H
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32, nwarps = blockDim.x / 32;

  for (int k = threadIdx.x; k < H; k += blockDim.x) {
    dh[k] = 0.f;
    dc[k] = 0.f;
  }
  for (size_t i = (size_t)len * G + threadIdx.x; i < (size_t)T * G; i += blockDim.x)
    dgates[(size_t)b * T * G + i] = 0.f;
  for (size_t i = (size_t)len * H + threadIdx.x; i < (size_t)T * H; i += blockDim.x)
    hprev[(size_t)b * T * H + i] = 0.f;
  __syncthreads();

  for (int s = 0; s < len; ++s) {
    // Against the forward's processing order: reverse walked len-1 .. 0.
    const int t = reverse ? s : len - 1 - s;
    const int tp = reverse ? t + 1 : t - 1;  // the step processed just before t
    const bool has_prev = reverse ? tp < len : tp >= 0;
    const ResT* a = acts + ((size_t)t * B + b) * G;
    const ResT* ap = has_prev ? acts + ((size_t)tp * B + b) * G : a;
    for (int k = threadIdx.x; k < H; k += blockDim.x) {
      const float ig = to_f32(a[k]), fg = to_f32(a[H + k]);
      const float gg = to_f32(a[2 * H + k]), og = to_f32(a[3 * H + k]);
      const float tanh_c = tanhf(to_f32(ct[((size_t)t * B + b) * H + k]));
      const float c_prev = has_prev ? to_f32(ct[((size_t)tp * B + b) * H + k]) : 0.f;
      const float h_prev = has_prev ? to_f32(ap[3 * H + k]) * tanhf(c_prev) : 0.f;
      const CellGrad g = cell_backward(dh[k], dc[k], gy[((size_t)b * T + t) * H * kRows + k],
                                       ig, fg, gg, og, tanh_c, c_prev);
      dg[k] = g.di;
      dg[H + k] = g.df;
      dg[2 * H + k] = g.dg;
      dg[3 * H + k] = g.d_o;
      dc[k] = g.dc;
      hprev[((size_t)b * T + t) * H + k] = h_prev;
    }
    __syncthreads();
    float* dgb = dgates + ((size_t)b * T + t) * G;
    for (int col = threadIdx.x; col < G; col += blockDim.x) dgb[col] = dg[col];
    // dh = dgates @ whh^T: a warp per row of whh, lanes across its 4H columns.
    for (int r = warp; r < H; r += nwarps) {
      float acc = 0.f;
      for (int col = lane; col < G; col += 32) acc = fmaf(dg[col], whh[(size_t)r * G + col], acc);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
      if (lane == 0) dh[r] = acc;
    }
    __syncthreads();
  }
}

// Bytes of a backward CTA's shared memory: the rows of whh of its units
// (units x 4H), the staged dgates rows (rows x 4H), and for each (utterance,
// unit) dh, dc and the 7 inputs of its cell; then the lengths, B ints.
__host__ __device__ __forceinline__ size_t bwd_grid_smem_bytes(int H, int B, int units,
                                                               int rows) {
  const size_t G = 4 * (size_t)H;
  return sizeof(float) * (((size_t)units + rows) * G + 9 * (size_t)B * units) +
         sizeof(int) * (size_t)B;
}

// Units of one warp's dh chains.
constexpr int kChainU = 4;

// K3's backward recurrence on the co-resident grid: see the note at the top.
// CTA j owns units [k0, k0 + nu), k0 = j units; w_s holds their rows of whh.
// Utterances are staged `rows` at a time.  The cell inputs of a step (gate
// activations, tanh(c_t), c_prev and gy) are loaded while the staging is in
// flight.  dgates (B, T, 4H) is both this kernel's output and, one step
// later, its input (read through L2 after the barrier).  sync: the barrier's
// counter, 0 at launch; trace, if not null: (steps, 5) int64 as
// lstm_grid_kernel's: the global timer as a step starts, then its clock
// then, after the staging (and the cell inputs), after the dh chains and
// after the cells.
// kDual (K11): the grid is (ctas, 2) and blockIdx.y the direction, 0
// forward, 1 reverse; gy (B, T, 2H) (direction d reads columns [d H, (d +
// 1) H)), acts (2, T, B, 4H), ct (2, T, B, H), whh (2, H, 4H), dgates (2, B,
// T, 4H), hprev (2, B, T, H): the offsets of lstm_bwd_recurrence_kernel's
// dual form.  Both halves step in lockstep, one barrier a step for all
// their CTAs; each half zero-fills its own direction's windows; the trace is
// CTA (0, 0)'s.
template <typename ResT, bool kDual = false>
__global__ void __launch_bounds__(1024) lstm_bwd_grid_kernel(
    const float* __restrict__ gy, const ResT* __restrict__ acts, const ResT* __restrict__ ct,
    const float* __restrict__ whh, const int* __restrict__ lengths, float* dgates,
    float* __restrict__ hprev, unsigned* sync, long long* trace, int T, int B, int H, int units,
    int rows, int reverse) {
  extern __shared__ __align__(16) float smem[];
  const int G = 4 * H, S = B * units;
  if constexpr (kDual) {
    const int dir = blockIdx.y;
    reverse = dir;
    gy += (size_t)dir * H;
    acts += (size_t)dir * T * B * G;
    ct += (size_t)dir * T * B * H;
    whh += (size_t)dir * H * G;
    dgates += (size_t)dir * B * T * G;
    hprev += (size_t)dir * B * T * H;
  }
  constexpr int kRows = kDual ? 2 : 1;  // gy's row stride, in H
  const int k0 = blockIdx.x * units, nu = min(units, H - k0);
  float* w_s = smem;              // (units, G): whh[k0 + u, :]
  float* dg_s = w_s + units * G;  // (rows, G): the staged dgates rows
  float* dh_s = dg_s + rows * G;  // (B, units): dh of this step
  float* dc_s = dh_s + S;         // (B, units): the cell gradient carried
  float* in_s = dc_s + S;         // (7, B, units): ig, fg, gg, og, tanh c, c_prev, gy
  int* len_s = reinterpret_cast<int*>(in_s + 7 * S);
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32, nwarps = blockDim.x / 32;

  for (int e = threadIdx.x; e < nu * G; e += blockDim.x) w_s[e] = whh[(size_t)k0 * G + e];
  // Zeros outside the windows, spread over the whole grid.
  const size_t gtid = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  const size_t gstride = (size_t)gridDim.x * blockDim.x;
  int steps = 0;
  for (int b = 0; b < B; ++b) {
    const int len = max(0, min(lengths[b], T));
    steps = max(steps, len);
    if (threadIdx.x == 0) len_s[b] = len;
    for (size_t i = gtid; i < (size_t)(T - len) * G; i += gstride)
      dgates[((size_t)b * T + len) * G + i] = 0.f;
    for (size_t i = gtid; i < (size_t)(T - len) * H; i += gstride)
      hprev[((size_t)b * T + len) * H + i] = 0.f;
  }
  for (int e = threadIdx.x; e < S; e += blockDim.x) dc_s[e] = 0.f;
  __syncthreads();

  long long* tr = blockIdx.x == 0 && blockIdx.y == 0 && threadIdx.x == 0 ? trace : nullptr;
  for (int s = 0; s < steps; ++s) {
    if (tr) {
      tr[5 * s] = (long long)global_ns();
      tr[5 * s + 1] = clock64();
    }
    for (int b0 = 0; b0 < B; b0 += rows) {
      const int nb = min(rows, B - b0);
      if (b0 > 0) __syncthreads();  // the last group's chains have read dg_s
      // dg_s row bl = dgates of utterance b0 + bl at the step before, for
      // the utterances still in their window: 16 bytes a cp.async.cg.
      if (s > 0) {
        const int q = G / 4;
        for (int e = threadIdx.x; e < nb * q; e += blockDim.x) {
          const int bl = e / q, len = len_s[b0 + bl];
          if (s >= len) continue;
          const int tp = reverse ? s - 1 : len - s;
          asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(
                           smem_addr(dg_s + bl * G + 4 * (e % q))),
                       "l"(dgates + ((size_t)(b0 + bl) * T + tp) * G + 4 * (e % q))
                       : "memory");
        }
        cp_async_commit();
      }
      if (b0 == 0) {
        // This step's cell inputs, from device memory, while the copies fly.
        for (int i = threadIdx.x; i < B * nu; i += blockDim.x) {
          const int b = i / nu, u = i % nu, k = k0 + u, len = len_s[b];
          if (s >= len) continue;
          const int t = reverse ? s : len - 1 - s;
          const int tp = reverse ? t + 1 : t - 1;  // the step processed just before t
          const bool has_prev = reverse ? tp < len : tp >= 0;
          const ResT* a = acts + ((size_t)t * B + b) * G;
          const float c_prev = has_prev ? to_f32(ct[((size_t)tp * B + b) * H + k]) : 0.f;
          const float h_prev =
              has_prev ? to_f32(acts[((size_t)tp * B + b) * G + 3 * H + k]) * tanhf(c_prev) : 0.f;
          hprev[((size_t)b * T + t) * H + k] = h_prev;
          float* in = in_s + b * units + u;
          in[0] = to_f32(a[k]);
          in[S] = to_f32(a[H + k]);
          in[2 * S] = to_f32(a[2 * H + k]);
          in[3 * S] = to_f32(a[3 * H + k]);
          in[4 * S] = tanhf(to_f32(ct[((size_t)t * B + b) * H + k]));
          in[5 * S] = c_prev;
          in[6 * S] = gy[((size_t)b * T + t) * H * kRows + k];
        }
      }
      if (s == 0) break;  // dh enters the first step as 0: nothing to stage
      cp_async_wait<0>();
      __syncthreads();
      if (tr && b0 == 0) tr[5 * s + 2] = clock64();
      // dh[b, k] = sum over columns of dgates[b, col] whh[k, col]: lane l
      // sums columns l, l + 32, ... with fmaf from 0, then the butterfly.
      // A warp takes one utterance and up to kChainU units, so a column's
      // dgates entry is loaded once for them all.
      const int nuc = (nu + kChainU - 1) / kChainU;
      for (int task = warp; task < nb * nuc; task += nwarps) {
        const int bl = task % nb, u0 = kChainU * (task / nb);
        if (s >= len_s[b0 + bl]) continue;
        float acc[kChainU] = {};
        for (int col = lane; col < G; col += 32) {
          const float d = dg_s[bl * G + col];
#pragma unroll
          for (int j = 0; j < kChainU; ++j)
            if (u0 + j < nu) acc[j] = fmaf(d, w_s[(u0 + j) * G + col], acc[j]);
        }
#pragma unroll
        for (int j = 0; j < kChainU; ++j) {
#pragma unroll
          for (int off = 16; off > 0; off >>= 1)
            acc[j] += __shfl_xor_sync(0xffffffffu, acc[j], off);
          if (lane == 0 && u0 + j < nu) dh_s[(b0 + bl) * units + u0 + j] = acc[j];
        }
      }
    }
    __syncthreads();
    if (tr) {
      if (s == 0) tr[2] = clock64();
      tr[5 * s + 3] = clock64();
    }
    for (int i = threadIdx.x; i < B * nu; i += blockDim.x) {
      const int b = i / nu, u = i % nu, k = k0 + u, len = len_s[b];
      if (s >= len) continue;
      const int t = reverse ? s : len - 1 - s;
      const int p = b * units + u;
      const float* in = in_s + p;
      const CellGrad g = cell_backward(s > 0 ? dh_s[p] : 0.f, dc_s[p], in[6 * S], in[0], in[S],
                                       in[2 * S], in[3 * S], in[4 * S], in[5 * S]);
      dc_s[p] = g.dc;
      float* dgb = dgates + ((size_t)b * T + t) * G;
      dgb[k] = g.di;
      dgb[H + k] = g.df;
      dgb[2 * H + k] = g.dg;
      dgb[3 * H + k] = g.d_o;
    }
    __syncthreads();
    if (tr) tr[5 * s + 4] = clock64();
    if (s + 1 < steps) grid_wait(sync, (unsigned)(s + 1) * gridDim.x * gridDim.y);
  }
}

// out[n] = sum_m a[m, n], rows in order: one thread a column.
__global__ void column_sum_kernel(const float* __restrict__ a, float* __restrict__ out, int M,
                                  int N) {
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= N) return;
  float acc = 0.f;
  for (int m = 0; m < M; ++m) acc += a[(size_t)m * N + n];
  out[n] = acc;
}

template <typename AT, typename BT, typename OutT>
cudaError_t gemm(const void* A, long sam, long sak, const void* Bm, long sbk, long sbn,
                 const float* bias, void* C, int M, int N, int K, cudaStream_t st) {
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  gemm_kernel<AT, BT, OutT><<<grid, GEMM_THREADS, 0, st>>>(
      static_cast<const AT*>(A), sam, sak, static_cast<const BT*>(Bm), sbk, sbn, bias,
      static_cast<OutT*>(C), M, N, K);
  return cudaGetLastError();
}

// xproj (B*T, 4H) fp32 = x (B*T, D) @ wih (D, 4H) + bias.
cudaError_t projection(const void* x, const void* wih, const float* bias, float* xproj, int M,
                       int D, int G, int in_bf16, cudaStream_t st) {
  return in_bf16 ? gemm<bf16, bf16, float>(x, D, 1, wih, G, 1, bias, xproj, M, G, D, st)
                 : gemm<float, float, float>(x, D, 1, wih, G, 1, bias, xproj, M, G, D, st);
}

// The per-utterance kernel, a block an utterance (and direction, under
// kDual): the wide route of K2, K3's forward and K11 where the co-resident
// grid cannot hold whh (ops/lstm_cuda.py::forward_route), and, both
// directions, the bit-equality oracle of the grid kernel
// (bilstm_seq_per_utterance).  6 H floats of shared memory a block.
template <typename OutT, typename ResT, bool kSave, bool kDual, bool kCarry = false>
cudaError_t utterance_recurrence(const float* xproj, const float* whh, const int* lengths,
                                 void* out, void* acts, void* ct, int B, int T, int H,
                                 int reverse, cudaStream_t st) {
  const size_t smem = (size_t)6 * H * sizeof(float);
  auto kernel = lstm_recurrence_kernel<OutT, ResT, kSave, kDual, kCarry>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int threads = 2 * H >= 1024 ? 1024 : (2 * H + 31) / 32 * 32;
  kernel<<<dim3(B, kDual ? 2 : 1), threads, smem, st>>>(
      xproj, whh, lengths, static_cast<OutT*>(out), static_cast<ResT*>(acts),
      static_cast<ResT*>(ct), T, B, H, reverse);
  return cudaGetLastError();
}

// The per-utterance recurrence in any of its forms: save selects the
// training form, its residuals in bf16 when res_bf16.
template <bool kDual>
cudaError_t utterance_forward(const float* xproj, const float* whh, const int* lengths,
                              void* out, void* acts, void* ct, int B, int T, int H, int reverse,
                              int out_bf16, int save, int res_bf16, cudaStream_t st) {
  if (save) {
    if (res_bf16)
      return out_bf16 ? utterance_recurrence<bf16, bf16, true, kDual>(
                            xproj, whh, lengths, out, acts, ct, B, T, H, reverse, st)
                      : utterance_recurrence<float, bf16, true, kDual>(
                            xproj, whh, lengths, out, acts, ct, B, T, H, reverse, st);
    return out_bf16 ? utterance_recurrence<bf16, float, true, kDual>(
                          xproj, whh, lengths, out, acts, ct, B, T, H, reverse, st)
                    : utterance_recurrence<float, float, true, kDual>(
                          xproj, whh, lengths, out, acts, ct, B, T, H, reverse, st);
  }
  return out_bf16 ? utterance_recurrence<bf16, float, false, kDual>(
                        xproj, whh, lengths, out, nullptr, nullptr, B, T, H, reverse, st)
                  : utterance_recurrence<float, float, false, kDual>(
                        xproj, whh, lengths, out, nullptr, nullptr, B, T, H, reverse, st);
}

// K2's and K3's forward recurrence on the co-resident grid: ctas CTAs of
// `units` hidden units each, `rows` utterances staged at once, smem bytes of
// shared memory each (ops/lstm_cuda.py::recurrence_grid); under kDual (K11)
// ctas a direction, the grid (ctas, 2).  Returns the cooperative launch's
// error where the grid cannot be resident at once.
template <typename OutT, typename ResT, bool kSave, bool kDual = false, bool kCarry = false>
cudaError_t grid_recurrence(const float* xproj, const float* whh, const int* lengths, void* out,
                            void* acts, void* ct, float* hbuf, unsigned* sync, long long* trace,
                            int B, int T, int H, int reverse, int ctas, int units, int rows,
                            int smem, cudaStream_t st) {
  if (units < 1 || rows < 1 || rows > B || (long)ctas * units < H ||
      (long)(ctas - 1) * units >= H || (size_t)smem < grid_smem_bytes(H, B, units, rows))
    return cudaErrorInvalidValue;
  auto kernel = lstm_grid_kernel<OutT, ResT, kSave, kDual, kCarry>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  // A thread a chain of a staged group (its utterances rounded up to 8), and
  // at least 256 for the staging.
  int threads = (rows + 7) / 8 * 8 * 4 * units;
  threads = threads < 256 ? 256 : threads > 1024 ? 1024 : (threads + 31) / 32 * 32;
  OutT* o = static_cast<OutT*>(out);
  ResT* a = static_cast<ResT*>(acts);
  ResT* c = static_cast<ResT*>(ct);
  void* args[] = {&xproj, &whh, &lengths, &o, &a, &c, &hbuf, &sync, &trace,
                  &T, &B, &H, &units, &rows, &reverse};
  return launch_cooperative(reinterpret_cast<const void*>(kernel), dim3(ctas, kDual ? 2 : 1),
                            dim3(threads), args, (size_t)smem, st);
}

template <typename OutT, bool kDual = false>
cudaError_t train_grid_recurrence(const float* xproj, const float* whh, const int* lengths,
                                  void* out, void* acts, void* ct, float* hbuf, unsigned* sync,
                                  long long* trace, int B, int T, int H, int reverse,
                                  int res_bf16, int ctas, int units, int rows, int smem,
                                  cudaStream_t st) {
  return res_bf16 ? grid_recurrence<OutT, bf16, true, kDual>(xproj, whh, lengths, out, acts, ct,
                                                             hbuf, sync, trace, B, T, H, reverse,
                                                             ctas, units, rows, smem, st)
                  : grid_recurrence<OutT, float, true, kDual>(xproj, whh, lengths, out, acts, ct,
                                                              hbuf, sync, trace, B, T, H, reverse,
                                                              ctas, units, rows, smem, st);
}

template <typename ResT, bool kDual = false>
cudaError_t bwd_recurrence(const float* gy, const void* acts, const void* ct,
                           const float* whh, const int* lengths, float* dgates, float* hprev,
                           int B, int T, int H, int reverse, cudaStream_t st) {
  const size_t smem = (size_t)6 * H * sizeof(float);
  auto kernel = lstm_bwd_recurrence_kernel<ResT, kDual>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  int threads = (4 * H + 31) / 32 * 32;
  threads = threads > 1024 ? 1024 : threads;
  kernel<<<dim3(B, kDual ? 2 : 1), threads, smem, st>>>(
      gy, static_cast<const ResT*>(acts), static_cast<const ResT*>(ct), whh, lengths, dgates,
      hprev, T, B, H, reverse);
  return cudaGetLastError();
}

// K3's backward recurrence on the co-resident grid: ctas CTAs of `units`
// hidden units each, `rows` utterances staged at once, smem bytes of shared
// memory each (ops/lstm_cuda.py::backward_grid); under kDual (K11) ctas a
// direction, the grid (ctas, 2).  Returns the cooperative launch's error
// where the grid cannot be resident at once.
template <typename ResT, bool kDual = false>
cudaError_t bwd_grid_recurrence(const float* gy, const void* acts, const void* ct,
                                const float* whh, const int* lengths, float* dgates,
                                float* hprev, unsigned* sync, long long* trace, int B, int T,
                                int H, int reverse, int ctas, int units, int rows, int smem,
                                cudaStream_t st) {
  if (units < 1 || rows < 1 || rows > B || (long)ctas * units < H ||
      (long)(ctas - 1) * units >= H || (size_t)smem < bwd_grid_smem_bytes(H, B, units, rows))
    return cudaErrorInvalidValue;
  auto kernel = lstm_bwd_grid_kernel<ResT, kDual>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  // A thread a cell where they fit, a warp a group of chains, and at least
  // 512 for the staging.
  const int tasks = rows * ((units + kChainU - 1) / kChainU);
  int threads = B * units > 32 * tasks ? B * units : 32 * tasks;
  threads = threads < 512 ? 512 : threads > 1024 ? 1024 : (threads + 31) / 32 * 32;
  const ResT* a = static_cast<const ResT*>(acts);
  const ResT* c = static_cast<const ResT*>(ct);
  void* args[] = {&gy, &a, &c, &whh, &lengths, &dgates, &hprev, &sync, &trace,
                  &T, &B, &H, &units, &rows, &reverse};
  return launch_cooperative(reinterpret_cast<const void*>(kernel), dim3(ctas, kDual ? 2 : 1),
                            dim3(threads), args, (size_t)smem, st);
}

template <typename InT>
cudaError_t bwd_products(const float* dgates, const float* hprev, const void* x,
                         const void* wih, void* dx, void* dwih, float* dwhh, float* db, int M,
                         int D, int H, cudaStream_t st) {
  const int G = 4 * H;
  // dx (M, D) = dgates (M, G) @ wih^T: B(k=g, n=d) = wih[d*G + g].
  cudaError_t err = gemm<float, InT, InT>(dgates, G, 1, wih, 1, G, nullptr, dx, M, D, G, st);
  if (err != cudaSuccess) return err;
  // dwih (D, G) = x^T @ dgates: A(m=d, k=row) = x[row*D + d].
  err = gemm<InT, float, InT>(x, 1, D, dgates, G, 1, nullptr, dwih, D, G, M, st);
  if (err != cudaSuccess) return err;
  // dwhh (H, G) = h_prev^T @ dgates.
  err = gemm<float, float, float>(hprev, 1, H, dgates, G, 1, nullptr, dwhh, H, G, M, st);
  if (err != cudaSuccess) return err;
  column_sum_kernel<<<(G + 255) / 256, 256, 0, st>>>(dgates, db, M, G);
  return cudaGetLastError();
}

// K11: out[i] = half[i] + half[n + i], in the type of x (dx = dx_f + dx_b).
template <typename T>
__global__ void add_halves_kernel(const T* __restrict__ halves, T* __restrict__ out, size_t n) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) out[i] = from_f32<T>(to_f32(halves[i]) + to_f32(halves[n + i]));
}

// K11's input projections: K2's GEMM once a direction, into xproj (2, B*T, 4H).
cudaError_t dual_projection(const void* x, const void* wih, const float* bias, float* xproj,
                            int M, int D, int G, int in_bf16, cudaStream_t st) {
  const size_t w_bytes = (size_t)D * G * (in_bf16 ? sizeof(bf16) : sizeof(float));
  for (int d = 0; d < 2; ++d) {
    const cudaError_t err =
        projection(x, static_cast<const char*>(wih) + d * w_bytes, bias + (size_t)d * G,
                   xproj + (size_t)d * M * G, M, D, G, in_bf16, st);
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

// K11's products: K3's for each direction, dx of each into its half of
// dx2 (2, M, D), then dx = dx2[0] + dx2[1].
template <typename InT>
cudaError_t dual_bwd_products(const float* dgates, const float* hprev, const void* x,
                              const void* wih, void* dx2, void* dx, void* dwih, float* dwhh,
                              float* db, int M, int D, int H, cudaStream_t st) {
  const int G = 4 * H;
  for (int d = 0; d < 2; ++d) {
    const cudaError_t err = bwd_products<InT>(
        dgates + (size_t)d * M * G, hprev + (size_t)d * M * H, x,
        static_cast<const InT*>(wih) + (size_t)d * D * G,
        static_cast<InT*>(dx2) + (size_t)d * M * D,
        static_cast<InT*>(dwih) + (size_t)d * D * G, dwhh + (size_t)d * H * G,
        db + (size_t)d * G, M, D, H, st);
    if (err != cudaSuccess) return err;
  }
  const size_t n = (size_t)M * D;
  add_halves_kernel<InT><<<(unsigned)((n + 255) / 256), 256, 0, st>>>(
      static_cast<const InT*>(dx2), static_cast<InT*>(dx), n);
  return cudaGetLastError();
}

}  // namespace

// Inference forward.  xproj: (B, T, 4H) fp32 scratch; hbuf (2, B, H) fp32
// scratch, sync (one unsigned, 0) and trace (null, or (max len, 5) int64:
// see lstm_grid_kernel) for the grid; in_bf16 / out_bf16 pick the types of x
// and wih / of out (else fp32); ctas, units, rows, smem: the grid
// (ops/lstm_cuda.py::recurrence_grid).  Returns the first failing launch's
// cudaError_t, or 0.
extern "C" int lstm_seq_fwd(const void* x, const void* wih, const float* whh,
                            const float* bias, const int* lengths, float* xproj, float* hbuf,
                            unsigned* sync, long long* trace, void* out, int B, int T, int D,
                            int H, int reverse, int in_bf16, int out_bf16, int ctas, int units,
                            int rows, int smem, void* stream) {
  if (B == 0 || T == 0) return 0;
  const cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err = projection(x, wih, bias, xproj, B * T, D, 4 * H, in_bf16, st);
  if (err != cudaSuccess) return err;
  return out_bf16 ? grid_recurrence<bf16, float, false>(xproj, whh, lengths, out, nullptr,
                                                        nullptr, hbuf, sync, trace, B, T, H,
                                                        reverse, ctas, units, rows, smem, st)
                  : grid_recurrence<float, float, false>(xproj, whh, lengths, out, nullptr,
                                                         nullptr, hbuf, sync, trace, B, T, H,
                                                         reverse, ctas, units, rows, smem, st);
}

// K2 from a carried state, the streaming recognizer's chunk: forward only,
// no trace.  state_in (2, B, H) fp32 holds h0 then c0; state_out (2, B, H)
// fp32 receives h then c after each row's last valid step (h0 and c0 for a
// row of no steps).  ctas > 0: the co-resident grid (ctas, units, rows, smem
// as lstm_seq_fwd's); ctas 0: the per-utterance kernel, the wide route.
// Other arguments as lstm_seq_fwd's.  A chunk's values are those of the
// same steps in one launch over the whole sequence: the projection sums
// each element in k order whatever the rows, and the steps are K2's.
extern "C" int lstm_seq_stream(const void* x, const void* wih, const float* whh,
                               const float* bias, const int* lengths, float* xproj, float* hbuf,
                               unsigned* sync, const float* state_in, float* state_out, void* out,
                               int B, int T, int D, int H, int in_bf16, int out_bf16, int ctas,
                               int units, int rows, int smem, void* stream) {
  if (B == 0 || T == 0) return 0;
  const cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err = projection(x, wih, bias, xproj, B * T, D, 4 * H, in_bf16, st);
  if (err != cudaSuccess) return err;
  float* in = const_cast<float*>(state_in);
  if (ctas == 0)
    return out_bf16 ? utterance_recurrence<bf16, float, false, false, true>(
                          xproj, whh, lengths, out, in, state_out, B, T, H, 0, st)
                    : utterance_recurrence<float, float, false, false, true>(
                          xproj, whh, lengths, out, in, state_out, B, T, H, 0, st);
  return out_bf16 ? grid_recurrence<bf16, float, false, false, true>(
                        xproj, whh, lengths, out, in, state_out, hbuf, sync, nullptr, B, T, H, 0,
                        ctas, units, rows, smem, st)
                  : grid_recurrence<float, float, false, false, true>(
                        xproj, whh, lengths, out, in, state_out, hbuf, sync, nullptr, B, T, H, 0,
                        ctas, units, rows, smem, st);
}

// Training forward: as lstm_seq_fwd (trace (T, 5)), plus the residuals acts
// (T, B, 4H) and ct (T, B, H) in bf16 when res_bf16, else fp32.
extern "C" int lstm_seq_train_fwd(const void* x, const void* wih, const float* whh,
                                  const float* bias, const int* lengths, float* xproj,
                                  float* hbuf, unsigned* sync, long long* trace, void* out,
                                  void* acts, void* ct, int B, int T, int D, int H, int reverse,
                                  int in_bf16, int out_bf16, int res_bf16, int ctas, int units,
                                  int rows, int smem, void* stream) {
  if (B == 0 || T == 0) return 0;
  const cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err = projection(x, wih, bias, xproj, B * T, D, 4 * H, in_bf16, st);
  if (err != cudaSuccess) return err;
  return out_bf16 ? train_grid_recurrence<bf16>(xproj, whh, lengths, out, acts, ct, hbuf, sync,
                                                trace, B, T, H, reverse, res_bf16, ctas, units,
                                                rows, smem, st)
                  : train_grid_recurrence<float>(xproj, whh, lengths, out, acts, ct, hbuf, sync,
                                                 trace, B, T, H, reverse, res_bf16, ctas, units,
                                                 rows, smem, st);
}

// Backward on the co-resident grid.  gy: (B, T, H) fp32; dgates (B, T, 4H)
// and hprev (B, T, H): fp32 scratch; dx (B, T, D) in x's type, dwih (D, 4H)
// in wih's (= x's) type, dwhh (H, 4H) and db (4H) fp32; sync (one unsigned,
// 0) and trace (null, or (max len, 5) int64: see lstm_bwd_grid_kernel);
// ctas, units, rows, smem: the grid (ops/lstm_cuda.py::backward_grid).
extern "C" int lstm_seq_bwd(const float* gy, const void* x, const void* wih, const float* whh,
                            const int* lengths, const void* acts, const void* ct,
                            float* dgates, float* hprev, void* dx, void* dwih, float* dwhh,
                            float* db, unsigned* sync, long long* trace, int B, int T, int D,
                            int H, int reverse, int in_bf16, int res_bf16, int ctas, int units,
                            int rows, int smem, void* stream) {
  if (B == 0 || T == 0) return 0;
  const cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err =
      res_bf16 ? bwd_grid_recurrence<bf16>(gy, acts, ct, whh, lengths, dgates, hprev, sync, trace,
                                           B, T, H, reverse, ctas, units, rows, smem, st)
               : bwd_grid_recurrence<float>(gy, acts, ct, whh, lengths, dgates, hprev, sync,
                                            trace, B, T, H, reverse, ctas, units, rows, smem, st);
  if (err != cudaSuccess) return err;
  return in_bf16 ? bwd_products<bf16>(dgates, hprev, x, wih, dx, dwih, dwhh, db, B * T, D, H, st)
                 : bwd_products<float>(dgates, hprev, x, wih, dx, dwih, dwhh, db, B * T, D, H,
                                       st);
}

// Backward on the per-utterance kernel, a block an utterance: the wide
// route, where the grid cannot hold whh's rows.  Arguments as lstm_seq_bwd's
// without the grid's.
extern "C" int lstm_seq_bwd_per_utterance(const float* gy, const void* x, const void* wih,
                                          const float* whh, const int* lengths, const void* acts,
                                          const void* ct, float* dgates, float* hprev, void* dx,
                                          void* dwih, float* dwhh, float* db, int B, int T, int D,
                                          int H, int reverse, int in_bf16, int res_bf16,
                                          void* stream) {
  if (B == 0 || T == 0) return 0;
  const cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err = res_bf16
      ? bwd_recurrence<bf16>(gy, acts, ct, whh, lengths, dgates, hprev, B, T, H, reverse, st)
      : bwd_recurrence<float>(gy, acts, ct, whh, lengths, dgates, hprev, B, T, H, reverse, st);
  if (err != cudaSuccess) return err;
  return in_bf16 ? bwd_products<bf16>(dgates, hprev, x, wih, dx, dwih, dwhh, db, B * T, D, H, st)
                 : bwd_products<float>(dgates, hprev, x, wih, dx, dwih, dwhh, db, B * T, D, H,
                                       st);
}

// K11, inference forward: both directions of a BiLSTM layer on the dual
// grid.  wih (2, D, 4H) in x's type, whh (2, H, 4H) and bias (2, 4H) fp32
// ([forward, reverse]); xproj (2, B, T, 4H) and hbuf (2, 2, B, H) fp32
// scratch, sync and trace as lstm_seq_fwd's (the trace CTA (0, 0)'s, the
// forward direction's); out (B, T, 2H) = [forward | reverse]; ctas, units,
// rows, smem: a direction's grid (ops/lstm_cuda.py::recurrence_grid with
// directions 2).
extern "C" int bilstm_seq_fwd(const void* x, const void* wih, const float* whh,
                              const float* bias, const int* lengths, float* xproj, float* hbuf,
                              unsigned* sync, long long* trace, void* out, int B, int T, int D,
                              int H, int in_bf16, int out_bf16, int ctas, int units, int rows,
                              int smem, void* stream) {
  if (B == 0 || T == 0) return 0;
  const cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err = dual_projection(x, wih, bias, xproj, B * T, D, 4 * H, in_bf16, st);
  if (err != cudaSuccess) return err;
  return out_bf16 ? grid_recurrence<bf16, float, false, true>(
                        xproj, whh, lengths, out, nullptr, nullptr, hbuf, sync, trace, B, T, H, 0,
                        ctas, units, rows, smem, st)
                  : grid_recurrence<float, float, false, true>(
                        xproj, whh, lengths, out, nullptr, nullptr, hbuf, sync, trace, B, T, H, 0,
                        ctas, units, rows, smem, st);
}

// K11, training forward: as bilstm_seq_fwd (trace (T, 5)), plus each
// direction's residuals, acts (2, T, B, 4H) and ct (2, T, B, H), in bf16
// when res_bf16, else fp32.
extern "C" int bilstm_seq_train_fwd(const void* x, const void* wih, const float* whh,
                                    const float* bias, const int* lengths, float* xproj,
                                    float* hbuf, unsigned* sync, long long* trace, void* out,
                                    void* acts, void* ct, int B, int T, int D, int H, int in_bf16,
                                    int out_bf16, int res_bf16, int ctas, int units, int rows,
                                    int smem, void* stream) {
  if (B == 0 || T == 0) return 0;
  const cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err = dual_projection(x, wih, bias, xproj, B * T, D, 4 * H, in_bf16, st);
  if (err != cudaSuccess) return err;
  return out_bf16 ? train_grid_recurrence<bf16, true>(xproj, whh, lengths, out, acts, ct, hbuf,
                                                      sync, trace, B, T, H, 0, res_bf16, ctas,
                                                      units, rows, smem, st)
                  : train_grid_recurrence<float, true>(xproj, whh, lengths, out, acts, ct, hbuf,
                                                       sync, trace, B, T, H, 0, res_bf16, ctas,
                                                       units, rows, smem, st);
}

// K2 (save 0) or K3's training forward (save 1, residuals in bf16 when
// res_bf16) on the per-utterance kernel, a block an utterance: the wide
// route, where the co-resident grid cannot hold whh.  Arguments as
// lstm_seq_train_fwd's without the grid's; acts and ct are ignored when
// save is 0.
extern "C" int lstm_seq_per_utterance(const void* x, const void* wih, const float* whh,
                                      const float* bias, const int* lengths, float* xproj,
                                      void* out, void* acts, void* ct, int B, int T, int D, int H,
                                      int reverse, int in_bf16, int out_bf16, int save,
                                      int res_bf16, void* stream) {
  if (B == 0 || T == 0) return 0;
  const cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err = projection(x, wih, bias, xproj, B * T, D, 4 * H, in_bf16, st);
  if (err != cudaSuccess) return err;
  return utterance_forward<false>(xproj, whh, lengths, out, acts, ct, B, T, H, reverse, out_bf16,
                                  save, res_bf16, st);
}

// K11's forward (save 0) or training forward (save 1) on the per-utterance
// kernel, a block an utterance and direction: K11's wide route, and the
// oracle of the dual grid.  Arguments as bilstm_seq_train_fwd's without the
// grid's; acts and ct are ignored when save is 0.
extern "C" int bilstm_seq_per_utterance(const void* x, const void* wih, const float* whh,
                                        const float* bias, const int* lengths, float* xproj,
                                        void* out, void* acts, void* ct, int B, int T, int D,
                                        int H, int in_bf16, int out_bf16, int save, int res_bf16,
                                        void* stream) {
  if (B == 0 || T == 0) return 0;
  const cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err = dual_projection(x, wih, bias, xproj, B * T, D, 4 * H, in_bf16, st);
  if (err != cudaSuccess) return err;
  return utterance_forward<true>(xproj, whh, lengths, out, acts, ct, B, T, H, 0, out_bf16, save,
                                 res_bf16, st);
}

// K11, backward, its dh recurrence on the dual grid.  gy (B, T, 2H) fp32;
// dgates (2, B, T, 4H), hprev (2, B, T, H) fp32 and dx2 (2, B, T, D) in x's
// type: scratch; dx (B, T, D) in x's type, dwih (2, D, 4H) in wih's type,
// dwhh (2, H, 4H) and db (2, 4H) fp32; sync (one unsigned, 0) and trace
// (null, or (max len, 5) int64, CTA (0, 0)'s: see lstm_bwd_grid_kernel);
// ctas, units, rows, smem: a direction's grid (ops/lstm_cuda.py::
// backward_grid with directions 2).
extern "C" int bilstm_seq_bwd(const float* gy, const void* x, const void* wih,
                              const float* whh, const int* lengths, const void* acts,
                              const void* ct, float* dgates, float* hprev, void* dx2, void* dx,
                              void* dwih, float* dwhh, float* db, unsigned* sync,
                              long long* trace, int B, int T, int D, int H, int in_bf16,
                              int res_bf16, int ctas, int units, int rows, int smem,
                              void* stream) {
  if (B == 0 || T == 0) return 0;
  const cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err =
      res_bf16 ? bwd_grid_recurrence<bf16, true>(gy, acts, ct, whh, lengths, dgates, hprev, sync,
                                                 trace, B, T, H, 0, ctas, units, rows, smem, st)
               : bwd_grid_recurrence<float, true>(gy, acts, ct, whh, lengths, dgates, hprev,
                                                  sync, trace, B, T, H, 0, ctas, units, rows,
                                                  smem, st);
  if (err != cudaSuccess) return err;
  return in_bf16 ? dual_bwd_products<bf16>(dgates, hprev, x, wih, dx2, dx, dwih, dwhh, db,
                                           B * T, D, H, st)
                 : dual_bwd_products<float>(dgates, hprev, x, wih, dx2, dx, dwih, dwhh, db,
                                            B * T, D, H, st);
}

// K11's backward on the per-utterance kernel, a block an utterance and
// direction: its wide route, where the dual grid cannot hold whh's rows,
// and the grid's bit-equality oracle.  Arguments as bilstm_seq_bwd's
// without the grid's.
extern "C" int bilstm_seq_bwd_per_utterance(const float* gy, const void* x, const void* wih,
                                            const float* whh, const int* lengths,
                                            const void* acts, const void* ct, float* dgates,
                                            float* hprev, void* dx2, void* dx, void* dwih,
                                            float* dwhh, float* db, int B, int T, int D, int H,
                                            int in_bf16, int res_bf16, void* stream) {
  if (B == 0 || T == 0) return 0;
  const cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err =
      res_bf16 ? bwd_recurrence<bf16, true>(gy, acts, ct, whh, lengths, dgates, hprev, B, T, H,
                                            0, st)
               : bwd_recurrence<float, true>(gy, acts, ct, whh, lengths, dgates, hprev, B, T, H,
                                             0, st);
  if (err != cudaSuccess) return err;
  return in_bf16 ? dual_bwd_products<bf16>(dgates, hprev, x, wih, dx2, dx, dwih, dwhh, db,
                                           B * T, D, H, st)
                 : dual_bwd_products<float>(dgates, hprev, x, wih, dx2, dx, dwih, dwhh, db,
                                            B * T, D, H, st);
}

// The fused TCN residual block of config 3 for Hopper (sm_90a), CUDA C++:
// the inference block (K5) and the training forward and backward (K6).
//
// Replaces: pytorch_asr_tpu/ops/dilated_conv_pallas.py.
//   tcn_block_fwd(residual=1)  K5, tcn_block_pallas (_tcn_block_kernel :41);
//   tcn_block_fwd(residual=0)  K6 forward, _train_fwd_impl (_tcn_fwd_train_kernel
//                              :149): the block body y and the normalized xn;
//   tcn_block_bwd              K6 backward, _train_vjp_bwd (_tcn_bwd_kernel :187).
// Python side: ops/tcn_cuda.py.
//
// Computes, for x (B, T, C) in fp32 or bf16, ln_scale, ln_bias (C), w_conv
// (K, C, 2Cm), b_conv (2Cm), w_point (Cm, C), b_point (C), all parameters fp32:
//   xn  = LayerNorm(x) * ln_scale + ln_bias              (eps 1e-6, two-pass)
//   acc = sum_k xn[t + (k - K/2) d] @ w_conv[k] + b_conv  (taps outside [0, T) read 0)
//   glu = acc[:, :Cm] * sigmoid(acc[:, Cm:])
//   y   = glu @ w_point + b_point
// The GLU half-width Cm is C in the block as the model holds it, and C / m
// on a model rank of a tensor-parallel block (models/encoder_tcn.py): the
// rank's Cm lin columns paired with their gate columns, and the matching Cm
// rows of w_point, as the JAX package's TCNBlock._tp_pallas slices them and
// its kernel reads the widths from the weights (_train_vjp_bwd :328-329).
// The inference block (K5) is square: Cm = C.
// K5 writes x + y in x's type, the sum taken in fp32; the K6 forward writes y
// and keeps xn, both fp32.  The JAX package holds its kernel to a
// Precision.HIGHEST reference at 2e-4, so no product here runs in plain TF32
// (about three decimal digits): every product is 3xTF32 on the tensor cores
// (below).  Rows past an utterance's length are not special: their xn is
// ln_bias, and the last valid frames' taps read it, as in both JAX paths.
//
// Why the TPU design does not carry over: the Pallas kernel keeps a halo'd
// (256 + 64, C) fp32 slab of x plus a (256, 2C) accumulator in VMEM, about
// 480 KB at C = 384, and walks time blocks on a sequential grid, carrying
// the weight-gradient sums across grid steps.  A Hopper block has 227 KB of
// shared memory and blocks run in no order.  So each wrapper call here is a
// few launches.
//
// Forward (K5, the K6 forward): three launches.
//   1. layer_norm_kernel: one warp a row writes xn (B*T, C) fp32 (9.8 MB at
//      B 16, T' 400, C 384: it stays in L2 for the next launch).
//   2. tc_gemm_kernel<GLU>: the dilated conv as an implicit GEMM, rows (b, t)
//      by 32 output-channel pairs a tile: lin columns together with their
//      gate columns Cm + p, so the GLU runs in the epilogue, which writes
//      glu (B*T, Cm) fp32 and nothing else; the reduction walks the K*C
//      (tap, channel) pairs, reading xn rows at t + (k - K/2) d.  The GLU is
//      not linear, so the reduction is never split.
//   3. tc_gemm_kernel<POINT>: glu @ w_point, one slice, with a + b_point
//      epilogue (K5: + x read in x's type, the sum in fp32, cast to x's type).
//
// Backward (K6): five implicit GEMMs on tc_gemm_kernel, then column sums.
//   1. <DGLU>  dglu = dy @ w_point^T.
//   2. <CONV>  the conv again from xn (as the TPU kernel recomputes it,
//      :214-226, instead of saving it), with an epilogue that writes glu and
//      dacc = [dglu sg, dglu lin sg (1 - sg)] directly: no pre-activations
//      go through device memory.
//   3. <DWP>   dw_point = glu^T dy.
//   4. <DWC>   dw_conv[k] = xs_k^T dacc, xs_k = xn shifted by the tap.
//   5. <DXN>   dxn[t] = sum_k dacc[t - (k - K/2) d] w_conv[k]^T, written as a
//      gather (the transposed conv; the TPU's per-block halo slabs and their
//      overlap-add were a workaround for its sequential grid).
//   db_conv, db_point are column sums.  The weight gradients reduce over all
//   B*T rows: inside one block an output tile, split over the reduction in a
//   number of slices fixed by the shapes alone where the tiles alone would
//   leave SMs idle, then summed slice by slice in a second pass.  No
//   atomics, so results are the same from run to run.
//
// Bound on this card: operations.  A block's forward is 2 B T C (K 2C + C)
// = 20.8 GFLOP at B 16, T' 400, C 384, K 5 against ~40 MB of inputs and
// outputs: 0.31 ms at 67 TFLOP/s fp32, and 0.126 ms as 3xTF32 work (three
// TF32 products for each, 62 GFLOP at 495 TFLOP/s).  The backward's
// products are ~60 GFLOP: 0.90 ms in fp32 on the CUDA cores, 0.37 ms as
// 3xTF32.  Both once ran as SIMT fp32 GEMMs (the forward at ~3.4x its fp32
// bound, the backward at 3.7x: 2.7 FMAs a shared-memory load), so
// tc_gemm_kernel runs every product on the tensor cores instead, with the
// 3xTF32 split that keeps fp32 accuracy:
// each fp32 operand a becomes big = tf32(a) and small = tf32(a - big), both
// rounded to nearest as cvt.rna.tf32.f32 rounds (done on the bits, two
// integer operations, where the conversion unit's cvt made the split the
// slowest part of the loop), and each product is small*big + big*small +
// big*big, accumulated in fp32 in that order (CUTLASS's 3xTF32), losing
// only small*small (~2^-22 relative).  mma.sync.m16n8k8 takes its
// fragments from shared memory in any layout, which the reductions over
// rows (DWP, DWC, whose A is not K-major) need; wgmma's TF32 form takes only
// K-major operands.  Tiles of 128 x 64 by 32, eight warps of 32 x 32, two
// blocks an SM; a three-stage cp.async pipeline loads A and B tiles while
// the tensor cores work on an earlier one.  The loaders keep the
// implicit-GEMM address logic: rows shifted by a tap, the gather of DXN,
// and a row outside [0, T) copied as zeros (cp.async with a source size of
// 0).  16-byte copies where C is a multiple of 4, else 4-byte ones.  Where
// a backward product's tiles leave the last wave of blocks mostly empty,
// its reduction is split into slices (split_k).  On the H100 the three
// large backward products run at about 155 TFLOP/s of TF32 work each, a
// third of the peak, and so bound the forward's conv too (its 600 tiles
// at config 3 fill 2.3 waves).  What holds them there is not measured (it
// needs a profiler of the SM's pipes).  In tuning, neither leaving the
// small part unrounded (half the split's integer operations) nor issuing
// each accumulator's three products apart paid much, and 64 x 32 warp
// tiles at one block an SM were slower; mma.sync's rate below wgmma's and
// ~0.9 GB of L2 reads a product remain (PERF.md).  wgmma with TMA is later
// work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <algorithm>

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

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// xn (M, C) fp32 = (x - mean) * rsqrt(var + eps) * scale + bias, one warp a
// row, the variance over (x - mean)^2 as in the Pallas kernel.
template <typename InT>
__global__ void layer_norm_kernel(const InT* __restrict__ x, const float* __restrict__ scale,
                                  const float* __restrict__ bias, float* __restrict__ xn, int M,
                                  int C, float eps) {
  const int row = (blockIdx.x * blockDim.x + threadIdx.x) / 32;
  const int lane = threadIdx.x % 32;
  if (row >= M) return;  // whole warps leave together
  const InT* xr = x + (size_t)row * C;
  float s = 0.f;
  for (int c = lane; c < C; c += 32) s += to_f32(xr[c]);
  const float mu = warp_sum(s) / C;
  float v = 0.f;
  for (int c = lane; c < C; c += 32) {
    const float d = to_f32(xr[c]) - mu;
    v = fmaf(d, d, v);
  }
  const float rstd = rsqrtf(warp_sum(v) / C + eps);
  float* out = xn + (size_t)row * C;
  for (int c = lane; c < C; c += 32) out[c] = (to_f32(xr[c]) - mu) * rstd * scale[c] + bias[c];
}

constexpr int LN_THREADS = 256;   // layer_norm_kernel: a warp a row
constexpr int SM_COUNT = 132;     // H100 SXM: split-K aims at ~2 blocks an SM

// The products of the block.  Output rows i, columns n, reduction index k
// (A is M x Kred, B is Kred x N):
//   CONV   (B*T) x Cm pairs, k = (tap, c):   A = xn shifted by the tap, B = w_conv
//   GLU    as CONV, with the forward's epilogue (glu only)
//   POINT  (B*T) x C,        k = j < Cm:     A = glu,   B = w_point
//   DGLU   (B*T) x Cm,       k = c:          A = dy,    B = w_point^T
//   DWP    Cm x C,           k = (b, t):     A = glu^T, B = dy
//   DWC    (K*C) x 2Cm,      k = (b, t):     A = xs^T (xn shifted), B = dacc
//   DXN    (B*T) x C,        k = (tap, j):   A = dacc shifted back, B = w_conv[tap]^T
// All run on tc_gemm_kernel: the forward GLU and POINT, the backward CONV,
// DGLU, DWP, DWC and DXN.
enum Mode { CONV = 0, POINT = 1, DGLU = 2, DWP = 3, DWC = 4, DXN = 5, GLU = 6 };

struct Args {
  int T, C, K, dil;
  int M, N, Kred, k_per_split;
  const float* xn;     // (B, T, C)
  const float* wc;     // (K, C, 2Cm)
  const float* bc;     // (2Cm)
  const float* wp;     // (Cm, C)
  const float* bp;     // (C)
  const float* glu;    // (B*T, Cm)
  const float* dy;     // (B*T, C)
  const float* dglu;   // (B*T, Cm): dy @ w_point^T (the backward's CONV epilogue)
  const float* dacc;   // (B*T, 2Cm)
  const void* x_res;   // POINT with residual: x, in InT
  float* out;          // fp32 output (or the split-K slices, each M x N)
  float* out2;         // the backward's CONV: dacc
  void* out_typed;     // POINT with residual: x + y in InT
  int Cm;              // the GLU half-width: C in the square block, read only by SPLIT forms
};

// Unit stride of A along k (else along the rows), of B along n (else along k):
// each loader walks the unit-stride axis across neighbouring threads.
template <int MODE>
__host__ __device__ constexpr bool a_k_contig() { return MODE != DWP && MODE != DWC; }
template <int MODE>
__host__ __device__ constexpr bool b_n_contig() { return MODE != DGLU && MODE != DXN; }
// The conv products, which pair each tile's lin columns with their gate columns.
template <int MODE>
__host__ __device__ constexpr bool is_conv() { return MODE == CONV || MODE == GLU; }

// ---------------------------------------------------------------- the products on tensor cores

constexpr int TBM = 128, TBN = 64, TBK = 32, TSTAGES = 3;
// Eight warps, WARPS_M along the tile's rows, each a warp tile of WTM rows
// by 32 columns (MI x 4 fragments of 16 x 8); BLOCKS_SM blocks an SM.
constexpr int WARPS_M = 4, WTM = TBM / WARPS_M, MI = WTM / 16, BLOCKS_SM = 2;
static_assert(TBN / (8 / WARPS_M) == 32, "a warp tile is 32 columns: 16 lin, 16 gate pairs");
// Row strides, in floats, chosen so that a fragment's loads fall in
// distinct banks: 8-byte loads along k (8 mod 32), 4-byte loads two rows
// apart along m or n (twice the stride 8 mod 32).
constexpr int TSK = TBK + 8;  // a tile row along k: 40 floats
constexpr int TSM = TBM + 4;  // an A row along m: 132 floats
constexpr int TSN = TBN + 4;  // a B row along n: 68 floats
constexpr int TA_STAGE = TBM * TSK > TBK * TSM ? TBM * TSK : TBK * TSM;
constexpr int TB_STAGE = TBN * TSK > TBK * TSN ? TBN * TSK : TBK * TSN;
constexpr int T_STAGE = TA_STAGE + TB_STAGE;  // floats of one stage
constexpr int TC_SMEM = (int)sizeof(float) * T_STAGE * TSTAGES;  // 92,160 bytes

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// Copies V floats (V = 4: 16 bytes, L2 only; V = 1: 4 bytes) from src to
// dst in shared memory, or V zeros where !valid (a source size of 0, which
// reads nothing; src is then any valid address).
template <int V>
__device__ __forceinline__ void cp_async(float* dst, const float* src, bool valid) {
  if constexpr (V == 4)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(smem_addr(dst)),
                 "l"(src), "r"(valid ? 16 : 0)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(smem_addr(dst)),
                 "l"(src), "r"(valid ? 4 : 0)
                 : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

// Waits until at most N of the thread's newest groups are still in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// tf32(v) rounded to nearest, ties away from zero, as cvt.rna.tf32.f32
// gives it for finite v: on the bits, half a unit of the 13 dropped bits
// added, then those bits cleared.  Two integer operations at the full rate,
// where the conversion unit's cvt has a fraction of it.
__device__ __forceinline__ unsigned tf32_rna(float v) {
  return (__float_as_uint(v) + 0x1000u) & 0xFFFFE000u;
}

// The 3xTF32 split: big = tf32(v), small = tf32(v - big).
__device__ __forceinline__ void split_tf32(float v, unsigned& big, unsigned& small) {
  big = tf32_rna(v);
  small = tf32_rna(v - __uint_as_float(big));
}

// d += a b on the tensor cores: a 16 x 8 (row-major fragment), b 8 x 8
// (column-major), d 16 x 8 fp32, one warp.  Not volatile: the compiler may
// interleave independent products.
__device__ __forceinline__ void mma_tf32(float* d, const unsigned* a, const unsigned* b) {
  asm(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// One TBM x TBN output tile of a product of the block (blockIdx.z's split-K
// slice of the reduction, [kbeg, kend)), 3xTF32 on mma.sync.m16n8k8.  Warp
// w computes rows WTM (w % WARPS_M) .. + WTM and columns 32 (w / WARPS_M) ..
// + 32 of the tile: MI x 4 fragments of 16 x 8.  The fragments' k index j
// < 4 of a step of 8 is the tile's k = 2 j and j + 4 is 2 j + 1 (any order
// of the 8 serves the sum), so a thread's two k of a row are neighbours:
// one 8-byte load where the row runs along k.  Shared memory holds TSTAGES
// stages of an A tile (TBM x TBK: row-major along k, or k-major along m for
// DWP and DWC) and a B tile (TBK x TBN: along n, or along k for DGLU and
// DXN), with rows padded so that a fragment's 32 loads fall in distinct
// banks.  Each thread copies fixed V-float pieces of every tile: its own
// position along the copied rows and a fixed set of rows, so it keeps what
// does not change over the reduction (a row's time index, a column's tap)
// and steps what does (the (tap, channel) of its k, a reduction row's
// time) a tile at a time, in order.  A conv tile's (CONV, GLU) local column
// c is, for w = c / 32 and r = c % 32, pair p = TBN / 2 blockIdx.x + 16 w +
// r % 16, the lin column p where r < 16, else the gate column Cm + p: each
// warp holds both halves of its 16 pairs, so the GLU runs in the epilogue.
// POINT with RES adds x (InT) in its epilogue and writes x + y in InT.
// SPLIT: the training pair on a model rank's slice, Cm = a.Cm; otherwise
// the square block, Cm = C, compiled as it was before the split existed.
template <int MODE, int V, typename InT = float, bool RES = false, bool SPLIT = false>
__global__ void __launch_bounds__(256, BLOCKS_SM) tc_gemm_kernel(Args a) {
  extern __shared__ __align__(16) float tsm[];
  constexpr bool AK = a_k_contig<MODE>(), BNC = b_n_contig<MODE>(), CV = is_conv<MODE>();
  // Pieces: V floats along each copied row; a thread's row step and count.
  constexpr int A_LEN = AK ? TBK : TBM, A_PER = A_LEN / V, A_Q = TBM * TBK / V / 256;
  constexpr int B_LEN = BNC ? TBN : TBK, B_PER = B_LEN / V, B_Q = TBN * TBK / V / 256;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int g = lane / 4, tg = lane % 4, wm = warp % WARPS_M, wn = warp / WARPS_M;
  const int m0 = blockIdx.y * TBM, n0 = blockIdx.x * TBN;
  const int kbeg = blockIdx.z * a.k_per_split, kend = min(a.Kred, kbeg + a.k_per_split);
  const int tiles = (kend - kbeg + TBK - 1) / TBK;
  // C2: the width of w_conv, b_conv and dacc rows, 2Cm.
  const int half = a.K / 2, C = a.C, Cm = SPLIT ? a.Cm : a.C, C2 = 2 * Cm;
  const int a_pos = tid % A_PER * V, a_line = tid / A_PER;  // + (256 / A_PER) q
  const int b_pos = tid % B_PER * V, b_line = tid / B_PER;  // + (256 / B_PER) q

  // What stays over the reduction, and the trackers stepped a tile at a time.
  int a_t[A_Q];  // conv, DXN: each A row's time index; DWC: each k row's time
  int ktap = 0, kcol = 0;  // conv, DXN: the (tap, column) of this thread's k
  int w_tap = 0, w_col = 0;  // DWC: the tap and channel of this thread's row
  if constexpr (CV || MODE == DXN) {
#pragma unroll
    for (int q = 0; q < A_Q; ++q) a_t[q] = (m0 + a_line + (256 / A_PER) * q) % a.T;
    const int width = CV ? C : C2, k = kbeg + a_pos;
    ktap = k / width;
    kcol = k - ktap * width;
  } else if constexpr (MODE == DWC) {
#pragma unroll
    for (int q = 0; q < A_Q; ++q) a_t[q] = (kbeg + a_line + (256 / A_PER) * q) % a.T;
    w_tap = (m0 + a_pos) / C;
    w_col = m0 + a_pos - w_tap * C;
  }
  const int w_shift = (w_tap - half) * a.dil;
  // The operands; a copy of zeros names the operand's first element.
  const float* a_src = CV || MODE == DWC         ? a.xn
                       : MODE == DGLU              ? a.dy
                       : MODE == DWP || MODE == POINT ? a.glu
                                                   : a.dacc;
  const float* b_src = CV || MODE == DXN           ? a.wc
                       : MODE == DGLU || MODE == POINT ? a.wp
                       : MODE == DWP               ? a.dy
                                                   : a.dacc;

  auto load_tile = [&](int stage, int kt) {
    float* As = tsm + stage * T_STAGE;
    float* Bs = As + TA_STAGE;
    const int k0 = kbeg + kt * TBK;
    if constexpr (AK) {  // lines are the tile's rows i, a piece runs along k
      const int k = k0 + a_pos;
      int shift = 0;
      if constexpr (CV) shift = (ktap - half) * a.dil;
      if constexpr (MODE == DXN) shift = -(ktap - half) * a.dil;  // the gather: t - s
#pragma unroll
      for (int q = 0; q < A_Q; ++q) {
        const int r = a_line + (256 / A_PER) * q, i = m0 + r;
        bool ok = i < a.M && k < kend;
        const float* src = a_src;
        if constexpr (CV || MODE == DXN) {
          const int ts = a_t[q] + shift;
          ok = ok && ts >= 0 && ts < a.T;
          if (ok) src += (size_t)(i + shift) * (CV ? C : C2) + kcol;
        } else if (ok) {  // DGLU (dy), POINT (glu)
          src += (size_t)i * (MODE == POINT ? Cm : C) + k;
        }
        cp_async<V>(As + r * TSK + a_pos, src, ok);
      }
    } else {  // DWP, DWC: lines are reduction rows k, a piece runs along i
      const int i = m0 + a_pos;
#pragma unroll
      for (int q = 0; q < A_Q; ++q) {
        const int kk = a_line + (256 / A_PER) * q, k = k0 + kk;
        bool ok = i < a.M && k < kend;
        const float* src = a_src;
        if constexpr (MODE == DWC) {
          const int ts = a_t[q] + w_shift;
          ok = ok && ts >= 0 && ts < a.T;
          if (ok) src += (size_t)(k + w_shift) * C + w_col;
        } else if (ok) {  // DWP: glu
          src += (size_t)k * Cm + i;
        }
        cp_async<V>(As + kk * TSM + a_pos, src, ok);
      }
    }
    if constexpr (BNC) {  // lines are reduction rows k, a piece runs along n
      int n;
      if constexpr (CV) {
        const int w = b_pos / 32, r = b_pos % 32;
        const int p = blockIdx.x * (TBN / 2) + 16 * w + r % 16;
        n = p < Cm ? (r < 16 ? p : Cm + p) : -1;
      } else {
        n = n0 + b_pos < a.N ? n0 + b_pos : -1;
      }
#pragma unroll
      for (int q = 0; q < B_Q; ++q) {
        const int kk = b_line + (256 / B_PER) * q, k = k0 + kk;
        const bool ok = n >= 0 && k < kend;
        const float* src = b_src;
        if (ok) src += (size_t)k * (MODE == DWP || MODE == POINT ? C : C2) + n;
        cp_async<V>(Bs + kk * TSN + b_pos, src, ok);
      }
    } else {  // DGLU, DXN: lines are columns n, a piece runs along k
      const int k = k0 + b_pos;
#pragma unroll
      for (int q = 0; q < B_Q; ++q) {
        const int c = b_line + (256 / B_PER) * q, n = n0 + c;
        const bool ok = n < a.N && k < kend;
        const float* src = b_src;
        if (ok) {
          if constexpr (MODE == DGLU) src += (size_t)n * C + k;  // w_point^T
          else src += ((size_t)ktap * C + n) * C2 + kcol;        // DXN: w_conv[tap]^T
        }
        cp_async<V>(Bs + c * TSK + b_pos, src, ok);
      }
    }
    // Step the trackers to the next tile.
    if constexpr (CV || MODE == DXN) {
      const int width = CV ? C : C2;
      kcol += TBK;
      while (kcol >= width) {
        kcol -= width;
        ++ktap;
      }
    } else if constexpr (MODE == DWC) {
#pragma unroll
      for (int q = 0; q < A_Q; ++q) {
        a_t[q] += TBK;
        while (a_t[q] >= a.T) a_t[q] -= a.T;
      }
    }
  };

  float acc[MI][4][4] = {};
#pragma unroll
  for (int s = 0; s < TSTAGES - 1; ++s) {
    if (s < tiles) load_tile(s, s);
    cp_async_commit();
  }
  for (int kt = 0; kt < tiles; ++kt) {
    cp_async_wait<TSTAGES - 2>();  // tile kt has landed
    __syncthreads();               // for every thread, and all are done with tile kt - 1
    if (kt + TSTAGES - 1 < tiles) load_tile((kt + TSTAGES - 1) % TSTAGES, kt + TSTAGES - 1);
    cp_async_commit();
    const float* As = tsm + (kt % TSTAGES) * T_STAGE;
    const float* Bs = As + TA_STAGE;
#pragma unroll
    for (int kk = 0; kk < TBK; kk += 8) {
      unsigned ab[MI][4], as[MI][4], bb[4][2], bs[4][2];
      const int k = kk + 2 * tg;  // fragment k indices tg and tg + 4
#pragma unroll
      for (int mi = 0; mi < MI; ++mi)
#pragma unroll
        for (int h = 0; h < 2; ++h) {  // rows r and r + 8: registers h and h + 2
          const int r = wm * WTM + mi * 16 + g + 8 * h;
          const float2 v = AK ? *reinterpret_cast<const float2*>(As + r * TSK + k)
                              : make_float2(As[k * TSM + r], As[(k + 1) * TSM + r]);
          split_tf32(v.x, ab[mi][h], as[mi][h]);
          split_tf32(v.y, ab[mi][h + 2], as[mi][h + 2]);
        }
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const int c = wn * 32 + ni * 8 + g;
        const float2 v = BNC ? make_float2(Bs[k * TSN + c], Bs[(k + 1) * TSN + c])
                             : *reinterpret_cast<const float2*>(Bs + c * TSK + k);
        split_tf32(v.x, bb[ni][0], bs[ni][0]);
        split_tf32(v.y, bb[ni][1], bs[ni][1]);
      }
      // Each pass over the eight accumulators before the next, so a
      // product waits on its accumulator's previous one eight issues back.
#pragma unroll
      for (int mi = 0; mi < MI; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) mma_tf32(acc[mi][ni], as[mi], bb[ni]);
#pragma unroll
      for (int mi = 0; mi < MI; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) mma_tf32(acc[mi][ni], ab[mi], bs[ni]);
#pragma unroll
      for (int mi = 0; mi < MI; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) mma_tf32(acc[mi][ni], ab[mi], bb[ni]);
    }
  }
  cp_async_wait<0>();

  // acc[mi][ni][e] is row wm 32 + mi 16 + g + 8 (e / 2), local column
  // wn 32 + ni 8 + 2 tg + e % 2.
#pragma unroll
  for (int mi = 0; mi < MI; ++mi)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = m0 + wm * WTM + mi * 16 + g + 8 * (e >> 1);
      if (row >= a.M) continue;
      const size_t m = row;
      if constexpr (CV) {
#pragma unroll
        for (int ni = 0; ni < 2; ++ni) {  // lin in fragments 0, 1, its gate in 2, 3
          const int p = blockIdx.x * (TBN / 2) + wn * 16 + ni * 8 + 2 * tg + (e & 1);
          if (p >= Cm) continue;
          const float lin = acc[mi][ni][e] + a.bc[p];
          const float sg = sigmoid(acc[mi][ni + 2][e] + a.bc[Cm + p]);
          a.out[m * Cm + p] = lin * sg;
          if constexpr (MODE == CONV) {  // the backward's: dacc from dglu
            const float dg = a.dglu[m * Cm + p];
            a.out2[m * C2 + p] = dg * sg;
            a.out2[m * C2 + Cm + p] = dg * lin * sg * (1.f - sg);
          }
        }
      } else if constexpr (MODE == POINT) {
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) {
          const int n = n0 + wn * 32 + ni * 8 + 2 * tg + (e & 1);
          if (n >= a.N) continue;
          const float y = acc[mi][ni][e] + a.bp[n];
          const size_t idx = m * C + n;
          if constexpr (RES)
            static_cast<InT*>(a.out_typed)[idx] =
                from_f32<InT>(to_f32(static_cast<const InT*>(a.x_res)[idx]) + y);
          else
            a.out[idx] = y;
        }
      } else {
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) {
          const int n = n0 + wn * 32 + ni * 8 + 2 * tg + (e & 1);
          if (n >= a.N) continue;
          // DWP, DWC: one split-K slice each; DGLU, DXN: the output.
          a.out[(size_t)blockIdx.z * a.M * a.N + m * a.N + n] = acc[mi][ni][e];
        }
      }
    }
}

// out[idx] = sum over s of part[s][idx], slices in order.
__global__ void sum_slices_kernel(const float* __restrict__ part, float* __restrict__ out,
                                  size_t n, int S) {
  for (size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x; idx < n;
       idx += (size_t)gridDim.x * blockDim.x) {
    float acc = 0.f;
    for (int s = 0; s < S; ++s) acc += part[s * n + idx];
    out[idx] = acc;
  }
}

// part[s][n] = sum of a[m][n] over the rows m of slice s, in order.
__global__ void column_sum_kernel(const float* __restrict__ a, float* __restrict__ part, int M,
                                  int N, int rows_per_slice) {
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= N) return;
  const int m1 = min(M, (int)(blockIdx.y + 1) * rows_per_slice);
  float acc = 0.f;
  for (int m = blockIdx.y * rows_per_slice; m < m1; ++m) acc += a[(size_t)m * N + n];
  part[(size_t)blockIdx.y * N + n] = acc;
}

constexpr int COLSUM_ROWS = 64;

int cdiv(long a, long b) { return (int)((a + b - 1) / b); }

// The split-K of a backward product with an output of rows x cols reduced
// over kred.  The card runs BLOCKS_SM blocks an SM at once, so a launch goes
// in waves of BLOCKS_SM SM_COUNT blocks, and a last wave mostly empty idles
// SMs.  The split takes the fewest slices whose blocks fill their waves to
// at least 3/4 (else the fullest), with at least four 32-deep tiles a slice
// and at most 16 slices, none empty.  A function of the shapes alone, so
// results are reproducible.
struct Split {
  int slices, k_per_split;
};

Split split_k(int rows, int cols, int kred) {
  const long tiles = (long)cdiv(rows, TBM) * cdiv(cols, TBN), wave = (long)BLOCKS_SM * SM_COUNT;
  const int most = std::max(1, std::min(16, cdiv(kred, 4 * TBK)));
  int s = 1;
  double best = 0.0;
  for (int c = 1; c <= most; ++c) {
    const double fill = (double)(tiles * c) / (wave * ((tiles * c + wave - 1) / wave));
    if (fill > best + 1e-9) {
      best = fill;
      s = c;
    }
    if (fill >= 0.75) break;
  }
  const int kps = cdiv(cdiv(kred, s), TBK) * TBK;
  return {cdiv(kred, kps), kps};
}

Args geometry(int T, int C, int Cm, int K, int dil) {
  Args a = {};
  a.T = T;
  a.C = C;
  a.Cm = Cm;
  a.K = K;
  a.dil = dil;
  return a;
}

template <int MODE, int V, typename InT, bool RES, bool SPLIT>
cudaError_t tc_launch(const Args& a, dim3 grid, cudaStream_t st) {
  auto kernel = tc_gemm_kernel<MODE, V, InT, RES, SPLIT>;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, TC_SMEM);
  if (err != cudaSuccess) return err;
  kernel<<<grid, 256, TC_SMEM, st>>>(a);
  return cudaGetLastError();
}

// A product on tc_gemm_kernel, in `split` slices (CONV, GLU: N is Cm, the
// pairs, and one slice; POINT one slice).  16-byte copies where every row
// of every operand starts and steps on a 16-byte boundary (C and Cm
// multiples of 4).  Partial tiles (Cm 96 against TBN 64 in DGLU, DWP's
// rows) are bounded by the loaders' and the epilogue's checks.
template <int MODE, typename InT = float, bool RES = false>
cudaError_t tc_gemm(Args a, int M, int N, int Kred, Split split, cudaStream_t st) {
  a.M = M;
  a.N = N;
  a.Kred = Kred;
  a.k_per_split = split.k_per_split;
  const dim3 grid(is_conv<MODE>() ? cdiv(N, TBN / 2) : cdiv(N, TBN), cdiv(M, TBM),
                  split.slices);
  const bool vec = a.C % 4 == 0 && a.Cm % 4 == 0;
  if (a.Cm == a.C)
    return vec ? tc_launch<MODE, 4, InT, RES, false>(a, grid, st)
               : tc_launch<MODE, 1, InT, RES, false>(a, grid, st);
  if constexpr (RES) return cudaErrorInvalidValue;  // K5 is square
  else
    return vec ? tc_launch<MODE, 4, InT, RES, true>(a, grid, st)
               : tc_launch<MODE, 1, InT, RES, true>(a, grid, st);
}

constexpr Split WHOLE = {1, 1 << 30};  // one slice: the whole reduction

cudaError_t sum_slices(const float* part, float* out, size_t n, int S, cudaStream_t st) {
  const int blocks = std::min(cdiv((long)n, 256), 4 * SM_COUNT);
  sum_slices_kernel<<<blocks, 256, 0, st>>>(part, out, n, S);
  return cudaGetLastError();
}

cudaError_t column_sum(const float* a, float* part, float* out, int M, int N, cudaStream_t st) {
  const int S = cdiv(M, COLSUM_ROWS);
  column_sum_kernel<<<dim3(cdiv(N, 256), S), 256, 0, st>>>(a, part, M, N, COLSUM_ROWS);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return sum_slices(part, out, N, S, st);
}

// The backward's fp32 scratch, carved in this order: dglu, glu, dacc, then
// the split-K slices of each product that has more than one, then the
// column sums' slices (of dacc's 2Cm columns and dy's C).
struct BwdLayout {
  size_t dglu, glu, dacc, dglu_part, dwp_part, dwc_part, dxn_part, col_part, total;
  Split sdglu, sdwp, sdwc, sdxn;
};

BwdLayout bwd_layout(int B, int T, int C, int Cm, int K) {
  const size_t M = (size_t)B * T, C2 = 2 * (size_t)Cm;
  BwdLayout l;
  l.sdglu = split_k((int)M, Cm, C);
  l.sdwp = split_k(Cm, C, (int)M);
  l.sdwc = split_k(K * C, 2 * Cm, (int)M);
  l.sdxn = split_k((int)M, C, K * 2 * Cm);
  auto part = [](const Split& sp, size_t n) { return sp.slices > 1 ? sp.slices * n : 0; };
  l.dglu = 0;
  l.glu = l.dglu + M * Cm;
  l.dacc = l.glu + M * Cm;
  l.dglu_part = l.dacc + M * C2;
  l.dwp_part = l.dglu_part + part(l.sdglu, M * Cm);
  l.dwc_part = l.dwp_part + part(l.sdwp, (size_t)Cm * C);
  l.dxn_part = l.dwc_part + part(l.sdwc, (size_t)K * C * C2);
  l.col_part = l.dxn_part + part(l.sdxn, M * C);
  l.total = l.col_part + (size_t)cdiv((long)M, COLSUM_ROWS) * std::max(C2, (size_t)C);
  return l;
}

// A backward product into `out`, through its slices and their sum when the
// split has more than one.
template <int MODE>
cudaError_t tc_product(Args a, int M, int N, int Kred, Split split, float* part, float* out,
                       cudaStream_t st) {
  a.out = split.slices > 1 ? part : out;
  const cudaError_t err = tc_gemm<MODE>(a, M, N, Kred, split, st);
  if (err != cudaSuccess || split.slices == 1) return err;
  return sum_slices(part, out, (size_t)M * N, split.slices, st);
}

}  // namespace

// K5 (residual = 1, Cm = C) and the K6 forward (residual = 0).  x (B, T, C)
// in bf16 when in_bf16, else fp32; xn (B, T, C) and glu (B, T, Cm) fp32: xn
// is the K6 forward's second output, glu scratch.  out: x + y in x's type
// (K5), or y fp32 (K6).  Returns the first failing launch's cudaError_t, or 0.
extern "C" int tcn_block_fwd(const void* x, const float* ln_scale, const float* ln_bias,
                             const float* wc, const float* bc, const float* wp, const float* bp,
                             float* xn, float* glu, void* out, int B, int T, int C, int Cm,
                             int K, int dil, float eps, int in_bf16, int residual,
                             void* stream) {
  if (B == 0 || T == 0) return 0;
  const cudaStream_t st = (cudaStream_t)stream;
  const int M = B * T;
  const int ln_blocks = cdiv(M, LN_THREADS / 32);
  if (in_bf16)
    layer_norm_kernel<bf16><<<ln_blocks, LN_THREADS, 0, st>>>(static_cast<const bf16*>(x),
                                                              ln_scale, ln_bias, xn, M, C, eps);
  else
    layer_norm_kernel<float><<<ln_blocks, LN_THREADS, 0, st>>>(static_cast<const float*>(x),
                                                               ln_scale, ln_bias, xn, M, C, eps);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  Args a = geometry(T, C, Cm, K, dil);
  a.xn = xn;
  a.wc = wc;
  a.bc = bc;
  a.out = glu;
  if ((err = tc_gemm<GLU>(a, M, Cm, K * C, WHOLE, st)) != cudaSuccess) return err;

  Args p = geometry(T, C, Cm, K, dil);
  p.glu = glu;
  p.wp = wp;
  p.bp = bp;
  if (!residual) {
    p.out = static_cast<float*>(out);
    return tc_gemm<POINT>(p, M, C, Cm, WHOLE, st);
  }
  p.x_res = x;
  p.out_typed = out;
  return in_bf16 ? tc_gemm<POINT, bf16, true>(p, M, C, Cm, WHOLE, st)
                 : tc_gemm<POINT, float, true>(p, M, C, Cm, WHOLE, st);
}

// Floats of fp32 scratch that tcn_block_bwd needs at these shapes.
extern "C" int tcn_block_bwd_workspace(int B, int T, int C, int Cm, int K) {
  return (int)bwd_layout(B, T, C, Cm, K).total;
}

// K6 backward.  xn, dy (B, T, C) fp32; ws: tcn_block_bwd_workspace floats;
// outputs fp32: dxn (B, T, C), dwc (K, C, 2Cm), dbc (2Cm), dwp (Cm, C), dbp (C).
extern "C" int tcn_block_bwd(const float* xn, const float* dy, const float* wc, const float* bc,
                             const float* wp, float* ws, float* dxn, float* dwc, float* dbc,
                             float* dwp, float* dbp, int B, int T, int C, int Cm, int K, int dil,
                             void* stream) {
  if (B == 0 || T == 0) return 0;
  const cudaStream_t st = (cudaStream_t)stream;
  const int M = B * T;
  const BwdLayout l = bwd_layout(B, T, C, Cm, K);
  float* dglu = ws + l.dglu;
  float* glu = ws + l.glu;
  float* dacc = ws + l.dacc;

  Args g = geometry(T, C, Cm, K, dil);
  g.dy = dy;
  g.wp = wp;
  cudaError_t err = tc_product<DGLU>(g, M, Cm, C, l.sdglu, ws + l.dglu_part, dglu, st);
  if (err != cudaSuccess) return err;

  // The GLU tensors again, from xn: glu, and dacc from dglu in the epilogue.
  Args a = geometry(T, C, Cm, K, dil);
  a.xn = xn;
  a.wc = wc;
  a.bc = bc;
  a.dglu = dglu;
  a.out = glu;
  a.out2 = dacc;
  if ((err = tc_gemm<CONV>(a, M, Cm, K * C, WHOLE, st)) != cudaSuccess) return err;

  Args w = geometry(T, C, Cm, K, dil);
  w.glu = glu;
  w.dy = dy;
  if ((err = tc_product<DWP>(w, Cm, C, M, l.sdwp, ws + l.dwp_part, dwp, st)) !=
      cudaSuccess)
    return err;

  Args c = geometry(T, C, Cm, K, dil);
  c.xn = xn;
  c.dacc = dacc;
  if ((err = tc_product<DWC>(c, K * C, 2 * Cm, M, l.sdwc, ws + l.dwc_part, dwc, st)) !=
      cudaSuccess)
    return err;

  Args d = geometry(T, C, Cm, K, dil);
  d.dacc = dacc;
  d.wc = wc;
  if ((err = tc_product<DXN>(d, M, C, K * 2 * Cm, l.sdxn, ws + l.dxn_part, dxn, st)) !=
      cudaSuccess)
    return err;

  if ((err = column_sum(dacc, ws + l.col_part, dbc, M, 2 * Cm, st)) != cudaSuccess) return err;
  return column_sum(dy, ws + l.col_part, dbp, M, C, st);
}

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
// (K, C, 2C), b_conv (2C), w_point (C, C), b_point (C), all parameters fp32:
//   xn  = LayerNorm(x) * ln_scale + ln_bias              (eps 1e-6, two-pass)
//   acc = sum_k xn[t + (k - K/2) d] @ w_conv[k] + b_conv  (taps outside [0, T) read 0)
//   glu = acc[:, :C] * sigmoid(acc[:, C:])
//   y   = glu @ w_point + b_point
// K5 writes x + y in x's type, the sum taken in fp32; the K6 forward writes y
// and keeps xn, both fp32.  Every product is fp32 FMA on the CUDA cores: the
// JAX package holds its kernel to a Precision.HIGHEST reference at 2e-4, so
// no TF32.  Rows past an utterance's length are not special: their xn is
// ln_bias, and the last valid frames' taps read it, as in both JAX paths.
//
// Why the TPU design does not carry over: the Pallas kernel keeps a halo'd
// (256 + 64, C) fp32 slab of x plus a (256, 2C) accumulator in VMEM, about
// 480 KB at C = 384, and walks time blocks on a sequential grid, carrying
// the weight-gradient sums across grid steps.  A Hopper block has 227 KB of
// shared memory and blocks run in no order.  So each wrapper call here is a
// few launches:
//   1. layer_norm_kernel: one warp a row writes xn (B*T, C) fp32 (9.8 MB at
//      B 16, T' 400, C 384: it stays in L2 for the next launch).
//   2. gemm_kernel<CONV>: the dilated conv as an implicit GEMM, rows (b, t)
//      by 32 output-channel pairs: lin columns n0..n0+32 together with the
//      gate columns C + n0.., so the GLU runs in the epilogue; the reduction
//      walks the K*C (tap, channel) pairs, reading xn rows at t + (k - K/2) d.
//   3. gemm_kernel<POINT>: glu @ w_point with a + b_point (+ x) epilogue.
// The backward recomputes the GLU pre-activations from xn (as the TPU kernel
// does, :214-226) instead of saving them, then:
//   dglu = dy @ w_point^T, with dacc = [dglu sg, dglu lin sg (1 - sg)] in
//   the epilogue (gemm_kernel<DGLU>); dw_point = glu^T dy (<DWP>);
//   dw_conv[k] = xs_k^T dacc (<DWC>); dxn[t] = sum_k dacc[t - (k - K/2) d]
//   w_conv[k]^T, written as a gather (<DXN>: the transposed conv; the TPU's
//   per-block halo slabs and their overlap-add were a workaround for its
//   sequential grid); db_conv, db_point are column sums.  The weight
//   gradients reduce over all B*T rows: inside one block an output tile,
//   split over the reduction in a fixed number of slices when the tiles
//   alone would leave SMs idle, then summed slice by slice in a second pass.
//   No atomics, so results are the same from run to run.
//
// Bound on this card: operations.  A block's forward is 2 B T C (K 2C + C)
// = 20.8 GFLOP at B 16, T' 400, C 384, K 5 against ~40 MB of inputs and
// outputs: 0.31 ms at 67 TFLOP/s fp32; the backward ~60 GFLOP, ~0.90 ms.
// The design goes at that bound with a register-tiled SIMT GEMM: 128 x 64
// tiles, 8 x 4 outputs a thread, 16-deep slices of A and B in shared memory,
// so each shared-memory load feeds 2.7 FMAs.  It is not double-buffered and
// uses no tensor cores: the 3xTF32 split on wgmma is later work.

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

constexpr int BM = 128, BN = 64, BK = 16, THREADS = 256, TM = 8, TN = 4;
constexpr int HALF_BN = BN / 2;        // output-channel pairs a CONV tile covers
constexpr int AQ = BM * BK / THREADS;  // A elements each thread loads a step
constexpr int BQ = BK * BN / THREADS;  // B elements each thread loads a step
constexpr int SM_COUNT = 132;          // H100 SXM: split-K aims at ~2 blocks an SM

// The six products of the block.  Output rows i, columns n, reduction index
// k (A is M x Kred, B is Kred x N):
//   CONV   (B*T) x C pairs,  k = (tap, c):   A = xn shifted by the tap, B = w_conv
//   POINT  (B*T) x C,        k = c:          A = glu,   B = w_point
//   DGLU   (B*T) x C,        k = c:          A = dy,    B = w_point^T
//   DWP    C x C,            k = (b, t):     A = glu^T, B = dy
//   DWC    (K*C) x 2C,       k = (b, t):     A = xs^T (xn shifted), B = dacc
//   DXN    (B*T) x C,        k = (tap, j):   A = dacc shifted back, B = w_conv[tap]^T
enum Mode { CONV = 0, POINT = 1, DGLU = 2, DWP = 3, DWC = 4, DXN = 5 };

struct Args {
  int T, C, K, dil;
  int M, N, Kred, k_per_split;
  const float* xn;     // (B, T, C)
  const float* wc;     // (K, C, 2C)
  const float* bc;     // (2C)
  const float* wp;     // (C, C)
  const float* bp;     // (C)
  const float* glu;    // (B*T, C)
  const float* dy;     // (B*T, C)
  const float* pre;    // (B*T, 2C): lin | gate pre-activations, biases added
  const float* dacc;   // (B*T, 2C)
  const void* x_res;   // POINT with residual: x, in InT
  float* out;          // fp32 output (or the split-K slices, each M x N)
  float* out2;         // CONV: the pre-activations too (backward), or null
  void* out_typed;     // POINT with residual: x + y in InT
};

// Unit stride of A along k (else along the rows), of B along n (else along k):
// each loader walks the unit-stride axis across neighbouring threads.
template <int MODE>
__host__ __device__ constexpr bool a_k_contig() { return MODE != DWP && MODE != DWC; }
template <int MODE>
__host__ __device__ constexpr bool b_n_contig() { return MODE != DGLU && MODE != DXN; }

// Global column of the tile's local column c, or -1 past the edge.  A CONV
// tile pairs lin columns n0 .. n0+32 with gate columns C + n0 .. so each
// thread holds both halves of its GLU outputs.
template <int MODE>
__device__ __forceinline__ int tile_col(const Args& a, int c) {
  if constexpr (MODE == CONV) {
    const int p = blockIdx.x * HALF_BN + (c % HALF_BN);
    return p < a.C ? (c < HALF_BN ? p : a.C + p) : -1;
  } else {
    const int n = blockIdx.x * BN + c;
    return n < a.N ? n : -1;
  }
}

// One 128 x 64 output tile, the reduction over [kbeg, kend) of blockIdx.z's
// slice, accumulated in fp32 in k order.  Thread (tx, ty) owns rows
// ty + 16 i and columns tx + 16 j.  The loaders keep what does not change
// over the k loop (a row's time index, a row's tap) and decompose the
// reduction index once a step.  A shifted row (b, t + s) of a (B, T, width)
// tensor is flat row m + s; it reads 0 outside [0, T), the zero padding of
// the conv at the edges of the padded batch.
template <int MODE, typename InT, bool RES>
__global__ void __launch_bounds__(THREADS) gemm_kernel(Args a) {
  __shared__ float As[BK][BM + 4];
  __shared__ float Bs[BK][BN + 1];
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int m0 = blockIdx.y * BM;
  const int kbeg = blockIdx.z * a.k_per_split;
  const int kend = min(a.Kred, kbeg + a.k_per_split);
  const int half = a.K / 2;
  const size_t C = a.C, C2 = 2 * C;

  int a_t[AQ] = {};  // CONV, DXN: the time index of each row this thread loads
  if constexpr (MODE == CONV || MODE == DXN) {
#pragma unroll
    for (int q = 0; q < AQ; ++q) a_t[q] = (m0 + tid / BK + 16 * q) % a.T;
  }
  int w_col = 0, w_shift = 0;  // DWC: channel and tap shift of this thread's row
  if constexpr (MODE == DWC) {
    const int i = m0 + tid % BM, tap = i / a.C;
    w_col = i - tap * a.C;
    w_shift = (tap - half) * a.dil;
  }
  int t0 = kbeg % a.T;  // DWC: time index of reduction row k0

  float acc[TM][TN] = {};
  for (int k0 = kbeg; k0 < kend; k0 += BK) {
    if constexpr (a_k_contig<MODE>()) {
      const int kk = tid % BK, k = k0 + kk;
      int col = k, shift = 0;
      if constexpr (MODE == CONV) {
        const int tap = k / a.C;
        col = k - tap * a.C;
        shift = (tap - half) * a.dil;
      } else if constexpr (MODE == DXN) {  // dacc row t reaches xn row t + s: gather t - s
        const int tap = k / (2 * a.C);
        col = k - tap * 2 * a.C;
        shift = -(tap - half) * a.dil;
      }
#pragma unroll
      for (int q = 0; q < AQ; ++q) {
        const int r = tid / BK + 16 * q, i = m0 + r;
        float v = 0.f;
        if (i < a.M && k < kend) {
          const int ts = a_t[q] + shift;
          if constexpr (MODE == CONV) {
            if (ts >= 0 && ts < a.T) v = a.xn[(size_t)(i + shift) * C + col];
          } else if constexpr (MODE == DXN) {
            if (ts >= 0 && ts < a.T) v = a.dacc[(size_t)(i + shift) * C2 + col];
          } else if constexpr (MODE == POINT) {
            v = a.glu[(size_t)i * C + k];
          } else {  // DGLU
            v = a.dy[(size_t)i * C + k];
          }
        }
        As[kk][r] = v;
      }
    } else {
      const int r = tid % BM, i = m0 + r;
#pragma unroll
      for (int q = 0; q < AQ; ++q) {
        const int kk = tid / BM + (THREADS / BM) * q, k = k0 + kk;
        float v = 0.f;
        if (i < a.M && k < kend) {
          if constexpr (MODE == DWP) {
            v = a.glu[(size_t)k * C + i];
          } else {  // DWC
            int t = t0 + kk;
            while (t >= a.T) t -= a.T;
            const int ts = t + w_shift;
            if (ts >= 0 && ts < a.T) v = a.xn[(size_t)(k + w_shift) * C + w_col];
          }
        }
        As[kk][r] = v;
      }
    }
    if constexpr (b_n_contig<MODE>()) {
      const int c = tid % BN, n = tile_col<MODE>(a, c);
#pragma unroll
      for (int q = 0; q < BQ; ++q) {
        const int kk = tid / BN + (THREADS / BN) * q, k = k0 + kk;
        float v = 0.f;
        if (n >= 0 && k < kend) {
          if constexpr (MODE == CONV) v = a.wc[k * C2 + n];
          else if constexpr (MODE == POINT) v = a.wp[k * C + n];
          else if constexpr (MODE == DWP) v = a.dy[k * C + n];
          else v = a.dacc[k * C2 + n];  // DWC
        }
        Bs[kk][c] = v;
      }
    } else {
      const int kk = tid % BK, k = k0 + kk;
      const int tap = MODE == DXN ? k / (2 * a.C) : 0, j = k - tap * 2 * a.C;
#pragma unroll
      for (int q = 0; q < BQ; ++q) {
        const int c = tid / BK + 16 * q, n = tile_col<MODE>(a, c);
        float v = 0.f;
        if (n >= 0 && k < kend) {
          if constexpr (MODE == DGLU) v = a.wp[n * C + k];  // w_point^T
          else v = a.wc[((size_t)tap * C + n) * C2 + j];     // DXN: w_conv[tap]^T
        }
        Bs[kk][c] = v;
      }
    }
    if constexpr (MODE == DWC) {
      t0 += BK;
      while (t0 >= a.T) t0 -= a.T;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float av[TM], bv[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) av[i] = As[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < TN; ++j) bv[j] = Bs[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const size_t m = m0 + ty + 16 * i;
    if (m >= (size_t)a.M) continue;
    if constexpr (MODE == CONV) {
      // acc[i][j] and acc[i][j + 2] are lin and gate of pair n0 + tx + 16 j.
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int p = blockIdx.x * HALF_BN + tx + 16 * j;
        if (p >= a.C) continue;
        const float lin = acc[i][j] + a.bc[p];
        const float gate = acc[i][j + 2] + a.bc[C + p];
        a.out[m * C + p] = lin * sigmoid(gate);
        if (a.out2) {
          a.out2[m * C2 + p] = lin;
          a.out2[m * C2 + C + p] = gate;
        }
      }
    } else {
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const int n = blockIdx.x * BN + tx + 16 * j;
        if (n >= a.N) continue;
        const float v = acc[i][j];
        if constexpr (MODE == POINT) {
          const float y = v + a.bp[n];
          if constexpr (RES) {
            const size_t idx = m * C + n;
            static_cast<InT*>(a.out_typed)[idx] =
                from_f32<InT>(to_f32(static_cast<const InT*>(a.x_res)[idx]) + y);
          } else {
            a.out[m * C + n] = y;
          }
        } else if constexpr (MODE == DGLU) {
          const float lin = a.pre[m * C2 + n], sg = sigmoid(a.pre[m * C2 + C + n]);
          a.out[m * C2 + n] = v * sg;
          a.out[m * C2 + C + n] = v * lin * sg * (1.f - sg);
        } else {  // DWP, DWC (one split-K slice each), DXN
          a.out[(size_t)blockIdx.z * a.M * a.N + m * a.N + n] = v;
        }
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

// Split-K slices for an output of rows x cols reduced over kred: enough
// blocks for about two an SM, at least four 16-deep steps a slice, at most
// 16 slices.  A function of the shapes alone, so results are reproducible.
int slices(int rows, int cols, int kred) {
  const long tiles = (long)cdiv(rows, BM) * cdiv(cols, BN);
  int s = cdiv(2L * SM_COUNT, tiles);
  s = std::min(s, cdiv(kred, 4 * BK));
  s = std::min(s, 16);
  return std::max(s, 1);
}

Args geometry(int T, int C, int K, int dil) {
  Args a = {};
  a.T = T;
  a.C = C;
  a.K = K;
  a.dil = dil;
  return a;
}

template <int MODE, typename InT = float, bool RES = false>
cudaError_t gemm(Args a, int M, int N, int Kred, int S, cudaStream_t st) {
  a.M = M;
  a.N = N;
  a.Kred = Kred;
  a.k_per_split = cdiv(cdiv(Kred, S), BK) * BK;
  const dim3 grid(MODE == CONV ? cdiv(N, HALF_BN) : cdiv(N, BN), cdiv(M, BM), S);
  gemm_kernel<MODE, InT, RES><<<grid, THREADS, 0, st>>>(a);
  return cudaGetLastError();
}

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

// The backward's fp32 scratch, carved in this order.
struct BwdLayout {
  size_t pre, glu, dacc, dwc_part, dwp_part, col_part, total;
  int s_dwc, s_dwp;
};

BwdLayout bwd_layout(int B, int T, int C, int K) {
  const size_t M = (size_t)B * T, C2 = 2 * (size_t)C;
  BwdLayout l;
  l.s_dwc = slices(K * C, 2 * C, (int)M);
  l.s_dwp = slices(C, C, (int)M);
  l.pre = 0;
  l.glu = l.pre + M * C2;
  l.dacc = l.glu + M * C;
  l.dwc_part = l.dacc + M * C2;
  l.dwp_part = l.dwc_part + (l.s_dwc > 1 ? (size_t)l.s_dwc * K * C * C2 : 0);
  l.col_part = l.dwp_part + (l.s_dwp > 1 ? (size_t)l.s_dwp * C * C : 0);
  l.total = l.col_part + (size_t)cdiv((long)M, COLSUM_ROWS) * C2;
  return l;
}

}  // namespace

// K5 (residual = 1) and the K6 forward (residual = 0).  x (B, T, C) in bf16
// when in_bf16, else fp32; xn and glu (B, T, C) fp32: xn is the K6 forward's
// second output, glu scratch.  out: x + y in x's type (K5), or y fp32 (K6).
// Returns the first failing launch's cudaError_t, or 0.
extern "C" int tcn_block_fwd(const void* x, const float* ln_scale, const float* ln_bias,
                             const float* wc, const float* bc, const float* wp, const float* bp,
                             float* xn, float* glu, void* out, int B, int T, int C, int K, int dil,
                             float eps, int in_bf16, int residual, void* stream) {
  if (B == 0 || T == 0) return 0;
  const cudaStream_t st = (cudaStream_t)stream;
  const int M = B * T;
  const int ln_blocks = cdiv(M, THREADS / 32);
  if (in_bf16)
    layer_norm_kernel<bf16><<<ln_blocks, THREADS, 0, st>>>(static_cast<const bf16*>(x), ln_scale,
                                                           ln_bias, xn, M, C, eps);
  else
    layer_norm_kernel<float><<<ln_blocks, THREADS, 0, st>>>(static_cast<const float*>(x),
                                                            ln_scale, ln_bias, xn, M, C, eps);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  Args a = geometry(T, C, K, dil);
  a.xn = xn;
  a.wc = wc;
  a.bc = bc;
  a.out = glu;
  if ((err = gemm<CONV>(a, M, C, K * C, 1, st)) != cudaSuccess) return err;

  Args p = geometry(T, C, K, dil);
  p.glu = glu;
  p.wp = wp;
  p.bp = bp;
  if (!residual) {
    p.out = static_cast<float*>(out);
    return gemm<POINT>(p, M, C, C, 1, st);
  }
  p.x_res = x;
  p.out_typed = out;
  return in_bf16 ? gemm<POINT, bf16, true>(p, M, C, C, 1, st)
                 : gemm<POINT, float, true>(p, M, C, C, 1, st);
}

// Floats of fp32 scratch that tcn_block_bwd needs at these shapes.
extern "C" int tcn_block_bwd_workspace(int B, int T, int C, int K) {
  return (int)bwd_layout(B, T, C, K).total;
}

// K6 backward.  xn, dy (B, T, C) fp32; ws: tcn_block_bwd_workspace floats;
// outputs fp32: dxn (B, T, C), dwc (K, C, 2C), dbc (2C), dwp (C, C), dbp (C).
extern "C" int tcn_block_bwd(const float* xn, const float* dy, const float* wc, const float* bc,
                             const float* wp, float* ws, float* dxn, float* dwc, float* dbc,
                             float* dwp, float* dbp, int B, int T, int C, int K, int dil,
                             void* stream) {
  if (B == 0 || T == 0) return 0;
  const cudaStream_t st = (cudaStream_t)stream;
  const int M = B * T;
  const BwdLayout l = bwd_layout(B, T, C, K);
  float* pre = ws + l.pre;
  float* glu = ws + l.glu;
  float* dacc = ws + l.dacc;

  // The GLU tensors again, from xn: glu, and lin | gate before the GLU.
  Args a = geometry(T, C, K, dil);
  a.xn = xn;
  a.wc = wc;
  a.bc = bc;
  a.out = glu;
  a.out2 = pre;
  cudaError_t err = gemm<CONV>(a, M, C, K * C, 1, st);
  if (err != cudaSuccess) return err;

  Args g = geometry(T, C, K, dil);
  g.dy = dy;
  g.wp = wp;
  g.pre = pre;
  g.out = dacc;
  if ((err = gemm<DGLU>(g, M, C, C, 1, st)) != cudaSuccess) return err;

  Args w = geometry(T, C, K, dil);
  w.glu = glu;
  w.dy = dy;
  w.out = l.s_dwp > 1 ? ws + l.dwp_part : dwp;
  if ((err = gemm<DWP>(w, C, C, M, l.s_dwp, st)) != cudaSuccess) return err;
  if (l.s_dwp > 1 &&
      (err = sum_slices(ws + l.dwp_part, dwp, (size_t)C * C, l.s_dwp, st)) != cudaSuccess)
    return err;

  Args c = geometry(T, C, K, dil);
  c.xn = xn;
  c.dacc = dacc;
  c.out = l.s_dwc > 1 ? ws + l.dwc_part : dwc;
  if ((err = gemm<DWC>(c, K * C, 2 * C, M, l.s_dwc, st)) != cudaSuccess) return err;
  if (l.s_dwc > 1 &&
      (err = sum_slices(ws + l.dwc_part, dwc, (size_t)K * C * 2 * C, l.s_dwc, st)) !=
          cudaSuccess)
    return err;

  Args d = geometry(T, C, K, dil);
  d.dacc = dacc;
  d.wc = wc;
  d.out = dxn;
  if ((err = gemm<DXN>(d, M, C, K * 2 * C, 1, st)) != cudaSuccess) return err;

  if ((err = column_sum(dacc, ws + l.col_part, dbc, M, 2 * C, st)) != cudaSuccess) return err;
  return column_sum(dy, ws + l.col_part, dbp, M, C, st);
}

// One LSTM direction over a padded batch, inference forward, for Hopper
// (sm_90a), CUDA C++.
//
// Replaces: pytorch_asr_tpu/ops/lstm_pallas.py::lstm_seq, inference forward
// (_fwd_impl with save_residuals=False, kernel body _fwd_kernel).  Python
// side: ops/lstm_cuda.py.
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
// Bound on this card: operations.  At the serving shapes (B 8, T' up to
// about 400, D 640 or 768, H 384) the projection is 2 * D * 4H operations a
// valid step and the recurrence 2 * H * 4H in fp32, against about 12 MB of
// inputs and outputs.  In practice the recurrence is bound by latency: its
// len steps are serial, and each step needs all of whh (2.4 MB fp32).
//
// Design, first and simple, in two launches on one stream:
//  1. input_projection_kernel: xproj = x @ wih + bias for all B*T rows, a
//     shared-memory tiled product (64x64 tile, 4x4 outputs a thread) with
//     fp32 FMA accumulation into fp32 scratch.
//  2. lstm_recurrence_kernel: one block per utterance carries h and c in
//     shared memory across all steps inside the block (GPU blocks run in no
//     order, so the TPU grid's carry across sequential grid steps becomes a
//     loop inside the block).  Each step, thread j computes gate columns
//     j, j + blockDim, ... as fp32 dot products of h with whh columns read
//     from L2 (coalesced across threads), then H threads apply the cell.
//     Only the len valid steps are computed; the rest of the output is
//     written as zeros once.
// This keeps only B of the card's SMs busy and reads whh from L2 every
// step.  Later work: spread whh over a cluster's shared memory so each step
// reads it from shared memory, and run the projection on tensor cores.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);  // round to nearest even, as a JAX astype
}

__device__ __forceinline__ float sigmoid(float v) { return 1.f / (1.f + expf(-v)); }

constexpr int BM = 64, BN = 64, BK = 16, PROJ_THREADS = 256;

// y (M, N) fp32 = x (M, K) @ w (K, N) + bias (N); each thread owns rows
// ty + 16 i and columns tx + 16 j of the block's 64x64 tile.
template <typename InT>
__global__ void __launch_bounds__(PROJ_THREADS) input_projection_kernel(
    const InT* __restrict__ x, const InT* __restrict__ w,
    const float* __restrict__ bias, float* __restrict__ y, int M, int N, int K) {
  __shared__ float As[BK][BM + 4];
  __shared__ float Bs[BK][BN];
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  float acc[4][4] = {};
  for (int k0 = 0; k0 < K; k0 += BK) {
    for (int e = threadIdx.x; e < BM * BK; e += PROJ_THREADS) {
      const int r = e / BK, kk = e % BK;
      const int m = m0 + r, k = k0 + kk;
      As[kk][r] = (m < M && k < K) ? to_f32(x[(size_t)m * K + k]) : 0.f;
    }
    for (int e = threadIdx.x; e < BK * BN; e += PROJ_THREADS) {
      const int kk = e / BN, c = e % BN;
      const int k = k0 + kk, n = n0 + c;
      Bs[kk][c] = (k < K && n < N) ? to_f32(w[(size_t)k * N + n]) : 0.f;
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
      if (n < N) y[(size_t)m * N + n] = acc[i][j] + bias[n];
    }
  }
}

template <typename OutT>
__global__ void __launch_bounds__(1024) lstm_recurrence_kernel(
    const float* __restrict__ xproj, const float* __restrict__ whh,
    const int* __restrict__ lengths, OutT* __restrict__ out, int T, int H,
    int reverse) {
  extern __shared__ float smem[];
  float* h = smem;          // (H) hidden carry
  float* c = smem + H;      // (H) cell carry
  float* pre = smem + 2 * H;  // (4H) gate pre-activations of this step
  const int b = blockIdx.x;
  const int G = 4 * H;
  const int len = max(0, min(lengths[b], T));
  OutT* ob = out + (size_t)b * T * H;

  for (int k = threadIdx.x; k < H; k += blockDim.x) {
    h[k] = 0.f;
    c[k] = 0.f;
  }
  for (size_t i = (size_t)len * H + threadIdx.x; i < (size_t)T * H; i += blockDim.x)
    ob[i] = from_f32<OutT>(0.f);
  __syncthreads();

  for (int s = 0; s < len; ++s) {
    const int t = reverse ? len - 1 - s : s;
    const float* xp = xproj + ((size_t)b * T + t) * G;
    for (int col = threadIdx.x; col < G; col += blockDim.x) {
      float acc = 0.f;
#pragma unroll 8
      for (int r = 0; r < H; ++r) acc = fmaf(h[r], whh[(size_t)r * G + col], acc);
      pre[col] = xp[col] + acc;
    }
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
      ob[(size_t)t * H + k] = from_f32<OutT>(hn);
    }
    __syncthreads();
  }
}

template <typename InT>
cudaError_t launch_projection(const void* x, const void* wih, const float* bias,
                              float* xproj, int M, int N, int K, cudaStream_t st) {
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  input_projection_kernel<InT><<<grid, PROJ_THREADS, 0, st>>>(
      static_cast<const InT*>(x), static_cast<const InT*>(wih), bias, xproj, M, N, K);
  return cudaGetLastError();
}

template <typename OutT>
cudaError_t launch_recurrence(const float* xproj, const float* whh,
                              const int* lengths, void* out, int B, int T, int H,
                              int reverse, cudaStream_t st) {
  const size_t smem = (size_t)6 * H * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(lstm_recurrence_kernel<OutT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return err;
  const int threads = 2 * H >= 1024 ? 1024 : (2 * H + 31) / 32 * 32;
  lstm_recurrence_kernel<OutT><<<B, threads, smem, st>>>(
      xproj, whh, lengths, static_cast<OutT*>(out), T, H, reverse);
  return cudaGetLastError();
}

}  // namespace

// xproj: (B, T, 4H) fp32 scratch; in_bf16 / out_bf16 pick the types of
// x and wih / of out (else fp32).  Returns the first failing launch's
// cudaError_t, or 0.
extern "C" int lstm_seq_fwd(const void* x, const void* wih, const float* whh,
                            const float* bias, const int* lengths, float* xproj,
                            void* out, int B, int T, int D, int H, int reverse,
                            int in_bf16, int out_bf16, void* stream) {
  if (B == 0 || T == 0) return 0;
  const cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err = in_bf16
      ? launch_projection<__nv_bfloat16>(x, wih, bias, xproj, B * T, 4 * H, D, st)
      : launch_projection<float>(x, wih, bias, xproj, B * T, 4 * H, D, st);
  if (err != cudaSuccess) return err;
  return out_bf16
      ? launch_recurrence<__nv_bfloat16>(xproj, whh, lengths, out, B, T, H, reverse, st)
      : launch_recurrence<float>(xproj, whh, lengths, out, B, T, H, reverse, st);
}

// STFT log-mel frontend for Hopper (sm_90a), CUDA C++.
//
// Replaces: pytorch_asr_tpu/ops/stft_pallas.py::stft_log_mel (kernel body
// _stft_kernel, wrapper log_mel_pallas).  Python side: ops/stft_cuda.py.
//
// Computes, for audio (B, A) fp32 and T = (A - win) / hop + 1 frames
// (center=False), out[b, t, m] = log(max(sum_k P[b,t,k] * mel[k, m], floor))
// with P[b,t,k] = |sum_n audio[b, t*hop + n] * win[n] * e^{-2 pi i n k / n_fft}|^2,
// in natural frame order.  Masking by length and CMVN stay outside, as in
// log_mel_pallas.  The frame is zero-padded from win to n_fft samples, and
// the window is zero there, so only win samples per frame are read.
//
// Bound on this card: bytes.  A real FFT needs about 2.5 n_fft log2(n_fft)
// operations a frame (11.5 k at n_fft 512), power 3 per bin and the mel
// product 2 per nonzero of the triangular bank (about 1 k): some 14 kFLOP a
// frame against 4 * hop bytes of audio read and 4 * n_mels bytes written,
// so the 3.35 TB/s of memory bounds it, not the fp32 or fp64 rate.
//
// Design, first and simple: one block per (utterance, tile of TF frames).
// The block copies the tile's audio span once into shared memory and forms
// the overlapping frames there (no frame tensor in device memory).  Each
// frame's n_fft real samples are packed as n_fft/2 complex points (even
// samples real, odd imaginary), put in bit-reversed order, and transformed
// by an in-place radix-2 FFT in shared memory, one butterfly per thread per
// step, all TF frames at once; a last pass splits the even and odd spectra
// into the n_fft/2 + 1 bins of the real frame.  The FFT runs in fp64: the
// log of a band whose power is near log_floor is ill-conditioned (its power
// is a small remainder of large terms), and fp32 spectra lose 5e-4 (cuFFT)
// to 3e-3 (a direct DFT) there; fp64 keeps the output within fp32 rounding
// of the exact value, and the card's fp64 rate is ample for a kernel bound
// by bytes.  The
// power tile is kept in fp32 for the mel product, which sums only each
// band's nonzero bins (exact zeros elsewhere), then the log.
//
// TPU workarounds of the Pallas kernel dropped here: the bf16x3 split of
// the matrix products (the card has full-precision FMA), the phase-major
// frame order and its undo-permutation (shared memory takes any offset),
// the flattened 1024-aligned audio (a block reads its own span with bounds
// checks) and the semaphore double-buffering (other resident blocks hide
// the load latency).  The Pallas kernel's DFT as a product against a
// cos/sin basis, which suits the MXU, becomes an FFT.

#include <cuda_runtime.h>

namespace {

constexpr int TF = 16;        // frames per block
constexpr int THREADS = 512;

__global__ void __launch_bounds__(THREADS) stft_log_mel_kernel(
    const float* __restrict__ audio, const float* __restrict__ window,
    const double* __restrict__ twiddle, const float* __restrict__ mel,
    const int* __restrict__ band, float* __restrict__ out, int A, int T, int win,
    int hop, int log2_half, int n_mels, float log_floor) {
  extern __shared__ double smem[];
  const int half = 1 << log2_half;  // complex points per frame: n_fft / 2
  const int n_freq = half + 1;
  const int span = (TF - 1) * hop + win;
  double* zr = smem;                 // TF x half, real parts
  double* zi = zr + TF * half;       // TF x half, imaginary parts
  double* twr = zi + TF * half;      // half: cos(2 pi k / n_fft)
  double* twi = twr + half;          // half: -sin(2 pi k / n_fft)
  float* pw = (float*)(twi + half);  // TF x n_freq power spectrum
  float* seg = pw + TF * n_freq;     // the tile's audio span
  const int b = blockIdx.y;
  const int t0 = blockIdx.x * TF;
  const long long s0 = (long long)t0 * hop;
  const float* a = audio + (size_t)b * A;

  for (int i = threadIdx.x; i < span; i += THREADS) {
    const long long s = s0 + i;
    seg[i] = s < A ? a[s] : 0.f;
  }
  for (int i = threadIdx.x; i < 2 * half; i += THREADS) twr[i] = twiddle[i];
  __syncthreads();

  // z[n] = w[2n] x[2n] + i w[2n+1] x[2n+1], stored at bit-reversed n.
  for (int idx = threadIdx.x; idx < TF * half; idx += THREADS) {
    const int f = idx >> log2_half;
    const int n = idx & (half - 1);
    const float* fr = seg + f * hop;
    const int e = 2 * n, o = 2 * n + 1;
    const int r = (int)(__brev((unsigned)n) >> (32 - log2_half));
    zr[f * half + r] = e < win ? (double)window[e] * fr[e] : 0.0;
    zi[f * half + r] = o < win ? (double)window[o] * fr[o] : 0.0;
  }
  __syncthreads();

  // Radix-2 decimation in time: at span m, butterfly (i0, i0 + m) with
  // twiddle e^{-2 pi i pos / (2m)} = table[pos * half / m].
  for (int m = 1, step = half; m < half; m <<= 1, step >>= 1) {
    for (int j = threadIdx.x; j < TF * half / 2; j += THREADS) {
      const int f = j >> (log2_half - 1);
      const int q = j & (half / 2 - 1);
      const int pos = q & (m - 1);
      const int i0 = f * half + ((q - pos) << 1) + pos;
      const int i1 = i0 + m;
      const double wr = twr[pos * step], wi = twi[pos * step];
      const double br = zr[i1], bi = zi[i1];
      const double tr = br * wr - bi * wi, ti = br * wi + bi * wr;
      const double ar = zr[i0], ai = zi[i0];
      zr[i0] = ar + tr;
      zi[i0] = ai + ti;
      zr[i1] = ar - tr;
      zi[i1] = ai - ti;
    }
    __syncthreads();
  }

  // Split: E[k] = (Z[k] + conj Z[-k]) / 2 (even samples), O[k] =
  // (Z[k] - conj Z[-k]) / 2i (odd samples), X[k] = E[k] + e^{-2 pi i k / n_fft} O[k].
  for (int idx = threadIdx.x; idx < TF * n_freq; idx += THREADS) {
    const int f = idx / n_freq;
    const int k = idx - f * n_freq;
    const int k0 = f * half + (k & (half - 1));
    const int k1 = f * half + ((half - k) & (half - 1));
    const double ar = zr[k0], ai = zi[k0], br = zr[k1], bi = zi[k1];
    const double er = 0.5 * (ar + br), ei = 0.5 * (ai - bi);
    const double orr = 0.5 * (ai + bi), oi = 0.5 * (br - ar);
    const double cr = k < half ? twr[k] : -1.0, ci = k < half ? twi[k] : 0.0;
    const double xr = er + cr * orr - ci * oi;
    const double xi = ei + cr * oi + ci * orr;
    pw[idx] = (float)(xr * xr + xi * xi);
  }
  __syncthreads();

  for (int idx = threadIdx.x; idx < TF * n_mels; idx += THREADS) {
    const int f = idx / n_mels;
    const int m = idx - f * n_mels;
    const int t = t0 + f;
    if (t >= T) continue;
    const float* p = pw + f * n_freq;
    float acc = 0.f;
    for (int k = band[2 * m]; k < band[2 * m + 1]; ++k)
      acc = fmaf(p[k], mel[(size_t)k * n_mels + m], acc);
    out[((size_t)b * T + t) * n_mels + m] = logf(fmaxf(acc, log_floor));
  }
}

}  // namespace

// window: (win,) fp32; twiddle: (2, n_fft/2) fp64, cos then -sin of
// 2 pi k / n_fft; mel: (n_fft/2+1, n_mels) fp32; band: (n_mels, 2) int32,
// the [first, last + 1) nonzero bins of each mel band; out: (B, T, n_mels).
// n_fft = 2 << log2_half with log2_half >= 1.  Returns the launch's cudaError_t.
extern "C" int stft_log_mel_f32(const float* audio, const float* window,
                                const double* twiddle, const float* mel,
                                const int* band, float* out, int B, int A, int T,
                                int win, int hop, int log2_half, int n_mels,
                                float log_floor, void* stream) {
  if (B == 0 || T == 0) return 0;
  const int half = 1 << log2_half;
  const size_t smem = (size_t)(2 * TF * half + 2 * half) * sizeof(double) +
                      (size_t)(TF * (half + 1) + (TF - 1) * hop + win) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      stft_log_mel_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((T + TF - 1) / TF, B);
  stft_log_mel_kernel<<<grid, THREADS, smem, (cudaStream_t)stream>>>(
      audio, window, twiddle, mel, band, out, A, T, win, hop, log2_half, n_mels,
      log_floor);
  return cudaGetLastError();
}

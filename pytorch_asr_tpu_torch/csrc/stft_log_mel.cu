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
// Design: a warp a frame, no block-wide barrier after the set-up.  Each
// frame's n_fft real samples are packed as half = n_fft / 2 complex points
// (even samples real, odd imaginary); lane l holds the points n = l + 32 j,
// j < half / 32, in registers (8 at n_fft 512; below 32 points, as many
// lanes as points hold one each).  With half = lanes x P, n = l + lanes j
// and the bin k = k1 + P k2, the FFT is a pass of radix P inside each lane
// (radix 8 at n_fft 512: an 8-point DFT over the lane's registers j, whose
// inner twiddles W_P^e are constants: 1, -i and (+-1 - i) / sqrt 2), one
// twiddle W_half^{l k1} a register from the table, then the lanes-point
// DFT over l for each k1 as five radix-2 stages of decimation in frequency
// across lanes (fewer below 32 points): a lane takes its partner's value by
// __shfl_xor_sync (the lower lane keeps a + b, the upper (a - b) w: one fma
// with a sign, and a multiply by a twiddle that is 1 on the lower lane).
// Each lane's twiddles sit in shared memory as a row of 32, one per lane,
// so a warp reads them without bank conflicts.  The spectrum, bit-reversed
// in the registers, goes to the warp's buffer at its natural bins (a slot
// of padding every 16, so that the scattered writes hit distinct banks);
// the lanes then split it into the half + 1 bins of the real frame and
// their power, and each lane sums whole mel bands over the bank's nonzeros,
// staged once a block in shared memory as compressed rows.  A block of 4
// warps uses ~36 KB of shared memory at n_fft 512; the grid is sized so
// that every warp takes the same number of frames.  The FFT runs in fp64:
// the log of a band whose power is near log_floor is ill-conditioned (its
// power is a small remainder of large terms), and fp32 spectra lose 5e-4
// (cuFFT) to 3e-3 (a direct DFT) there; fp64 keeps the output within fp32
// rounding of the exact value.  The power is kept in fp32 for the mel
// product, which sums each band's bins in order with fmaf, then the log.
//
// trace, if not null: (trace_rows, 8) int64 where lane 0 of warp 0 of block
// 0 writes, for each of its frames, the global timer (ns) as it starts, the
// SM clock (cycles) then, after issuing the audio loads, after the pack
// (the loads' wait included), after the FFT, after the split and power,
// after the mel product and log, and the global timer at the end.
//
// The DFT form (stft_log_mel_dft_f32), for an n_fft that has no FFT plan
// here (not a power of two in [4, 1024], odd ones included): still a warp
// a frame.  The warp stages its windowed frame in shared memory in fp64;
// lane l sums the n_fft / 2 + 1 real-frame bins k = l + 32 j directly,
// DFT_BINS at a time, over the frame's win samples: X[k] = sum_n x[n]
// (cos, -sin)(2 pi (n k mod n_fft) / n_fft), the index advanced by k and
// wrapped each sample, the (cos, -sin) pairs read from a table of n_fft
// (ops/stft_cuda.py::dft_table; in shared memory where it fits, else read
// from device memory through L1), fp64 as the FFT is (the log near
// log_floor is ill-conditioned).  Then the same power, mel product and log.
// About 2 n_freq win fp64 multiply-adds a frame: bound by the table's
// shared-memory reads, milliseconds at n_fft 2048 (PERF.md); a mixed-radix
// plan would be faster.  The block has 4 warps where its shared memory
// fits, else 2 or 1.
//
// TPU workarounds of the Pallas kernel dropped here: the bf16x3 split of
// the matrix products (the card has full-precision FMA), the phase-major
// frame order and its undo-permutation, the flattened 1024-aligned audio
// and the semaphore double-buffering (other resident warps hide the load
// latency).  The Pallas kernel's DFT as a product against a cos/sin basis,
// which suits the MXU, becomes an FFT.

#include <cuda_runtime.h>

namespace {

constexpr int WARPS = 4;  // frames in flight a block, one a warp
constexpr int THREADS = 32 * WARPS;

__device__ __forceinline__ long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return (long long)t;
}

// Slot of bin k in a warp's spectrum buffer: one slot of padding every 16.
__device__ __forceinline__ int zslot(int k) { return k + (k >> 4); }

// The FFT's shape for half = 2^LOG2_HALF complex points: lanes holding
// points, points a lane, rows of per-lane stage twiddles, buffer slots.
template <int LOG2_HALF>
struct Plan {
  static constexpr int HALF = 1 << LOG2_HALF;
  static constexpr int LOG2_LANES = LOG2_HALF < 5 ? LOG2_HALF : 5;
  static constexpr int LANES = 1 << LOG2_LANES;
  static constexpr int P = HALF / LANES;
  static constexpr int ROWS = P - 1 + LOG2_LANES;  // a row a register past the first, a lane stage
  static constexpr int TW = ROWS * 32 + HALF;      // and the split's HALF twiddles
  static constexpr int ZN = HALF + HALF / 16;
};

template <int LOG2_HALF>
size_t smem_bytes(int win, int n_mels, int nnz) {
  using Q = Plan<LOG2_HALF>;
  return sizeof(double) * (2 * (size_t)Q::TW + 2 * (size_t)WARPS * Q::ZN) +
         sizeof(float) * ((size_t)WARPS * (Q::HALF + 1) + win + nnz) +
         sizeof(int) * 2 * ((size_t)n_mels + 1);
}

// cos(2 pi m / 16) and sin(2 pi m / 16), m < 8: the inner twiddles of an
// in-lane pass of up to 16 points, W_P^e = cos16(m) - i sin16(m) with
// m = 16 e / P.  Called with constant m, they fold into the code.
__device__ __forceinline__ constexpr double cos16(int m) {
  return m == 0 ? 1.0 : m == 1 ? 0.92387953251128675613 : m == 2 ? 0.70710678118654752440
       : m == 3 ? 0.38268343236508977173 : m == 4 ? 0.0 : m == 5 ? -0.38268343236508977173
       : m == 6 ? -0.70710678118654752440 : -0.92387953251128675613;
}
__device__ __forceinline__ constexpr double sin16(int m) { return cos16(m < 4 ? 4 - m : m - 4); }

// twiddle (2, TW) fp64, real then imaginary parts: row r < ROWS of 32 at
// [32 r, 32 r + 32) gives lane l a twiddle (ops/stft_cuda.py::twiddles):
// rows j - 1 < P - 1 the W_half^{l bitrev(j)} of register j, then one a
// lane stage; then W_{n_fft}^k for k < half.  mel_w (nnz) fp32: each band's
// weights over its bins; band (n_mels + 1, 2) int32: a band's first bin and
// its offset into mel_w, and [0, nnz] last.
template <int LOG2_HALF>
__global__ void __launch_bounds__(THREADS) stft_log_mel_kernel(
    const float* __restrict__ audio, const float* __restrict__ window,
    const double* __restrict__ twiddle, const float* __restrict__ mel_w,
    const int* __restrict__ band, float* __restrict__ out, long long* trace, int trace_rows,
    int B, int A, int T, int win, int hop, int n_mels, int nnz, float log_floor) {
  using Q = Plan<LOG2_HALF>;
  constexpr int HALF = Q::HALF, LANES = Q::LANES, P = Q::P, LOG2_LANES = Q::LOG2_LANES;
  extern __shared__ __align__(16) double smem[];
  double* tw_re = smem;                                            // (TW)
  double* tw_im = tw_re + Q::TW;                                   // (TW)
  double* zr = tw_im + Q::TW + (threadIdx.x / 32) * Q::ZN;         // the warp's spectrum
  double* zi = tw_im + Q::TW + (WARPS + threadIdx.x / 32) * Q::ZN;
  float* pw_all = reinterpret_cast<float*>(tw_im + Q::TW + 2 * WARPS * Q::ZN);
  float* pw = pw_all + (threadIdx.x / 32) * (HALF + 1);            // the warp's power bins
  float* win_s = pw_all + WARPS * (HALF + 1);                      // (win)
  float* melw_s = win_s + win;                                     // (nnz)
  int* band_s = reinterpret_cast<int*>(melw_s + nnz);              // (n_mels + 1, 2)
  for (int i = threadIdx.x; i < Q::TW; i += THREADS) {
    tw_re[i] = twiddle[i];
    tw_im[i] = twiddle[Q::TW + i];
  }
  for (int i = threadIdx.x; i < win; i += THREADS) win_s[i] = window[i];
  for (int i = threadIdx.x; i < nnz; i += THREADS) melw_s[i] = mel_w[i];
  for (int i = threadIdx.x; i < 2 * (n_mels + 1); i += THREADS) band_s[i] = band[i];
  __syncthreads();

  const int lane = threadIdx.x % 32;
  const int ll = lane & (LANES - 1);  // below 32 points, lanes past them repeat the first
  long long* tr = blockIdx.x == 0 && threadIdx.x == 0 ? trace : nullptr;
  int row = 0;
  for (int f = blockIdx.x * WARPS + threadIdx.x / 32; f < B * T; f += gridDim.x * WARPS, ++row) {
    long long* rec = tr && row < trace_rows ? tr + 8 * row : nullptr;
    if (rec) {
      rec[0] = global_ns();
      rec[1] = clock64();
    }
    const float* fr = audio + (size_t)(f / T) * A + (size_t)(f % T) * hop;
    float se[P], so[P];
#pragma unroll
    for (int j = 0; j < P; ++j) {
      const int e = 2 * (ll + LANES * j);
      se[j] = e < win ? __ldg(fr + e) : 0.f;
      so[j] = e + 1 < win ? __ldg(fr + e + 1) : 0.f;
    }
    if (rec) rec[2] = clock64();
    // z[n] = w[2n] x[2n] + i w[2n+1] x[2n+1] for n = ll + LANES j.
    double xr[P], xi[P];
#pragma unroll
    for (int j = 0; j < P; ++j) {
      const int e = 2 * (ll + LANES * j);
      xr[j] = e < win ? (double)win_s[e] * se[j] : 0.0;
      xi[j] = e + 1 < win ? (double)win_s[e + 1] * so[j] : 0.0;
    }
    if (rec) rec[3] = clock64();

    // The in-lane pass: a P-point DFT over j by radix-2 decimation in
    // frequency with the constant twiddles W_{2h}^{j mod h} (register j then
    // holds k1 = bitrev(j)), and W_half^{l k1} from row j - 1.
#pragma unroll
    for (int h = P / 2; h >= 1; h /= 2) {
#pragma unroll
      for (int j = 0; j < P; ++j) {
        if (j & h) continue;
        const int m = 8 * (j & (h - 1)) / h;  // W_{2h}^{j mod h} = W_16^m
        const double ar = xr[j], ai = xi[j], br = xr[j + h], bi = xi[j + h];
        xr[j] = ar + br;
        xi[j] = ai + bi;
        const double dr = ar - br, di = ai - bi;
        if (m == 0) {
          xr[j + h] = dr;
          xi[j + h] = di;
        } else if (m == 4) {  // -i
          xr[j + h] = di;
          xi[j + h] = -dr;
        } else {
          xr[j + h] = dr * cos16(m) + di * sin16(m);
          xi[j + h] = di * cos16(m) - dr * sin16(m);
        }
      }
    }
#pragma unroll
    for (int j = 1; j < P; ++j) {
      const int r = (j - 1) * 32 + lane;
      const double wr = tw_re[r], wi = tw_im[r], ar = xr[j], ai = xi[j];
      xr[j] = ar * wr - ai * wi;
      xi[j] = ar * wi + ai * wr;
    }
    // Span h < LANES: the partner is lane l ^ h.  The lower lane keeps
    // a + b, the upper (a - b) W_{2h}^{l mod h}; its row holds 1 for the
    // lower lanes.
#pragma unroll
    for (int s = LOG2_LANES - 1; s >= 0; --s) {
      const int h = 1 << s;
      const double sign = (ll & h) ? -1.0 : 1.0;
      const int r = (P - 1 + LOG2_LANES - 1 - s) * 32 + lane;
      const double wr = tw_re[r], wi = tw_im[r];
#pragma unroll
      for (int j = 0; j < P; ++j) {
        const double tr_ = fma(sign, xr[j], __shfl_xor_sync(0xffffffffu, xr[j], h));
        const double ti = fma(sign, xi[j], __shfl_xor_sync(0xffffffffu, xi[j], h));
        xr[j] = tr_ * wr - ti * wi;
        xi[j] = tr_ * wi + ti * wr;
      }
    }
    // Point n holds bin bitrev(n): store it at its natural bin.
#pragma unroll
    for (int j = 0; j < P; ++j) {
      const int k = zslot((int)(__brev((unsigned)(ll + LANES * j)) >> (32 - LOG2_HALF)));
      zr[k] = xr[j];
      zi[k] = xi[j];
    }
    __syncwarp();
    if (rec) rec[4] = clock64();

    // Split: E[k] = (Z[k] + conj Z[-k]) / 2 (even samples), O[k] =
    // (Z[k] - conj Z[-k]) / 2i (odd samples), X[k] = E[k] + e^{-2 pi i k / n_fft} O[k].
    for (int k = lane; k <= HALF; k += 32) {
      const int k0 = zslot(k & (HALF - 1)), k1 = zslot((HALF - k) & (HALF - 1));
      const double ar = zr[k0], ai = zi[k0], br = zr[k1], bi = zi[k1];
      const double er = 0.5 * (ar + br), ei = 0.5 * (ai - bi);
      const double orr = 0.5 * (ai + bi), oi = 0.5 * (br - ar);
      const double cr = k < HALF ? tw_re[Q::ROWS * 32 + k] : -1.0;
      const double ci = k < HALF ? tw_im[Q::ROWS * 32 + k] : 0.0;
      const double yr = er + cr * orr - ci * oi;
      const double yi = ei + cr * oi + ci * orr;
      pw[k] = (float)(yr * yr + yi * yi);
    }
    __syncwarp();
    if (rec) rec[5] = clock64();

    // A lane a mel band: its bins in order, from its first nonzero.
    for (int m = lane; m < n_mels; m += 32) {
      const int lo = band_s[2 * m], off = band_s[2 * m + 1], n = band_s[2 * m + 3] - off;
      float acc = 0.f;
#pragma unroll 4
      for (int i = 0; i < n; ++i) acc = fmaf(pw[lo + i], melw_s[off + i], acc);
      out[(size_t)f * n_mels + m] = logf(fmaxf(acc, log_floor));
    }
    __syncwarp();  // the next frame overwrites zr, zi and pw
    if (rec) {
      rec[6] = clock64();
      rec[7] = global_ns();
    }
  }
}

template <int LOG2_HALF>
cudaError_t launch(const float* audio, const float* window, const double* twiddle,
                   const float* mel_w, const int* band, float* out, long long* trace,
                   int trace_rows, int B, int A, int T, int win, int hop, int n_mels, int nnz,
                   float log_floor, cudaStream_t st) {
  auto kernel = stft_log_mel_kernel<LOG2_HALF>;
  const size_t smem = smem_bytes<LOG2_HALF>(win, n_mels, nnz);
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, THREADS, smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  // As many rounds of frames as the resident warps need, and the frames
  // spread evenly over the warps of those rounds: no tail wave.
  const long long frames = (long long)B * T, slots = (long long)sms * per_sm * WARPS;
  const long long rounds = (frames + slots - 1) / slots;
  const long long warps = (frames + rounds - 1) / rounds;
  kernel<<<(unsigned)((warps + WARPS - 1) / WARPS), THREADS, smem, st>>>(
      audio, window, twiddle, mel_w, band, out, trace, trace_rows, B, A, T, win, hop, n_mels, nnz,
      log_floor);
  return cudaGetLastError();
}

constexpr int DFT_BINS = 4;  // bins a lane of the DFT form sums at once

// The DFT form: dft (n_fft) the (cos, -sin)(2 pi m / n_fft) pairs; window,
// mel_w, band, out and trace as stft_log_mel_kernel's (the trace's split
// phase is empty: the power is written as each bin is summed).
__global__ void __launch_bounds__(THREADS) stft_log_mel_dft_kernel(
    const float* __restrict__ audio, const float* __restrict__ window,
    const double2* __restrict__ dft, const float* __restrict__ mel_w,
    const int* __restrict__ band, float* __restrict__ out, long long* trace, int trace_rows,
    int B, int A, int T, int win, int hop, int n_fft, int n_mels, int nnz, float log_floor,
    bool dft_in_smem) {
  extern __shared__ __align__(16) double smem[];
  const int warps = blockDim.x / 32, lane = threadIdx.x % 32, n_freq = n_fft / 2 + 1;
  double2* dft_s = reinterpret_cast<double2*>(smem);                       // (n_fft), if held
  double* frames = smem + (dft_in_smem ? 2 * (size_t)n_fft : 0);           // (warps, win)
  float* pw_all = reinterpret_cast<float*>(frames + (size_t)warps * win);  // (warps, n_freq)
  float* win_s = pw_all + (size_t)warps * n_freq;                          // (win)
  float* melw_s = win_s + win;                                             // (nnz)
  int* band_s = reinterpret_cast<int*>(melw_s + nnz);                      // (n_mels + 1, 2)
  if (dft_in_smem)
    for (int i = threadIdx.x; i < n_fft; i += blockDim.x) dft_s[i] = dft[i];
  for (int i = threadIdx.x; i < win; i += blockDim.x) win_s[i] = window[i];
  for (int i = threadIdx.x; i < nnz; i += blockDim.x) melw_s[i] = mel_w[i];
  for (int i = threadIdx.x; i < 2 * (n_mels + 1); i += blockDim.x) band_s[i] = band[i];
  __syncthreads();

  const double2* tw = dft_in_smem ? dft_s : dft;
  double* x = frames + (size_t)(threadIdx.x / 32) * win;
  float* pw = pw_all + (size_t)(threadIdx.x / 32) * n_freq;
  long long* tr = blockIdx.x == 0 && threadIdx.x == 0 ? trace : nullptr;
  int row = 0;
  for (int f = blockIdx.x * warps + threadIdx.x / 32; f < B * T; f += gridDim.x * warps, ++row) {
    long long* rec = tr && row < trace_rows ? tr + 8 * row : nullptr;
    if (rec) {
      rec[0] = global_ns();
      rec[1] = clock64();
    }
    const float* fr = audio + (size_t)(f / T) * A + (size_t)(f % T) * hop;
    for (int n = lane; n < win; n += 32) x[n] = (double)win_s[n] * (double)__ldg(fr + n);
    if (rec) rec[2] = clock64();
    __syncwarp();
    if (rec) rec[3] = clock64();
    for (int k0 = lane; k0 < n_freq; k0 += 32 * DFT_BINS) {
      double re[DFT_BINS], im[DFT_BINS];
      int k[DFT_BINS], idx[DFT_BINS];
#pragma unroll
      for (int j = 0; j < DFT_BINS; ++j) {
        k[j] = k0 + 32 * j < n_freq ? k0 + 32 * j : 0;
        re[j] = im[j] = 0.0;
        idx[j] = 0;
      }
      for (int n = 0; n < win; ++n) {
        const double xn = x[n];
#pragma unroll
        for (int j = 0; j < DFT_BINS; ++j) {
          const double2 c = tw[idx[j]];
          re[j] = fma(xn, c.x, re[j]);
          im[j] = fma(xn, c.y, im[j]);
          idx[j] += k[j];
          if (idx[j] >= n_fft) idx[j] -= n_fft;
        }
      }
#pragma unroll
      for (int j = 0; j < DFT_BINS; ++j)
        if (k0 + 32 * j < n_freq) pw[k0 + 32 * j] = (float)(re[j] * re[j] + im[j] * im[j]);
    }
    __syncwarp();
    if (rec) rec[4] = rec[5] = clock64();

    // A lane a mel band: its bins in order, from its first nonzero.
    for (int m = lane; m < n_mels; m += 32) {
      const int lo = band_s[2 * m], off = band_s[2 * m + 1], n = band_s[2 * m + 3] - off;
      float acc = 0.f;
#pragma unroll 4
      for (int i = 0; i < n; ++i) acc = fmaf(pw[lo + i], melw_s[off + i], acc);
      out[(size_t)f * n_mels + m] = logf(fmaxf(acc, log_floor));
    }
    __syncwarp();  // the next frame overwrites x and pw
    if (rec) {
      rec[6] = clock64();
      rec[7] = global_ns();
    }
  }
}

size_t dft_smem_bytes(int warps, bool dft_in_smem, int n_fft, int win, int n_mels, int nnz) {
  return sizeof(double) * ((dft_in_smem ? 2 * (size_t)n_fft : 0) + (size_t)warps * win) +
         sizeof(float) * ((size_t)warps * (n_fft / 2 + 1) + win + nnz) +
         sizeof(int) * 2 * ((size_t)n_mels + 1);
}

}  // namespace

// window: (win,) fp32; twiddle, mel_w, band: see stft_log_mel_kernel
// (ops/stft_cuda.py::constants); out: (B, T, n_mels); trace: null or
// (trace_rows, 8) int64.  n_fft = 2 << log2_half, 1 <= log2_half <= 9.
// Returns the launch's cudaError_t.
extern "C" int stft_log_mel_f32(const float* audio, const float* window, const double* twiddle,
                                const float* mel_w, const int* band, float* out,
                                long long* trace, int trace_rows, int B, int A, int T, int win,
                                int hop, int log2_half, int n_mels, int nnz, float log_floor,
                                void* stream) {
  if (B == 0 || T == 0) return 0;
  const cudaStream_t st = (cudaStream_t)stream;
#define STFT_CASE(L)                                                                           \
  case L:                                                                                      \
    return launch<L>(audio, window, twiddle, mel_w, band, out, trace, trace_rows, B, A, T, win, \
                     hop, n_mels, nnz, log_floor, st);
  switch (log2_half) {
    STFT_CASE(1)
    STFT_CASE(2)
    STFT_CASE(3)
    STFT_CASE(4)
    STFT_CASE(5)
    STFT_CASE(6)
    STFT_CASE(7)
    STFT_CASE(8)
    STFT_CASE(9)
    default:
      return cudaErrorInvalidValue;
  }
#undef STFT_CASE
}

// The DFT form, any n_fft >= win: dft (n_fft, 2) fp64 (ops/stft_cuda.py::
// dft_table); the other arguments as stft_log_mel_f32's.  The block takes 4
// warps with the table in shared memory where that fits, else 2 or 1, else
// 4, 2 or 1 with the table read from device memory.
extern "C" int stft_log_mel_dft_f32(const float* audio, const float* window, const double* dft,
                                    const float* mel_w, const int* band, float* out,
                                    long long* trace, int trace_rows, int B, int A, int T,
                                    int win, int hop, int n_fft, int n_mels, int nnz,
                                    float log_floor, void* stream) {
  if (B == 0 || T == 0) return 0;
  int dev = 0, sms = 0, max_smem = 0, per_sm = 0;
  cudaError_t err;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return err;
  if ((err = cudaDeviceGetAttribute(&max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev)) !=
      cudaSuccess)
    return err;
  int warps = 0;
  bool held = false;
  for (int pass = 0; pass < 2 && warps == 0; ++pass)
    for (int w = WARPS; w >= 1 && warps == 0; w /= 2)
      if (dft_smem_bytes(w, pass == 0, n_fft, win, n_mels, nnz) <= (size_t)max_smem) {
        warps = w;
        held = pass == 0;
      }
  if (warps == 0) return cudaErrorInvalidValue;
  const size_t smem = dft_smem_bytes(warps, held, n_fft, win, n_mels, nnz);
  auto kernel = stft_log_mel_dft_kernel;
  if ((err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  (int)smem)) != cudaSuccess)
    return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, 32 * warps, smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const long long frames = (long long)B * T, slots = (long long)sms * per_sm * warps;
  const long long rounds = (frames + slots - 1) / slots;
  const long long busy = (frames + rounds - 1) / rounds;
  kernel<<<(unsigned)((busy + warps - 1) / warps), 32 * warps, smem, (cudaStream_t)stream>>>(
      audio, window, reinterpret_cast<const double2*>(dft), mel_w, band, out, trace, trace_rows,
      B, A, T, win, hop, n_fft, n_mels, nnz, log_floor, held);
  return cudaGetLastError();
}

// The co-resident grid's barrier, launcher and copy helpers, shared by the
// kernels that run one persistent CTA an SM under cudaLaunchCooperativeKernel:
// lstm_seq.cu (lstm_grid_kernel, lstm_bwd_grid_kernel) and prefix_beam.cu
// (prefix_beam_rnn_grid_kernel).  ops/build.py hashes this header into every
// library's name, so an edit here rebuilds both.

#pragma once

#include <cuda_runtime.h>

namespace {

// A barrier of the grid's co-resident CTAs on a counter that only grows:
// their n-th barrier waits until it reaches n times the CTAs of the grid
// (gridDim.x gridDim.y: both directions of K11's dual grid).  Thread 0 adds
// to it with release semantics after the CTA's __syncthreads and spins with
// acquire loads (gpu scope), so each CTA's writes before the barrier are
// visible to every CTA after it (readers load with cp.async.cg or __ldcg,
// from L2).  Under the cooperative launch only; a wait of more than
// kBarrierTimeoutNs traps, so a fault ends the launch with an error instead
// of hanging the card.
constexpr unsigned long long kBarrierTimeoutNs = 20000000000ull;

__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

__device__ __forceinline__ unsigned load_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

// The barrier: every thread of the CTA calls it after a __syncthreads.
__device__ __forceinline__ void grid_wait(unsigned* count, unsigned target) {
  if (threadIdx.x == 0) {
    asm volatile("red.release.gpu.global.add.u32 [%0], 1;" ::"l"(count) : "memory");
    const unsigned long long t0 = global_ns();
    while (load_acquire(count) < target) {
      if (global_ns() - t0 > kBarrierTimeoutNs) __trap();
    }
  }
  __syncthreads();
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// Closes the thread's group of cp.async copies issued since the last one.
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

// Waits until at most N of the thread's newest groups are still in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// A cooperative launch; one whose grid cannot be resident at once fails
// before it runs, and its error is cleared from the runtime's last-error
// state, so that only the op that made the launch reports it.
cudaError_t launch_cooperative(const void* kernel, dim3 grid, dim3 block, void** args,
                               size_t smem, cudaStream_t st) {
  const cudaError_t err = cudaLaunchCooperativeKernel(kernel, grid, block, args, smem, st);
  if (err != cudaSuccess) cudaGetLastError();
  return err;
}

}  // namespace

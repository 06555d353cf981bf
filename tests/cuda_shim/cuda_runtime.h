// A stand-in for <cuda_runtime.h> that lets g++ compile the device code of
// radiosonde_auto_rx_tpu_torch/csrc/fft_smem.cuh and fsk_block.cuh for the
// CPU: one block at a time, every CUDA thread a host thread,
// __syncthreads() a barrier, the round-to-nearest intrinsics plain float
// arithmetic (x86-64 without -mfma contracts nothing).  Used by
// fft_rows_host.cc (tests/test_torch_fft.py) and fsk_scan_host.cc
// (tests/test_torch_fsk.py).
#pragma once
#include <pthread.h>

#include <cmath>
#include <cstddef>

#define __device__
#define __host__
#define __global__
#define __forceinline__ inline
#define __restrict__
#define __shared__
#define __launch_bounds__(x)

struct ShimIdx {
  int x;
};
extern thread_local ShimIdx threadIdx, blockIdx, gridDim;
extern pthread_barrier_t shim_barrier;
inline void __syncthreads() { pthread_barrier_wait(&shim_barrier); }
inline float __fadd_rn(float a, float b) { return a + b; }
inline float __fsub_rn(float a, float b) { return a - b; }
inline float __fmul_rn(float a, float b) { return a * b; }
inline float __fdiv_rn(float a, float b) { return a / b; }

typedef int cudaError_t;
typedef void* cudaStream_t;
enum {
  cudaSuccess = 0,
  cudaErrorInvalidValue = 1,
  cudaErrorInvalidDevice = 101,
  cudaErrorLaunchOutOfResources = 701,
  cudaFuncAttributeMaxDynamicSharedMemorySize = 8,
  cudaDevAttrMultiProcessorCount = 16
};
template <class K>
cudaError_t cudaFuncSetAttribute(K, int, int) {
  return cudaSuccess;
}
template <class K>
cudaError_t cudaOccupancyMaxActiveBlocksPerMultiprocessor(int* n, K, int,
                                                          size_t) {
  *n = 1;
  return cudaSuccess;
}
inline cudaError_t cudaDeviceGetAttribute(int* v, int, int) {
  *v = 2;
  return cudaSuccess;
}

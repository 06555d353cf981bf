// K3: windowed complex FFT with re/im planes out,
//   X[k] = sum_n w[n] x[n] e^{-2 pi i n k / N},   k = 0 .. N-1.
//
// Replaces radiosonde_auto_rx_tpu/ops/pallas_fft.py::_fft_kernel (the
// pallas_call in _direct(abs2=False), reached from fft for N <= 1024, and
// in _cmatmul_pallas, the two DFT stages of _four_step).  Both uses are a
// batched DFT of power-of-two length: the four-step stages multiply by the
// [N1, N1] and [N2, N2] DFT matrices with a ones window, so the wrapper
// (ops/fft.py) calls this kernel for them with no window.  Here one launch
// covers N = 2 .. 4096; the wrapper factors only above that.
//
// What bounds it on an H100: bytes.  The function needs its 16 B N bytes of
// I/O (N = 1024, B = 512: 8.4 MB, 2.5 us at 3.35 TB/s) against
// 5 B N log2 N operations (26 MFLOP, under 1 us at 67 TFLOP/s).  The
// kernel this one replaces did the DFT directly, 8 B N^2 operations out of
// shared memory, and took 0.53 ms at that shape.
//
// Design: the row FFT of fft_smem.cuh (Stockham radix 8 in registers,
// in-place exchanges through swizzled shared memory, table twiddles; one
// row per block of N/8 threads from N = 1024 up, several rows per
// 128-thread block below; a grid no larger than the card holds, each block
// walking over rows).  Rows are addressed by a row stride and a re/im
// plane stride, so a [B, 2, N] view is read in place; the optional window
// is multiplied in on the way into registers, and the bins leave the
// registers for the two output planes in natural order.  Plain float32, no
// tensor cores.
//
// nvcc 12.8 -Xptxas -v, sm_90a, registers a thread: N = 4096 64 (capped by
// MIN_BLOCKS: 2 blocks of 512 threads an SM), N = 2048 75 (3 blocks of
// 256), N = 1024 71, N = 512 64, N = 256 56, below that 28-48.  No spills,
// no stack frame.
#include "fft_smem.cuh"

namespace {

using namespace rsx;

template <int LOG2N>
__global__ void
__launch_bounds__(FftPlan<LOG2N>::THREADS, FftPlan<LOG2N>::MIN_BLOCKS)
fft_planes_kernel(const float* __restrict__ x, long long s_row,
                  long long s_plane, int rows,
                  const float* __restrict__ win,
                  const float* __restrict__ tw, float* __restrict__ out) {
  constexpr int N = FftPlan<LOG2N>::N;
  fft_rows<LOG2N>(
      rows, s_plane, win, tw,
      [=](long long row) { return x + row * s_row; },
      [=](long long row, int bin, cpx X) {
        float* o = out + row * 2 * N + bin;
        o[0] = X.re;
        o[N] = X.im;
      });
}

template <int LOG2N>
cudaError_t launch(const float* x, long long s_row, long long s_plane,
                   int rows, const float* win, const float* tw, float* out,
                   int device, cudaStream_t stream) {
  using P = FftPlan<LOG2N>;
  static int cache[kMaxDevices];
  int cap = 0;
  const cudaError_t err = grid_cap(fft_planes_kernel<LOG2N>, P::THREADS,
                                   P::SMEM_BYTES, device, cache, &cap);
  if (err != cudaSuccess) return err;
  const int blocks = (rows + P::RPB - 1) / P::RPB;
  fft_planes_kernel<LOG2N>
      <<<blocks < cap ? blocks : cap, P::THREADS, P::SMEM_BYTES, stream>>>(
          x, s_row, s_plane, rows, win, tw, out);
  return cudaGetLastError();
}

}  // namespace

// Row r reads re at x + r*s_row and im s_plane further (element strides;
// the last axis is contiguous, no alignment asked).  win [n] f32 or NULL
// (no window); tw [2, n] (cos, sin of 2 pi m / n) f32 on the device; out
// [rows, 2, n] f32 contiguous.  n: a power of two, 2..4096.
extern "C" int rsx_fft_planes(const float* x, long long s_row,
                              long long s_plane, int rows, const float* win,
                              const float* tw, float* out, int n, int device,
                              void* stream) {
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
#define RSX_CASE(L) \
  case 1 << L:      \
    return launch<L>(x, s_row, s_plane, rows, win, tw, out, device, st);
  static_assert(kMaxLog2N == 12, "one case for each log2 N, 1 .. 12");
  switch (n) {
    RSX_CASE(1) RSX_CASE(2) RSX_CASE(3) RSX_CASE(4) RSX_CASE(5) RSX_CASE(6)
    RSX_CASE(7) RSX_CASE(8) RSX_CASE(9) RSX_CASE(10) RSX_CASE(11)
    RSX_CASE(12)
    default:
      return cudaErrorInvalidValue;
  }
#undef RSX_CASE
}

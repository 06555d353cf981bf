// K2: fused windowed FFT power, p[k] = |sum_n w[n] x[n] e^{-2 pi i n k'/N}|^2
// with k' = (k + N/2) mod N when the output is fftshifted.
//
// Replaces radiosonde_auto_rx_tpu/ops/pallas_fft.py::_abs2_kernel (the
// pallas_call in _direct(abs2=True), reached from fft_abs2 and the Welch
// PSD, detect/psd.py::_welch).  The Pallas kernel covers N <= 1024 and
// the JAX package falls back to an XLA matmul above; the station's PSD
// runs N = 2048, which this kernel covers directly (N = 2 .. 4096).
//
// What bounds it on an H100: bytes.  A row is 8 N bytes in and 4 N out
// (N = 2048, 292 rows: 7.2 MB, 2.1 us at 3.35 TB/s) against
// 5 N log2 N + 5 N operations (34 MFLOP, 0.5 us at 67 TFLOP/s).  The
// kernel this one replaces did the DFT directly, 8 N^2 operations a row
// out of shared memory, and took 1.24 ms for those 292 rows.
//
// Design: the row FFT of fft_smem.cuh (Stockham radix 8 in registers,
// in-place exchanges through swizzled shared memory, table twiddles), one
// row per block of N/8 threads from N = 1024 up and several rows per
// 128-thread block below, a grid no larger than the card holds, each block
// walking over rows.  Around it, fused: rows are addressed through
// two-level strides (outer, segment) plus a re/im plane stride, so the
// sparse Welch view [C, 2, nseg, hop][..., :nfft] and the overlapping
// tilings (rows that start at any float) are read in place with no copy;
// the window is multiplied in on the way from device memory into
// registers; re^2 + im^2 and the shift happen in registers, and only
// [rows, N] powers are written.  The complex spectrum never reaches
// device memory.  Plain float32, no tensor cores.
//
// nvcc 12.8 -Xptxas -v, sm_90a, registers a thread: N = 2048 80 (3 blocks
// of 256 threads an SM by registers; 7 by shared memory), N = 4096 63
// (capped by MIN_BLOCKS: 2 blocks of 512), N = 1024 72, N = 128 .. 512 64,
// below that 24-48.  No spills, no stack frame.
#include "fft_smem.cuh"

namespace {

using namespace rsx;

template <int LOG2N>
__global__ void
__launch_bounds__(FftPlan<LOG2N>::THREADS, FftPlan<LOG2N>::MIN_BLOCKS)
fft_abs2_kernel(const float* __restrict__ x, long long s_outer,
                long long s_seg, long long s_plane, int nseg, int rows,
                const float* __restrict__ win, const float* __restrict__ tw,
                float* __restrict__ out, int shift) {
  constexpr int N = FftPlan<LOG2N>::N;
  const int rot = shift ? N / 2 : 0;
  fft_rows<LOG2N>(
      rows, s_plane, win, tw,
      [=](long long row) {
        const long long outer = row / nseg;
        return x + outer * s_outer + (row - outer * nseg) * s_seg;
      },
      [=](long long row, int bin, cpx X) {
        out[row * N + ((bin + rot) & (N - 1))] = X.re * X.re + X.im * X.im;
      });
}

template <int LOG2N>
cudaError_t launch(const float* x, long long s_outer, long long s_seg,
                   long long s_plane, int nseg, int rows, const float* win,
                   const float* tw, float* out, int shift, int device,
                   cudaStream_t stream) {
  using P = FftPlan<LOG2N>;
  static int cache[kMaxDevices];
  int cap = 0;
  const cudaError_t err = grid_cap(fft_abs2_kernel<LOG2N>, P::THREADS,
                                   P::SMEM_BYTES, device, cache, &cap);
  if (err != cudaSuccess) return err;
  const int blocks = (rows + P::RPB - 1) / P::RPB;
  fft_abs2_kernel<LOG2N>
      <<<blocks < cap ? blocks : cap, P::THREADS, P::SMEM_BYTES, stream>>>(
          x, s_outer, s_seg, s_plane, nseg, rows, win, tw, out, shift);
  return cudaGetLastError();
}

}  // namespace

// Row r = outer * nseg + seg reads re at x + outer*s_outer + seg*s_seg
// and im s_plane further (element strides; the last axis is contiguous,
// no alignment asked).  win [n] and tw [2, n] (cos, sin of 2 pi m / n) f32
// on the device; out [rows, n] f32 contiguous.  n: a power of two, 2..4096.
extern "C" int rsx_fft_abs2(const float* x, long long s_outer,
                            long long s_seg, long long s_plane, int nseg,
                            int rows, const float* win, const float* tw,
                            float* out, int n, int shift, int device,
                            void* stream) {
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
#define RSX_CASE(L)                                                        \
  case 1 << L:                                                             \
    return launch<L>(x, s_outer, s_seg, s_plane, nseg, rows, win, tw, out, \
                     shift, device, st);
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

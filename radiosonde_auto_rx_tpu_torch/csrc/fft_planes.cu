// K3: windowed complex DFT with re/im planes out,
//   X[k] = sum_n w[n] x[n] e^{-2 pi i n k / N},   k = 0 .. N-1.
//
// Replaces radiosonde_auto_rx_tpu/ops/pallas_fft.py::_fft_kernel (the
// pallas_call in _direct(abs2=False), reached from fft for N <= 1024, and
// in _cmatmul_pallas, the two DFT stages of _four_step).  Both uses are a
// batched DFT of power-of-two length: the four-step stages multiply by the
// [N1, N1] and [N2, N2] DFT matrices with a ones window, so the wrapper
// (ops/fft.py) calls this kernel for them with no window.
//
// What bounds it on an H100: the function needs its 16 B N bytes of I/O
// (N = 1024, B = 512: 8.4 MB, about 2.5 us at 3.35 TB/s) and, as an FFT,
// 5 B N log2 N operations (26 MFLOP, under 1 us at 67 TFLOP/s), so it is
// bound by bytes.  This simple form is not: its direct DFT does 8 B N^2
// float32 operations (4.3 GFLOP, about 64 us), and within the loop each
// 4 FMAs read 4 floats from shared memory, so shared-memory bandwidth and
// the bank conflicts of the twiddle reads hold it further back.  An FFT
// schedule (radix stages in shared memory) is a later redesign.
//
// Design (as K2, csrc/fft_abs2.cu): one block per (row, tile of 256
// output bins), one thread per bin.  The block stages one N-entry cos/sin
// table and the windowed row in shared memory (4 N floats, 16 KB at
// N = 1024) instead of the [N, N] matrices of the matmul form, and walks
// the twiddle index (j k) mod N incrementally.  Rows are addressed by a
// row stride and a re/im plane stride, so a [B, 2, N] view is read in
// place.  Plain float32 FMA, no tensor cores (parity first).
#include <cuda_runtime.h>

namespace {

constexpr int kBins = 256;  // output bins per block, one per thread

__global__ void __launch_bounds__(kBins)
fft_planes_kernel(const float* __restrict__ x, long long s_row,
                  long long s_plane, const float* __restrict__ win,
                  const float* __restrict__ tw, float* __restrict__ out,
                  int n) {
  extern __shared__ float sm[];  // cos[n], sin[n], re*w[n], im*w[n]
  float* cs = sm;
  float* sn = sm + n;
  float* xr = sm + 2 * n;
  float* xi = sm + 3 * n;
  const long long row = blockIdx.x;
  const float* pr = x + row * s_row;
  const float* pi = pr + s_plane;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    cs[i] = tw[i];
    sn[i] = tw[n + i];
    const float w = win ? win[i] : 1.f;
    xr[i] = pr[i] * w;
    xi[i] = pi[i] * w;
  }
  __syncthreads();
  const int k = blockIdx.y * kBins + threadIdx.x;
  if (k >= n) return;
  const int mask = n - 1;  // n is a power of two
  float re = 0.f, im = 0.f;
  int idx = 0;  // (j * k) mod n
  for (int j = 0; j < n; ++j) {
    // (a + i b)(c - i s) = (a c + b s) + i (b c - a s)
    const float c = cs[idx], s = sn[idx];
    const float a = xr[j], b = xi[j];
    re = fmaf(a, c, re);
    re = fmaf(b, s, re);
    im = fmaf(b, c, im);
    im = fmaf(-a, s, im);
    idx = (idx + k) & mask;
  }
  float* o = out + row * 2 * n;
  o[k] = re;
  o[n + k] = im;
}

}  // namespace

// Row r reads re at x + r*s_row and im s_plane further (element strides;
// the last axis is contiguous).  win [n] f32 or NULL (no window); tw
// [2, n] (cos, sin of 2 pi m / n) f32 on the device; out [rows, 2, n] f32
// contiguous.
extern "C" int rsx_fft_planes(const float* x, long long s_row,
                              long long s_plane, int rows, const float* win,
                              const float* tw, float* out, int n, int device,
                              void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const size_t smem = 4 * static_cast<size_t>(n) * sizeof(float);
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(fft_planes_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const int threads = n < kBins ? n : kBins;
  const dim3 grid(rows, (n + kBins - 1) / kBins);
  fft_planes_kernel<<<grid, threads, smem,
                      static_cast<cudaStream_t>(stream)>>>(
      x, s_row, s_plane, win, tw, out, n);
  return cudaGetLastError();
}

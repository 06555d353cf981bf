// K1: the FSK frequency estimator's spectral pass on its own, sf_new =
// sf*decay + sum_h w_h * |DFT(win * x[s_h : s_h + ndft])| (fftshifted), for
// every channel: one launch, one 256-thread block a channel.
//
// Replaces radiosonde_auto_rx_tpu/ops/pallas_fsk.py::_sf_kernel (the
// pallas_call in freq_est_sf).  The demod itself runs this stage inside the
// persistent scan (fsk_scan.cu); this thin kernel around the same device
// function (fsk_block.cuh::spectral_pass) is the stage's unit check and the
// entry ops/fsk_sf.py::freq_est_sf.
//
// What bounds it on an H100: latency.  The function is a few KB of input
// (bound 0.0001-0.0002 ms on bytes) and the station gives it 1-16 channels,
// i.e. 1-16 blocks on 132 SMs; a block's time is its chain of hop groups,
// each one row FFT in shared memory (three radix stages at ndft 128) and
// the ordered sum into the bins.  The first port computed the DFT directly
// (ndft^2 per hop out of L2) in two launches with a [C, nf, ndft] scratch
// between them; this one does a fourteenth of the operations (ndft 128),
// keeps the spectra in shared memory and sums the hops in order in the same
// block.
//
// The window is read from wc's DC column (wc[n, ndft/2] = win[n] cos 0, the
// twin's own float32 values): the wrapper passes the twin's [ndft, ndft]
// operands, and ws carries nothing the FFT needs.  The wrapper refuses a
// wc/ws pair that is not that window's DFT (ops/fsk_sf.py::is_dft_pair),
// since the kernel would compute another function than the twin.
#include "fsk_block.cuh"

namespace {

using namespace rsx;
using namespace rsx::fsk;

template <int LOG2N>
__global__ void __launch_bounds__(kThreads)
freq_est_sf_kernel(const float* __restrict__ xw, const float* __restrict__ sf,
                   const float* __restrict__ wc, const int* __restrict__ starts,
                   const float* __restrict__ weights, float decay,
                   const float* __restrict__ tw, float* __restrict__ out,
                   int nmem, int nf) {
  using S = SpecPlan<LOG2N>;
  constexpr int N = S::N;
  extern __shared__ float smem[];
  float* tc = smem;
  float* ts = tc + S::F::PN;
  float* win = ts + S::F::PN;
  float* rows = win + N;
  stage_table<LOG2N>(tw, tc, ts);
  for (int i = threadIdx.x; i < N; i += kThreads) win[i] = wc[i * N + N / 2];
  __syncthreads();
  const int c = blockIdx.x;
  const float* xr = xw + static_cast<long long>(c) * 2 * nmem;
  spectral_pass<LOG2N>(xr, xr + nmem, starts, weights, nf, win, decay,
                       sf + c * N, out + c * N, tc, ts, rows);
}

template <int LOG2N>
cudaError_t launch(const float* xw, const float* sf, const float* wc,
                   const int* starts, const float* weights, float decay,
                   const float* tw, float* out, int C, int nmem, int nf,
                   cudaStream_t stream) {
  using S = SpecPlan<LOG2N>;
  const size_t smem =
      sizeof(float) * (2 * S::F::PN + S::N + S::ROWS * S::ROW);
  freq_est_sf_kernel<LOG2N><<<C, kThreads, smem, stream>>>(
      xw, sf, wc, starts, weights, decay, tw, out, nmem, nf);
  return cudaGetLastError();
}

}  // namespace

// xw [C, 2, nmem], sf/out [C, ndft], wc [ndft, ndft] (the twin's windowed
// DFT operand), tw [2, ndft] (cos, sin of 2 pi m / ndft), all f32
// contiguous on the device; starts [nf] int32 (each + ndft <= nmem) and
// weights [nf] f32 on the device.  ndft: 64, 128, 256 or 512.
extern "C" int rsx_freq_est_sf(const float* xw, const float* sf,
                               const float* wc, const int* starts,
                               const float* weights, float decay,
                               const float* tw, float* out, int C, int nmem,
                               int ndft, int nf, int device, void* stream) {
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (ndft) {
    case 64:
      return launch<6>(xw, sf, wc, starts, weights, decay, tw, out, C, nmem,
                       nf, s);
    case 128:
      return launch<7>(xw, sf, wc, starts, weights, decay, tw, out, C, nmem,
                       nf, s);
    case 256:
      return launch<8>(xw, sf, wc, starts, weights, decay, tw, out, C, nmem,
                       nf, s);
    case 512:
      return launch<9>(xw, sf, wc, starts, weights, decay, tw, out, C, nmem,
                       nf, s);
    default:
      return cudaErrorInvalidValue;
  }
}

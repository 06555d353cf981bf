// The buffered FSK demod scan as ONE persistent launch per
// demod/fsk.py::fsk_demod_stream call: every demod block of every channel.
//
// Replaces radiosonde_auto_rx_tpu/ops/pallas_fsk.py::_sf_kernel (K1, the
// pallas_call at :84, now the scan's spectral stage) together with the
// demod block around it that the JAX package leaves to XLA
// (radiosonde_auto_rx_tpu/demod/fsk.py::fsk_demod_block inside
// _fsk_demod_scan_buffered's lax.scan).  The port ran that block as ~150
// small torch ops per demod block, ~3,150 launches per steady 1 s station
// block; this kernel is one launch per chain (type group).
//
// What bounds it on an H100: latency.  The bytes (the input span read once,
// the soft decisions written once) and the operations (the FFTs and the
// downconvert) come to 0.0002-0.001 ms, but each channel is a serial chain
// of n_blocks dependent demod blocks (14 for RS41 at 1 s, 62-63 for
// M10/M20), and a chain can only run on one SM: the carry of block b (the
// spectral EMA, timing, ppm, pointer, window offset) is block b+1's input.
// So one 256-thread block per channel walks the blocks with its carry in
// shared memory, and the design's job is the per-demod-block latency:
// every stage is spread over the 256 threads, the next block's window span
// is copied in with cp.async while this block computes (when two spans fit:
// all chains but MTS01), and nothing goes back to device memory between
// stages except the outputs.  The stages are fsk_block.cuh's.
//
// Outputs are written in the layout fsk_demod_stream returns: soft and bits
// [C, n_blocks * nsym * bps], f_est [C, n_blocks, M], ebno and ppm
// [C, n_blocks]; with probe also sf [C, n_blocks, ndft], timing
// [C, n_blocks] and tmag [C, n_blocks, M, nsym].
#include "fsk_block.cuh"

namespace {

using namespace rsx;
using namespace rsx::fsk;

template <int LOG2N, int M>
__global__ void __launch_bounds__(kThreads)
fsk_scan_kernel(const ScanArgs a) {
  extern __shared__ float smem[];
  scan_channel<LOG2N, M>(a, blockIdx.x, smem);
}

template <int LOG2N, int M>
cudaError_t launch(const ScanArgs& a, size_t bytes, int device,
                   cudaStream_t stream) {
  static size_t opted[kMaxDevices];   // dynamic shared memory opted in
  if (bytes > 48 * 1024 && opted[device] < bytes) {
    const cudaError_t err = cudaFuncSetAttribute(
        fsk_scan_kernel<LOG2N, M>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(bytes));
    if (err != cudaSuccess) return err;
    opted[device] = bytes;
  }
  fsk_scan_kernel<LOG2N, M><<<a.C, kThreads, bytes, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

// ptrs [kScanPtrs], geo [kScanInts], fgeo [kScanFloats]: host arrays in the
// order of fsk_block.cuh's ScanPtr, ScanInt and ScanFloat (every pointer a
// contiguous device array; the probe pointers may be NULL).  ndft 64, 128,
// 256 or 512; M 2 or 4.
extern "C" int rsx_fsk_scan(const void* const* ptrs, const int* geo,
                            const float* fgeo, int device, void* stream) {
  if (device < 0 || device >= kMaxDevices) return cudaErrorInvalidDevice;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  int optin = 0;
  err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               device);
  if (err != cudaSuccess) return err;
  ScanArgs a = scan_args(ptrs, geo, fgeo);
  a.stages = sizeof(float) * scan_map(a, 2).total <=
                     static_cast<size_t>(optin) ? 2 : 1;
  const size_t bytes = sizeof(float) * scan_map(a, a.stages).total;
  if (bytes > static_cast<size_t>(optin) || a.C < 1 || a.nb < 1)
    return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define RSX_CASE(L)                                       \
  case 1 << L:                                            \
    return a.m == 2 ? launch<L, 2>(a, bytes, device, s)   \
                    : launch<L, 4>(a, bytes, device, s);
  if (a.m != 2 && a.m != 4) return cudaErrorInvalidValue;
  switch (a.ndft) {
    RSX_CASE(6) RSX_CASE(7) RSX_CASE(8) RSX_CASE(9)
    default:
      return cudaErrorInvalidValue;
  }
#undef RSX_CASE
}

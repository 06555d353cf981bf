// Runs the row FFT of csrc/fft_smem.cuh on the CPU (see cuda_runtime.h
// beside this file) and holds it against a float64 DFT.
//
//   fft_rows_host LOG2N  ->  prints "N rows blocks err_windowed err_plain"
//
// Rows are no multiple of a block's rows, start 3 floats into their buffer
// (no 16-byte alignment), and are walked by 2 blocks and by 1, with and
// without a window.  err is the largest |got - want| / (|want| + row RMS).
#include "cuda_runtime.h"

thread_local ShimIdx threadIdx, blockIdx, gridDim;
pthread_barrier_t shim_barrier;
namespace rsx {
float sm[1 << 15];  // the block's dynamic shared memory
}

#include <algorithm>
#include <complex>
#include <cstdio>
#include <cstdlib>
#include <thread>
#include <vector>

#include "fft_smem.cuh"

using namespace rsx;

template <int L>
double run(int rows, bool windowed, int grid) {
  using P = FftPlan<L>;
  constexpr int N = P::N;
  static_assert(P::SMEM_BYTES <= sizeof(sm), "shim shared memory too small");
  std::vector<float> x(rows * 2 * N + 3), win(N), tw(2 * N),
      out(rows * 2 * N, -7.f);
  srand(L * 7 + grid);
  for (auto& v : x) v = static_cast<float>(rand()) / RAND_MAX - 0.5f;
  for (int i = 0; i < N; ++i) {
    win[i] = 0.5f + static_cast<float>(rand()) / RAND_MAX;
    tw[i] = static_cast<float>(std::cos(2 * M_PI * i / N));
    tw[N + i] = static_cast<float>(std::sin(2 * M_PI * i / N));
  }
  const float* xp = x.data() + 3;
  float* op = out.data();
  const float* wp = windowed ? win.data() : nullptr;
  const float* tp = tw.data();
  for (int blk = 0; blk < grid; ++blk) {
    pthread_barrier_init(&shim_barrier, nullptr, P::THREADS);
    std::vector<std::thread> threads;
    for (int t = 0; t < P::THREADS; ++t)
      threads.emplace_back([=] {
        threadIdx.x = t;
        blockIdx.x = blk;
        gridDim.x = grid;
        fft_rows<L>(
            rows, static_cast<long long>(N), wp, tp,
            [=](long long row) { return xp + row * 2 * N; },
            [=](long long row, int bin, cpx X) {
              op[row * 2 * N + bin] = X.re;
              op[row * 2 * N + N + bin] = X.im;
            });
      });
    for (auto& th : threads) th.join();
    pthread_barrier_destroy(&shim_barrier);
  }
  double worst = 0;
  std::vector<std::complex<double>> want(N);
  for (int r = 0; r < rows; ++r) {
    double rms = 0;
    for (int k = 0; k < N; ++k) {
      std::complex<double> a = 0;
      for (int n = 0; n < N; ++n) {
        const double w = windowed ? win[n] : 1.0;
        a += std::complex<double>(xp[r * 2 * N + n] * w,
                                  xp[r * 2 * N + N + n] * w) *
             std::polar(1.0, -2 * M_PI * (static_cast<long long>(n) * k % N) /
                                 N);
      }
      want[k] = a;
      rms += std::norm(a);
    }
    rms = std::sqrt(rms / N);
    for (int k = 0; k < N; ++k) {
      const std::complex<double> got(out[r * 2 * N + k],
                                     out[r * 2 * N + N + k]);
      worst = std::max(worst,
                       std::abs(got - want[k]) / (std::abs(want[k]) + rms));
    }
  }
  return worst;
}

template <int L>
int report(int log2n) {
  if (L != log2n) {
    if constexpr (L < kMaxLog2N) return report<L + 1>(log2n);
    return 1;
  }
  using P = FftPlan<L>;
  const int rows = 2 * P::RPB + (P::RPB > 1 ? 3 : 1);
  std::printf("%d %d %d %.3e %.3e\n", P::N, rows, 2, run<L>(rows, true, 2),
              run<L>(rows, false, 1));
  return 0;
}

int main(int argc, char** argv) {
  return argc == 2 ? report<1>(std::atoi(argv[1])) : 1;
}

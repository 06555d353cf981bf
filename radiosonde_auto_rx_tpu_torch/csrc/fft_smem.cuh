// The row FFT that K2 (fft_abs2.cu) and K3 (fft_planes.cu) share: a
// power-of-two complex FFT, N = 2 .. 4096, of rows held as planar re/im
// float32, with the butterflies in registers and the exchanges between
// stages in one block's shared memory.
//
// It takes the place of the direct O(N^2) DFT that both kernels carried
// over from radiosonde_auto_rx_tpu/ops/pallas_fft.py (dense [N, N] DFT
// matrices, the right shape for a 128-deep systolic array and the wrong
// one here): 5 N log2 N operations a row instead of 8 N^2, 300x fewer at
// N = 2048.
//
// What bounds it on an H100: as an FFT the function is bound by its
// device-memory bytes (every input read once, every output written
// once), so the design's job is to keep everything else below that:
// passes through shared memory, bank conflicts, barriers, and blocks
// enough in flight to cover the loads' latency.
//
// Design.
// * Stockham autosort, decimation in time, no bit-reversal pass.  Radix 8
//   for as many stages as log2 N holds, then ONE radix-4 or radix-2 stage
//   for the rest (N = 2048: 8, 8, 8, 4 — four stages and three exchanges
//   instead of eleven; N = 4096: 8, 8, 8, 8).
// * A row has T = N/8 threads and a thread holds 8 complex values in
//   registers at every stage: one radix-8 butterfly, two radix-4 or four
//   radix-2.  In every stage thread t reads the row positions t + m T
//   (m = 0 .. 7) and, after the last stage, holds the bins t + m T: a
//   warp's reads and writes of device memory are 32 neighbouring floats,
//   whatever the row's alignment, so the first stage loads straight from
//   device memory into registers (times the window) and the last stage's
//   epilogue stores straight from registers.  No staging pass, hence no
//   16-byte form and no aligned/unaligned switch: a 16-byte load would give
//   a thread 4 neighbouring samples, which no radix-8 butterfly takes, so it
//   would cost two more passes through shared memory.
// * Exchanges are in place (one planar re/im buffer a row): every thread
//   reads its 8 values, barrier, butterflies, writes, barrier.  Half the
//   shared memory of a two-buffer form for one more barrier a stage.
// * Bank conflicts: stage s writes position (j / Ns) Ns R + j % Ns + r Ns
//   (Ns = product of the earlier radices): stride 8 across a warp in the
//   first stage, runs of 8 at stride 64 in the second.  No padding i + f(i/32)
//   frees both (the first wants f distinct modulo 8, the second wants it in
//   steps of 8), so position i of a row is stored at swz(i), which XORs
//   bits 5-7 of i into bits 0-2 and bits 6-7 into bits 3-4.  Within an
//   aligned run of 32 that is a permutation of the banks, so the unit-stride
//   reads stay conflict-free, and for N >= 256 so is every write of every
//   stage (tests/test_torch_fft.py counts a warp's addresses on each bank,
//   stage by stage).
//   Rows of N <= 128, several to a warp, keep 2- to 4-way conflicts in
//   their first stage's writes.
// * Twiddles: stage s multiplies input r of butterfly j by
//   table[(j % Ns) r N / (Ns R)], read from the N-entry float32 cos/sin
//   table that the wrapper computes in float64 and rounds once (no
//   __sincosf, no recurrence).  The block stages the table in shared
//   memory once, entry i at i + i/32 (that padding leaves the strided
//   reads of the middle stages at most 2-way conflicts; the swizzle would
//   leave 8-way), and then walks over its rows, so the table costs one
//   read a block, not one a row.
// * Rows of N < 1024 share a block (128 threads: 2 rows at N = 512, 16 at
//   N = 64), and the grid is capped at what the card holds at once
//   (occupancy x SMs, asked once per instantiation and device), each
//   block looping over rows.
// * Shared memory: 2 (N + N/32) floats of table and 2 N a row: 32.3 KB at
//   N = 2048, 64.5 KB at N = 4096 (dynamic, opted in once per
//   instantiation and device).
//
// What `nvcc -Xptxas -v` reports for sm_90a (CUDA 12.8) is printed by
// chip_smoke.py at every build: no spills and no stack frame in any of the
// 24 instantiations; registers a thread are noted in fft_abs2.cu and
// fft_planes.cu, with the blocks an SM then holds.
#pragma once
#include <cuda_runtime.h>

namespace rsx {

struct cpx {
  float re, im;
};

__device__ __forceinline__ cpx operator+(cpx a, cpx b) {
  return {a.re + b.re, a.im + b.im};
}
__device__ __forceinline__ cpx operator-(cpx a, cpx b) {
  return {a.re - b.re, a.im - b.im};
}
// a (c - i s): the twiddle e^{-i theta} from the table's cos, sin
__device__ __forceinline__ cpx mul_tw(cpx a, float c, float s) {
  return {fmaf(a.re, c, a.im * s), fmaf(a.im, c, -a.re * s)};
}
// a (-i)
__device__ __forceinline__ cpx mul_neg_i(cpx a) { return {a.im, -a.re}; }

// where entry i of the twiddle table is stored (one float of padding per 32)
__host__ __device__ constexpr int pad(int i) { return i + (i >> 5); }
// where position i of a row is stored: bits 5-7 XORed into bits 0-2 and
// bits 6-7 into bits 3-4 (a permutation of every aligned 256)
__host__ __device__ constexpr int swz(int i) {
  return i ^ ((i >> 5) & 7) ^ (((i >> 5) & 6) << 2);
}

template <int LOG2N>
struct FftPlan {
  static constexpr int N = 1 << LOG2N;
  static constexpr int T = N >= 8 ? N / 8 : 1;         // threads a row
  static constexpr int VALS = N / T;                   // values a thread
  static constexpr int RPB = T >= 128 ? 1 : 128 / T;   // rows a block
  static constexpr int THREADS = T * RPB;
  // Second argument of __launch_bounds__; 0 leaves it unset.  N = 4096 (512
  // threads) asks for two blocks an SM, i.e. 64 registers a thread, which
  // on an H100 ran faster at 2048 rows than the one block that 74-79
  // registers allow.  Below, unset is best: a cap of 64 registers at
  // N = 2048 (80 -> 64, 3 -> 4 blocks an SM) ran slower at 2920 rows, and
  // an explicit 1 makes ptxas spend 93 (2 blocks an SM): K2 then took
  // 0.0373 ms at 2920 rows instead of 0.0331 (chip_smoke.py, H100 80GB
  // HBM3 at 700 W).
  static constexpr int MIN_BLOCKS = THREADS >= 512 ? 2 : 0;
  static constexpr int PN = N + N / 32;                // padded table length
  // floats from one row's (re, im) to the next: rows that share a warp
  // (T < 32) are set T banks apart, so that their unit-stride reads tile
  // the banks
  static constexpr int ROW = 2 * N + (T < 32 ? T : 0);
  static constexpr bool EXCHANGES = N > 8;             // more than one stage
  static constexpr size_t SMEM_BYTES =
      EXCHANGES ? sizeof(float) * (2 * PN + RPB * ROW) : 0;
};

__device__ __forceinline__ void fft4(cpx& a0, cpx& a1, cpx& a2, cpx& a3) {
  const cpx t0 = a0 + a2, t1 = a0 - a2, t2 = a1 + a3;
  const cpx t3 = mul_neg_i(a1 - a3);
  a0 = t0 + t2;
  a1 = t1 + t3;
  a2 = t0 - t2;
  a3 = t1 - t3;
}

// Radix-R DFT of v[b], v[b + S], ..., v[b + (R-1) S], natural order in
// and out.
template <int R, int S, int VALS>
__device__ __forceinline__ void butterfly(cpx (&v)[VALS], int b) {
  if constexpr (R == 2) {
    const cpx a = v[b], c = v[b + S];
    v[b] = a + c;
    v[b + S] = a - c;
  } else if constexpr (R == 4) {
    fft4(v[b], v[b + S], v[b + 2 * S], v[b + 3 * S]);
  } else {
    static_assert(R == 8, "radix 2, 4 or 8");
    constexpr float h = 0.70710678118654752440f;
    cpx e0 = v[b], e1 = v[b + 2 * S], e2 = v[b + 4 * S], e3 = v[b + 6 * S];
    cpx o0 = v[b + S], o1 = v[b + 3 * S], o2 = v[b + 5 * S],
        o3 = v[b + 7 * S];
    fft4(e0, e1, e2, e3);
    fft4(o0, o1, o2, o3);
    o1 = {h * (o1.re + o1.im), h * (o1.im - o1.re)};    // e^{-i pi/4}
    o2 = mul_neg_i(o2);                                 // e^{-i pi/2}
    o3 = {h * (o3.im - o3.re), -h * (o3.re + o3.im)};   // e^{-3i pi/4}
    v[b] = e0 + o0;
    v[b + S] = e1 + o1;
    v[b + 2 * S] = e2 + o2;
    v[b + 3 * S] = e3 + o3;
    v[b + 4 * S] = e0 - o0;
    v[b + 5 * S] = e1 - o1;
    v[b + 6 * S] = e2 - o2;
    v[b + 7 * S] = e3 - o3;
  }
}

// The stage whose earlier radices multiply to NS, and every stage after
// it.  In: v[m] = position t + m T of the row (first stage), or the row in
// (sr, si).  Out: v[m] = bin t + m T.  Holds barriers: every thread of the
// block calls it.
template <int LOG2N, int NS>
__device__ __forceinline__ void fft_stages(
    cpx (&v)[FftPlan<LOG2N>::VALS], float* sr, float* si, const float* tc,
    const float* ts, int t) {
  using P = FftPlan<LOG2N>;
  constexpr int N = P::N, T = P::T, VALS = P::VALS;
  constexpr int R = N / NS >= 8 ? 8 : N / NS;   // this stage's radix
  constexpr int BPT = N / (R * T);              // butterflies a thread
  constexpr bool FIRST = NS == 1, LAST = NS * R == N;
  if constexpr (!FIRST) {
#pragma unroll
    for (int m = 0; m < VALS; ++m) {
      const int i = swz(t + m * T);
      v[m] = {sr[i], si[i]};
    }
    if constexpr (!LAST) __syncthreads();   // all read before any writes
  }
#pragma unroll
  for (int b = 0; b < BPT; ++b) {
    const int j = t + b * T;                // butterfly j of N / R
    const int k = j & (NS - 1);
    if constexpr (!FIRST) {
      constexpr int STEP = N / (NS * R);
#pragma unroll
      for (int r = 1; r < R; ++r) {
        const int i = pad(k * r * STEP);
        v[b + r * BPT] = mul_tw(v[b + r * BPT], tc[i], ts[i]);
      }
    }
    butterfly<R, BPT>(v, b);
    if constexpr (!LAST) {
      const int base = (j - k) * R + k;
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int i = swz(base + r * NS);
        sr[i] = v[b + r * BPT].re;
        si[i] = v[b + r * BPT].im;
      }
    }
  }
  if constexpr (!LAST) {
    __syncthreads();
    fft_stages<LOG2N, NS * R>(v, sr, si, tc, ts, t);
  }
}

// The body of a row-FFT kernel: stage the table, then for each of this
// block's rows load (re, im) = win * x from row_ptr(row) and s_plane
// further, transform, and hand every bin to store(row, bin, X).  win may
// be NULL (no window); tw is [2, N]: cos, sin of 2 pi m / N.
template <int LOG2N, class RowPtr, class Store>
__device__ __forceinline__ void fft_rows(int rows, long long s_plane,
                                         const float* __restrict__ win,
                                         const float* __restrict__ tw,
                                         RowPtr row_ptr, Store store) {
  using P = FftPlan<LOG2N>;
  constexpr int N = P::N, T = P::T, VALS = P::VALS;
  extern __shared__ float sm[];   // cos, sin, then (re, im) for each row
  float* tc = sm;
  float* ts = sm + P::PN;
  const int q = threadIdx.x / T, t = threadIdx.x % T;
  float* sr = sm + 2 * P::PN + q * P::ROW;
  float* si = sr + N;
  if constexpr (P::EXCHANGES) {
    for (int i = threadIdx.x; i < N; i += P::THREADS) {
      tc[pad(i)] = tw[i];
      ts[pad(i)] = tw[N + i];
    }
  }
  float w[VALS];
#pragma unroll
  for (int m = 0; m < VALS; ++m) w[m] = win ? win[t + m * T] : 1.f;
  for (long long first = static_cast<long long>(blockIdx.x) * P::RPB;
       first < rows; first += static_cast<long long>(gridDim.x) * P::RPB) {
    const long long row = first + q;
    const bool live = row < rows;
    cpx v[VALS];
    if (live) {
      const float* pr = row_ptr(row);
      const float* pi = pr + s_plane;
#pragma unroll
      for (int m = 0; m < VALS; ++m)
        v[m] = {pr[t + m * T] * w[m], pi[t + m * T] * w[m]};
    } else {
#pragma unroll
      for (int m = 0; m < VALS; ++m) v[m] = {0.f, 0.f};
    }
    // the table is staged; the row before is read out of shared memory
    __syncthreads();
    fft_stages<LOG2N, 1>(v, sr, si, tc, ts, t);
    if (live) {
#pragma unroll
      for (int m = 0; m < VALS; ++m) store(row, t + m * T, v[m]);
    }
  }
}

constexpr int kMaxLog2N = 12;    // N = 4096
constexpr int kMaxDevices = 64;

// Blocks the card holds at once for this kernel.  On the first call for a
// device it also opts the kernel in to its dynamic shared memory.
template <class Kernel>
cudaError_t grid_cap(Kernel kernel, int threads, size_t smem, int device,
                     int (&cache)[kMaxDevices], int* cap) {
  if (device < 0 || device >= kMaxDevices) return cudaErrorInvalidDevice;
  if (cache[device] == 0) {
    cudaError_t err = cudaSuccess;
    if (smem > 48 * 1024) {
      err = cudaFuncSetAttribute(kernel,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 static_cast<int>(smem));
      if (err != cudaSuccess) return err;
    }
    int per_sm = 0, sms = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        threads, smem);
    if (err != cudaSuccess) return err;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                 device);
    if (err != cudaSuccess) return err;
    if (per_sm < 1 || sms < 1) return cudaErrorLaunchOutOfResources;
    cache[device] = per_sm * sms;
  }
  *cap = cache[device];
  return cudaSuccess;
}

}  // namespace rsx

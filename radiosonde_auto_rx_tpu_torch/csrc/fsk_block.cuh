// The FSK demod block as device code: one stage function per stage of
// demod/fsk.py::fsk_demod_block, run by one 256-thread block per channel.
// Shared by fsk_sf.cu (K1 alone: the spectral stage) and fsk_scan.cu (the
// whole buffered scan in one persistent launch).
//
// Stages and the plain lines they follow (radiosonde_auto_rx_tpu_torch/
// demod/fsk.py; the reference is radiosonde_auto_rx_tpu/demod/fsk.py):
//   spectral_pass   K1, _freq_est / ops/fsk_sf.py::freq_est_sf_ref
//   estimate        _peak_estimate, _mask_estimate
//   nco_tables,     the factored-NCO downconvert and integrate-and-dump:
//   downconvert     t = a*tsp + b, phases k*b and k*a*Q*tsp, k*r*tsp taken
//                   mod 1 (floor) before the trig, as the twin does; never a
//                   float32 per-sample NCO
//   timing_sums     fine timing from the |.|^2 line at Rs
//   resample        interpolation at the timing estimate, hard bits, soft
//                   decisions, Eb/N0 sums
//
// K1's spectral stage, sf <- sf*decay + sum_h w_h |DFT(win * x[s_h : s_h +
// ndft])| (fftshifted), is an FFT here, not the direct O(ndft^2) DFT of the
// first port: each hop is one row of csrc/fft_smem.cuh's radix-8 FFT, the
// window multiplied in on the way into registers and the shift done by
// rotating the output index.  A 256-thread block transforms 256/(ndft/8)
// hops at once (16 at ndft 128) and adds w_h |X_h| into the per-bin sums in
// hop order, one hop group after another, so the result is deterministic and
// no partial spectra leave shared memory.  No tensor cores: at ndft <= 512
// the FFT does 1/14-1/60 of the operations of the DFT as a matrix product,
// TF32 would break the 1e-5 tolerance and 3xTF32 would triple the work.
//
// Numerics follow the plain twin: float32 throughout with precise cosf,
// sinf, atan2f, sqrtf and log10f (no fast math); the products and sums whose
// rounding the twin fixes (the NCO phases, the rotations, the clock tracking,
// the interpolation) use __fmul_rn/__fadd_rn so that nvcc does not contract
// them into FMAs; every argmax keeps the lowest index on ties, as
// torch.argmax; the M peaks are sorted ascending; every reduction is a fixed
// tree, so a run repeats bit for bit.  What may differ from the twin is the
// order of the long sums (the FFT against the matrix product, the timing and
// Eb/N0 sums), a few float32 ulps.
//
// The window buffer: at demod block b the buffered scan reads the
// reference's own rolling buffer x[c, :, b*n : b*n + nmem + slack] into
// shared memory with 4-byte cp.async (rows start at any float: M10 has
// n = 745), block b+1's buffer in flight while block b computes when two
// buffers fit (every chain but MTS01), and takes the window at the
// channel's offset off.  The unbuffered scan (the reference's
// _fsk_demod_scan) reads block b's window at [ptr - nmem, ptr) of the
// channel's stream, its start clamped into [0, T - nmem] as
// jax.lax.dynamic_slice clamps it; ptr is known only once block b-1's nin
// is, so its one buffer (slack 0) is loaded after the carry is updated.
//
// Compiled for the CPU by tests/cuda_shim (g++, every CUDA thread a host
// thread): cp.async becomes a plain copy there, and nothing here uses warp
// shuffles, so the reductions run the same on both.
#pragma once
#include <math.h>

#include "fft_smem.cuh"

namespace rsx {
namespace fsk {

constexpr int kThreads = 256;        // threads a block, one block a channel
constexpr int kMaxOffs = 12;         // mask comb offsets: 3 a tone, M <= 4
constexpr float kTwoPi = 6.28318530717958647692f;   // float32(2 pi)

// The row FFT's geometry for the spectral stage, also needed on the host to
// size shared memory (FftPlan's formulas, checked against it below).
__host__ __device__ constexpr int spec_t(int n) { return n >= 8 ? n / 8 : 1; }
__host__ __device__ constexpr int spec_rows(int n) {
  return kThreads / spec_t(n);
}
__host__ __device__ constexpr int spec_row_floats(int n) {
  return 2 * n + (spec_t(n) < 32 ? spec_t(n) : 0);
}
__host__ __device__ constexpr int spec_table_floats(int n) {
  return 2 * (n + n / 32);
}

template <int LOG2N>
struct SpecPlan {
  using F = FftPlan<LOG2N>;
  static constexpr int N = F::N, T = F::T, VALS = F::VALS;
  static constexpr int ROWS = spec_rows(N);        // hops a group
  static constexpr int ROW = spec_row_floats(N);
  static constexpr int BINS = (N + kThreads - 1) / kThreads;  // a thread's
  static_assert(ROW == F::ROW && spec_table_floats(N) == 2 * F::PN &&
                    T == spec_t(N) && VALS == 8 && kThreads % T == 0,
                "spectral stage geometry");
};

// ---------------------------------------------------------------------- //
// copies into shared memory

__device__ __forceinline__ void copy4_async(float* dst, const float* src) {
#if defined(__CUDA_ARCH__)
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
               "l"(src));
#else
  *dst = *src;
#endif
}
__device__ __forceinline__ void async_commit() {
#if defined(__CUDA_ARCH__)
  asm volatile("cp.async.commit_group;\n" ::);
#endif
}
template <int PENDING>
__device__ __forceinline__ void async_wait() {
#if defined(__CUDA_ARCH__)
  asm volatile("cp.async.wait_group %0;\n" ::"n"(PENDING));
#endif
}

// ---------------------------------------------------------------------- //
// block reductions (fixed trees; every thread gets the result)

__device__ inline void block_sum2(float& a, float& b, float* red) {
  const int tid = threadIdx.x;
  red[tid] = a;
  red[kThreads + tid] = b;
  __syncthreads();
  for (int s = kThreads / 2; s > 0; s >>= 1) {
    if (tid < s) {
      red[tid] += red[tid + s];
      red[kThreads + tid] += red[kThreads + tid + s];
    }
    __syncthreads();
  }
  a = red[0];
  b = red[kThreads];
  __syncthreads();
}

// Index of the largest of v[0 .. n), the lowest index on ties.
__device__ inline int block_argmax(const float* v, int n, float* red,
                                   int* redi) {
  const int tid = threadIdx.x;
  float best = -INFINITY;
  int bi = n;
  for (int k = tid; k < n; k += kThreads) {
    if (v[k] > best) {
      best = v[k];
      bi = k;
    }
  }
  red[tid] = best;
  redi[tid] = bi;
  __syncthreads();
  for (int s = kThreads / 2; s > 0; s >>= 1) {
    if (tid < s) {
      const float o = red[tid + s];
      const int oi = redi[tid + s];
      if (o > red[tid] || (o == red[tid] && oi < redi[tid])) {
        red[tid] = o;
        redi[tid] = oi;
      }
    }
    __syncthreads();
  }
  const int r = redi[0];
  __syncthreads();
  return r;
}

// ---------------------------------------------------------------------- //
// K1: the spectral stage

// Stage the twiddle table (cos, sin of 2 pi m / N) for fft_stages.
template <int LOG2N>
__device__ inline void stage_table(const float* tw, float* tc, float* ts) {
  constexpr int N = SpecPlan<LOG2N>::N;
  for (int i = threadIdx.x; i < N; i += kThreads) {
    tc[pad(i)] = tw[i];
    ts[pad(i)] = tw[N + i];
  }
}

// sf_out[k] = sf_in[k] * decay + sum_h weights[h] |X_h[(k + N/2) mod N]|,
// X_h the DFT of win * (xr + i xi)[starts[h] ..]; sf_out may be sf_in.  The
// table (tc, ts) and the inputs must be visible to every thread (a barrier
// after they were written); rows: the hop group's FFT rows.  Ends with a
// barrier.  Every thread of the block calls it.
template <int LOG2N>
__device__ void spectral_pass(const float* xr, const float* xi,
                              const int* starts, const float* weights,
                              int nf, const float* win, float decay,
                              const float* sf_in, float* sf_out,
                              const float* tc, const float* ts, float* rows) {
  using S = SpecPlan<LOG2N>;
  constexpr int N = S::N, T = S::T;
  const int q = threadIdx.x / T, t = threadIdx.x % T;
  float* sr = rows + q * S::ROW;
  float* si = sr + N;
  float w[S::VALS];
#pragma unroll
  for (int m = 0; m < S::VALS; ++m) w[m] = win[t + m * T];
  float acc[S::BINS];
#pragma unroll
  for (int j = 0; j < S::BINS; ++j) acc[j] = 0.f;
  for (int h0 = 0; h0 < nf; h0 += S::ROWS) {
    const int h = h0 + q;
    const bool live = h < nf;
    cpx v[S::VALS];
    if (live) {
      const int s = starts[h];
#pragma unroll
      for (int m = 0; m < S::VALS; ++m)
        v[m] = {xr[s + t + m * T] * w[m], xi[s + t + m * T] * w[m]};
    } else {
#pragma unroll
      for (int m = 0; m < S::VALS; ++m) v[m] = {0.f, 0.f};
    }
    __syncthreads();   // the group before is summed out of rows
    fft_stages<LOG2N, 1>(v, sr, si, tc, ts, t);
    __syncthreads();   // every row is read out of rows
    if (live) {
      const float wt = weights[h];
#pragma unroll
      for (int m = 0; m < S::VALS; ++m) {
        const int bin = t + m * T;
        sr[(bin + N / 2) & (N - 1)] =
            wt * sqrtf(v[m].re * v[m].re + v[m].im * v[m].im);
      }
    }
    __syncthreads();
    const int nrows = nf - h0 < S::ROWS ? nf - h0 : S::ROWS;
#pragma unroll
    for (int j = 0; j < S::BINS; ++j) {
      const int k = threadIdx.x + j * kThreads;
      if (k < N)
        for (int r = 0; r < nrows; ++r) acc[j] += rows[r * S::ROW + k];
    }
  }
#pragma unroll
  for (int j = 0; j < S::BINS; ++j) {
    const int k = threadIdx.x + j * kThreads;
    if (k < N) sf_out[k] = __fadd_rn(__fmul_rn(sf_in[k], decay), acc[j]);
  }
  __syncthreads();
}

// ---------------------------------------------------------------------- //
// the buffered scan

// The scan's operands.  The C entry (fsk_scan.cu) and the CPU harness
// (tests/cuda_shim/fsk_scan_host.cc) build it with scan_args from three
// flat arrays whose order the Python wrapper
// (demod/fsk.py::SCAN_POINTERS, SCAN_INTS, SCAN_FLOATS) lists by name.
enum ScanPtr {
  pX,                                        // [C, 2, T] f32 planes
  pSfIn, pTimingIn, pPpmIn, pPtrIn,          // the carried state in
  pSf, pTiming, pPpm, pPtr, pNin,            // ... and out
  pSoft, pBits, pFEst, pEbno, pPpmBlocks,    // per block
  pProbeSf, pProbeTiming, pProbeTmag,        // probe=True, else NULL
  pWin, pTw, pStarts, pWeights, pRot,        // constants
  kScanPtrs
};
enum ScanInt {
  iC, iT, iBlocks, iM, iP, iNsym, iTs, iNdft, iNf, iEstType, iEstSt, iEstEn,
  iEstSpace, iMaskNb, iQ, iNA, iOff0, iOffMax, iWrap, iSlack, iNOffs, iOffs,
  iUnbuffered = iOffs + kMaxOffs, kScanInts
};
enum ScanFloat { fFs, fBinHz, fSpacing, fDecay, kScanFloats };

struct ScanArgs {
  const float* x;
  const float *sf_in, *timing_in, *ppm_in;
  const int* ptr_in;
  float *sf, *timing, *ppm;
  int *ptr, *nin;
  float* soft;
  unsigned char* bits;
  float *f_est, *ebno, *ppm_blocks;
  float *probe_sf, *probe_timing, *probe_tmag;
  const float *win, *tw;
  const int* starts;
  const float *weights, *rot;
  long long T;
  int C, nb, m, p, nsym, ts, ndft, nf, est_type, est_st, est_en, est_space,
      mask_nb, q, na, off0, off_max, wrap, slack, n_offs;
  int offs[kMaxOffs];
  float fs, bin_hz, spacing, decay;
  int unbuffered;   // 1: the window at [ptr - nmem, ptr), slack 0
  int stages;   // window buffers in shared memory: 1, or 2 (double buffered)
};

inline ScanArgs scan_args(const void* const* p, const int* g,
                          const float* f) {
  ScanArgs a;
  a.x = static_cast<const float*>(p[pX]);
  a.sf_in = static_cast<const float*>(p[pSfIn]);
  a.timing_in = static_cast<const float*>(p[pTimingIn]);
  a.ppm_in = static_cast<const float*>(p[pPpmIn]);
  a.ptr_in = static_cast<const int*>(p[pPtrIn]);
  a.sf = static_cast<float*>(const_cast<void*>(p[pSf]));
  a.timing = static_cast<float*>(const_cast<void*>(p[pTiming]));
  a.ppm = static_cast<float*>(const_cast<void*>(p[pPpm]));
  a.ptr = static_cast<int*>(const_cast<void*>(p[pPtr]));
  a.nin = static_cast<int*>(const_cast<void*>(p[pNin]));
  a.soft = static_cast<float*>(const_cast<void*>(p[pSoft]));
  a.bits = static_cast<unsigned char*>(const_cast<void*>(p[pBits]));
  a.f_est = static_cast<float*>(const_cast<void*>(p[pFEst]));
  a.ebno = static_cast<float*>(const_cast<void*>(p[pEbno]));
  a.ppm_blocks = static_cast<float*>(const_cast<void*>(p[pPpmBlocks]));
  a.probe_sf = static_cast<float*>(const_cast<void*>(p[pProbeSf]));
  a.probe_timing = static_cast<float*>(const_cast<void*>(p[pProbeTiming]));
  a.probe_tmag = static_cast<float*>(const_cast<void*>(p[pProbeTmag]));
  a.win = static_cast<const float*>(p[pWin]);
  a.tw = static_cast<const float*>(p[pTw]);
  a.starts = static_cast<const int*>(p[pStarts]);
  a.weights = static_cast<const float*>(p[pWeights]);
  a.rot = static_cast<const float*>(p[pRot]);
  a.T = g[iT];
  a.C = g[iC];
  a.nb = g[iBlocks];
  a.m = g[iM];
  a.p = g[iP];
  a.nsym = g[iNsym];
  a.ts = g[iTs];
  a.ndft = g[iNdft];
  a.nf = g[iNf];
  a.est_type = g[iEstType];
  a.est_st = g[iEstSt];
  a.est_en = g[iEstEn];
  a.est_space = g[iEstSpace];
  a.mask_nb = g[iMaskNb];
  a.q = g[iQ];
  a.na = g[iNA];
  a.off0 = g[iOff0];
  a.off_max = g[iOffMax];
  a.wrap = g[iWrap];
  a.slack = g[iSlack];
  a.n_offs = g[iNOffs];
  for (int i = 0; i < kMaxOffs; ++i) a.offs[i] = g[iOffs + i];
  a.fs = f[fFs];
  a.bin_hz = f[fBinHz];
  a.spacing = f[fSpacing];
  a.decay = f[fDecay];
  a.unbuffered = g[iUnbuffered];
  a.stages = 1;
  return a;
}

// The block's scalars between stages.
struct Carry {
  int off, ptr, nin, low;
  float timing, ppm, fract, norm;
  float fest[4];
  int peak[4];
};

// Where each region of a block's dynamic shared memory starts, in floats.
struct ScanMap {
  long long buf, tc, win, rows, sf, s, ps, nco, red, carry, total;
};

__host__ __device__ inline ScanMap scan_map(const ScanArgs& a, int stages) {
  const int n = a.nsym * a.ts, nmem = n + 2 * a.ts, w = nmem + a.slack;
  const int tsp = a.ts / a.p, nps = nmem / tsp, N = a.ndft;
  ScanMap s;
  long long o = 0;
  s.buf = o;   o += 2LL * stages * w;
  s.tc = o;    o += spec_table_floats(N);
  s.win = o;   o += N;
  s.rows = o;  o += static_cast<long long>(spec_rows(N)) * spec_row_floats(N);
  s.sf = o;    o += N;
  s.s = o;     o += N;
  s.ps = o;    o += 2LL * a.m * nps;
  s.nco = o;   o += 2LL * a.m * (tsp + a.na + a.q);
  s.red = o;   o += 3 * kThreads;
  s.carry = o; o += (sizeof(Carry) + sizeof(float) - 1) / sizeof(float);
  s.total = o;
  return s;
}

// Start the copy of x[c, :, start : start + w] into buf [2, w].
__device__ inline void load_buffer(float* buf, const float* xc, long long T,
                                   long long start, int w) {
  for (int pl = 0; pl < 2; ++pl) {
    const float* src = xc + pl * T + start;
    float* dst = buf + pl * w;
    for (int i = threadIdx.x; i < w; i += kThreads)
      copy4_async(dst + i, src + i);
  }
}

// The unbuffered scan's window start for a channel at pointer ptr:
// ptr - nmem clamped into [0, T - nmem].
__host__ __device__ inline long long window_start(long long ptr, int nmem,
                                                  long long T) {
  const long long s = ptr - nmem;
  return s < 0 ? 0 : (s > T - nmem ? T - nmem : s);
}

// sum_{pp < P} v[i + pp], in order (the integrate-and-dump)
__device__ __forceinline__ float dump(const float* v, int i, int P) {
  float s = v[i];
  for (int pp = 1; pp < P; ++pp) s = __fadd_rn(s, v[i + pp]);
  return s;
}

// Tone estimates into cy->fest from the spectrum sf (an argmax over it, or
// over its mask correlation).  Ends with a barrier.
template <int M>
__device__ void estimate(const ScanArgs& a, const float* sf, float* s,
                         float* red, int* redi, Carry* cy) {
  const int tid = threadIdx.x, N = a.ndft;
  if (a.est_type == 1) {            // mask correlator (fsk.c:549-581)
    for (int j = tid; j < a.mask_nb; j += kThreads) {
      float v = 0.f;
      for (int o = 0; o < a.n_offs; ++o)
        v = __fadd_rn(v, sf[a.est_st + a.offs[o] + j]);
      s[j] = v;
    }
    __syncthreads();
    const int bm = block_argmax(s, a.mask_nb, red, redi) + a.est_st;
    if (tid == 0) {
      const float foff = __fmul_rn(static_cast<float>(bm - N / 2), a.bin_hz);
      for (int m = 0; m < M; ++m)
        cy->fest[m] =
            __fadd_rn(foff, __fmul_rn(static_cast<float>(m), a.spacing));
    }
  } else {                          // M peaks with blanking (fsk.c:508-546)
    for (int k = tid; k < N; k += kThreads)
      s[k] = (k >= a.est_st && k < a.est_en) ? sf[k] : -1.f;
    __syncthreads();
    for (int m = 0; m < M; ++m) {
      const int im = block_argmax(s, N, red, redi);
      if (tid == 0) cy->peak[m] = im;
      for (int k = tid; k < N; k += kThreads)
        if (k >= im - a.est_space && k < im + a.est_space) s[k] = 0.f;
      __syncthreads();
    }
    if (tid == 0) {
      int pk[M];
      for (int m = 0; m < M; ++m) pk[m] = cy->peak[m];
      for (int i = 1; i < M; ++i)      // ascending
        for (int j = i; j > 0 && pk[j] < pk[j - 1]; --j) {
          const int t = pk[j];
          pk[j] = pk[j - 1];
          pk[j - 1] = t;
        }
      for (int m = 0; m < M; ++m)
        cy->fest[m] = __fmul_rn(static_cast<float>(pk[m] - N / 2), a.bin_hz);
    }
  }
  __syncthreads();
}

// The NCO's trig tables for each tone: cos/sin of 2 pi frac(k x) for the
// micro-mix x = b (b < tsp), the coarse steps x = iA Q tsp (iA < nA) and
// x = iR tsp (iR < Q), with k = f_est / fs.  Ends with a barrier.
template <int M>
__device__ void nco_tables(const ScanArgs& a, const Carry* cy, float* nco) {
  const int tsp = a.ts / a.p, na = a.na, q = a.q;
  const int e1 = M * tsp, e2 = e1 + M * na, e3 = e2 + M * q;
  float* cb = nco;
  float* sb = cb + M * tsp;
  float* ca = sb + M * tsp;
  float* sa = ca + M * na;
  float* cr = sa + M * na;
  float* sr = cr + M * q;
  for (int i = threadIdx.x; i < e3; i += kThreads) {
    int m, j;
    float x;
    float *co, *si;
    if (i < e1) {
      m = i / tsp;
      j = i - m * tsp;
      x = static_cast<float>(j);
      co = cb + i;
      si = sb + i;
    } else if (i < e2) {
      m = (i - e1) / na;
      j = (i - e1) - m * na;
      x = __fmul_rn(static_cast<float>(j), static_cast<float>(q * tsp));
      co = ca + (i - e1);
      si = sa + (i - e1);
    } else {
      m = (i - e2) / q;
      j = (i - e2) - m * q;
      x = __fmul_rn(static_cast<float>(j), static_cast<float>(tsp));
      co = cr + (i - e2);
      si = sr + (i - e2);
    }
    const float k = __fdiv_rn(cy->fest[m], a.fs);
    float ph = __fmul_rn(k, x);
    ph = __fsub_rn(ph, floorf(ph));
    const float ang = __fmul_rn(kTwoPi, ph);
    *co = cosf(ang);
    *si = sinf(ang);
  }
  __syncthreads();
}

// Tone downconvert: ps[2m] / ps[2m+1] (re, im) [nps] for each tone, the
// tsp-long micro-mix of the window times the coarse rotation.  Ends with a
// barrier.
template <int M>
__device__ void downconvert(const ScanArgs& a, const float* xr,
                            const float* xi, const float* nco, float* ps) {
  const int tsp = a.ts / a.p, na = a.na, q = a.q;
  const int nps = (a.nsym + 2) * a.p;
  const float* cb = nco;
  const float* sb = cb + M * tsp;
  const float* cA = sb + M * tsp;
  const float* sA = cA + M * na;
  const float* cR = sA + M * na;
  const float* sR = cR + M * q;
  for (int i = threadIdx.x; i < M * nps; i += kThreads) {
    const int m = i / nps, u = i - m * nps;
    float ur = 0.f, ui = 0.f;
    for (int j = 0; j < tsp; ++j) {
      const float xv = xr[u * tsp + j], yv = xi[u * tsp + j];
      const float c = cb[m * tsp + j], s = sb[m * tsp + j];
      ur = __fadd_rn(ur, __fadd_rn(__fmul_rn(xv, c), __fmul_rn(yv, s)));
      ui = __fadd_rn(ui, __fsub_rn(__fmul_rn(yv, c), __fmul_rn(xv, s)));
    }
    const int ia = m * na + u / q, ir = m * q + u % q;
    const float c =
        __fsub_rn(__fmul_rn(cA[ia], cR[ir]), __fmul_rn(sA[ia], sR[ir]));
    const float s =
        __fadd_rn(__fmul_rn(sA[ia], cR[ir]), __fmul_rn(cA[ia], sR[ir]));
    ps[2 * m * nps + u] = __fadd_rn(__fmul_rn(c, ur), __fmul_rn(s, ui));
    ps[(2 * m + 1) * nps + u] = __fsub_rn(__fmul_rn(c, ui), __fmul_rn(s, ur));
  }
  __syncthreads();
}

// Fine timing and clock tracking (fsk.c:677-731) into cy: norm, low, fract,
// nin (the block's nin_next) and ppm.  Ends with a barrier.
template <int M>
__device__ void timing(const ScanArgs& a, const float* ps, float* red,
                       Carry* cy) {
  const int P = a.p, nps = (a.nsym + 2) * P, ni = (a.nsym + 1) * P;
  float are = 0.f, aim = 0.f;
  for (int i = threadIdx.x; i < ni; i += kThreads) {
    float ft = 0.f;
    for (int m = 0; m < M; ++m) {
      const float fr = dump(ps + 2 * m * nps, i, P);
      const float fi = dump(ps + (2 * m + 1) * nps, i, P);
      ft = __fadd_rn(ft, __fadd_rn(__fmul_rn(fr, fr), __fmul_rn(fi, fi)));
    }
    are += ft * a.rot[i];
    aim += ft * a.rot[ni + i];
  }
  block_sum2(are, aim, red);
  if (threadIdx.x == 0) {
    const float norm = __fdiv_rn(atan2f(aim, are), kTwoPi);
    const float rx = __fmul_rn(norm, static_cast<float>(P));
    const float d = __fsub_rn(norm, cy->timing);
    const float appm =
        __fdiv_rn(__fmul_rn(1e6f, d), static_cast<float>(a.nsym));
    if (fabsf(d) < 0.2f)
      cy->ppm = __fadd_rn(__fmul_rn(0.9f, cy->ppm), __fmul_rn(0.1f, appm));
    const int half = a.ts / 2;
    cy->nin = a.nsym * a.ts + (norm > 0.25f ? half : 0) -
              (norm < -0.25f ? half : 0);
    int low = static_cast<int>(floorf(rx));
    cy->fract = __fsub_rn(rx, static_cast<float>(low));
    if (low < -(P / 2 + 1)) low = -(P / 2 + 1);
    if (low > P / 2) low = P / 2;
    cy->low = low;
    cy->norm = norm;
  }
  __syncthreads();
}

// Resample the integrators at the timing estimate, write block b's hard
// bits, soft decisions (and tmag), and return sum(mx), sum(mx^2) over the
// symbols (mx: the largest tone magnitude) to every thread.
template <int M>
__device__ void resample(const ScanArgs& a, int c, int b, const float* ps,
                         float* red, const Carry* cy, float* smx,
                         float* smx2) {
  constexpr int BPS = M == 2 ? 1 : 2;
  const int P = a.p, nsym = a.nsym, nps = (nsym + 2) * P;
  const int low = cy->low;
  const float fr = cy->fract, om = __fsub_rn(1.f, fr);
  const long long row = static_cast<long long>(a.nb) * nsym * BPS;
  float* soft = a.soft + c * row + static_cast<long long>(b) * nsym * BPS;
  unsigned char* bits =
      a.bits + c * row + static_cast<long long>(b) * nsym * BPS;
  float s1 = 0.f, s2 = 0.f;
  for (int k = threadIdx.x; k < nsym; k += kThreads) {
    const int i0 = (k + 1) * P + low;
    float tm[M];
#pragma unroll
    for (int m = 0; m < M; ++m) {
      const float* re = ps + 2 * m * nps;
      const float* im = re + nps;
      const float vr = __fadd_rn(__fmul_rn(dump(re, i0, P), om),
                                 __fmul_rn(dump(re, i0 + 1, P), fr));
      const float vi = __fadd_rn(__fmul_rn(dump(im, i0, P), om),
                                 __fmul_rn(dump(im, i0 + 1, P), fr));
      tm[m] = sqrtf(__fadd_rn(__fmul_rn(vr, vr), __fmul_rn(vi, vi)));
    }
    int sym = 0;
    float mx = tm[0];
#pragma unroll
    for (int m = 1; m < M; ++m)
      if (tm[m] > mx) {
        mx = tm[m];
        sym = m;
      }
    if constexpr (M == 2) {
      bits[k] = static_cast<unsigned char>(sym);
      soft[k] = __fsub_rn(tm[0], tm[1]);
    } else {
      bits[2 * k] = static_cast<unsigned char>((sym >> 1) & 1);
      bits[2 * k + 1] = static_cast<unsigned char>(sym & 1);
      soft[2 * k] = __fadd_rn(__fadd_rn(__fsub_rn(-tm[0], tm[1]), tm[2]),
                              tm[3]);
      soft[2 * k + 1] = __fadd_rn(__fsub_rn(__fadd_rn(-tm[0], tm[1]), tm[2]),
                                  tm[3]);
    }
    if (a.probe_tmag) {
#pragma unroll
      for (int m = 0; m < M; ++m)
        a.probe_tmag[((static_cast<long long>(c) * a.nb + b) * M + m) * nsym +
                     k] = tm[m];
    }
    s1 += mx;
    s2 += mx * mx;
  }
  block_sum2(s1, s2, red);
  *smx = s1;
  *smx2 = s2;
}

// Channel c's whole scan, buffered or unbuffered (a.unbuffered, then with
// one window buffer): every demod block, the carry held in shared memory.
// smem: scan_map(a, a.stages).total floats.  Every thread of the block
// calls it.
template <int LOG2N, int M>
__device__ void scan_channel(const ScanArgs& a, int c, float* smem) {
  using S = SpecPlan<LOG2N>;
  constexpr int N = S::N;
  const int tid = threadIdx.x;
  const ScanMap mp = scan_map(a, a.stages);
  float* buf = smem + mp.buf;
  float* tc = smem + mp.tc;
  float* tsn = tc + (S::F::PN);
  float* win = smem + mp.win;
  float* rows = smem + mp.rows;
  float* sf = smem + mp.sf;
  float* s = smem + mp.s;
  float* ps = smem + mp.ps;
  float* nco = smem + mp.nco;
  float* red = smem + mp.red;
  int* redi = reinterpret_cast<int*>(red + 2 * kThreads);
  Carry* cy = reinterpret_cast<Carry*>(smem + mp.carry);
  const int n = a.nsym * a.ts, nmem = n + 2 * a.ts, w = nmem + a.slack;
  const float* xc = a.x + static_cast<long long>(c) * 2 * a.T;

  stage_table<LOG2N>(a.tw, tc, tsn);
  for (int k = tid; k < N; k += kThreads) {
    win[k] = a.win[k];
    sf[k] = a.sf_in[c * N + k];
  }
  if (tid == 0) {
    cy->off = a.off0;
    cy->ptr = a.ptr_in[c];
    cy->timing = a.timing_in[c];
    cy->ppm = a.ppm_in[c];
    cy->nin = n;
  }
  load_buffer(buf, xc, a.T,
              a.unbuffered ? window_start(a.ptr_in[c], nmem, a.T) : 0, w);
  async_commit();
  for (int b = 0; b < a.nb; ++b) {
    float* cur = buf + (a.stages == 2 ? (b & 1) : 0) * 2 * w;
    if (a.stages == 2 && b + 1 < a.nb) {   // the next buffer in flight
      load_buffer(buf + ((b + 1) & 1) * 2 * w, xc, a.T,
                  static_cast<long long>(b + 1) * n, w);
      async_commit();
      async_wait<1>();
    } else {
      async_wait<0>();
    }
    __syncthreads();
    const float* xr = cur + cy->off;
    const float* xi = xr + w;

    spectral_pass<LOG2N>(xr, xi, a.starts, a.weights, a.nf, win, a.decay, sf,
                         sf, tc, tsn, rows);
    if (a.probe_sf)
      for (int k = tid; k < N; k += kThreads)
        a.probe_sf[(static_cast<long long>(c) * a.nb + b) * N + k] = sf[k];
    estimate<M>(a, sf, s, red, redi, cy);
    nco_tables<M>(a, cy, nco);
    downconvert<M>(a, xr, xi, nco, ps);
    timing<M>(a, ps, red, cy);
    float s1, s2;
    resample<M>(a, c, b, ps, red, cy, &s1, &s2);

    if (tid == 0) {                 // Eb/N0 (fsk.c:806-833), the carry
      const float inv = static_cast<float>(a.nsym);
      const float mean = __fdiv_rn(s1, inv), mean2 = __fdiv_rn(s2, inv);
      const float var = __fsub_rn(mean2, __fmul_rn(mean, mean));
      const float sd = sqrtf(var > 0.f ? var : 0.f);
      const float eb = __fadd_rn(
          -6.f, __fmul_rn(20.f, log10f(__fdiv_rn(__fadd_rn(1e-6f, mean),
                                                 __fadd_rn(1e-6f, sd)))));
      const long long cb = static_cast<long long>(c) * a.nb + b;
      for (int m = 0; m < M; ++m) a.f_est[cb * M + m] = cy->fest[m];
      a.ebno[cb] = eb;
      a.ppm_blocks[cb] = cy->ppm;
      if (a.probe_timing) a.probe_timing[cb] = cy->norm;
      cy->timing = cy->norm;
      cy->ptr += cy->nin;
      if (!a.unbuffered) {
        int off = cy->off + (cy->nin - n);
        if (off > a.off_max) off -= a.wrap;
        if (off < 0) off += a.wrap;
        cy->off = off < 0 ? 0 : (off > a.off_max ? a.off_max : off);
      }
    }
    __syncthreads();                // cur and the scratch are free
    if (a.stages == 1 && b + 1 < a.nb) {
      load_buffer(buf, xc, a.T,
                  a.unbuffered ? window_start(cy->ptr, nmem, a.T)
                               : static_cast<long long>(b + 1) * n,
                  w);
      async_commit();
    }
  }
  for (int k = tid; k < N; k += kThreads) a.sf[c * N + k] = sf[k];
  if (tid == 0) {
    a.timing[c] = cy->timing;
    a.ppm[c] = cy->ppm;
    a.ptr[c] = cy->ptr;
    a.nin[c] = cy->nin;
  }
}

}  // namespace fsk
}  // namespace rsx

// Runs the FSK scan of csrc/fsk_block.cuh (scan_channel, the body
// of csrc/fsk_scan.cu's kernel) on the CPU: every channel a block of 256
// host threads (see cuda_runtime.h beside this file).
//
//   fsk_scan_host IN OUT STAGES
//
// IN holds the C entry's operands as the Python wrapper builds them
// (demod/fsk.py::_scan_operands): int32 count, then per pointer slot an
// int64 byte count (0: NULL) and the bytes; int32 count and the ints;
// int32 count and the floats.  The output slots come zero-filled.  OUT
// gets every pointer slot back in the same form.  STAGES: window buffers
// in shared memory, 1 or 2 (the kernel takes 2 where they fit; the
// unbuffered scan takes 1).  Shared
// memory starts as NaN, so a read before a write shows in the outputs.
#include "cuda_runtime.h"

thread_local ShimIdx threadIdx, blockIdx, gridDim;
pthread_barrier_t shim_barrier;

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <limits>
#include <thread>
#include <vector>

#include "fsk_block.cuh"

using namespace rsx::fsk;

template <class T>
static bool get(FILE* f, T* v, size_t n = 1) {
  return fread(v, sizeof(T), n, f) == n;
}

template <int L, int M>
static void run(const ScanArgs& a) {
  const ScanMap mp = scan_map(a, a.stages);
  std::vector<float> smem(mp.total, std::numeric_limits<float>::quiet_NaN());
  for (int c = 0; c < a.C; ++c) {
    for (auto& v : smem) v = std::numeric_limits<float>::quiet_NaN();
    pthread_barrier_init(&shim_barrier, nullptr, kThreads);
    std::vector<std::thread> threads;
    for (int t = 0; t < kThreads; ++t)
      threads.emplace_back([&, t, c] {
        threadIdx.x = t;
        blockIdx.x = c;
        gridDim.x = a.C;
        scan_channel<L, M>(a, c, smem.data());
      });
    for (auto& th : threads) th.join();
    pthread_barrier_destroy(&shim_barrier);
  }
}

int main(int argc, char** argv) {
  if (argc != 4) return 2;
  FILE* f = fopen(argv[1], "rb");
  if (!f) return 2;
  int32_t np = 0, ni = 0, nf = 0;
  if (!get(f, &np) || np != kScanPtrs) return 3;
  std::vector<std::vector<char>> bufs(np);
  std::vector<const void*> ptrs(np);
  for (int i = 0; i < np; ++i) {
    int64_t nb = 0;
    if (!get(f, &nb)) return 3;
    bufs[i].resize(nb);
    if (nb && !get(f, bufs[i].data(), nb)) return 3;
    ptrs[i] = nb ? bufs[i].data() : nullptr;
  }
  if (!get(f, &ni) || ni != kScanInts) return 3;
  std::vector<int> geo(ni);
  if (!get(f, geo.data(), ni)) return 3;
  if (!get(f, &nf) || nf != kScanFloats) return 3;
  std::vector<float> fgeo(nf);
  if (!get(f, fgeo.data(), nf)) return 3;
  fclose(f);
  ScanArgs a = scan_args(ptrs.data(), geo.data(), fgeo.data());
  a.stages = std::atoi(argv[3]);
  if (a.stages != 1 && a.stages != 2) return 2;
  if (a.unbuffered && a.stages != 1) return 2;   // as the C entry
  const int key = a.ndft * 10 + a.m;
  switch (key) {
    case 642: run<6, 2>(a); break;
    case 644: run<6, 4>(a); break;
    case 1282: run<7, 2>(a); break;
    case 1284: run<7, 4>(a); break;
    case 2562: run<8, 2>(a); break;
    case 2564: run<8, 4>(a); break;
    case 5122: run<9, 2>(a); break;
    case 5124: run<9, 4>(a); break;
    default: return 4;
  }
  FILE* o = fopen(argv[2], "wb");
  if (!o) return 2;
  for (int i = 0; i < np; ++i) {
    const int64_t nb = bufs[i].size();
    fwrite(&nb, sizeof nb, 1, o);
    fwrite(bufs[i].data(), 1, nb, o);
  }
  fclose(o);
  std::printf("%lld floats of shared memory\n",
              static_cast<long long>(scan_map(a, a.stages).total));
  return 0;
}

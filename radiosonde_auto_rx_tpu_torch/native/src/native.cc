// Host-side native runtime for radiosonde_auto_rx_tpu.
//
// The reference runs its sample path as a shell pipeline of C processes
// (reference auto_rx/autorx/decode.py:1500-1529); per-decoder input
// conversion is re-implemented in every binary (demod/mod/demod_mod.c
// f32read_csample / f32read_cblock).  Here the host boundary is one native
// library driven from Python via ctypes:
//
//   * IQ wire-format conversion (cu8 / cs16 / interleaved f32 -> planar
//     float32 I/Q) — the single host->device format conversion point.
//   * A lock-free SPSC byte ring buffer with an fd-pump thread — the IO
//     executor that replaces pipe backpressure between capture process and
//     Python (reference utils.py AsynchronousFileReader :380).
//   * Packed-bit header correlation (popcount) — host framing hot path
//     (reference demod/mod/demod_mod.c find_header :1533 searches
//     bit-by-bit; here one XOR+popcount per 64-bit word with early exit).
//
// Plain C ABI, no pybind11 (not in image); loaded with ctypes.

#include <atomic>
#include <cerrno>
#include <chrono>
#include <cstdint>
#include <cstring>
#include <new>
#include <thread>

#include <poll.h>
#include <unistd.h>

extern "C" {

// ---------------------------------------------------------------------------
// IQ wire-format conversion
// ---------------------------------------------------------------------------

// rtl_sdr unsigned 8-bit IQ: x -> (x - 127.5) / 128, LUT per byte.
void rsx_cu8_to_planes(const uint8_t* in, float* I, float* Q, size_t n) {
    static const struct Lut {
        float v[256];
        Lut() {
            for (int i = 0; i < 256; i++) v[i] = (float(i) - 127.5f) / 128.0f;
        }
    } lut;  // magic static: thread-safe init
    for (size_t k = 0; k < n; k++) {
        I[k] = lut.v[in[2 * k]];
        Q[k] = lut.v[in[2 * k + 1]];
    }
}

// Signed 16-bit little-endian IQ (rtl_fm -M raw / ss_iq / pcmrecord): /32768.
void rsx_cs16_to_planes(const int16_t* in, float* I, float* Q, size_t n) {
    constexpr float s = 1.0f / 32768.0f;
    for (size_t k = 0; k < n; k++) {
        I[k] = float(in[2 * k]) * s;
        Q[k] = float(in[2 * k + 1]) * s;
    }
}

// Interleaved complex float32 -> planes (deinterleave only).
void rsx_f32c_to_planes(const float* in, float* I, float* Q, size_t n) {
    for (size_t k = 0; k < n; k++) {
        I[k] = in[2 * k];
        Q[k] = in[2 * k + 1];
    }
}

// Mono signed 16-bit (FM-audio chains, rtl_fm output) -> float32 /32768.
void rsx_s16_to_f32(const int16_t* in, float* out, size_t n) {
    constexpr float s = 1.0f / 32768.0f;
    for (size_t k = 0; k < n; k++) out[k] = float(in[k]) * s;
}

// ---------------------------------------------------------------------------
// SPSC ring buffer + fd pump thread
// ---------------------------------------------------------------------------
//
// Single producer (the pump thread, or rsx_rb_write) / single consumer
// (rsx_rb_read from Python).  head/tail are monotonically increasing byte
// counters; the index is counter % cap.  Producer blocks when full
// (backpressure up the capture pipe — same policy as a POSIX pipe, which is
// what the reference relies on); consumer blocks up to a timeout.

struct RsxRing {
    uint8_t* buf;
    size_t cap;
    std::atomic<uint64_t> head{0};   // total bytes written
    std::atomic<uint64_t> tail{0};   // total bytes read
    std::atomic<bool> eof{false};    // producer saw EOF / was stopped
    std::atomic<bool> stop{false};   // request pump shutdown
    int fd = -1;
    std::thread pump;
};

static void rsx_rb_copy_in(RsxRing* rb, const uint8_t* src, size_t n) {
    uint64_t h = rb->head.load(std::memory_order_relaxed);
    size_t i = size_t(h % rb->cap);
    size_t first = n < rb->cap - i ? n : rb->cap - i;
    memcpy(rb->buf + i, src, first);
    memcpy(rb->buf, src + first, n - first);
    rb->head.store(h + n, std::memory_order_release);
}

void* rsx_rb_create(size_t capacity) {
    RsxRing* rb = new RsxRing();
    rb->cap = capacity;
    rb->buf = new uint8_t[capacity];
    return rb;
}

// Producer-side write (used directly for in-process producers and tests).
// Blocks while the ring is full unless the consumer stopped; returns bytes
// accepted (== n, or less only after stop).
size_t rsx_rb_write(void* h, const uint8_t* src, size_t n) {
    RsxRing* rb = static_cast<RsxRing*>(h);
    size_t done = 0;
    while (done < n && !rb->stop.load(std::memory_order_relaxed)) {
        uint64_t used = rb->head.load(std::memory_order_relaxed) -
                        rb->tail.load(std::memory_order_acquire);
        size_t space = rb->cap - size_t(used);
        if (space == 0) {
            std::this_thread::sleep_for(std::chrono::microseconds(200));
            continue;
        }
        size_t chunk = n - done < space ? n - done : space;
        rsx_rb_copy_in(rb, src + done, chunk);
        done += chunk;
    }
    return done;
}

static void rsx_pump_main(RsxRing* rb) {
    // Read the fd in <=64 KiB slices straight into ring space.
    constexpr size_t SLICE = 64 * 1024;
    uint8_t tmp[SLICE];
    while (!rb->stop.load(std::memory_order_relaxed)) {
        uint64_t used = rb->head.load(std::memory_order_relaxed) -
                        rb->tail.load(std::memory_order_acquire);
        size_t space = rb->cap - size_t(used);
        if (space == 0) {  // full: backpressure the pipe
            std::this_thread::sleep_for(std::chrono::microseconds(200));
            continue;
        }
        size_t want = space < SLICE ? space : SLICE;
        // poll so a stop request interrupts an otherwise-blocking read
        struct pollfd pfd = {rb->fd, POLLIN, 0};
        int pr = poll(&pfd, 1, 100);
        if (pr < 0) {
            if (errno == EINTR) continue;
            break;
        }
        if (pr == 0) continue;  // timeout: re-check stop flag
        ssize_t got = read(rb->fd, tmp, want);
        if (got < 0) {
            if (errno == EINTR) continue;
            break;  // fd error == EOF for the consumer
        }
        if (got == 0) break;  // EOF
        rsx_rb_copy_in(rb, tmp, size_t(got));
    }
    rb->eof.store(true, std::memory_order_release);
}

int rsx_rb_start_pump(void* h, int fd) {
    RsxRing* rb = static_cast<RsxRing*>(h);
    if (rb->pump.joinable()) return -1;
    rb->fd = fd;
    rb->pump = std::thread(rsx_pump_main, rb);
    return 0;
}

// Consumer read: up to `want` bytes, blocking until at least one byte, EOF,
// or timeout_ms elapses (timeout_ms < 0: wait forever). Returns bytes read;
// 0 means EOF-and-drained or timeout (check rsx_rb_eof to distinguish).
size_t rsx_rb_read(void* h, uint8_t* dst, size_t want, int timeout_ms) {
    RsxRing* rb = static_cast<RsxRing*>(h);
    auto deadline = std::chrono::steady_clock::now() +
                    std::chrono::milliseconds(timeout_ms < 0 ? 0 : timeout_ms);
    for (;;) {
        uint64_t t = rb->tail.load(std::memory_order_relaxed);
        uint64_t avail = rb->head.load(std::memory_order_acquire) - t;
        if (avail > 0) {
            size_t n = want < avail ? want : size_t(avail);
            size_t i = size_t(t % rb->cap);
            size_t first = n < rb->cap - i ? n : rb->cap - i;
            memcpy(dst, rb->buf + i, first);
            memcpy(dst + first, rb->buf, n - first);
            rb->tail.store(t + n, std::memory_order_release);
            return n;
        }
        if (rb->eof.load(std::memory_order_acquire)) return 0;
        if (timeout_ms >= 0 && std::chrono::steady_clock::now() >= deadline)
            return 0;
        std::this_thread::sleep_for(std::chrono::microseconds(200));
    }
}

uint64_t rsx_rb_available(void* h) {
    RsxRing* rb = static_cast<RsxRing*>(h);
    return rb->head.load(std::memory_order_acquire) -
           rb->tail.load(std::memory_order_acquire);
}

int rsx_rb_eof(void* h) {
    RsxRing* rb = static_cast<RsxRing*>(h);
    return rb->eof.load(std::memory_order_acquire) ? 1 : 0;
}

uint64_t rsx_rb_total_in(void* h) {
    return static_cast<RsxRing*>(h)->head.load(std::memory_order_acquire);
}

// Signal producer EOF without destroying (in-process producer done).
void rsx_rb_close_write(void* h) {
    static_cast<RsxRing*>(h)->eof.store(true, std::memory_order_release);
}

void rsx_rb_stop(void* h) {
    RsxRing* rb = static_cast<RsxRing*>(h);
    rb->stop.store(true, std::memory_order_release);
    rb->eof.store(true, std::memory_order_release);
    if (rb->pump.joinable()) rb->pump.join();
}

void rsx_rb_destroy(void* h) {
    RsxRing* rb = static_cast<RsxRing*>(h);
    rsx_rb_stop(rb);
    delete[] rb->buf;
    delete rb;
}

// ---------------------------------------------------------------------------
// Packed-bit header correlation
// ---------------------------------------------------------------------------
//
// bits: one byte per bit (0/1), length n.  header: one byte per bit, length
// hlen (<= 4096).  Finds every offset where the header matches with
// <= max_err bit errors.  Strategy: pack the stream and the header into
// 64-bit words; for each offset, XOR the realigned stream words against the
// packed header and popcount with early exit.  Worst case O(n*hlen/64);
// random data exits after ~1 word.

static inline uint64_t rsx_word_at(const uint64_t* w, size_t nwords,
                                   size_t word, unsigned shift) {
    uint64_t lo = word < nwords ? w[word] : 0;
    if (shift == 0) return lo;
    uint64_t hi = word + 1 < nwords ? w[word + 1] : 0;
    return (lo >> shift) | (hi << (64 - shift));
}

// Returns the number of hits written to out_pos/out_err (capped max_out).
size_t rsx_bitcorr(const uint8_t* bits, size_t n, const uint8_t* header,
                   size_t hlen, int max_err, int64_t* out_pos,
                   int32_t* out_err, size_t max_out) {
    if (hlen == 0 || n < hlen) return 0;
    size_t nw = (n + 63) / 64;
    size_t hw = (hlen + 63) / 64;
    uint64_t* sw = new uint64_t[nw]();
    uint64_t* hwrd = new uint64_t[hw]();
    for (size_t i = 0; i < n; i++)
        if (bits[i]) sw[i / 64] |= (uint64_t(1) << (i % 64));
    for (size_t i = 0; i < hlen; i++)
        if (header[i]) hwrd[i / 64] |= (uint64_t(1) << (i % 64));
    uint64_t tail_mask = (hlen % 64) ? ((uint64_t(1) << (hlen % 64)) - 1)
                                     : ~uint64_t(0);
    size_t hits = 0;
    size_t last = n - hlen;
    for (size_t t = 0; t <= last && hits < max_out; t++) {
        unsigned shift = unsigned(t % 64);
        size_t word = t / 64;
        int err = 0;
        for (size_t j = 0; j < hw; j++) {
            uint64_t x = rsx_word_at(sw, nw, word + j, shift) ^ hwrd[j];
            if (j == hw - 1) x &= tail_mask;
            err += __builtin_popcountll(x);
            if (err > max_err) break;
        }
        if (err <= max_err) {
            out_pos[hits] = int64_t(t);
            out_err[hits] = err;
            hits++;
        }
    }
    delete[] sw;
    delete[] hwrd;
    return hits;
}

// ---------------------------------------------------------------------------
// Soft-bit frame assembly (find_softbinhead analogue for float streams)
// ---------------------------------------------------------------------------

// Hard-slice float soft bits (>0 -> 1) into a byte-per-bit buffer; used by
// the host frame plane before rsx_bitcorr.
void rsx_soft_to_bits(const float* soft, uint8_t* bits, size_t n,
                      int invert) {
    if (invert) {
        for (size_t i = 0; i < n; i++) bits[i] = soft[i] <= 0.0f;
    } else {
        for (size_t i = 0; i < n; i++) bits[i] = soft[i] > 0.0f;
    }
}

// ---------------------------------------------------------------------------
// Rate-1/2 K=7 soft Viterbi (LMS6 conv code)
// ---------------------------------------------------------------------------

// Same trellis as ecc/viterbi.py (polys 0x4F/0x6D per reference
// demod/mod/lms6Xmod.c:115-117): extended index n = 2*state + bit (7 bits),
// expected pair (cA,cB) = parity(POLY&n).  Branch metric uses the
// correlation form -(cA'*sA + cB'*sB), which differs from the python
// squared-distance metric only by a per-step constant common to all
// branches — identical decisions.  soft: [2T] floats; out: [T] hard bits.
// Returns 0 on success, -1 on alloc failure.
int rsx_viterbi_k7(const float* soft, int64_t npairs, uint8_t* out) {
    const int M = 64;
    // magic static: C++11 guarantees thread-safe one-time init (ctypes
    // releases the GIL, so two Python threads CAN race a first call —
    // the bare `static int init` flag pattern here was UB)
    struct Code {
        uint8_t v[2 * 64];
        Code() {
            for (int n = 0; n < 2 * 64; n++) {
                int a = __builtin_parity(0x4F & n);
                int b = __builtin_parity(0x6D & n);
                v[n] = uint8_t((a << 1) | b);
            }
        }
    };
    static const Code code_s;
    const uint8_t* code = code_s.v;
    int64_t T = npairs / 2;
    if (T <= 0) return 0;
    uint8_t* back = new (std::nothrow) uint8_t[size_t(T) * M];
    if (!back) return -1;
    float pw[M], npw[M];
    const float INF = 1e30f;
    for (int k = 1; k < M; k++) pw[k] = INF;
    pw[0] = 0.0f;
    for (int64_t t = 0; t < T; t++) {
        float sA = soft[2 * t], sB = soft[2 * t + 1];
        // bm[(a<<1)|b] = -((2a-1)*sA + (2b-1)*sB)
        float bm[4] = {sA + sB, sA - sB, -sA + sB, -sA - sB};
        uint8_t* bt = back + size_t(t) * M;
        for (int k = 0; k < M; k++) {
            float lo = pw[k >> 1] + bm[code[k]];
            float hi = pw[(k + M) >> 1] + bm[code[k + M]];
            if (hi < lo) {
                npw[k] = hi;
                bt[k] = uint8_t(k + M);
            } else {
                npw[k] = lo;
                bt[k] = uint8_t(k);
            }
        }
        memcpy(pw, npw, sizeof(pw));
    }
    int j = 0;
    for (int k = 1; k < M; k++)
        if (pw[k] < pw[j]) j = k;
    for (int64_t t = T - 1; t >= 0; t--) {
        uint8_t ext = back[size_t(t) * M + j];
        out[t] = ext & 1;
        j = ext >> 1;
    }
    delete[] back;
    return 0;
}

int rsx_abi_version(void) { return 1; }

}  // extern "C"

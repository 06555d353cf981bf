"""ctypes bindings for the native host runtime (see src/native.cc).

Exposes:
  * ``available()`` — True when _libnative.so loaded.
  * IQ conversions ``cu8_to_planes`` / ``cs16_to_planes`` /
    ``f32c_to_planes`` / ``s16_to_f32``.
  * ``RingBuffer`` — SPSC byte ring with optional fd-pump thread; the
    host IO executor between capture processes and the device feeder
    (replaces reference pipe chains, decode.py:1500-1529).
  * ``find_headers`` — packed-bit popcount header search (replaces
    reference demod_mod.c find_header :1533 per-sample loop).

Every entry point has a NumPy fallback in its caller; nothing here is
required for correctness, only for host-path speed.
"""

import ctypes
import threading

import numpy as np

from . import _build

_lib = None
_load_lock = threading.Lock()
_load_tried = False


def _load():
    global _lib, _load_tried
    if _lib is not None or _load_tried:
        return _lib
    with _load_lock:
        if _lib is not None or _load_tried:
            return _lib
        _load_tried = True
        path = _build.build()
        if path is None:
            return None
        try:
            lib = ctypes.CDLL(str(path))
        except OSError:
            return None
        u8p = ctypes.POINTER(ctypes.c_uint8)
        i16p = ctypes.POINTER(ctypes.c_int16)
        f32p = ctypes.POINTER(ctypes.c_float)
        lib.rsx_cu8_to_planes.argtypes = [u8p, f32p, f32p, ctypes.c_size_t]
        lib.rsx_cs16_to_planes.argtypes = [i16p, f32p, f32p, ctypes.c_size_t]
        lib.rsx_f32c_to_planes.argtypes = [f32p, f32p, f32p, ctypes.c_size_t]
        lib.rsx_s16_to_f32.argtypes = [i16p, f32p, ctypes.c_size_t]
        lib.rsx_rb_create.restype = ctypes.c_void_p
        lib.rsx_rb_create.argtypes = [ctypes.c_size_t]
        lib.rsx_rb_start_pump.argtypes = [ctypes.c_void_p, ctypes.c_int]
        lib.rsx_rb_write.restype = ctypes.c_size_t
        lib.rsx_rb_write.argtypes = [ctypes.c_void_p, u8p, ctypes.c_size_t]
        lib.rsx_rb_read.restype = ctypes.c_size_t
        lib.rsx_rb_read.argtypes = [ctypes.c_void_p, u8p, ctypes.c_size_t,
                                    ctypes.c_int]
        lib.rsx_rb_available.restype = ctypes.c_uint64
        lib.rsx_rb_available.argtypes = [ctypes.c_void_p]
        lib.rsx_rb_eof.restype = ctypes.c_int
        lib.rsx_rb_eof.argtypes = [ctypes.c_void_p]
        lib.rsx_rb_total_in.restype = ctypes.c_uint64
        lib.rsx_rb_total_in.argtypes = [ctypes.c_void_p]
        lib.rsx_rb_close_write.argtypes = [ctypes.c_void_p]
        lib.rsx_rb_stop.argtypes = [ctypes.c_void_p]
        lib.rsx_rb_destroy.argtypes = [ctypes.c_void_p]
        lib.rsx_bitcorr.restype = ctypes.c_size_t
        lib.rsx_bitcorr.argtypes = [u8p, ctypes.c_size_t, u8p,
                                    ctypes.c_size_t, ctypes.c_int,
                                    ctypes.POINTER(ctypes.c_int64),
                                    ctypes.POINTER(ctypes.c_int32),
                                    ctypes.c_size_t]
        lib.rsx_soft_to_bits.argtypes = [f32p, u8p, ctypes.c_size_t,
                                         ctypes.c_int]
        lib.rsx_viterbi_k7.restype = ctypes.c_int
        lib.rsx_viterbi_k7.argtypes = [f32p, ctypes.c_int64, u8p]
        _lib = lib
    return _lib


def available() -> bool:
    return _load() is not None


def _as_ptr(arr, ctype):
    return arr.ctypes.data_as(ctypes.POINTER(ctype))


def cu8_to_planes(buf: bytes) -> np.ndarray:
    lib = _load()
    raw = np.frombuffer(buf, dtype=np.uint8)
    n = len(raw) // 2
    out = np.empty((2, n), np.float32)
    lib.rsx_cu8_to_planes(_as_ptr(raw, ctypes.c_uint8),
                          _as_ptr(out[0], ctypes.c_float),
                          _as_ptr(out[1], ctypes.c_float), n)
    return out


def cs16_to_planes(buf: bytes) -> np.ndarray:
    lib = _load()
    raw = np.frombuffer(buf, dtype="<i2")
    n = len(raw) // 2
    out = np.empty((2, n), np.float32)
    lib.rsx_cs16_to_planes(_as_ptr(raw, ctypes.c_int16),
                           _as_ptr(out[0], ctypes.c_float),
                           _as_ptr(out[1], ctypes.c_float), n)
    return out


def f32c_to_planes(buf: bytes) -> np.ndarray:
    lib = _load()
    raw = np.frombuffer(buf, dtype="<f4")
    n = len(raw) // 2
    out = np.empty((2, n), np.float32)
    lib.rsx_f32c_to_planes(_as_ptr(raw, ctypes.c_float),
                           _as_ptr(out[0], ctypes.c_float),
                           _as_ptr(out[1], ctypes.c_float), n)
    return out


def s16_to_f32(buf: bytes) -> np.ndarray:
    lib = _load()
    raw = np.frombuffer(buf, dtype="<i2")
    out = np.empty(len(raw), np.float32)
    lib.rsx_s16_to_f32(_as_ptr(raw, ctypes.c_int16),
                       _as_ptr(out, ctypes.c_float), len(raw))
    return out


def find_headers(bits01: np.ndarray, header01: np.ndarray, max_errors: int,
                 max_out: int = 4096):
    """All offsets t where header01 matches bits01[t:t+H] with <= max_errors
    bit errors.  Returns (positions int64 [k], errors int32 [k])."""
    lib = _load()
    bits = np.ascontiguousarray(bits01, dtype=np.uint8)
    hdr = np.ascontiguousarray(header01, dtype=np.uint8)
    pos = np.empty(max_out, np.int64)
    err = np.empty(max_out, np.int32)
    k = lib.rsx_bitcorr(_as_ptr(bits, ctypes.c_uint8), len(bits),
                        _as_ptr(hdr, ctypes.c_uint8), len(hdr),
                        int(max_errors),
                        pos.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
                        err.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
                        max_out)
    return pos[:k].copy(), err[:k].copy()


def viterbi_k7(soft_pairs: np.ndarray) -> np.ndarray:
    """Rate-1/2 K=7 soft Viterbi (LMS6): soft pairs [2T] -> hard bits [T].
    Same trellis/decisions as ecc.viterbi.viterbi_decode."""
    lib = _load()
    s = np.ascontiguousarray(soft_pairs, dtype=np.float32)
    T = len(s) // 2
    out = np.empty(T, np.uint8)
    if lib.rsx_viterbi_k7(_as_ptr(s, ctypes.c_float), len(s),
                          _as_ptr(out, ctypes.c_uint8)) != 0:
        raise MemoryError("viterbi traceback alloc failed")
    return out


def soft_to_bits(soft: np.ndarray, invert: bool = False) -> np.ndarray:
    lib = _load()
    s = np.ascontiguousarray(soft, dtype=np.float32)
    out = np.empty(len(s), np.uint8)
    lib.rsx_soft_to_bits(_as_ptr(s, ctypes.c_float),
                         _as_ptr(out, ctypes.c_uint8), len(s), int(invert))
    return out


class RingBuffer:
    """SPSC byte ring.  Producer: ``start_pump(fd)`` (background thread
    reads the fd until EOF, blocking when full — pipe-style backpressure)
    or in-process ``write()``.  Consumer: ``read(n, timeout)``/
    ``read_exact``.  Use as a context manager to guarantee teardown."""

    def __init__(self, capacity: int = 1 << 22):
        lib = _load()
        if lib is None:
            raise RuntimeError("native runtime unavailable")
        self._lib = lib
        self._h = ctypes.c_void_p(lib.rsx_rb_create(capacity))
        self.capacity = capacity

    def start_pump(self, fd: int):
        if self._lib.rsx_rb_start_pump(self._handle(), fd) != 0:
            raise RuntimeError("pump already running")
        return self

    def _handle(self):
        # a closed buffer must raise in Python, not pass NULL into C
        # (a NULL RsxRing* dereference takes down the whole station)
        if self._h is None:
            raise ValueError("RingBuffer is closed")
        return self._h

    def write(self, data: bytes) -> int:
        buf = (ctypes.c_uint8 * len(data)).from_buffer_copy(data)
        return self._lib.rsx_rb_write(self._handle(), buf, len(data))

    def close_write(self):
        self._lib.rsx_rb_close_write(self._handle())

    def read(self, want: int, timeout_ms: int = -1) -> bytes:
        out = np.empty(want, np.uint8)
        n = self._lib.rsx_rb_read(self._handle(),
                                  _as_ptr(out, ctypes.c_uint8),
                                  want, timeout_ms)
        return out[:n].tobytes()

    def read_exact(self, want: int, timeout_ms: int = -1) -> bytes:
        """Accumulate exactly `want` bytes; shorter only at EOF/timeout."""
        parts, got = [], 0
        while got < want:
            chunk = self.read(want - got, timeout_ms)
            if not chunk:
                break
            parts.append(chunk)
            got += len(chunk)
        return b"".join(parts)

    @property
    def eof(self) -> bool:
        return bool(self._lib.rsx_rb_eof(self._handle()))

    def available(self) -> int:
        return int(self._lib.rsx_rb_available(self._handle()))

    def total_in(self) -> int:
        return int(self._lib.rsx_rb_total_in(self._handle()))

    def close(self):
        if self._h:
            self._lib.rsx_rb_destroy(self._h)
            self._h = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


class PumpedReader:
    """File-like ``.read(nbytes)`` over a RingBuffer pumping an fd —
    drop-in for the ``stream`` argument of IQStreamSource so a slow Python
    consumer never stalls the capture process's pipe."""

    def __init__(self, fileobj_or_fd, capacity: int = 1 << 22,
                 timeout_ms: int = -1):
        self._fileobj = None
        if hasattr(fileobj_or_fd, "fileno"):
            self._fileobj = fileobj_or_fd  # keep a ref so the fd stays open
            fd = fileobj_or_fd.fileno()
        else:
            fd = int(fileobj_or_fd)
        self.timeout_ms = timeout_ms
        self.rb = RingBuffer(capacity).start_pump(fd)

    def read(self, n: int) -> bytes:
        return self.rb.read_exact(n, self.timeout_ms)

    def close(self):
        self.rb.close()

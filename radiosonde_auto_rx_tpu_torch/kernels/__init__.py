"""Build, load and count the port's CUDA kernels.

Every ``csrc/*.cu`` is compiled by ``nvcc`` for Hopper (``sm_90a``), one
``nvcc`` process per source, all started together, and the objects are
linked into ONE shared library with a plain C interface, loaded with
``ctypes`` (no PyTorch headers in the build, so it takes seconds, not
minutes).
The library lands in ``build/kernels/`` at the repository root, named
by a hash of the sources (``*.cu`` and the ``*.cuh`` headers they
include) and flags: an edited source or header rebuilds on first use, an
unchanged one is reused.  A failed build raises with nvcc's
output.

Each C entry point takes raw device pointers and the CUDA stream as
``void*`` and returns ``cudaGetLastError()`` after its launch; ``check``
turns a non-zero code into an exception.  Nothing here runs at import:
the CPU tests import every module of the port on machines without nvcc.

``launches`` counts kernel launches by name.  A wrapper adds one exactly
where it launches its kernel, so a run can show that its main path went
through the hand-written kernels.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC")

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_L = ctypes.c_longlong

# C symbol -> argtypes (every pointer and the stream as void*)
SIGNATURES = {
    # xw, sf, wc, starts, weights, decay, tw, out,
    # C, nmem, ndft, nf, device, stream
    "rsx_freq_est_sf": [_P, _P, _P, _P, _P, _F, _P, _P,
                        _I, _I, _I, _I, _I, _P],
    # pointers [23], ints [34], floats [4] (host arrays in the order of
    # demod/fsk.py's SCAN_POINTERS, SCAN_INTS, SCAN_FLOATS), device, stream
    "rsx_fsk_scan": [_P, _P, _P, _I, _P],
    # x, s_outer, s_seg, s_plane, nseg, rows, win, tw, out, n, shift,
    # device, stream
    "rsx_fft_abs2": [_P, _L, _L, _L, _I, _I, _P, _P, _P, _I, _I, _I, _P],
    # x, s_row, s_plane, rows, win (or NULL), tw, out, n, device, stream
    "rsx_fft_planes": [_P, _L, _L, _I, _P, _P, _P, _I, _I, _P],
    "rsx_error_string": [_I],
}

# "fsk_scan" counts both scan modes; "fsk_scan_unbuffered" the
# unbuffered one again
launches = {"freq_est_sf": 0, "fft_abs2": 0, "fft": 0, "fsk_scan": 0,
            "fsk_scan_unbuffered": 0}
build_log = {}                 # "ptxas": nvcc's -Xptxas -v report

_lock = threading.Lock()
_lib = None


def reset_launches():
    for name in launches:
        launches[name] = 0


def _sources():
    return sorted(CSRC.glob("*.cu"))


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or \
        "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME): the port's "
                           "CUDA kernels cannot be built")
    return found


def fingerprint() -> str:
    """Hash of the flags, the sources and the headers they include."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted([*_sources(), *CSRC.glob("*.cuh")]):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def library_path() -> Path:
    """Build the kernel library if its sources changed; return its path."""
    lib = BUILD_DIR / f"librsx_kernels-{fingerprint()}.so"
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        jobs = []
        for src in _sources():
            obj = str(Path(tmp) / f"{src.stem}.o")
            cmd = [nvcc, *NVCC_FLAGS, "-Xptxas", "-v", "-c", str(src),
                   "-o", obj]
            jobs.append((cmd, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                text=True)))
        logs = []
        for cmd, _, proc in jobs:
            out, err = proc.communicate()
            if proc.returncode:
                for _, _, other in jobs:
                    other.kill()
                    other.wait()
                raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                                   f"{' '.join(cmd)}\n{out}{err}")
            logs.append(err)
        so = str(Path(tmp) / "lib.so")
        cmd = [nvcc, *NVCC_FLAGS, "-shared", "-o", so,
               *[obj for _, obj, _ in jobs]]
        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode:
            raise RuntimeError(f"nvcc link failed ({res.returncode}):\n"
                               f"{' '.join(cmd)}\n{res.stdout}{res.stderr}")
        os.replace(so, lib)
    build_log["ptxas"] = "".join(logs)
    return lib


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first use)."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(library_path()))
            for name, argtypes in SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_char_p if name == "rsx_error_string" \
                    else ctypes.c_int
            _lib = lib
        return _lib


def check(err: int, what: str):
    """Raise if a C entry point returned a CUDA error code."""
    if err:
        msg = library().rsx_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")

"""Build the native host runtime (_libnative.so) with g++.

No pybind11 in the image, so the library is a plain C-ABI shared object
loaded via ctypes.  Built lazily on first import (and rebuilt when the
source is newer than the .so); set RSX_NATIVE_BUILD=0 to disable and run
pure-NumPy fallbacks everywhere.
"""

import os
import subprocess
import tempfile
from pathlib import Path

_HERE = Path(__file__).resolve().parent
SRC = _HERE / "src" / "native.cc"
LIB = _HERE / "_libnative.so"


def build(force: bool = False) -> Path | None:
    """Compile native.cc -> _libnative.so.  Returns the lib path, or None
    if building is disabled or fails (callers fall back to NumPy)."""
    if os.environ.get("RSX_NATIVE_BUILD", "1") == "0":
        return LIB if LIB.exists() else None
    if LIB.exists() and not force:
        if not SRC.exists():
            return LIB          # shipped .so without sources: use it
        if LIB.stat().st_mtime >= SRC.stat().st_mtime:
            return LIB
    if not SRC.exists():
        return None
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=_HERE)
    os.close(fd)
    cmd = ["g++", "-O3", "-std=c++17", "-shared", "-fPIC", "-pthread",
           str(SRC), "-o", tmp]
    for extra in (["-march=native"], []):
        try:
            subprocess.run(cmd[:2] + extra + cmd[2:], check=True,
                           capture_output=True, timeout=120)
            os.replace(tmp, LIB)  # atomic: concurrent importers see old or new
            return LIB
        except (subprocess.CalledProcessError, subprocess.TimeoutExpired,
                FileNotFoundError):
            continue
    try:
        os.unlink(tmp)
    except OSError:
        pass
    return None


if __name__ == "__main__":
    out = build(force=True)
    print(out if out else "native build FAILED")

"""Subprocess helpers: timeout prefix + asynchronous pipe reader.

Equivalents of the reference's process plumbing (reference
auto_rx/autorx/utils.py:53-80 `timeout_cmd`, :380-434
`AsynchronousFileReader`).  Capture subprocesses are always run under a
`timeout` prefix so a wedged SDR can never hang the station.

The reference's ``apply_platform_env`` (it selects the JAX backend) has
no counterpart here: the port picks its device on the command line.
"""

import platform
import shutil
import threading
import queue


def timeout_cmd() -> str:
    """The timeout binary for this platform (reference utils.py:53-80):
    plain `timeout -k 30` where available, `gtimeout` on macOS."""
    if platform.system() == "Darwin":
        return "gtimeout -k 30 "
    if shutil.which("timeout"):
        return "timeout -k 30 "
    return ""


class AsynchronousFileReader(threading.Thread):
    """Drain a pipe on a daemon thread into a queue so the caller can poll
    without blocking (reference utils.py:380-434)."""

    def __init__(self, fd, autostart: bool = True):
        threading.Thread.__init__(self)
        self.daemon = True
        self._fd = fd
        self._queue = queue.Queue()
        self._running = True
        if autostart:
            self.start()

    def run(self):
        while self._running:
            line = self._fd.readline()
            if not line:
                break
            self._queue.put(line)
        self._running = False

    def eof(self) -> bool:
        return not self.is_alive() and self._queue.empty()

    def stop(self):
        self._running = False

    def readlines(self):
        while not self._queue.empty():
            yield self._queue.get()

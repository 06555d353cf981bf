"""Modem-internal signal probing + profiler helpers.

Equivalent of the reference's modem_probe (reference utils/modem_probe.c,
hooks at utils/fsk.c:505,627-633,733-734,912-914): named internal-signal
buffers collected during a run and dumped for offline analysis.  Two
idiomatic-TPU differences:

* The demodulator is functional, so "probing" is not a global side
  channel inside the DSP — ``fsk_demod_stream(..., probe=True)`` returns
  the internal trajectories (EMA spectrum ``sf``, fine timing, per-tone
  magnitudes) as extra arrays.  This module is the host-side registry
  that accumulates those (or anything else) across calls and dumps them.
* The dump format is ``.npz`` instead of an Octave text file — loadable
  from numpy/Octave/Matlab alike.

Enable via the same environment contract as the reference
(``MODEMPROBE_ENABLE`` set + optional ``MODEMPROBE_FILE``), or
programmatically with ``enable()``.

``trace(path)`` wraps ``torch.profiler`` for kernel-level timelines —
the device replacement for per-stage CPU timing.

The span store (``span``, ``count``, ``spans``) times the host's layers
on the device trace's clock: each span is stamped with ``time.time_ns()``,
the one clock of every process on the host, which ``torch.profiler``'s
Chrome trace also keeps (``baseTimeNanoseconds + ts``).  It records only
while a ``torch.profiler`` session records or after ``enable_spans()``.
"""

import contextlib
import itertools
import json
import os
import sys
import threading
import time
from typing import NamedTuple

import numpy as np

_lock = threading.Lock()
_enabled = None          # None: consult env
_buffers: dict[str, list] = {}


def enabled() -> bool:
    if _enabled is not None:
        return _enabled
    return bool(os.environ.get("MODEMPROBE_ENABLE"))


def enable(on: bool = True):
    global _enabled
    _enabled = on


def _host(arr):
    """A host array from ``arr``: a tensor on any device, or array-like."""
    if hasattr(arr, "detach"):
        return arr.detach().cpu().numpy()
    return np.asarray(arr)


def probe_samp(name: str, arr):
    """Append one block of samples to the named buffer (no-op unless
    enabled — mirrors modem_probe_samp_* being compiled out)."""
    if not enabled():
        return
    with _lock:
        _buffers.setdefault(name, []).append(_host(arr))


def probe_stream(name: str):
    """Concatenate the named buffer along the leading axis."""
    with _lock:
        bufs = _buffers.get(name, [])
        if not bufs:
            return np.zeros((0,))
        return np.concatenate([np.atleast_1d(b) for b in bufs], axis=0)


def names():
    with _lock:
        return sorted(_buffers)


def reset():
    with _lock:
        _buffers.clear()


def dump(path: str | None = None):
    """Write every buffer to an .npz (reference modem_probe_close dumping
    the Octave file).  Returns the path, or None if nothing collected."""
    if path is None:
        path = os.environ.get("MODEMPROBE_FILE", "modem_probe.npz")
    with _lock:
        if not _buffers:
            return None
        arrs = {k: np.concatenate([np.atleast_1d(b) for b in v], axis=0)
                for k, v in _buffers.items()}
    np.savez(path, **arrs)
    return path


def capture_demod_internals(stats: dict, prefix: str = "fsk"):
    """Feed a ``fsk_demod_stream(..., probe=True)`` stats dict into the
    probe buffers under reference-style names (sf -> fsk_sf, etc.)."""
    for key in ("sf", "timing", "tmag", "f_est", "ebno_db", "ppm"):
        if key in stats:
            probe_samp(f"{prefix}_{key}", stats[key])


@contextlib.contextmanager
def trace(log_dir: str):
    """torch.profiler trace around a region (CPU activity, and CUDA
    activity where a card is present): a per-kernel timeline written into
    ``log_dir`` as a Chrome trace (``trace.json``) that Perfetto and
    TensorBoard read — the device analogue of the reference's per-file
    wall-clock logging (test_demod.py:809-818).  Yields the profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = profile(activities=activities)
    t0 = time.time_ns()
    prof.start()
    try:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    finally:
        prof.stop()
        path = os.path.join(log_dir, "trace.json")
        prof.export_chrome_trace(path)
        _write_spans(path, t0, time.time_ns())


# ---------------------------------------------------------------------- #
# the span store

class Span(NamedTuple):
    """One timed region of the host: ``t0``/``t1`` in ``time.time_ns()``;
    ``parent`` the ``id`` of the span open around it when it began (for
    a worker's span, when its work was handed over); ``block`` the
    station's block sequence number, shared by every span of one block."""
    name: str
    t0: int
    t1: int
    id: int
    parent: int | None
    block: int | None
    pid: int
    attrs: dict


MAX_SPANS = 1 << 18      # the store keeps the first this many

_spans: list = []
_counts: dict = {}
_dropped = 0
_spans_on = False
_ids = itertools.count(1)
_profiler = None         # torch.autograd.profiler, once torch is loaded


class _Local(threading.local):
    def __init__(self):
        self.stack = []          # ids of the spans open on this thread
        self.block = None


_here = _Local()


def enable_spans(on: bool = True):
    """Record spans and window counts whether or not a profiler runs."""
    global _spans_on
    _spans_on = on


def _torch_profiler():
    """``torch.autograd.profiler`` once this process has loaded torch
    (never loaded here: a pool worker stays torch-free)."""
    global _profiler
    if _profiler is None:
        torch = sys.modules.get("torch")
        if torch is not None:
            _profiler = torch.autograd.profiler
    return _profiler


def recording() -> bool:
    """Whether spans are recorded: after ``enable_spans()``, or while a
    ``torch.profiler`` session records in this process."""
    if _spans_on:
        return True
    prof = _torch_profiler()
    return prof is not None and prof._is_profiler_enabled


def _keep(s: Span):
    global _dropped
    with _lock:
        if len(_spans) >= MAX_SPANS:
            _dropped += 1
        else:
            _spans.append(s)


class _Off:
    """The span while nothing records: enters nothing, keeps nothing."""
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **attrs):
        pass


_OFF = _Off()


class _On:
    __slots__ = ("name", "attrs", "id", "parent", "block", "t0", "_rf")

    def __init__(self, name, attrs):
        self.name, self.attrs, self._rf = name, attrs, None

    def __enter__(self):
        stack = _here.stack
        self.parent = stack[-1] if stack else None
        self.block = _here.block
        self.id = next(_ids)
        stack.append(self.id)
        self.t0 = time.time_ns()
        prof = _torch_profiler()
        if prof is not None and prof._is_profiler_enabled:
            self._rf = prof.record_function(self.name)
            self._rf.__enter__()
        return self

    def __exit__(self, *exc):
        if self._rf is not None:
            self._rf.__exit__(*exc)
        t1 = time.time_ns()
        _here.stack.pop()
        _keep(Span(self.name, self.t0, t1, self.id, self.parent,
                   self.block, os.getpid(), self.attrs))
        return False

    def set(self, **attrs):
        """Attributes known only at the span's end (a count returned)."""
        self.attrs.update(attrs)


def span(name: str, **attrs):
    """A context manager timing the region it wraps as one ``Span``
    (inside ``torch.profiler.record_function(name)`` while a profiler
    records); while nothing records, a shared object that does
    nothing."""
    if not recording():
        return _OFF
    return _On(name, attrs)


def context():
    """(the open span's id, the block) on this thread, for work handed to
    another process; None while nothing records."""
    if not recording():
        return None
    stack = _here.stack
    return (stack[-1] if stack else None, _here.block)


def add_span(name: str, t0: int, t1: int, ctx, pid: int, **attrs):
    """Keep a span timed elsewhere (a pool worker's, on the same clock)
    under ``ctx`` (``context()`` when its work was handed over)."""
    if ctx is None or not recording():
        return
    _keep(Span(name, t0, t1, next(_ids), ctx[0], ctx[1], pid, attrs))


@contextlib.contextmanager
def block(seq):
    """Every span begun inside carries block ``seq``."""
    prev, _here.block = _here.block, seq
    try:
        yield
    finally:
        _here.block = prev


def count(name: str, n: int = 1, into: dict | None = None):
    """Add ``n`` to ``into[name]`` (a station's ``stats``), always, and
    to the store's count of ``name`` while spans are recorded."""
    if into is not None:
        into[name] = into.get(name, 0) + n
    if recording():
        with _lock:
            _counts[name] = _counts.get(name, 0) + n


def spans() -> list:
    """The recorded spans, in the order they ended."""
    with _lock:
        return list(_spans)


def counts() -> dict:
    """The counts added while spans were recorded."""
    with _lock:
        return dict(_counts)


def spans_dropped() -> int:
    """Spans left out since the store filled (``MAX_SPANS``)."""
    return _dropped


def reset_spans():
    global _dropped
    with _lock:
        _spans.clear()
        _counts.clear()
        _dropped = 0


def _write_spans(path: str, t0: int, t1: int):
    """Adds the spans that began between ``t0`` and ``t1`` to the Chrome
    trace at ``path``, on its clock (``baseTimeNanoseconds``): this
    process's on a row of their own, each worker's on a row a worker."""
    with open(path) as f:
        doc = json.load(f)
    base = doc.get("baseTimeNanoseconds")
    if base is None:
        return
    me = os.getpid()
    for s in spans():
        if not t0 <= s.t0 <= t1:
            continue
        w = s.attrs.get("worker")
        doc["traceEvents"].append({
            "ph": "X", "cat": "program_span", "name": s.name,
            "pid": s.pid,
            "tid": "program spans" if s.pid == me else f"worker {w}",
            "ts": (s.t0 - base) / 1e3, "dur": (s.t1 - s.t0) / 1e3,
            "args": {**s.attrs, "block": s.block, "id": s.id,
                     "parent": s.parent}})
    with open(path, "w") as f:
        json.dump(doc, f)

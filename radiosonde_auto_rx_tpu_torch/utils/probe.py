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
"""

import contextlib
import os
import threading

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
    prof.start()
    try:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    finally:
        prof.stop()
        prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))

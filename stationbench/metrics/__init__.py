"""Per-layer metric readers, one module a metric, found by its name.

``read(run, blocks, trace)`` returns the metric's value or None when the
run holds nothing to read (no trace, no such work in the cell); ``trace``
is a ``stationbench.trace.Trace`` of the window (None without one).
A module's data (kernel names, rates) sits beside it in ``<name>.json``.
"""

import json
from pathlib import Path

HERE = Path(__file__).resolve().parent


def data(name: str) -> dict:
    with open(HERE / f"{name}.json") as f:
        return json.load(f)


def roofline_pct(nbytes: float, name: str, trace):
    """``nbytes`` over the device time of the kernels that ``name``'s
    file lists, as a share of its peak bytes/s; None when they did not
    run."""
    if trace is None or nbytes <= 0:
        return None
    d = data(name)
    secs = trace.kernel_s(d["kernels"])
    if secs <= 0:
        return None
    return 100.0 * nbytes / secs / float(d["peak_bytes_per_s"])

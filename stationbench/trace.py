"""Reading a ``torch.profiler`` trace of the window.

The station's device activity is every kernel, copy and memset on the
streams that the station's thread (the one that holds the ``window``,
``dispatch`` and ``collect`` spans) launched work on; the generator's
thread launches on a stream of its own, which is left out.  From
it: the device's busy time (the union of the intervals), each kernel
name's time, and the device's idle gaps, each named by the benchmark span
(``dispatch``, ``collect``) the host was in at the gap's middle.
"""

import json
import os
import tempfile

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_SPANS = ("dispatch", "collect")


class Trace:
    def __init__(self, events):
        window = [e for e in events if e.get("name") == "window" and
                  e.get("cat") == "user_annotation"]
        if not window:
            raise RuntimeError("the trace holds no window span")
        w = window[0]
        self.t0, self.t1 = float(w["ts"]), float(w["ts"]) + float(w["dur"])
        # the station's streams: those its own thread (the one that
        # holds the window's spans) launched work on
        main_tids = {e.get("tid") for e in events
                     if e.get("cat") == "user_annotation" and
                     e.get("name") in ("window",) + HOST_SPANS}
        main_corr = {e["args"]["correlation"] for e in events
                     if e.get("cat") == "cuda_runtime" and
                     e.get("tid") in main_tids and
                     "correlation" in e.get("args", {})}
        dev = [e for e in events if e.get("cat") in DEVICE_CATS]
        streams = {e["args"].get("stream") for e in dev
                   if e["args"].get("correlation") in main_corr}
        self.device = [e for e in dev
                       if e["args"].get("stream") in streams and
                       self.t0 <= float(e["ts"]) < self.t1]
        self.spans = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]),
                             e["name"]) for e in events
                            if e.get("cat") == "user_annotation" and
                            e.get("name") in HOST_SPANS)

    @classmethod
    def from_profiler(cls, prof):
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f)["traceEvents"]
        finally:
            os.remove(path)
        return cls(events)

    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) * 1e-6

    def busy(self):
        """Merged [start, end) intervals (us) of the station's device
        activity inside the window."""
        iv = sorted((float(e["ts"]), min(float(e["ts"]) + float(e["dur"]),
                                         self.t1)) for e in self.device)
        out = []
        for a, b in iv:
            if out and a <= out[-1][1]:
                out[-1][1] = max(out[-1][1], b)
            else:
                out.append([a, b])
        return out

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy()) * 1e-6

    def kernel_s(self, names) -> float:
        """Seconds of the station's kernels whose name holds any of
        ``names``."""
        return sum(float(e["dur"]) for e in self.device
                   if e.get("cat") == "kernel" and
                   any(n in e["name"] for n in names)) * 1e-6

    def breakdown(self, top: int = 10):
        ops = {}
        for e in self.device:
            ops[e["name"]] = ops.get(e["name"], 0.0) + float(e["dur"]) * 1e-6
        gaps = {}
        edges = [self.t0] + [x for iv in self.busy() for x in iv] + [self.t1]
        for a, b in zip(edges[0::2], edges[1::2]):
            if b <= a:
                continue
            mid = 0.5 * (a + b)
            name = "other"
            for s0, s1, n in self.spans:
                if s0 <= mid < s1:
                    name = n
            gaps[name] = gaps.get(name, 0.0) + (b - a) * 1e-6
        order = lambda d: sorted(d.items(), key=lambda kv: -kv[1])[:top]
        return {"device_ops": [[k[:200], v] for k, v in order(ops)],
                "idle_gaps": [[k, v] for k, v in order(gaps)]}

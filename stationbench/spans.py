"""The program's own spans and counts of a traced run, on the trace's
clock.

``radiosonde_auto_rx_tpu_torch.utils.probe`` keeps a span for each timed
region of the station and the frame plane (its pool's workers included)
while a ``torch.profiler`` session records, stamped with
``time.time_ns()``; a ``stationbench.trace.Trace`` holds the trace's
events in us from the trace's base.  The benchmark's ``window`` span is in
both: its kineto event's ``start_ns()`` and ``Trace.t0`` are one instant,
which maps every span onto the trace.

A block id is a dispatch's, so one a cycle.  A window cycle is a block id
that some span inside one of the trace's ``collect`` spans carries: the
cycles the window collected (the last cycle's dispatch, whose collect
follows the window, is left out).
Without a card's trace, or with a program that keeps no spans, there is
nothing to read.
"""

import bisect


class Spans:
    def __init__(self, spans, counts, window_ns, trace):
        self.trace = trace
        self.offset_ns = window_ns - round(trace.t0 * 1e3)
        w0, w1 = window_ns, window_ns + round(trace.window_s * 1e9)
        self.spans = [s for s in spans if w0 <= s.t0 < w1]
        self.counts = counts
        collect = sorted((a, b) for a, b, n in trace.spans
                         if n == "collect")
        starts = [a for a, _ in collect]
        self.blocks = set()
        for s in self.spans:
            if s.block is None or s.block in self.blocks:
                continue
            a = self.us(s.t0)
            i = bisect.bisect_right(starts, a) - 1
            if i >= 0 and a < collect[i][1]:
                self.blocks.add(s.block)

    def us(self, t_ns: int) -> float:
        """A ``time.time_ns()`` instant in the trace's us."""
        return (t_ns - self.offset_ns) * 1e-3

    def of(self, name: str) -> list:
        """The window blocks' spans named ``name``."""
        return [s for s in self.spans
                if s.name == name and s.block in self.blocks]

    def ms(self, name: str):
        """Their summed duration in ms; None where there is none."""
        got = self.of(name)
        if not got:
            return None
        return sum(s.t1 - s.t0 for s in got) * 1e-6

    def self_ms(self, name: str):
        """Their summed self time in ms: each span's duration less that
        of the spans directly inside it."""
        got = self.of(name)
        if not got:
            return None
        ids = {s.id for s in got}
        inner = sum(s.t1 - s.t0 for s in self.spans if s.parent in ids)
        return (sum(s.t1 - s.t0 for s in got) - inner) * 1e-6


def window_start_ns(prof):
    """The ``window`` span's start in ns of Unix time, from the
    profiler's own events; None where it holds none."""
    for e in prof.profiler.kineto_results.events():
        if e.name() == "window":
            return int(e.start_ns())
    return None


def read(run, trace):
    """The run's ``Spans``, made once a run; None without a trace, a
    profiler, or a program that keeps spans."""
    if trace is None or getattr(run, "prof", None) is None:
        return None
    if hasattr(run, "program_spans"):
        return run.program_spans
    run.program_spans = None
    try:
        from radiosonde_auto_rx_tpu_torch.utils import probe
    except ImportError:
        return None
    if not hasattr(probe, "spans"):
        return None
    start = window_start_ns(run.prof)
    if start is not None:
        run.program_spans = Spans(probe.spans(), probe.counts(), start,
                                  trace)
    return run.program_spans

"""The port's span store (``radiosonde_auto_rx_tpu_torch/utils/probe.py``),
the spans and counters of its station and frame plane, and the
benchmark's readers of them (``stationbench/spans.py``,
``stationbench/metrics/``), on the CPU.

* Off (no profiler, no ``enable_spans``): nothing is kept and no
  ``record_function`` is entered; ``count`` still adds to a station's
  ``stats``.
* Spans nest: each knows the span open around it and the block it
  belongs to, per thread; the store is bounded.
* A spawned pool returns each decode's timing: ``frame_plane.decode``
  spans with the worker's index and pid, the model and the frames, and
  the same telemetry as the inline plane.
* Under a CPU ``torch.profiler`` session a program span and a
  ``record_function`` region around the same sleep land within 1 ms of
  each other on the trace; ``probe.trace`` writes the spans into its
  ``trace.json``.
* A small CPU station with a pool fills ``spec_predicted``,
  ``fused_channels``, ``decode_rows`` and ``pool_decodes``, and every
  span of a block carries the block id of its dispatch; a block handed
  over as a host array to a station on another device is timed as
  ``station.h2d``.
* Each new reader gives its value on a synthetic run: spans, counts and a
  ``stationbench.trace.Trace`` built from events.
"""

import json
import re
import threading
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from radiosonde_auto_rx_tpu_torch.station import station as station_mod
from radiosonde_auto_rx_tpu_torch.station.frame_plane import FramePlane
from radiosonde_auto_rx_tpu_torch.utils import probe
from stationbench import spans as bench_spans
from stationbench.trace import Trace

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "radiosonde_auto_rx_tpu_torch"
BENCH_NAMES = {"window", "dispatch", "collect"}


@pytest.fixture(autouse=True)
def clean_store():
    probe.enable_spans(False)
    probe.reset_spans()
    yield
    probe.enable_spans(False)
    probe.reset_spans()


@pytest.fixture
def rf_calls(monkeypatch):
    """Names of the ``record_function`` regions that the probe enters."""
    calls = []
    orig = torch.autograd.profiler.record_function

    def counted(name, *a, **k):
        calls.append(name)
        return orig(name, *a, **k)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", counted)
    return calls


def test_off_records_nothing(rf_calls):
    stats = {}
    assert not probe.recording()
    with probe.span("test.off", k=1) as sp:
        sp.set(frames=3)
        with probe.block(4):
            station_mod._np(torch.ones(3))
    probe.count("spec_predicted", 2, stats)
    assert probe.context() is None
    probe.add_span("frame_plane.decode", 1, 2, (None, 4), 99, worker=0)
    assert probe.spans() == [] and probe.counts() == {}
    assert stats == {"spec_predicted": 2}
    assert rf_calls == []
    # the control: the same span under a profiler enters its region
    with profile(activities=[ProfilerActivity.CPU]):
        with probe.span("test.off"):
            pass
    assert rf_calls == ["test.off"]
    assert [s.name for s in probe.spans()] == ["test.off"]


def test_parents_and_blocks_nest():
    probe.enable_spans()
    seen = {}

    def other_thread():
        with probe.span("test.thread") as sp:
            seen["thread"] = sp.id

    with probe.block(7):
        with probe.span("test.outer") as outer:
            with probe.span("test.inner", kind="a") as inner:
                t = threading.Thread(target=other_thread)
                t.start()
                t.join(10)
                assert not t.is_alive()
                assert probe.context() == (inner.id, 7)
            with probe.block(8):
                with probe.span("test.next"):
                    pass
    with probe.span("test.after"):
        pass
    got = {s.name: s for s in probe.spans()}
    assert got["test.outer"].parent is None
    assert got["test.inner"].parent == got["test.outer"].id
    assert got["test.inner"].attrs == {"kind": "a"}
    assert got["test.next"].parent == got["test.outer"].id
    assert [got[n].block for n in ("test.outer", "test.inner", "test.next",
                                   "test.after")] == [7, 7, 8, None]
    # another thread has its own stack and block
    assert got["test.thread"].id == seen["thread"]
    assert got["test.thread"].parent is None
    assert got["test.thread"].block is None
    for s in got.values():
        assert s.t0 <= s.t1
    assert got["test.outer"].t0 <= got["test.inner"].t0 <= \
        got["test.inner"].t1 <= got["test.outer"].t1


def test_store_is_bounded(monkeypatch):
    monkeypatch.setattr(probe, "MAX_SPANS", 3)
    probe.enable_spans()
    for _ in range(5):
        with probe.span("test.many"):
            pass
    probe.count("c", 2)
    assert len(probe.spans()) == 3 and probe.spans_dropped() == 2
    assert probe.counts() == {"c": 2}
    probe.reset_spans()
    assert probe.spans() == [] and probe.spans_dropped() == 0 and \
        probe.counts() == {}


def test_pool_returns_decode_spans():
    """Two spawned workers (frequencies routed to worker 0 and 1): each
    decode comes back as a ``frame_plane.decode`` span stamped in its
    worker, under the span and block open when it was handed over; the
    telemetry is the inline plane's."""
    from radiosonde_auto_rx_tpu_torch.models.dfm import encode_flight_bits
    bits = encode_flight_bits(n_cycles=3)
    fzs = (400_000_000, 400_000_001)
    inline = FramePlane(workers=0)
    want = {}
    for fz in fzs:
        t = inline.decode(fz, "DFM", "DFM", {}, bits, None)
        want[fz] = inline.gather()[t]
    probe.enable_spans()
    plane = FramePlane(workers=2)
    try:
        with probe.block(5), probe.span("test.handover") as hand:
            tickets = {plane.decode(fz, "DFM", "DFM", {}, bits, None): fz
                       for fz in fzs}
            got = plane.gather()
        pids = [p.pid for p in plane._procs]
    finally:
        plane.close()
    assert {tickets[t]: v for t, v in got.items()} == want
    assert all(want.values())
    dec = [s for s in probe.spans() if s.name == "frame_plane.decode"]
    assert sorted(s.attrs["worker"] for s in dec) == [0, 1]
    for s in dec:
        w = s.attrs["worker"]
        assert s.pid == pids[w] and s.attrs["model"] == "DFM"
        assert s.attrs["frames"] == len(want[fzs[w]])
        assert s.parent == hand.id and s.block == 5
        assert s.t0 < s.t1
    gather = [s for s in probe.spans() if s.name == "frame_plane.gather"]
    assert len(gather) == 1 and gather[0].parent == hand.id
    assert plane.decodes == [1, 1]


def _trace_events(prof, tmp_path):
    path = tmp_path / "t.json"
    prof.export_chrome_trace(str(path))
    return json.loads(path.read_text())


def test_span_and_record_function_share_the_trace_clock(tmp_path):
    prof = profile(activities=[ProfilerActivity.CPU])
    with prof:
        with record_function("window"):
            time.sleep(0.005)
            with probe.span("test.sleep"):
                with record_function("sleep"):
                    time.sleep(0.05)
            time.sleep(0.005)
    doc = _trace_events(prof, tmp_path)
    trace = Trace(doc["traceEvents"])
    sp = bench_spans.read(SimpleNamespace(prof=prof), trace)
    assert sp is not None
    mine = [s for s in sp.spans if s.name == "test.sleep"]
    assert len(mine) == 1
    ev = {e["name"]: e for e in doc["traceEvents"]
          if e.get("cat") == "user_annotation"}
    rf = ev["sleep"]
    assert abs(sp.us(mine[0].t0) - rf["ts"]) < 1000.0
    assert abs(sp.us(mine[0].t1) - (rf["ts"] + rf["dur"])) < 1000.0
    # the span entered a region of its own name on the profiler's
    # timeline, which the same mapping puts at the span
    own = ev["test.sleep"]
    assert abs(sp.us(mine[0].t0) - own["ts"]) < 1000.0
    # the mapping through the window span is the trace's own base
    base = doc["baseTimeNanoseconds"]
    assert abs(sp.us(base) - 0.0) < 1.0


def test_trace_writes_the_spans(tmp_path):
    with probe.trace(str(tmp_path)):
        with probe.block(3), probe.span("test.region"):
            ctx = probe.context()
            t0 = time.time_ns()
            time.sleep(0.002)
        probe.add_span("frame_plane.decode", t0, time.time_ns(), ctx,
                       424242, worker=1, model="RS41", frames=2)
    doc = json.loads((tmp_path / "trace.json").read_text())
    base = doc["baseTimeNanoseconds"]
    ours = {e["name"]: e for e in doc["traceEvents"]
            if e.get("cat") == "program_span"}
    assert set(ours) == {"test.region", "frame_plane.decode"}
    assert ours["test.region"]["tid"] == "program spans"
    assert ours["test.region"]["args"]["block"] == 3
    dec = ours["frame_plane.decode"]
    assert dec["pid"] == 424242 and dec["tid"] == "worker 1"
    assert dec["args"]["model"] == "RS41" and dec["args"]["block"] == 3
    assert abs(base + dec["ts"] * 1e3 - t0) < 1e3
    region = [e for e in doc["traceEvents"]
              if e.get("cat") == "user_annotation" and
              e["name"] == "test.region"]
    assert abs(region[0]["ts"] - ours["test.region"]["ts"]) < 1000.0


def test_station_counts_and_blocks():
    """A CPU station, 8 channels, manual tasks, two workers, two blocks
    double-buffered as the served path runs them."""
    import chip_smoke as cs
    stream = cs.synth_stream(8, 384_000, 2)
    blocks = cs.split_blocks(stream, 384_000, 1)
    st = cs.make_station(torch.device("cpu"), 8, 384_000,
                         frame_plane_workers=2)
    probe.enable_spans()
    try:
        p1 = st.captures_dispatch([blocks[0]])
        p2 = st.captures_dispatch([blocks[1]])
        st.captures_collect(p1)
        telems = st.captures_collect(p2)
    finally:
        st.close()
    assert telems
    n_pred = len(cs.sondes_for(8, 384_000))
    assert st.stats["spec_predicted"] == 2 * n_pred
    assert 0 < st.stats["fused_channels"] <= st.stats["spec_predicted"]
    # every task's row goes to frame decode once a block
    assert st.stats["decode_rows"] == 2 * n_pred
    assert probe.counts() == {k: st.stats[k] for k in
                              ("spec_predicted", "fused_channels",
                               "decode_rows")}
    dec = [s for s in probe.spans() if s.name == "frame_plane.decode"]
    assert len(st.stats["pool_decodes"]) == 2
    assert sum(st.stats["pool_decodes"]) == len(dec) > 0
    ids = (p1[-1], p2[-1])
    assert ids[1] == ids[0] + 1
    for b in ids:
        names = {s.name for s in probe.spans() if s.block == b}
        # no copy to another device here, so no station.h2d
        assert names == {"station.policy", "station.d2h",
                         "frame_plane.gather", "frame_plane.decode"}, names
    assert {s.block for s in probe.spans()} == set(ids)


def test_block_copy_to_another_device_is_timed(monkeypatch):
    """``_wide_planes`` times the copy of a host block to a station's
    device when that device is another (the card's; here a stand-in
    whose type differs from the block's)."""
    import chip_smoke as cs
    st = cs.make_station(torch.device("cpu"), 8, 384_000)
    block = np.zeros((2, 384), np.int16)
    probe.enable_spans()
    st._wide_planes(block)
    assert probe.spans() == []
    monkeypatch.setattr(st, "device", SimpleNamespace(type="card"))
    moved = []
    monkeypatch.setattr(torch.Tensor, "to",
                        lambda self, dev: moved.append(dev) or self)
    with probe.block(9):
        st._wide_planes(block)
    st.close()
    assert moved == [st.device]
    assert [(s.name, s.block) for s in probe.spans()] == [("station.h2d", 9)]


def test_no_span_takes_a_benchmark_name():
    """The benchmark's trace reading matches ``window``, ``dispatch`` and
    ``collect`` by name; the program names none of its spans so."""
    names = set()
    for f in ("station/station.py", "station/frame_plane.py"):
        src = (PORT / f).read_text()
        names |= set(re.findall(r'(?:span|add_span)\(\s*"([^"]+)"', src))
    assert names == {"station.h2d", "station.d2h", "station.policy",
                     "station.detect", "frame_plane.gather",
                     "frame_plane.decode"}
    assert not names & BENCH_NAMES


# ---------------------------------------------------------------------- #
# the readers, on a synthetic run

W_NS = 1_790_000_000_000_000_000     # the window's start, Unix ns
T0 = 1000.0                          # ... and on the trace, us


def _ns(us):
    return W_NS + round((us - T0) * 1e3)


def _ann(name, ts, dur):
    return {"ph": "X", "cat": "user_annotation", "name": name, "pid": 1,
            "tid": 1, "ts": ts, "dur": dur, "args": {}}


def _kernel(corr, ts, dur):
    return [{"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
             "pid": 1, "tid": 1, "ts": ts - 10.0, "dur": 5.0,
             "args": {"correlation": corr}},
            {"ph": "X", "cat": "kernel", "name": "k", "pid": 0, "tid": 7,
             "ts": ts, "dur": dur,
             "args": {"correlation": corr, "stream": 7}}]


def _synthetic_run():
    """Two window blocks (ids 1 and 2) and the next block's dispatch
    (id 3), a span of block 0 before the window; us on the trace."""
    events = [_ann("window", T0, 100_000.0),
              _ann("dispatch", 1000.0, 1000.0),
              _ann("collect", 2000.0, 50_000.0),
              _ann("dispatch", 52_000.0, 1000.0),
              _ann("collect", 53_000.0, 45_000.0),
              _ann("dispatch", 98_000.0, 1000.0)]
    events += _kernel(1, 1500.0, 1000.0) + _kernel(2, 52_500.0, 1000.0) + \
        _kernel(3, 20_000.0, 5000.0)
    trace = Trace(events)
    S = probe.Span
    spans = [
        S("station.h2d", _ns(500), _ns(700), 1, None, 0, 1, {}),
        S("station.h2d", _ns(1100), _ns(1300), 2, None, 1, 1, {}),
        S("station.policy", _ns(2000), _ns(12_000), 10, None, 1, 1, {}),
        S("station.d2h", _ns(2000), _ns(4000), 11, 10, 1, 1, {}),
        S("station.d2h", _ns(12_000), _ns(13_000), 12, None, 1, 1, {}),
        S("frame_plane.gather", _ns(13_000), _ns(43_000), 13, None, 1, 1,
          {"tickets": 2}),
        S("frame_plane.decode", _ns(13_100), _ns(33_100), 14, 13, 1, 2,
          {"worker": 0, "model": "RS41", "frames": 2}),
        S("frame_plane.decode", _ns(13_200), _ns(18_200), 15, 13, 1, 3,
          {"worker": 1, "model": "DFM", "frames": 1}),
        S("station.detect", _ns(43_000), _ns(47_000), 16, None, 1, 1,
          {"rows": 2}),
        S("station.h2d", _ns(52_100), _ns(52_500), 20, None, 2, 1, {}),
        S("station.policy", _ns(53_000), _ns(55_000), 21, None, 2, 1, {}),
        S("frame_plane.gather", _ns(55_000), _ns(95_000), 22, None, 2, 1,
          {"tickets": 1}),
        S("frame_plane.decode", _ns(55_100), _ns(85_100), 23, 22, 2, 2,
          {"worker": 0, "model": "RS41", "frames": 3}),
        S("station.h2d", _ns(98_100), _ns(98_600), 30, None, 3, 1, {}),
    ]
    kineto = SimpleNamespace(events=lambda: [
        SimpleNamespace(name=lambda: "window", start_ns=lambda: W_NS)])
    run = SimpleNamespace(prof=SimpleNamespace(
        profiler=SimpleNamespace(kineto_results=kineto)))
    counts = {"spec_predicted": 8, "fused_channels": 6, "decode_rows": 7}
    return run, [{}, {}], trace, spans, counts


# per block over the two window blocks: h2d 0.2 + 0.4 ms; policy's self
# time 10 - 2 + 2 ms; copies back 2 + 1 ms; pool waits 30 + 40 ms; worker
# 0 decodes 20 + 30 ms; 6 of 8 rows served; the waits (70 ms) less the 5
# ms kernel inside them, of the 100 ms window; the detector 4 ms
READINGS = [("h2d_ms", 0.3), ("policy_ms", 5.0), ("d2h_wait_ms", 1.5),
            ("pool_wait_ms", 35.0), ("decode_busiest_ms", 25.0),
            ("spec_hit_pct", 75.0), ("idle_pool_wait_pct", 65.0),
            ("detect_ms", 2.0), ("decode_rows", 3.5)]


@pytest.mark.parametrize("name,want", READINGS)
def test_reader_on_a_synthetic_run(name, want, monkeypatch):
    import importlib
    run, blocks, trace, spans, counts = _synthetic_run()
    monkeypatch.setattr(probe, "spans", lambda: list(spans))
    monkeypatch.setattr(probe, "counts", lambda: dict(counts))
    reader = importlib.import_module(f"stationbench.metrics.{name}")
    assert reader.read(run, blocks, trace) == pytest.approx(want, abs=1e-9)
    assert run.program_spans.blocks == {1, 2}


def test_readers_read_nothing_without_spans_or_trace(monkeypatch):
    import importlib
    names = [n for n, _ in READINGS]
    run, blocks, trace, spans, counts = _synthetic_run()
    for n in names:
        assert importlib.import_module(
            f"stationbench.metrics.{n}").read(run, blocks, None) is None
    # a program that keeps no spans (the parent of the span store)
    monkeypatch.delattr(probe, "spans")
    for n in names:
        assert importlib.import_module(
            f"stationbench.metrics.{n}").read(run, blocks, trace) is None
    # an empty store reads nothing either
    monkeypatch.undo()
    run, blocks, trace, _, _ = _synthetic_run()
    for n in names:
        assert importlib.import_module(
            f"stationbench.metrics.{n}").read(run, blocks, trace) is None


def test_benchmark_lists_the_readers():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    per = {m["name"]: m for m in bench["per_layer"]}
    for name, _ in READINGS:
        assert per[name]["moves"] == "realtime_x"
    # confirm never ran inside busy10's window, the detector in lband's;
    # the three-source cell reads what busy10 reads
    assert per["spec_hit_pct"]["workloads"] == ["uhf400.busy10",
                                                "uhf400x3.band12"]
    assert per["detect_ms"]["workloads"] == ["lband1680.rs92_lms6"]
    assert per["decode_rows"]["workloads"] == ["uhf400x3.band12"]
    assert np.all([per[n]["workloads"] == ["uhf400.busy10",
                                           "lband1680.rs92_lms6",
                                           "uhf400x3.band12"]
                   for n, _ in READINGS
                   if n not in ("spec_hit_pct", "detect_ms", "decode_rows")])

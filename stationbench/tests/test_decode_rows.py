"""The ``decode_rows`` reader on a traced run of the two-source tiny cell
on the CPU (the profiler's CPU trace stands in for the card's): it reads
the cell's distinct tasks a cycle, and nothing where the program keeps
no such count.

    python3 -m pytest -q -p no:cacheprovider \
        stationbench/tests/test_decode_rows.py
"""

import contextlib
import io
import json

import pytest

from stationbench import run, spans
from stationbench.metrics import decode_rows
from stationbench.tests.test_harness import TWO_CONFIG, TWO_TRAFFIC, tiny_root
from stationbench.trace import Trace


@pytest.fixture(scope="module", params=["counted", "absent"])
def traced(request, tmp_path_factory):
    """A ``--trace 1`` run of the two-source cell: its result line, the
    run and its window cycles, and the window's trace; with ``absent``
    the program's ``decode_rows`` count is dropped, as a program without
    it would keep none."""
    from radiosonde_auto_rx_tpu_torch.utils import probe
    mp = pytest.MonkeyPatch()
    if request.param == "absent":
        count = probe.count

        def without(name, n=1, into=None):
            if name != "decode_rows":
                count(name, n, into)
        mp.setattr(probe, "count", without)
    seen = {}
    per_layer = run.Run.per_layer

    def keep(self, blocks):
        seen.update(run=self, blocks=blocks)
        return per_layer(self, blocks)
    mp.setattr(run.Run, "per_layer", keep)
    probe.reset_spans()
    out = io.StringIO()
    try:
        with contextlib.redirect_stdout(out):
            rc = run.main(["--workload", "tiny.cell", "--seed", "3000000019",
                           "--seconds", "1", "--trace", "1"], device="cpu",
                          root=tiny_root(tmp_path_factory.mktemp("rows"),
                                         TWO_CONFIG, TWO_TRAFFIC))
    finally:
        mp.undo()
    assert rc == 0
    line = json.loads(out.getvalue().strip().splitlines()[-1])
    return request.param, line, seen["run"], seen["blocks"], \
        Trace.from_profiler(seen["run"].prof)


def test_reads_the_tasks_a_cycle(traced):
    kind, line, r, blocks, trace = traced
    assert line["correct"] is True, line["checks"]
    # the CPU run's own line reads nothing: no card, no trace
    assert "decode_rows" not in line["metrics"]
    got = decode_rows.read(r, blocks, trace)
    if kind == "absent":
        assert got is None
        assert spans.read(r, trace) is not None
        return
    tasks = {len(b["tasks"]) for b in blocks}
    assert tasks == {3}
    assert got == 3.0


def test_reads_nothing_without_a_trace(traced):
    _, _, r, blocks, _ = traced
    assert decode_rows.read(r, blocks, None) is None

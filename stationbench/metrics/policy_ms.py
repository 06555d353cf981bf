"""Mean host ms a cycle of the collect's scan and task policy: the self
time of the program's ``station.policy`` spans (the PSD scan's peaks,
forced tasks, candidate ranking, the spacing rule, routing and the
speculation check; on the sequential route the scan's peaks, row
allocation and the spacing rule), copies inside them left out."""

from stationbench import spans


def read(run, blocks, trace):
    sp = spans.read(run, trace)
    ms = None if sp is None else sp.self_ms("station.policy")
    return None if ms is None else ms / len(blocks)

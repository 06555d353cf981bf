"""Mean ms a cycle in the detector on candidate rows (``station.detect``:
the sequential route's ``detector.detect``, the fused route's confirm
and its decision), over the window's cycles."""

from stationbench import spans


def read(run, blocks, trace):
    sp = spans.read(run, trace)
    ms = None if sp is None else sp.ms("station.detect")
    return None if ms is None else ms / len(blocks)

"""Mean host ms a cycle in the station's copies back from the card
(``station.d2h``: each ``.cpu()`` of ``station/station.py`` and the
sequential route's PSD), where the host waits for the device work that
makes them."""

from stationbench import spans


def read(run, blocks, trace):
    sp = spans.read(run, trace)
    ms = None if sp is None else sp.ms("station.d2h")
    return None if ms is None else ms / len(blocks)

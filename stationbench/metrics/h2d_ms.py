"""Mean ms a cycle of its blocks' copies to the card
(``station.h2d``, the program's span around ``Station._wide_planes``'s
copy), over the window's cycles."""

from stationbench import spans


def read(run, blocks, trace):
    sp = spans.read(run, trace)
    ms = None if sp is None else sp.ms("station.h2d")
    return None if ms is None else ms / len(blocks)

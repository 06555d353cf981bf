"""Mean task rows a cycle that the station handed to frame decode: the
program's ``decode_rows`` count over the traced window, over the
window's cycles.  A sonde that several captures of a cycle demodulate
counts once a capture; a program that keeps no such count reads
nothing."""

from stationbench import spans


def read(run, blocks, trace):
    sp = spans.read(run, trace)
    if sp is None or "decode_rows" not in sp.counts:
        return None
    return sp.counts["decode_rows"] / len(blocks)

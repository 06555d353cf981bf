"""Share of the traced window in which the card ran none of the
station's work while the main process waited on the frame-plane pool:
the ``frame_plane.gather`` spans, mapped onto the trace, less the
station's device activity, over the window."""

from stationbench import spans


def read(run, blocks, trace):
    sp = spans.read(run, trace)
    if sp is None or trace.window_s <= 0:
        return None
    waits = sorted((max(sp.us(s.t0), trace.t0), min(sp.us(s.t1), trace.t1))
                   for s in sp.spans if s.name == "frame_plane.gather")
    if not waits:
        return None
    busy = trace.busy()
    idle, j = 0.0, 0
    for a, b in waits:
        if b <= a:
            continue
        idle += b - a
        while j < len(busy) and busy[j][1] <= a:
            j += 1
        k = j
        while k < len(busy) and busy[k][0] < b:
            idle -= min(b, busy[k][1]) - max(a, busy[k][0])
            k += 1
    return 100.0 * idle * 1e-6 / trace.window_s

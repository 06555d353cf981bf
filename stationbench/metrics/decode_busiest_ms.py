"""Mean ms a cycle of frame decode in the busiest decoder: the
``frame_plane.decode`` spans (stamped in each pool worker, or in the
main process inline) summed by worker, the largest sum over the window's
cycles."""

from stationbench import spans


def read(run, blocks, trace):
    sp = spans.read(run, trace)
    if sp is None:
        return None
    by_worker = {}
    for s in sp.of("frame_plane.decode"):
        w = s.attrs.get("worker")
        by_worker[w] = by_worker.get(w, 0) + s.t1 - s.t0
    if not by_worker:
        return None
    return max(by_worker.values()) * 1e-6 / len(blocks)

"""Mean host ms a cycle the main process waits on the frame-plane pool
(``frame_plane.gather``, around ``FramePlane.gather``'s wait)."""

from stationbench import spans


def read(run, blocks, trace):
    sp = spans.read(run, trace)
    ms = None if sp is None else sp.ms("frame_plane.gather")
    return None if ms is None else ms / len(blocks)

"""Mean ms a block in which the station's device work ran: the union of
its kernels, copies and memsets in the traced window (the generator's
stream left out), over the window's blocks."""


def read(run, blocks, trace):
    if trace is None:
        return None
    return 1e3 * trace.busy_s / len(blocks)

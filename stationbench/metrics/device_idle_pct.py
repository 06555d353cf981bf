"""Share of the traced window in which none of the station's device work
ran: 100 (1 - busy / window)."""


def read(run, blocks, trace):
    if trace is None or trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - trace.busy_s / trace.window_s)

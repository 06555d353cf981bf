"""Mean host ms a cycle in ``Station.captures_dispatch``: the speculative
plan, the cycle's copies to the device and the steady step's launches (the
benchmark's span around the call)."""


def read(run, blocks, trace):
    return 1e3 * sum(b["dispatch_s"] for b in blocks) / len(blocks)

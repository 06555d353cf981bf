"""Mean host ms a block in ``Station.captures_collect``: the scan and
task policy, the speculation check, confirm, frame decode through the
frame-plane pool (the benchmark's span around the call)."""


def read(run, blocks, trace):
    return 1e3 * sum(b["collect_s"] for b in blocks) / len(blocks)

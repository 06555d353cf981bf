"""Share of the rows that the fused dispatch demodulated speculatively
(the program's ``spec_predicted`` count) that the collect's speculation
check served (``fused_channels``), over the traced window."""

from stationbench import spans


def read(run, blocks, trace):
    sp = spans.read(run, trace)
    if sp is None or not sp.counts.get("spec_predicted"):
        return None
    return 100.0 * sp.counts.get("fused_channels", 0) / \
        sp.counts["spec_predicted"]

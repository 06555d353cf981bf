"""The demod kernel's share of its byte roofline: for every task of every
block, the least bytes of its demodulation (the task's channel planes at
the demod's input rate, two float32 planes a sample, read once; a float32
soft decision and a byte of bit a symbol written once, as
``chip_smoke.scan_bound`` counts them), over the device time of the
kernels listed in ``demod_roofline_pct.json``."""

from stationbench.metrics import data, roofline_pct


def read(run, blocks, trace):
    d = data("demod_roofline_pct")
    rate, sym = d["input_rate"], d["symbol_rate"]
    nbytes = 0.0
    for b in blocks:
        for typ, _ in b["tasks"]:
            if typ in rate:
                nbytes += run.block_s * (8.0 * rate[typ] + 5.0 * sym[typ])
    return roofline_pct(nbytes, "demod_roofline_pct", trace)

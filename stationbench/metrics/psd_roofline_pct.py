"""The PSD kernel's share of its byte roofline: the least bytes of the
scanned blocks' Welch windows (one nfft window of cs16 samples, 4 bytes
each, every hop, read once) and PSD rows (float32, written once), over
the device time of the kernels listed in ``psd_roofline_pct.json``."""

from stationbench.metrics import data, roofline_pct


def read(run, blocks, trace):
    d = data("psd_roofline_pct")
    nfft, hop = int(d["nfft"]), int(d["hop"])
    per_block = run.traffic.block // hop * nfft * 4 + nfft * 4
    scanned = sum(b.get("scanned", 0) for b in blocks)
    return roofline_pct(scanned * per_block, "psd_roofline_pct", trace)

"""The port's modem probe: ``tests/test_probe.py``'s three cases on the
port, the demod internals held to the JAX package's on the same IQ, the
PER harness's demod probed as ``chip_smoke.py`` phase 11 probes it on the
card, and ``trace`` writing a Chrome trace on the CPU."""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from radiosonde_auto_rx_tpu.demod import (FSKConfig as RefConfig,
                                          fsk_demod_stream as ref_stream)
from radiosonde_auto_rx_tpu_torch.demod import FSKConfig, fsk_demod_stream
from radiosonde_auto_rx_tpu_torch.demod.modulate import add_awgn, gfsk_mod
from radiosonde_auto_rx_tpu_torch.tools import per_harness
from radiosonde_auto_rx_tpu_torch.utils import probe

torch.set_num_threads(1)
CPU = torch.device("cpu")
KW = dict(fs=48000, rs=4800, m=2, p=5, nsym=50, est_min=-5000,
          est_max=5000, tone_spacing=5000, freq_est_type=1)
# the internals to 1e-4 of their peak, as tests/test_torch_fsk.py holds
# the probe outputs
TOL = 1e-4


@pytest.fixture
def probing():
    probe.enable(True)
    probe.reset()
    yield
    probe.enable(False)
    probe.reset()


def _humps(sf, cfg, tone_hz):
    bins = (np.argsort(sf)[-8:] - cfg.ndft // 2) * cfg.fs / cfg.ndft
    return any(abs(b + tone_hz) < 800 for b in bins) and \
        any(abs(b - tone_hz) < 800 for b in bins)


def test_probe_disabled_noop():
    probe.enable(False)
    probe.reset()
    probe.probe_samp("x", np.ones(4))
    assert probe.names() == []
    probe.enable(True)
    try:
        probe.probe_samp("x", np.ones(4))
        probe.probe_samp("x", torch.zeros(2))
        assert probe.probe_stream("x").shape == (6,)
    finally:
        probe.enable(False)
        probe.reset()


def test_dump_npz(tmp_path, probing):
    probe.probe_samp("fsk_sf", np.arange(8.0).reshape(2, 4))
    out = probe.dump(str(tmp_path / "probe.npz"))
    assert np.load(out)["fsk_sf"].shape == (2, 4)


def test_demod_probe_internals(rng, probing):
    cfg = FSKConfig(**KW)
    tx = rng.integers(0, 2, 2000)
    iq = add_awgn(gfsk_mod(tx, 48000, 4800, 2, 0.0, 5000), 12.0, 48000,
                  4800, rng=np.random.default_rng(3))
    soft, bits, stats, _ = fsk_demod_stream(cfg, iq[None], CPU, probe=True)
    nb = stats["ebno_db"].shape[1]
    assert stats["sf"].shape == (1, nb, cfg.ndft)
    assert stats["timing"].shape == (1, nb)
    assert stats["tmag"].shape == (1, nb, 2, cfg.nsym)
    assert _humps(stats["sf"][0, -1].numpy(), cfg, 2500)
    probe.capture_demod_internals(stats)
    assert {"fsk_sf", "fsk_timing", "fsk_tmag", "fsk_ebno_db"} <= \
        set(probe.names())
    assert probe.probe_stream("fsk_sf").shape == (1, nb, cfg.ndft)
    # the same internals as the JAX package's on the same IQ
    _, _, ref, _ = ref_stream(RefConfig(**KW), jnp.asarray(iq)[None],
                              probe=True)
    for key in ("sf", "timing", "tmag"):
        r, p = np.asarray(ref[key]), stats[key].numpy()
        assert np.max(np.abs(p - r)) <= TOL * np.max(np.abs(r)), key


def test_per_harness_demod_probed(monkeypatch, probing):
    """``run_point("RS41", 18.0, 5)`` with its demod asked for the probe
    outputs, fed to ``capture_demod_internals``: the RS41's tones at
    +-2400 Hz in the spectrum of the last block."""
    orig = per_harness.fsk_demod_stream

    def probed(cfg, x, device, **kw):
        out = orig(cfg, x, device, probe=True, **kw)
        probe.capture_demod_internals(out[2])
        return out
    monkeypatch.setattr(per_harness, "fsk_demod_stream", probed)
    row, = per_harness.run_point("RS41", 18.0, 5, device=CPU)
    assert row["frames_rx"] == 5
    sf = probe.probe_stream("fsk_sf")
    cfg = per_harness.CASES["RS41"](1, None, None).cfg
    assert sf.ndim == 3 and sf.shape[0] == 1 and sf.shape[2] == cfg.ndft
    assert _humps(sf[0, -1], cfg, 2400)


def test_trace_writes_chrome_trace(tmp_path):
    with probe.trace(str(tmp_path / "tr")) as prof:
        soft, _, _, _ = fsk_demod_stream(
            FSKConfig(**KW), np.zeros((1, 2, 4800), np.float32), CPU)
    assert prof is not None
    path = tmp_path / "tr" / "trace.json"
    events = json.loads(path.read_text())["traceEvents"]
    assert any("aten::" in e.get("name", "") for e in events)

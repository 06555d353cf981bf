"""The slice end to end: the port's steady-path ``Station`` against the
reference ``Station`` on a 1-device mesh, both on the CPU.

Both stations start the same manual RS41 (on a channel center) and DFM
(20 kHz off grid: recentered extraction + the 50 kHz resampler) and
process the same captures (``tests/test_offgrid.py::_capture``): a scan
block, then a no-scan block (``scan_every=4``).  They must decode the
same telemetry (``_key``: type, serial, frame, position) and end with
the same task keys, and one ``steady_step`` on identical inputs must
agree: channel planes and PSD to 2e-5 of their peak (float32 with a
different summation order), hard bits equal, soft decisions to 1e-4 of
their peak.
"""

import numpy as np
import jax
import pytest
import torch

from radiosonde_auto_rx_tpu.parallel.mesh import make_mesh
from radiosonde_auto_rx_tpu.station.station import Station as RefStation
from radiosonde_auto_rx_tpu_torch.station.station import Station

from test_offgrid import CENTER, FREQS, _capture, _cfg, _Col, _key

torch.set_num_threads(1)
RS41_F = CENTER + FREQS[5]
DFM_F = CENTER + FREQS[4] - 20e3


def _start(st):
    st.start_manual_decoder(RS41_F, "RS41")
    st.start_manual_decoder(DFM_F, "DFM")
    return st


@pytest.fixture(scope="module")
def runs():
    caps = [_capture(0.0, -20e3, seed=21 + i) for i in range(2)]
    mesh = make_mesh(n_ch=1, n_t=1, devices=jax.devices()[:1])
    ref = _start(RefStation(_cfg(), exporters=[_Col()],
                            center_freq_hz=CENTER, mesh=mesh))
    port = _start(Station(_cfg(), exporters=[_Col()], center_freq_hz=CENTER,
                          device="cpu"))
    out = {}
    for tag, st in (("ref", ref), ("port", port)):
        telems = []
        for c in caps:
            telems.extend(st.process_captures([c]))
        out[tag] = (telems, st)
    return out, caps


def test_same_telemetry_and_tasks(runs):
    (ref_t, ref), (got_t, port) = runs[0]["ref"], runs[0]["port"]
    assert {t["type"] for t in ref_t} == {"RS41", "DFM"}
    assert sorted(map(_key, got_t)) == sorted(map(_key, ref_t))
    assert set(port.active) == set(ref.active)
    assert port.stats["fused_channels"] == ref.stats["fused_channels"] == 4
    assert port.stats["frames_ok"] == ref.stats["frames_ok"]


def test_steady_step_outputs_match(runs):
    _, caps = runs
    (_, ref), (_, port) = runs[0]["ref"], runs[0]["port"]
    n_chan = port.n_chan
    T = caps[0].shape[-1]
    # the dispatch's inputs: both tasks fused; the DFM row recentered
    cid_rs41 = port.channel_of_freq(RS41_F)
    cid_dfm = port.channel_of_freq(DFM_F)
    idx = np.array([cid_dfm, cid_rs41], np.int32)
    plan = (("DFM", 1), ("RS41", 1))
    from radiosonde_auto_rx_tpu_torch.ops.channelizer import extract_phases
    f_rel = DFM_F - CENTER
    ph_m, ph_r = (t[None] for t in extract_phases(f_rel, port.fs_wide, T,
                                                  n_chan))
    # a second, pad slot (row id past the last channel) must be skipped
    ph_m = np.concatenate([ph_m, np.zeros_like(ph_m)])
    ph_r = np.concatenate([ph_r, np.zeros_like(ph_r)])
    blk = np.zeros(2, np.int32)
    rows = np.array([cid_dfm, n_chan], np.int32)
    wide = caps[1][None]
    r_step = ref._sharded_step(ref.profile())
    chf_r, psd_r, out_r = r_step.steady_step(
        wide, idx, blk, rows, ph_m, ph_r, plan, scan=True)
    p_step = port._step(port.profile())
    chf_p, psd_p, out_p = p_step.steady_step(
        torch.from_numpy(wide), idx, blk, rows, ph_m, ph_r, plan, scan=True)
    for got, want in ((chf_p, chf_r), (psd_p, psd_r)):
        want = np.asarray(want)
        assert tuple(got.shape) == want.shape
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=2e-5 * np.abs(want).max())
    for name in ("DFM", "RS41"):
        soft_r, bits_r, _ = out_r[name]
        soft_p, bits_p, _ = out_p[name]
        np.testing.assert_array_equal(bits_p.numpy(), np.asarray(bits_r))
        np.testing.assert_allclose(
            soft_p.numpy(), np.asarray(soft_r), rtol=0,
            atol=1e-4 * np.abs(np.asarray(soft_r)).max())


def test_out_of_slice_paths_raise():
    """A second sonde inside a taken channel goes through the collision
    path as in the reference; a block centered at 1680 MHz, once a
    refusal, now takes the L-band profile's sequential route in both
    packages with the same outcome; a station needs its device."""
    # a manual task 20 kHz above the RS41, in its channel: the RS41's
    # scan peak is too far from the task to be absorbed by it, so the
    # sonde itself is the second signal in the channel
    cap = _capture(0.0, -20e3, seed=5)
    mesh = make_mesh(n_ch=1, n_t=1, devices=jax.devices()[:1])
    ref = RefStation(_cfg(), exporters=[_Col()], center_freq_hz=CENTER,
                     mesh=mesh)
    st = Station(_cfg(), exporters=[_Col()], center_freq_hz=CENTER,
                 device="cpu")
    out = []
    for s in (ref, st):
        s.start_manual_decoder(RS41_F + 20e3, "RS41")
        out.append((sorted(map(_key, s.process_captures([cap]))),
                    sorted((v["type"], f) for f, v in s.active.items()),
                    s.stats["detections"]))
    assert out[1] == out[0]
    telems, tasks, detections = out[0]
    assert detections >= 1 and {k[1] for k in telems} >= {"T1357911"}
    assert ("RS41", int(RS41_F + 20e3)) in tasks
    lband = _capture(0.0, 0.0, seed=5)
    got = [(sorted(map(_key, s.process_captures([lband], [1680e6]))),
            s.profile(1680e6).fs_ch, s.stats["detections"])
           for s in (ref, st)]
    assert got[1] == got[0]
    assert st.captures_dispatch([lband], [1680e6])[0] == "seq"
    with pytest.raises(TypeError):           # no silent default device
        Station(_cfg())

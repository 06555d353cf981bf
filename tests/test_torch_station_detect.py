"""The station finds sondes by itself: the port's ``Station`` against the
JAX package's on a one-device CPU mesh, both without manual tasks.

Both process ``chip_smoke.synth_stream`` at 8 channels of 48 kHz
(384 kHz): an RS41 on a channel center, an RS41 10 kHz off grid and a
DFM, as four 1 s blocks and as two 2 s blocks.  Every scan candidate
goes through the full-rate confirmation (``StationStep.confirm`` +
``decide_confirmed``) and starts a task.  After each block both must
hold the same tasks (type, and frequency within 1 Hz), and over the run
decode the same telemetry (type, serial, frame, position) and count the
same detections.  The port must find all three sondes and decode both
RS41s from the 1 s blocks and all three from the 2 s blocks (the DFM
needs 2 s blocks in both packages: ROADMAP.md F2).
"""

import jax
import pytest
import torch

import chip_smoke as cs
from radiosonde_auto_rx_tpu.parallel.mesh import make_mesh
from radiosonde_auto_rx_tpu.station.station import Station as RefStation
from radiosonde_auto_rx_tpu_torch.station.station import Station

torch.set_num_threads(1)
N, FS = 8, 384_000


def _cfg():
    return {**cs.STATION_CFG, "capture_rate": FS, "num_channels": N}


def _tasks(st):
    return sorted((v["type"], fz) for fz, v in st.active.items())


@pytest.fixture(scope="module")
def stream():
    return cs.synth_stream(N, FS, 4)


@pytest.mark.parametrize("block_s", [1, 2])
def test_detecting_station_matches_reference(stream, block_s):
    mesh = make_mesh(n_ch=1, n_t=1, devices=jax.devices()[:1])
    ref = RefStation(_cfg(), center_freq_hz=cs.CENTER, mesh=mesh)
    port = Station(_cfg(), center_freq_hz=cs.CENTER, device="cpu")
    assert not port.manual_tasks and not ref.manual_tasks
    got_t, want_t = [], []
    for blk in cs.split_blocks(stream, FS, block_s):
        want_t.extend(ref.process_captures([blk]))
        got_t.extend(port.process_captures([blk]))
        got, want = _tasks(port), _tasks(ref)
        assert [t for t, _ in got] == [t for t, _ in want]
        assert all(abs(a - b) <= 1 for (_, a), (_, b) in zip(got, want))
    assert sorted(map(cs._key, got_t)) == sorted(map(cs._key, want_t))
    assert port.stats["detections"] == ref.stats["detections"] == 3
    # the three sondes, each on its own task, with its type
    found = sorted((v["type"], fz) for fz, v in port.active.items())
    for typ, _, f_off, _, _ in cs.sondes_for(N, FS):
        assert any(t == typ and abs(fz - (cs.CENTER + f_off)) < 2e3
                   for t, fz in found), (typ, f_off, found)
    seen = cs.check_telemetry(got_t, N, FS,
                              ("RS41",) if block_s == 1 else ("RS41", "DFM"))
    assert seen["T1357911"] > 0 and seen["P2468024"] > 0
    if block_s == 2:
        assert seen["21054321"] > 0

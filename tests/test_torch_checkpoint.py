"""The port's station checkpoint (``station/checkpoint.py``, a copy of the
JAX package's): the cases of ``tests/test_checkpoint.py`` on the port's
``Station`` (on the CPU), resume roundtrip and the decoder rebuilt after
resume, inline and pooled; then a checkpoint written by the JAX
package's station resumed by the port's, and the other way round.  The
RS41 frames carry a fixed GPS time (``RS41_TS``), and the station's time
filter is opened for it."""

import datetime
import json
import time

import numpy as np
import pytest
import torch

RS41_TS = 1_755_600_000       # 2025-08-19, the frames' GPS time

from radiosonde_auto_rx_tpu_torch.station.checkpoint import (load_station_state,
                                                       save_station_state)
from radiosonde_auto_rx_tpu_torch.station.station import Station


def _station():
    return Station({"capture_rate": 2_400_000, "num_channels": 50,
                    "sondehub_enabled": False}, exporters=[],
                   center_freq_hz=402.5e6, device="cpu")


def test_roundtrip(tmp_path):
    st = _station()
    st.active[7] = dict(type="RS41", decoder=object(), last_ok=123.0)
    st.active[12] = dict(type="DFM", decoder=object(), last_ok=456.0)
    st.temporary_blocks[402.7e6] = time.time() + 600
    st.temporary_blocks[403.1e6] = time.time() - 10      # expired
    st.manual_tasks[3] = "M10"
    st.scan_enabled = False
    st.stats["frames_ok"] = 42
    p = str(tmp_path / "st.ckpt")
    save_station_state(st, p)

    st2 = _station()
    assert load_station_state(st2, p)
    assert st2.active[7]["type"] == "RS41"
    assert st2.active[7]["decoder"] is None          # rebuilt lazily
    assert st2.active[7]["last_ok"] == 123.0
    assert st2.active[12]["type"] == "DFM"
    assert len(st2.temporary_blocks) == 1            # expired one dropped
    assert st2.manual_tasks == {3: "M10"}
    assert st2.scan_enabled is False
    assert st2.stats["frames_ok"] == 42


def test_load_missing_and_garbage(tmp_path):
    st = _station()
    assert not load_station_state(st, str(tmp_path / "nope.ckpt"))
    bad = tmp_path / "bad.ckpt"
    bad.write_text("{not json")
    assert not load_station_state(st, str(bad))
    wrong = tmp_path / "wrong.ckpt"
    wrong.write_text('{"version": 99}')
    assert not load_station_state(st, str(wrong))


def test_resume_survives_retune(tmp_path):
    """Frequency-keyed task state loads regardless of the current capture
    center (band-plan hopping retunes between blocks)."""
    st = _station()
    fz = st.freq_of_channel(9)
    st.active[fz] = dict(type="RS41", decoder=object(), last_ok=1.0)
    p = str(tmp_path / "st.ckpt")
    save_station_state(st, p)
    st2 = Station({"capture_rate": 2_400_000, "num_channels": 50},
                  exporters=[], center_freq_hz=403.0e6, device="cpu")
    assert load_station_state(st2, p)
    assert st2.active[fz]["type"] == "RS41"


@pytest.mark.parametrize("workers", [0, -1], ids=["inline", "default"])
def test_decode_after_resume(tmp_path, rng, workers):
    """A resumed channel (decoder=None) decodes on the next block —
    under both the inline frame plane and the default (pooled) one."""
    from radiosonde_auto_rx_tpu_torch.demod.modulate import gfsk_mod, add_awgn
    from radiosonde_auto_rx_tpu_torch.models.rs41 import (encode_frame,
                                                    frame_to_bits,
                                                    make_calibytes)

    def _station():
        return Station({"capture_rate": 2_400_000, "num_channels": 50,
                        "sondehub_enabled": False,
                        "sonde_time_threshold": 1e9,
                        "frame_plane_workers": workers}, exporters=[],
                       center_freq_hz=402.5e6, device="cpu")

    st = _station()
    fz5 = st.freq_of_channel(5)
    st.active[fz5] = dict(type="RS41", decoder=object(), last_ok=0.0)
    p = str(tmp_path / "st.ckpt")
    save_station_state(st, p)
    st2 = _station()
    assert load_station_state(st2, p)

    now = datetime.datetime.fromtimestamp(RS41_TS, datetime.timezone.utc)
    week = (now - datetime.datetime(1980, 1, 6,
                                    tzinfo=datetime.timezone.utc)).days // 7
    dow = (now.weekday() + 1) % 7
    tow = ((dow * 24 + now.hour) * 3600 + now.minute * 60 +
           now.second) * 1000
    cal = make_calibytes()
    tx = np.concatenate(
        [np.tile([1, 0], 200)] +
        [frame_to_bits(encode_frame(frame_nb=30 + i, sonde_id="R7654321",
                                    week=week, tow_ms=tow + i * 1000,
                                    lat=10.0, lon=20.0, alt=1000.0,
                                    calibytes=cal, calfr=i))
         for i in range(3)] + [np.tile([1, 0], 200)])
    iq = add_awgn(gfsk_mod(tx, 48000, 4800, 2, 0.0, 5000), 14.0, 48000,
                  4800)
    ch = torch.from_numpy(np.stack([iq.real, iq.imag]).astype(np.float32))
    telems = st2.decode_channel(ch, 5, "RS41")
    assert telems and telems[-1]["id"] == "R7654321"
    # inline plane: the rebuilt decoder lives in the task state.  Pooled
    # plane: the decoder lives in a worker process (proven by the telems
    # above); the main-process state keeps only type/last_ok.
    if st2.frame_plane.workers == 0:
        assert st2.active[fz5]["decoder"] is not None
    assert st2.active[fz5]["type"] == "RS41"
    st2.frame_plane.close()


@pytest.mark.parametrize("src", ["jax", "port"])
def test_checkpoint_crosses_packages(tmp_path, src):
    """A checkpoint written by one package's station resumes the other's
    (JAX -> port and port -> JAX): the same tasks, blocks, manual tasks
    and stats, and written back, the same file apart from its time."""
    from radiosonde_auto_rx_tpu.station import checkpoint as ref_ckpt
    from radiosonde_auto_rx_tpu.station.station import Station as RefStation
    cfg = {"capture_rate": 2_400_000, "num_channels": 50,
           "sondehub_enabled": False}
    make = {"jax": lambda: RefStation(dict(cfg), exporters=[],
                                      center_freq_hz=402.5e6),
            "port": lambda: Station(dict(cfg), exporters=[],
                                    center_freq_hz=402.5e6, device="cpu")}
    save = {"jax": ref_ckpt.save_station_state, "port": save_station_state}
    load = {"jax": ref_ckpt.load_station_state, "port": load_station_state}
    dst = "port" if src == "jax" else "jax"
    a = make[src]()
    f9, f12 = a.freq_of_channel(9), a.freq_of_channel(12)
    a.active[f9] = dict(type="RS41", decoder=object(), last_ok=123.0)
    a.active[f12] = dict(type="DFM", decoder=object(), last_ok=456.0)
    until = time.time() + 600
    a.temporary_blocks[402.7e6] = until
    a.temporary_blocks[403.1e6] = time.time() - 10      # expired
    a.manual_tasks[3] = "M10"
    a.scan_enabled = False
    a.stats["frames_ok"] = 42
    p = tmp_path / f"{src}.ckpt"
    save[src](a, str(p))

    b = make[dst]()
    assert load[dst](b, str(p))
    assert {fz: (s["type"], s["decoder"], s["last_ok"])
            for fz, s in b.active.items()} == \
        {f9: ("RS41", None, 123.0), f12: ("DFM", None, 456.0)}
    assert b.temporary_blocks == {402.7e6: until}
    assert b.manual_tasks == {3: "M10"} and b.scan_enabled is False
    assert b.stats == a.stats
    q = tmp_path / f"{dst}.ckpt"
    save[dst](b, str(q))
    written = [json.loads(f.read_text()) for f in (p, q)]
    for w in written:
        w.pop("saved_at")
    written[0]["temporary_blocks"].pop(f"{403.1e6:.1f}")
    assert written[0] == written[1]
    for st in (a, b):
        st.frame_plane.close()

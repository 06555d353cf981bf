"""The station's split dispatch (``fused_steady_step: false``) on one
device, against the reference and against the port's fused block.

- On ``tests/test_station_sharded.py``'s capture set (three 4 s blocks at
  three centers: an RS41, an M20 with an M10, a DFM; 16 channels at
  768 kHz), the port's ``Station`` with the split dispatch decodes the
  same telemetry and ends with the same tasks as the reference
  ``Station`` on a one-device mesh with the same setting, as one batch
  of three blocks and as three batches of one (dispatch and collect
  pipelined as the command line runs them).  Task frequencies agree to
  ``RETUNE_HZ``: a drift retune averages the demod's tone estimates over
  the blocks whose Eb/N0 lies within 10 dB of the block's best, and on
  these near-noiseless signals the one-pass variance behind Eb/N0
  cancels to rounding, so the two packages pick other blocks and tune
  the M20 to 402.9644 against 402.9648 MHz (F11 in ROADMAP.md queue 3).
- The same 400 Hz on the sequential route, which the split dispatch does
  not touch (``use_mesh: false``, one block at a time), and from the
  Eb/N0 estimate alone: the two packages' tone estimates are equal, their
  Eb/N0 readings part only on near-noiseless blocks, and the port's
  residual on the reference's readings is the reference's.
- On ``chip_smoke.synth_stream``'s capture (8 channels at 384 kHz: an
  RS41 on a channel center, an RS41 10 kHz off grid, a DFM), with the
  sondes as manual tasks and with none (detection), the split station
  decodes the same telemetry and holds the same tasks block by block as
  the port's fused station, as 1 s and as 2 s blocks; it demodulates
  once a type group a block and scans the PSD every block.
- ``mesh_time_shards`` 2 runs on a mesh that has the devices: on an
  8-shard virtual CPU mesh, a 4 s block of ``synth_stream``'s capture
  with manual tasks dispatches the split route and collects the
  ``use_mesh: false`` station's telemetry; given one device, the station
  raises as the reference's ``make_mesh`` does.
"""

import jax
import numpy as np
import pytest
import torch

import chip_smoke as cs
from radiosonde_auto_rx_tpu.parallel.mesh import make_mesh
from radiosonde_auto_rx_tpu.station.station import Station as RefStation
from radiosonde_auto_rx_tpu_torch.parallel import station_step
from radiosonde_auto_rx_tpu_torch.parallel.mesh import make_mesh as mesh_of
from radiosonde_auto_rx_tpu_torch.station.station import Station

from test_station_sharded import CENTERS, _cfg, _Collect, _key
from test_station_sharded import capture_set  # noqa: F401  (fixture)

torch.set_num_threads(1)
CPU = torch.device("cpu")
SPLIT = {"fused_steady_step": False}
INLINE = {"frame_plane_workers": 0}


RETUNE_HZ = 500.0


def _tasks(st):
    return sorted((v["type"], fz) for fz, v in st.active.items())


def _same_tasks(a, b):
    return len(a) == len(b) and all(
        ta == tb and abs(fa - fb) <= RETUNE_HZ
        for (ta, fa), (tb, fb) in zip(a, b))


def _ref_station(col):
    return RefStation({**_cfg(), **SPLIT, **INLINE}, exporters=[col],
                      mesh=make_mesh(n_ch=1, n_t=1,
                                     devices=jax.devices()[:1]))


def test_split_batch_equals_reference(capture_set):  # noqa: F811
    col_r, col_p = _Collect(), _Collect()
    st_r = _ref_station(col_r)
    ref = st_r.process_captures(list(capture_set), list(CENTERS))
    st = Station({**_cfg(), **SPLIT, **INLINE},
                 exporters=[col_p], device=CPU)
    pending = st.captures_dispatch(list(capture_set), list(CENTERS))
    assert pending[0] == "sharded"
    got = st.captures_collect(pending)
    assert {"RS41", "M20", "M10", "DFM"} <= {t["type"] for t in ref}
    assert sorted(map(_key, got)) == sorted(map(_key, ref))
    assert sorted(map(_key, col_p.items)) == sorted(map(_key, col_r.items))
    assert _same_tasks(_tasks(st), _tasks(st_r))
    assert st.stats.get("fused_channels", 0) == 0


def test_split_pipelined_equals_reference(capture_set):  # noqa: F811
    st_r = _ref_station(_Collect())
    st_p = Station({**_cfg(), **SPLIT, **INLINE},
                   device=CPU)
    ref, got = [], []
    for b in range(3):
        ref.extend(st_r.process_captures([capture_set[b]], [CENTERS[b]]))
    pending = st_p.captures_dispatch([capture_set[0]], [CENTERS[0]])
    for b in (1, 2):
        nxt = st_p.captures_dispatch([capture_set[b]], [CENTERS[b]])
        got.extend(st_p.captures_collect(pending))
        pending = nxt
    got.extend(st_p.captures_collect(pending))
    assert ref and sorted(map(_key, got)) == sorted(map(_key, ref))
    assert _same_tasks(_tasks(st_p), _tasks(st_r))
    assert st_p.stats["detections"] == st_r.stats["detections"]


def test_retune_departure_is_the_ebno_estimate(capture_set,  # noqa: F811
                                               monkeypatch):
    seen = {"ref": [], "port": []}
    resid = {}
    for key, cls in (("ref", RefStation), ("port", Station)):
        resid[key] = orig = cls._freq_residuals

        def recorded(stats, chain, n_items, key=key, orig=orig):
            seen[key].append((chain, n_items, {
                k: np.array(stats[k], np.float32)
                for k in ("f_est", "ebno_db")}))
            return orig(stats, chain, n_items)
        monkeypatch.setattr(cls, "_freq_residuals", staticmethod(recorded))
    cfg = {**_cfg(), "use_mesh": False, **INLINE}
    st_r, st_p = RefStation(cfg), Station(cfg, device=CPU)
    for b in range(3):
        st_r.process_capture(capture_set[b], center_freq_hz=CENTERS[b])
        st_p.process_capture(capture_set[b], center_freq_hz=CENTERS[b])
    m20_r, m20_p = ({fz for t, fz in _tasks(st) if t == "M20"}
                    for st in (st_r, st_p))
    assert m20_r == {402_964_800} and m20_p == {402_964_400}
    assert [t for t, _ in _tasks(st_p)] == [t for t, _ in _tasks(st_r)]
    assert len(seen["port"]) == len(seen["ref"]) > 0
    parted = 0
    for (chain, n, sr), (_, _, sp) in zip(seen["ref"], seen["port"]):
        assert np.array_equal(sp["f_est"], sr["f_est"])
        apart = np.abs(sp["ebno_db"] - sr["ebno_db"]) > 0.1
        assert (sp["ebno_db"][apart] > 40).all() and \
            (sr["ebno_db"][apart] > 40).all()
        want = resid["ref"](sr, chain, n)
        got = resid["port"]({**sp, "ebno_db": sr["ebno_db"]}, chain, n)
        assert np.array_equal(got, want, equal_nan=True)
        parted += not np.array_equal(resid["port"](sp, chain, n), want,
                                     equal_nan=True)
    assert parted >= 1


class _Welch:
    """Counts the step's PSD calls."""

    def __init__(self, monkeypatch):
        self.calls = 0
        orig = station_step._welch

        def counted(*a, **kw):
            self.calls += 1
            return orig(*a, **kw)
        monkeypatch.setattr(station_step, "_welch", counted)


@pytest.mark.parametrize("block_s", [1, 2])
@pytest.mark.parametrize("manual", [True, False], ids=["manual", "detect"])
def test_split_equals_fused(block_s, manual, monkeypatch):
    n, fs = 8, 384_000
    blocks = cs.split_blocks(cs.synth_stream(n, fs, 4), fs, block_s)
    (fused,), _ = cs.drive_station(CPU, [blocks], n, fs, manual)
    welch = _Welch(monkeypatch)
    with cs.DemodCalls() as calls:
        (split,), _ = cs.drive_station(CPU, [blocks], n, fs, manual,
                                       **SPLIT)
    (_, telems_f, per_f), (st, telems_s, per_s) = fused, split
    assert telems_s and sorted(map(_key, telems_s)) == \
        sorted(map(_key, telems_f))
    assert [t for t, _ in per_s] == [t for t, _ in per_f]
    assert st.stats.get("fused_channels", 0) == 0
    # the PSD every block; the demod once a type group a block once the
    # tasks exist (every block with manual tasks)
    assert welch.calls == len(blocks)
    if manual:
        groups = len({t for t, _ in per_s[-1][0]})
        assert calls.calls == groups * len(blocks)


def test_mesh_time_shards_on_a_mesh_of_several_devices():
    n, fs = 8, 384_000
    cfg = {"mesh_time_shards": 2}
    stream = cs.synth_stream(n, fs, 4)
    (seq,), _ = cs.drive_station(CPU, [[stream]], n, fs, use_mesh=False)
    (mesh,), _ = cs.drive_station(
        CPU, [[stream]], n, fs, mesh=mesh_of(devices=[CPU] * 8, n_t=2),
        **cfg)
    st = mesh[0]
    assert (st.mesh.shape["ch"], st.mesh.shape["t"]) == (4, 2)
    assert mesh[1] and sorted(map(_key, mesh[1])) == \
        sorted(map(_key, seq[1]))
    assert cs.tasks_of(st) == cs.tasks_of(seq[0])
    with pytest.raises(ValueError, match="not divisible by n_t=2"):
        Station({"capture_rate": fs, "num_channels": n, **cfg}, device=CPU)
    with pytest.raises(AssertionError, match="not divisible by n_t=2"):
        make_mesh(n_t=2, devices=jax.devices()[:1])

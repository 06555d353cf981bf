"""The port's frame-plane worker pool (``station/frame_plane.py``, a copy of
the JAX package's, and the pooled decode paths of ``Station``) on the CPU.

Station level, block by block on the same captures (``tests/
test_offgrid.py``'s 768 kHz, 16-channel geometry): the port's station
with a pool of 2 workers, the port's inline station
(``frame_plane_workers`` 0) and the JAX package's pooled station (on a
1-device mesh for the fused route) decode the same telemetry
(``_key``: type, serial, frame, position) and hold the same task keys
after every block.

* A sonde drifting +12 kHz a block with no manual task, on the
  sequential route (``use_mesh: false``, as ``tests/test_offgrid.py``'s
  drift case): every block detects or absorbs it and decodes it through
  ``decode_channels`` → ``_decode_frames_pooled``, and the task follows
  the drift, so its decoder state is re-keyed in its worker
  (``FramePlane.rekey``) or dropped where the new key routes to another
  worker, as in the reference.
* Manual RS41 and DFM tasks (the DFM 20 kHz off grid), two blocks of the
  fused steady step (``_decode_fused``'s pool branch).

Plane level: the inline plane decodes and keeps decoder state, a worker
error stays with its ticket, ``drop`` and ``rekey`` reach the worker.
"""

import os

import jax
import numpy as np
import torch

from radiosonde_auto_rx_tpu.parallel.mesh import make_mesh
from radiosonde_auto_rx_tpu.station.station import Station as RefStation
from radiosonde_auto_rx_tpu_torch.demod.modulate import gfsk_mod
from radiosonde_auto_rx_tpu_torch.models.dfm import encode_flight_bits
from radiosonde_auto_rx_tpu_torch.station.frame_plane import FramePlane
from radiosonde_auto_rx_tpu_torch.station.station import Station

from station_fixture import rs41_bits, taper
from test_offgrid import (CENTER, FREQS, FS_WIDE, RS41_CH, RS41_TS, T_WIDE,
                          _capture, _cfg, _Col, _key)

torch.set_num_threads(1)


def _stations(**cfg):
    # the reference's fused route on one device (a mesh given to the
    # reference station takes that route whatever use_mesh says)
    mesh = make_mesh(n_ch=1, n_t=1, devices=jax.devices()[:1]) \
        if cfg.get("use_mesh", True) else None
    return {
        "port_pool": Station(_cfg(frame_plane_workers=2, **cfg),
                             exporters=[_Col()], center_freq_hz=CENTER,
                             device="cpu"),
        "port_inline": Station(_cfg(frame_plane_workers=0, **cfg),
                               exporters=[_Col()], center_freq_hz=CENTER,
                               device="cpu"),
        "ref_pool": RefStation(_cfg(frame_plane_workers=2, **cfg),
                               exporters=[_Col()], center_freq_hz=CENTER,
                               mesh=mesh),
    }


def _drive(stations, caps):
    """Each station through the captures, block by block: [(telemetry
    keys, task keys)] a block, by mode."""
    out = {m: [] for m in stations}
    try:
        for cap in caps:
            for m, st in stations.items():
                telems = st.process_captures([cap])
                out[m].append((sorted(map(_key, telems)),
                               sorted(st.active)))
    finally:
        for st in stations.values():
            st.close()
    return out


def _drift_capture(i, off):
    rng = np.random.default_rng(31 + i)
    wide = (rng.standard_normal(T_WIDE) + 1j *
            rng.standard_normal(T_WIDE)).astype(np.complex64) * 0.002
    sig = taper(gfsk_mod(rs41_bits(np.random.default_rng(77),
                                   ts=RS41_TS + i),
                         FS_WIDE, 4800, 2, FREQS[RS41_CH] + off, 4800,
                         bt=0.5)[:T_WIDE])
    wide[:len(sig)] += sig
    return np.stack([wide.real, wide.imag]).astype(np.float32)


def test_pooled_station_follows_drift_like_inline_and_reference():
    stations = _stations(use_mesh=False)
    pool = stations["port_pool"]
    assert pool.frame_plane.workers == 2
    rekeys = []
    rekey = pool.frame_plane.rekey
    pool.frame_plane.rekey = lambda a, b: rekeys.append((a, b)) or rekey(a, b)
    caps = [_drift_capture(i, off)
            for i, off in enumerate((14e3, 26e3, 38e3))]
    out = _drive(stations, caps)
    assert out["port_pool"] == out["port_inline"] == out["ref_pool"]
    for telems, tasks in out["port_pool"]:
        assert telems and len(tasks) == 1
    # the task followed the sonde across the channel boundary, and its
    # decoder state moved with it
    assert out["port_pool"][0][1] != out["port_pool"][-1][1]
    assert rekeys and all(a != b for a, b in rekeys)
    # the pooled station keeps no decoder in the main process
    assert all(st["decoder"] is None for st in pool.active.values())


def test_pooled_manual_tasks_match_inline_and_reference():
    stations = _stations()
    for st in stations.values():
        st.start_manual_decoder(CENTER + FREQS[5], "RS41")
        st.start_manual_decoder(CENTER + FREQS[4] - 20e3, "DFM")
    caps = [_capture(0.0, -20e3, seed=21 + i) for i in range(2)]
    pool = stations["port_pool"]
    out = _drive(stations, caps)
    assert out["port_pool"] == out["port_inline"] == out["ref_pool"]
    types = {k[0] for telems, _ in out["port_pool"] for k in telems}
    assert types == {"RS41", "DFM"}
    assert all(st["decoder"] is None for st in pool.active.values())


def test_inline_plane_decodes():
    """workers=0: decode/gather inline, decoder state persists."""
    plane = FramePlane(workers=0)
    bits = encode_flight_bits(n_cycles=3)
    t1 = plane.decode(400_500_000, "DFM", {}, bits, None)
    assert plane.gather()[t1], "no telemetry from the inline plane"
    t2 = plane.decode(400_500_000, "DFM", {}, bits, None)
    assert plane.gather()[t2]
    plane.rekey(400_500_000, 400_510_000)
    assert list(plane._decoders) == [400_510_000]
    plane.close()


def test_pooled_worker_error_isolated():
    """A decoder that raises in a worker yields [] for its ticket; the
    other tickets and the plane survive; drop and rekey reach the
    worker that holds the state."""
    plane = FramePlane(workers=2)
    try:
        bits = encode_flight_bits(n_cycles=3)
        bad = plane.decode(400_000_000, "RS41", {"no_such_kwarg": 1},
                           bits, None)
        good = plane.decode(400_010_000, "DFM", {}, bits, None)
        res = plane.gather()
        assert res[bad] == []
        assert res[good], "good ticket starved by the bad one"
        plane.drop(400_010_000)
        again = plane.decode(400_010_000, "DFM", {}, bits, None)
        assert plane.gather()[again]
        # a rekey within one worker moves the state, across workers
        # drops it; decoding goes on at the new keys either way
        plane.rekey(400_010_000, 400_010_002)
        plane.rekey(400_010_002, 400_010_003)
        moved = plane.decode(400_010_003, "DFM", {}, bits, None)
        assert plane.gather()[moved]
        assert all(p.is_alive() for p in plane._procs)
    finally:
        plane.close()
    assert plane._procs == []


def test_pool_workers_load_no_torch():
    """The pool's spawned workers decode with NumPy alone: none maps
    ``torch`` or the CUDA driver, so none can open a CUDA context beside
    a parent that holds one (``chip_smoke.py`` phase 10 checks the same
    on the card)."""
    plane = FramePlane(workers=2)
    try:
        bits = encode_flight_bits(n_cycles=3)
        tickets = [plane.decode(400_000_000 + 10_000 * i, "DFM", {}, bits,
                                None) for i in range(2)]
        res = plane.gather()
        assert all(res[t] for t in tickets)
        assert len(plane._procs) == 2
        for p in plane._procs:
            with open(f"/proc/{p.pid}/maps") as f:
                maps = f.read()
            assert "libtorch" not in maps and "libcuda" not in maps, p.pid
        with open(f"/proc/{os.getpid()}/maps") as f:
            assert "libtorch" in f.read()     # the check sees torch here
    finally:
        plane.close()

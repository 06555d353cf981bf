"""The port's ``Station`` on virtual CPU meshes of several shards, after
``tests/test_station_sharded.py``, on its capture set (three 4 s blocks
at three centers: an RS41, an M20 with an M10, a DFM; 16 channels at
768 kHz) as one batch.

- On an (8, 1) mesh (the batch padded to 8 blocks with zero blocks; the
  RS41, M20, M10 and DFM tasks routed to their experts' shards) and on a
  (4, 2) mesh with ``mesh_time_shards`` 2 (the channelizer, prescreen
  and demod halos, the time reductions), the telemetry equals the port's
  ``use_mesh: false`` station's (block by block) and the reference's
  mesh station's on the same mesh of virtual XLA devices, and the tasks
  are the same types at the same frequencies (to ``RETUNE_HZ`` of the
  reference's: F11, see ``tests/test_torch_station_split.py``).
- On an (8, 1) mesh with a pool of two frame-plane workers, the routed
  expert tasks decode in the pool (F24): the telemetry is the inline
  station's, and the main process holds no decoder.
- Dispatching block N+1 before collecting block N on a (2, 1) mesh
  gives the telemetry and tasks of the synchronous loop.
- An explicit one-device mesh takes the fused steady block and decodes
  what the ``use_mesh: false`` station decodes.
"""

import pytest
import torch

from radiosonde_auto_rx_tpu.station.station import Station as RefStation
from radiosonde_auto_rx_tpu_torch.parallel.mesh import make_mesh
from radiosonde_auto_rx_tpu_torch.station.station import Station

from test_station_sharded import CENTERS, _cfg, _Collect, _key
from test_station_sharded import capture_set  # noqa: F401  (fixture)
from test_torch_station_split import _same_tasks, _tasks

torch.set_num_threads(1)
CPU = torch.device("cpu")
INLINE = {"frame_plane_workers": 0}


def _mesh(n_ch, n_t):
    return make_mesh(n_ch, n_t, devices=[CPU] * 8)


@pytest.fixture(scope="module")
def sequential(capture_set):  # noqa: F811
    st = Station({**_cfg(), **INLINE, "use_mesh": False}, device=CPU)
    out = []
    for b in range(3):
        out.extend(st.process_capture(capture_set[b],
                                      center_freq_hz=CENTERS[b]))
    assert {"RS41", "M20", "M10", "DFM"} <= {t["type"] for t in out}
    return out, st


@pytest.mark.parametrize("n_ch,n_t", [(8, 1), (4, 2)])
def test_mesh_station_equals_sequential_and_reference(
        capture_set, sequential, n_ch, n_t):  # noqa: F811
    seq, st_seq = sequential
    cfg = {**_cfg(), **INLINE, "mesh_time_shards": n_t}
    col = _Collect()
    st = Station(cfg, exporters=[col], device=CPU, mesh=_mesh(n_ch, n_t))
    pending = st.captures_dispatch(list(capture_set), list(CENTERS))
    assert pending[0] == "sharded"
    got = st.captures_collect(pending)
    assert sorted(map(_key, got)) == sorted(map(_key, seq))
    assert sorted(map(_key, col.items)) == sorted(map(_key, got))
    assert _tasks(st) == _tasks(st_seq)
    ref = RefStation(cfg, exporters=[])
    assert (ref.mesh.shape["ch"], ref.mesh.shape["t"]) == (n_ch, n_t)
    want = ref.process_captures(list(capture_set), list(CENTERS))
    assert sorted(map(_key, got)) == sorted(map(_key, want))
    assert _same_tasks(_tasks(st), _tasks(ref))
    assert st.stats["detections"] == ref.stats["detections"]


def test_routed_tasks_decode_in_the_pool(capture_set,  # noqa: F811
                                         sequential):
    seq, st_seq = sequential
    st = Station({**_cfg(), "frame_plane_workers": 2}, device=CPU,
                 mesh=_mesh(8, 1))
    try:
        got = st.process_captures(list(capture_set), list(CENTERS))
    finally:
        st.close()
    assert sorted(map(_key, got)) == sorted(map(_key, seq))
    assert _tasks(st) == _tasks(st_seq)
    assert all("decoder" not in s for s in st.active.values())
    assert set(st.frame_plane.owner) == set(st.active)
    assert sum(st.stats["pool_decodes"]) == st.stats["decode_rows"] > 0


def test_pipelined_dispatch_equals_sync(capture_set):  # noqa: F811
    cfg = {**_cfg(), **INLINE}
    st_a = Station(cfg, device=CPU, mesh=_mesh(2, 1))
    sync = []
    for b in range(3):
        sync.extend(st_a.process_captures([capture_set[b]], [CENTERS[b]]))
    st_b = Station(cfg, device=CPU, mesh=_mesh(2, 1))
    out = []
    pending = st_b.captures_dispatch([capture_set[0]], [CENTERS[0]])
    for b in (1, 2):
        nxt = st_b.captures_dispatch([capture_set[b]], [CENTERS[b]])
        out.extend(st_b.captures_collect(pending))
        pending = nxt
    out.extend(st_b.captures_collect(pending))
    assert sync and sorted(map(_key, out)) == sorted(map(_key, sync))
    assert _tasks(st_b) == _tasks(st_a)


def test_one_device_mesh_is_the_fused_block(capture_set,  # noqa: F811
                                            sequential):
    st = Station({**_cfg(), **INLINE}, device=CPU,
                 mesh=make_mesh(1, 1, devices=[CPU]))
    got = []
    for b in range(3):
        pending = st.captures_dispatch([capture_set[b]], [CENTERS[b]])
        assert pending[0] == "steady"
        got.extend(st.captures_collect(pending))
    assert sorted(map(_key, got)) == sorted(map(_key, sequential[0]))

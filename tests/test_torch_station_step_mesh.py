"""The port's ``StationStep`` on a (ch, t) = (4, 2) virtual CPU mesh
against the reference ``ShardedStationStep`` on the 8 virtual XLA
devices (``tests/conftest.py``), after ``tests/test_station_step.py``.

The inputs: ``station_fixture``'s four captures of 3 s (16 channels at
768 kHz; an RS41, an M20, a DFM and an M10), built from a pinned time.

- ``analyze``: the channel planes within rtol = atol = 1e-5 of the
  reference's on the same mesh and of the port's own 1x1 mesh (the
  reference's own test of its sharding), the PSD within 1e-4 of the
  reference's (relative), the prescreen's best template equal on the
  sondes' channels and their best ratio within 1e-3 (relative).
- ``confirm`` + ``decide_confirmed`` on the reference's channel planes:
  the same decisions (name, polarity, position; score within 1e-3,
  frequency offset within 1 Hz), the noise channel undetected.
- ``route_demod`` on the reference's channel planes: the same routed
  ids and masks, the hard bits of every masked slot equal, Eb/N0 within
  0.01 dB below 40 dB (F11: above it the one-pass variance cancels), no
  drop; the RS41, M20, DFM and M10 decode from the routed bits.
- On an (8, 1) mesh the 12 experts pad to 16: the pad experts exist, a
  channel reaches its expert, and a capacity overflow counts as the
  reference counts it.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from radiosonde_auto_rx_tpu.parallel.mesh import make_mesh as ref_mesh
from radiosonde_auto_rx_tpu.parallel.station_step import ShardedStationStep
from radiosonde_auto_rx_tpu_torch.models import get_model
from radiosonde_auto_rx_tpu_torch.parallel.mesh import (
    make_mesh, unshard)
from radiosonde_auto_rx_tpu_torch.parallel.station_step import (
    EXPERT_TYPES, ROWS, STREAM, StationStep)

import station_fixture as fx

torch.set_num_threads(1)
CPU = torch.device("cpu")
TS = 1_755_600_000.0
CANDS = [fx.RS41_CAP * fx.N_CHAN + fx.RS41_CH,
         fx.M20_CAP * fx.N_CHAN + fx.M20_CH,
         fx.DFM_CAP * fx.N_CHAN + fx.DFM_CH,
         fx.M10_CAP * fx.N_CHAN + fx.M10_CH,
         2 * fx.N_CHAN + 1]                      # last: pure noise
ROUTE = dict(zip(CANDS[:4], ("RS41", "M20", "DFM", "M10")))


@pytest.fixture(scope="module")
def steps():
    mesh = make_mesh(4, 2, devices=[CPU] * 8)
    return (ShardedStationStep(ref_mesh(n_ch=4, n_t=2), n_chan=fx.N_CHAN,
                               capacity=2, conf_capacity=2),
            StationStep(n_chan=fx.N_CHAN, capacity=2, conf_capacity=2,
                        mesh=mesh),
            StationStep(CPU, n_chan=fx.N_CHAN, conf_capacity=8))


@pytest.fixture(scope="module")
def analyzed(steps):
    ref, port, one = steps
    wide = fx.make_wide_captures(TS)
    r = ref.analyze(jnp.asarray(wide))
    p = port.analyze(torch.from_numpy(wide))
    o = one.analyze(torch.from_numpy(wide))
    return ([np.array(v) for v in r],
            [unshard(v, port.mesh, s).numpy()
             for v, s in zip(p, (STREAM, ROWS, ROWS))],
            [v.numpy() for v in o])


def test_analyze_matches_reference(steps, analyzed):
    (ch_r, psd_r, rat_r), (ch_p, psd_p, rat_p), (ch_1, _, _) = analyzed
    np.testing.assert_allclose(ch_p, ch_r, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(ch_p, ch_1, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(psd_p, psd_r, rtol=1e-4,
                               atol=1e-4 * psd_r.max())
    names = [s.name for s in steps[1].prescreen.spec_order]
    for cid in CANDS[:4]:
        assert names[rat_p[cid].argmax()] == names[rat_r[cid].argmax()]
        assert abs(rat_p[cid].max() - rat_r[cid].max()) <= \
            1e-3 * rat_r[cid].max()
    assert names[rat_p[CANDS[0]].argmax()] == "RS41"


def test_confirm_decisions_match_reference(steps, analyzed):
    ref, port, _ = steps
    ch_r = analyzed[0][0]
    slots = np.full(port.n_conf_slots, -1, np.int64)
    slots[:len(CANDS)] = CANDS
    want = ref.decide_confirmed(
        ref.confirm(jnp.asarray(ch_r), jnp.asarray(slots.astype(np.int32))),
        slots)
    got = port.decide_confirmed(port.confirm(torch.from_numpy(ch_r), slots),
                                slots)
    assert set(got) == set(want) == set(CANDS)
    for cid in CANDS:
        assert len(got[cid]) == len(want[cid]), cid
        for g, w in zip(got[cid], want[cid]):
            assert (g.name, g.inverted, g.position) == \
                (w.name, w.inverted, w.position), cid
            assert abs(g.score - w.score) < 1e-3
            assert abs(g.freq_offset - w.freq_offset) < 1.0
    assert [d.name for d in got[CANDS[0]]] == ["RS41"]
    assert [d.name for d in got[CANDS[1]]] == ["M20"]
    assert [d.name for d in got[CANDS[3]]] == ["M10"]
    assert got[CANDS[4]] == []


@pytest.fixture(scope="module")
def routed(steps, analyzed):
    ref, port, _ = steps
    ch_r = analyzed[0][0]
    exp = np.full(ch_r.shape[0], -1, np.int64)
    for cid, name in ROUTE.items():
        exp[cid] = EXPERT_TYPES.index(name)
    want = ref.route_demod(jnp.asarray(ch_r), jnp.asarray(exp, jnp.int32))
    got = port.gather_routed(port.route_demod(torch.from_numpy(ch_r), exp))
    return ({k: np.array(v) for k, v in want.items()},
            {k: v.numpy() for k, v in got.items()}, ch_r.shape[-1])


def test_route_demod_bits_match_reference(routed):
    want, got, _ = routed
    np.testing.assert_array_equal(got["mask"], want["mask"])
    np.testing.assert_array_equal(got["ids"], want["ids"])
    m = want["mask"]
    assert m.sum() == 4
    assert (got["ids"][~m] == -1).all()
    np.testing.assert_array_equal(got["bits"][m],
                                  want["bits"][m].astype(np.uint8))
    eb_r, eb_p = want["ebno"][m], got["ebno"][m]
    low = eb_r < 40.0
    np.testing.assert_allclose(eb_p[low], eb_r[low], atol=0.01)
    np.testing.assert_array_equal(got["fcnt"][m] > 0, want["fcnt"][m] > 0)
    assert got["dropped"].sum() == np.asarray(want["dropped"]).sum() == 0


@pytest.mark.parametrize("name,check", [
    ("RS41", lambda t: t["id"] == "T1357911" and abs(t["lat"] + 34.5) < 1e-4),
    ("M20", lambda t: abs(t["lat"] - 52.1) < 1e-4),
    ("DFM", lambda t: abs(t["lat"] - 47.9) < 1e-4 and
     abs(t["lon"] - 16.8) < 1e-4),
    ("M10", lambda t: abs(t["lat"] - 48.2) < 1e-4)])
def test_routed_bits_decode(steps, routed, name, check):
    port = steps[1]
    _, got, t_total = routed
    e = EXPERT_TYPES.index(name)
    cid = next(c for c, n in ROUTE.items() if n == name)
    (s,) = np.flatnonzero(got["ids"][e] == cid)
    res = {k: torch.from_numpy(v) for k, v in got.items()}
    bits, _ = port.slot_bits(res, e, int(s), t_total)
    telems = get_model(name)().decode_bits(bits, None)
    assert telems and check(telems[-1]), name


def test_pad_experts_and_dropped():
    """(8, 1): 12 experts pad to 16, two a shard; RS41 (expert 0) on
    shard 0.  Two RS41 channels of one source shard at capacity 1: one
    routed, one dropped, as the reference counts it."""
    port = StationStep(n_chan=2, capacity=1, conf_capacity=1,
                       frame_halo=0, mesh=make_mesh(8, 1, devices=[CPU] * 8))
    ref = ShardedStationStep(ref_mesh(n_ch=8, n_t=1), n_chan=2,
                             capacity=1, conf_capacity=1, frame_halo=0)
    assert port.n_exp_pad == ref.n_exp_pad == 16 > port.n_exp
    assert port.e_local == 2 and port.halo_max == 0
    rng = np.random.default_rng(0)
    chf = rng.standard_normal((16, 2, 48000)).astype(np.float32) * 0.1
    exp = np.full(16, -1, np.int64)
    exp[[6, 7]] = EXPERT_TYPES.index("RS41")
    exp[3] = EXPERT_TYPES.index("DFM")
    want = ref.route_demod(jnp.asarray(chf), jnp.asarray(exp, jnp.int32))
    raw = port.route_demod(torch.from_numpy(chf), exp)
    assert len(raw["soft"]) == 8 and raw["soft"][(0, 0)].shape[0] == 2
    got = port.gather_routed(raw)
    for k in ("mask", "ids"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    assert int(got["dropped"].sum()) == int(np.asarray(
        want["dropped"]).sum()) == 1
    assert got["ids"][0][got["mask"][0]].tolist() == [6]
    assert got["ids"][2][got["mask"][2]].tolist() == [3]
    assert got["ebno"].dtype == torch.float32

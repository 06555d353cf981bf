"""The port bench's station programs (``bench.production_program``,
``bench.steady_program``) against the same programs composed from the
JAX package's ``ShardedStationStep`` on a one-device mesh, as the root
``bench.py`` composes them (``:225-331``, ``:334-420``), on the CPU.

Geometry: one capture (B = 1) of 50 channels at the shortest ``t_wide``
that gives every active channel two demod blocks (1,820,000 samples:
36,400 a channel, two MTS01 blocks; the other types take more), the
reference's plan (``default_rng(3)``: RS41 x4, DFM x2, M10 x2, M20,
MTS01; the production block confirms the reference's CPU count of 6
candidates; the steady block recenters two actives 10 kHz off grid).
Gaussian-noise captures.  Tolerances as ``tests/test_torch_bench.py``:
bit sums equal but for flips where the reference's |soft| < 1e-4 of its
peak (counted), soft and score sums within 1e-4 of the sum of their
terms' absolute values.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from radiosonde_auto_rx_tpu.demod.fsk import fsk_demod_stream
from radiosonde_auto_rx_tpu.ops.resample import resample_planes
from radiosonde_auto_rx_tpu.parallel.mesh import make_mesh
from radiosonde_auto_rx_tpu.parallel.station_step import ShardedStationStep
from radiosonde_auto_rx_tpu.station.station import CHAIN_TABLE, _demod_cfg
from radiosonde_auto_rx_tpu_torch import bench
from radiosonde_auto_rx_tpu_torch.parallel import station_step

from test_torch_bench import close_sum, flips, record, same_bit_sum

torch.set_num_threads(1)
CPU = torch.device("cpu")
T_WIDE = 1_820_000
N_CAND = 6


@pytest.fixture(scope="module")
def wide():
    return np.random.default_rng(7).standard_normal(
        (1, 2, T_WIDE)).astype(np.float32)


def ref_step(**kw):
    return ShardedStationStep(make_mesh(n_ch=1, n_t=1), n_chan=50,
                              capacity=4, **kw)


def check_demods(got, want, demods, what):
    """Each type's probes (``soft_<type>``: soft[:, ::257] summed,
    ``bits_<type>``: bits[:, ::7] summed) against the reference's
    stream-layout (soft, bits) ``want[type]``; ``demods`` the port's."""
    assert set(want) == set(demods)
    for name, (soft_j, bits_j) in want.items():
        soft_j, bits_j = np.asarray(soft_j), np.asarray(bits_j)
        soft_p, bits_p = (v.numpy() for v in demods[name])
        assert soft_j.shape[1] >= 2 * 50, (name, soft_j.shape)
        mask = flips(bits_p, bits_j, soft_j, f"{what} {name}")
        close_sum(got[f"soft_{name}"], soft_j[:, ::257].sum(),
                  soft_j[:, ::257], f"{what} soft {name}")
        same_bit_sum(got[f"bits_{name}"],
                     bits_j.astype(np.int64)[:, ::7].sum(), mask[:, ::7],
                     f"{what} bits {name}")


def test_production_program_matches_reference(monkeypatch, wide):
    streams = record(monkeypatch, bench, "fsk_demod_stream")
    run, model = bench.production_program(CPU, 1, T_WIDE, N_CAND)
    got = run(torch.from_numpy(wide))
    assert model.endswith("confirm@6 cands + 5-type demod@10 active)")

    # the reference's plan and program (bench.py:253-310)
    rng = np.random.default_rng(3)
    by_type = {}
    for name in bench.ACTIVES:
        by_type.setdefault(name, []).append(int(rng.integers(0, 50)))
    step = ref_step(conf_capacity=N_CAND)
    slots = np.full(step.n_conf_slots, -1, np.int32)
    slots[:N_CAND] = rng.choice(50, N_CAND, replace=False)
    chf, psd, _ = step.analyze(jnp.asarray(wide), screen=False)
    conf = step.confirm(chf, jnp.asarray(slots))
    psd = np.asarray(psd)
    close_sum(got["psd"], psd.sum(), psd, "psd")
    vals = [np.asarray(p[0]) for p in conf["peaks"]]
    close_sum(got["peaks"], sum(v.sum() for v in vals),
              np.concatenate([v.ravel() for v in vals]), "peaks")
    want = {}
    for name, cids in by_type.items():
        chain = CHAIN_TABLE[name]
        fs = chain.get("resample_to") or 48000
        cfg_t = _demod_cfg(fs, chain["rs"], chain.get("est", 10000),
                           chain.get("mask", 0))
        x = chf[jnp.asarray(np.array(cids))].astype(jnp.float32)
        if chain.get("resample_to"):
            x = resample_planes(x, 48000, chain["resample_to"])
        want[name] = fsk_demod_stream(cfg_t, x)[:2]
    assert len(streams) == len(want)
    check_demods(got, want, dict(zip(by_type, (s[:2] for s in streams))),
                 "production")


@pytest.mark.parametrize("scan", [True, False])
def test_steady_program_matches_reference(monkeypatch, wide, scan):
    streams = record(monkeypatch, station_step, "fsk_demod_stream")
    got = bench.steady_program(CPU, 1, T_WIDE, scan)(torch.from_numpy(wide))
    idx, blk, rows, ph_m, ph_r, plan = bench.steady_plan(1, T_WIDE)
    assert plan == (("DFM", 2), ("M10", 2), ("M20", 1), ("MTS01", 1),
                    ("RS41", 4))
    assert len(rows) == 2
    chf, psd, outs = ref_step().steady_step(
        jnp.asarray(wide), jnp.asarray(idx), jnp.asarray(blk),
        jnp.asarray(rows), jnp.asarray(ph_m), jnp.asarray(ph_r), plan,
        scan=scan)
    if scan:
        psd = np.asarray(psd)
        close_sum(got["psd"], psd.sum(), psd, "psd")
    else:
        probe = np.asarray(chf[:, 0, ::4097])
        close_sum(got["psd"], probe.sum(), probe, "channel probe")
    check_demods(got, {k: v[:2] for k, v in outs.items()},
                 dict(zip((n for n, _ in plan), (s[:2] for s in streams))),
                 f"steady scan={scan}")

"""The port's bench (``radiosonde_auto_rx_tpu_torch/bench.py``) on the
CPU: its headline demod program against the same program composed from
the JAX package's public functions, as the root ``bench.py`` composes it
(its programs are closures inside the ``bench_*`` functions), on the
same numpy input (8 channels of 12,000 samples: two demod blocks); then
the bench's JSON line, ``--ablate`` and ``--scaling`` at a small
geometry (one capture of 455,000 samples).  The r3 all-channel model is
held in ``tests/test_torch_bench_r3.py``, the production and steady
programs in ``tests/test_torch_bench_station.py``.

Tolerances, probe for probe, in all three files: bit sums equal but for flips where the
reference's |soft| < 1e-4 of its peak (counted, printed); each soft or
score sum within 1e-4 of the sum of the absolute values of its terms;
on noise the prescreen ratios within 1e-4 of their peak, with both full
passes fed the port's survivor rows (their top-k sets equal).
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from radiosonde_auto_rx_tpu.demod.fsk import FSKConfig as RefConfig
from radiosonde_auto_rx_tpu.demod.fsk import (
    _fsk_demod_scan_buffered, fsk_init_state, fsk_num_blocks_buffered)
from radiosonde_auto_rx_tpu_torch import bench

import chip_smoke as cs

torch.set_num_threads(1)
CPU = torch.device("cpu")
TOL = 1e-4
T_R3 = 455_000
# the JSON line's geometry: small and quick (the parity tests hold the
# programs' values)
SMALL = bench.Geometry(8, 12_000, 1, 455_000, 455_000, 3, 1, 1,
                       (16, 12_000, 1))


def ref_cfg(cfg):
    """The reference's FSKConfig with the port config's fields."""
    return RefConfig(fs=cfg.fs, rs=cfg.rs, m=cfg.m, p=cfg.p, nsym=cfg.nsym,
                     est_min=cfg.est_min, est_max=cfg.est_max,
                     tone_spacing=cfg.tone_spacing,
                     freq_est_type=cfg.freq_est_type)


def fsk_planes(cfg, channels, t_samples, seed):
    """``bench.make_input``'s signal made with numpy: random symbols,
    tones at +-spacing/2, AWGN 0.07, [C, 2, T] float32."""
    rng = np.random.default_rng(seed)
    bits = rng.random((channels, t_samples // cfg.ts + 1)) < 0.5
    tone = cfg.tone_spacing / 2.0
    f = np.where(np.repeat(bits, cfg.ts, axis=1)[:, :t_samples], tone, -tone)
    ph = 2 * np.pi * np.cumsum(f, axis=1) / cfg.fs
    iq = np.stack([np.cos(ph), np.sin(ph)], axis=1)
    return (iq + rng.standard_normal(iq.shape) * 0.07).astype(np.float32)


def close_sum(got, want, terms, what):
    """A sum within TOL of the sum of its terms' absolute values."""
    got, want = float(got), float(want)
    scale = float(np.abs(np.asarray(terms, np.float64)).sum())
    assert abs(got - want) <= TOL * scale, (what, got, want, scale)


def flips(bits_p, bits_j, soft_j, what):
    """Where the port's bits differ from the reference's: allowed only
    where the reference's |soft| < TOL of its peak.  Returns the mask."""
    bits_p, bits_j = np.asarray(bits_p), np.asarray(bits_j)
    soft_j = np.asarray(soft_j)
    assert bits_p.shape == bits_j.shape == soft_j.shape, what
    mask = bits_p.astype(np.int64) != bits_j.astype(np.int64)
    peak = np.abs(soft_j).max()
    assert (np.abs(soft_j[mask]) < TOL * peak).all(), \
        (what, np.abs(soft_j[mask]).max() / peak)
    print(f"{what}: {int(mask.sum())} bit flips of {mask.size}")
    return mask


def same_bit_sum(got, want, mask, what):
    """A probed bit sum equal to the reference's but for the allowed
    flips inside the probe (``mask`` sliced as the probe)."""
    assert abs(int(got) - int(want)) <= int(np.asarray(mask).sum()), \
        (what, int(got), int(want))


def record(monkeypatch, module, name):
    """Wrap ``module.name`` so that each call's result is kept."""
    calls = []
    fn = getattr(module, name)

    def wrapped(*a, **k):
        out = fn(*a, **k)
        calls.append(out)
        return out

    monkeypatch.setattr(module, name, wrapped)
    return calls


def test_demod_program_matches_reference(monkeypatch):
    cfg = bench._cfg()
    C, T = 8, 12_000
    x = fsk_planes(cfg, C, T, seed=0)
    scans = record(monkeypatch, bench, "scan")
    got = bench.demod_program(cfg, C, CPU)(torch.from_numpy(x))
    nb = fsk_num_blocks_buffered(ref_cfg(cfg), T)
    assert nb == 2 and len(scans) == 1
    _, outs = _fsk_demod_scan_buffered(ref_cfg(cfg), jnp.asarray(x),
                                       fsk_init_state(ref_cfg(cfg), C), nb)
    soft_j, bits_j = np.asarray(outs["soft"]), np.asarray(outs["bits"])
    soft_p = bench._stacked(scans[0][1]["soft"], C, nb).numpy()
    bits_p = bench._stacked(scans[0][1]["bits"], C, nb).numpy()
    np.testing.assert_allclose(soft_p, soft_j, rtol=0,
                               atol=TOL * np.abs(soft_j).max())
    mask = flips(bits_p, bits_j, soft_j, "demod")
    close_sum(got["soft"], soft_j.sum(), soft_j, "soft")
    same_bit_sum(got["bits"], bits_j.astype(np.int64).sum(), mask, "bits")


# device metrics: null on the CPU
DEVICE_KEYS = {"hbm_sustained_gbps_measured",
               "station_step_hbm_pct_h100_least_bytes",
               *(f"{p}_device_ms" for p in cs.BENCH_PROGRAMS)}


def check_line(res, geo):
    """The JSON line of a CPU run at ``geo``: the key set, units,
    finite positive values, the duty-weighted block, no device metric."""
    assert set(res) == {"metric", "value", "unit", "vs_baseline", "extra"}
    assert (res["metric"], res["unit"]) == ("fsk_demod_iq_throughput",
                                            "Msamples/s/chip")
    ex = res["extra"]
    assert set(ex) == cs.BENCH_KEYS
    assert not any(k.endswith(("_v5espec", "_bf16peak")) for k in ex)
    for k in DEVICE_KEYS:
        assert ex[k] is None, k
    nums = {k: v for k, v in ex.items() if isinstance(v, (int, float))
            and k not in DEVICE_KEYS}
    nums.update(value=res["value"], vs_baseline=res["vs_baseline"])
    assert all(np.isfinite(v) and v > 0 for v in nums.values()), nums
    assert res["vs_baseline"] == pytest.approx(res["value"] / 0.24)
    assert ex["station_step_ms_steady_duty4"] == pytest.approx(
        (ex["station_step_ms_steady"]
         + 3 * ex["station_step_ms_steady_noscan"]) / 4, rel=1e-12)
    samples = geo.B * geo.t_wide
    assert ex["station_step_msps_production"] == \
        ex["station_step_msps_wideband"] == pytest.approx(
            samples / ex["station_step_ms"] / 1e3)
    assert ex["station_step_msps_steady"] == pytest.approx(
        samples / ex["station_step_ms_steady"] / 1e3)
    assert ex["station_step_least_bytes_r3"] == \
        geo.B * 2 * geo.t_wide_r3 * 4 + 8
    assert (ex["bench_schema"], ex["detect_duty"],
            ex["detect_full_pass_cap"], ex["device"]) == (2, 0.2, 16, "cpu")
    assert ex["station_step_model"].startswith(
        f"production device programs (analyze[no-screen] + "
        f"confirm@{geo.n_cand} cands + 5-type demod@10 active)")
    for p in cs.BENCH_PROGRAMS:
        # CPU tensors take the plain twins: no kernel launches
        assert set(ex[f"{p}_launches"].values()) == {0}
        assert ex[f"{p}_clock"].startswith("host (cpu)")


def test_json_line_on_the_cpu(capsys):
    assert bench.main(["--device", "cpu"], geometry=SMALL) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1
    check_line(json.loads(lines[0]), SMALL)


def test_no_card_prints_the_error_line(capsys, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert bench.main([]) == 1
    res = json.loads(capsys.readouterr().out)
    assert res["value"] == 0.0 and "no CUDA device" in res["extra"]["error"]


def test_ablate_table(capsys):
    rows = bench.ablate(CPU, SMALL)
    out = capsys.readouterr().out
    assert [r["stage"] for r in rows] == [
        "channelize", "psd_scan", "prescreen", "full_detect_top10",
        "fsk_demod"]
    assert out.startswith("| stage | ms/step |") and "SUM (isolated)" in out
    assert all(r["ms"] > 0 and r["device_ms"] is None for r in rows)
    # channelize reads and writes the captures once
    assert rows[0]["least_mb"] == pytest.approx(2 * 2 * T_R3 * 4 / 1e6)


def test_scaling_on_cpu_shards(capsys):
    res = bench.scaling(CPU, SMALL)
    assert json.loads(capsys.readouterr().out) == res
    assert (res["metric"], res["unit"]) == ("sharded_demod_scaling_cpu",
                                            "Msamples/s@8dev")
    ex = res["extra"]
    assert ex["ndev"] == 8 and ex["msps_1dev"] > 0 and ex["msps_8dev"] > 0
    assert res["vs_baseline"] == pytest.approx(ex["msps_8dev"]
                                               / ex["msps_1dev"])

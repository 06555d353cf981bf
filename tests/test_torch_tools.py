"""The port's quality tools against the JAX package's, on the same inputs.

- ``per_offgrid.gate_point`` on ``docs/per_r5.csv``'s centered rows:
  the JAX tool's point for every type, and the point
  ``tests/test_per_gate.py`` gates at.
- ``per_refine.read_sweep``, ``cliff_windows`` and ``cliff_50`` on the
  recorded sweeps: the same rows, windows and cliffs (the port's
  ``cliff_50`` defaults to its own ``torch`` chain).  Both packages'
  ``read_sweep`` refuse ``docs/per_r5.csv``, whose off-grid rows have no
  runtime (F12 in ROADMAP.md queue 3).
- ``detect_scores``: the conditioning to 1e-4 of its peak and the
  command line's CSV at 2 trials (the same detections and mean scores;
  chain ``torch`` against ``tpu``).
- ``bench_frame_plane`` at 1 round inline: the same frames decoded.
- ``profile_station`` on the CPU at a small geometry (module constants
  patched): each stage's result against the JAX functions the JAX tool
  times, on the same capture (``chip_smoke.synth_stream``'s three
  sondes at 8 channels).
- The tools' command lines exit 1 without a card unless asked for the
  CPU.
"""

import contextlib
import csv
import io
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke as cs
from radiosonde_auto_rx_tpu.tools import (bench_frame_plane as ref_bench,
                                          detect_scores as ref_scores,
                                          per_offgrid as ref_offgrid,
                                          per_refine as ref_refine,
                                          plot_per as ref_plot)
from radiosonde_auto_rx_tpu_torch.tools import (bench_frame_plane,
                                                detect_scores, per_offgrid,
                                                per_refine, plot_per,
                                                profile_station)

from test_per_gate import TYPES
from test_torch_per_harness import gate_ebno

torch.set_num_threads(1)
CPU = torch.device("cpu")
DOCS = Path(__file__).resolve().parent.parent / "docs"


def _centered(path):
    with open(path) as f:
        return [r for r in csv.DictReader(f)
                if float(r.get("f_off") or 0.0) == 0.0]


@pytest.mark.parametrize("sonde_type", TYPES)
def test_gate_point(sonde_type):
    rows = _centered(DOCS / "per_r5.csv")
    got = per_offgrid.gate_point(rows, sonde_type)
    assert got == ref_offgrid.gate_point(rows, sonde_type)
    assert got == gate_ebno(sonde_type)


@pytest.mark.parametrize("name", ["per_r2.csv", "per_r3.csv"])
def test_refine_reads_and_windows(name):
    rows = per_refine.read_sweep(DOCS / name)
    assert rows == ref_refine.read_sweep(DOCS / name)
    assert per_refine.cliff_windows(rows) == ref_refine.cliff_windows(rows)
    as_torch = [dict(r, chain="torch") if r["chain"] == "tpu" else r
                for r in rows]
    for t in sorted({r["type"] for r in rows}):
        want = ref_refine.cliff_50(rows, t)
        assert per_refine.cliff_50(rows, t, "tpu") == want
        assert per_refine.cliff_50(as_torch, t) == want
        assert per_refine.cliff_50(rows, t, "ref") == \
            ref_refine.cliff_50(rows, t, "ref")


def test_refine_refuses_the_offgrid_sweep():
    for mod in (per_refine, ref_refine):
        with pytest.raises(ValueError):
            mod.read_sweep(DOCS / "per_r5.csv")


def test_detect_conditioning():
    rng = np.random.default_rng(4)
    spec = next(t for t in detect_scores.TEMPLATES if t.name == "RS41")
    iq = detect_scores.add_awgn(detect_scores._burst(spec, rng), 10.0,
                                detect_scores.FS, spec.sps, rng=rng)
    got = detect_scores._condition(iq, CPU).numpy()
    want = ref_scores._condition(iq)
    assert np.max(np.abs(got - want)) <= 1e-4 * np.max(np.abs(want))


def _run_main(main, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert main(argv) == 0
    return buf.getvalue().strip().splitlines()


def test_detect_scores_cli():
    argv = ["--ebno", "6:12:6", "--trials", "2", "--types", "RS41,DFM,M10"]
    got = _run_main(detect_scores.main, argv + ["--device", "cpu"])
    want = _run_main(ref_scores.main, argv)
    assert len(got) == len(want) == 8
    assert got == [ln.replace(",tpu,", ",torch,") for ln in want]
    assert any(ln.split(",")[4] != "0" for ln in got[1:-1])


def test_bench_frame_plane_inline():
    got = bench_frame_plane.bench_type("RS41", 2, 1, 0, n_frames=4)
    want = ref_bench.bench_type("RS41", 2, 1, 0, n_frames=4)
    assert got["frames_per_stream"] == want["frames_per_stream"] > 0
    assert {k: got[k] for k in ("type", "workers")} == \
        {k: want[k] for k in ("type", "workers")}


def test_profile_station_stages(monkeypatch):
    from radiosonde_auto_rx_tpu.demod import FSKConfig as RefConfig
    from radiosonde_auto_rx_tpu.demod import fsk_demod_stream
    from radiosonde_auto_rx_tpu.detect.correlator import _correlate_peaks
    from radiosonde_auto_rx_tpu.detect.psd import _welch
    from radiosonde_auto_rx_tpu.detect.scanner import SondeDetector
    from radiosonde_auto_rx_tpu.ops.channelizer import (_channelize,
                                                        pfb_prototype)
    n, fs = 8, 384_000
    for k, v in dict(N_CHAN=n, CAP=4, REPS=1, TRIALS=1).items():
        monkeypatch.setattr(profile_station, k, v)
    stream = cs.synth_stream(n, fs, 1)
    wide_np = (stream.astype(np.float32) / 32768.0)[None]
    out = profile_station.profile(CPU, torch.from_numpy(wide_np))
    assert list(out) == ["channelize", "welch_psd hop=4*nfft",
                         "det_prescreen (duty chans)", "det_full_pass (4 ch)",
                         "fsk_demod(all channels)"]
    assert all(v["device"] == "cpu" and v["ms"] > 0 for v in out.values())
    got = [fn() for _, fn in profile_station.stages(
        CPU, torch.from_numpy(wide_np))]

    wide = jnp.asarray(wide_np)
    taps = jnp.asarray(pfb_prototype(n))
    chan = jax.vmap(lambda x: _channelize(x, taps, n))(wide)
    chf = chan.reshape(n, 2, -1)
    det = SondeDetector(48000)
    acc = jnp.float32(0)
    for fm, (_, _, _, bank, lens) in zip(det._condition(chf[:4]),
                                         det.classes):
        val, _, _, xm = _correlate_peaks(fm, bank.astype(fm.dtype),
                                         tuple(int(v) for v in lens))
        acc = acc + val.max() + xm.sum()
    cfg = RefConfig(fs=48000, rs=4800, m=2, p=5, nsym=300, est_min=-5000,
                    est_max=5000, tone_spacing=5000, freq_est_type=1)
    soft, _, _, _ = fsk_demod_stream(cfg, chf)
    want = [chan, _welch(wide, 2048, 8192),
            det.prescreen.scores(chf[:max(1, int(n * 0.2))]), acc, soft]
    for (name, _), g, w in zip(out.items(), got, want):
        g, w = g.numpy(), np.asarray(w)
        assert g.shape == w.shape, name
        if name.startswith("fsk_demod"):
            # the rows that carry the three sondes: soft decisions to
            # 1e-4 of their peak (the noise rows' timing line is weak)
            rows = [r for r in range(n) if np.abs(w[r]).max() >
                    10 * np.median(np.abs(w))]
            assert len(rows) == 3
            g, w = g[rows], w[rows]
        assert np.max(np.abs(g - w)) <= 1e-4 * np.max(np.abs(w)), name


@pytest.mark.parametrize("main", [
    profile_station.main, per_refine.main, per_offgrid._cli,
    detect_scores.main], ids=["profile_station", "per_refine",
                              "per_offgrid", "detect_scores"])
def test_cli_wants_a_card(main, monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert main([]) == 1
    assert "no CUDA device" in capsys.readouterr().err


def test_plot_per(tmp_path):
    """The plot reads the port's ``torch`` rows as the JAX tool reads its
    ``tpu`` rows, and draws them."""
    src = tmp_path / "sweep.csv"
    with open(DOCS / "per_r3.csv") as f:
        text = f.read()
    src.write_text(text.replace(",tpu,", ",torch,"))
    got = plot_per.load(src)
    want = ref_plot.load(DOCS / "per_r3.csv")
    assert {(t, "torch" if c == "tpu" else c): v
            for (t, c), v in want.items()} == dict(got)
    out = tmp_path / "per.png"
    assert plot_per.main([str(src), "-o", str(out)]) == 0
    assert out.stat().st_size > 0

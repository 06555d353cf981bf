"""The hand-written CUDA kernels against their plain twins, and the CUDA
detector and stations against their CPU paths, on the card.

Marked ``cuda``: a CUDA kernel has no CPU mode, so these skip where no
CUDA device is present.  This file imports no JAX, so on a GPU
host without it it runs alone:

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_cuda.py

Tolerances: K1 to 1e-5 of the largest twin value, K2 per bin to 1e-4
of (|twin| + the row's mean power), K3 per bin to 1e-4 of (|twin| + the
row's RMS) — float32 FMA on both sides, in another summation order; the
scan kernel ``fsk_scan`` as ``chip_smoke.scan_diff`` (bits, tone
estimates, ptr and nin equal; soft decisions, spectra and tone magnitudes
to ``chip_smoke.SCAN_TOL`` of their peak; the Eb/N0 bound), on modulated
signals with noise (on pure noise the timing estimate is ill-conditioned
and may legitimately differ); the detector's scores to
``chip_smoke.DET_TOL`` (its normalization's float32 running sums cancel,
and the CUDA scan sums in another order; see chip_smoke.py).
"""

import numpy as np
import pytest
import torch

import chip_smoke as cs
from radiosonde_auto_rx_tpu_torch import kernels
from radiosonde_auto_rx_tpu_torch.demod import fsk
from radiosonde_auto_rx_tpu_torch.demod.fsk import _consts
from radiosonde_auto_rx_tpu_torch.detect.scanner import SondeDetector
from radiosonde_auto_rx_tpu_torch.ops import fft, fsk_sf
from radiosonde_auto_rx_tpu_torch.station.chains import CHAIN_TABLE, \
    _demod_cfg

torch.set_num_threads(1)
pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda", 0)


def _cfg(name):
    ch = CHAIN_TABLE[name]
    return _demod_cfg(ch.get("resample_to", 48000), ch["rs"],
                      ch.get("est", 10000), ch.get("mask", 0))


@pytest.mark.parametrize("name,c", [("RS41", 1), ("RS41", 3), ("M20", 5),
                                    ("DFM", 2), ("MTS01", 2),
                                    ("MEISEI", 1)])
def test_k1_matches_twin(dev, name, c):
    cfg = _cfg(name)
    g = torch.Generator(device=dev).manual_seed(c)
    xw = torch.randn(c, 2, cfg.nmem, generator=g, device=dev)
    sf = torch.rand(c, cfg.ndft, generator=g, device=dev)
    k = _consts(cfg, dev)
    args = (xw, sf, k.wc, k.ws, k.starts, k.weights, k.decay)
    before = kernels.launches["freq_est_sf"]
    got = fsk_sf.freq_est_sf(*args)
    assert kernels.launches["freq_est_sf"] == before + 1
    want = fsk_sf.freq_est_sf_ref(*args)
    torch.cuda.synchronize()
    err = (got - want).abs().max() / want.abs().max()
    assert float(err) <= 1e-5


# every FSK chain of the station (the iMet chains' audio demod as "AFSK";
# the Weathex and L-band chains at their own rates), and an FSK4 config
SCAN_CHAINS = sorted({"RS41", "RS92", "DFM", "M10", "M20", "LMS6", "IMET5",
                      "MEISEI", "MRZ", "MTS01", "RD94RD41", "WXR301",
                      "WXRPN9", "RS92NGP", "MK2LMS"}) + ["AFSK", "FSK4"]


@pytest.mark.parametrize("c", [1, 2, 16])
@pytest.mark.parametrize("name", SCAN_CHAINS)
def test_fsk_scan_matches_twin(dev, name, c):
    """One launch per call, against the twin with probe outputs, then from
    the twin's final state (a carried state)."""
    cfg = cs.cfg_of(name)
    t = max(cfg.fs // 2, cfg.nmem + 8 * cfg.ts + 2 * cfg.n)   # 2+ blocks
    x = torch.from_numpy(cs.fsk_signal(cfg, c, t, seed=c)).to(dev)
    nb = fsk.fsk_num_blocks_buffered(cfg, t)
    st0 = fsk.fsk_init_state(cfg, c, dev)
    before = kernels.launches["fsk_scan"]
    got = fsk.fsk_scan(cfg, x, st0, nb, probe=True)
    assert kernels.launches["fsk_scan"] == before + 1
    want = fsk.fsk_scan_ref(cfg, x, st0, nb, probe=True)
    cs.scan_diff(got, want, name)
    cs.scan_diff(fsk.fsk_scan(cfg, x, want[0], nb),
                 fsk.fsk_scan_ref(cfg, x, want[0], nb), name)


def test_fsk_demod_stream_launches_the_scan_once(dev, monkeypatch):
    """On a CUDA tensor the stream demod is one scan launch and reaches
    neither the plain scan nor K1's twin; short input gives empty outputs
    without a launch, as on the CPU."""
    from radiosonde_auto_rx_tpu_torch.ops import fsk_sf as sf_mod

    def refuse(*a, **k):
        raise AssertionError("a twin was called on a CUDA tensor")
    monkeypatch.setattr(fsk, "fsk_scan_ref", refuse)
    monkeypatch.setattr(fsk, "freq_est_sf_ref", refuse)
    monkeypatch.setattr(sf_mod, "freq_est_sf_ref", refuse)
    cfg = cs.cfg_of("RS41")
    x = torch.from_numpy(cs.fsk_signal(cfg, 3, cfg.fs, seed=5)).to(dev)
    before = dict(kernels.launches)
    soft, bits, stats, state = fsk.fsk_demod_stream(cfg, x, dev, probe=True)
    assert kernels.launches["fsk_scan"] == before["fsk_scan"] + 1
    assert kernels.launches["freq_est_sf"] == before["freq_est_sf"]
    nb = fsk.fsk_num_blocks_buffered(cfg, cfg.fs)
    assert soft.shape == bits.shape == (3, nb * cfg.nsym)
    assert set(stats) == {"f_est", "ebno_db", "ppm", "sf", "timing", "tmag"}
    assert stats["tmag"].shape == (3, nb, 2, cfg.nsym)
    soft, bits, stats, _ = fsk.fsk_demod_stream(
        cfg, torch.zeros(3, 2, cfg.nmem, device=dev), dev)
    assert soft.shape == (3, 0) and bits.dtype == torch.uint8 and not stats
    assert kernels.launches["fsk_scan"] == before["fsk_scan"] + 1


def test_fsk_scan_refuses_bad_input(dev):
    cfg = cs.cfg_of("RS41")
    x = torch.from_numpy(cs.fsk_signal(cfg, 2, cfg.fs)).to(dev)
    nb = fsk.fsk_num_blocks_buffered(cfg, cfg.fs)
    st = fsk.fsk_init_state(cfg, 2, dev)
    with pytest.raises(ValueError):           # wrong dtype
        fsk.fsk_scan(cfg, x.double(), st, nb)
    with pytest.raises(ValueError):           # not contiguous
        fsk.fsk_scan(cfg, x[..., ::2], st, nb // 2)
    with pytest.raises(ValueError):           # more blocks than the input
        fsk.fsk_scan(cfg, x, st, nb + 2)
    with pytest.raises(ValueError):           # state on the CPU
        fsk.fsk_scan(cfg, x, fsk.fsk_init_state(cfg, 2, "cpu"), nb)
    wide = fsk.FSKConfig(fs=48000, rs=300, m=2, p=5, nsym=100)  # ndft 2048
    with pytest.raises(ValueError):
        fsk.fsk_demod_stream(wide, torch.zeros(1, 2, 48000, device=dev), dev)


POWERS_OF_TWO = [2 ** k for k in range(1, 13)]      # up to fft.MAX_N


@pytest.mark.parametrize("n", POWERS_OF_TWO)
@pytest.mark.parametrize("shift", [True, False])
@pytest.mark.parametrize("b", [5, 293])      # no multiple of a block's rows
def test_k2_matches_twin(dev, n, shift, b):
    g = torch.Generator(device=dev).manual_seed(n)
    x = torch.randn(b, 2, n, generator=g, device=dev)
    win = torch.rand(n, generator=g, device=dev) + 0.5
    before = kernels.launches["fft_abs2"]
    got = fft.fft_abs2(x, win, shift)
    assert kernels.launches["fft_abs2"] == before + 1
    want = fft.fft_abs2_ref(x, win, shift)
    torch.cuda.synchronize()
    err = (got - want).abs() / (want.abs() + want.mean(-1, keepdim=True))
    assert float(err.max()) <= 1e-4


@pytest.mark.parametrize("offset", [0, 3])   # 3: rows from an odd float
def test_k2_reads_strided_welch_view(dev, offset):
    x = torch.randn(3, 2, offset + 40 * 1024, device=dev)[..., offset:]
    view = x.reshape(3, 2, 40, 1024)[..., :256]
    assert (view.data_ptr() % 16 == 0) == (offset == 0)
    win = torch.ones(256, device=dev)
    got = fft.fft_abs2(view, win, True)
    rows = view.permute(0, 2, 1, 3).reshape(120, 2, 256).contiguous()
    np.testing.assert_array_equal(
        got.reshape(120, 256).cpu().numpy(),
        fft.fft_abs2(rows, win, True).cpu().numpy())


# one launch up to the kernels' largest row by either method; two (the
# factorization's stages) above 4096
@pytest.mark.parametrize("n,method,launches", [
    *[(n, "auto", 1) for n in POWERS_OF_TWO],
    (1024, "four-step", 1), (2048, "four-step", 1), (4096, "four-step", 1),
    (8192, "auto", 2), (8192, "four-step", 2)])
@pytest.mark.parametrize("b", [5, 293])
def test_k3_matches_twin(dev, n, method, launches, b):
    g = torch.Generator(device=dev).manual_seed(n)
    x = torch.randn(b, 2, n, generator=g, device=dev)
    win = torch.rand(n, generator=g, device=dev) + 0.5
    before = kernels.launches["fft"]
    got = fft.fft(x, win, method)
    assert kernels.launches["fft"] == before + launches
    want = fft.fft_ref(x * win)
    torch.cuda.synchronize()
    mag = torch.hypot(want[:, 0], want[:, 1])
    rms = mag.pow(2).mean(-1, keepdim=True).sqrt()
    diff = torch.hypot(*(got - want).unbind(1))
    assert float((diff / (mag + rms)).max()) <= 1e-4


@pytest.mark.parametrize("start", [256, 257])   # 257: from an odd float
def test_k3_reads_complex_and_strided_rows(dev, start):
    x = torch.randn(6, 2, 3 * 256, device=dev)[..., start:start + 256]
    z = torch.complex(x[:, 0], x[:, 1])
    np.testing.assert_allclose(fft.fft(x).cpu().numpy(),
                               fft.fft(z).cpu().numpy(), rtol=0, atol=1e-4)


def test_fft_auto_above_1024_launches_the_kernel(dev):
    """``fft`` on a CUDA tensor never takes the plain matmul: at N = 2048
    "auto" is one launch of the kernel."""
    x = torch.randn(4, 2, 2048, device=dev)
    before = kernels.launches["fft"]
    got = fft.fft(x, method="auto")
    assert kernels.launches["fft"] == before + 1
    want = fft.fft_ref(x)
    torch.cuda.synchronize()
    assert float((got - want).abs().max()) <= 1e-4 * float(want.abs().max())


def test_detector_cuda_matches_cpu(dev):
    """The detector on 4 rows of 1 s at 48 kHz: the three sondes of the
    8-channel smoke capture, extracted at their frequencies, and a row of
    noise.  Streams are compared on the sonde rows only: on noise the
    discriminator's angle is ill-conditioned wherever the IQ magnitude
    nears zero, so float32 rounding there is not bounded by the peak."""
    import chip_smoke as cs
    from radiosonde_auto_rx_tpu_torch.ops.channelizer import \
        extract_channels
    n, fs = 8, 384_000
    wide = cs.synth_stream(n, fs, 1).astype(np.float32) / 32768.0
    freqs = [f for _, _, f, _, _ in cs.sondes_for(n, fs)] + [-150e3]
    out = []
    for d in (dev, torch.device("cpu")):
        rows = extract_channels(wide, fs, freqs, n, d)
        det = SondeDetector(fs // n, device=d)
        out.append((det._condition(rows), det.detect(rows, max_det=0)))
    (s_g, d_g), (s_c, d_c) = out
    for a, b in zip(s_g, s_c):
        assert float((a[:3].cpu() - b[:3]).abs().max()) <= \
            cs.STREAM_TOL * float(b[:3].abs().max())
    assert [[(x.name, x.tn, x.inverted) for x in ch] for ch in d_g] == \
        [[(x.name, x.tn, x.inverted) for x in ch] for ch in d_c]
    assert [ch[0].name if ch else None for ch in d_g] == \
        ["RS41", "RS41", "DFM", None]
    for g_ch, c_ch in zip(d_g, d_c):
        for a, b in zip(g_ch, c_ch):
            assert abs(a.score - b.score) <= cs.DET_TOL


def test_prescreen_cuda_matches_cpu(dev):
    """The prescreen's ratios on the card against the CPU's, on the nine
    candidate rows of phase 9's capture at 16 channels (the three sondes,
    extracted at their frequencies, and six carriers): within
    ``chip_smoke.RATIO_TOL`` relative, the same survivors (the sondes)."""
    import chip_smoke as cs
    from radiosonde_auto_rx_tpu_torch.detect.prescreen import MARGIN
    from radiosonde_auto_rx_tpu_torch.ops.channelizer import \
        extract_channels
    n, fs = 16, 768_000
    wide = cs.synth_stream(n, fs, 1, carriers=cs.carriers_for) \
        .astype(np.float32) / 32768.0
    freqs = [f for _, _, f, _, _ in cs.sondes_for(n, fs)] + \
        cs.carriers_for(n, fs)
    out = []
    for d in (dev, torch.device("cpu")):
        rows = extract_channels(wide, fs, freqs, n, d)
        rows = rows - rows.mean(dim=-1, keepdim=True) * 0.98
        out.append(SondeDetector(fs // n, device=d).prescreen.scores(rows))
    got, want = out[0].cpu(), out[1]
    assert out[0].device == dev
    assert float(((got - want).abs() / want.abs()).max()) <= cs.RATIO_TOL
    assert (got >= MARGIN).tolist() == (want >= MARGIN).tolist() == \
        [True] * 3 + [False] * 6


def test_kernels_refuse_bad_input(dev):
    with pytest.raises(ValueError):
        fft.fft(torch.zeros(2, 2, 96, device=dev))
    with pytest.raises(ValueError):
        fft.fft_abs2(torch.zeros(2, 2, 8192, device=dev),
                     torch.ones(8192, device=dev))
    with pytest.raises(ValueError):
        fft.fft_abs2(torch.zeros(2, 2, 96, device=dev),
                     torch.ones(96, device=dev))
    cfg = _cfg("RS41")
    k = _consts(cfg, dev)
    xw = torch.zeros(2, 2, cfg.nmem, device=dev)
    with pytest.raises(ValueError):
        fsk_sf.freq_est_sf(xw[:, :, ::2], torch.zeros(2, cfg.ndft,
                                                      device=dev),
                           k.wc, k.ws, k.starts, k.weights, k.decay)
    # operands the kernel does not compute with (it reads only wc's DC
    # column as the window): refused, no launch
    before = kernels.launches["freq_est_sf"]
    with pytest.raises(ValueError):
        fsk_sf.freq_est_sf(xw, torch.zeros(2, cfg.ndft, device=dev), k.wc,
                           -k.ws, k.starts, k.weights, k.decay)
    assert kernels.launches["freq_est_sf"] == before


def test_station_cuda_equals_cpu(dev):
    """The slice at 8 channels: the CUDA station (kernels) decodes the
    same telemetry as the CPU station (twins)."""
    import chip_smoke as cs
    n, fs = 8, 384_000
    stream = cs.synth_stream(n, fs, 2)
    runs = [cs.split_blocks(stream, fs, 1)]
    with cs.DemodCalls() as calls:
        gpu, launches = cs.drive_station(dev, runs, n, fs)
    cpu, _ = cs.drive_station(torch.device("cpu"), runs, n, fs)
    assert launches["fsk_scan"] == calls.calls > 0
    assert launches["freq_est_sf"] == 0 and launches["fft_abs2"] > 0
    got = sorted(map(cs._key, gpu[0][1]))
    assert got and got == sorted(map(cs._key, cpu[0][1]))


def test_sequential_stations_cuda_equal_cpu(dev):
    """``use_mesh: false`` at 16 channels with phase 9's carriers (nine
    candidates: the prescreen runs), and an L-band block at 960 kHz: the
    CUDA stations find and decode what the CPU stations do, one scan
    launch per demod call."""
    import chip_smoke as cs
    n, fs = 16, 768_000
    stream = cs.synth_stream(n, fs, 2, carriers=cs.carriers_for)
    runs = [cs.split_blocks(stream, fs, 2)]
    with cs.DemodCalls() as calls:
        gpu, launches = cs.drive_station(dev, runs, n, fs, manual=False,
                                         use_mesh=False)
    cpu, _ = cs.drive_station(torch.device("cpu"), runs, n, fs,
                              manual=False, use_mesh=False)
    assert launches["fsk_scan"] == calls.calls > 0
    assert launches["freq_est_sf"] == 0 and launches["fft_abs2"] > 0
    assert gpu[0][0].stats["detections"] == 3
    assert cs.same_tasks(gpu[0][2][0][0], cpu[0][2][0][0])
    got = sorted(map(cs._key, gpu[0][1]))
    assert got and got == sorted(map(cs._key, cpu[0][1]))
    lb, f_off = cs.lband_stream(960_000, 4, 2)
    out = []
    for d in (dev, torch.device("cpu")):
        st = cs.lband_station(d, 960_000, 4)
        out.append((sorted(map(cs._lkey, st.process_captures([lb],
                                                              [cs.LBAND]))),
                    cs.tasks_of(st)))
    assert out[0] == out[1] and out[0][0]


def test_detecting_station_cuda_equals_cpu(dev):
    """With no task, the CUDA station finds the three sondes as the CPU
    station does, block by block, and decodes the same telemetry."""
    import chip_smoke as cs
    n, fs = 8, 384_000
    stream = cs.synth_stream(n, fs, 2)
    runs = [cs.split_blocks(stream, fs, 1)]
    with cs.DemodCalls() as calls:
        gpu, launches = cs.drive_station(dev, runs, n, fs, manual=False)
    cpu, _ = cs.drive_station(torch.device("cpu"), runs, n, fs,
                              manual=False)
    assert launches["fsk_scan"] == calls.calls > 0
    assert launches["freq_est_sf"] == 0 and launches["fft_abs2"] > 0
    assert gpu[0][0].stats["detections"] == 3
    for (t_g, _), (t_c, _) in zip(gpu[0][2], cpu[0][2]):
        assert cs.same_tasks(t_g, t_c)
    got = sorted(map(cs._key, gpu[0][1]))
    assert got and got == sorted(map(cs._key, cpu[0][1]))


@pytest.mark.parametrize("c", [1, 2])
@pytest.mark.parametrize("name", ["RS41", "M10", "DFM", "MTS01", "RS92NGP",
                                  "FSK4"])
def test_fsk_scan_unbuffered_matches_twin(dev, name, c):
    """The unbuffered mode (the demod CLI's: each window at
    [ptr - nmem, ptr)) against ``fsk_scan_ref(buffered=False)`` run on a
    CPU copy: from the initial state with probe outputs (one launch,
    counted in both counters), then with window starts clamped at both
    ends (channel 0's pointer at 0, the last's past the input)."""
    cfg = cs.cfg_of(name)
    t = cfg.nmem + 8 * cfg.block_advance_max
    x = torch.from_numpy(cs.fsk_signal(cfg, c, t, seed=c))
    nb = fsk.fsk_num_blocks(cfg, t)
    st0 = fsk.fsk_init_state(cfg, c, "cpu")
    before = dict(kernels.launches)
    got = fsk.fsk_scan(cfg, x.to(dev), fsk.fsk_init_state(cfg, c, dev), nb,
                       probe=True, buffered=False)
    assert kernels.launches["fsk_scan"] == before["fsk_scan"] + 1
    assert kernels.launches["fsk_scan_unbuffered"] == \
        before["fsk_scan_unbuffered"] + 1
    cs.scan_diff(cs._on_cpu(got),
                 fsk.fsk_scan_ref(cfg, x, st0, nb, probe=True,
                                  buffered=False), name)
    st0["ptr"][0] = 0
    st0["ptr"][-1] = t + cfg.n
    got = fsk.fsk_scan(cfg, x.to(dev), {k: v.to(dev) for k, v in
                                        st0.items()}, nb, buffered=False)
    cs.scan_diff(cs._on_cpu(got),
                 fsk.fsk_scan_ref(cfg, x, st0, nb, buffered=False), name)


def test_unbuffered_stream_launches_once(dev, monkeypatch):
    """``fsk_demod_stream(buffered=False)`` on a CUDA tensor is one
    unbuffered scan launch and never the twin."""
    def refuse(*a, **k):
        raise AssertionError("the twin was called on a CUDA tensor")
    monkeypatch.setattr(fsk, "fsk_scan_ref", refuse)
    cfg = cs.cfg_of("RS41")
    x = torch.from_numpy(cs.fsk_signal(cfg, 2, cfg.fs, seed=4)).to(dev)
    before = dict(kernels.launches)
    soft, bits, stats, state = fsk.fsk_demod_stream(cfg, x, dev,
                                                    buffered=False)
    nb = fsk.fsk_num_blocks(cfg, cfg.fs)
    assert soft.shape == bits.shape == (2, nb * cfg.nsym)
    assert kernels.launches["fsk_scan_unbuffered"] == \
        before["fsk_scan_unbuffered"] + 1
    assert kernels.launches["fsk_scan"] == before["fsk_scan"] + 1


def test_demod_cli_on_the_card_equals_cpu(dev):
    """``demod.cli.run`` on an RS41 stream of test frames: the same hard
    bits on the card as on the CPU, one unbuffered launch a chunk."""
    import io
    from radiosonde_auto_rx_tpu_torch.demod import cli
    from radiosonde_auto_rx_tpu_torch.demod.modulate import (add_awgn,
                                                             gfsk_mod)
    tx = np.tile(cli.test_frame_bits(), 60)
    iq = add_awgn(gfsk_mod(tx, 48000, 4800, 2, 0.0, 5000), 14.0, 48000,
                  4800, rng=np.random.default_rng(3))
    wire = np.empty(2 * len(iq), np.int16)
    wire[0::2] = np.clip(iq.real * 16384, -32767, 32767)
    wire[1::2] = np.clip(iq.imag * 16384, -32767, 32767)
    out = {}
    for d in ("cuda", "cpu"):
        o = io.BytesIO()
        kernels.reset_launches()
        rc = cli.run(cli.parse_args(
            ["--device", d, "-p", "5", "--nsym", "300", "-b", "-5000", "-u",
             "5000", "--mask", "5000", "--hardout", "2", "48000", "4800",
             "-", "-"]), stdin=io.BytesIO(wire.tobytes()), stdout=o,
            stderr=io.StringIO())
        out[d] = (rc, o.getvalue(), dict(kernels.launches))
    assert out["cuda"][0] == out["cpu"][0] == 0
    assert out["cuda"][1] and out["cuda"][1] == out["cpu"][1]
    n = out["cuda"][2]["fsk_scan_unbuffered"]
    assert n > 1 and out["cuda"][2]["fsk_scan"] == n
    assert not any(out["cpu"][2].values())


def test_station_cli_replay_on_the_card_equals_cpu(dev, tmp_path):
    """``station.main.run_station`` replaying a cs16 capture (8 channels,
    the three sondes, no task, the pool at its default) writes the same
    per-sonde log rows on the card as on the CPU."""
    from radiosonde_auto_rx_tpu_torch.station import main as cli
    from radiosonde_auto_rx_tpu_torch.station.config import default_config
    n, fs = 8, 384_000
    cap = tmp_path / "cap.cs16"
    cs.write_cs16(cap, cs.synth_stream(n, fs, 4))
    rows = {}
    for d in ("cuda", "cpu"):
        cfg = {**default_config(), **cs.STATION_CFG, "capture_rate": fs,
               "num_channels": n, "frame_plane_workers": -1,
               "sondehub_enabled": False}
        args = cli.parse_args(["--device", d, "--replay", str(cap),
                               "--no-web", "--center",
                               str(cs.CENTER / 1e6), "--log-dir",
                               str(tmp_path / d)])
        assert cli.run_station(args, cfg) == cli.EXIT_OK
        rows[d] = cs.log_rows(tmp_path / d)
    assert len(rows["cuda"]) == 3 and rows["cuda"] == rows["cpu"]


def test_mesh_station_cuda_equals_cpu(dev):
    """A (2, 2) virtual mesh of the card, ``mesh_time_shards`` 2, a 4 s
    block at 8 channels with no task: the CUDA mesh station finds and
    decodes what the CPU station on the same mesh does, the RS41s and
    the DFM through the experts' scans, one launch each."""
    from radiosonde_auto_rx_tpu_torch.parallel.mesh import make_mesh
    n, fs = 8, 384_000
    stream = cs.synth_stream(n, fs, 4)
    cpu = torch.device("cpu")
    with cs.DemodCalls() as calls:
        gpu, launches = cs.drive_station(
            dev, [[stream]], n, fs, manual=False, mesh_time_shards=2,
            mesh=make_mesh(2, 2, devices=[dev] * 4))
    ref, _ = cs.drive_station(cpu, [[stream]], n, fs, manual=False,
                              mesh_time_shards=2,
                              mesh=make_mesh(2, 2, devices=[cpu] * 4))
    assert calls.routed > 0 and launches["fsk_scan"] == calls.calls
    assert launches["freq_est_sf"] == 0 and launches["fft_abs2"] > 0
    assert gpu[0][0].stats["detections"] == 3
    assert cs.same_tasks(gpu[0][2][0][0], ref[0][2][0][0])
    got = sorted(map(cs._key, gpu[0][1]))
    assert got and got == sorted(map(cs._key, ref[0][1]))


def test_detector_running_sums_repeat_on_one_row(dev):
    """The detector's running sums of a one-row stream on the card give
    the same bits on every call (``correlator._row_cumsum``), the bits
    of that row scanned in a batch of two."""
    from radiosonde_auto_rx_tpu_torch.detect.correlator import \
        _windowed_sums
    g = torch.Generator(device=dev).manual_seed(9)
    x = torch.randn(2, 144000, generator=g, device=dev) * 0.3 + 0.01
    lens = [2000, 4800, 7680]
    first = _windowed_sums(x[:1], lens)
    for _ in range(20):
        assert torch.equal(_windowed_sums(x[:1], lens), first)
    assert torch.equal(_windowed_sums(x, lens)[:1], first)


def test_sharded_modules_cuda_equal_cpu(dev):
    """``make_station_step`` on a (4, 2) virtual mesh of the card and
    ``make_pp_demod_pipeline`` on a 3-stage one: the CPU port's bits on
    the same meshes, one scan launch a shard (a microbatch)."""
    from radiosonde_auto_rx_tpu_torch.demod.fsk import FSKConfig
    from radiosonde_auto_rx_tpu_torch.ops.fir import design_lowpass
    from radiosonde_auto_rx_tpu_torch.parallel.mesh import make_mesh
    from radiosonde_auto_rx_tpu_torch.parallel.pipeline import \
        make_station_step
    from radiosonde_auto_rx_tpu_torch.parallel.pp import (
        make_pp_demod_pipeline, make_stage_mesh)
    cfg = cs.cfg_of("RS41")
    taps = design_lowpass(0.2, 25)
    x = torch.from_numpy(cs.fsk_signal(cfg, 8, 96000, seed=3))
    cpu = torch.device("cpu")
    out = []
    for d in (dev, cpu):
        kernels.reset_launches()
        out.append((make_station_step(cfg, make_mesh(
            4, 2, devices=[d] * 8), taps)(x.to(d))[1].cpu(),
            kernels.launches["fsk_scan"]))
    assert torch.equal(out[0][0], out[1][0]) and out[0][1] == 8
    pcfg = FSKConfig(**cs.PP_CFG)
    xs = torch.from_numpy(cs.fsk_signal(pcfg, 2, 5 * cs.PP_T_MB, seed=4))
    xs = xs.reshape(2, 2, 5, cs.PP_T_MB).permute(2, 0, 1, 3).contiguous()
    bits = []
    for d in (dev, cpu):
        kernels.reset_launches()
        run = make_pp_demod_pipeline(pcfg, make_stage_mesh(3, devices=[d] * 3),
                                     taps, channels=2, t_mb=cs.PP_T_MB)
        bits.append(run(xs.to(d))[1].cpu())
        if d == dev:
            assert kernels.launches["fsk_scan_unbuffered"] == 5
    assert torch.equal(bits[0], bits[1])


def test_bench_line_on_the_card(dev, capsys):
    """``bench.main()`` on the card at a cut geometry (2 captures, 5
    calls a trial): every key, every number finite and positive, wall at
    or above device ms, the launches a step as ``chip_smoke.bench_plan``
    says."""
    import json
    from radiosonde_auto_rx_tpu_torch import bench
    geo = bench.Geometry(64, 48000, 2, 2_400_000, 2_400_000, 6, 5)
    assert bench.main([], geometry=geo) == 0
    res = json.loads(capsys.readouterr().out)
    cs.check_bench_line(res, len(set(bench.ACTIVES)))
    assert res["extra"]["device"] == bench.card_line()


def test_entry_on_the_card_equals_cpu(dev):
    """``graft_entry.entry()``'s step on the card: one unbuffered scan
    launch, the CPU step's bits, soft within ``chip_smoke.ENTRY_TOL`` of
    its peak."""
    from radiosonde_auto_rx_tpu_torch import graft_entry
    fn, args = graft_entry.entry(dev)
    kernels.reset_launches()
    soft, bits = fn(*args)
    torch.cuda.synchronize()
    assert kernels.launches["fsk_scan_unbuffered"] == 1
    assert kernels.launches["fsk_scan"] == 1
    cfn, cargs = graft_entry.entry(torch.device("cpu"))
    csoft, cbits = cfn(*cargs)
    assert torch.equal(bits.cpu(), cbits)
    assert float((soft.cpu() - csoft).abs().max()) <= \
        cs.ENTRY_TOL * float(csoft.abs().max())

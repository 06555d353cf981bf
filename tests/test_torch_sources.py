"""The port's sample-source layer (``sources/*``, copies of the JAX
package's): the cases of ``tests/test_sources.py`` — command builders,
CSV parsers, IQ ingestion, demod-stats tracking, with no SDR hardware —
and the WIDEBAND ``get_power_spectrum``, which computes the PSD on the
device it is given (K2 on a CUDA one), against the JAX package's on the
same block: the same frequencies, the PSD in dB within 1e-3 dB (float32
Welch sums in another order), the same peak."""

import io

import numpy as np
import pytest
import torch

from radiosonde_auto_rx_tpu.sources import \
    get_power_spectrum as ref_power_spectrum

from radiosonde_auto_rx_tpu_torch.sources import (
    DemodStatsTracker, IQStreamSource, cs16_to_planes, cu8_to_planes,
    get_power_spectrum, get_sdr_fm_cmd, get_sdr_iq_cmd, get_sdr_name,
    read_ka9q_power_log, read_rtl_power_log)
from radiosonde_auto_rx_tpu_torch.sources.ka9q import (
    ka9q_pcm_host, ka9q_ssrc, ka9q_tune_cmd)


# ---------------------------------------------------------------- commands

def test_rtlsdr_iq_cmd():
    cmd = get_sdr_iq_cmd("RTLSDR", 404.5e6, 48000, rtl_device_idx="1",
                         ppm=5, gain=30.0, bias=True)
    assert cmd.startswith("rtl_fm -M raw -F9 -T ")
    assert "-p 5" in cmd and "-d 1" in cmd and "-g 30.0" in cmd
    assert "-s 48000" in cmd and "-f 404500000" in cmd
    assert cmd.rstrip().endswith("|")
    # no iq_dec DC-block stage: that runs on device here
    assert "iq_dec" not in cmd


def test_spyserver_iq_cmd():
    cmd = get_sdr_iq_cmd("SpyServer", 402e6, 48000,
                         sdr_hostname="sdr.local", sdr_port=5555)
    assert "./ss_iq" in cmd and "-r sdr.local" in cmd and "-q 5555" in cmd


def test_fm_cmd_has_sox_resample():
    cmd = get_sdr_fm_cmd("RTLSDR", 1680e6, 220000, 48000,
                         highpass=20, lowpass=2600)
    assert "rtl_fm -M fm -F9" in cmd and "-s 220000" in cmd
    assert "sox -t raw -r 220000" in cmd and "-r 48000" in cmd
    assert "highpass 20" in cmd and "lowpass 2600" in cmd


def test_sdr_names():
    assert get_sdr_name("RTLSDR", rtl_device_idx="2") == "RTLSDR 2"
    assert "KA9Q" in get_sdr_name("KA9Q", sdr_hostname="x.local")


# ------------------------------------------------------------------- ka9q

def test_ka9q_ssrc_convention():
    # freq kHz + 01/04 suffix (reference ka9q.py:23-27)
    assert ka9q_ssrc(404.09e6, scan=False) == "40409001"
    assert ka9q_ssrc(404.09e6, scan=True) == "40409004"


def test_ka9q_tune_cmd():
    cmd = ka9q_tune_cmd("sonde.local", 404.09e6, 48000)
    assert "--samprate 48000" in cmd and "--mode iq" in cmd
    assert "--ssrc 40409001" in cmd and "--radio sonde.local" in cmd
    # default channel filter = ±samprate/2.4 (reference ka9q.py:33-35)
    assert "--low -20000" in cmd and "--high 20000" in cmd


def test_ka9q_pcm_host():
    assert ka9q_pcm_host("sonde.local") == "sonde-pcm.local"


# ---------------------------------------------------------------- parsers

def test_rtl_power_log_roundtrip(tmp_path):
    p = tmp_path / "log.csv"
    powers = ", ".join(f"{v:.2f}" for v in np.linspace(-30, -10, 8))
    p.write_text(
        f"2026-08-17, 00:00:00, 400000000, 403000000, 800, 8, {powers}\n")
    freq, power, step = read_rtl_power_log(str(p))
    assert step == 800
    assert len(freq) == len(power) == 8
    assert freq[0] == 400e6 and freq[-1] == 403e6
    assert power[0] == pytest.approx(-30, abs=0.01)


def test_ka9q_power_log_skips_header(tmp_path):
    p = tmp_path / "log.csv"
    powers = ",".join(f"{v:.2f}" for v in np.linspace(-40, -20, 4))
    p.write_text("header line\n"
                 f"2026-08-17T00:00:00,400000000,406000000,1500000,4,{powers}\n")
    freq, power, step = read_ka9q_power_log(str(p))
    assert len(freq) == 4 and step == 1500000
    assert power[-1] == pytest.approx(-20, abs=0.01)


def test_wideband_power_spectrum_on_device():
    rng = np.random.default_rng(0)
    fs, fc = 2_400_000, 402_500_000
    t = np.arange(fs // 10) / fs
    iq = (0.02 * (rng.standard_normal(len(t)) +
                  1j * rng.standard_normal(len(t))))
    iq += np.exp(2j * np.pi * 300e3 * t)       # tone at fc+300k
    freq, power, step = get_power_spectrum(
        "WIDEBAND", 401.5e6, 403.5e6, wideband_iq=iq.astype(np.complex64),
        capture_rate=fs, centre_hz=fc, device=torch.device("cpu"))
    assert len(freq) and step > 0
    pk = freq[np.argmax(power)]
    assert abs(pk - (fc + 300e3)) < 5e3


@pytest.mark.parametrize("step", [800, 5000])
def test_wideband_power_spectrum_matches_reference(step):
    rng = np.random.default_rng(step)
    fs, fc = 2_400_000, 402_500_000
    t = np.arange(fs // 10) / fs
    iq = (0.02 * (rng.standard_normal(len(t)) +
                  1j * rng.standard_normal(len(t))))
    iq += 0.5 * np.exp(2j * np.pi * -410e3 * t)
    iq = iq.astype(np.complex64)
    kw = dict(step=step, wideband_iq=iq, capture_rate=fs, centre_hz=fc)
    f_r, p_r, s_r = ref_power_spectrum("WIDEBAND", 401.9e6, 403.1e6, **kw)
    f_p, p_p, s_p = get_power_spectrum("WIDEBAND", 401.9e6, 403.1e6,
                                       device=torch.device("cpu"), **kw)
    assert s_p == s_r and len(f_p) > 100
    np.testing.assert_array_equal(f_p, f_r)
    np.testing.assert_allclose(p_p, p_r, rtol=0, atol=1e-3)
    assert np.argmax(p_p) == np.argmax(p_r)


def test_wideband_power_spectrum_needs_a_device():
    iq = np.zeros(4096, np.complex64)
    with pytest.raises(ValueError, match="device"):
        get_power_spectrum("WIDEBAND", 401.5e6, 403.5e6, wideband_iq=iq,
                           capture_rate=2_400_000, centre_hz=402_500_000)


# --------------------------------------------------------------- ingestion

def test_cu8_conversion():
    buf = bytes([0, 255, 127, 128])
    planes = cu8_to_planes(buf)
    assert planes.shape == (2, 2)
    assert planes[0, 0] == pytest.approx(-127.5 / 128)
    assert planes[1, 0] == pytest.approx(127.5 / 128)


def test_cs16_conversion():
    buf = np.array([-32768, 32767, 0, 16384], "<i2").tobytes()
    planes = cs16_to_planes(buf)
    assert planes.shape == (2, 2)
    assert planes[0, 0] == -1.0
    assert planes[1, 1] == pytest.approx(0.5)


def test_stream_source_blocks_and_overlap():
    n = 1000
    iq = np.arange(2 * n, dtype="<i2").tobytes()
    src = IQStreamSource(io.BytesIO(iq), fmt="cs16", block_samples=256,
                         overlap=16)
    blocks = list(src.blocks())
    assert len(blocks) == 3                     # 1000 // 256
    assert all(b.shape == (2, 272) for b in blocks)
    # overlap: first 16 samples of block k = last 16 of block k-1
    np.testing.assert_array_equal(blocks[1][:, :16], blocks[0][:, -16:])
    assert src.samples_read == 768


def test_stream_source_eof_partial():
    src = IQStreamSource(io.BytesIO(b"\0" * 100), fmt="cs16",
                         block_samples=256)
    assert src.read_block() is None


# ------------------------------------------------------------------ stats

def test_demod_stats_windowing():
    trk = DemodStatsTracker(averaging_time=5.0)
    for i in range(10):
        trk.update(10.0 + i, 1.0, [1000.0, 5800.0], t=float(i))
    # window keeps t in [4, 9] -> snrs 14..19 mean=16.5
    assert trk.snr == pytest.approx(16.5)
    assert trk.fest == [1000.0, 5800.0]
    assert trk.ppm == pytest.approx(1.0)


def test_demod_stats_peak_hold():
    trk = DemodStatsTracker(averaging_time=10.0, peak_hold=True)
    trk.update(5.0, 0.0, [0.0], t=0.0)
    trk.update(12.0, 0.0, [0.0], t=1.0)
    trk.update(7.0, 0.0, [0.0], t=2.0)
    assert trk.snr == 12.0


def test_demod_stats_from_stream_dict():
    stats = {"ebno_db": np.array([[8.0, 9.0, 10.0]]),
             "ppm": np.array([[0.5, 0.5, 0.5]]),
             "f_est": np.array([[[1000.0, 5800.0]] * 3])}
    trk = DemodStatsTracker(averaging_time=100.0)
    trk.update_block(stats, channel=0, t0=0.0, block_period=3.0)
    assert trk.snr == pytest.approx(9.0)
    assert trk.fest_mean == pytest.approx(3400.0)


def test_spyserver_power_cmd(monkeypatch, tmp_path):
    """SpyServer PSD branch builds the reference ss_power command and
    parses the CSV output (reference sdr_wrappers.py:706-767)."""
    from radiosonde_auto_rx_tpu_torch.sources import sdr_wrappers as sw
    import subprocess as sp
    seen = {}

    def fake_check_output(cmd, shell=True, stderr=None):
        seen["cmd"] = cmd
        log = cmd.rsplit(" ", 1)[-1]
        with open(log, "w") as f:
            f.write("2024-01-01, 00:00:00, 400000000, 400002400, 800, 1, "
                    "-20.0, -21.0, -22.0\n")
        return b""

    monkeypatch.setattr(sp, "check_output", fake_check_output)
    freq, power, step = sw.get_power_spectrum(
        "SpyServer", 400.0e6, 400.0024e6, step=800,
        sdr_hostname="sshost", sdr_port=5555)
    assert "ss_power" in seen["cmd"]
    assert "-r sshost" in seen["cmd"] and "-q 5555" in seen["cmd"]
    assert "-o" in seen["cmd"].split()
    assert freq is not None and len(power) == 3


def test_native_width_planes_value_identical():
    """int16/uint8 wire planes scaled ON-DEVICE must equal the host-side
    float conversions bit-for-bit (the scales are exact powers of two),
    so shipping native width changes transfer size only."""
    import numpy as np
    from radiosonde_auto_rx_tpu_torch.sources.iq_source import (
        cs16_to_planes, cs16_to_planes_raw, cu8_to_planes,
        cu8_to_planes_raw)
    from radiosonde_auto_rx_tpu_torch.station.station import Station

    rng = np.random.default_rng(0)
    buf16 = rng.integers(-32768, 32768, 4096, np.int16).tobytes()
    f32 = cs16_to_planes(buf16)
    i16 = cs16_to_planes_raw(buf16)
    assert i16.dtype == np.int16
    st = Station(device="cpu")
    dev = st._wide_planes(i16).numpy()
    np.testing.assert_array_equal(dev, f32)

    buf8 = rng.integers(0, 256, 4096, np.int64).astype(np.uint8).tobytes()
    f32u = cu8_to_planes(buf8)
    u8 = cu8_to_planes_raw(buf8)
    assert u8.dtype == np.uint8
    devu = st._wide_planes(u8).numpy()
    np.testing.assert_array_equal(devu, f32u)

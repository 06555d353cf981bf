"""SDR abstraction: test/reset/name/shutdown + capture command builders.

Functional equivalent of the reference's SDR layer (reference
auto_rx/autorx/sdr_wrappers.py:19-867 and ka9q.py:16-175), re-scoped for
the TPU station: instead of one narrowband command per task, one wideband
IQ capture feeds the on-device channelizer, so the IQ command here is
normally built once at ``capture_rate`` (2.4 MHz+).  The narrowband
builders are kept API-compatible so reference deployments can be driven
unchanged; DC removal / IF filtering that the reference delegates to an
``iq_dec`` pipe stage (sdr_wrappers.py:316-323) happens on-device in
``ops.fir`` instead, so no extra pipe stage is emitted.

All builders are pure (return the command string); process management is
the caller's job — keeping these pure makes them unit-testable without
hardware, which the reference never achieved (its tests need an SDR).
"""

import logging
import os
import shutil
import subprocess

import numpy as np

from radiosonde_auto_rx_tpu_torch.utils.process import timeout_cmd


# --------------------------------------------------------------------------- #
# identification / health
# --------------------------------------------------------------------------- #

def get_sdr_name(sdr_type: str, rtl_device_idx="0", sdr_hostname="",
                 sdr_port=5555) -> str:
    """Human-readable SDR identifier (reference sdr_wrappers.py:212-241)."""
    if sdr_type == "RTLSDR":
        return f"RTLSDR {rtl_device_idx}"
    if sdr_type == "SpyServer":
        return f"SpyServer {sdr_hostname}:{sdr_port}"
    if sdr_type == "KA9Q":
        return f"KA9Q {sdr_hostname}"
    if sdr_type == "WIDEBAND":
        return f"Wideband {sdr_hostname or 'capture'}"
    return f"UNKNOWN {sdr_type}"


def test_sdr(sdr_type: str, rtl_device_idx="0", sdr_hostname="",
             sdr_port=5555, frequency: float = 402e6,
             check_freq: bool = True) -> bool:
    """Verify an SDR/source is usable (reference sdr_wrappers.py:19-177).

    RTLSDR: run a short `rtl_sdr` test capture.  SpyServer: short `ss_iq`
    read.  KA9Q: resolve the server with `tune` metadata query.
    WIDEBAND (file/UDP replay) is always available.
    """
    if sdr_type == "WIDEBAND":
        return True

    if sdr_type == "RTLSDR":
        if shutil.which("rtl_sdr") is None:
            logging.critical("SDR Test - rtl_sdr not found on PATH")
            return False
        _cmd = (f"{timeout_cmd()} 5 rtl_sdr -d {rtl_device_idx} "
                f"-n 200000 -f {int(frequency)} /dev/null")
        try:
            subprocess.check_output(_cmd, shell=True,
                                    stderr=subprocess.STDOUT)
            return True
        except subprocess.CalledProcessError as e:
            logging.critical(
                f"SDR Test - rtl_sdr failed with code {e.returncode}")
            return False

    if sdr_type == "SpyServer":
        if not os.path.isfile("./ss_iq"):
            logging.critical("SDR Test - ss_iq binary not found")
            return False
        _cmd = (f"{timeout_cmd()} 10 ./ss_iq -f {int(frequency)} -s 48000 "
                f"-r {sdr_hostname} -q {sdr_port} -n 48000 - > /dev/null")
        try:
            subprocess.check_output(_cmd, shell=True,
                                    stderr=subprocess.STDOUT)
            return True
        except subprocess.CalledProcessError as e:
            logging.critical(
                f"SDR Test - ss_iq failed with code {e.returncode}")
            return False

    if sdr_type == "KA9Q":
        ok = shutil.which("tune") is not None
        if not ok:
            logging.critical("SDR Test - KA9Q 'tune' binary not found")
        return ok

    logging.critical(f"SDR Test - unknown SDR type {sdr_type}")
    return False


def reset_sdr(sdr_type: str, rtl_device_idx="0", sdr_hostname="",
              sdr_port=5555) -> None:
    """Reset an SDR (reference sdr_wrappers.py:180-209): only RTLSDRs can
    be reset (USB re-enumeration); network SDRs are stateless here."""
    if sdr_type == "RTLSDR":
        from radiosonde_auto_rx_tpu_torch.utils.usb import reset_rtlsdr_by_serial
        reset_rtlsdr_by_serial(rtl_device_idx)
    else:
        logging.debug(f"No reset action for SDR type {sdr_type}")


def shutdown_sdr(sdr_type: str, sdr_hostname="", frequency: float = 0,
                 scan: bool = False) -> None:
    """Release an SDR channel (reference sdr_wrappers.py:244-266): only
    KA9Q holds server-side channel state that needs closing."""
    if sdr_type == "KA9Q" and frequency:
        from radiosonde_auto_rx_tpu_torch.sources.ka9q import ka9q_close_channel
        ka9q_close_channel(sdr_hostname, frequency, scan)


# --------------------------------------------------------------------------- #
# capture command builders (pure)
# --------------------------------------------------------------------------- #

def get_sdr_iq_cmd(sdr_type: str, frequency: float, sample_rate: int,
                   rtl_device_idx="0", ppm=0, gain=-1, bias=False,
                   sdr_hostname="", sdr_port=5555, fast_filter=False,
                   scan=False, channel_filter=None) -> str:
    """Build a command producing cs16 IQ on stdout
    (reference sdr_wrappers.py:270-376).

    Unlike the reference, no ``iq_dec`` DC-block pipe stage is appended —
    DC removal runs on-device (ops.fir.dc_block) where it is free.
    """
    if sdr_type == "RTLSDR":
        _gain = f"-g {gain:.1f} " if gain is not None and gain >= 0 else ""
        _agc = "-E agc " if gain == -2 else ""
        return (f"rtl_fm -M raw "
                f"{'' if fast_filter else '-F9 '}"
                f"{'-T ' if bias else ''}"
                f"-p {int(ppm)} -d {rtl_device_idx} "
                f"{_gain}{_agc}"
                f"-s {int(sample_rate)} -f {int(frequency)} - 2>/dev/null |")

    if sdr_type == "SpyServer":
        return (f"./ss_iq -f {int(frequency)} -s {int(sample_rate)} "
                f"-r {sdr_hostname} -q {sdr_port} - 2>/dev/null|")

    if sdr_type == "KA9Q":
        from radiosonde_auto_rx_tpu_torch.sources.ka9q import ka9q_get_iq_cmd
        return ka9q_get_iq_cmd(sdr_hostname, frequency, sample_rate, scan,
                               channel_filter, setup=False)

    if sdr_type == "WIDEBAND":
        # file replay source: hostname doubles as the capture path
        return f"cat {sdr_hostname} |"

    logging.critical(f"IQ Source - unsupported SDR type {sdr_type}")
    return "false |"


def get_sdr_fm_cmd(sdr_type: str, frequency: float, filter_bandwidth: int,
                   sample_rate: int, rtl_device_idx="0", ppm=0, gain=-1,
                   bias=False, highpass=None, lowpass=None) -> str:
    """Build an FM-audio capture command (reference sdr_wrappers.py:379-453):
    rtl_fm narrowband FM demod + sox resample to wav.  Only used for the
    1680 MHz FM fallback path; everything below 1 GHz is IQ into the
    channelizer."""
    if sdr_type != "RTLSDR":
        logging.critical(f"FM Source - unsupported SDR type {sdr_type}")
        return "false |"
    _gain = f"-g {gain:.1f} " if gain is not None and gain >= 0 else ""
    _cmd = (f"rtl_fm -M fm -F9 "
            f"{'-T ' if bias else ''}"
            f"-p {int(ppm)} -d {rtl_device_idx} "
            f"{_gain}"
            f"-s {int(filter_bandwidth)} -f {int(frequency)} 2>/dev/null | "
            f"sox -t raw -r {int(filter_bandwidth)} -e s -b 16 -c 1 - "
            f"-r {int(sample_rate)} -b 16 -t wav - ")
    if highpass:
        _cmd += f"highpass {int(highpass)} "
    if lowpass:
        _cmd += f"lowpass {int(lowpass)} "
    _cmd += "2> /dev/null |"
    return _cmd


# --------------------------------------------------------------------------- #
# power spectrum
# --------------------------------------------------------------------------- #

def read_rtl_power_log(log_filename: str, sdr_name: str = "SDR"):
    """Parse an rtl_power CSV log (reference sdr_wrappers.py:456-509).

    Lines: date,time,start_hz,stop_hz,step_hz,n,p0,p1,...
    Returns (freq [Hz], power [dB], freq_step).
    """
    freqs, powers, step = [], [], 0.0
    with open(log_filename) as f:
        for line in f:
            fields = line.split(",", 6)
            if len(fields) < 7:
                raise ValueError(
                    f"Scanner ({sdr_name}) - corrupt rtl_power log line")
            start_f, stop_f, step = (float(fields[2]), float(fields[3]),
                                     float(fields[4]))
            samples = np.fromstring(fields[6], sep=",")
            freqs.append(np.linspace(start_f, stop_f, len(samples)))
            powers.append(samples)
    freq = np.concatenate(freqs) if freqs else np.array([])
    power = np.nan_to_num(np.concatenate(powers) if powers else np.array([]))
    return freq, power, step


def read_ka9q_power_log(log_filename: str, sdr_name: str = "SDR"):
    """Parse a KA9Q `powers` CSV log (reference sdr_wrappers.py:511-568):
    a header line, then datetime,start_hz,stop_hz,step_hz,n,p0,...."""
    freqs, powers, step = [], [], 0.0
    with open(log_filename) as f:
        for i, line in enumerate(f):
            if i == 0:
                continue                       # header
            fields = line.rstrip().split(",", 5)
            if len(fields) < 6:
                raise ValueError(
                    f"Scanner ({sdr_name}) - corrupt powers log line")
            start_f, stop_f, step = (float(fields[1]), float(fields[2]),
                                     float(fields[3]))
            samples = np.fromstring(fields[5], sep=",")
            freqs.append(np.linspace(start_f, stop_f, len(samples)))
            powers.append(samples)
    freq = np.concatenate(freqs) if freqs else np.array([])
    power = np.nan_to_num(np.concatenate(powers) if powers else np.array([]))
    return freq, power, step


def get_power_spectrum(sdr_type: str, frequency_start: float,
                       frequency_stop: float, step: int = 800,
                       integration_time: int = 20, rtl_device_idx="0",
                       ppm=0, gain=-1, bias=False, sdr_hostname="",
                       sdr_port=5555, wideband_iq=None, capture_rate=None,
                       centre_hz=None, device=None):
    """PSD over the scan range → (freq [Hz], power [dB], step [Hz])
    (reference sdr_wrappers.py:571-831).

    WIDEBAND (the on-device path): compute the PSD on ``device`` (no
    default: a torch device, where K2 runs for a CUDA one) from the
    supplied wideband IQ block — no subprocess, no CSV round-trip.
    RTLSDR/KA9Q: spawn the reference's `rtl_power`/`powers` utilities and
    parse their CSV logs, so hardware deployments keep working.
    """
    if sdr_type == "WIDEBAND":
        assert wideband_iq is not None and capture_rate and centre_hz
        if device is None:
            raise ValueError("get_power_spectrum('WIDEBAND') needs the "
                             "device to compute the PSD on")
        from radiosonde_auto_rx_tpu_torch.detect.psd import power_spectrum
        nfft = max(64, min(8192, int(2 ** np.round(np.log2(
            capture_rate / max(step, 1))))))
        freq_rel, power = power_spectrum(wideband_iq, device, nfft=nfft,
                                         fs=capture_rate)
        freq = np.asarray(freq_rel) + centre_hz
        sel = (freq >= frequency_start) & (freq <= frequency_stop)
        st = float(freq[1] - freq[0]) if len(freq) > 1 else 0.0
        return freq[sel], power[sel], st

    log_file = f"/tmp/scan_{os.getpid()}.csv"
    if sdr_type == "RTLSDR":
        _gain = f"-g {gain:.1f} " if gain is not None and gain >= 0 else ""
        _cmd = (f"{timeout_cmd()} {integration_time * 2} rtl_power "
                f"-p {int(ppm)} -d {rtl_device_idx} "
                f"{'-T ' if bias else ''}{_gain}"
                f"-f {int(frequency_start)}:{int(frequency_stop)}:{step} "
                f"-i {integration_time} -1 -c 25% {log_file}")
        try:
            subprocess.check_output(_cmd, shell=True,
                                    stderr=subprocess.STDOUT)
        except subprocess.CalledProcessError as e:
            logging.error(f"Scanner - rtl_power failed ({e.returncode})")
            return None, None, None
        return read_rtl_power_log(log_file, get_sdr_name(sdr_type,
                                                         rtl_device_idx))

    if sdr_type == "SpyServer":
        # ss_power PSD sweep (reference sdr_wrappers.py:706-767); -o
        # returns spectrum even when the requested centre is outside a
        # locked SpyServer's tuning range
        _freq_c = int(frequency_start
                      + (frequency_stop - frequency_start) / 2.0)
        _cmd = (f"{timeout_cmd()} {integration_time + 10} ss_power "
                f"-f {_freq_c} -i {integration_time} -1 -o "
                f"-r {sdr_hostname} -q {sdr_port} {log_file}")
        try:
            subprocess.check_output(_cmd, shell=True,
                                    stderr=subprocess.STDOUT)
        except subprocess.CalledProcessError as e:
            out = e.output.decode("ascii", "replace")
            if "outside currently allowed range" in out:
                logging.critical(
                    "Scanner - scan centre %d Hz outside the allowed "
                    "SpyServer tuning range" % _freq_c)
            else:
                logging.error(f"Scanner - ss_power failed "
                              f"({e.returncode}): {out}")
            return None, None, None
        return read_rtl_power_log(log_file, get_sdr_name(
            sdr_type, sdr_hostname=sdr_hostname, sdr_port=sdr_port))

    if sdr_type == "KA9Q":
        _freq_c = (frequency_start + frequency_stop) / 2
        _n = int((frequency_stop - frequency_start) / step)
        _cmd = (f"{timeout_cmd()} {integration_time * 2} powers "
                f"-f {_freq_c} -w {step} -b {_n} "
                f"-i {integration_time} -c 1 {sdr_hostname} > {log_file}")
        try:
            subprocess.check_output(_cmd, shell=True,
                                    stderr=subprocess.STDOUT)
        except subprocess.CalledProcessError as e:
            logging.error(f"Scanner - powers failed ({e.returncode})")
            return None, None, None
        return read_ka9q_power_log(log_file, get_sdr_name(sdr_type,
                                                          sdr_hostname=sdr_hostname))

    logging.critical(f"Scanner - unsupported SDR type {sdr_type}")
    return None, None, None

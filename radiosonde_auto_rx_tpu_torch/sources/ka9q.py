"""KA9Q-radio client: channel lifecycle + IQ stream command.

Equivalent of the reference's KA9Q glue (reference auto_rx/autorx/ka9q.py
:16-175).  KA9Q-radio is a multichannel SDR server: `tune` creates or
retunes a virtual channel addressed by SSRC, `pcmrecord` streams its
samples.  SSRC convention matches the reference so both can share a
server: freq_kHz suffixed with 01 (decode) or 04 (scan)
(ka9q.py:23-27,44).

For the TPU station KA9Q is the preferred *wideband* front-end: one
channel at the full capture rate replaces the reference's per-sonde
channels — the polyphase channelizer does the per-sonde split on device.
"""

import logging
import subprocess

from radiosonde_auto_rx_tpu_torch.utils.process import timeout_cmd


def ka9q_ssrc(frequency: float, scan: bool) -> str:
    """SSRC naming convention (reference ka9q.py:23-27): freq in kHz
    suffixed with 01 (decoder channel) or 04 (scanner channel)."""
    return f"{round(frequency / 1000)}{'04' if scan else '01'}"


def ka9q_tune_cmd(sdr_hostname: str, frequency: float, sample_rate: int,
                  scan: bool = False, channel_filter=None) -> str:
    """The `tune` invocation creating/retuning a channel
    (reference ka9q.py:28-48)."""
    if channel_filter:
        low, high = -int(channel_filter), int(channel_filter)
    else:
        low = int(int(sample_rate) / -2.4)
        high = int(int(sample_rate) / 2.4)
    return (f"{timeout_cmd()} 5 tune "
            f"--samprate {int(sample_rate)} --mode iq "
            f"--low {low} --high {high} "
            f"--frequency {int(frequency)} "
            f"--ssrc {ka9q_ssrc(frequency, scan)} "
            f"--radio {sdr_hostname}")


def _run(cmd: str, what: str, sdr_hostname: str) -> bool:
    try:
        subprocess.check_output(cmd, shell=True, stderr=subprocess.STDOUT,
                                timeout=10)
        return True
    except subprocess.TimeoutExpired:
        logging.critical(f"KA9Q ({sdr_hostname}) - tune timed out {what}")
        return False
    except subprocess.CalledProcessError as e:
        if e.returncode == 127:
            logging.critical(f"KA9Q ({sdr_hostname}) - 'tune' not found")
        else:
            logging.critical(f"KA9Q ({sdr_hostname}) - tune failed {what} "
                             f"(code {e.returncode})")
        return False


def ka9q_setup_channel(sdr_hostname: str, frequency: float,
                       sample_rate: int, scan: bool = False,
                       channel_filter=None) -> bool:
    """Create a channel (reference ka9q.py:16-81)."""
    cmd = ka9q_tune_cmd(sdr_hostname, frequency, sample_rate, scan,
                        channel_filter)
    logging.debug(f"KA9Q - opening channel at {frequency} Hz: {cmd}")
    return _run(cmd, "opening channel", sdr_hostname)


def ka9q_close_channel(sdr_hostname: str, frequency: float,
                       scan: bool = False) -> bool:
    """Release a channel by tuning it to 0 Hz (reference ka9q.py:84-131)."""
    cmd = (f"{timeout_cmd()} 5 tune --samprate 48000 --mode iq "
           f"--frequency 0 --ssrc {ka9q_ssrc(frequency, scan)} "
           f"--radio {sdr_hostname}")
    logging.debug(f"KA9Q - closing channel at {frequency} Hz")
    return _run(cmd, "closing channel", sdr_hostname)


def ka9q_pcm_host(sdr_hostname: str) -> str:
    """PCM stream hostname: '-pcm' appended to the first label
    (reference ka9q.py:150-152)."""
    parts = sdr_hostname.split(".")
    return parts[0] + "-pcm." + ".".join(parts[1:])


def ka9q_get_iq_cmd(sdr_hostname: str, frequency: float, sample_rate: int,
                    scan: bool = False, channel_filter=None,
                    setup: bool = True) -> str:
    """`pcmrecord` command streaming cs16 IQ for one channel
    (reference ka9q.py:134-175).  With ``setup`` the channel is created
    first; scan-channel setup failure raises IOError so async scanning
    can skip the peak (ka9q.py:140-147)."""
    if setup:
        ok = ka9q_setup_channel(sdr_hostname, frequency, sample_rate, scan,
                                channel_filter)
        if not ok:
            logging.critical(f"KA9Q ({sdr_hostname}) - channel setup failed")
            if scan:
                raise IOError(
                    f"Failed to setup KA9Q channel at {frequency} Hz")
    return (f"pcmrecord --ssrc {ka9q_ssrc(frequency, scan)} "
            f"--catmode --raw {ka9q_pcm_host(sdr_hostname)} |")

"""RTLSDR USB reset + presence test.

Equivalent of the reference's USB plumbing (reference
auto_rx/autorx/utils.py:691-915: `reset_usb`, `reset_rtlsdr_by_serial`,
`is_rtlsdr`, `rtlsdr_test`).  Linux-only (ioctl USBDEVFS_RESET); no-ops
gracefully elsewhere.  These exist for RTLSDR hardware deployments — the
wideband/TPU path has no USB devices to babysit.
"""

import fcntl
import glob
import logging
import os
import subprocess

from radiosonde_auto_rx_tpu_torch.utils.process import timeout_cmd

USBDEVFS_RESET = ord("U") << 8 | 20

# RTLSDR-compatible USB vendor:product IDs (reference utils.py:824-840)
RTLSDR_IDS = {("0bda", "2832"), ("0bda", "2838")}


def reset_usb(bus: int, device: int) -> bool:
    """ioctl reset of one USB device (reference utils.py:691-716)."""
    path = f"/dev/bus/usb/{bus:03d}/{device:03d}"
    try:
        with open(path, "w", os.O_WRONLY) as fd:
            fcntl.ioctl(fd, USBDEVFS_RESET, 0)
        return True
    except (IOError, OSError, PermissionError) as e:
        logging.error(f"USB - could not reset {path}: {e}")
        return False


def _usb_device_ids():
    """Yield (bus, dev, vendor, product, serial) from sysfs — the
    reference shells out to lsusb (utils.py:719-778); sysfs needs no
    subprocess and gives the serial directly."""
    for dev_path in glob.glob("/sys/bus/usb/devices/[0-9]*"):
        try:
            def rd(name):
                p = os.path.join(dev_path, name)
                with open(p) as f:
                    return f.read().strip()
            yield (int(rd("busnum")), int(rd("devnum")),
                   rd("idVendor"), rd("idProduct"),
                   rd("serial") if os.path.exists(
                       os.path.join(dev_path, "serial")) else "")
        except (IOError, OSError, ValueError):
            continue


def is_rtlsdr(vid: str, pid: str) -> bool:
    return (vid, pid) in RTLSDR_IDS


def reset_rtlsdr_by_serial(serial) -> bool:
    """Reset every RTLSDR whose USB serial matches (reference
    utils.py:781-822).  Device indices 0..N are accepted too: rtl_sdr
    serials default to '00000001'-style strings."""
    serial = str(serial)
    found = False
    for bus, dev, vid, pid, dev_serial in _usb_device_ids():
        if is_rtlsdr(vid, pid) and (dev_serial == serial or
                                    dev_serial.lstrip("0") == serial):
            logging.info(f"USB - resetting RTLSDR {serial} "
                         f"(bus {bus} dev {dev})")
            found = reset_usb(bus, dev) or found
    if not found:
        logging.debug(f"USB - no RTLSDR with serial {serial} found")
    return found


def rtlsdr_test(device_idx="0", rtl_sdr_path="rtl_sdr",
                retries: int = 2) -> bool:
    """Short test read from an RTLSDR, with reset-and-retry (reference
    utils.py:918-1004)."""
    _cmd = (f"{timeout_cmd()} 10 {rtl_sdr_path} -d {device_idx} "
            f"-n 200000 - > /dev/null")
    for _ in range(retries):
        try:
            subprocess.check_output(_cmd, shell=True,
                                    stderr=subprocess.STDOUT)
            return True
        except subprocess.CalledProcessError:
            logging.warning(f"RTLSDR {device_idx} test failed; resetting")
            reset_rtlsdr_by_serial(device_idx)
    return False

"""Welch PSD scanning, scan-peak picking and sonde-type detection by
template correlation."""

from radiosonde_auto_rx_tpu_torch.detect.correlator import (
    Detection, correlate_bank, detect_types)
from radiosonde_auto_rx_tpu_torch.detect.psd import (
    detect_peaks, power_spectrum, scan_peaks)
from radiosonde_auto_rx_tpu_torch.detect.templates import (
    TEMPLATES, TemplateSpec, build_template_bank)

__all__ = ["Detection", "correlate_bank", "detect_types", "detect_peaks",
           "power_spectrum", "scan_peaks", "TEMPLATES", "TemplateSpec",
           "build_template_bank"]

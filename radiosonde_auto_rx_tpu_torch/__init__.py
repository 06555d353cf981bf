"""radiosonde_auto_rx_tpu_torch — the station's PyTorch/CUDA port.

A second package beside ``radiosonde_auto_rx_tpu`` (the JAX reference,
which stays as it is).  Module paths mirror the reference, so the
counterpart of ``radiosonde_auto_rx_tpu/demod/fsk.py`` is
``radiosonde_auto_rx_tpu_torch/demod/fsk.py``.

Conventions:

* The port imports ``torch`` and never ``jax``, nor anything of the
  reference package: it keeps its own copies of the reference's
  NumPy-only host modules (frame decoders, ECC, framing, modulator,
  templates, telemetry, config, frame plane, utils, the native host
  runtime), at the same paths, with only their imports renamed.
* IQ is float32 ``[..., 2, T]`` re/im planes, as in the reference; all
  device math is float32.
* Functions that take host (NumPy) data take an explicit ``device``;
  functions on tensors run on their tensors' device.
* The reference's three TPU kernels are hand-written CUDA C++ for
  Hopper (``csrc/``, built by ``kernels``).  Their wrappers
  (``ops.fsk_sf.freq_est_sf``, ``ops.fft.fft_abs2``, ``ops.fft.fft``)
  use the plain PyTorch twin for CPU tensors only; for CUDA tensors they
  launch the kernel or raise.

Layout:
    kernels/    nvcc build + ctypes binding of csrc/*.cu, launch counters
    csrc/       CUDA C++ kernels (sm_90a)
    ops/        channelizer, FFT (K3) and |DFT|^2 (K2), freq-est pass
                (K1), resampler, FIR filters, FM discriminator
    demod/      buffered FSK demodulator; framing and modulator (copies)
    detect/     Welch PSD, scan peaks, template bank, correlator and the
                sonde detector
    parallel/   single-device station step (channelize + PSD + demod,
                candidate confirmation)
    station/    chain table and Station; config, telemetry, frame
                plane and GPS ephemeris (copies)
    models/ ecc/ utils/ native/   copies of the reference's host code
"""

__version__ = "0.1.0"

# Telemetry fields required before a frame is passed to exporters
# (reference auto_rx/autorx/decode.py:88-96).
DECODER_REQUIRED_FIELDS = ["frame", "id", "datetime", "lat", "lon", "alt"]

# Defaults merged into telemetry when a decoder does not supply them
# (reference auto_rx/autorx/decode.py:99-107).
DECODER_OPTIONAL_FIELDS = {
    "temp": -273.0,
    "humidity": -1.0,
    "pressure": -1,
    "batt": -1,
    "vel_h": -9999.0,
    "vel_v": -9999.0,
    "heading": -9999.0,
}

# Sonde types the framework understands (reference auto_rx/autorx/decode.py:29-47).
VALID_SONDE_TYPES = [
    "RS92",
    "RS41",
    "DFM",
    "M10",
    "M20",
    "IMET",
    "IMET5",
    "MK2LMS",
    "LMS6",
    "MEISEI",
    "MRZ",
    "MTS01",
    "UDP",
    "WXR301",
    "WXRPN9",
    "RS92-NGP",
    "DROPSONDE",
]

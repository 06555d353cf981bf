"""DSP primitives on float32 ``[..., 2, T]`` planes (and complex
tensors where the reference takes complex IQ), plus the wrappers of the
three hand-written kernels (``fsk_sf``: K1, ``fft``: K2 and K3)."""

from radiosonde_auto_rx_tpu_torch.ops.fir import (
    decimate, design_lowpass, fir_filter, fir_filter_streaming)
from radiosonde_auto_rx_tpu_torch.ops.fm import (
    dc_offset, fm_discriminate, iq_dc_removal)
from radiosonde_auto_rx_tpu_torch.ops.mixer import freq_shift, nco_phase
from radiosonde_auto_rx_tpu_torch.ops.windows import (
    hann_periodic, hann_symmetric)

__all__ = ["decimate", "design_lowpass", "fir_filter", "fir_filter_streaming",
           "dc_offset", "fm_discriminate", "iq_dc_removal", "freq_shift",
           "nco_phase", "hann_periodic", "hann_symmetric"]

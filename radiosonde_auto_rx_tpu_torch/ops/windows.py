"""Window functions.

Port of ``radiosonde_auto_rx_tpu/ops/windows.py``: the reference fsk
demod uses a symmetric Hann window over ``Ndft-1`` (reference
utils/fsk.c:91-98).  Built in float64 on the host, then float32 on
``device``.
"""

import numpy as np
import torch


def hann_symmetric(n: int, device) -> torch.Tensor:
    """0.5 - 0.5*cos(2*pi*i/(n-1)) — matches reference utils/fsk.c:96."""
    i = np.arange(n, dtype=np.float64)
    w = 0.5 - 0.5 * np.cos(2.0 * np.pi * i / (n - 1))
    return torch.from_numpy(w.astype(np.float32)).to(device)


def hann_periodic(n: int, device) -> torch.Tensor:
    """Periodic Hann (DFT-even), for spectral estimation with overlapping
    hops."""
    i = np.arange(n, dtype=np.float64)
    w = 0.5 - 0.5 * np.cos(2.0 * np.pi * i / n)
    return torch.from_numpy(w.astype(np.float32)).to(device)

"""DSP primitives on float32 ``[..., 2, T]`` planes, plus the wrappers of
the three hand-written kernels (``fsk_sf``: K1, ``fft``: K2 and K3)."""

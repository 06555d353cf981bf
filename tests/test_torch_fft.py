"""K3: the port's ``ops.fft.fft`` (its plain twin on the CPU) against the
JAX package's ``pallas_fft.fft`` in Pallas interpret mode.

N = 64 .. 1024 go through one direct DFT in both packages (the Pallas
``_fft_kernel`` in the reference, ``fft_ref`` here); N = 2048 and 4096
through ``method="four-step"`` (the reference's two ``_cmatmul_pallas``
stages, the port's twiddle and transposes around two direct stages) and
``method="auto"`` (a plain matmul in both).  Inputs are made with numpy
from a seed, with a Hann window.  Tolerance per bin: |port - JAX| <=
1e-4·(|JAX| + the row's RMS), float32 on both sides in another
summation order — the tolerance ``chip_smoke.py`` holds the kernel to.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from radiosonde_auto_rx_tpu.ops import pallas_fft
from radiosonde_auto_rx_tpu_torch import kernels
from radiosonde_auto_rx_tpu_torch.ops import fft

torch.set_num_threads(1)
TOL = 1e-4


def _inputs(b, n, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, 2, n)).astype(np.float32)
    win = np.hanning(n).astype(np.float32)
    return x, win


def _per_bin_close(got, want):
    want = np.asarray(want)
    mag = np.hypot(want[:, 0], want[:, 1])                    # [B, N]
    rms = np.sqrt(np.mean(mag ** 2, axis=-1, keepdims=True))
    diff = np.hypot(*(np.asarray(got) - want).transpose(1, 0, 2))
    assert float((diff / (mag + rms)).max()) <= TOL


@pytest.mark.parametrize("n", [64, 128, 256, 512, 1024])
def test_fft_matches_pallas_interpret(n):
    x, win = _inputs(5, n, n)
    want = pallas_fft.fft(jnp.asarray(x), win=jnp.asarray(win),
                          interpret=True)
    got = fft.fft(torch.from_numpy(x), torch.from_numpy(win))
    assert got.shape == (5, 2, n) and got.dtype == torch.float32
    _per_bin_close(got.numpy(), want)
    _per_bin_close(fft.fft_ref(torch.from_numpy(x), win).numpy(), want)


@pytest.mark.parametrize("n,method", [(2048, "four-step"), (4096, "four-step"),
                                      (2048, "auto")])
def test_fft_large_matches_pallas_interpret(n, method):
    x, win = _inputs(3, n, n + 1)
    want = pallas_fft.fft(jnp.asarray(x), win=jnp.asarray(win),
                          interpret=True, method=method)
    got = fft.fft(torch.from_numpy(x), torch.from_numpy(win), method=method)
    _per_bin_close(got.numpy(), want)


def test_fft_takes_complex_input_and_no_window():
    x, _ = _inputs(4, 256, 7)
    z = torch.complex(torch.from_numpy(x[:, 0]), torch.from_numpy(x[:, 1]))
    want = np.fft.fft(x[:, 0].astype(np.float64) + 1j * x[:, 1])
    got = fft.fft(z).numpy()
    _per_bin_close(got, np.stack([want.real, want.imag], axis=1))


def test_fft_cpu_takes_the_twin_and_refuses_bad_input():
    before = dict(kernels.launches)
    fft.fft(torch.zeros(2, 2, 64))
    fft.fft(torch.zeros(2, 2, 2048), method="four-step")
    assert kernels.launches == before            # no kernel on the CPU
    with pytest.raises(ValueError):
        fft.fft(torch.zeros(2, 2, 96))
    with pytest.raises(ValueError):
        fft.fft(torch.zeros(2, 3, 64))

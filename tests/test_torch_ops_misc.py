"""The port's remaining small ops against the JAX package's, on the CPU:
the windows, the NCO mixer, the complex resampler, ``correlate_bank``
and the two packages' exports.

Tolerances: windows equal (both float64 on the host, then float32);
``nco_phase`` to 2e-6 cycles and ``freq_shift`` to 1e-5 (float32 phase
and rotation in another order); the resampler to 1e-5 of its output's
peak (float32 matmuls); ``correlate_bank`` scores and DC terms to 1e-4
(the float32 running sums of the normalization, as
``tests/test_torch_detect.py`` states).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import radiosonde_auto_rx_tpu.detect as ref_detect
import radiosonde_auto_rx_tpu.ops as ref_ops
from radiosonde_auto_rx_tpu.ops import resample as ref_resample
import radiosonde_auto_rx_tpu_torch.detect as detect
import radiosonde_auto_rx_tpu_torch.ops as ops
from radiosonde_auto_rx_tpu_torch.ops import resample

from test_detect import _fm_of_header

torch.set_num_threads(1)
CPU = torch.device("cpu")


@pytest.mark.parametrize("n", [64, 255, 512])
def test_windows_match_reference(n):
    for name in ("hann_symmetric", "hann_periodic"):
        got = getattr(ops, name)(n, CPU)
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy(),
                                      np.asarray(getattr(ref_ops, name)(n)))


def test_mixer_matches_reference():
    fs = 48000
    k = np.array([-5000.0, 1234.5, 9000.0]) / fs
    want = np.asarray(ref_ops.nco_phase(jnp.asarray(k), 4096, t0=7.0))
    got = ops.nco_phase(torch.from_numpy(k), 4096, CPU, t0=7.0).numpy()
    d = np.abs(got - want)
    np.testing.assert_array_less(np.minimum(d, 1 - d), 2e-6)
    t = np.arange(4096) / fs
    x = np.exp(2j * np.pi * 5000 * t).astype(np.complex64)
    want = np.asarray(ref_ops.freq_shift(jnp.asarray(x), -5000 / fs))
    got = ops.freq_shift(torch.from_numpy(x), -5000 / fs)
    assert got.dtype == torch.complex64
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
    # the tone is at DC (JAX tests/test_ops.py:72)
    y = got.numpy()
    assert np.abs(np.mean(np.angle(y[1:] * np.conj(y[:-1])))) < 1e-3


@pytest.mark.parametrize("fs_in,fs_out", [(48000, 48080), (96000, 48000),
                                          (48000, 48000)])
def test_complex_resample_matches_reference(fs_in, fs_out):
    rng = np.random.default_rng(fs_out)
    x = (rng.standard_normal((2, 5000)) +
         1j * rng.standard_normal((2, 5000))).astype(np.complex64)
    want = np.asarray(ref_resample.resample(jnp.asarray(x), fs_in, fs_out))
    got = resample.resample(torch.from_numpy(x), fs_in, fs_out)
    assert got.dtype == torch.complex64 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=1e-5 * np.abs(want).max())
    # complex = its two planes through resample_planes
    planes = torch.from_numpy(np.stack([x.real, x.imag], axis=1))
    p = resample.resample_planes(planes, fs_in, fs_out)
    np.testing.assert_array_equal(torch.complex(p[:, 0], p[:, 1]).numpy(),
                                  got.numpy())


@pytest.mark.parametrize("name", ["RS41", "DFM"])
def test_correlate_bank_matches_reference(name):
    fm, hdr_end = _fm_of_header(name)
    bank, lens, specs = detect.build_template_bank(48000)
    s_w, dc_w = (np.asarray(v) for v in
                 ref_detect.correlate_bank(fm, bank, lens))
    s_g, dc_g = (v.numpy() for v in
                 detect.correlate_bank(torch.from_numpy(fm), bank, lens))
    assert s_g.shape == s_w.shape == (1, len(specs),
                                      len(fm) - bank.shape[1] + 1)
    np.testing.assert_allclose(s_g, s_w, rtol=0, atol=1e-4)
    np.testing.assert_allclose(dc_g, dc_w, rtol=0, atol=1e-4)
    # the header's own template peaks at its end (JAX test_detect.py)
    k = [s.name for s in specs].index(name)
    pk = int(np.argmax(np.abs(s_g[0, k])))
    assert abs(pk + lens[k] - hdr_end) <= 2 and abs(s_g[0, k, pk]) > 0.8


# the names JAX ops/__init__.py and detect/__init__.py export
EXPORTS = {
    "ops": ("hann_periodic", "hann_symmetric", "design_lowpass",
            "fir_filter", "fir_filter_streaming", "decimate", "freq_shift",
            "nco_phase", "fm_discriminate", "iq_dc_removal"),
    "detect": ("TEMPLATES", "TemplateSpec", "build_template_bank",
               "correlate_bank", "detect_types", "Detection",
               "power_spectrum", "detect_peaks", "scan_peaks"),
}


@pytest.mark.parametrize("pkg", sorted(EXPORTS))
def test_exports_match_reference(pkg):
    ref, port = {"ops": (ref_ops, ops), "detect": (ref_detect, detect)}[pkg]
    for name in EXPORTS[pkg]:
        assert hasattr(ref, name), name
        assert name in port.__all__ and hasattr(port, name), name

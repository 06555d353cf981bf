"""The two kernels' plain twins against the JAX package's kernels on the
CPU, and the wrappers' dispatch rule.

K1 ``ops.fsk_sf.freq_est_sf_ref`` against ``pallas_fsk.freq_est_sf`` in
Pallas interpret mode and against the einsum path of
``demod/fsk.py::_freq_est``; K2 ``ops.fft.fft_abs2_ref`` against
``pallas_fft.fft_abs2`` in interpret mode (N <= 1024, the Pallas range)
and against ``_direct_xla`` + roll at N = 2048 (the station PSD).
Inputs are made with numpy from a seed.  Tolerances are relative to the
largest reference value (1e-5 for K1's |X| sums, 1e-5 for K2's |X|^2):
float32 on both sides, with the contraction order of XLA's and
PyTorch's matmuls differing.
"""

from types import SimpleNamespace

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from radiosonde_auto_rx_tpu.demod import fsk as ref_fsk
from radiosonde_auto_rx_tpu.ops import pallas_fft, pallas_fsk
from radiosonde_auto_rx_tpu_torch import kernels
from radiosonde_auto_rx_tpu_torch.demod import fsk as port_fsk
from radiosonde_auto_rx_tpu_torch.ops import fft, fsk_sf

torch.set_num_threads(1)

RS41 = dict(fs=48000, rs=4800, m=2, p=5, nsym=300, est_min=-5000,
            est_max=5000, tone_spacing=5000, freq_est_type=1)
M20 = dict(fs=48000, rs=9600, m=2, p=5, nsym=150, est_min=-10000,
           est_max=10000)


def _k1_inputs(kw, c, seed=0):
    cfg = port_fsk.FSKConfig(**kw)
    rng = np.random.default_rng(seed)
    xw = rng.standard_normal((c, 2, cfg.nmem)).astype(np.float32)
    sf = np.abs(rng.standard_normal((c, cfg.ndft))).astype(np.float32)
    k = port_fsk._consts(cfg, torch.device("cpu"))
    return cfg, xw, sf, k


def _rel_close(got, want, rel):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=rel * np.abs(want).max())


@pytest.mark.parametrize("kw", [RS41, M20], ids=["rs41", "m20"])
def test_k1_twin_matches_pallas_interpret(kw):
    cfg, xw, sf, k = _k1_inputs(kw, c=3)
    want = pallas_fsk.freq_est_sf(
        jnp.asarray(xw), jnp.asarray(sf), jnp.asarray(k.wc.numpy()),
        jnp.asarray(k.ws.numpy()), k.starts, k.weights, k.decay,
        interpret=True)
    got = fsk_sf.freq_est_sf(torch.from_numpy(xw), torch.from_numpy(sf),
                             k.wc, k.ws, k.starts, k.weights, k.decay)
    assert got.shape == (3, cfg.ndft) and got.dtype == torch.float32
    _rel_close(got, want, 1e-5)


@pytest.mark.parametrize("kw", [RS41, M20], ids=["rs41", "m20"])
def test_k1_twin_matches_einsum_path(kw):
    cfg, xw, sf, k = _k1_inputs(kw, c=4, seed=1)
    f_r, sf_r = ref_fsk._freq_est(ref_fsk.FSKConfig(**kw), jnp.asarray(xw),
                                  jnp.asarray(sf))
    f_p, sf_p = port_fsk._freq_est(cfg, torch.from_numpy(xw),
                                   torch.from_numpy(sf))
    _rel_close(sf_p, sf_r, 1e-5)
    np.testing.assert_array_equal(f_p.numpy(), np.asarray(f_r))


def _dft_pair(n, win):
    """wc/ws as ``demod.fsk._dft_mats`` builds them, for any window."""
    ang = 2 * np.pi * np.outer(np.arange(n), np.arange(n) - n // 2) / n
    return (torch.from_numpy((win[:, None] * np.cos(ang)).astype(np.float32)),
            torch.from_numpy((win[:, None] * np.sin(ang)).astype(np.float32)))


@pytest.mark.parametrize("ndft", fsk_sf.KERNEL_NDFT)
def test_k1_kernel_takes_only_the_dft_pair(ndft):
    """The kernel reads the window from wc's DC column and does an FFT, so
    its wrapper takes wc/ws only where they are that window's DFT: the
    demod's own pair, or another window's; not a changed, swapped or
    transposed one."""
    wc, ws = (torch.from_numpy(m) for m in port_fsk._dft_mats(
        SimpleNamespace(ndft=ndft)))
    assert fsk_sf.is_dft_pair(wc, ws)
    win = np.random.default_rng(ndft).uniform(0.2, 1.0, ndft)
    assert fsk_sf.is_dft_pair(*_dft_pair(ndft, win))
    bumped = ws.clone()
    bumped[3, 5] += 1e-4
    for bad in ((wc, -ws), (ws, wc), (wc.T.contiguous(), ws), (wc, bumped),
                (wc, torch.full_like(ws, float("nan")))):
        assert not fsk_sf.is_dft_pair(*bad)
    # the check is cached per pair, and taken again once either is written
    wc, ws = wc.clone(), ws.clone()
    assert fsk_sf._dft_pair_ok(wc, ws) and fsk_sf._dft_pair_ok(wc, ws)
    ws[3, 5] += 1e-4
    assert not fsk_sf._dft_pair_ok(wc, ws)


@pytest.mark.parametrize("n", [64, 256, 1024])
@pytest.mark.parametrize("shift", [True, False])
def test_k2_twin_matches_pallas_interpret(n, shift):
    rng = np.random.default_rng(n)
    x = rng.standard_normal((5, 2, n)).astype(np.float32)
    win = (0.5 - 0.5 * np.cos(2 * np.pi * np.arange(n) / (n - 1))) \
        .astype(np.float32)
    want = pallas_fft.fft_abs2(jnp.asarray(x), win=jnp.asarray(win),
                               shift=shift, interpret=True)
    got = fft.fft_abs2(torch.from_numpy(x), torch.from_numpy(win), shift)
    assert got.shape == (5, n)
    _rel_close(got, want, 1e-5)


def test_k2_twin_matches_direct_xla_at_2048():
    n = 2048
    rng = np.random.default_rng(7)
    x = rng.standard_normal((6, 2, n)).astype(np.float32)
    win = rng.uniform(0.5, 1.5, n).astype(np.float32)
    yr, yi = pallas_fft._direct_xla(jnp.asarray(x[:, 0] * win),
                                    jnp.asarray(x[:, 1] * win), n)
    want = jnp.roll(yr * yr + yi * yi, n // 2, axis=-1)
    got = fft.fft_abs2(torch.from_numpy(x), torch.from_numpy(win), True)
    _rel_close(got, want, 1e-5)


def test_k2_strided_segments_equal_rows():
    """A [C, 2, S, N] strided view (the sparse Welch layout) gives the
    same powers as the same segments copied out as [C*S, 2, N] rows."""
    n, hop, s = 256, 1024, 5
    x = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (2, 2, s * hop)).astype(np.float32))
    view = x.reshape(2, 2, s, hop)[..., :n]
    rows = view.permute(0, 2, 1, 3).reshape(2 * s, 2, n)
    win = torch.ones(n)
    got = fft.fft_abs2(view, win, True)
    assert got.shape == (2, s, n)
    np.testing.assert_array_equal(got.reshape(2 * s, n).numpy(),
                                  fft.fft_abs2(rows, win, True).numpy())


def test_wrappers_never_fall_back_off_cpu():
    """Only a CPU tensor reaches a twin: any other device launches the
    kernel or raises (a meta tensor has no kernel)."""
    cfg, xw, sf, k = _k1_inputs(RS41, c=1)
    meta = torch.device("meta")
    with pytest.raises(ValueError):
        fsk_sf.freq_est_sf(torch.from_numpy(xw).to(meta),
                           torch.from_numpy(sf).to(meta), k.wc.to(meta),
                           k.ws.to(meta), k.starts, k.weights, k.decay)
    with pytest.raises(ValueError):
        fft.fft_abs2(torch.zeros(2, 2, 64, device=meta),
                     torch.ones(64, device=meta))
    with pytest.raises(ValueError):
        fft.fft(torch.zeros(2, 2, 64, device=meta))
    # above N = 1024 too, by either method: no plain matmul off the CPU
    for n, method in ((2048, "auto"), (2048, "four-step"), (8192, "auto")):
        with pytest.raises(ValueError):
            fft.fft(torch.zeros(2, 2, n, device=meta), method=method)
    with pytest.raises(ValueError):
        port_fsk.fsk_demod_stream(port_fsk.FSKConfig(**RS41),
                                  torch.zeros(1, 2, 9000), meta)
    assert kernels.launches == {"freq_est_sf": 0, "fft_abs2": 0, "fft": 0,
                                "fsk_scan": 0}


def test_kernel_library_is_built_lazily():
    """Importing the port builds nothing; the build recipe targets
    sm_90a and hashes every CUDA source."""
    assert kernels._lib is None
    assert "arch=compute_90a,code=sm_90a" in kernels.NVCC_FLAGS
    names = {p.name for p in kernels._sources()}
    assert {"fsk_sf.cu", "fsk_scan.cu", "fft_abs2.cu",
            "fft_planes.cu"} <= names


def test_an_edited_header_rebuilds_the_library(tmp_path, monkeypatch):
    """The library's name hashes the ``.cuh`` headers with the ``.cu``
    sources: K2 and K3 are thin files around ``fft_smem.cuh``."""
    import shutil
    src = tmp_path / "csrc"
    shutil.copytree(kernels.CSRC, src)
    monkeypatch.setattr(kernels, "CSRC", src)
    before = kernels.fingerprint()
    assert kernels.fingerprint() == before
    with open(src / "fft_smem.cuh", "a") as f:
        f.write("// edited\n")
    edited = kernels.fingerprint()
    assert edited != before
    with open(src / "fft_abs2.cu", "a") as f:
        f.write("// edited\n")
    assert kernels.fingerprint() not in (before, edited)

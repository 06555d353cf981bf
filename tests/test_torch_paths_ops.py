"""Port parity for the modules of the station's remaining paths, against
the JAX reference on the CPU.

- The buffered FSK demod (``demod/fsk.py``, whose CUDA path is the scan
  kernel) at the chain geometries those paths add: the iMet AFSK audio
  demod (P = 8, ndft 512, a real input: the Q plane zero) and the Weathex
  chains (WXR301 at 96 kHz and WXRPN9 at 100 kHz: ndft 256, the mask
  comb over the whole spectrum).  Hard bits and tone estimates equal,
  soft decisions to 1e-4 of their peak, as ``tests/test_torch_fsk.py``
  (float32 sums in another order).
- The iMet front end (``models/imet4.py::afsk_fm_audio``: IF lowpass, FM
  discriminator, audio lowpass) into that demod.
- ``ops/fm.py`` (``fm_discriminate``, ``iq_dc_removal``, ``dc_offset``)
  and ``ops/fir.py`` (``fir_filter_streaming``, ``decimate``): to 1e-5 of
  the reference's peak (float32 convolutions and complex products in
  another summation order).

Inputs are made with numpy from a seed and handed to both packages.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from radiosonde_auto_rx_tpu.demod import fsk as ref_fsk
from radiosonde_auto_rx_tpu.demod.modulate import add_awgn, gfsk_mod
from radiosonde_auto_rx_tpu.models import imet4 as ref_imet4
from radiosonde_auto_rx_tpu.ops import fir as ref_fir
from radiosonde_auto_rx_tpu.ops import fm as ref_fm
from radiosonde_auto_rx_tpu.station.station import CHAIN_TABLE as REF_TABLE
from radiosonde_auto_rx_tpu.station.station import _demod_cfg as ref_cfg
from radiosonde_auto_rx_tpu_torch import ops
from radiosonde_auto_rx_tpu_torch.demod import fsk as port_fsk
from radiosonde_auto_rx_tpu_torch.models import imet4 as port_imet4
from radiosonde_auto_rx_tpu_torch.station.chains import demod_chain

from test_torch_fsk import _assert_close

torch.set_num_threads(1)
CPU = torch.device("cpu")
OPS_TOL = 1e-5                   # of the reference's peak


def _wide_cfgs(name):
    """(reference cfg, port cfg) of a Weathex chain at its own rate."""
    ch = REF_TABLE[name]
    fs = ch.get("resample_to", ch["wide_fs"])
    return (ref_cfg(fs, ch["rs"], ch.get("est", 10000), ch.get("mask", 0)),
            demod_chain(name, ch["wide_fs"])[0])


def _afsk_planes(fs, seed, c=2, seconds=1.0):
    """Bell-202 audio with noise as [C, 2, T] planes, the Q plane zero."""
    rng = np.random.default_rng(seed)
    t = int(fs * seconds)
    rows = []
    for _ in range(c):
        bits = rng.integers(0, 2, int(seconds * 1200) + 2).astype(np.uint8)
        audio = port_imet4.afsk_modulate(bits, fs)[:t]
        rows.append(audio + 0.1 * rng.standard_normal(t))
    x = np.stack(rows).astype(np.float32)
    return np.stack([x, np.zeros_like(x)], axis=1)


def _run_both(cfg_r, cfg_p, x):
    s_r, b_r, st_r, state_r = ref_fsk.fsk_demod_stream(cfg_r, x)
    s_p, b_p, st_p, state_p = port_fsk.fsk_demod_stream(cfg_p, x, CPU)
    return ((np.asarray(s_r), np.asarray(b_r),
             {k: np.asarray(v) for k, v in st_r.items()},
             {k: np.asarray(v) for k, v in state_r.items()}),
            (s_p.numpy(), b_p.numpy(), {k: v.numpy() for k, v in st_p.items()},
             port_fsk.state_to_numpy(state_p)))


def test_afsk_config_matches_reference():
    for fs in (48000, 96000):
        c_r = ref_imet4.afsk_demod_config(fs)
        c_p = demod_chain("IMET4", fs)[0]
        for f in ("fs", "rs", "m", "p", "nsym", "ts", "tsp", "n", "nmem",
                  "ndft", "est_range", "est_space_bins", "numffts"):
            assert getattr(c_p, f) == getattr(c_r, f), f
    assert demod_chain("IMET4", 48000)[1:] == (None, True)


def test_afsk_stream_matches_reference():
    """The AFSK audio demod: P = 8, ndft 512, est_range (264, 283) on the
    positive tones of a real input."""
    cfg_r = ref_imet4.afsk_demod_config(48000)
    cfg_p = port_imet4.afsk_demod_config(48000)
    assert (cfg_p.p, cfg_p.ndft, cfg_p.est_range) == (8, 512, (264, 283))
    r, p = _run_both(cfg_r, cfg_p, _afsk_planes(48000, seed=4))
    _assert_close(r, p)
    assert r[1].shape[-1] > 0


@pytest.mark.parametrize("name", ["WXR301", "WXRPN9"])
def test_weathex_stream_matches_reference(name):
    """The Weathex chains: 50 kHz tone spacing, the mask comb over the
    whole ndft 256 spectrum (est_range (0, 256))."""
    cfg_r, cfg_p = _wide_cfgs(name)
    assert cfg_p == port_fsk.FSKConfig(**{
        k: getattr(cfg_r, k) for k in cfg_r.__dataclass_fields__})
    assert cfg_p.ndft == 256 and cfg_p.est_range == (0, 256)
    rng = np.random.default_rng(len(name))
    rows = []
    for i in range(2):
        tx = rng.integers(0, 2, cfg_p.rs + 50)            # 1 s of bits
        iq = gfsk_mod(tx, cfg_p.fs, cfg_p.rs, 2, 400.0 * i - 300.0, 50000,
                      bt=1.0)
        rows.append(add_awgn(iq, 14.0, cfg_p.fs, cfg_p.rs, rng=rng))
    t = min(len(q) for q in rows)
    x = np.stack([q[:t] for q in rows]).astype(np.complex64)
    _assert_close(*_run_both(cfg_r, cfg_p, x))


def test_afsk_front_end_and_demod_match_reference():
    """An FM-modulated iMet channel (3 kHz deviation, noise) through
    ``afsk_fm_audio`` (audio to 1e-5 of its peak) and the AFSK demod."""
    rng = np.random.default_rng(6)
    fs = 48000
    bits = rng.integers(0, 2, 1300).astype(np.uint8)
    audio = ref_imet4.afsk_modulate(bits, fs).astype(np.float64)
    z = np.exp(2j * np.pi * np.cumsum(3000.0 * audio + 700.0) / fs)
    z = z + 0.05 * (rng.standard_normal(len(z)) +
                    1j * rng.standard_normal(len(z)))
    planes = np.stack([z.real, z.imag]).astype(np.float32)[None]
    a_r = np.asarray(ref_imet4.afsk_fm_audio(planes, fs))
    a_p = port_imet4.afsk_fm_audio(torch.from_numpy(planes), fs).numpy()
    np.testing.assert_allclose(a_p, a_r, rtol=0,
                               atol=OPS_TOL * np.abs(a_r).max())
    x = np.stack([a_r, np.zeros_like(a_r)], axis=1)
    _assert_close(*_run_both(ref_imet4.afsk_demod_config(fs),
                             port_imet4.afsk_demod_config(fs), x))


def _fm_iq(seed, shape=(2, 3000)):
    """Unit-magnitude FM IQ with a little noise (the discriminator's angle
    is ill-conditioned only where |z| nears 0)."""
    rng = np.random.default_rng(seed)
    ph = np.cumsum(rng.standard_normal(shape) * 0.3, axis=-1)
    z = np.exp(1j * ph) + 0.05 * (rng.standard_normal(shape) +
                                   1j * rng.standard_normal(shape))
    return z.astype(np.complex64)


def _close(got, want):
    want = np.asarray(want)
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert got.shape == want.shape and got.dtype == want.dtype
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=OPS_TOL * np.abs(want).max())


def test_fm_discriminate_matches_reference():
    z = _fm_iq(1)
    _close(ops.fm_discriminate(torch.from_numpy(z)),
           ref_fm.fm_discriminate(jnp.asarray(z)))
    _close(ops.fm_discriminate(torch.from_numpy(z), gain=1.0),
           ref_fm.fm_discriminate(jnp.asarray(z), gain=1.0))


def test_iq_dc_removal_and_dc_offset_match_reference():
    z = _fm_iq(2) + np.complex64(0.3 - 0.2j)
    _close(ops.iq_dc_removal(torch.from_numpy(z)),
           ref_fm.iq_dc_removal(jnp.asarray(z)))
    for x in (z, z.real.copy()):
        _close(ops.fm.dc_offset(torch.from_numpy(x)),
               ref_fm.dc_offset(jnp.asarray(x)))


@pytest.mark.parametrize("cplx", [False, True])
def test_fir_filter_streaming_matches_reference(cplx):
    """Two consecutive blocks, the tail carried from the first into the
    second; the output and the new tail."""
    z = _fm_iq(3, (2, 1200))
    x = z if cplx else z.real.copy()
    h = ref_fir.design_lowpass(0.1, 31)
    tail_r = jnp.zeros((2, 30), x.dtype)
    tail_p = torch.zeros((2, 30), dtype=torch.from_numpy(x).dtype)
    for blk in (x[:, :700], x[:, 700:]):
        y_r, tail_r = ref_fir.fir_filter_streaming(jnp.asarray(blk),
                                                   jnp.asarray(h), tail_r)
        y_p, tail_p = ops.fir_filter_streaming(torch.from_numpy(blk), h,
                                               tail_p)
        _close(y_p, y_r)
        np.testing.assert_array_equal(tail_p.numpy(), np.asarray(tail_r))


@pytest.mark.parametrize("cplx", [False, True])
@pytest.mark.parametrize("factor,taps", [(4, None), (5, 41), (1, None)])
def test_decimate_matches_reference(cplx, factor, taps):
    z = _fm_iq(4, (2, 2003))
    x = z if cplx else z.real.copy()
    h = None if taps is None else ref_fir.design_lowpass(0.4 / factor, taps)
    _close(ops.decimate(torch.from_numpy(x), factor, h),
           ref_fir.decimate(jnp.asarray(x), factor, h))
    _close(ops.decimate(torch.from_numpy(x[0]), factor, h),
           ref_fir.decimate(jnp.asarray(x[0]), factor, h))


def test_design_lowpass_for_transition_exact():
    for c, t in ((0.1, 0.025), (0.45 / 4, 0.1 / 4), (0.2, 0.3)):
        np.testing.assert_array_equal(
            ops.fir.design_lowpass_for_transition(c, t),
            ref_fir.design_lowpass_for_transition(c, t))

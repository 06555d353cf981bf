"""The port's sonde detector against the JAX package's, on the CPU.

``SondeDetector(48000, prescreen=False)`` in both packages, on the same
4 channels × 48,000 samples (1 s at 48 kHz) made with numpy from a
seed: an RS41, a DFM and an M10 frame stream (GFSK at their on-air
rates, 15 dB Eb/N0) and noise alone.

* ``_condition``: each class's FM stream to 1e-4 of its largest value
  (float32 conv and atan2 on both sides, in another summation order).
* ``_correlate_peaks_exact`` on the same stream: ``val``, ``dc`` and
  ``xm`` within 1e-4; ``ipk`` equal except where the row's two best
  |scores| are within 1e-5 of each other (a tie the summation order may
  break either way).
* ``detect``: the same decisions (``name``, ``tn``, ``inverted``) per
  channel, and the expected ones.
* The port's overlap-save ``_corr_fft`` against its direct
  ``_corr_direct``.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from radiosonde_auto_rx_tpu.detect import correlator as ref_corr
from radiosonde_auto_rx_tpu.detect.scanner import SondeDetector as RefDetector
from radiosonde_auto_rx_tpu_torch.demod.modulate import add_awgn, gfsk_mod
from radiosonde_auto_rx_tpu_torch.detect import correlator
from radiosonde_auto_rx_tpu_torch.detect.scanner import SondeDetector
from radiosonde_auto_rx_tpu_torch.detect.templates import build_template_bank

torch.set_num_threads(1)
FS = 48000
T = 48000


def _burst(bits, rs, spacing, bt, rng):
    iq = add_awgn(gfsk_mod(np.asarray(bits, np.uint8), FS, rs, 2, 0.0,
                           spacing, bt=bt), 15.0, FS, rs, rng=rng)
    if len(iq) < T:
        raise RuntimeError("burst shorter than the test block")
    return iq[:T]


@pytest.fixture(scope="module")
def planes():
    import chip_smoke as cs
    from radiosonde_auto_rx_tpu_torch.models.m10 import (encode_frame_m10,
                                                         frame_to_raw_bits)
    rng = np.random.default_rng(17)
    rs41 = cs._rs41_bits("T1357911", -34.5, 138.6, 3, rng)
    dfm = cs._dfm_bits("21054321", 47.9, 16.8, 2, rng)
    m10 = np.concatenate([rng.integers(0, 2, 300)] +
                         [frame_to_raw_bits(encode_frame_m10(
                             tow_ms=388815000 + 1000 * i))
                          for i in range(10)])
    x = np.stack([_burst(rs41, 4800, 4800, 0.5, rng),
                  _burst(dfm, 2500, 5000, 0.5, rng),
                  _burst(m10, 9608, 6000, 1.0, rng),
                  0.05 * (rng.standard_normal(T) +
                          1j * rng.standard_normal(T))])
    p = np.stack([x.real, x.imag], axis=1).astype(np.float32)
    return p - p.mean(axis=-1, keepdims=True) * np.float32(0.98)


@pytest.fixture(scope="module")
def detectors():
    return (RefDetector(FS, prescreen=False),
            SondeDetector(FS, prescreen=False, device="cpu"))


@pytest.fixture(scope="module")
def streams(planes, detectors):
    ref, port = detectors
    want = [np.array(s) for s in ref._condition(jnp.asarray(planes))]
    got = [s.numpy() for s in port._condition(torch.from_numpy(planes))]
    return want, got


def test_condition_streams_match(streams):
    want, got = streams
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        assert g.shape == w.shape == (4, T)
        assert np.abs(g - w).max() <= 1e-4 * np.abs(w).max()


@pytest.mark.parametrize("cls", range(4))
def test_correlate_peaks_match(streams, detectors, cls):
    ref, port = detectors
    fm = streams[0][cls]
    _, _, _, bank, lens = port.classes[cls]
    lens_t = tuple(lens)
    want = [np.asarray(v) for v in ref_corr._correlate_peaks_exact(
        jnp.asarray(fm), ref.classes[cls][3], lens_t)]
    got = [v.numpy() for v in correlator._correlate_peaks_exact(
        torch.from_numpy(fm), bank, lens)]
    for name, i in (("val", 0), ("dc", 2), ("xm", 3)):
        np.testing.assert_allclose(got[i], want[i], rtol=0, atol=1e-4,
                                   err_msg=name)
    # positions: equal unless the row's best two |scores| nearly tie
    corr, xnorm, _ = ref_corr._correlate(jnp.asarray(fm),
                                         ref.classes[cls][3], lens_t)
    top2 = np.sort(np.abs(np.asarray(corr / xnorm)), axis=-1)[..., -2:]
    tie = (top2[..., 1] - top2[..., 0]) < 1e-5
    assert got[1].dtype == np.int32
    assert np.array_equal(got[1][~tie], want[1][~tie])


def test_detect_decisions_match(planes, detectors):
    ref, port = detectors
    want = ref.detect(jnp.asarray(planes), max_det=0, dc_block=False)
    got = port.detect(torch.from_numpy(planes), max_det=0, dc_block=False)

    def key(dets):
        return [[(d.name, d.tn, d.inverted) for d in ch] for ch in dets]

    assert key(got) == key(want)
    best = [ch[0].name if ch else None for ch in got]
    assert best == ["RS41", "DFM", "M10", None]
    for g, w in zip(got, want):
        for dg, dw in zip(g, w):
            assert abs(dg.score - dw.score) < 1e-4
            assert abs(dg.freq_offset - dw.freq_offset) < 0.5


def test_corr_fft_matches_direct():
    bank, _, _ = build_template_bank(FS)
    bank = torch.from_numpy(bank)
    rng = np.random.default_rng(11)
    for C, n in [(2, 20000), (1, 2 * bank.shape[1] + 1)]:
        x = torch.from_numpy(rng.standard_normal((C, n)).astype(np.float32))
        a = correlator._corr_direct(x, bank)
        b = correlator._corr_fft(x, bank)
        assert a.shape == b.shape == (C, bank.shape[0],
                                      n - bank.shape[1] + 1)
        np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=0, atol=5e-5)


def test_detector_refuses_prescreen(planes):
    """Once a refusal, now the reference's default: ``SondeDetector``
    builds the half-rate ``Prescreen`` (as JAX ``test_prescreen_built``),
    and ``prescreen=True`` on these four channels gives the full pass's
    decisions, as the reference's does, on every channel the prescreen
    keeps ([] elsewhere)."""
    from radiosonde_auto_rx_tpu_torch.detect.prescreen import Prescreen
    det = SondeDetector(FS, device="cpu")
    assert isinstance(det.prescreen, Prescreen)
    assert RefDetector(FS).prescreen is not None
    x = torch.from_numpy(planes)
    full = det.detect(x, max_det=0, dc_block=False, prescreen=False)
    got = det.detect(x, max_det=0, dc_block=False, prescreen=True)
    keep = det.prescreen.scores(x).numpy() >= det.prescreen_margin
    assert keep.tolist() == [True, True, True, False]
    assert got == [f if k else [] for f, k in zip(full, keep)]

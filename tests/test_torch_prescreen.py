"""The detection prescreen: the port against the JAX package, on the CPU.

Module parity (the same numpy inputs, made from seeds, through both
packages):

* ``ops/fir.fir_filter_block`` at strides 1 and 2 over an odd and an
  even length: to 1e-5 of the output's peak (float32 convolutions in
  another summation order).
* ``detect/correlator._correlate_peaks_blocknorm_scan`` on a
  conditioned FM stream carrying headers, both ``positions`` modes:
  values to rtol 1e-4 (atol 1e-6 for values near 0), positions equal,
  DC terms and stream means to 1e-5.
* ``Prescreen.template_ratios`` at 48 kHz over the narrow spec set:
  rtol 1e-4, atol 1e-5.
* ``SondeDetector.detect`` with the prescreen forced on and in its auto
  mode (12 channels >= 8): the same detections (name, tn, inverted,
  position; score within 1e-4) on every channel, the same survivors.
* ``StationStep.analyze(screen=True)`` ratios of every channel of two
  768 kHz captures (16 channels each, ``tests/station_fixture.py``)
  against the JAX ``ShardedStationStep`` on a 1-device mesh: 99% of
  them within 1e-4 and all within 1e-2, the same survivors at
  ``MARGIN`` and the same ``expert_assignment``.  The inputs differ
  here (the two channelizers' rows agree to 2e-7 of their peak), and
  the dead-air floor (a block's score is 0 below 0.05·sqrt(L)·rms) is a
  step: on a noise row a block near it scores 0 in one package and its
  ratio in the other (2 of 512 ratios moved by 0.0017 and 0.0041).

Then the four cases of ``tests/test_prescreen.py`` against the port's
detector, and its default: the prescreen is built, as in the reference.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from radiosonde_auto_rx_tpu.detect import correlator as ref_corr
from radiosonde_auto_rx_tpu.detect.scanner import SondeDetector as RefDetector
from radiosonde_auto_rx_tpu.ops import fir as ref_fir
from radiosonde_auto_rx_tpu.parallel.mesh import make_mesh
from radiosonde_auto_rx_tpu.parallel.station_step import ShardedStationStep
from radiosonde_auto_rx_tpu_torch.demod.modulate import add_awgn
from radiosonde_auto_rx_tpu_torch.detect import correlator
from radiosonde_auto_rx_tpu_torch.detect.prescreen import MARGIN, Prescreen
from radiosonde_auto_rx_tpu_torch.detect.scanner import SondeDetector
from radiosonde_auto_rx_tpu_torch.detect.templates import TEMPLATES
from radiosonde_auto_rx_tpu_torch.ops.fir import (design_lowpass,
                                                  fir_filter_block)
from radiosonde_auto_rx_tpu_torch.parallel.station_step import StationStep

from station_fixture import (M20_CAP, M20_CH, N_CHAN, RS41_CAP, RS41_CH,
                             make_wide_captures)
from test_prescreen import _burst, _planes

torch.set_num_threads(1)
FS = 48000
SPECS = {t.name: t for t in TEMPLATES}


def _sonde(name, rng, eb=14.0, f_off=0.0):
    return add_awgn(_burst(SPECS[name], rng, f_off=f_off), eb, FS,
                    SPECS[name].sps, rng=rng)


@pytest.fixture(scope="module")
def planes():
    """4 sondes (RS41, DFM, M10, WXR301 at 14 dB) and 8 noise channels,
    DC-blocked as ``detect`` does (the ``test_prescreen.py`` mix)."""
    rng = np.random.default_rng(5)
    iqs = [_sonde(n, rng) for n in ("RS41", "DFM", "M10", "WXR301")]
    iqs += [(rng.standard_normal(FS) + 1j * rng.standard_normal(FS))
            .astype(np.complex64) * 0.3 for _ in range(8)]
    x = _planes(iqs)
    return x - x.mean(axis=-1, keepdims=True) * np.float32(0.98)


@pytest.fixture(scope="module")
def detectors():
    return RefDetector(FS), SondeDetector(FS, device="cpu")


@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("T", [1001, 1000])
def test_fir_filter_block_stride_matches_reference(stride, T):
    rng = np.random.default_rng(T + stride)
    x = rng.standard_normal((3, T)).astype(np.float32)
    hs = np.stack([design_lowpass(0.1, 31), design_lowpass(0.2, 31)])
    want = np.asarray(ref_fir.fir_filter_block(jnp.asarray(x),
                                               jnp.asarray(hs),
                                               stride=stride))
    got = fir_filter_block(torch.from_numpy(x), torch.from_numpy(hs),
                           stride=stride).numpy()
    assert got.shape == want.shape == (3, 2, -(-T // stride))
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-5 * np.abs(want).max())
    # output i is the 'same'-aligned sample i*stride
    full = fir_filter_block(torch.from_numpy(x), torch.from_numpy(hs))
    np.testing.assert_array_equal(got, full.numpy()[..., ::stride])


@pytest.mark.parametrize("positions", [True, False])
def test_blocknorm_scan_matches_reference(planes, detectors, positions):
    _, port = detectors
    cls = 2                                  # 48 kHz, 4 templates
    fm = port._condition(torch.from_numpy(planes))[cls]
    _, _, _, bank, lens = port.classes[cls]
    lens_t = tuple(int(v) for v in lens)
    want = [np.asarray(v) for v in ref_corr._correlate_peaks_blocknorm_scan(
        jnp.asarray(fm.numpy()), jnp.asarray(bank.numpy()), lens_t,
        positions=positions)]
    got = [v.numpy() for v in correlator._correlate_peaks_blocknorm_scan(
        fm, bank, lens, positions=positions)]
    assert got[1].dtype == np.int32
    np.testing.assert_allclose(got[0], want[0], rtol=1e-4, atol=1e-6)
    np.testing.assert_array_equal(got[1], want[1])
    for i in (2, 3):
        np.testing.assert_allclose(got[i], want[i], rtol=0, atol=1e-5)
    if positions:
        # the exact rescore at the peak equals the exact search's value
        # wherever both pick the same position
        exact = correlator._correlate_peaks_exact(fm, bank, lens)
        same = exact[1].numpy() == got[1]
        assert same.any()
        np.testing.assert_allclose(got[0][same], exact[0].numpy()[same],
                                   rtol=1e-4, atol=1e-5)


def test_template_ratios_match_reference(planes, detectors):
    ref, port = detectors
    want = np.asarray(ref.prescreen.template_ratios(jnp.asarray(planes)))
    got = port.prescreen.template_ratios(torch.from_numpy(planes)).numpy()
    assert [s.name for s in port.prescreen.spec_order] == \
        [s.name for s in ref.prescreen.spec_order]
    assert got.shape == want.shape == (12, len(TEMPLATES))
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
    assert [cl[5] for cl in port.prescreen.classes] == \
        [cl[5] for cl in ref.prescreen.classes]


def _key(dets):
    return [[(d.name, d.tn, d.inverted, d.position) for d in ch]
            for ch in dets]


@pytest.mark.parametrize("mode", [True, None])
def test_detect_with_prescreen_matches_reference(planes, detectors, mode):
    """Forced on, and auto (12 channels: the prescreen runs); rejected
    channels get [] in both packages, survivors the full pass."""
    ref, port = detectors
    want = ref.detect(jnp.asarray(planes), dc_block=False, prescreen=mode)
    got = port.detect(torch.from_numpy(planes), dc_block=False,
                      prescreen=mode)
    assert _key(got) == _key(want)
    for g, w in zip(got, want):
        for dg, dw in zip(g, w):
            assert abs(dg.score - dw.score) < 1e-4
    assert [ch[0].name if ch else None for ch in got[:3]] == \
        ["RS41", "DFM", "M10"]
    # the survivors' detections are the full pass's, exactly
    full = port.detect(torch.from_numpy(planes), dc_block=False,
                       prescreen=False)
    ratio = port.prescreen.scores(torch.from_numpy(planes)).numpy()
    for c, dets in enumerate(got):
        assert dets == (full[c] if ratio[c] >= MARGIN else [])


def test_analyze_screen_matches_reference():
    wide = make_wide_captures()[[RS41_CAP, M20_CAP]]
    mesh = make_mesh(n_ch=1, n_t=1, devices=jax.devices()[:1])
    ref = ShardedStationStep(mesh, n_chan=N_CHAN)
    port = StationStep("cpu", n_chan=N_CHAN)
    _, _, r_want = ref.analyze(jnp.asarray(wide))
    chf, _, r_got = port.analyze(torch.from_numpy(wide))
    r_want, r_got = np.asarray(r_want), r_got.numpy()
    assert r_got.shape == r_want.shape == (2 * N_CHAN, len(TEMPLATES))
    err = np.abs(r_got - r_want)
    assert (err <= 1e-4).mean() >= 0.99 and err.max() <= 1e-2, err.max()
    np.testing.assert_array_equal(r_got >= MARGIN, r_want >= MARGIN)
    # screen=False: the same channels, no ratios
    chf0, _, none = port.analyze(torch.from_numpy(wide), screen=False)
    assert none is None and torch.equal(chf0, chf)
    assert np.array_equal(port.template_expert, ref.template_expert)
    names = [s.name for s in port.prescreen.spec_order]
    assert names[r_got[RS41_CH].argmax()] == "RS41"
    assert r_got[N_CHAN + M20_CH, names.index("M10")] >= MARGIN
    for margin in (1.0, MARGIN):
        got = port.expert_assignment(r_got, margin)
        want = ref.expert_assignment(r_want, margin)
        for g, w in zip(got, want):
            assert g.dtype == np.int32
            np.testing.assert_array_equal(g, w)


def test_detector_defaults_match_reference():
    """The port's detector takes the reference's defaults (ROADMAP F4):
    the prescreen is built, at the reference's margin, and ``detect``
    uses it from 8 channels; L-band builds none."""
    ref, port = RefDetector(FS), SondeDetector(FS, device="cpu")
    assert isinstance(port.prescreen, Prescreen)
    assert port.prescreen_margin == ref.prescreen_margin == MARGIN
    assert SondeDetector(240000, lband=True, device="cpu").prescreen is None
    assert RefDetector(240000, lband=True).prescreen is None
    assert SondeDetector(FS, prescreen=False,
                         device="cpu").prescreen_margin == 0.55
    calls = []
    screen = port.prescreen.scores
    port.prescreen.scores = lambda x: calls.append(len(x)) or screen(x)
    noise = np.random.default_rng(1).standard_normal(
        (8, 2, 9600)).astype(np.float32)
    for c in (7, 8):
        port.detect(torch.from_numpy(noise[:c]))
    assert calls == [8]


# ---------------------------------------------------------------------- #
# tests/test_prescreen.py's cases against the port's detector

@pytest.fixture(scope="module")
def detector(detectors):
    return detectors[1]


def test_prescreen_built(detector):
    assert detector.prescreen is not None


def test_prescreen_never_rejects_full_pass_detections(detector):
    """Types x Eb/N0 x frequency offset: every channel the full pass
    detects clears the prescreen margin."""
    specs = [t for t in TEMPLATES if t.name != "IMETafsk"]
    rng = np.random.default_rng(99)
    cases = []
    for spec in specs:
        for eb in (8.0, 11.0, 20.0):
            for f_off in (0.0, 3000.0):
                cases.append((spec.name, eb, f_off,
                              _sonde(spec.name, rng, eb, f_off)))
    x = _planes([c[3] for c in cases])
    x = torch.from_numpy(x - x.mean(axis=-1, keepdims=True) * 0.98)
    full = detector._detect_full(x, max_det=1)
    ratio = detector.prescreen.scores(x).numpy()
    missed = [(name, eb, f_off, full[i][0].score, float(ratio[i]))
              for i, (name, eb, f_off, _) in enumerate(cases)
              if full[i] and ratio[i] < detector.prescreen_margin]
    assert not missed, f"prescreen rejected full-pass detections: {missed}"


def test_detect_with_prescreen_matches_full(detector):
    rng = np.random.default_rng(5)
    iqs = [_sonde(n, rng) for n in ("RS41", "DFM", "M10", "WXR301")]
    iqs += [(rng.standard_normal(FS) + 1j * rng.standard_normal(FS))
            .astype(np.complex64) * 0.3 for _ in range(8)]
    x = _planes(iqs)
    with_pre = detector.detect(x, prescreen=True)
    without = detector.detect(x, prescreen=False)
    assert sum(map(bool, without)) >= 3
    for c, dets in enumerate(without):
        if dets:
            assert with_pre[c], f"channel {c} lost by prescreen"
            assert with_pre[c][0].name == dets[0].name
            assert with_pre[c][0].position == dets[0].position
            assert abs(with_pre[c][0].score - dets[0].score) < 1e-3


def test_prescreen_rejects_noise(detector):
    rng = np.random.default_rng(6)
    x = _planes([(rng.standard_normal(FS) + 1j * rng.standard_normal(FS))
                 .astype(np.complex64) * 0.3 for _ in range(16)])
    ratio = detector.prescreen.scores(torch.from_numpy(x)).numpy()
    assert (ratio >= detector.prescreen_margin).sum() <= 16 // 2

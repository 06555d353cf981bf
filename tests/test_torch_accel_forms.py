"""The detector's and the channelizer's accelerator forms: the port
against the JAX package, on the CPU, each form forced in both packages.

The reference takes these forms on its TPU (bfloat16 FM streams and
polyphase branches, the blocked-Toeplitz correlation, the
block-normalized peak search) and lets a switch force them anywhere:
``RSX_DETECT_DTYPE``, ``RSX_CHANNELIZER_DTYPE`` (read at each call),
``RSX_DETECT_CORR``, ``RSX_DETECT_PEAKS`` (read at import into
``correlator._CORR_METHOD`` / ``_PEAKS_METHOD``, which these tests set).
The reference reads its switches while it traces and does not key its
jit caches on them, so every test that forces a form clears the jitted
functions that read one (``_correlate``, ``_correlate_peaks_exact``,
``_channelize``, ``_extract``, ``_welch``) before and after; its
block-normalized peak searches read none (a bfloat16 stream is a
separate trace: the dtype is in the jit key), so they are cleared when
the module starts and ends.  The reference's banded operands are built
one pad a column, which its CPU compiler takes seconds over at the
production block of 128 columns: the direct parity cases of the
Toeplitz and block-normalized forms run at a block of 32 (an argument
of the functions), and the production block is held through the
dispatcher (``_correlate_peaks``, ``detect_types``, the station).

Tolerances, each from the arithmetic it covers:

* float32 forms: 1e-5 of the output's peak, or rtol 1e-4 on scores
  (float32 sums in another order);
* a bfloat16 value (the Toeplitz cube, the channel planes, the
  discriminator's streams) within one bfloat16 unit in the last place of
  the reference's value (2^-7 relative at most) plus 1e-6 of the peak:
  both packages accumulate in float32 and round once, and a float32 sum
  in another order can land on the other side of a rounding boundary;
  the channelizer's planes are held so to a plain model of the
  reference's order of work (each branch step rounded to bf16) and to
  the reference, and the float32-then-cast control shown to fail that
  limit; the extraction is held so to its model, and to the reference
  at one bf16 unit at the peak's scale (the reference's fused branch
  loop differs from the model in some values by that much);
* peak positions: equal (the seeded bursts' peaks clear their
  runners-up); peak values rtol 1e-4 (float32 normalization);
* the station under all four switches: the same tasks after every block
  and the same telemetry.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke as cs
from radiosonde_auto_rx_tpu.detect import correlator as ref_corr
from radiosonde_auto_rx_tpu.detect import psd as ref_psd
from radiosonde_auto_rx_tpu.detect.scanner import SondeDetector as RefDetector
from radiosonde_auto_rx_tpu.ops import channelizer as ref_ch
from radiosonde_auto_rx_tpu.ops import fm as ref_fm
from radiosonde_auto_rx_tpu.parallel.mesh import make_mesh as ref_mesh
from radiosonde_auto_rx_tpu.parallel.station_step import ShardedStationStep
from radiosonde_auto_rx_tpu.station.station import Station as RefStation
from radiosonde_auto_rx_tpu_torch.demod.modulate import add_awgn, gfsk_mod
from radiosonde_auto_rx_tpu_torch.detect import correlator
from radiosonde_auto_rx_tpu_torch.detect.scanner import (SondeDetector,
                                                         stream_dtype)
from radiosonde_auto_rx_tpu_torch.detect.templates import TEMPLATES
from radiosonde_auto_rx_tpu_torch.ops import channelizer
from radiosonde_auto_rx_tpu_torch.ops.fm import fm_discriminate_planes_mixed
from radiosonde_auto_rx_tpu_torch.parallel.mesh import make_mesh
from radiosonde_auto_rx_tpu_torch.parallel.station_step import (
    EXPERT_TYPES, StationStep)
from radiosonde_auto_rx_tpu_torch.station.station import Station

from test_prescreen import _burst, _planes

torch.set_num_threads(1)
FS = 48000
SPECS = {t.name: t for t in TEMPLATES}
DTYPES = {"float32": (torch.float32, jnp.float32),
          "bfloat16": (torch.bfloat16, jnp.bfloat16)}
# the reference's jitted functions that read a switch while tracing,
# and the block-normalized searches, which read none
REF_SWITCHED = (ref_corr._correlate, ref_corr._correlate_peaks_exact,
                ref_ch._channelize, ref_ch._extract, ref_psd._welch)
REF_BLOCKNORM = (ref_corr._correlate_peaks_blocknorm,
                 ref_corr._correlate_peaks_blocknorm_scan)
SMALL_BLOCK = 32


def _clear_reference(fns=REF_SWITCHED):
    for fn in fns:
        fn.clear_cache()


@pytest.fixture(scope="module", autouse=True)
def _clear_blocknorm():
    _clear_reference(REF_BLOCKNORM)
    yield
    _clear_reference(REF_BLOCKNORM)


@pytest.fixture
def forms(monkeypatch):
    """Force forms in both packages: ``forms(corr=..., peaks=...,
    detect=..., channelizer=...)``; the reference's traces are cleared
    before and after."""
    _clear_reference()

    def force(corr=None, peaks=None, detect=None, channelizer=None):
        for mod in (ref_corr, correlator):
            if corr:
                monkeypatch.setattr(mod, "_CORR_METHOD", corr)
            if peaks:
                monkeypatch.setattr(mod, "_PEAKS_METHOD", peaks)
        if detect:
            monkeypatch.setenv("RSX_DETECT_DTYPE", detect)
        if channelizer:
            monkeypatch.setenv("RSX_CHANNELIZER_DTYPE", channelizer)
        _clear_reference()

    yield force
    monkeypatch.undo()
    _clear_reference()


def _np(t):
    return t.float().numpy() if t.is_floating_point() else t.numpy()


def _bf16_ulp(w):
    """One bfloat16 unit in the last place at each value of ``w``."""
    a = np.abs(np.asarray(w, np.float64))
    return np.exp2(np.floor(np.log2(np.maximum(a, 1e-30))) - 7)


def _assert_bf16_close(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    err = np.abs(got - want)
    lim = _bf16_ulp(want) + 1e-6 * np.abs(want).max()
    assert (err <= lim).all(), (err - lim).max()


@pytest.fixture(scope="module")
def streams():
    """Conditioned float32 FM streams of the class that holds RS41 and
    DFM: 0.25 s each of an RS41, a DFM and an M10 burst at 14 dB (their
    headers inside) and one of noise, and the class's bank and lengths."""
    rng = np.random.default_rng(5)
    iqs = [add_awgn(_burst(SPECS[n], rng, t_samples=12000), 14.0, FS,
                    SPECS[n].sps, rng=rng) for n in ("RS41", "DFM", "M10")]
    iqs.append((rng.standard_normal(12000) + 1j * rng.standard_normal(
        12000)).astype(np.complex64) * 0.3)
    x = _planes(iqs)
    x = x - x.mean(axis=-1, keepdims=True) * np.float32(0.98)
    det = SondeDetector(FS, device="cpu")
    cls = next(i for i, cl in enumerate(det.classes)
               if {"RS41", "DFM"} <= {s.name for s in cl[2]})
    fm = det._condition(torch.from_numpy(x))[cls]
    _, _, specs, bank, lens = det.classes[cls]
    return fm, bank, tuple(int(v) for v in lens), specs


@pytest.mark.parametrize("T", [5120, 5000])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_corr_toeplitz_matches_reference(streams, dtype, T):
    """T a multiple of the block (5120 = 160 x 32 = 40 x 128) and not
    (5000); the port's result at the production block of 128 is held to
    the same tolerance."""
    tdt, jdt = DTYPES[dtype]
    _, bank, _, _ = streams
    rng = np.random.default_rng(T)
    x = rng.standard_normal((2, T)).astype(np.float32)
    xt, bt = torch.from_numpy(x).to(tdt), bank.to(tdt)
    want = np.asarray(ref_corr._corr_toeplitz(
        jnp.asarray(x).astype(jdt), jnp.asarray(bank.numpy()).astype(jdt),
        block=SMALL_BLOCK).astype(jnp.float32))
    got = correlator._corr_toeplitz(xt, bt, block=SMALL_BLOCK)
    prod = _np(correlator._corr_toeplitz(xt, bt))   # the production block
    assert got.dtype == tdt
    assert got.shape == want.shape == (2, bank.shape[0],
                                       T - bank.shape[1] + 1)
    direct = correlator._corr_direct(xt.float(), bt.float()).numpy()
    if dtype == "float32":
        np.testing.assert_allclose(_np(got), want, rtol=0,
                                   atol=1e-5 * np.abs(want).max())
        np.testing.assert_allclose(_np(got), direct, rtol=0,
                                   atol=1e-5 * np.abs(direct).max())
        np.testing.assert_allclose(prod, want, rtol=0,
                                   atol=1e-5 * np.abs(want).max())
    else:
        _assert_bf16_close(_np(got), want)
        _assert_bf16_close(prod, want)
        # the same correlation of the same bf16 operands, to bf16 rounding
        np.testing.assert_allclose(_np(got), direct, rtol=0,
                                   atol=2 ** -8 * np.abs(direct).max())


def _peaks_close(got, want):
    """(val, t_pk, dc, xm): positions equal, values rtol 1e-4."""
    assert got[1].dtype == np.int32
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_allclose(got[0], want[0], rtol=1e-4, atol=1e-6)
    for i in (2, 3):
        np.testing.assert_allclose(got[i], want[i], rtol=0, atol=1e-5)


MODES = {"rescore": dict(rescore=True), "block": dict(rescore=False),
         "screen": dict(positions=False)}


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_blocknorm_matches_reference(streams, dtype, mode):
    """The monolithic block-normalized peak search: exact rescore, the
    block-normalized peak, and the screening form, in float32 and on
    bfloat16 streams."""
    tdt, jdt = DTYPES[dtype]
    fm, bank, lens, _ = streams
    want = [np.asarray(v) for v in ref_corr._correlate_peaks_blocknorm(
        jnp.asarray(fm.numpy()).astype(jdt),
        jnp.asarray(bank.numpy()).astype(jdt), lens, block=SMALL_BLOCK,
        **MODES[mode])]
    got = [_np(v) for v in correlator._correlate_peaks_blocknorm(
        fm.to(tdt), bank.to(tdt), lens, block=SMALL_BLOCK, **MODES[mode])]
    _peaks_close(got, want)


@pytest.mark.parametrize("positions", [True, False])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_blocknorm_scan_matches_reference(streams, dtype, positions):
    """The scan form, which also computes the port's monolithic form:
    against the reference's scan form on the bursts' streams (block 32,
    chunks of 64, another chunking than the default); and at the
    production block of 128, on five seeded 40,000-sample streams with
    a template burst planted in row 2, the burst's row scores highest
    and its peak lies at the burst (the block-normalized argmax may
    take a neighbouring, near-equal position)."""
    tdt, jdt = DTYPES[dtype]
    fm, bank, lens, _ = streams
    b = bank.to(tdt)
    got = correlator._correlate_peaks_blocknorm_scan(
        fm.to(tdt), b, lens, block=SMALL_BLOCK, m_chunk=64,
        positions=positions)
    want = [np.asarray(v) for v in ref_corr._correlate_peaks_blocknorm_scan(
        jnp.asarray(fm.numpy()).astype(jdt),
        jnp.asarray(bank.numpy()).astype(jdt), lens, block=SMALL_BLOCK,
        m_chunk=64, positions=positions)]
    _peaks_close([_np(v) for v in got], want)
    rng = np.random.default_rng(42)
    x = rng.standard_normal((5, 40000)).astype(np.float32)
    x[2, 1000:1000 + lens[0]] += 3.0 * bank[0, :lens[0]].numpy()
    val, t_pk, _, _ = correlator._correlate_peaks_blocknorm_scan(
        torch.from_numpy(x).to(tdt), b, lens, positions=positions)
    assert int(torch.argmax(val[:, 0].abs())) == 2
    if positions:
        assert abs(int(t_pk[2, 0]) - 1000) <= 2


def _det_key(dets):
    return [[(d.name, d.tn, d.inverted, d.position) for d in ch]
            for ch in dets]


@pytest.mark.parametrize("corr", ["fft", "conv", "toeplitz"])
@pytest.mark.parametrize("peaks", ["exact", "blocknorm"])
def test_correlate_peaks_and_detect_types_under_switches(streams, forms,
                                                         peaks, corr):
    """``_correlate_peaks`` and ``detect_types`` under each
    ``RSX_DETECT_PEAKS`` and ``RSX_DETECT_CORR``: the RS41 and DFM
    detected on their rows, as the reference detects them."""
    forms(corr=corr, peaks=peaks)
    assert correlator._peaks_method() == peaks
    assert correlator._corr_method() == corr
    fm, bank, lens, specs = streams
    xj, bj = jnp.asarray(fm.numpy()), jnp.asarray(bank.numpy())
    want = [np.asarray(v) for v in ref_corr._correlate_peaks(xj, bj, lens)]
    got = [_np(v) for v in correlator._correlate_peaks(fm, bank, lens)]
    _peaks_close(got, want)
    kw = dict(fm_gain_hz=FS / 1.6, max_det=0, fs=FS)
    d_want = ref_corr.detect_types(np.asarray(fm.numpy()), bj, lens, specs,
                                   **kw)
    d_got = correlator.detect_types(fm, bank, lens, specs, **kw)
    assert _det_key(d_got) == _det_key(d_want)
    for g, w in zip(d_got, d_want):
        for dg, dw in zip(g, w):
            assert abs(dg.score - dw.score) < 1e-4
            assert abs(dg.freq_offset - dw.freq_offset) < 0.1
    assert [ch[0].name if ch else None for ch in d_got[:2]] == \
        ["RS41", "DFM"]


def test_detection_bf16_streams(forms):
    """As ``tests/test_detect.py::test_detection_bf16_streams``: on
    bfloat16 streams a clean RS41 burst is detected with a score within
    0.02 of the float32 path's, and the port's detections on bfloat16
    streams are the reference's (score to 1e-3: the two packages round
    the bf16 streams from float32 sums in another order)."""
    spec = SPECS["RS41"]
    rng = np.random.default_rng(3)
    bits = np.concatenate([np.array([int(c) for c in spec.header] * 2),
                           rng.integers(0, 2, 600)])
    iq = add_awgn(gfsk_mod(bits, FS, int(spec.sps), 2, 0.0, 4800,
                           bt=spec.bt), 12.0, FS, int(spec.sps), rng=rng)
    x = np.zeros(FS // 2, np.complex64)
    x[2000:2000 + len(iq)] = iq
    planes = np.stack([x.real, x.imag]).astype(np.float32)[None]
    det = SondeDetector(FS, device="cpu")
    d32 = det.detect(planes)[0]
    forms(detect="bfloat16")
    assert stream_dtype() == torch.bfloat16
    assert det._condition(torch.from_numpy(planes))[0].dtype == \
        torch.bfloat16
    d16 = det.detect(planes)[0]
    assert d16 and d16[0].name == "RS41", d16
    assert d32 and d32[0].name == "RS41"
    assert abs(d16[0].score - d32[0].score) < 0.02
    want = RefDetector(FS).detect(planes)[0]
    assert _det_key([d16]) == _det_key([want])
    assert abs(d16[0].score - want[0].score) < 1e-3


def test_fm_discriminate_out_dtype():
    """``out_dtype``: products in the planes' dtype, atan2 in float32,
    the result cast; float32 by default (bit-equal to the float32 path's
    previous output)."""
    rng = np.random.default_rng(7)
    re, im = rng.standard_normal((2, 3, 4000)).astype(np.float32)
    for tdt, jdt in DTYPES.values():
        r, i = torch.from_numpy(re).to(tdt), torch.from_numpy(im).to(tdt)
        got = fm_discriminate_planes_mixed(r, i, tdt)
        want = np.asarray(ref_fm.fm_discriminate_planes_mixed(
            jnp.asarray(re).astype(jdt), jnp.asarray(im).astype(jdt),
            jdt).astype(jnp.float32))
        assert got.dtype == tdt
        if tdt == torch.float32:
            np.testing.assert_allclose(_np(got), want, rtol=0, atol=2e-6)
            np.testing.assert_array_equal(
                _np(fm_discriminate_planes_mixed(r, i)), _np(got))
        else:
            # the products' bf16 rounding can move a phase step by a
            # bf16 unit of |w|; atan2 maps it to < 2^-7 rad (0.8/pi scale)
            err = np.abs(_np(got) - want)
            assert (err <= _bf16_ulp(want) + 2 ** -8).all(), err.max()
            assert np.median(err) == 0.0


@pytest.fixture(scope="module")
def wide():
    """Two 0.1 s wideband captures, 16 channels of 48 kHz, with the
    station fixture's sondes (a seeded GFSK at two channel offsets)."""
    rng = np.random.default_rng(11)
    n, T = 16, 76800
    x = (rng.standard_normal((2, T)) + 1j * rng.standard_normal((2, T))) \
        * 0.01
    for k, f in ((0, 5 * 48000.0), (1, -3 * 48000.0 + 7000.0)):
        bits = rng.integers(0, 2, T // 160 + 2)
        x[k] += 0.3 * gfsk_mod(bits, n * 48000, 4800, 2, f, 4800)[:T]
    return np.stack([x.real, x.imag], axis=1).astype(np.float32)


def _r16(t):
    """Round to bfloat16, kept in the tensor's dtype."""
    return t.to(torch.bfloat16).to(t.dtype)


def _model_branches(planes, taps, n, per_step):
    """The polyphase branches of [..., 2, M, n] float64 planes, in
    float64: ``per_step`` rounds the operands and every product and
    partial sum of the P multiply-accumulates to bfloat16 (the
    reference's order of work); otherwise nothing is rounded."""
    rr = _r16 if per_step else (lambda t: t)
    P = taps.shape[0] // n
    M = planes.shape[-2]
    hb = rr(torch.from_numpy(taps).double().reshape(P, n).flip(1))
    xp = torch.nn.functional.pad(rr(planes), (0, 0, P - 1, 0))
    y = rr(xp[..., P - 1:P - 1 + M, :] * hb[0])
    for k in range(1, P):
        y = rr(y + rr(xp[..., P - 1 - k:P - 1 - k + M, :] * hb[k]))
    return y


def _model_channelize(wide, taps, n, per_step=True):
    """A plain model of the bfloat16 ``_channelize`` on [S, 2, T]
    planes, [S, n, 2, T//n] float64: the branches (``_model_branches``;
    with ``per_step`` each step rounded, then the DFT of bf16 operands
    summed exactly), or the float32-then-cast control (everything
    unrounded); the planes rounded to bfloat16 once at the end."""
    M = wide.shape[-1] // n
    x = torch.from_numpy(wide[..., :M * n]).double().reshape(
        *wide.shape[:-1], M, n)
    y = _model_branches(x, taps, n, per_step)
    cosm, sinm = (torch.from_numpy(a).double()
                  for a in channelizer._dft_mats(n))
    if per_step:
        cosm, sinm = _r16(cosm), _r16(sinm)
    yr, yi = y[:, 0], y[:, 1]                              # [S, M, n]
    z = torch.stack([yr @ cosm + yi @ sinm, yi @ cosm - yr @ sinm], 1)
    return _r16(z.transpose(-1, -2).transpose(1, 2)).numpy()


def _model_extract(x, fs, freqs, n, taps, per_step=True):
    """A plain model of the bfloat16 ``_extract`` of [2, T] planes,
    [S, 2, T//n] float64: the rotation in float32 (as both packages
    compute it), the rotated planes and the branches as in
    ``_model_branches``, the branch sum exact, rounded to bfloat16
    once."""
    M = x.shape[-1] // n
    tau = np.float32(2 * np.pi)
    xb = x[:, :M * n].reshape(2, M, n)
    out = []
    for f in freqs:
        ph_m, ph_r = channelizer.extract_phases(f, fs, x.shape[-1], n)
        cm, sm = np.cos(tau * ph_m), np.sin(tau * ph_m)
        cr, sr = np.cos(tau * ph_r), np.sin(tau * ph_r)
        c = cm[:, None] * cr[None, :] - sm[:, None] * sr[None, :]
        s = sm[:, None] * cr[None, :] + cm[:, None] * sr[None, :]
        rot = torch.from_numpy(np.stack([xb[0] * c + xb[1] * s,
                                         xb[1] * c - xb[0] * s])).double()
        out.append(_r16(_model_branches(rot, taps, n, per_step).sum(-1)))
    return torch.stack(out).numpy()


def _beyond(got, want, lim):
    """How many values of ``got`` lie beyond ``lim`` of ``want``."""
    return int((np.abs(np.asarray(got, np.float64) - want) > lim).sum())


def _unit_lim(want):
    """One bfloat16 unit at each value plus 1e-6 of the peak."""
    return _bf16_ulp(want) + 1e-6 * np.abs(want).max()


def test_channelize_bf16_matches_reference(forms, wide):
    """``_channelize`` with bfloat16 branches, held to a plain model of
    the reference's order of work (each of the P branch steps rounded
    to bf16, then the DFT of bf16 operands accumulated in float32) at
    one bf16 unit a value plus 1e-6 of the peak: the DFT's float32 sum
    in another order can land on the other side of a rounding boundary.
    The float32-then-cast control (branches and DFT in float32, the
    planes cast) fails that limit, so the test sees the order of work.
    The reference's CPU output meets the model's limit too, and the
    port the reference's; the port is within 2^-5 of the peak of the
    float32 channelizer."""
    taps = channelizer.pfb_prototype(16)
    f32 = channelizer._channelize(torch.from_numpy(wide),
                                  torch.from_numpy(taps), 16)
    forms(channelizer="bfloat16")
    assert channelizer._branch_dtype() == torch.bfloat16
    got = channelizer._channelize(torch.from_numpy(wide),
                                  torch.from_numpy(taps), 16)
    assert got.dtype == torch.bfloat16
    got = _np(got)
    want = np.stack([np.asarray(ref_ch._channelize(
        jnp.asarray(w), jnp.asarray(taps), 16).astype(jnp.float32))
        for w in wide])
    step = _model_channelize(wide, taps, 16)
    cast = _model_channelize(wide, taps, 16, per_step=False)
    assert got.shape == want.shape == step.shape == \
        (2, 16, 2, wide.shape[-1] // 16)
    lim = _unit_lim(step)
    beyond = {"port": _beyond(got, step, lim), "jax": _beyond(want, step, lim),
              "control": _beyond(cast, step, lim)}
    worst = np.abs(cast - step).max() / np.abs(step).max()
    print(f"channelize bf16, of {step.size} values beyond one bf16 unit "
          f"(+1e-6 of the peak) of the per-step model: {beyond}; the "
          f"control's worst {worst:.3e} of the peak")
    assert beyond["port"] == 0 and beyond["jax"] == 0
    assert beyond["control"] > step.size // 2
    _assert_bf16_close(got, want)
    np.testing.assert_allclose(got, f32.numpy(), rtol=0,
                               atol=2 ** -5 * np.abs(want).max())


def test_extract_bf16_matches_reference(forms, wide):
    """``_extract`` (recentered extraction) with bfloat16 branches, off
    grid and on a channel center: held to a plain model of its order of
    work (the float32 rotation rounded to bf16, each branch step
    rounded, the branch sum in float32 rounded once) at one bf16 unit a
    value plus 1e-6 of the peak, which the float32-then-cast control
    fails.  The reference's CPU output differs from the same model in
    some values by up to one bf16 unit at the peak's scale (its rotated
    planes fed to the model leave the same values: the difference lies
    inside XLA's fused multiply-accumulate and branch sum, whose steps
    alone match the model), so the port is held to the reference at one
    unit at the peak's scale plus 1e-6 of the peak.  On a channel center
    the extraction reproduces that channel's ``_channelize`` row within
    2^-6 of the peak (another sum: the DFT row, not the rotation)."""
    forms(channelizer="bfloat16")
    taps = channelizer.pfb_prototype(16)
    fs = 16 * 48000
    freqs = [5 * 48000.0 + 3000.0, -3 * 48000.0]
    got = channelizer.extract_channels(wide[0], fs, freqs, 16, "cpu", taps)
    assert got.dtype == torch.bfloat16
    got = _np(got)
    want = np.asarray(ref_ch.extract_channels(
        wide[0], fs, freqs, 16, taps).astype(jnp.float32))
    step = _model_extract(wide[0], fs, freqs, 16, taps)
    cast = _model_extract(wide[0], fs, freqs, 16, taps, per_step=False)
    assert got.shape == want.shape == step.shape
    peak = np.abs(step).max()
    lim = _unit_lim(step)
    unit_at_peak = float(_bf16_ulp(peak)) + 1e-6 * peak
    beyond = {"port": _beyond(got, step, lim), "jax": _beyond(want, step, lim),
              "control": _beyond(cast, step, lim)}
    print(f"extract bf16, of {step.size} values beyond one bf16 unit "
          f"(+1e-6 of the peak) of the per-step model: {beyond}; the "
          f"reference's worst {np.abs(want - step).max() / peak:.3e} of "
          f"the peak (one unit at the peak's scale: "
          f"{_bf16_ulp(peak) / peak:.3e})")
    assert beyond["port"] == 0
    assert beyond["control"] > step.size // 4
    assert _beyond(want, step, unit_at_peak) == 0
    assert _beyond(got, want, unit_at_peak) == 0
    row = channelizer._channelize(torch.from_numpy(wide[0]),
                                  torch.from_numpy(taps), 16)[16 - 3]
    np.testing.assert_allclose(got[1], _np(row), rtol=0,
                               atol=2 ** -6 * peak)


TPU_CHOICES = dict(corr="toeplitz", peaks="blocknorm", detect="bfloat16",
                   channelizer="bfloat16")


def test_station_under_tpu_choices_matches_reference(forms):
    """The JAX ``Station`` (one-device mesh) and the port's, both under
    all four switches at the reference's TPU choices, with no task over
    the smoke script's capture at 8 channels (three sondes) as two 2 s
    blocks: the same tasks after each block and the same telemetry; the
    port finds the three sondes and decodes the two RS41s and the DFM."""
    forms(**TPU_CHOICES)
    n, fs = 8, 384_000
    stream = cs.synth_stream(n, fs, 4)
    cfg = {**cs.STATION_CFG, "capture_rate": fs, "num_channels": n}
    ref = RefStation(cfg, center_freq_hz=cs.CENTER,
                     mesh=ref_mesh(n_ch=1, n_t=1, devices=jax.devices()[:1]))
    port = Station(cfg, center_freq_hz=cs.CENTER, device="cpu")
    got_t, want_t = [], []
    for blk in cs.split_blocks(stream, fs, 2):
        want_t.extend(ref.process_captures([blk]))
        got_t.extend(port.process_captures([blk]))
        got, want = cs.tasks_of(port), cs.tasks_of(ref)
        assert [t for t, _ in got] == [t for t, _ in want]
        assert all(abs(a - b) <= 1 for (_, a), (_, b) in zip(got, want))
    assert sorted(map(cs._key, got_t)) == sorted(map(cs._key, want_t))
    assert port.stats["detections"] == ref.stats["detections"] == 3
    seen = cs.check_telemetry(got_t, n, fs, ("RS41", "DFM"))
    assert all(v > 0 for v in seen.values()), seen


def test_route_demod_bf16_planes_pad_experts(forms):
    """As ``tests/test_station_step.py::
    test_route_demod_bf16_planes_pad_experts``, on the port's (8, 1)
    virtual CPU mesh against the reference's 8 devices: bfloat16 channel
    planes routed with the 12 experts padded to 16; the same routed
    slots and bits, float32 Eb/N0."""
    forms(channelizer="bfloat16")
    port = StationStep(n_chan=2, capacity=1, conf_capacity=1,
                       frame_halo=0, mesh=make_mesh(8, 1, devices=["cpu"] * 8))
    ref = ShardedStationStep(ref_mesh(n_ch=8, n_t=1), n_chan=2,
                             capacity=1, conf_capacity=1, frame_halo=0)
    assert port.n_exp_pad == ref.n_exp_pad == 16 > port.n_exp
    rng = np.random.default_rng(0)
    chf = rng.standard_normal((16, 2, 24000)).astype(np.float32)
    chf16 = torch.from_numpy(chf).to(torch.bfloat16)
    exp = np.full(16, -1, np.int64)
    exp[3] = EXPERT_TYPES.index("RS41")
    want = ref.route_demod(jnp.asarray(chf).astype(jnp.bfloat16),
                           jnp.asarray(exp, jnp.int32))
    got = port.gather_routed(port.route_demod(chf16, exp))
    assert got["ebno"].dtype == torch.float32
    assert np.asarray(want["ebno"]).dtype == np.float32
    for k in ("mask", "ids"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    m = np.asarray(want["mask"])
    assert m[EXPERT_TYPES.index("RS41")].any()
    np.testing.assert_array_equal(got["bits"].numpy()[m],
                                  np.asarray(want["bits"])[m])

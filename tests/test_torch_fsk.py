"""Port parity: the FSK demod (radiosonde_auto_rx_tpu_torch.demod.fsk),
buffered and unbuffered scans, against the JAX reference on the CPU.

Inputs are made with numpy from a seed and handed to both packages.
Tolerances: hard bits and tone estimates (argmax picks) must be equal on
these clean signals; soft decisions agree to 1e-4 of their peak — float32 sums over
hundreds of samples whose summation order (and cos/sin last-ulp
rounding) differs between XLA and PyTorch.  Eb/N0 is
-6 + 20·log10(mean/std) with var = E[x²] − E[x]² taken in float32: the
difference of two means loses ~4e-6·mean² (a few ulps of 300-term
sums), so the std's relative error grows as 2e-6·r² with r = mean/std.
The bound is 1e-3 dB plus 20·log10(1 + 4e-6·r²) — tight at realistic
Eb/N0 (0.007 dB at 14 dB), loose only on noiseless input (r ~ 300).
"""

import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from radiosonde_auto_rx_tpu.demod import fsk as ref
from radiosonde_auto_rx_tpu.demod.modulate import add_awgn, fsk_mod, gfsk_mod
from radiosonde_auto_rx_tpu_torch.demod import fsk as port

torch.set_num_threads(1)
CPU = torch.device("cpu")

RS41 = dict(fs=48000, rs=4800, m=2, p=5, nsym=300, est_min=-5000,
            est_max=5000, tone_spacing=5000, freq_est_type=1)
PEAK = dict(fs=48000, rs=4800, m=2, p=5, nsym=300, est_min=-5000,
            est_max=5000)
FSK4 = dict(fs=48000, rs=2400, m=4, p=5, nsym=100, est_min=-10000,
            est_max=10000)
# station chain geometries (station/chains.py::_demod_cfg): M10's odd
# n = 745 at 48.08 kHz, MTS01's ndft 512, DFM at 50 kHz
M10 = dict(fs=48080, rs=9616, m=2, p=5, nsym=149, est_min=-10000,
           est_max=10000)
MTS01 = dict(fs=48000, rs=1200, m=2, p=5, nsym=300, est_min=-5000,
             est_max=5000)
DFM = dict(fs=50000, rs=2500, m=2, p=5, nsym=300, est_min=-5000,
           est_max=5000)


def _iq(kw, seed, n_bits, c=1, noisy=False):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(c):
        tx = rng.integers(0, 2, size=n_bits)
        if kw["m"] == 4:
            iq = fsk_mod(tx, kw["fs"], kw["rs"], 4, f1=-3600,
                         tone_spacing=2400)
        elif noisy:
            iq = add_awgn(gfsk_mod(tx, kw["fs"], kw["rs"], 2, 300.0 * i,
                                   4800), 14.0, kw["fs"], kw["rs"], rng=rng)
        else:
            iq = fsk_mod(tx, kw["fs"], kw["rs"], 2, f1=-2500 + 300 * i,
                         tone_spacing=5000)
        out.append(iq)
    t = min(len(q) for q in out)
    return np.stack([q[:t] for q in out]).astype(np.complex64)


def _run_both(kw, iq, probe=False):
    s_r, b_r, st_r, state_r = ref.fsk_demod_stream(
        ref.FSKConfig(**kw), iq, probe=probe)
    s_p, b_p, st_p, state_p = port.fsk_demod_stream(
        port.FSKConfig(**kw), iq, CPU, probe=probe)
    return ((np.asarray(s_r), np.asarray(b_r),
             {k: np.asarray(v) for k, v in st_r.items()},
             {k: np.asarray(v) for k, v in state_r.items()}),
            (s_p.numpy(), b_p.numpy(), {k: v.numpy() for k, v in st_p.items()},
             port.state_to_numpy(state_p)))


def _assert_close(r, p):
    (s_r, b_r, st_r, state_r), (s_p, b_p, st_p, state_p) = r, p
    assert b_p.dtype == np.uint8 and b_p.shape == b_r.shape
    np.testing.assert_array_equal(b_p, b_r)
    np.testing.assert_allclose(s_p, s_r, rtol=0,
                               atol=1e-4 * np.abs(s_r).max())
    np.testing.assert_array_equal(st_p["f_est"], st_r["f_est"])
    r2 = 10 ** ((st_r["ebno_db"] + 6.0) / 10.0)          # (mean/std)^2
    tol = 1e-3 + 20 * np.log10(1 + 4e-6 * r2)
    assert (np.abs(st_p["ebno_db"] - st_r["ebno_db"]) <= tol).all()
    np.testing.assert_array_equal(state_p["ptr"], state_r["ptr"])
    np.testing.assert_array_equal(state_p["nin"], state_r["nin"])
    np.testing.assert_allclose(state_p["sf"], state_r["sf"], rtol=0,
                               atol=1e-4 * np.abs(state_r["sf"]).max())


def test_config_and_dft_mats_exact():
    for kw in (RS41, PEAK, FSK4, M10, MTS01, DFM):
        c_r, c_p = ref.FSKConfig(**kw), port.FSKConfig(**kw)
        for f in ("ts", "tsp", "n", "nmem", "ndft", "tc", "est_space_bins",
                  "numffts", "bits_per_symbol", "est_range",
                  "block_advance_max"):
            assert getattr(c_p, f) == getattr(c_r, f), f
        for a, b in zip(ref._dft_mats(c_r), port._dft_mats(c_p)):
            np.testing.assert_array_equal(a, b)
    assert dataclasses.astuple(port.FSKConfig(**RS41)) == \
        dataclasses.astuple(ref.FSKConfig(**RS41))


@pytest.mark.parametrize("name,kw,n_bits,noisy", [
    ("rs41_mask", RS41, 6000, False),
    ("rs41_mask_gfsk_noise", RS41, 6000, True),
    ("peak", PEAK, 6000, False),
    ("fsk4", FSK4, 4000, False),
    ("m10_odd_n", M10, 700, False),
    ("mts01_ndft512", MTS01, 1000, False),
    ("dfm_50k", DFM, 1300, True),
])
def test_stream_matches_reference(name, kw, n_bits, noisy):
    iq = _iq(kw, seed=11, n_bits=n_bits, c=2, noisy=noisy)
    _assert_close(*_run_both(kw, iq))


def test_probe_outputs_match():
    iq = _iq(RS41, seed=5, n_bits=4000)
    (_, _, st_r, _), (_, _, st_p, _) = _run_both(RS41, iq, probe=True)
    assert set(st_p) == set(st_r)
    for k in ("sf", "tmag"):
        np.testing.assert_allclose(st_p[k], st_r[k], rtol=0,
                                   atol=1e-4 * np.abs(st_r[k]).max())
    np.testing.assert_allclose(st_p["timing"], st_r["timing"], atol=1e-4)


def test_zero_input_ebno():
    x = np.zeros((2, 2, 20000), np.float32)
    soft, bits, stats, _ = port.fsk_demod_stream(
        port.FSKConfig(**RS41), x, CPU)
    assert torch.isfinite(soft).all()
    np.testing.assert_allclose(stats["ebno_db"].numpy(), -6.0, atol=1e-6)


def test_short_input_empty():
    cfg = port.FSKConfig(**RS41)
    x = np.zeros((3, 2, cfg.nmem), np.float32)
    soft, bits, stats, state = port.fsk_demod_stream(cfg, x, CPU)
    assert soft.shape == (3, 0) and bits.shape == (3, 0)
    assert bits.dtype == torch.uint8 and stats == {}
    assert int(state["ptr"][0]) == cfg.nmem
    # a short complex 1-D input keeps its channel axis, as in the
    # reference (its early return precedes the squeeze)
    short = np.zeros(100, np.complex64)
    soft1, _, _, _ = port.fsk_demod_stream(cfg, short, CPU)
    soft_r, _, _, _ = ref.fsk_demod_stream(ref.FSKConfig(**RS41), short)
    assert tuple(soft1.shape) == np.asarray(soft_r).shape == (1, 0)


def test_batch_equals_single_channel():
    cfg = port.FSKConfig(**RS41)
    iq = _iq(RS41, seed=3, n_bits=4500, c=3)
    soft_b, bits_b, _, _ = port.fsk_demod_stream(cfg, iq, CPU)
    for i in range(3):
        soft_1, bits_1, _, _ = port.fsk_demod_stream(cfg, iq[i], CPU)
        np.testing.assert_array_equal(bits_b[i].numpy(), bits_1.numpy())
        np.testing.assert_array_equal(soft_b[i].numpy(), soft_1.numpy())


def test_state_roundtrip_continues_stream():
    """A reference state carried into the port continues identically."""
    kw = RS41
    iq = _iq(kw, seed=8, n_bits=3000, c=2)
    _, _, _, state_r = ref.fsk_demod_stream(ref.FSKConfig(**kw), iq)
    state = port.state_from_numpy(
        {k: np.asarray(v) for k, v in state_r.items()}, CPU)
    _, b_r, _, _ = ref.fsk_demod_stream(ref.FSKConfig(**kw), iq,
                                        state=state_r)
    _, b_p, _, _ = port.fsk_demod_stream(port.FSKConfig(**kw), iq, CPU,
                                         state=state)
    np.testing.assert_array_equal(b_p.numpy(), np.asarray(b_r))


@pytest.mark.parametrize("name,kw,n_bits,noisy", [
    ("rs41_mask", RS41, 6000, True),
    ("m10_odd_n", M10, 700, False),
    ("dfm_50k", DFM, 1300, True),
])
def test_unbuffered_scan_not_ported(name, kw, n_bits, noisy):
    """The unbuffered scan (``buffered=False``, the reference's
    ``_fsk_demod_scan``) against the reference's, from a fresh state and
    again from the carried one over the same input: the pointer then runs
    past the input's end, so the later window starts are clamped into
    [0, T - nmem]."""
    iq = _iq(kw, seed=13, n_bits=n_bits, c=2, noisy=noisy)
    s_r, b_r, st_r, state_r = ref.fsk_demod_stream(
        ref.FSKConfig(**kw), iq, buffered=False)
    s_p, b_p, st_p, state_p = port.fsk_demod_stream(
        port.FSKConfig(**kw), iq, CPU, buffered=False)
    assert b_p.shape[1] == port.fsk_num_blocks(
        port.FSKConfig(**kw), iq.shape[-1]) * kw["nsym"]
    _assert_close((np.asarray(s_r), np.asarray(b_r),
                   {k: np.asarray(v) for k, v in st_r.items()},
                   {k: np.asarray(v) for k, v in state_r.items()}),
                  (s_p.numpy(), b_p.numpy(),
                   {k: v.numpy() for k, v in st_p.items()},
                   port.state_to_numpy(state_p)))
    _, b_r2, _, state_r2 = ref.fsk_demod_stream(
        ref.FSKConfig(**kw), iq, state=state_r, buffered=False)
    _, b_p2, _, state_p2 = port.fsk_demod_stream(
        port.FSKConfig(**kw), iq, CPU, state=state_p, buffered=False)
    np.testing.assert_array_equal(b_p2.numpy(), np.asarray(b_r2))
    np.testing.assert_array_equal(state_p2["ptr"].numpy(),
                                  np.asarray(state_r2["ptr"]))
    # the second call's later windows started past T - nmem: clamped
    assert (state_p2["ptr"].numpy() > iq.shape[-1]).all()


def test_reference_planes_accepted():
    """Port accepts the reference's own plane layout ([C, 2, T] f32)."""
    iq = _iq(RS41, seed=2, n_bits=3000)
    planes = np.asarray(ref.iq_planes(iq))
    a = port.iq_planes(planes, CPU)
    b = port.iq_planes(iq, CPU)
    assert a.dtype == torch.float32 and a.shape == (1, 2, iq.shape[-1])
    np.testing.assert_array_equal(a.numpy(), b.numpy())
    np.testing.assert_array_equal(b.numpy(), np.asarray(jnp.asarray(planes)))

"""The port bench's r3 all-channel model (``bench.AllChannelModel``,
whose stages ``--ablate`` times) against the same program composed from
the JAX package's public functions, as the root ``bench.py:104-222``
composes it, on the CPU.

Geometry: one capture (B = 1) of 50 channels at the shortest ``t_wide``
that gives every channel two demod blocks (455,000 samples: 9,100 a
channel, two RS41 blocks), Gaussian noise.  Tolerances as
``tests/test_torch_bench.py``: the prescreen ratios within 1e-4 of
their peak, both full passes fed the port's survivor rows (their top-k
sets equal; the cap is cut to 4 of the 10 duty rows, so that the top-k
selects a strict subset), score and soft sums within 1e-4 of the sum of
their terms' absolute values, bit sums equal but for flips where the
reference's |soft| < 1e-4 of its peak (counted).
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from radiosonde_auto_rx_tpu.demod.fsk import (_fsk_demod_scan_buffered,
                                              fsk_init_state)
from radiosonde_auto_rx_tpu.detect.correlator import _correlate_peaks
from radiosonde_auto_rx_tpu.detect.psd import _welch
from radiosonde_auto_rx_tpu.detect.scanner import SondeDetector
from radiosonde_auto_rx_tpu.ops.channelizer import (_channelize,
                                                    pfb_prototype)
from radiosonde_auto_rx_tpu_torch import bench

from test_torch_bench import (TOL, close_sum, flips, record, ref_cfg,
                              same_bit_sum)

torch.set_num_threads(1)
CPU = torch.device("cpu")
T_R3 = 455_000


def test_all_channel_model_matches_reference(monkeypatch):
    """The r3 step (``bench.py:104-222``) on Gaussian noise, each probe
    against the reference's composition; its stages are ``--ablate``'s."""
    wide = np.random.default_rng(5).standard_normal(
        (1, 2, T_R3)).astype(np.float32)
    # B = 1 has 10 duty rows: a cap of 4 makes the top-k a selection
    monkeypatch.setattr(bench, "CAP", 4)
    m = bench.AllChannelModel(CPU, 1, T_R3)
    scans = record(monkeypatch, bench, "scan")
    got = m.step(torch.from_numpy(wide))
    cfg = ref_cfg(m.cfg)
    assert (m.C, m.n_det, m.cap, m.nb) == (50, 10, 4, 2)

    taps = jnp.asarray(pfb_prototype(50))
    det = SondeDetector(48000)
    w = jnp.asarray(wide)
    chf = jax.vmap(lambda v: _channelize(v, taps, 50))(w).reshape(50, 2, -1)
    psd = np.asarray(_welch(w, 2048, hop=8192))
    close_sum(got["psd"], psd.sum(), psd, "psd")
    ratio = np.asarray(det.prescreen.scores(chf[:m.n_det]))
    np.testing.assert_allclose(got["ratios"].numpy(), ratio, rtol=0,
                               atol=TOL * ratio.max())
    close_sum(got["ratio"], ratio.sum(), ratio, "ratio")
    survivors = got["survivors"].numpy()
    assert set(survivors) == set(np.asarray(
        jax.lax.top_k(jnp.asarray(ratio), m.cap)[1]))
    corr, terms = 0.0, []
    for fm, (_, _, _, bank, lens) in zip(
            det._condition(chf[jnp.asarray(survivors)]), det.classes):
        val, _, _, xm = _correlate_peaks(fm, bank.astype(fm.dtype),
                                         tuple(int(v) for v in lens))
        corr += float(val.max()) + float(xm.sum())
        terms += [float(val.max()), *np.asarray(xm)]
    close_sum(got["corr"], corr, terms, "corr")

    _, outs = _fsk_demod_scan_buffered(cfg, chf, fsk_init_state(cfg, 50),
                                       m.nb)
    soft_j, bits_j = np.asarray(outs["soft"]), np.asarray(outs["bits"])
    soft_p = bench._stacked(scans[0][1]["soft"], 50, m.nb).numpy()
    bits_p = bench._stacked(scans[0][1]["bits"], 50, m.nb).numpy()
    mask = flips(bits_p, bits_j, soft_j, "r3 demod")
    probe = soft_j[:, :, ::257]
    close_sum(got["soft"], probe.sum(), probe, "soft probe")
    same_bit_sum(got["duty_bits"],
                 bits_j[:, :m.n_det].astype(np.int64).sum(),
                 mask[:, :m.n_det], "duty bits")

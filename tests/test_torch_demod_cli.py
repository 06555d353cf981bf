"""The port's ``fsk_demod`` CLI (``radiosonde_auto_rx_tpu_torch.demod.cli``)
on the CPU: the cases of ``tests/test_demod_cli.py``, and the port's CLI
against the JAX package's on the same cs16 streams.

The CLI streams the unbuffered scan (``fsk_demod_stream(buffered=False)``,
the reference's ``_fsk_demod_scan``) 8 demod blocks a call, carrying the
unconsumed tail and resetting the pointer to ``nmem`` each call.  Port
against reference, at the RS41 (mask estimator), M10 (odd n = 745 at
48,080 Hz) and DFM (50 kHz) geometries: hard bits equal, the per-block
stats lines' tone estimates equal, Eb/N0 and ppm within one and two
units of their last printed digit, and soft decisions within 1e-4 of
their peak (float32 sums in another order, as
``tests/test_torch_fsk.py``).
"""

import io
import json

import numpy as np
import pytest
import torch

from radiosonde_auto_rx_tpu.demod import cli as ref_cli
from radiosonde_auto_rx_tpu_torch.demod import cli
from radiosonde_auto_rx_tpu_torch.demod.fsk import (FSKConfig,
                                                    fsk_demod_stream)
from radiosonde_auto_rx_tpu_torch.demod.modulate import add_awgn, gfsk_mod

torch.set_num_threads(1)
CPU = ["--device", "cpu"]
RS41_ARGS = ["-p", "5", "--nsym", "50", "-b", "-5000", "-u", "5000",
             "--mask", "5000"]


def _cs16(iq, scale=16000):
    w = np.empty(2 * len(iq), np.int16)
    w[0::2] = np.clip(iq.real * scale, -32768, 32767).astype(np.int16)
    w[1::2] = np.clip(iq.imag * scale, -32768, 32767).astype(np.int16)
    return w.tobytes()


def _iq_cs16(rng, nbits=4000, fs=48000, rs=4800, spacing=5000, ebno=14.0):
    tx = rng.integers(0, 2, nbits).astype(np.uint8)
    iq = add_awgn(gfsk_mod(tx, fs, rs, 2, 0.0, spacing), ebno, fs, rs)
    return tx, iq, _cs16(iq)


def _ber(rx, tx, search=96):
    """Best BER over tx/rx alignments (the demod starts emitting about
    one window into the stream)."""
    best = 1.0
    for off in range(search):
        n = min(len(rx), len(tx) - off)
        if n <= 100:
            continue
        best = min(best, float(np.mean(rx[:n] != tx[off:off + n])))
    return best


def _run(mod, argv, wire):
    out, err = io.BytesIO(), io.StringIO()
    rc = mod.run(mod.parse_args(argv), stdin=io.BytesIO(wire), stdout=out,
                 stderr=err)
    return rc, out.getvalue(), err.getvalue()


def test_cli_soft_output_decodes(rng):
    tx, _, wire = _iq_cs16(rng)
    rc, out, err = _run(cli, CPU + RS41_ARGS + ["--stats=5", "2", "48000",
                                                "4800", "-", "-"], wire)
    assert rc == 0
    soft = np.frombuffer(out, np.float32)
    assert len(soft) > 0.9 * len(tx)
    assert _ber((soft < 0).astype(np.uint8), tx) < 0.01   # soft + => bit 0
    lines = [json.loads(ln) for ln in err.splitlines()]
    assert lines, "no stats emitted"
    assert {"EbNodB", "ppm", "f1_est", "f2_est"} <= set(lines[-1])
    assert lines[-1]["EbNodB"] > 5


def test_cli_hardout_and_invert(rng):
    tx, _, wire = _iq_cs16(rng, nbits=2500)
    _, out, _ = _run(cli, CPU + RS41_ARGS + ["--hardout", "-i", "2",
                                             "48000", "4800", "-", "-"],
                     wire)
    bits = np.frombuffer(out, np.uint8)
    assert _ber(1 - bits, tx) < 0.01      # -i flips the polarity back


def test_cli_streaming_matches_batch(rng):
    """The chunked CLI equals one unbuffered ``fsk_demod_stream`` call on
    the same IQ (cs16 quantization may flip the odd soft-zero bit)."""
    _, iq, wire = _iq_cs16(rng, nbits=6000)
    cfg = FSKConfig(fs=48000, rs=4800, m=2, p=5, nsym=50, est_min=-5000,
                    est_max=5000, tone_spacing=5000, freq_est_type=1)
    _, bits_batch, _, _ = fsk_demod_stream(cfg, iq, torch.device("cpu"),
                                           buffered=False)
    bits_batch = bits_batch.numpy()
    _, out, _ = _run(cli, CPU + RS41_ARGS + ["--hardout", "2", "48000",
                                             "4800", "-", "-"], wire)
    bits_cli = np.frombuffer(out, np.uint8)
    n = min(len(bits_cli), len(bits_batch))
    assert n > 0.8 * len(bits_batch)
    assert np.mean(bits_cli[:n] != bits_batch[:n]) < 0.005


def test_cli_testframes_ber(rng):
    """--testframes: the known PRBS frames report ~0 BER."""
    tx = np.tile(cli.test_frame_bits(), 40)
    iq = add_awgn(gfsk_mod(tx, 48000, 4800, 2, 0.0, 5000), 14.0,
                  48000, 4800, rng=rng)
    _, _, err = _run(cli, CPU + ["-b", "-5000", "-u", "5000", "--mask",
                                 "5000", "-p", "5", "--testframes", "2",
                                 "48000", "4800", "-", "-"],
                     _cs16(iq, 16384))
    lines = [ln for ln in err.splitlines() if "FSK BER" in ln]
    assert len(lines) >= 20, f"frames synced: {len(lines)}"
    ber = float(lines[-1].split("FSK BER")[1].split(",")[0])
    assert ber < 0.01, lines[-1]


def test_test_frame_matches_reference_generator():
    """The PRBS test frame is the JAX package's (its own test holds that
    one to the C library's srand(158324) sequence)."""
    np.testing.assert_array_equal(cli.test_frame_bits(),
                                  ref_cli.test_frame_bits())
    assert cli.test_frame_bits().shape == (cli.TEST_FRAME_SIZE,)


def test_cli_refuses_a_missing_card(monkeypatch):
    """Without a CUDA device the default ``--device cuda`` exits 1 and
    names the missing card; it never runs on the CPU instead."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc, out, err = _run(cli, RS41_ARGS + ["2", "48000", "4800", "-", "-"],
                        b"\0" * 4000)
    assert rc == 1 and out == b"" and "no CUDA device" in err


# (CLI arguments, fs, rs, tone spacing) of the station chains' geometries
GEOMETRIES = {
    "RS41": (["-p", "5", "--nsym", "300", "-b", "-5000", "-u", "5000",
              "--mask", "5000"], 48000, 4800, 5000),
    "M10": (["-p", "5", "--nsym", "149", "-b", "-10000", "-u", "10000"],
            48080, 9616, 8000),
    "DFM": (["-p", "5", "--nsym", "300", "-b", "-5000", "-u", "5000"],
            50000, 2500, 4000),
}


@pytest.mark.parametrize("name", sorted(GEOMETRIES))
def test_cli_matches_reference(name):
    """The port's CLI and the JAX package's on one noisy cs16 stream:
    hard bits equal, soft within 1e-4 of its peak, the same stats lines:
    tone estimates equal, Eb/N0 to one unit of its last printed digit,
    ppm to two (a running mean of 1e6·Δtiming/nsym: timing's float32
    sums move it by ~1e-2 at M10's 149 symbols)."""
    args, fs, rs, spacing = GEOMETRIES[name]
    rng = np.random.default_rng(len(name))
    tx = rng.integers(0, 2, int(2.5 * rs)).astype(np.uint8)
    iq = add_awgn(gfsk_mod(tx, fs, rs, 2, 300.0, spacing), 12.0, fs, rs,
                  rng=rng)
    wire = _cs16(iq)
    tail = ["--stats=1", "2", str(fs), str(rs), "-", "-"]
    rc_r, soft_r, err_r = _run(ref_cli, args + tail, wire)
    rc_p, soft_p, err_p = _run(cli, CPU + args + tail, wire)
    assert rc_r == rc_p == 0
    soft_r = np.frombuffer(soft_r, np.float32)
    soft_p = np.frombuffer(soft_p, np.float32)
    assert soft_p.shape == soft_r.shape and len(soft_r) > rs
    np.testing.assert_array_equal(soft_p < 0, soft_r < 0)
    np.testing.assert_allclose(soft_p, soft_r, rtol=0,
                               atol=1e-4 * np.abs(soft_r).max())
    lines_r = [json.loads(ln) for ln in err_r.splitlines()]
    lines_p = [json.loads(ln) for ln in err_p.splitlines()]
    assert len(lines_p) == len(lines_r) > 0
    for lp, lr in zip(lines_p, lines_r):
        assert abs(lp.pop("EbNodB") - lr.pop("EbNodB")) <= 0.0100001
        assert abs(lp.pop("ppm") - lr.pop("ppm")) <= 0.0200001
        assert lp == lr

"""Pipeline parallelism in the port, after ``tests/test_pp.py``: the
systolic microbatch schedule on a 4-stage virtual CPU mesh equals the
serial composition of its stages exactly (the same float32 operations in
the same order), and the 3-stage demod pipeline (DC block, IF FIR, the
scan's unbuffered mode) decodes an RS41 frame stream with the
reference's bits on its 3-stage mesh of virtual XLA devices and soft
decisions within 1e-4 of their peak.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import torch

from radiosonde_auto_rx_tpu.demod.fsk import FSKConfig as RefCfg
from radiosonde_auto_rx_tpu.parallel import pp as ref
from radiosonde_auto_rx_tpu_torch.demod.fsk import FSKConfig
from radiosonde_auto_rx_tpu_torch.demod.modulate import add_awgn, gfsk_mod
from radiosonde_auto_rx_tpu_torch.models.rs41 import (
    RS41Decoder, frame_to_bits)
from radiosonde_auto_rx_tpu_torch.ops.fir import design_lowpass
from radiosonde_auto_rx_tpu_torch.parallel.pp import (
    make_pp_demod_pipeline, make_stage_mesh, pipeline_parallel)

from test_rs41 import _mkframe

torch.set_num_threads(1)
CPU = torch.device("cpu")


def test_pipeline_equals_serial_composition():
    mesh = make_stage_mesh(4, devices=[CPU] * 4)
    rng = np.random.default_rng(0)
    M, C, B = 6, 3, 32
    xs = torch.from_numpy(rng.standard_normal((M, C, 2, B)).astype(
        np.float32))

    # distinct affine stages with a running-sum carry each
    def mk(gain, bias):
        def fn(x, carry):
            return gain * x + bias + 0.001 * carry, carry + torch.sum(x)
        return fn

    fns = [mk(g, b) for g, b in
           [(1.5, 0.1), (0.8, -0.2), (1.1, 0.05), (0.9, 0.3)]]
    got = pipeline_parallel(mesh, fns, [torch.tensor(0.0)] * 4, xs)
    want, carries = [], [torch.tensor(0.0)] * 4
    for m in range(M):
        y = xs[m]
        for s in range(4):
            y, carries[s] = fns[s](y, carries[s])
        want.append(y)
    assert torch.equal(got, torch.stack(want))


def test_pp_demod_pipeline_matches_reference():
    cfg = FSKConfig(fs=48000, rs=4800, m=2, p=5, nsym=50,
                    est_min=-5000, est_max=5000, tone_spacing=5000,
                    freq_est_type=1)
    rng = np.random.default_rng(5)
    tx = np.concatenate(
        [rng.integers(0, 2, 400)] +
        [frame_to_bits(_mkframe(i)) for i in range(2)] +
        [rng.integers(0, 2, 700)]).astype(np.uint8)
    iq = add_awgn(gfsk_mod(tx, 48000, 4800, 2, 0.0, 4800, bt=0.5),
                  15.0, 48000, 4800)
    C, t_mb = 2, 12000
    planes = np.repeat(np.stack([iq.real, iq.imag]).astype(
        np.float32)[None], C, axis=0)
    M = planes.shape[-1] // t_mb
    xs = np.ascontiguousarray(planes[:, :, :M * t_mb].reshape(
        C, 2, M, t_mb).transpose(2, 0, 1, 3))
    taps = design_lowpass(0.2, 25)
    run = make_pp_demod_pipeline(cfg, make_stage_mesh(3, devices=[CPU] * 3),
                                 taps, channels=C, t_mb=t_mb)
    soft, bits = run(torch.from_numpy(xs))
    assert soft.shape[:2] == (M, C) and bits.dtype == torch.uint8
    telems = RS41Decoder().decode_bits(bits[:, 0].reshape(-1).numpy(),
                                       -soft[:, 0].reshape(-1).numpy())
    assert telems and telems[0]["id"] == "S0930112"
    soft_r, bits_r = ref.make_pp_demod_pipeline(
        RefCfg(**dataclasses.asdict(cfg)), ref.make_stage_mesh(3), taps,
        channels=C, t_mb=t_mb)(jnp.asarray(xs))
    np.testing.assert_array_equal(bits.numpy(), np.asarray(bits_r))
    soft_r = np.asarray(soft_r)
    np.testing.assert_allclose(soft.numpy(), soft_r, rtol=0,
                               atol=1e-4 * np.abs(soft_r).max())

"""The port's sharding layer on virtual CPU meshes, after
``tests/test_parallel.py``: halo contents, ``halo == 0``, the
overlap-save FIR equal to the unsharded filter, channel-sharded demod
equal to the unsharded demod, time-sharded demod decoding, the sharded
station step against the reference's on the 8 virtual XLA devices, and
the multi-process helpers in one process.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from radiosonde_auto_rx_tpu.parallel import pipeline as ref
from radiosonde_auto_rx_tpu.parallel.mesh import make_mesh as ref_mesh
from radiosonde_auto_rx_tpu_torch.demod.fsk import FSKConfig, fsk_demod_stream
from radiosonde_auto_rx_tpu_torch.demod.modulate import add_awgn, gfsk_mod
from radiosonde_auto_rx_tpu_torch.ops.fir import _conv_valid, design_lowpass
from radiosonde_auto_rx_tpu_torch.parallel import multihost
from radiosonde_auto_rx_tpu_torch.parallel.collectives import axis_index
from radiosonde_auto_rx_tpu_torch.parallel.halo import (
    halo_exchange_left, halo_exchange_right)
from radiosonde_auto_rx_tpu_torch.parallel.mesh import (
    make_mesh, shard, stream_sharding, unshard)
from radiosonde_auto_rx_tpu_torch.parallel.pipeline import (
    make_station_step, sharded_fir_filter, sharded_fsk_demod)

torch.set_num_threads(1)
CPU = torch.device("cpu")


def _mesh(n_ch, n_t):
    return make_mesh(n_ch, n_t, devices=[CPU] * (n_ch * n_t))


def _cfg(nsym=50):
    return FSKConfig(fs=48000, rs=4800, m=2, p=5, nsym=nsym,
                     est_min=-5000, est_max=5000, tone_spacing=5000,
                     freq_est_type=1)


def _signal(rng, c, t, fs=48000, rs=4800):
    tx = rng.integers(0, 2, (c, t // (fs // rs) + 1))
    out = []
    for ci in range(c):
        iq = add_awgn(gfsk_mod(tx[ci][: t // (fs // rs)], fs, rs, 2, 0.0,
                               5000), 14.0, fs, rs)
        out.append(np.stack([iq.real, iq.imag]))
    return tx, np.stack(out).astype(np.float32)[:, :, :t]


@pytest.mark.parametrize("side", ["left", "right"])
def test_halo_exchange_contents(side):
    """The halo is exactly the neighbor's edge; the end shard's zeros."""
    mesh = _mesh(1, 8)
    t_local, halo = 16, 4
    x = torch.arange(8 * t_local, dtype=torch.float32)[None, :]
    xs = shard(x, *stream_sharding(mesh))
    fn = halo_exchange_left if side == "left" else halo_exchange_right
    y = fn(xs, mesh, halo, "t")
    for s in range(8):
        assert axis_index(mesh, (0, s), "t") == s
        row = y[(0, s)][0].numpy()
        body = np.arange(s * t_local, (s + 1) * t_local)
        if side == "left":
            want = np.zeros(halo) if s == 0 else \
                np.arange(s * t_local - halo, s * t_local)
            np.testing.assert_array_equal(row[:halo], want)
            np.testing.assert_array_equal(row[halo:], body)
        else:
            want = np.zeros(halo) if s == 7 else \
                np.arange((s + 1) * t_local, (s + 1) * t_local + halo)
            np.testing.assert_array_equal(row[-halo:], want)
            np.testing.assert_array_equal(row[:-halo], body)
    # halo 0 hands the shards back untouched (x[..., -0:] would be all)
    assert fn(xs, mesh, 0, "t") is xs


def test_sharded_fir_equals_unsharded(rng):
    """Overlap-save across 4 time shards equals the zero-state causal
    filter of the unsharded stream exactly, and the reference's sharded
    filter within 1e-5 (relative)."""
    mesh = _mesh(2, 4)
    h = design_lowpass(0.2, 33)
    C, T = 4, 4096
    x = rng.standard_normal((C, T)).astype(np.float32)
    got = sharded_fir_filter(mesh, torch.from_numpy(x), h).numpy()
    xx = np.concatenate([np.zeros((C, len(h) - 1), np.float32), x], axis=1)
    np.testing.assert_array_equal(got, _conv_valid(torch.from_numpy(xx),
                                                   h).numpy())
    want = np.asarray(ref.sharded_fir_filter(ref_mesh(n_ch=2, n_t=4),
                                             jnp.asarray(x), h))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_channel_sharded_demod_exact(rng):
    """Pure channel DP (8 ch shards, 1 t shard) gives the bits of the
    unsharded demod of the zero-padded stream (each shard prepends its
    nmem + slack halo, zeros on the first t-shard), and the reference's
    sharded demod's bits."""
    cfg = _cfg()
    _, x = _signal(rng, 8, 48000)
    soft, bits = sharded_fsk_demod(cfg, _mesh(8, 1), torch.from_numpy(x))
    halo = cfg.nmem + 8 * cfg.ts
    xpad = np.concatenate([np.zeros((8, 2, halo), np.float32), x], axis=2)
    _, bits_1, _, _ = fsk_demod_stream(cfg, xpad, CPU)
    np.testing.assert_array_equal(bits.numpy(), bits_1.numpy())
    _, bits_r = ref.sharded_fsk_demod(
        _ref_cfg(cfg), ref_mesh(n_ch=8, n_t=1), jnp.asarray(x))
    np.testing.assert_array_equal(bits.numpy(), np.asarray(bits_r))


def _ref_cfg(cfg):
    from radiosonde_auto_rx_tpu.demod.fsk import FSKConfig as RefCfg
    import dataclasses
    return RefCfg(**dataclasses.asdict(cfg))


def test_time_sharded_demod_decodes(rng):
    """Sequence parallelism (2 t shards, nmem halo): each shard re-locks
    inside its halo; every shard's run, past its warm-up, aligns with
    the transmitted bits at a BER below 2 %."""
    cfg = _cfg()
    tx, x = _signal(rng, 4, 96000)
    _, bits = sharded_fsk_demod(cfg, _mesh(4, 2), torch.from_numpy(x))
    bits = bits.numpy()
    n_t, t_local = 2, 48000
    seg = bits.shape[1] // n_t
    warm = 2 * cfg.nsym
    for ci in range(4):
        for s in range(n_t):
            run = bits[ci, s * seg + warm:(s + 1) * seg]
            lo = max(0, s * (t_local // cfg.ts) - 120)
            best = 1.0
            for off in range(lo, lo + 300):
                n = min(len(run), tx.shape[1] - off)
                if n > 500:
                    best = min(best, float(
                        np.mean(run[:n] != tx[ci, off:off + n])))
            assert best < 0.02, f"ch{ci} shard{s}: BER {best:.3f}"


def test_station_step_matches_reference(rng):
    """make_station_step (IF FIR + demod) on a (4, 2) mesh: the
    reference's bits on the same mesh, soft decisions within 1e-4 of
    their peak; shapes and dtypes as the reference's; a dict of shards
    in gives the same shards out."""
    cfg = _cfg()
    _, x = _signal(rng, 8, 8192 * 2)
    taps = design_lowpass(0.2, 25)
    mesh = _mesh(4, 2)
    step = make_station_step(cfg, mesh, if_taps=taps)
    soft, bits = step(torch.from_numpy(x))
    soft_r, bits_r = ref.make_station_step(
        _ref_cfg(cfg), ref_mesh(n_ch=4, n_t=2),
        if_taps=taps)(jnp.asarray(x))
    assert soft.shape == soft_r.shape and bits.dtype == torch.uint8
    np.testing.assert_array_equal(bits.numpy(), np.asarray(bits_r))
    soft_r = np.asarray(soft_r)
    np.testing.assert_allclose(soft.numpy(), soft_r, rtol=0,
                               atol=1e-4 * np.abs(soft_r).max())
    spec = ("ch", "t")
    _, b_sh = step(shard(torch.from_numpy(x), mesh, ("ch", None, "t")))
    assert torch.equal(unshard(b_sh, mesh, spec), bits)


def test_multihost_helpers_single_process(monkeypatch):
    """Without a coordinator or torchrun's environment: one process, a
    global mesh over the local devices, every channel local."""
    for k in multihost._TORCHRUN_ENV:
        monkeypatch.delenv(k, raising=False)
    multihost.initialize(device="cpu")
    assert multihost.process_count() == 1
    mesh = multihost.global_mesh(n_t=2, local_devices=[CPU] * 8)
    assert mesh.shape == {"ch": 4, "t": 2} and mesh.all_local
    assert multihost.local_channel_slice(100) == (0, 100)
    with pytest.raises(ValueError, match="needs more than 1 devices"):
        make_mesh(n_ch=2, n_t=1, devices=[CPU])
    with pytest.raises(ValueError, match="not divisible"):
        make_mesh(n_t=2, devices=[CPU])

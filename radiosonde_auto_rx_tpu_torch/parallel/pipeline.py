"""Sharded end-to-end signal pipeline: the station "step".

Port of ``radiosonde_auto_rx_tpu/parallel/pipeline.py``.  The
reference's per-sonde shell pipeline (rtl_fm | iq_dec | fsk_demod |
<decoder>) becomes one program over ``IQ[C, T]``:

    IF lowpass (overlap-save FIR)  ->  FSK demod (block scan)  ->  soft bits

sharded over a ``(ch, t)`` mesh: channels are pure data parallelism; the
time axis is sequence-parallel with a left halo exchanged by
``ppermute`` (``parallel/halo.py``).  Each time shard re-locks demod
state within its halo, the same recovery the reference performs after
any stream restart.

Each function takes a global tensor (every shard in this process: it is
split with ``shard`` and the result assembled with ``unshard``) or a
dict of this process's shards (the result stays sharded).
"""

import numpy as np
import torch

from radiosonde_auto_rx_tpu_torch.demod.fsk import (
    SLACK_TS, fsk_init_state, fsk_num_blocks_buffered, fsk_scan,
    fsk_scan_ref, iq_planes)
from radiosonde_auto_rx_tpu_torch.ops.fir import _conv_valid
from radiosonde_auto_rx_tpu_torch.parallel.halo import halo_exchange_left
from radiosonde_auto_rx_tpu_torch.parallel.mesh import (
    CH_AXIS, T_AXIS, shard, unshard)


def scan(cfg, x, state, n_blocks: int, buffered: bool = True):
    """The demod scan on x's device: one launch of the scan kernel on a
    CUDA tensor, its plain twin ``fsk_scan_ref`` on a CPU one; bf16
    planes are read as a float32 copy."""
    x = x.float()
    if x.device.type == "cpu":
        return fsk_scan_ref(cfg, x, state, n_blocks, buffered=buffered)
    return fsk_scan(cfg, x.contiguous(), state, n_blocks,
                    buffered=buffered)


def sharded(fn, x, mesh, in_spec, out_specs):
    """Run ``fn`` (local shards -> a tuple of local shards) on ``x``: a
    dict of local shards passes through, a global tensor is split by
    ``in_spec`` and each result assembled by its ``out_specs`` entry."""
    if isinstance(x, dict):
        return fn(x)
    outs = fn(shard(x, mesh, in_spec))
    return tuple(unshard(o, mesh, s) for o, s in zip(outs, out_specs))


def sharded_fir_filter(mesh, x, h):
    """Causal FIR over [C, T] sharded (ch, t); overlap-save across t
    shards.  Equal to filtering the unsharded stream with zero initial
    state (each row's convolution reads the same samples)."""
    h = np.asarray(h, np.float32)     # host taps: on each device once
    K = int(h.shape[0])

    def body(xl):
        xx = halo_exchange_left(xl, mesh, K - 1, T_AXIS)
        out = {}
        for c, v in xx.items():
            if v.is_complex():
                out[c] = torch.complex(_conv_valid(v.real, h),
                                       _conv_valid(v.imag, h))
            else:
                out[c] = _conv_valid(v, h)
        return (out,)

    spec = (CH_AXIS, T_AXIS)
    return sharded(body, x, mesh, spec, (spec,))[0]


def sharded_fsk_demod(cfg, mesh, x):
    """FSK-demodulate float32 IQ planes [C, 2, T] sharded (ch, -, t).

    Each time shard prepends an ``nmem``-sample halo (plus the buffered
    scan's slack window) and runs the buffered scan locally from a fresh
    state (the spectral EMA warms up inside the halo).  Returns (soft,
    bits) sharded (ch, t).

    Seam semantics: the halo region is demodulated too, so each shard
    re-emits ~``nmem/ts`` symbols of its left neighbor's tail; the frame
    layer's duplicate-frame handling absorbs the repeats.  Shard 0's
    halo is zeros, identical to a fresh stream start, so pure channel
    sharding gives the bits of the unsharded demod of the zero-padded
    stream."""
    halo = cfg.nmem + SLACK_TS * cfg.ts

    def body(xl):
        xx = halo_exchange_left(xl, mesh, halo, T_AXIS)
        soft, bits = {}, {}
        for c, v in xx.items():
            nb = fsk_num_blocks_buffered(cfg, v.shape[-1])
            state = fsk_init_state(cfg, v.shape[0], v.device)
            _, outs = scan(cfg, v, state, nb)
            soft[c], bits[c] = outs["soft"], outs["bits"]
        return soft, bits

    out = (CH_AXIS, T_AXIS)
    return sharded(body, x, mesh, (CH_AXIS, None, T_AXIS), (out, out))


def make_station_step(cfg, mesh, if_taps=None):
    """The sharded station step: IQ planes [C, 2, T] (or complex [C, T])
    -> (soft, bits), a global tensor or a dict of local shards.

    ``if_taps``: optional IF lowpass taps run overlap-save before the
    demod (the reference's iq_dec/lowpass stage)."""

    def step(x):
        if isinstance(x, dict):
            xl = {c: iq_planes(v, v.device) for c, v in x.items()}
        else:
            xl = shard(iq_planes(x, x.device if isinstance(
                x, torch.Tensor) else "cpu"), mesh, (CH_AXIS, None, T_AXIS))
        if if_taps is not None:
            flat = sharded_fir_filter(
                mesh, {c: v.reshape(-1, v.shape[-1]) for c, v in xl.items()},
                if_taps)
            xl = {c: v.reshape(-1, 2, v.shape[-1]) for c, v in flat.items()}
        soft, bits = sharded_fsk_demod(cfg, mesh, xl)
        if isinstance(x, dict):
            return soft, bits
        spec = (CH_AXIS, T_AXIS)
        return unshard(soft, mesh, spec), unshard(bits, mesh, spec)

    return step

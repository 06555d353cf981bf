"""Pipeline parallelism: stage-split station dataflow over a mesh axis.

Port of ``radiosonde_auto_rx_tpu/parallel/pp.py``.  The reference's
pipe graph runs each stage (rtl_fm | iq_dec | fsk_demod | decoder) as a
separate OS process connected by pipes, all concurrent on different
byte ranges.  Here it is a systolic microbatch pipeline over a
``stage`` mesh axis: shard ``s`` holds stage ``s``'s function and carry;
every tick each stage processes one microbatch-sized block and hands its
output to stage ``s+1`` with ``ppermute``.  After the ``S-1``-tick fill
all stages work on consecutive time blocks.

Uniform activation shapes: every stage maps ``[C, 2, B] -> [C, 2, B]``
(pad/pack inside the block); each stage's carry stays on its own shard
across microbatches (the demod's ``Nmem`` sliding memory).  The host
knows each shard's stage, so a stage's function is plain Python, and a
tick outside a stage's fill/drain window skips it (its output is zeros
and its carry stays) — the reference computes and masks.  The
``ppermute`` runs every tick on every process.
"""

import numpy as np
import torch

from radiosonde_auto_rx_tpu_torch.demod.fsk import fsk_init_state
from radiosonde_auto_rx_tpu_torch.ops.fir import _conv_valid
from radiosonde_auto_rx_tpu_torch.parallel.collectives import ppermute
from radiosonde_auto_rx_tpu_torch.parallel.mesh import Mesh, process_rank
from radiosonde_auto_rx_tpu_torch.parallel.pipeline import scan

STAGE_AXIS = "stage"


def make_stage_mesh(n_stage: int, devices=None, ranks=None) -> Mesh:
    """A one-axis ``stage`` mesh over the first ``n_stage`` devices
    (default: every visible CUDA device; a list may repeat one)."""
    if devices is None:
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devices = list(devices)
    if len(devices) < n_stage:
        raise ValueError(f"{n_stage} stages need more than {len(devices)} "
                         f"devices")
    dev = np.empty(n_stage, object)
    dev[:] = devices[:n_stage]
    if ranks is None:
        ranks = [process_rank()] * n_stage
    return Mesh(dev, (STAGE_AXIS,), list(ranks)[:n_stage])


def pipeline_parallel(mesh: Mesh, stage_fns, carry_init, xs):
    """Run ``S`` stages over ``M`` microbatches on the ``stage`` axis.

    stage_fns: ``fn(x, carry) -> (y, carry)`` per stage, with uniform
    ``x``/``y`` shape ``xs.shape[1:]``; carry_init: the initial carry of
    each stage (moved to its shard's device); xs: ``[M, ...]``
    microbatches.

    Returns ``[M, ...]``, the last stage's outputs in microbatch order,
    on its device (None where the last stage is another process's).
    Total ticks ``M + S - 1`` (fill + steady state), against ``M * S``
    for serial execution."""
    S = mesh.shape[STAGE_AXIS]
    if not len(stage_fns) == S == len(carry_init):
        raise ValueError(f"{len(stage_fns)} stage functions and "
                         f"{len(carry_init)} carries for {S} stages")
    M = int(xs.shape[0])

    def on(v, dev):
        if isinstance(v, (tuple, list)):
            return type(v)(on(u, dev) for u in v)
        return torch.as_tensor(v).to(dev)

    carries = {c: on(carry_init[c[0]], mesh.device(c)) for c in mesh.local}
    buf = {c: torch.zeros(tuple(xs.shape[1:]), dtype=xs.dtype,
                          device=mesh.device(c)) for c in mesh.local}
    perm = [(s, s + 1) for s in range(S - 1)]
    ys = {c: [] for c in mesh.local}
    for t in range(M + S - 1):
        out = {}
        for c in mesh.local:
            s = c[0]
            # fill/drain gating: stage s holds microbatch t - s
            if s <= t < s + M:
                inp = xs[t].to(mesh.device(c)) if s == 0 else buf[c]
                out[c], carries[c] = stage_fns[s](inp, carries[c])
            else:
                out[c] = torch.zeros_like(buf[c])
            ys[c].append(out[c])
        buf = ppermute(out, mesh, STAGE_AXIS, perm)
    last = (S - 1,)
    if last not in ys:
        return None
    # the last stage emits microbatch m at tick m + S - 1
    return torch.stack(ys[last][S - 1:S - 1 + M])


def make_pp_demod_pipeline(cfg, mesh: Mesh, if_taps, channels: int,
                           t_mb: int):
    """3-stage station pipeline: DC block -> IF lowpass FIR -> FSK demod.

    Returns ``run(xs) -> (soft, bits)`` where ``xs`` is ``[M, C, 2, B]``
    float32 IQ plane microbatches; soft/bits are ``[M, C, nsym_mb]``.
    Stage carries: the DC estimate (stage 0), the FIR overlap-save tail
    (stage 1) and the demod's block-aligned input tail (stage 2) persist
    on their stage shards across microbatches."""
    taps = np.asarray(if_taps, np.float32)  # host taps: on the device once
    K = int(taps.shape[0])
    # block-aligned streaming: carry exactly the 2·ts samples beyond the
    # last block advance (nmem = n + 2·ts) so restarts land on the next
    # nominal block start — every symbol emitted exactly once
    if t_mb % cfg.n:
        raise ValueError("t_mb must be a multiple of cfg.n")
    tail_len = cfg.nmem - cfg.n             # = 2*ts
    nb = t_mb // cfg.n
    nsym_mb = nb * cfg.nsym
    if nsym_mb > t_mb:
        raise ValueError("microbatch too small to carry its symbols")

    def stage_dc(x, carry):
        # running DC estimate (EMA across microbatches)
        dc = 0.98 * carry + 0.02 * torch.mean(x, dim=-1, keepdim=True)
        return (x - dc).to(x.dtype), dc

    def stage_fir(x, tail):
        C, _, B = x.shape
        xx = torch.cat([tail, x.reshape(C * 2, B)], dim=-1)
        y = _conv_valid(xx, taps)[..., :B].reshape(C, 2, B)
        return y.to(x.dtype), xx[:, xx.shape[-1] - (K - 1):]

    def stage_demod(x, tail):
        # restart per microbatch from a fresh state with a block-aligned
        # tail: the scan kernel's unbuffered mode
        xx = torch.cat([tail, x], dim=-1).contiguous()
        state = fsk_init_state(cfg, x.shape[0], x.device)
        _, outs = scan(cfg, xx, state, nb, buffered=False)
        soft, bits = outs["soft"], outs["bits"].to(torch.float32)
        # pack [C, nsym_mb] soft + bits into the uniform [C, 2, B] block
        out = torch.zeros_like(x)
        out[:, 0, :soft.shape[1]] = soft
        out[:, 1, :bits.shape[1]] = bits
        return out, xx[:, :, xx.shape[-1] - tail_len:]

    carry_init = [
        torch.zeros((channels, 2, 1), dtype=torch.float32),
        torch.zeros((channels * 2, K - 1), dtype=torch.float32),
        torch.zeros((channels, 2, tail_len), dtype=torch.float32),
    ]

    def run(xs):
        ys = pipeline_parallel(mesh, [stage_dc, stage_fir, stage_demod],
                               carry_init, torch.as_tensor(xs))
        if ys is None:
            return None
        soft = ys[:, :, 0, :nsym_mb]
        bits = ys[:, :, 1, :nsym_mb].to(torch.uint8)
        return soft, bits

    return run

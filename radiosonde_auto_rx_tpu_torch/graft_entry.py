"""Driver entry points.

Port of the repository's root ``__graft_entry__.py`` (the JAX driver).

Usage: ``python -m radiosonde_auto_rx_tpu_torch.graft_entry [--device
cpu]``: ``entry()``'s step on the device, then ``dryrun_multichip`` over
max(2, visible GPUs) shards (CPU shards with ``--device cpu``).

``entry(device)``       — the single-device forward step on the flagship
                          chain (RS41 experimental path: 48 kHz IQ ->
                          2FSK demod soft bits, reference
                          auto_rx/autorx/decode.py:869-913): 8 channels
                          x 1 s through the scan kernel's unbuffered
                          mode, the reference's ``_fsk_demod_scan``.
``dryrun_multichip(n)`` — the sharded station step over an ``n``-shard
                          ``(ch, t)`` mesh on tiny shapes, with value
                          checks against unsharded and one-device runs.

Where the reference forces JAX onto ``n`` virtual CPU devices, the port
takes a list of shard devices: on the card ``n`` GPUs when that many
are visible, else ``n`` copies of ``cuda:0`` (a virtual mesh); on the
CPU ``n`` CPU shards.  Everything runs in one process (NCCL refuses two
ranks on one GPU).  Without a CUDA device and without ``--device cpu``
the command prints the reference bench's error line and exits 1.
"""

import argparse
import sys

import numpy as np
import torch

from radiosonde_auto_rx_tpu_torch.bench import error_line
from radiosonde_auto_rx_tpu_torch.demod.fsk import (
    FSKConfig, fsk_demod_stream, fsk_init_state, fsk_num_blocks)
from radiosonde_auto_rx_tpu_torch.ops.channelizer import extract_phases
from radiosonde_auto_rx_tpu_torch.ops.fir import _conv_valid, design_lowpass
from radiosonde_auto_rx_tpu_torch.parallel.mesh import make_mesh
from radiosonde_auto_rx_tpu_torch.parallel.pipeline import (
    make_station_step, scan)
from radiosonde_auto_rx_tpu_torch.parallel.pp import (
    make_pp_demod_pipeline, make_stage_mesh)
from radiosonde_auto_rx_tpu_torch.parallel.station_step import (
    EXPERT_TYPES, StationStep)


def _rs41_cfg(nsym=50):
    # fsk_demod --cs16 -b -5000 -u 5000 --mask 5000 -p 5 2 48000 4800
    return FSKConfig(fs=48000, rs=4800, m=2, p=5, nsym=nsym,
                     est_min=-5000, est_max=5000,
                     tone_spacing=5000, freq_est_type=1)


def _tone_iq(cfg, channels, t_samples, seed=0):
    rng = np.random.default_rng(seed)
    bits = rng.integers(0, 2, size=(channels, t_samples // cfg.ts + 1))
    sym = np.repeat(bits, cfg.ts, axis=1)[:, :t_samples]
    f = np.where(sym == 0, -cfg.tone_spacing / 2, cfg.tone_spacing / 2)
    ph = 2 * np.pi * np.cumsum(f, axis=1) / cfg.fs
    iq = np.exp(1j * ph).astype(np.complex64)
    iq += (rng.standard_normal(iq.shape) +
           1j * rng.standard_normal(iq.shape)).astype(np.complex64) * 0.05
    # float32 IQ planes [C, 2, T] — the framework's device-side format
    return np.stack([iq.real, iq.imag], axis=1).astype(np.float32)


def entry(device="cuda"):
    """(fn, args): ``fn(x)`` demodulates x [8, 2, 48000] (on ``device``)
    with the unbuffered scan (one ``fsk_scan`` launch on a CUDA tensor)
    and returns (soft, bits) in the reference's stacked [n_blocks, C,
    nsym] layout."""
    cfg = _rs41_cfg(nsym=50)
    C, T = 8, 48000
    x = torch.from_numpy(_tone_iq(cfg, C, T)).to(device)
    nb = fsk_num_blocks(cfg, T)

    def fn(x):
        state = fsk_init_state(cfg, C, x.device)
        _, outs = scan(cfg, x, state, nb, buffered=False)
        return tuple(outs[k].view(C, nb, -1).transpose(0, 1)
                     for k in ("soft", "bits"))

    return fn, (x,)


def mesh_devices(n: int, device="cuda") -> list:
    """``n`` shard devices: on a CUDA device ``n`` GPUs when that many
    are visible, else ``n`` copies of the one given (a virtual mesh); on
    the CPU ``n`` CPU shards."""
    device = torch.device(device)
    if device.type == "cuda":
        if torch.cuda.device_count() >= n:
            return [torch.device("cuda", i) for i in range(n)]
        return [torch.device("cuda", device.index or 0)] * n
    return [device] * n


def _check(ok: bool, what: str):
    if not ok:
        raise AssertionError(what)


def dryrun_multichip(n_devices: int, devices=None) -> dict:
    """Run the sharded station step over ``n_devices`` shards (default
    ``mesh_devices(n_devices)``) on tiny shapes; raise on any
    mismatch.  Prints the reference's "dryrun_multichip OK" line and
    returns the checked outputs (host tensors) and the line."""
    devices = mesh_devices(n_devices) if devices is None else list(devices)
    _check(len(devices) >= n_devices,
           f"dryrun_multichip needs {n_devices} devices, got {len(devices)}")
    dev0 = devices[0]
    cfg = _rs41_cfg(nsym=50)
    taps = design_lowpass(0.2, 25)
    out = {}

    # leg 1: pure channel DP with a cross-shard VALUE check: the sharded
    # bits must equal the unsharded demod on the same stream
    mesh_dp = make_mesh(n_ch=n_devices, n_t=1, devices=devices)
    C, T = 2 * n_devices, 4096
    x = torch.from_numpy(_tone_iq(cfg, C, T))
    soft, bits = make_station_step(cfg, mesh_dp, if_taps=taps)(x.to(dev0))
    _check(soft.shape[0] == C and bits.shape == soft.shape,
           f"leg 1 shapes {tuple(soft.shape)} {tuple(bits.shape)}")
    halo = cfg.nmem + 8 * cfg.ts
    K = len(taps)
    x2 = torch.cat([torch.zeros((C * 2, K - 1)), x.reshape(C * 2, T)],
                   dim=1).to(dev0)
    y = _conv_valid(x2, taps).reshape(C, 2, T)
    ypad = torch.cat([torch.zeros((C, 2, halo), device=dev0), y], dim=2)
    _, bits_ref, _, _ = fsk_demod_stream(cfg, ypad, dev0)
    out["leg1"] = (bits.cpu(), bits_ref.cpu())
    _check(torch.equal(*out["leg1"]),
           "sharded bits differ from unsharded reference")

    # leg 2: (ch, t) mesh — sequence parallelism with halos
    n_t = 2 if n_devices % 2 == 0 and n_devices >= 2 else 1
    mesh = make_mesh(n_ch=n_devices // n_t, n_t=n_t, devices=devices)
    C = 2 * mesh.shape["ch"]
    T = 4096 * n_t
    soft, bits = make_station_step(cfg, mesh, if_taps=taps)(
        torch.from_numpy(_tone_iq(cfg, C, T)).to(dev0))
    _check(soft.shape[0] == C and bits.shape == soft.shape,
           f"leg 2 shapes {tuple(soft.shape)} {tuple(bits.shape)}")
    out["leg2"] = (soft.cpu(), bits.cpu())

    # pipeline-parallel stage split over a stage sub-mesh
    out["pp"] = None
    if n_devices >= 3:
        smesh = make_stage_mesh(3, devices=devices)
        t_mb = 4 * cfg.n
        xpp = torch.from_numpy(_tone_iq(cfg, 2, 4 * t_mb)).reshape(
            2, 2, 4, t_mb).permute(2, 0, 1, 3).contiguous()
        run = make_pp_demod_pipeline(cfg, smesh, taps, channels=2,
                                     t_mb=t_mb)
        psoft, pbits = run(xpp)
        _check(pbits.shape[0] == 4, f"pp bits {tuple(pbits.shape)}")
        out["pp"] = (psoft.cpu(), pbits.cpu())

    # leg 3: the full station step — channelize, PSD, detect scores,
    # expert all-to-all routing, per-type demod — over the (ch, t) mesh,
    # with a cross-shard VALUE check: the channel-DP mesh's routed
    # expert bits must equal the 1-device mesh's
    n_chan = 8
    n_ch_m = mesh.shape["ch"]
    t_wide = n_chan * mesh.shape["t"] * 13000
    rng = np.random.default_rng(3)
    wide = torch.from_numpy(rng.standard_normal(
        (n_ch_m, 2, t_wide)).astype(np.float32)).to(dev0)
    full_kw = dict(n_chan=n_chan, capacity=2, nfft=256, frame_halo=0)
    step1 = StationStep(mesh=make_mesh(1, 1, devices=devices[:1]),
                        **full_kw)
    stepd = StationStep(mesh=make_mesh(n_ch_m, 1, devices=devices),
                        **full_kw)
    stept = StationStep(mesh=mesh, **full_kw)
    exp_ids = np.full(n_ch_m * n_chan, -1, np.int32)
    exp_ids[1] = EXPERT_TYPES.index("RS41")
    checks = [("RS41", 1)]
    if n_ch_m > 1:
        exp_ids[n_chan + 3] = EXPERT_TYPES.index("MEISEI")
        checks.append(("MEISEI", n_chan + 3))
    routed = {}
    for name, st in (("1dev", step1), ("dp", stepd), ("tp", stept)):
        chf, _, _ = st.analyze(wide)
        res = st.gather_routed(st.route_demod(chf, exp_ids))
        routed[name] = {k: v.cpu() for k, v in res.items()}
    for e_name, cid in checks:
        e = EXPERT_TYPES.index(e_name)
        sr = int(np.flatnonzero(routed["1dev"]["ids"][e].numpy() == cid)[0])
        sd = int(np.flatnonzero(routed["dp"]["ids"][e].numpy() == cid)[0])
        _check(torch.equal(routed["1dev"]["bits"][e, sr],
                           routed["dp"]["bits"][e, sd]),
               f"sharded station bits differ from 1-device ({e_name})")
    out["routed"] = routed

    # the fused steady step on the 1-device mesh (the single-device
    # production dispatch) with one recentered extraction slot
    ph_m, ph_r = extract_phases(10e3, n_chan * 48000, t_wide, n_chan)
    _, _, fouts = step1.steady_step(
        wide, np.array([1], np.int32), np.array([0], np.int32),
        np.array([1], np.int32), ph_m[None], ph_r[None], (("RS41", 1),))
    out["steady_bits"] = fouts["RS41"][1].cpu()

    soft = out["leg2"][0]
    out["line"] = (
        f"dryrun_multichip OK: mesh={dict(mesh.shape)} "
        f"soft={tuple(soft.shape)} {str(soft.dtype).removeprefix('torch.')} "
        f"(dp-value-checked=yes, "
        f"pp={'yes' if n_devices >= 3 else 'skipped'}, "
        f"full-station=sharded channelize+psd+detect+route+demod, "
        f"station-value-checked=yes) on {sorted(set(map(str, devices)))}")
    print(out["line"])
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m radiosonde_auto_rx_tpu_torch.graft_entry")
    ap.add_argument("--device", default="cuda",
                    help="torch device the step runs on (default cuda)")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    cuda = device.type == "cuda"
    if cuda and not torch.cuda.is_available():
        print(error_line("no CUDA device (pass --device cpu to run on the "
                         "CPU)"))
        sys.stdout.flush()
        return 1
    fn, args = entry(device)
    res = fn(*args)
    print("entry OK:", tuple((tuple(a.shape), str(a.dtype).removeprefix(
        "torch.")) for a in res))
    n = max(2, torch.cuda.device_count() if cuda else 1)
    dryrun_multichip(n, mesh_devices(n, device))
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""The port's mesh across two processes, after
``tests/test_multiprocess.py``: two OS processes, each with 4 virtual CPU
shards, join one gloo process group (a ``file://`` store) through
``parallel.multihost`` and run, on the global mesh:

- the station step's full dataflow on (ch, t) = (4, 2): ``analyze``
  (channelizer halo, PSD psum, prescreen halo and pmax), ``confirm``
  (the candidates' streams from their owners' shards across processes)
  and ``route_demod`` (the expert all-to-all, the demod halo, the t
  reductions) on ``station_fixture``'s captures;
- ``make_station_step`` (IF FIR + demod) on (8, 1).

Every cross-shard message between the processes goes through
``torch.distributed``.  Each process's local shards must be bitwise
equal to the same shards of a single-process run of the same mesh over
8 virtual shards, and the routed RS41 slot assembled from both
processes' shards decodes.  Every child runs under a timeout.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from radiosonde_auto_rx_tpu_torch.demod.fsk import FSKConfig  # noqa: E402
from radiosonde_auto_rx_tpu_torch.ops.fir import design_lowpass  # noqa: E402
from radiosonde_auto_rx_tpu_torch.parallel.mesh import (  # noqa: E402
    make_mesh, shard)
from radiosonde_auto_rx_tpu_torch.parallel.pipeline import (  # noqa: E402
    make_station_step)
from radiosonde_auto_rx_tpu_torch.parallel.station_step import (  # noqa: E402
    EXPERT_TYPES, STREAM, StationStep)

torch.set_num_threads(1)
CPU = torch.device("cpu")
NPROC, LOCAL = 2, 4
N_CHAN = 16
TS = 1_755_600_000.0
# station_fixture's geometry: (capture, channel) of each sonde
SONDES = {"RS41": (0, 5), "M20": (3, 9), "DFM": (1, 4), "M10": (2, 11)}
CANDS = [b * N_CHAN + c for b, c in SONDES.values()] + [2 * N_CHAN + 1]
CFG = FSKConfig(fs=48000, rs=4800, m=2, p=5, nsym=50, est_min=-5000,
                est_max=5000, tone_spacing=5000, freq_est_type=1)


def _pipeline_input():
    """make_station_step's input: 16 channels of 2-FSK, the same data
    in every process (seeded)."""
    C, T = 2 * NPROC * LOCAL, 24000
    rng = np.random.default_rng(0)
    bits = rng.integers(0, 2, (C, T // 10 + 2))
    sym = np.repeat(bits, 10, axis=1)[:, :T]
    ph = 2 * np.pi * np.cumsum(np.where(sym == 0, -2500.0, 2500.0),
                               axis=1) / 48000
    iq = np.exp(1j * ph) + (rng.standard_normal(ph.shape) +
                            1j * rng.standard_normal(ph.shape)) * 0.05
    return np.stack([iq.real, iq.imag], axis=1).astype(np.float32)


def run_all(wide, station_mesh, pipeline_mesh):
    """Both dataflows on the given meshes: {name: {coord: array}} of this
    process's shards."""
    step = StationStep(n_chan=N_CHAN, capacity=2, conf_capacity=2,
                       mesh=station_mesh)
    chf, psd, ratios = step.analyze(shard(wide, station_mesh, STREAM))
    slots = np.full(step.n_conf_slots, -1, np.int64)
    slots[:len(CANDS)] = CANDS
    conf = step.confirm(chf, slots)
    exp = np.full(wide.shape[0] * N_CHAN, -1, np.int64)
    for name, (b, c) in SONDES.items():
        exp[b * N_CHAN + c] = EXPERT_TYPES.index(name)
    res = step.route_demod(chf, exp)
    out = dict(chf=chf, psd=psd, ratios=ratios, streams=conf["streams"],
               **{f"peak{i}_{j}": p[j] for i, p in enumerate(conf["peaks"])
                  for j in range(4)}, **res)
    _, bits = make_station_step(CFG, pipeline_mesh,
                                design_lowpass(0.2, 25))(
        shard(_pipeline_input(), pipeline_mesh, STREAM))
    out["pipeline_bits"] = bits
    return {k: {c: v.numpy() for c, v in d.items()} for k, d in out.items()}


def worker(init: str, pid: int, outdir: str):
    """One process of the group: 4 local shards of the global meshes."""
    from radiosonde_auto_rx_tpu_torch.parallel import multihost
    multihost.initialize(init, num_processes=NPROC, process_id=pid,
                         device="cpu")
    import torch.distributed as dist
    assert multihost.process_count() == NPROC
    wide = np.load(os.path.join(outdir, "wide.npy"))
    meshes = (multihost.global_mesh(n_t=2, local_devices=[CPU] * LOCAL),
              multihost.global_mesh(n_t=1, local_devices=[CPU] * LOCAL))
    assert [len(m.local) for m in meshes] == [LOCAL, LOCAL]
    out = run_all(wide, *meshes)
    np.savez(os.path.join(outdir, f"shards_{pid}.npz"),
             **{f"{k}|{c[0]},{c[1]}": v for k, d in out.items()
                for c, v in d.items()})
    dist.destroy_process_group()
    print(f"worker {pid}: {sum(map(len, out.values()))} shards", flush=True)


def test_two_processes_equal_one(tmp_path):
    import station_fixture as fx
    wide = fx.make_wide_captures(TS)
    np.save(tmp_path / "wide.npy", wide)
    init = f"file://{tmp_path / 'store'}"
    env = {k: v for k, v in os.environ.items()
           if k not in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK")}
    procs = [subprocess.Popen(
        [sys.executable, __file__, init, str(pid), str(tmp_path)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for pid in range(NPROC)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=300)[0].decode(
                errors="replace"))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for pid, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"worker {pid} failed:\n{out}"

    devices = [CPU] * (NPROC * LOCAL)
    ref = run_all(wide, make_mesh(n_t=2, devices=devices),
                  make_mesh(n_t=1, devices=devices))
    seen = set()
    for pid in range(NPROC):
        with np.load(tmp_path / f"shards_{pid}.npz") as z:
            for key in z.files:
                name, coord = key.split("|")
                c = tuple(int(v) for v in coord.split(","))
                assert c[0] // (LOCAL // (2 if name != "pipeline_bits"
                                          else 1)) == pid, key
                np.testing.assert_array_equal(z[key], ref[name][c],
                                              err_msg=key)
                seen.add((name, c))
    assert seen == {(n, c) for n, d in ref.items() for c in d}

    # the routed RS41 slot, assembled from the processes' shards, decodes
    step = StationStep(n_chan=N_CHAN, capacity=2, conf_capacity=2,
                       mesh=make_mesh(n_t=2, devices=devices))
    res = step.gather_routed({k: {c: torch.from_numpy(v)
                                  for c, v in ref[k].items()}
                              for k in ("soft", "bits", "ebno", "fres",
                                        "fcnt", "ids", "mask", "dropped")})
    e = EXPERT_TYPES.index("RS41")
    (s,) = np.flatnonzero(res["ids"][e].numpy() == CANDS[0])
    bits, _ = step.slot_bits(res, e, int(s), wide.shape[-1] // N_CHAN)
    from radiosonde_auto_rx_tpu_torch.models import get_model
    telems = get_model("RS41")().decode_bits(bits, None)
    assert telems and telems[-1]["id"] == "T1357911"


if __name__ == "__main__":
    worker(sys.argv[1], int(sys.argv[2]), sys.argv[3])

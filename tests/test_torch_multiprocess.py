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
processes' shards decodes.  The dataflow is ``chip_smoke.
fixture_dataflow``, which phase 15 runs over NCCL on the card
(``tests/test_torch_nccl.py``).  Every child runs under a timeout.
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

import chip_smoke as cs  # noqa: E402
from radiosonde_auto_rx_tpu_torch.parallel.mesh import make_mesh  # noqa: E402

torch.set_num_threads(1)
CPU = torch.device("cpu")
NPROC, LOCAL = 2, 4
# both dataflows on the given meshes: {name: {coord: array}} of this
# process's shards (``StationStep`` on the (4, 2) mesh, the pipeline on
# (8, 1))
run_all = cs.fixture_dataflow


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
    wide = fx.make_wide_captures(cs.FX_TS)
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
    seen, assembled = set(), {}
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
                assembled.setdefault(name, {})[c] = z[key]
    assert seen == {(n, c) for n, d in ref.items() for c in d}

    # the routed RS41 slot, assembled from the processes' shards, decodes
    telems = cs.fixture_rs41(assembled)
    assert telems and telems[-1]["id"] == "T1357911"


if __name__ == "__main__":
    worker(sys.argv[1], int(sys.argv[2]), sys.argv[3])

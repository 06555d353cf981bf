"""The sharded station step across processes over NCCL, one GPU a
process, after ``tests/test_multiprocess.py``.

On the CPU, with a faked NCCL group of two ranks on a host of four GPUs
(``torch.distributed`` and ``torch.cuda`` patched), the repairs that
the path needs:

- ``multihost.global_mesh()`` gives each rank one shard, on its own
  ``cuda:r``; an explicit ``local_devices`` list still wins;
- ``collectives.comm_device()`` is the rank's NCCL GPU (the CPU under
  gloo), and ``transfer`` packs and receives on it, each shard getting
  its payload on its own device;
- ``multihost.initialize`` passes a timeout, makes the rank's GPU
  current before the group exists, and builds the communicator
  (``device_id``, then a barrier on the GPU) before any point-to-point
  message.

On the card (marker ``cuda``; the N-process case skips below N GPUs):
N processes (this file is their worker: ``python tests/test_torch_nccl.py
<file://store> <N> <pid> <dir>``) each hold 8/N virtual shards on
their one GPU and run ``tests/test_torch_multiprocess.py``'s ``run_all``
(``chip_smoke.fixture_dataflow``) on ``station_fixture``'s captures,
rebuilt from the port's copies (``chip_smoke.fixture_captures``: the GPU
host has no JAX); every shard is held to one process's run of the same
meshes on ``cuda:0`` (integers and masks equal, floats within
``chip_smoke.MESH_FLOAT_TOL`` of their peak), the routed RS41 slot
assembled from the ranks decodes, and the scan and K2 launched in every
rank.  On a GPU host (no JAX there, so without the repo's conftest)::

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_nccl.py
"""

import datetime
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from radiosonde_auto_rx_tpu_torch.parallel import (  # noqa: E402
    collectives, multihost)
from radiosonde_auto_rx_tpu_torch.parallel.collectives import (  # noqa: E402
    ppermute)
from radiosonde_auto_rx_tpu_torch.parallel.mesh import make_mesh  # noqa: E402

CPU = torch.device("cpu")
META = torch.device("meta")


def _nccl_group(monkeypatch, rank, backend="nccl", world=2, gpus=4):
    """A faked initialized group: ``rank`` of ``world`` on ``backend``,
    ``gpus`` visible GPUs, ``cuda:rank`` current."""
    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    monkeypatch.setattr(dist, "get_backend", lambda group=None: backend)
    monkeypatch.setattr(dist, "get_world_size", lambda group=None: world)
    monkeypatch.setattr(dist, "get_rank", lambda group=None: rank)
    monkeypatch.setattr(dist, "all_gather_object",
                        lambda out, obj, group=None: out.__setitem__(
                            slice(None), [obj] * len(out)))
    monkeypatch.setattr(torch.cuda, "device_count", lambda: gpus)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: rank)


@pytest.mark.parametrize("rank", [0, 1])
def test_global_mesh_default_is_the_ranks_own_gpu(monkeypatch, rank):
    _nccl_group(monkeypatch, rank)
    mesh = multihost.global_mesh()
    assert mesh.shape == {"ch": 2, "t": 1}
    assert mesh.local == [(rank, 0)]
    assert mesh.device((rank, 0)) == torch.device("cuda", rank)
    # an explicit list wins: 4 virtual CPU shards a process
    mesh = multihost.global_mesh(n_t=2, local_devices=[CPU] * 4)
    assert mesh.shape == {"ch": 4, "t": 2}
    assert mesh.local == [(2 * rank + i, j) for i in range(2)
                          for j in range(2)]
    assert {mesh.device(c) for c in mesh.local} == {CPU}


def test_comm_device_is_the_nccl_gpu(monkeypatch):
    _nccl_group(monkeypatch, 1)
    assert collectives.comm_device() == torch.device("cuda", 1)
    _nccl_group(monkeypatch, 1, backend="gloo")
    assert collectives.comm_device() == CPU


@pytest.mark.parametrize("rank", [0, 1])
def test_transfer_packs_on_the_comm_device(monkeypatch, rank):
    """Shard (0, 0) of rank 0 sends to shard (1, 0) of rank 1.  Rank 0's
    shards lie on the CPU and its messages must be packed on the
    communication device (here ``meta``), not on its first shard's;
    rank 1 receives on the communication device (the CPU) and its shard
    gets the payload on its own device (``meta``)."""
    _nccl_group(monkeypatch, rank)
    comm, shard_dev = (META, CPU) if rank == 0 else (CPU, META)
    monkeypatch.setattr(collectives, "comm_device", lambda: comm)
    posted = []
    monkeypatch.setattr(dist, "P2POp", lambda op, t, peer: (op, t, peer))
    monkeypatch.setattr(dist, "batch_isend_irecv",
                        lambda ops: posted.extend(ops) or [])
    mesh = make_mesh(2, 1, devices=[shard_dev] * 2, ranks=[0, 1])
    assert mesh.local == [(rank, 0)]
    x = {(rank, 0): torch.arange(6, dtype=torch.float32,
                                 device=shard_dev)}
    got = ppermute(x, mesh, "ch", [(0, 1)])
    ((op, t, peer),) = posted
    assert (op, peer) == ((dist.isend, 1) if rank == 0 else (dist.irecv, 0))
    assert t.device == comm and t.numel() == 6
    assert got[(rank, 0)].device == shard_dev


def test_initialize_sets_timeout_and_builds_the_communicator(monkeypatch):
    calls = []
    monkeypatch.delenv("LOCAL_RANK", raising=False)
    monkeypatch.setattr(dist, "is_initialized", lambda: False)
    monkeypatch.setattr(dist, "init_process_group",
                        lambda backend, **kw: calls.append(("init", backend,
                                                            kw)))
    monkeypatch.setattr(dist, "barrier",
                        lambda **kw: calls.append(("barrier", kw)))
    monkeypatch.setattr(dist, "get_rank", lambda group=None: 1)
    monkeypatch.setattr(dist, "get_world_size", lambda group=None: 2)
    monkeypatch.setattr(torch.cuda, "set_device",
                        lambda d: calls.append(("set_device", d)))
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    multihost.initialize("127.0.0.1:29500", 2, 1, device="cuda")
    gpu = torch.device("cuda", 1)
    timeout = datetime.timedelta(seconds=multihost.TIMEOUT_S)
    assert calls == [
        ("set_device", gpu),
        ("init", "nccl", dict(init_method="tcp://127.0.0.1:29500",
                              world_size=2, rank=1, timeout=timeout,
                              device_id=gpu)),
        ("barrier", dict(device_ids=[1]))]
    calls.clear()
    multihost.initialize("file:///x/store", 2, 0, device="cpu")
    assert calls == [("init", "gloo", dict(
        init_method="file:///x/store", world_size=2, rank=0,
        timeout=timeout))]
    calls.clear()
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(RuntimeError, match="found none"):
        multihost.initialize("127.0.0.1:29500", 2, 1, device="cuda")
    assert calls == []


# ---------------------------------------------------------------------- #
# on the card

SHARDS = cs.FX_SHARDS           # the (4, 2) and (8, 1) meshes


def worker(init: str, nproc: int, pid: int, outdir: str):
    """One process of the group: 8 / nproc shards of the global meshes
    on its own GPU."""
    from radiosonde_auto_rx_tpu_torch import kernels
    from test_torch_multiprocess import run_all
    multihost.initialize(init, num_processes=nproc, process_id=pid,
                         device="cuda")
    try:
        gpu = collectives.comm_device()
        default = multihost.global_mesh()
        local = [gpu] * (SHARDS // nproc)
        meshes = (multihost.global_mesh(n_t=2, local_devices=local),
                  multihost.global_mesh(n_t=1, local_devices=local))
        kernels.reset_launches()
        out = run_all(np.load(os.path.join(outdir, "wide.npy")), *meshes)
        launches = dict(kernels.launches)
        np.savez(os.path.join(outdir, f"shards_{pid}.npz"),
                 **{f"{k}|{c[0]},{c[1]}": v for k, d in out.items()
                    for c, v in d.items()})
        with open(os.path.join(outdir, f"info_{pid}.json"), "w") as f:
            json.dump(dict(device=str(gpu), launches=launches,
                           default=[str(default.device(c))
                                    for c in default.local]), f)
    finally:
        dist.destroy_process_group()


@pytest.mark.cuda
@pytest.mark.parametrize("nproc", [2, 4])
def test_processes_over_nccl_equal_one(nproc, tmp_path):
    if torch.cuda.device_count() < nproc:
        pytest.skip(f"{nproc} NCCL processes need {nproc} GPUs on this host "
                    f"(one a process)")
    from radiosonde_auto_rx_tpu_torch import kernels
    from test_torch_multiprocess import run_all
    kernels.library_path()              # built once, before the workers
    wide = cs.fixture_captures(cs.FX_TS)
    np.save(tmp_path / "wide.npy", wide)
    init = f"file://{tmp_path / 'store'}"
    env = {k: v for k, v in os.environ.items()
           if k not in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK",
                        "LOCAL_RANK")}
    procs = [subprocess.Popen(
        [sys.executable, __file__, init, str(nproc), str(pid),
         str(tmp_path)], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT) for pid in range(nproc)]
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
        assert p.returncode == 0, f"worker {pid} failed:\n{out[-4000:]}"

    dev = torch.device("cuda", 0)
    ref = run_all(wide, make_mesh(n_t=2, devices=[dev] * SHARDS),
                  make_mesh(n_t=1, devices=[dev] * SHARDS))
    ranks, assembled = [], {}
    for pid in range(nproc):
        info = json.loads((tmp_path / f"info_{pid}.json").read_text())
        assert info["device"] == info["default"][0] == f"cuda:{pid}"
        assert len(info["default"]) == 1
        assert info["launches"]["fsk_scan"] > 0, info
        assert info["launches"]["fft_abs2"] > 0, info
        got = {}
        with np.load(tmp_path / f"shards_{pid}.npz") as z:
            for key in z.files:
                name, coord = key.split("|")
                c = tuple(int(v) for v in coord.split(","))
                got.setdefault(name, {})[c] = z[key]
                assembled.setdefault(name, {})[c] = z[key]
        ranks.append(got)
    local = SHARDS // nproc
    cs.compare_shards(ranks, ref, f"{nproc} NCCL processes",
                      lambda name, c: c[0] // (
                          local if name == "pipeline_bits" else local // 2))
    telems = cs.fixture_rs41(assembled)
    assert telems and telems[-1]["id"] == "T1357911"


if __name__ == "__main__":
    worker(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])

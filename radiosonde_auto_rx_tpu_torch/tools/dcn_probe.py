"""Cross-process collective cost probe: measure and fit.

Port of ``radiosonde_auto_rx_tpu/tools/dcn_probe.py``.  It measures the
latency and bandwidth of the collectives the sharded station step calls
between processes (``parallel/collectives.py``: the halo exchange's
``ppermute`` over ``t``, the expert ``all_to_all`` over ``ch``, and a
scalar ``psum`` as the zero-byte baseline) on a real two-process
``torch.distributed`` group on one host, and fits the alpha-beta cost
model t = alpha + beta * bytes to each collective.

Usage::

    python -m radiosonde_auto_rx_tpu_torch.tools.dcn_probe [--device
        cuda|cpu] [-o out.json]

It spawns two worker processes that join one group
(``parallel.multihost.initialize``, a TCP store on a free local port),
each holding two shards of a four-shard mesh whose neighbours alternate
processes, so every ``ppermute`` hop and half of every ``all_to_all``
crosses the process boundary.  ``--device cuda`` (the default) puts
each process's shards on its own GPU and probes NCCL; NCCL refuses two
ranks on one GPU, so on a host with fewer than two GPUs the probe stops
with exit 1.  ``--device cpu`` puts them on the CPU and probes gloo over
loopback.  Messages of 64 KiB, 1 MiB and 8 MiB a shard; each timing is
the best of three runs of 30 back-to-back collectives.  The fit is
printed as JSON (and written to ``-o`` when given).
"""

import argparse
import json
import os
import socket
import subprocess
import sys
import tempfile
import time
from pathlib import Path

SIZES = (65536, 1048576, 8388608)       # bytes a shard
REPS = 30
TRIALS = 3
NPROC = 2
LOCAL = 2                               # shards a process
TRANSPORT = {
    "cuda": "torch.distributed nccl, 2 processes on one host "
            "(one GPU a process, 2 shards on each)",
    "cpu": "torch.distributed gloo, 2-process loopback "
           "(CPU shards, 2 a process)",
}


def _sync():
    """Wait for this process's queued device work (NCCL's transfers are
    queued on the GPU's stream; gloo's finish on the host)."""
    import torch
    import torch.distributed as dist
    if dist.get_backend() == "nccl":
        torch.cuda.synchronize()


def _barrier():
    import torch
    import torch.distributed as dist
    if dist.get_backend() == "nccl":
        dist.barrier(device_ids=[torch.cuda.current_device()])
    else:
        dist.barrier()


def _timeit(fn, reps: int) -> float:
    """Best over ``TRIALS`` of the mean seconds of ``reps`` calls of
    ``fn`` until their device work has ended, after one warm-up; both
    processes start each trial together."""
    fn()
    best = float("inf")
    for _ in range(TRIALS):
        _sync()
        _barrier()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        _sync()
        best = min(best, (time.perf_counter() - t0) / reps)
    return best


def _measure(sizes, reps: int, device: str) -> dict:
    """This process's timings of the three collectives on the global
    four-shard meshes (each process's shards on ``device``: its own GPU
    for ``cuda``); {name_size: seconds}."""
    import torch
    from radiosonde_auto_rx_tpu_torch.parallel.collectives import (
        all_to_all, ppermute, psum)
    from radiosonde_auto_rx_tpu_torch.parallel.mesh import make_mesh
    from radiosonde_auto_rx_tpu_torch.parallel.multihost import process_count
    nproc = process_count()
    n_dev = LOCAL * nproc
    ranks = [i % nproc for i in range(n_dev)]           # alternate
    # a shard lies on its owner's device (rank r on GPU r)
    devices = [torch.device("cuda", r) if device == "cuda"
               else torch.device("cpu") for r in ranks]
    res = {}

    # ppermute (the halo exchange) over t: every hop crosses processes
    mesh = make_mesh(n_ch=1, n_t=n_dev, devices=devices, ranks=ranks)
    perm = [(i, (i + 1) % n_dev) for i in range(n_dev)]
    for size in sizes:
        n = size // 4
        x = {c: torch.arange(n, dtype=torch.float32,
                             device=mesh.device(c)) + c[1] * n
             for c in mesh.local}

        def halo(x=x):
            recv = ppermute(x, mesh, "t", perm)
            return {c: v + recv[c] for c, v in x.items()}

        res[f"ppermute_{size}"] = _timeit(halo, reps)

    # all_to_all (expert routing) over ch
    mesh = make_mesh(n_ch=n_dev, n_t=1, devices=devices, ranks=ranks)
    for size in sizes:
        per = max(1, size // 4 // n_dev)
        x = {c: torch.arange(n_dev * per, dtype=torch.float32,
                             device=mesh.device(c))
             .reshape(n_dev, per) + c[0] for c in mesh.local}
        res[f"all_to_all_{size}"] = _timeit(
            lambda x=x: all_to_all(x, mesh, "ch"), reps)

    # zero-byte baseline: psum of a scalar row (pure latency)
    x = {c: torch.ones(8, device=mesh.device(c)) for c in mesh.local}
    res["psum_scalar"] = _timeit(lambda: psum(x, mesh, "ch"), reps)
    return res


def _worker(init: str, nproc: int, pid: int, out: str, sizes, reps: int,
            device: str):
    import torch
    import torch.distributed as dist
    from radiosonde_auto_rx_tpu_torch.parallel import multihost
    torch.set_num_threads(1)
    multihost.initialize(init, num_processes=nproc, process_id=pid,
                         device=device)
    try:
        res = _measure(sizes, reps, device)
        if pid == 0:
            with open(out, "w") as f:
                json.dump(res, f)
        _barrier()
    finally:
        dist.destroy_process_group()


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    p = s.getsockname()[1]
    s.close()
    return p


def gpus_short(device: str) -> str | None:
    """Why ``device`` cannot hold the probe's processes (``cuda`` with
    fewer GPUs than processes), or None."""
    if device != "cuda":
        return None
    import torch
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n >= NPROC:
        return None
    return (f"the NCCL probe needs {NPROC} GPUs on this host (one a "
            f"process; NCCL refuses two ranks on one GPU), found {n}; "
            f"--device cpu probes gloo on the CPU")


def run_probe(sizes=SIZES, reps: int = REPS, timeout: float = 900,
              device: str = "cuda") -> dict:
    """Spawn the two workers with their shards on ``device``, wait for
    them (each under ``timeout`` seconds; a worker that fails or
    outlasts it stops both) and return process 0's timings
    {name_size: seconds}."""
    short = gpus_short(device)
    if short:
        raise RuntimeError(short)
    init = f"tcp://127.0.0.1:{_free_port()}"
    fd, out = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    # the workers import this package from where it lies (after the
    # caller's own path)
    env = dict(os.environ)
    root = str(Path(__file__).resolve().parents[2])
    env["PYTHONPATH"] = os.pathsep.join(
        [p for p in env.get("PYTHONPATH", "").split(os.pathsep) if p] +
        [root])
    args = [",".join(map(str, sizes)), str(reps), device]
    procs = [subprocess.Popen(
        [sys.executable, "-m", "radiosonde_auto_rx_tpu_torch.tools.dcn_probe",
         "--worker", init, str(NPROC), str(pid), out] + args, env=env)
        for pid in range(NPROC)]
    try:
        for p in procs:
            if p.wait(timeout=timeout) != 0:
                raise RuntimeError(f"dcn probe worker exited {p.returncode}")
        with open(out) as f:
            return json.load(f)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        os.unlink(out)


def fit_alpha_beta(res, prefix):
    """Least-squares alpha (s) + beta (s/byte) from t = a + b*size."""
    import numpy as np
    sizes, ts = [], []
    for k, v in res.items():
        if k.startswith(prefix):
            sizes.append(int(k.rsplit("_", 1)[1]))
            ts.append(float(v))
    A = np.stack([np.ones(len(sizes)), np.asarray(sizes, float)], axis=1)
    coef, *_ = np.linalg.lstsq(A, np.asarray(ts), rcond=None)
    return {"alpha_s": float(coef[0]), "beta_s_per_byte": float(coef[1]),
            "points": dict(zip(map(str, sizes), ts))}


def report(res, device: str = "cuda") -> dict:
    """The fit of each collective, under the reference's keys."""
    return {
        "transport": TRANSPORT[device],
        "ppermute": fit_alpha_beta(res, "ppermute_"),
        "all_to_all": fit_alpha_beta(res, "all_to_all_"),
        "psum_scalar_s": res.get("psum_scalar"),
    }


def main(argv=None):
    argv = sys.argv[1:] if argv is None else list(argv)
    if argv[:1] == ["--worker"]:
        init, nproc, pid, out, sizes, reps, device = argv[1:8]
        _worker(init, int(nproc), int(pid), out,
                [int(v) for v in sizes.split(",")], int(reps), device)
        return 0
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", choices=sorted(TRANSPORT), default="cuda",
                    help="where each process's shards lie: its own GPU "
                         "(NCCL; needs 2 GPUs) or the CPU (gloo)")
    ap.add_argument("-o", "--output", default=None)
    args = ap.parse_args(argv)
    short = gpus_short(args.device)
    if short:
        print(f"dcn_probe: {short}", file=sys.stderr)
        return 1
    js = json.dumps(report(run_probe(device=args.device), args.device),
                    indent=1)
    if args.output:
        with open(args.output, "w") as f:
            f.write(js + "\n")
    print(js)
    return 0


if __name__ == "__main__":
    sys.exit(main())

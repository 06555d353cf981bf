"""The benchmark of ``radiosonde_auto_rx_tpu_torch``'s station: one cell, one run.

    python3 -m stationbench.run --workload <cell> --seed <n> --seconds <s>
        --trace <0|1>

from the root of a checkout.  The cell (``BENCHMARK.json``'s
``workloads``) names a configuration
(``stationbench/configs/<name>.json``: the station's settings and the
capture) and a traffic mix
(``stationbench/traffic/<name>.json``: the sondes on air, the warm-up,
the limits of the checks).  The run builds the station as a user's is
built (the default frame-plane pool, the fused steady step, the filters,
no exporters), feeds it the generator's cs16 blocks through the served
path, ``Station.captures_dispatch`` of block k+1 then
``Station.captures_collect`` of block k, as ``station.main.run_station``
does, in a closed loop (the next block is handed over when the loop asks
for it).  Warm-up blocks, in which the station finds its sondes itself,
are set-up; then the window runs at least ``--seconds`` and at least
CHAN_DRAW blocks, to the return of the collect that passes both.

The last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics;
with ``--trace 1`` its per-layer metrics, each read by
``stationbench/metrics/<name>.py``), ``device``, with ``--trace 1``
``breakdown``, and ``checks``: each number compared with its limit,
printed on standard error too.  Without a CUDA device, without the cards
the cell asks for, or with JAX or the JAX package loaded once the window
has closed, it prints no result and exits non-zero.
"""

import argparse
import gc
import importlib
import json
import math
import os
import sys
import time
from pathlib import Path

FORBIDDEN = ("jax", "jaxlib", "flax", "radiosonde_auto_rx_tpu")
EXIT_NO_DEVICE = 2
EXIT_FORBIDDEN = 3
CHAN_SAMPLES = 4          # window blocks whose channel rows are judged
CHAN_DRAW = 16            # ... drawn from the window's first blocks
PSD_SAMPLES = 2           # scanned window blocks whose PSD is judged


def process_start() -> float:
    """Wall time at which this process started (``/proc``)."""
    try:
        with open("/proc/self/stat") as f:
            fields = f.read().rsplit(")", 1)[1].split()
        with open("/proc/uptime") as f:
            up = float(f.read().split()[0])
        return time.time() - (up - int(fields[19]) /
                              os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return time.time()


def child_pids(parent: int) -> set:
    """Every live descendant of ``parent`` (``/proc``)."""
    kids = {}
    for d in os.listdir("/proc"):
        if not d.isdigit():
            continue
        try:
            with open(f"/proc/{d}/stat") as f:
                fields = f.read().rsplit(")", 1)[1].split()
        except (OSError, IndexError):
            continue
        if fields[0] != "Z":
            kids.setdefault(int(fields[1]), []).append(int(d))
    out, todo = set(), [parent]
    while todo:
        for c in kids.get(todo.pop(), []):
            if c not in out:
                out.add(c)
                todo.append(c)
    return out


def tracker_pid():
    """The pid of multiprocessing's resource tracker, None where none
    runs."""
    from multiprocessing import resource_tracker
    return getattr(resource_tracker._resource_tracker, "_pid", None)


def stop_children(before: set, had_tracker: bool, grace: float = 5.0):
    """Ends every process that this run started and waits for each: the
    frame-plane pool's workers (joined, then terminated, then killed),
    multiprocessing's resource tracker (started with the pool's queues),
    and any other descendant not among ``before``.  Nothing started
    before the run is touched."""
    import multiprocessing as mp
    import signal
    for p in mp.active_children():
        if p.pid in before:
            continue
        p.join(grace)
        if p.is_alive():
            p.terminate()
            p.join(grace)
        if p.is_alive():
            p.kill()
            p.join()
    if not had_tracker and tracker_pid() is not None:
        from multiprocessing import resource_tracker
        rt = resource_tracker._resource_tracker
        if hasattr(rt, "_stop"):
            rt._stop()
        else:
            os.close(rt._fd)
            os.waitpid(rt._pid, 0)
            rt._fd = rt._pid = None
    left = child_pids(os.getpid()) - before
    for sig in (signal.SIGTERM, signal.SIGKILL):
        for pid in left:
            try:
                os.kill(pid, sig)
            except ProcessLookupError:
                pass
        t_end = time.time() + grace
        while left and time.time() < t_end:
            for pid in list(left):
                try:                        # reaps a child of this one
                    os.waitpid(pid, os.WNOHANG)
                except ChildProcessError:
                    pass
            left &= child_pids(os.getpid())
            time.sleep(0.05)
        if not left:
            break
    if left:
        print(f"stationbench: processes left running: {sorted(left)}",
              file=sys.stderr)


def parse_args(argv=None):
    ap = argparse.ArgumentParser(prog="stationbench.run")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def load_json(path: Path):
    with open(path) as f:
        return json.load(f)


class Cell:
    """A cell of ``BENCHMARK.json`` with its configuration, traffic and
    metrics, found by name."""

    def __init__(self, root: Path, name: str):
        bench = load_json(root / "BENCHMARK.json")
        cells = {w["name"]: w for w in bench["workloads"]}
        if name not in cells:
            raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
        self.spec = cells[name]
        self.name = name
        configs = {c["name"]: c for c in bench["configs"]}
        self.config = load_json(root / configs[self.spec["config"]]["file"])
        self.traffic = load_json(root / "stationbench" / "traffic" /
                                 f"{self.spec['traffic']}.json")
        self.chips = int(self.spec["chips"])

        def mine(m):
            return name in m.get("workloads", [name])
        self.end_to_end = [m for m in bench["end_to_end"] if mine(m)]
        self.per_layer = [m for m in bench["per_layer"] if mine(m)]


class Tap:
    """Keeps what the sequential route's channelizer and PSD return while
    ``on``: the station module's own ``channelize`` and
    ``power_spectrum``, wrapped (their arguments and results untouched)."""

    def __init__(self, module):
        self.module, self.on = module, False
        self.ch, self.psd, self.calls = [], [], 0
        self._orig = (module.channelize, module.power_spectrum)

        def channelize(*a, **k):
            out = self._orig[0](*a, **k)
            if self.on:
                self.ch.append(out)
            return out

        def power_spectrum(*a, **k):
            out = self._orig[1](*a, **k)
            self.calls += 1
            if self.on:
                self.psd.append(out[1])
            return out
        module.channelize, module.power_spectrum = channelize, power_spectrum

    def close(self):
        self.module.channelize, self.module.power_spectrum = self._orig


def percentile(values, q: float) -> float:
    """The q-th percentile (linear between order statistics)."""
    v = sorted(values)
    if len(v) == 1:
        return float(v[0])
    x = (len(v) - 1) * q / 100.0
    lo = math.floor(x)
    hi = min(lo + 1, len(v) - 1)
    return float(v[lo] + (v[hi] - v[lo]) * (x - lo))


class Run:
    """One run of a cell on ``device``."""

    def __init__(self, cell: Cell, seed: int, seconds: float, trace: bool,
                 device, t_start: float):
        import numpy as np
        import torch
        from stationbench.generator import Generator, Prefetch, Traffic
        self.cell, self.seed, self.seconds = cell, seed, seconds
        self.trace, self.device, self.t_start = trace, device, t_start
        self.cuda = torch.device(device).type == "cuda"
        cfg, tr = cell.config, cell.traffic
        self.block_s = float(cfg["block_seconds"])
        self.center = float(cfg["center_mhz"]) * 1e6
        self.warm = int(tr["warmup_blocks"])
        self.n_blocks = self.warm + int(math.ceil(
            seconds * float(tr["max_realtime_x"]) / self.block_s)) + 2
        self.traffic = Traffic(tr, {**cfg["station"], **cfg}, seed,
                               self.n_blocks)
        self.prefetch = Prefetch(Generator(self.traffic, device))
        rng = np.random.default_rng([seed, 3])
        self.chan_pick = set(int(j) for j in rng.choice(
            CHAN_DRAW, CHAN_SAMPLES, replace=False))
        self.psd_from = int(rng.integers(0, CHAN_DRAW // 2))
        self.chan_keep, self.psd_keep = [], []

    # ------------------------------------------------------------------ #

    def build_station(self):
        """The station as a user's is built from the configuration, handed
        the traffic's GPS ephemeris (a station may not fetch one)."""
        from radiosonde_auto_rx_tpu_torch.station.gps_ephem import Ephemeris
        from radiosonde_auto_rx_tpu_torch.station.station import Station
        conf = dict(self.cell.config["station"])
        ephs = []
        for e in self.traffic.ephemeris:
            eph = Ephemeris()
            for k, v in e.items():
                setattr(eph, k, v)
            ephs.append(eph)
        conf["rs92_ephemeris"] = ephs
        return Station(conf, center_freq_hz=self.center, device=self.device)

    def next_block(self):
        self.k += 1
        return self.prefetch.get()

    def drive(self):
        """Set-up, warm-up and the window; returns the window's blocks.
        The station, its pool, the generator's thread and the tap are
        closed whatever happens."""
        import torch
        import radiosonde_auto_rx_tpu_torch.station.station as station_mod
        self.k = 0
        self.prof = None
        self.tap = Tap(station_mod)
        st = None
        try:
            st = self.station = self.build_station()
            # warm-up: the same loop, drained before the window
            pending = st.captures_dispatch([self.next_block()])
            for _ in range(1, self.warm):
                nxt = st.captures_dispatch([self.next_block()])
                st.captures_collect(pending)
                pending = nxt
            st.captures_collect(pending)
            if self.cuda:
                torch.cuda.synchronize()
                # the window's peak: the station's, with the generator's
                # blocks in flight (set-up's own is left out)
                torch.cuda.reset_peak_memory_stats()
            self.setup_s = time.time() - self.t_start
            if self.trace:
                from torch.profiler import ProfilerActivity, profile
                acts = [ProfilerActivity.CPU] + \
                    ([ProfilerActivity.CUDA] if self.cuda else [])
                self.prof = profile(activities=acts)
                with self.prof:
                    blocks, last = self.window(st)
                    if self.cuda:
                        torch.cuda.synchronize()
            else:
                blocks, last = self.window(st)
            self.memory_peak = torch.cuda.max_memory_allocated() \
                if self.cuda else 0
            st.captures_collect(last)               # the block in flight
        finally:
            self.tap.close()
            self.prefetch.close()
            if st is not None:
                st.close()
        return blocks

    def window(self, st):
        """The measured window: dispatch block k+1, collect block k, until
        ``seconds`` and CHAN_DRAW blocks have passed.  Returns the
        collected blocks and the pending dispatch of the last one."""
        from torch.profiler import record_function as rf
        blocks = []
        with rf("window"):
            t0 = time.perf_counter()
            blk = self.next_block()
            d0 = time.perf_counter()
            with rf("dispatch"):
                pending = st.captures_dispatch([blk])
            cur = dict(k=self.k - 1, host=blk, pending=pending, t_disp=d0,
                       dispatch_s=time.perf_counter() - d0)
            while True:
                blk = self.next_block()
                d0 = time.perf_counter()
                with rf("dispatch"):
                    nxt = st.captures_dispatch([blk])
                d1 = time.perf_counter()
                j = len(blocks)
                self.tap.on = self.wants(j)
                self.tap.ch, self.tap.psd, self.tap.calls = [], [], 0
                with rf("collect"):
                    tel = st.captures_collect(cur["pending"])
                t_r = time.perf_counter()
                self.tap.on = False
                cur.update(t_ret=t_r, collect_s=t_r - d1, telem=tel,
                           tasks=[(v["type"], fz - self.center)
                                  for fz, v in st.active.items()])
                self.keep(j, cur)
                blocks.append(cur)
                cur = dict(k=self.k - 1, host=blk, pending=nxt, t_disp=d0,
                           dispatch_s=d1 - d0)
                if t_r - t0 >= self.seconds and len(blocks) >= CHAN_DRAW:
                    break
        self.window_s = t_r - t0
        return blocks, cur["pending"]

    def wants(self, j):
        """Whether window block ``j``'s outputs are judged: its channel
        rows (drawn from the seed) or its PSD (the first PSD_SAMPLES
        scanned blocks from a seeded start)."""
        if j in self.chan_pick:
            return True
        return j >= self.psd_from and len(self.psd_keep) < PSD_SAMPLES

    def keep(self, j, blk):
        """Keeps what the check of block ``j`` needs, then drops the
        station's pending tuple."""
        p = blk.pop("pending")
        if p[0] == "seq":
            chf = self.tap.ch[0] if self.tap.ch else None
            psd = self.tap.psd[0] if self.tap.psd else None
            rec = set()
            blk["scanned"] = self.tap.calls
        else:
            chf, psd, rec = p[4], p[5], set(p[8]["rec"]) if p[8] else set()
            blk["scanned"] = int(psd is not None)
        if j in self.chan_pick and chf is not None:
            self.chan_keep.append((blk["host"], chf, rec))
        if psd is not None and j >= self.psd_from and \
                len(self.psd_keep) < PSD_SAMPLES:
            self.psd_keep.append((blk["host"], psd, p[0] == "seq"))
        blk["host"] = None

    # ------------------------------------------------------------------ #

    def check(self, blocks):
        """The numbers compared, each (value, limit), and the counts."""
        import numpy as np
        from stationbench import reference as ref
        n_chan = self.station.profile().n_chan
        limits = self.cell.traffic["limits"]
        checks = {}
        # channel rows and PSD against the float64 reference
        errs = []
        for host, chf, rec in self.chan_keep:
            got = chf.float().cpu().numpy()
            want = ref.channelize(ref.planes(host), n_chan)
            rows = [r for r in range(n_chan) if r not in rec]
            errs.append(ref.chan_err(got, want, rows))
        checks["chan_err"] = (max(errs) if errs else float("nan"),
                              limits["chan_err"])
        errs = []
        for host, psd, seq in self.psd_keep:
            got = np.asarray(psd if seq else psd.float().cpu().numpy())
            got = got.reshape(-1)
            if seq:
                got = 10.0 ** (got / 10.0)
            want = ref.welch(ref.planes(host), 2048, 8192)
            errs.append(ref.psd_err(got, want))
        checks["psd_err"] = (max(errs) if errs else float("nan"),
                             limits["psd_err"])
        # detection decisions: every task a sonde's
        wrong = set()
        for b in blocks:
            wrong.update((t, round(f, -2)) for t, f in
                         ref.wrong_tasks(self.traffic, b["tasks"]))
        for t, f in sorted(wrong):
            print(f"wrong task: {t} at {f:+.0f} Hz from the centre",
                  file=sys.stderr)
        checks["wrong_tasks"] = (len(wrong), limits["wrong_tasks"])
        # telemetry against the truth, sonde by sonde
        k0, k1 = blocks[0]["k"], blocks[-1]["k"] + 1
        t_disp = {b["k"]: b["t_disp"] for b in blocks}
        T, fs = self.traffic.block, self.traffic.fs
        ends, due = {}, {s.id: {} for s in self.traffic.sondes}
        for s, i, *_, blk, a, e in self.traffic.frames_ending_in(k0, k1):
            ends[(s.id, i)] = blk
            if ref.decodable(a, e, blk * T, T, fs, s.rs):
                due[s.id][i] = (a - blk * T, e - blk * T)
        got, wrong_frames, lat = set(), 0, []
        for b in blocks:
            for t in b["telem"]:
                hit = ref.judge_telemetry(self.traffic, t)
                if hit is None:
                    wrong_frames += 1
                    continue
                key = (hit[0].id, hit[1])
                if key in got or key not in ends:
                    continue
                got.add(key)
                lat.append((b["t_ret"] - t_disp[ends[key]]) * 1e3)
        checks["wrong_frames"] = (wrong_frames, limits["wrong_frames"])
        worst, attempted, failed = 0.0, 0, wrong_frames
        for sid, frames_due in due.items():
            missed = [i for i in frames_due if (sid, i) not in got]
            attempted += len(frames_due)
            failed += len(missed)
            pct = 100.0 * len(missed) / max(len(frames_due), 1)
            worst = max(worst, pct)
            where = " ".join(f"{frames_due[i][0] / fs:.3f}-"
                             f"{frames_due[i][1] / fs:.3f}"
                             for i in missed[:4])
            print(f"sonde {sid}: missed {len(missed)} of {len(frames_due)}"
                  f" due ({pct:.2f}%){' at ' + where if where else ''}",
                  file=sys.stderr)
        checks["missed_pct"] = (worst, limits["missed_pct"])
        self.lat = lat
        return checks, attempted, failed

    def end_to_end(self, blocks):
        vals = {
            "setup_s": self.setup_s,
            "realtime_x": len(blocks) * self.block_s / self.window_s,
            "block_ms_p95": percentile(
                [(b["t_ret"] - b["t_disp"]) * 1e3 for b in blocks], 95),
            "telemetry_ms_p95": percentile(self.lat, 95) if self.lat
            else None,
        }
        return vals

    def per_layer(self, blocks):
        from stationbench.trace import Trace
        tr = None
        if self.prof is not None and self.cuda:
            tr = Trace.from_profiler(self.prof)
        self.trace_obj = tr
        out = {}
        for m in self.cell.per_layer:
            reader = importlib.import_module(f"stationbench.metrics.{m['name']}")
            v = reader.read(self, blocks, tr)
            if v is not None:
                out[m["name"]] = v
        return out


def device_info(torch, run, chips: int) -> dict:
    if run.cuda:
        info = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                "count": chips, "memory_peak_bytes": int(run.memory_peak)}
    else:
        info = {"platform": "cpu", "kind": "cpu", "count": 1,
                "memory_peak_bytes": 0}
    return info


def forbidden_loaded() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)} &
                  set(FORBIDDEN))


def main(argv=None, device=None, root=None) -> int:
    """Runs the cell; ``device`` None means the card (a test passes
    ``"cpu"`` and a ``root`` holding its own ``BENCHMARK.json``).  Every
    process that the run started has ended before the result is
    printed, on every path out."""
    t_start = process_start()
    before = child_pids(os.getpid())
    had_tracker = tracker_pid() is not None
    try:
        rc, out = run_cell(argv, device, root, t_start)
    finally:
        gc.collect()                # the pool's queues, before the tracker
        stop_children(before, had_tracker)
    if out is not None:
        for k, c in out["checks"].items():
            print(f"check {k} {c['value']!r} limit {c['limit']!r}",
                  file=sys.stderr)
        print(json.dumps(out))
    return rc


def run_cell(argv, device, root, t_start):
    """One run: (exit code, the result line's object or None)."""
    args = parse_args(argv)
    root = Path.cwd() if root is None else Path(root)
    cell = Cell(root, args.workload)
    build = root / "build"
    os.environ.setdefault("TRITON_CACHE_DIR", str(build / "triton"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR",
                          str(build / "torch_extensions"))
    import torch
    if device is None:
        if not torch.cuda.is_available() or \
                torch.cuda.device_count() < cell.chips:
            print(f"stationbench: the cell needs {cell.chips} CUDA "
                  f"device(s); found "
                  f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
                  file=sys.stderr)
            return EXIT_NO_DEVICE, None
        device = torch.device("cuda")
        from radiosonde_auto_rx_tpu_torch import kernels
        kernels.library()
    run = Run(cell, args.seed, args.seconds, bool(args.trace), device,
              t_start)
    blocks = run.drive()
    bad = forbidden_loaded()
    if bad:
        print(f"stationbench: loaded after the window: {', '.join(bad)}",
              file=sys.stderr)
        return EXIT_FORBIDDEN, None
    checks, attempted, failed = run.check(blocks)
    e2e = run.end_to_end(blocks)
    units = {m["name"]: m["unit"] for m in cell.end_to_end + cell.per_layer}
    if args.trace:
        vals = run.per_layer(blocks)
    else:
        vals = {m["name"]: e2e.get(m["name"]) for m in cell.end_to_end}
    metrics = {k: {"value": v, "unit": units[k]} for k, v in vals.items()
               if v is not None}
    correct = all(math.isfinite(v) and v <= lim
                  for v, lim in checks.values())
    out = {"correct": correct, "attempted": attempted, "failed": failed,
           "metrics": metrics, "device": device_info(torch, run, cell.chips)}
    if args.trace and run.trace_obj is not None:
        out["device"]["busy_s"] = run.trace_obj.busy_s
        out["device"]["window_s"] = run.trace_obj.window_s
        out["breakdown"] = run.trace_obj.breakdown()
    # a number that could not be read (no rows kept) is null, not NaN
    out["checks"] = {k: {"value": v if math.isfinite(v) else None,
                         "limit": lim} for k, (v, lim) in checks.items()}
    return 0, out


if __name__ == "__main__":
    sys.exit(main())

"""The port runs without JAX and without the JAX package.

A subprocess whose meta-path hook refuses every ``jax``/``jaxlib``
import and the top-level package ``radiosonde_auto_rx_tpu`` (exactly:
``radiosonde_auto_rx_tpu_torch`` stays importable) loads the port and
drives its station on the CPU at 8 channels (384 kHz) over the smoke
script's three sondes (RS41 on grid, RS41 +10 kHz off grid, DFM), as
four 1 s blocks and as two 2 s blocks, exactly as ``chip_smoke.py``
drives them on the card: once with the sondes as manual tasks, once
with no task, so that the station finds them by itself; then with no
task as two 2 s blocks on a (ch, t) = (2, 1) virtual mesh, where the
RS41s and the DFM are routed to their experts' shards
(``route_demod``).  A second child
drives the remaining paths on phase 8's sondes (an iMet-4, a WXR301
off grid, two RS41s in one channel; ``wideband_sondes`` on) as two 2 s
blocks, with and without manual tasks.  A third drives phase 9's paths
at a small geometry: the sequential route (``use_mesh: false``, 16
channels at 768 kHz) over the three sondes and six carriers, where the
detector's prescreen runs on the nine candidates, and one 2 s L-band
block at 960 kHz (four 240 kHz channels) with an RS92-NGP.  A fourth
runs the quality tools: PER points of the harness (the AFSK and 601/600
resample preps, an off-grid extraction) and ``profile_station`` at a
small geometry under ``utils.probe.trace``.  They check the telemetry, the
detections, that every frame decoder of the port's registry imported,
and that no blocked module was loaded.  Two more children run the
command lines, ``python -m radiosonde_auto_rx_tpu_torch --device cpu``
replaying a cs16 capture in scan mode (it finds and logs the RS41, its
frames decoded by spawned pool workers) and the demod CLI, with
``PYTHONPATH`` shadowing ``jax`` and ``radiosonde_auto_rx_tpu`` by
packages that raise on import, so that the pool's workers, which inherit
the environment, are blocked too.  Another
child runs the two drivers: the bench's JSON line on the CPU at a small
geometry and the entry step (``graft_entry.entry``).  Another runs
``chip_smoke.py --mesh-worker`` (it imports its modes' modules and
refuses: no GPU here) and builds phase 15's host inputs.  A static
check keeps ``import jax`` and imports of the JAX package out of the
port's files and the smoke script.
"""

import json
import re
import subprocess
import sys
from pathlib import Path

import torch

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parent.parent

BLOCKER = r"""
import json, sys
sys.path.insert(0, sys.argv[1])


BLOCKED = ("jax", "jaxlib", "radiosonde_auto_rx_tpu")


class _NoJax:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError(f"{name} is blocked in this process")
        return None


sys.meta_path.insert(0, _NoJax())
import torch
torch.set_num_threads(1)
import chip_smoke as cs
"""

CHILD = BLOCKER + r"""
from radiosonde_auto_rx_tpu_torch.models import available_models

n, fs = 8, 384_000
stream = cs.synth_stream(n, fs, 4)
runs = [cs.split_blocks(stream, fs, 1), cs.split_blocks(stream, fs, 2)]
out = dict(models=sorted(available_models()))
for manual in (True, False):
    results, launches = cs.drive_station(torch.device("cpu"), runs, n, fs,
                                         manual=manual)
    out[str(manual)] = dict(
        seen=[cs.check_telemetry(results[0][1], n, fs, ("RS41",)),
              cs.check_telemetry(results[1][1], n, fs, ("RS41", "DFM"))],
        launches=launches,
        fused=[st.stats.get("fused_channels", 0) for st, _, _ in results],
        detections=[st.stats["detections"] for st, _, _ in results],
        tasks=[sorted(v["type"] for v in st.active.values())
               for st, _, _ in results])
from radiosonde_auto_rx_tpu_torch.parallel.mesh import make_mesh
from radiosonde_auto_rx_tpu_torch.parallel.station_step import StationStep
routed = []
route = StationStep.route_demod
StationStep.route_demod = lambda self, *a: (routed.append(1),
                                            route(self, *a))[1]
cpu = torch.device("cpu")
(res,), _ = cs.drive_station(cpu, [runs[1]], n, fs, manual=False,
                             mesh=make_mesh(2, 1, devices=[cpu] * 2))
out["mesh"] = dict(seen=cs.check_telemetry(res[1], n, fs, ("RS41", "DFM")),
                   routed=len(routed), detections=res[0].stats["detections"],
                   tasks=sorted(v["type"] for v in res[0].active.values()))
out["blocked"] = sorted(m for m in sys.modules
                        if m.split(".")[0] in BLOCKED)
print(json.dumps(out))
"""


PATHS_CHILD = BLOCKER + r"""
n, fs = 8, 384_000
sondes = cs.path_sondes_for(n, fs)
stream = cs.synth_stream(n, fs, 4, seed=23, sondes=cs.path_sondes_for)
runs = [cs.split_blocks(stream, fs, 2)]
out = {}
for manual in (True, False):
    results, launches = cs.drive_station(
        torch.device("cpu"), runs, n, fs, manual, cs.path_sondes_for,
        wideband_sondes=True)
    st, telems, per_block = results[0]
    cs.check_detections(per_block, [(t, cs.CENTER + f)
                                    for t, _, f, _, _ in sondes])
    out[str(manual)] = dict(
        seen=cs.check_telemetry(telems, n, fs, [t for t, *_ in sondes],
                                cs.path_sondes_for),
        launches=launches, detections=st.stats["detections"],
        tasks=sorted(v["type"] for v in st.active.values()))
out["blocked"] = sorted(m for m in sys.modules
                        if m.split(".")[0] in BLOCKED)
print(json.dumps(out))
"""


SEQ_CHILD = BLOCKER + r"""
n, fs = 16, 768_000
stream = cs.synth_stream(n, fs, 4, carriers=cs.carriers_for)
screens = []
results, launches = cs.drive_station(
    torch.device("cpu"), [cs.split_blocks(stream, fs, 2)], n, fs, False,
    setup=cs.record_prescreen(screens), use_mesh=False)
st, telems, per_block = results[0]
cs.check_detections(per_block, [(t, cs.CENTER + f)
                                for t, _, f, _, _ in cs.sondes_for(n, fs)])
out = dict(seen=cs.check_telemetry(telems, n, fs, ("RS41", "DFM")),
           launches=launches, detections=st.stats["detections"],
           screened=[[float(v) for v in r] for _, r in screens])
lb, f_off = cs.lband_stream(960_000, 4, 2)
st = cs.lband_station(torch.device("cpu"), 960_000, 4)
telems = st.process_captures([lb], [cs.LBAND])
cs.check_lband(telems, cs.tasks_of(st), f_off)
out["lband"] = [cs._lkey(t) for t in telems]
out["blocked"] = sorted(m for m in sys.modules
                        if m.split(".")[0] in BLOCKED)
print(json.dumps(out))
"""


TOOLS_CHILD = BLOCKER + r"""
import tempfile
from radiosonde_auto_rx_tpu_torch.tools import per_harness, profile_station
from radiosonde_auto_rx_tpu_torch.utils import probe

cpu = torch.device("cpu")
out = dict(points=[per_harness.run_point(t, e, 4, device=cpu, f_off=f)[0]
                   for t, e, f in (("RS41", 14.0, 0.0), ("IMET4", 26.0, 0.0),
                                   ("MK2LMS", 16.0, 0.0),
                                   ("DFM", 14.0, 20e3))])
for k, v in dict(B=1, T_WIDE=480_000, CAP=2, REPS=1, TRIALS=1).items():
    setattr(profile_station, k, v)
with tempfile.TemporaryDirectory() as d:
    with probe.trace(d):
        stages = profile_station.profile(cpu)
    import os
    out["trace"] = os.listdir(d)
out["stages"] = {k: v["device"] for k, v in stages.items()}
out["blocked"] = sorted(m for m in sys.modules
                        if m.split(".")[0] in BLOCKED)
print(json.dumps(out))
"""


# the four switches at the reference's TPU choices; two are read when
# the correlator is imported, so they are set before anything imports it
FORMS = dict(RSX_CHANNELIZER_DTYPE="bfloat16", RSX_DETECT_DTYPE="bfloat16",
             RSX_DETECT_CORR="toeplitz", RSX_DETECT_PEAKS="blocknorm")

FORMS_CHILD = f"import os\nos.environ.update({FORMS!r})\n" + BLOCKER + r"""
from radiosonde_auto_rx_tpu_torch.detect import correlator
from radiosonde_auto_rx_tpu_torch.detect.scanner import stream_dtype
from radiosonde_auto_rx_tpu_torch.ops.channelizer import _branch_dtype
from radiosonde_auto_rx_tpu_torch.parallel.station_step import StationStep

planes = []
analyze = StationStep.analyze
StationStep.analyze = lambda self, *a, **k: (
    lambda r: (planes.append(str(r[0].dtype)), r)[1])(analyze(self, *a, **k))
n, fs = 8, 384_000
stream = cs.synth_stream(n, fs, 4)
results, launches = cs.drive_station(
    torch.device("cpu"), [cs.split_blocks(stream, fs, 2)], n, fs,
    manual=False)
st, telems, _ = results[0]
out = dict(seen=cs.check_telemetry(telems, n, fs, ("RS41", "DFM")),
           detections=st.stats["detections"],
           forms=[correlator._corr_method(), correlator._peaks_method(),
                  str(stream_dtype()), str(_branch_dtype())],
           planes=sorted(set(planes)))
out["blocked"] = sorted(m for m in sys.modules
                        if m.split(".")[0] in BLOCKED)
print(json.dumps(out))
"""


BENCH_CHILD = BLOCKER + r"""
import contextlib, io
from radiosonde_auto_rx_tpu_torch import bench, graft_entry

geo = bench.Geometry(8, 12_000, 1, 455_000, 455_000, 3, 1, 1,
                     (16, 12_000, 1))
buf = io.StringIO()
with contextlib.redirect_stdout(buf):
    rc = bench.main(["--device", "cpu"], geometry=geo)
fn, args = graft_entry.entry(torch.device("cpu"))
soft, bits = fn(*args)
out = dict(rc=rc, line=json.loads(buf.getvalue()),
           entry=[list(soft.shape), list(bits.shape)])
out["blocked"] = sorted(m for m in sys.modules
                        if m.split(".")[0] in BLOCKED)
print(json.dumps(out))
"""


MESH_CHILD = BLOCKER + r"""
import contextlib, io
import numpy as np
work = sys.argv[2]
err = io.StringIO()
with contextlib.redirect_stderr(err):
    rc = cs.cli(["--mesh-worker", work, "file://" + work + "/store", "2",
                 "0", "fixture,production,headline,pp"])
np.save(work + "/fixture.npy", cs.fixture_captures())
exp, slots = cs.production_plan(cs.PROD_B)
out = dict(rc=rc, err=err.getvalue(), actives=int((exp >= 0).sum()),
           experts=sorted({int(e) for e in exp[exp >= 0]}),
           slots=len(set(slots.tolist())), microbatches=cs.pp_input()[1],
           worker_modules=sorted(m for m in sys.modules if m.startswith(
               "radiosonde_auto_rx_tpu_torch.parallel.")))
out["blocked"] = sorted(m for m in sys.modules
                        if m.split(".")[0] in BLOCKED)
print(json.dumps(out))
"""


def _child(code, *args):
    res = subprocess.run([sys.executable, "-c", code, str(ROOT), *args],
                         capture_output=True, text=True, timeout=300,
                         cwd=ROOT)
    assert res.returncode == 0, res.stderr[-4000:]
    return json.loads(res.stdout.strip().splitlines()[-1])


def test_slice_runs_without_jax():
    out = _child(CHILD)
    assert out["blocked"] == []
    for manual in ("True", "False"):
        run = out[manual]
        one_s, two_s = run["seen"]
        assert one_s["T1357911"] > 0 and one_s["P2468024"] > 0
        assert all(v > 0 for v in two_s.values())
        assert all(f > 0 for f in run["fused"])
        # CPU tensors take the plain twins: no kernel launches
        assert run["launches"] == {"freq_est_sf": 0, "fft_abs2": 0,
                                   "fft": 0, "fsk_scan": 0,
                                   "fsk_scan_unbuffered": 0}
    # the task-less station found the three sondes itself
    assert out["False"]["detections"] == [3, 3]
    assert out["True"]["detections"] == [0, 0]
    assert out["False"]["tasks"] == [["DFM", "RS41", "RS41"]] * 2
    # the (2, 1) mesh: found, routed once a block, decoded
    mesh = out["mesh"]
    assert mesh["detections"] == 3 and mesh["routed"] == 2
    assert mesh["tasks"] == ["DFM", "RS41", "RS41"]
    assert all(v > 0 for v in mesh["seen"].values())
    assert {"RS41", "RS92", "DFM", "M10", "M20", "LMS6", "IMET5",
            "MEISEI", "MRZ", "MTS01", "DROPSONDE"} <= set(out["models"])


def test_remaining_paths_run_without_jax():
    out = _child(PATHS_CHILD)
    assert out["blocked"] == []
    for manual in ("True", "False"):
        run = out[manual]
        assert len(run["seen"]) == 4 and all(
            v > 0 for v in run["seen"].values())
        assert run["tasks"] == ["IMET4", "RS41", "RS41", "WXR301"]
        assert run["launches"] == {"freq_est_sf": 0, "fft_abs2": 0,
                                   "fft": 0, "fsk_scan": 0,
                                   "fsk_scan_unbuffered": 0}
    assert out["True"]["detections"] == 0
    assert out["False"]["detections"] >= 4


def test_sequential_and_lband_run_without_jax():
    from radiosonde_auto_rx_tpu_torch.detect.prescreen import MARGIN
    out = _child(SEQ_CHILD)
    assert out["blocked"] == []
    assert len(out["seen"]) == 3 and all(v > 0 for v in out["seen"].values())
    assert out["detections"] == 3
    assert out["launches"] == {"freq_est_sf": 0, "fft_abs2": 0, "fft": 0,
                               "fsk_scan": 0, "fsk_scan_unbuffered": 0}
    # the prescreen ran once, on the first block's nine candidates, and
    # kept the three sondes
    assert [len(r) for r in out["screened"]] == [9]
    assert sum(v >= MARGIN for v in out["screened"][0]) == 3
    assert out["lband"] and {t[1] for t in out["lband"]} == {"R1234567"}


def test_tools_run_without_jax():
    out = _child(TOOLS_CHILD)
    assert out["blocked"] == []
    assert [(r["type"], r["chain"], r["f_off"]) for r in out["points"]] == [
        ("RS41", "torch", 0.0), ("IMET4", "torch", 0.0),
        ("MK2LMS", "torch", 0.0), ("DFM", "torch", 20e3)]
    assert all(r["frames_rx"] >= 3 for r in out["points"]), out["points"]
    assert len(out["stages"]) == 5 and \
        set(out["stages"].values()) == {"cpu"}
    assert out["trace"] == ["trace.json"]


def test_tpu_forms_run_without_jax():
    """The station under the four switches at the reference's TPU
    choices (bf16 branches and streams, Toeplitz correlation,
    block-normalized peaks), with no task: it finds and decodes the
    three sondes."""
    out = _child(FORMS_CHILD)
    assert out["blocked"] == []
    assert out["forms"] == ["toeplitz", "blocknorm", "torch.bfloat16",
                            "torch.bfloat16"]
    assert out["planes"] == ["torch.bfloat16"]
    assert out["detections"] == 3
    assert len(out["seen"]) == 3 and all(v > 0 for v in out["seen"].values())


def test_bench_and_entry_run_without_jax():
    """``bench.main(["--device", "cpu"])`` at a small geometry prints its
    JSON line, and ``graft_entry.entry()`` runs its step."""
    from test_torch_bench import SMALL, check_line
    out = _child(BENCH_CHILD)
    assert out["blocked"] == []
    assert out["rc"] == 0
    check_line(out["line"], SMALL)
    assert out["entry"] == [[94, 8, 50], [94, 8, 50]]


def _shadowed(tmp_path):
    """An environment whose PYTHONPATH puts packages named ``jax``,
    ``jaxlib`` and ``radiosonde_auto_rx_tpu`` that raise on import ahead
    of everything but the working directory (run from ``tmp_path``,
    which holds nothing else)."""
    import os
    shadow = tmp_path / "shadow"
    for name in ("jax", "jaxlib", "radiosonde_auto_rx_tpu"):
        (shadow / name).mkdir(parents=True)
        (shadow / name / "__init__.py").write_text(
            f"raise ImportError('{name} is blocked in this process')\n")
    env = dict(os.environ, PYTHONPATH=f"{shadow}{os.pathsep}{ROOT}",
               OMP_NUM_THREADS="1")
    return env


def test_station_cli_runs_without_jax(tmp_path):
    from test_torch_cli import SCAN_CH, SCAN_FS, rs41_capture
    run = tmp_path / "run"
    run.mkdir()
    env = _shadowed(tmp_path)
    cap = run / "cap.cs16"
    rs41_capture(cap, SCAN_FS, SCAN_CH * 48000, n_frames=6, seed=5)
    cfg = run / "station.cfg"
    cfg.write_text(f"[sdr]\ncapture_rate = {SCAN_FS}\nnum_channels = 8\n"
                   "[filtering]\nsonde_time_threshold = 1000000\n")
    res = subprocess.run(
        [sys.executable, "-m", "radiosonde_auto_rx_tpu_torch", "--device",
         "cpu", "-c", str(cfg), "--replay", str(cap), "--no-web",
         "--log-dir", str(run / "log")],
        capture_output=True, text=True, timeout=300, cwd=run, env=env)
    assert res.returncode == 0, res.stderr[-4000:]
    assert "decoder workers started" in res.stderr
    logs = list((run / "log").glob("*_C2468101_RS41_*_sonde.log"))
    assert len(logs) == 1
    assert len(logs[0].read_text().splitlines()) > 3
    # the blocked packages really are blocked in that environment
    probe = subprocess.run([sys.executable, "-c", "import jax"], cwd=run,
                           env=env, capture_output=True, text=True)
    assert probe.returncode != 0 and "blocked" in probe.stderr


def test_demod_cli_runs_without_jax(tmp_path):
    import numpy as np
    from radiosonde_auto_rx_tpu_torch.demod.cli import test_frame_bits
    from radiosonde_auto_rx_tpu_torch.demod.modulate import (add_awgn,
                                                             gfsk_mod)
    run = tmp_path / "run"
    run.mkdir()
    tx = np.tile(test_frame_bits(), 30)
    iq = add_awgn(gfsk_mod(tx, 48000, 4800, 2, 0.0, 5000), 14.0, 48000,
                  4800, rng=np.random.default_rng(2))
    w = np.empty(2 * len(iq), np.int16)
    w[0::2] = np.clip(iq.real * 16384, -32767, 32767)
    w[1::2] = np.clip(iq.imag * 16384, -32767, 32767)
    (run / "in.cs16").write_bytes(w.tobytes())
    res = subprocess.run(
        [sys.executable, "-m", "radiosonde_auto_rx_tpu_torch.demod.cli",
         "--device", "cpu", "-p", "5", "-b", "-5000", "-u", "5000",
         "--mask", "5000", "--testframes", "2", "48000", "4800", "in.cs16",
         "out.f32"], capture_output=True, text=True, timeout=300, cwd=run,
        env=_shadowed(tmp_path))
    assert res.returncode == 0, res.stderr[-4000:]
    lines = [ln for ln in res.stderr.splitlines() if "FSK BER" in ln]
    assert len(lines) >= 15
    assert float(lines[-1].split("FSK BER")[1].split(",")[0]) < 0.01
    assert (run / "out.f32").stat().st_size > 4 * 0.9 * len(tx)


def test_mesh_worker_runs_without_jax(tmp_path):
    """``chip_smoke.py --mesh-worker`` (phase 15's process of an NCCL
    group) with ``jax`` and the JAX package blocked: it imports the
    modules of its modes, and on a host with fewer GPUs than processes
    (none here) exits 1 naming the GPU count before joining any group.
    Its host inputs build there too: ``fixture_captures`` equals
    ``tests/station_fixture.py``'s captures, the production plan holds
    ``bench.ACTIVES``' 10 actives of 5 types and 20 slots."""
    import numpy as np
    import station_fixture as fx
    import chip_smoke as cs
    out = _child(MESH_CHILD, str(tmp_path))
    assert out["blocked"] == []
    assert out["rc"] == 1
    assert "needs 2 GPUs" in out["err"] and "found 0" in out["err"]
    assert {"radiosonde_auto_rx_tpu_torch.parallel.multihost",
            "radiosonde_auto_rx_tpu_torch.parallel.pp",
            "radiosonde_auto_rx_tpu_torch.parallel.station_step"} <= set(
                out["worker_modules"])
    assert list(tmp_path.iterdir()) == [tmp_path / "fixture.npy"]
    np.testing.assert_array_equal(np.load(tmp_path / "fixture.npy"),
                                  fx.make_wide_captures(cs.FX_TS))
    assert out["actives"] == 10 and len(out["experts"]) == 5
    assert out["slots"] == 20 and out["microbatches"] > 3


def test_no_jax_import_in_port_sources():
    pat = re.compile(r"^\s*(import\s+jax|from\s+jax|"
                     r"(from|import)\s+radiosonde_auto_rx_tpu\b)", re.M)
    files = sorted((ROOT / "radiosonde_auto_rx_tpu_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 10
    bad = [str(f) for f in files if pat.search(f.read_text())]
    assert bad == []


def test_dcn_probe_runs_without_jax(tmp_path):
    """``python -m radiosonde_auto_rx_tpu_torch.tools.dcn_probe --device
    cpu`` with ``jax`` and the JAX package shadowed (its two spawned workers
    inherit the path): two gloo processes, the reference's keys."""
    run = tmp_path / "run"
    run.mkdir()
    res = subprocess.run(
        [sys.executable, "-m", "radiosonde_auto_rx_tpu_torch.tools.dcn_probe",
         "--device", "cpu", "-o", "fit.json"], capture_output=True,
        text=True, timeout=300, cwd=run, env=_shadowed(tmp_path))
    assert res.returncode == 0, res.stderr[-4000:]
    out = json.loads((run / "fit.json").read_text())
    assert set(out) == {"transport", "ppermute", "all_to_all",
                        "psum_scalar_s"}
    assert "gloo" in out["transport"] and out["psum_scalar_s"] > 0
    for k in ("ppermute", "all_to_all"):
        assert set(out[k]["points"]) == {"65536", "1048576", "8388608"}

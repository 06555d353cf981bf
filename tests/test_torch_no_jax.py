"""The port runs without JAX and without the JAX package.

A subprocess whose meta-path hook refuses every ``jax``/``jaxlib``
import and the top-level package ``radiosonde_auto_rx_tpu`` (exactly:
``radiosonde_auto_rx_tpu_torch`` stays importable) loads the port and
drives its station on the CPU at 8 channels (384 kHz) over the smoke
script's three sondes (RS41 on grid, RS41 +10 kHz off grid, DFM), as
four 1 s blocks and as two 2 s blocks, exactly as ``chip_smoke.py``
drives them on the card: once with the sondes as manual tasks, once
with no task, so that the station finds them by itself.  A second child
drives the remaining paths on phase 8's sondes (an iMet-4, a WXR301
off grid, two RS41s in one channel; ``wideband_sondes`` on) as two 2 s
blocks, with and without manual tasks.  A third drives phase 9's paths
at a small geometry: the sequential route (``use_mesh: false``, 16
channels at 768 kHz) over the three sondes and six carriers, where the
detector's prescreen runs on the nine candidates, and one 2 s L-band
block at 960 kHz (four 240 kHz channels) with an RS92-NGP.  They check the telemetry, the
detections, that every frame decoder of the port's registry imported,
and that no blocked module was loaded.  A static
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


def _child(code):
    res = subprocess.run([sys.executable, "-c", code, str(ROOT)],
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
                                   "fft": 0, "fsk_scan": 0}
    # the task-less station found the three sondes itself
    assert out["False"]["detections"] == [3, 3]
    assert out["True"]["detections"] == [0, 0]
    assert out["False"]["tasks"] == [["DFM", "RS41", "RS41"]] * 2
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
                                   "fft": 0, "fsk_scan": 0}
    assert out["True"]["detections"] == 0
    assert out["False"]["detections"] >= 4


def test_sequential_and_lband_run_without_jax():
    from radiosonde_auto_rx_tpu_torch.detect.prescreen import MARGIN
    out = _child(SEQ_CHILD)
    assert out["blocked"] == []
    assert len(out["seen"]) == 3 and all(v > 0 for v in out["seen"].values())
    assert out["detections"] == 3
    assert out["launches"] == {"freq_est_sf": 0, "fft_abs2": 0, "fft": 0,
                               "fsk_scan": 0}
    # the prescreen ran once, on the first block's nine candidates, and
    # kept the three sondes
    assert [len(r) for r in out["screened"]] == [9]
    assert sum(v >= MARGIN for v in out["screened"][0]) == 3
    assert out["lband"] and {t[1] for t in out["lband"]} == {"R1234567"}


def test_no_jax_import_in_port_sources():
    pat = re.compile(r"^\s*(import\s+jax|from\s+jax|"
                     r"(from|import)\s+radiosonde_auto_rx_tpu\b)", re.M)
    files = sorted((ROOT / "radiosonde_auto_rx_tpu_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 10
    bad = [str(f) for f in files if pat.search(f.read_text())]
    assert bad == []

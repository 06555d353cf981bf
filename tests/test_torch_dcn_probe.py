"""The collective cost probe: the port's ``tools/dcn_probe.py`` against
the JAX package's.

* ``fit_alpha_beta`` on the same points gives the reference's fit
  (alpha, beta to rtol 1e-12: the same float64 least squares).
* One real two-process probe (``--device cpu``: two gloo processes over
  loopback, two CPU shards each) at the smallest message size, 3
  repetitions: every collective timed, the report under the reference's
  keys.
* ``main`` prints the report and writes a file only when given ``-o``.
* ``--device`` defaults to ``cuda`` (NCCL, one GPU a process): on a host
  with fewer than two GPUs ``main`` exits 1 with the reason and
  ``run_probe`` raises; a test that needs the two GPUs is marked.
"""

import json

import numpy as np
import pytest
import torch

from radiosonde_auto_rx_tpu.tools import dcn_probe as ref_probe
from radiosonde_auto_rx_tpu_torch.tools import dcn_probe

POINTS = {"ppermute_65536": 4.4e-4, "ppermute_1048576": 5.6e-3,
          "ppermute_8388608": 4.8e-2, "all_to_all_65536": 3.5e-4,
          "all_to_all_1048576": 1.9e-3, "all_to_all_8388608": 1.5e-2,
          "psum_scalar": 3.7e-4}
REF_KEYS = {"transport", "ppermute", "all_to_all", "psum_scalar_s"}


@pytest.mark.parametrize("prefix", ["ppermute_", "all_to_all_"])
def test_fit_alpha_beta_matches_reference(prefix):
    got = dcn_probe.fit_alpha_beta(POINTS, prefix)
    want = ref_probe.fit_alpha_beta(POINTS, prefix)
    assert got["points"] == want["points"]
    for k in ("alpha_s", "beta_s_per_byte"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-12)


def test_probe_two_processes_smallest_size():
    res = dcn_probe.run_probe((65536,), reps=3, timeout=300, device="cpu")
    assert set(res) == {"ppermute_65536", "all_to_all_65536",
                        "psum_scalar"}
    assert all(0 < v < 10 for v in res.values()), res
    out = dcn_probe.report(res, "cpu")
    assert set(out) == REF_KEYS
    assert "gloo" in out["transport"]
    assert out["ppermute"]["points"] == {"65536": res["ppermute_65536"]}


def test_main_writes_only_with_output(monkeypatch, tmp_path, capsys):
    asked = []
    monkeypatch.setattr(dcn_probe, "run_probe",
                        lambda device: asked.append(device) or dict(POINTS))
    monkeypatch.chdir(tmp_path)
    assert dcn_probe.main(["--device", "cpu"]) == 0
    printed = json.loads(capsys.readouterr().out)
    assert set(printed) == REF_KEYS
    assert "gloo" in printed["transport"]
    assert list(tmp_path.iterdir()) == []
    path = tmp_path / "fit.json"
    assert dcn_probe.main(["--device", "cpu", "-o", str(path)]) == 0
    assert asked == ["cpu", "cpu"]
    assert json.loads(path.read_text()) == printed
    assert json.loads(capsys.readouterr().out) == printed


@pytest.mark.skipif(torch.cuda.device_count() >= 2,
                    reason="this host has the two GPUs the NCCL probe needs")
def test_default_device_is_cuda_and_needs_two_gpus(monkeypatch, tmp_path,
                                                   capsys):
    """Without ``--device`` the probe asks for the GPUs: on a host with
    fewer than two it runs no worker, prints why and exits 1."""
    monkeypatch.setattr(dcn_probe, "run_probe", lambda **kw: pytest.fail(
        "spawned workers without the GPUs"))
    monkeypatch.chdir(tmp_path)
    assert dcn_probe.main([]) == 1
    captured = capsys.readouterr()
    assert captured.out == ""
    assert "needs 2 GPUs" in captured.err and "--device cpu" in captured.err
    assert list(tmp_path.iterdir()) == []
    monkeypatch.undo()
    with pytest.raises(RuntimeError, match="needs 2 GPUs"):
        dcn_probe.run_probe((65536,), reps=1)


@pytest.mark.cuda
@pytest.mark.skipif(torch.cuda.device_count() < 2,
                    reason="the NCCL probe needs two GPUs on one host")
def test_probe_nccl_two_gpus_smallest_size():
    """The default device: two NCCL processes, one GPU each."""
    res = dcn_probe.run_probe((65536,), reps=3, timeout=300)
    assert all(0 < v < 10 for v in res.values()), res
    assert "nccl" in dcn_probe.report(res)["transport"]

"""The port's PER harness against the JAX package's, on the CPU.

For each of the 16 sonde types, with ``_gps_now_plus`` pinned to one
value in both modules (the port's ``per_harness.pinned_gps_now_plus``,
which the card's PER gate uses too: the RS41, M10 and M20 cases write
the wall clock's GPS time into their frames, so two runs a second apart
would make different frames):

- the transmitted bits and the noisy IQ of ``_make_iq`` equal the JAX
  harness's bit for bit (NumPy with ``default_rng(seed)`` on both sides,
  the port's modulator and encoders being copies);
- at 3 frames, at the type's PER-gate point plus 2 dB (the gate point as
  ``tests/test_per_gate.py`` picks it from ``docs/per_r5.csv``), the
  port's ``run_point`` on the CPU receives the same frames as the JAX
  ``run_point``: the same set of frame identities, not only the count.

Then the cliff-sanity cases of ``tests/test_per_harness.py`` on the
port's chain (clean well above the cliff, dead in deep noise) and the
CSV command line with the ``torch`` chain label.
"""

import numpy as np
import pytest
import torch

from radiosonde_auto_rx_tpu.tools import per_harness as ref_ph
from radiosonde_auto_rx_tpu_torch.tools import per_harness

from test_per_gate import ALL_ROWS, _cliff, _curve

torch.set_num_threads(1)
CPU = torch.device("cpu")
TYPES = sorted(per_harness.CASES)


@pytest.fixture
def pinned_clock(monkeypatch):
    pinned = per_harness.pinned_gps_now_plus
    monkeypatch.setattr(ref_ph, "_gps_now_plus", pinned)
    monkeypatch.setattr(per_harness, "_gps_now_plus", pinned)


def gate_ebno(sonde_type: str) -> float:
    """The Eb/N0 grid point ``tests/test_per_gate.py`` gates the type at
    (first grid point >= the recorded 50% cliff + 0.5 dB)."""
    curve = _curve(ALL_ROWS, sonde_type)
    grid = [e for e, _ in curve]
    cliff = _cliff(curve)
    if cliff is None:
        return grid[0]
    return min((e for e in grid if e >= cliff + 0.5), default=grid[-1])


def _recording(module, sonde_type, got):
    """A case factory for ``module.CASES`` that records the identities
    of the frames its decoder returns."""
    build = module.CASES[sonde_type]

    def wrapped(n_frames, rng, workdir):
        case = build(n_frames, rng, workdir)
        decode = case.decode

        def recorded(bits, soft):
            telems = decode(bits, soft)
            got.extend(t.get("frame") for t in telems)
            return telems
        case.decode = recorded
        return case
    return wrapped


@pytest.mark.parametrize("sonde_type", TYPES)
def test_iq_is_the_reference_harness_iq(sonde_type, pinned_clock):
    ebno = gate_ebno(sonde_type)
    rng_p, rng_r = np.random.default_rng(5), np.random.default_rng(5)
    case_p = per_harness.CASES[sonde_type](3, rng_p, None)
    case_r = ref_ph.CASES[sonde_type](3, rng_r, None)
    assert np.array_equal(np.asarray(case_p.tx_bits),
                          np.asarray(case_r.tx_bits))
    assert case_p.tx_ids == case_r.tx_ids
    iq_p = per_harness._make_iq(case_p, ebno, rng_p, device=CPU)
    iq_r = ref_ph._make_iq(case_r, ebno, rng_r)
    assert iq_p.dtype == iq_r.dtype and np.array_equal(iq_p, iq_r)


@pytest.mark.parametrize("sonde_type", TYPES)
def test_frames_received_as_the_reference(sonde_type, pinned_clock,
                                          monkeypatch):
    ebno = gate_ebno(sonde_type) + 2.0
    got_p, got_r = [], []
    monkeypatch.setitem(per_harness.CASES, sonde_type,
                        _recording(per_harness, sonde_type, got_p))
    monkeypatch.setitem(ref_ph.CASES, sonde_type,
                        _recording(ref_ph, sonde_type, got_r))
    row_p, = per_harness.run_point(sonde_type, ebno, n_frames=3, seed=7,
                                   device=CPU)
    row_r, = ref_ph.run_point(sonde_type, ebno, n_frames=3, seed=7)
    assert row_p["chain"] == "torch" and row_r["chain"] == "tpu"
    assert set(got_p) == set(got_r)
    for k in ("frames_tx", "frames_rx", "per", "ebno_db", "f_off"):
        assert row_p[k] == row_r[k], k
    assert row_p["frames_rx"] >= 2, row_p


def _point(sonde_type, ebno, n_frames):
    rows = per_harness.run_point(sonde_type, ebno, n_frames=n_frames,
                                 device=CPU)
    assert len(rows) == 1 and rows[0]["chain"] == "torch"
    return rows[0]


# tests/test_per_harness.py's cliff-sanity cases: (type, high Eb/N0,
# frames, frames the high point must receive, low Eb/N0)
CLIFFS = [("RS41", 12.0, 5, 4, 2.0), ("M10", 16.0, 5, 3, 2.0),
          ("LMS6", 16.0, 4, 3, 0.0), ("MRZ", 14.0, 5, 3, 2.0),
          ("IMET54", 14.0, 5, 3, 2.0), ("M20", 14.0, 4, 3, 2.0),
          ("MTS01", 16.0, 4, 3, 2.0), ("WXR301", 17.0, 4, 3, 2.0),
          ("WXRPN9", 17.0, 4, 3, 2.0), ("RD94RD41", 14.0, 4, 3, 2.0),
          ("MK2LMS", 16.0, 4, 3, 2.0), ("IMET4", 24.0, 4, 3, 2.0),
          ("RS92NGP", 16.0, 4, 3, 2.0)]


@pytest.mark.parametrize("sonde_type,hi_db,n,need,lo_db", CLIFFS,
                         ids=[c[0] for c in CLIFFS])
def test_per_cliff(sonde_type, hi_db, n, need, lo_db):
    """Clean above the cliff, dead in deep noise (exact TX/RX
    accounting holds for every type)."""
    hi = _point(sonde_type, hi_db, n)
    lo = _point(sonde_type, lo_db, n)
    assert hi["frames_rx"] >= need, hi
    assert lo["frames_rx"] == 0, lo


def test_sweep_csv_cli(tmp_path):
    out = tmp_path / "per.csv"
    rc = per_harness.main(["--type", "RS41", "--ebno", "2:12:10",
                           "--frames", "3", "-o", str(out),
                           "--device", "cpu"])
    assert rc == 0
    lines = out.read_text().strip().splitlines()
    assert lines[0] == "type,chain,ebno_db,frames_tx,frames_rx,per,runtime_s"
    assert len(lines) == 3          # header + 2 points
    assert lines[1].startswith("RS41,torch,2.0,3,0,1.000,")
    assert lines[2].startswith("RS41,torch,12.0,3,")


def test_cli_wants_a_card_unless_asked_for_the_cpu(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert per_harness.main(["--type", "RS41", "--ebno", "12:12:1",
                             "--frames", "1"]) == 1
    assert "no CUDA device" in capsys.readouterr().err


def test_cuda_device_has_no_cpu_fallback():
    """Asked for ``cuda`` where there is no card, the harness raises
    instead of running the demod's plain twin on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises((RuntimeError, AssertionError)):
        per_harness.run_point("RS41", 12.0, n_frames=1)

"""The PER cliff gate of ``tests/test_per_gate.py`` on the port's chain.

The same rule, the same recorded sweep (``docs/per_r5.csv``'s ``tpu``
rows, centered) and the same point per type: the first grid point at or
above the recorded 50% cliff + 0.5 dB (the grid floor where no cliff was
recorded), re-measured with 100 fresh frames (seed 123) through the
port's ``run_point`` on the CPU.  The port passes where

    measured_per <= max(recorded_per(point) + 0.20, 0.35),

the JAX gate's own limit.  The off-grid half of the gate is
``tests/test_torch_per_offgrid_gate.py`` (a file of its own, so that
test workers spread the two).
"""

import pytest
import torch

from radiosonde_auto_rx_tpu_torch.tools.per_harness import run_point

from test_per_gate import ALL_ROWS, TYPES, _cliff, _curve

torch.set_num_threads(1)


@pytest.mark.parametrize("sonde_type", TYPES)
def test_per_cliff_gate(sonde_type):
    curve = _curve(ALL_ROWS, sonde_type)
    grid = [e for e, _ in curve]
    cliff = _cliff(curve)
    if cliff is None:
        e_gate = grid[0]
    else:
        e_gate = min((e for e in grid if e >= cliff + 0.5),
                     default=grid[-1])
    p_rec = dict(curve)[e_gate]
    rows = run_point(sonde_type, e_gate, n_frames=100, seed=123,
                     device=torch.device("cpu"))
    p_meas = rows[0]["per"]
    limit = max(p_rec + 0.20, 0.35)
    assert p_meas <= limit, (
        f"{sonde_type}: the port's PER at {e_gate:.1f} dB measured "
        f"{p_meas:.2f} vs recorded {p_rec:.2f} (limit {limit:.2f})")

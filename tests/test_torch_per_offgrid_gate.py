"""The off-grid PER gate of ``tests/test_per_gate.py`` on the port's chain.

Every recorded ±20 kHz point of ``docs/per_r5.csv`` (the carrier
synthesized off the channel center at 4x the channel rate and pulled
back by the port's ``extract_channels``, then demodulated) re-measured
with 50 fresh frames (seed 321) through the port's ``run_point`` on the
CPU, held to the JAX gate's own limit
``max(recorded_per + 0.25, 0.45)``.
"""

import pytest
import torch

from radiosonde_auto_rx_tpu_torch.tools.per_harness import run_point

from test_per_gate import OFFGRID

torch.set_num_threads(1)


@pytest.mark.parametrize("sonde_type,f_off,e_gate,p_rec", OFFGRID,
                         ids=[f"{t}{'+' if f > 0 else '-'}20k"
                              for t, f, _, _ in OFFGRID])
def test_per_offgrid_gate(sonde_type, f_off, e_gate, p_rec):
    rows = run_point(sonde_type, e_gate, n_frames=50, seed=321,
                     f_off=f_off, device=torch.device("cpu"))
    p_meas = rows[0]["per"]
    limit = max(p_rec + 0.25, 0.45)
    assert p_meas <= limit, (
        f"{sonde_type} at {f_off/1e3:+.0f} kHz / {e_gate:.1f} dB: the "
        f"port's PER measured {p_meas:.2f} vs recorded {p_rec:.2f} "
        f"(limit {limit:.2f})")

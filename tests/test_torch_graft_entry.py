"""The port's driver entry points (``radiosonde_auto_rx_tpu_torch/
graft_entry.py``) against the root ``__graft_entry__.py`` on the CPU.

- ``entry()``: the port's step (the plain twin of the scan kernel's
  unbuffered mode on the CPU) against the JAX ``entry()`` on the same
  8 channels x 1 s: the same [n_blocks, C, nsym] layout, bits equal,
  soft within 1e-4 of its peak.
- ``dryrun_multichip(8)`` over 8 CPU shards passes its own checks (the
  channel-DP bits equal the unsharded FIR + demod, the routed RS41 and
  MEISEI bits of the DP mesh equal the one-device mesh's), runs the
  stage pipeline (8 >= 3) and prints the reference's OK line; its leg-1
  bits equal JAX's ``make_station_step`` on the JAX package's 8
  virtual CPU devices (``tests/conftest.py``).  JAX's whole dryrun is
  not run here: ``tests/test_torch_station_step_mesh.py`` holds the
  sharded station step.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

import __graft_entry__ as ref
from radiosonde_auto_rx_tpu.ops.fir import design_lowpass
from radiosonde_auto_rx_tpu.parallel.mesh import make_mesh
from radiosonde_auto_rx_tpu.parallel.pipeline import make_station_step
from radiosonde_auto_rx_tpu_torch import graft_entry

torch.set_num_threads(1)
CPU = torch.device("cpu")


def test_entry_matches_reference():
    fn, args = graft_entry.entry(CPU)
    soft, bits = (v.numpy() for v in fn(*args))
    rfn, rargs = ref.entry()
    np.testing.assert_array_equal(args[0].numpy(), np.asarray(rargs[0]))
    rsoft, rbits = (np.asarray(v) for v in jax.jit(rfn)(*rargs))
    assert soft.shape == rsoft.shape == (94, 8, 50)
    np.testing.assert_array_equal(bits, rbits.astype(np.uint8))
    np.testing.assert_allclose(soft, rsoft, rtol=0,
                               atol=1e-4 * np.abs(rsoft).max())


@pytest.fixture(scope="module")
def dryrun():
    return graft_entry.dryrun_multichip(8, [CPU] * 8)


def test_dryrun_over_8_cpu_shards(dryrun):
    assert dryrun["line"].startswith(
        "dryrun_multichip OK: mesh={'ch': 4, 't': 2} soft=(8, 800) float32 "
        "(dp-value-checked=yes, pp=yes, full-station=sharded channelize+psd"
        "+detect+route+demod, station-value-checked=yes)")
    got, want = dryrun["leg1"]
    assert got.shape == (16, 400) and torch.equal(got, want)
    psoft, pbits = dryrun["pp"]
    assert pbits.shape == psoft.shape == (4, 2, 200)
    routed = dryrun["routed"]
    for name in ("1dev", "dp", "tp"):
        assert int(routed[name]["mask"].sum()) == 2, name
    assert dryrun["steady_bits"].shape[0] == 1


def test_dryrun_leg1_matches_reference(dryrun):
    cfg = ref._rs41_cfg(nsym=50)
    mesh = make_mesh(n_ch=8, n_t=1)
    x = jax.device_put(jnp.asarray(ref._tone_iq(cfg, 16, 4096)),
                       NamedSharding(mesh, P("ch", None, "t")))
    _, bits = make_station_step(cfg, mesh,
                                if_taps=design_lowpass(0.2, 25))(x)
    np.testing.assert_array_equal(dryrun["leg1"][0].numpy(),
                                  np.asarray(bits).astype(np.uint8))

"""Expert-parallel channel routing in the port against the reference's
``parallel/routing.py``, after ``tests/test_routing.py``: the
compaction (the same slots, counts and drops, with capacity overflow and
no detection at all), the per-expert gather, and the all-to-all dispatch
on (4, 2) and (8, 1) virtual CPU meshes against the reference's on the 8
virtual XLA devices (the same received channels, masks and drops:
exact, since routing only moves samples).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from radiosonde_auto_rx_tpu.parallel import routing as ref
from radiosonde_auto_rx_tpu.parallel.mesh import make_mesh as ref_mesh
from radiosonde_auto_rx_tpu_torch.parallel.mesh import make_mesh
from radiosonde_auto_rx_tpu_torch.parallel.routing import (
    compact_by_type, gather_type_batch, route_to_experts)

torch.set_num_threads(1)
CPU = torch.device("cpu")


@pytest.mark.parametrize("ids,n_types,cap", [
    ([2, -1, 0, 2, 1, 0, -1, 2], 3, 4),      # basic
    ([1, 1, 1, 1, 1], 2, 3),                 # capacity overflow
    ([-1] * 6, 4, 2),                        # no detection
    (list(np.random.default_rng(3).integers(-1, 5, 40)), 5, 3)])
def test_compact_by_type_matches_reference(ids, n_types, cap):
    got = compact_by_type(torch.tensor(ids, dtype=torch.int32), n_types, cap)
    want = ref.compact_by_type(jnp.asarray(ids, jnp.int32), n_types, cap)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    slots, counts, dropped = (g.numpy() for g in got)
    ids = np.asarray(ids)
    for k in range(n_types):
        mine = np.flatnonzero(ids == k)
        assert slots[k][slots[k] >= 0].tolist() == mine[:cap].tolist()
        assert counts[k] == min(len(mine), cap)
        assert dropped[k] == max(len(mine) - cap, 0)


def test_gather_type_batch():
    x = np.arange(12.0, dtype=np.float32).reshape(6, 2)
    slots = np.array([4, 1, -1], np.int32)
    batch, mask = gather_type_batch(torch.from_numpy(x),
                                    torch.from_numpy(slots))
    b_r, m_r = ref.gather_type_batch(jnp.asarray(x), jnp.asarray(slots))
    np.testing.assert_array_equal(batch.numpy(), np.asarray(b_r))
    np.testing.assert_array_equal(mask.numpy(), [True, True, False])
    np.testing.assert_array_equal(mask.numpy(), np.asarray(m_r))


@pytest.mark.parametrize("n_ch,n_t", [(4, 2), (8, 1)])
def test_route_to_experts_matches_reference(n_ch, n_t):
    rng = np.random.default_rng(n_ch)
    C, F, T = 32, 2, 64
    n_exp, cap = 8, 3
    x = rng.standard_normal((C, F, T)).astype(np.float32)
    ids = rng.integers(-1, n_exp, C).astype(np.int32)
    mesh = make_mesh(n_ch, n_t, devices=[CPU] * 8)
    recv, mask, dropped = route_to_experts(mesh, torch.from_numpy(x),
                                           torch.from_numpy(ids), n_exp, cap)
    want = ref.route_to_experts(ref_mesh(n_ch=n_ch, n_t=n_t),
                                jnp.asarray(x), jnp.asarray(ids), n_exp, cap)
    assert recv.shape == (n_exp, n_ch * cap, F, T)
    for g, w in zip((recv, mask, dropped), want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    # every expert received exactly its type's channels, capacity a
    # (source shard, expert)
    c_l = C // n_ch
    for e in range(n_exp):
        got = recv[e].numpy()[mask[e].numpy()]
        want_idx = []
        for s in range(n_ch):
            mine = [c for c in range(s * c_l, (s + 1) * c_l) if ids[c] == e]
            want_idx += mine[:cap]
        np.testing.assert_array_equal(got, x[want_idx])
    assert int(dropped.sum()) == sum(
        max(0, int((ids[s * c_l:(s + 1) * c_l] == e).sum()) - cap)
        for s in range(n_ch) for e in range(n_exp))

"""The slice on two more chains: M10 (48 -> 48.08 kHz resampler, peak
estimator) and M20 (no resampler), port ``Station`` against the
reference ``Station`` on a 1-device mesh, both on the CPU.

Manual M10 and M20 tasks over two captures of
``tests/station_fixture.py::make_wide_captures`` (the M10 keyed up in
the first, the M20 in the second), with the scanner off (the web
control's "disable scanner" state): both stations must decode the same
telemetry (``_key``) and end with the same task keys.  With the scanner
on, the M10's spectral sidelobes nominate raster points 22 kHz either
side of it — beyond ``decoder_spacing_limit``, inside its own channel —
which both stations send to the collision path (detection on an
extracted row), where nothing is detected: the same telemetry, tasks
and collision calls.

The fixture's sondes sit ~54 dB above its noise, where the demod's
Eb/N0 (``mean(mx^2) - mean(mx)^2`` in float32) is cancellation noise
in both packages, and the drift follow, which picks "locked" blocks by
Eb/N0, would then compare rounding rather than policy.  The captures
get 0.03 RMS of extra seeded noise (Eb/N0 ~45 dB, well conditioned).
"""

import jax
import numpy as np
import pytest
import torch

from radiosonde_auto_rx_tpu.parallel.mesh import make_mesh
from radiosonde_auto_rx_tpu.station.station import Station as RefStation
from radiosonde_auto_rx_tpu_torch.station.station import Station

from station_fixture import (M10_CAP, M10_CH, M20_CAP, M20_CH,
                             make_wide_captures)
from test_offgrid import CENTER, FREQS, _cfg, _Col, _key

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def clean():
    wide = make_wide_captures(ts=1_755_600_000)
    return [wide[M10_CAP], wide[M20_CAP]]


@pytest.fixture(scope="module")
def caps(clean):
    rng = np.random.default_rng(3)
    return [c + (0.03 * rng.standard_normal(c.shape)).astype(np.float32)
            for c in clean]


def _run(st, caps):
    st.scan_enabled = False
    st.start_manual_decoder(CENTER + FREQS[M10_CH], "M10")
    st.start_manual_decoder(CENTER + FREQS[M20_CH], "M20")
    telems = []
    for c in caps:
        telems.extend(st.process_captures([c]))
    return telems


def test_m10_m20_match_reference(caps):
    mesh = make_mesh(n_ch=1, n_t=1, devices=jax.devices()[:1])
    ref = RefStation(_cfg(), exporters=[_Col()], center_freq_hz=CENTER,
                     mesh=mesh)
    port = Station(_cfg(), exporters=[_Col()], center_freq_hz=CENTER,
                   device="cpu")
    want = _run(ref, caps)
    got = _run(port, caps)
    assert {t["type"] for t in want} == {"M10", "M20"}
    assert sorted(map(_key, got)) == sorted(map(_key, want))
    assert set(port.active) == set(ref.active)
    assert port.stats["fused_channels"] == ref.stats["fused_channels"]


def test_m10_sidelobe_candidates_need_collision_path(clean):
    mesh = make_mesh(n_ch=1, n_t=1, devices=jax.devices()[:1])
    ref = RefStation(_cfg(), exporters=[_Col()], center_freq_hz=CENTER,
                     mesh=mesh)
    port = Station(_cfg(), exporters=[_Col()], center_freq_hz=CENTER,
                   device="cpu")
    out = []
    for st in (ref, port):
        st.start_manual_decoder(CENTER + FREQS[M10_CH], "M10")
        seen = []
        collide = st._process_collision

        def counted(prof, planes, f_abs, forced=None, collide=collide,
                    seen=seen):
            seen.append((round(f_abs), forced))
            return collide(prof, planes, f_abs, forced)
        st._process_collision = counted
        telems = st.process_captures([clean[0]])
        out.append((sorted(map(_key, telems)), sorted(st.active), seen,
                    st.stats["detections"]))
    (t_r, a_r, s_r, d_r), (t_p, a_p, s_p, d_p) = out
    # the sidelobes 22 kHz either side went to the collision path, found
    # nothing there, and the M10 decoded as before
    assert len(s_r) == 2 and all(abs(abs(f - CENTER - FREQS[M10_CH]) - 22e3)
                                 < 2e3 and forced is None for f, forced in s_r)
    assert d_r == 0 and a_r == [int(CENTER + FREQS[M10_CH])]
    assert {k[0] for k in t_r} == {"M10"}
    assert (t_p, a_p, s_p, d_p) == (t_r, a_r, s_r, d_r)

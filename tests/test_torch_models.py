"""The port's copies of the host modules against the JAX package's.

Each frame decoder with an encoder fixture decodes the same frames (bit
streams made by the JAX package's encoders, with a numpy seed where
they take one) to the same telemetry in both packages' registries; the
port's copy of ``models/imet4.py::afsk_fm_audio`` (rewritten on the
port's FIR and FM ops) matches the JAX one to 1e-4 of its peak.

One known difference (F22): where DFM frame candidates overlap, the
port keeps the one that more header hits support, so data that looks
like the header inside a frame no longer shadows the true frames after
it; the JAX package keeps the earlier candidate and loses the frame.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from radiosonde_auto_rx_tpu import models as ref_models
from radiosonde_auto_rx_tpu_torch import models as port_models

torch.set_num_threads(1)


def _rs41():
    from radiosonde_auto_rx_tpu.models.rs41 import (
        encode_frame, frame_to_bits, make_calibytes)
    cal = make_calibytes()
    return np.concatenate([frame_to_bits(encode_frame(
        frame_nb=900 + i, sonde_id="T1357911", week=2370,
        tow_ms=300_000_000 + 1000 * i, lat=-34.5, lon=138.6, alt=12000.0,
        calibytes=cal, calfr=i)) for i in range(3)]), {}


def _dfm():
    from radiosonde_auto_rx_tpu.models.dfm import encode_flight_bits
    return encode_flight_bits(sn=21054321, lat=47.9, lon=16.8,
                              n_cycles=3, time_step=1.0), {}


def _m10():
    from radiosonde_auto_rx_tpu.models.m10 import (encode_frame_m10,
                                                   frame_to_raw_bits)
    return np.concatenate([frame_to_raw_bits(encode_frame_m10(
        tow_ms=388815000 + 1000 * i)) for i in range(3)]), {}


def _m20():
    from radiosonde_auto_rx_tpu.models.m10 import (encode_frame_m20,
                                                   frame_to_raw_bits)
    return np.concatenate([frame_to_raw_bits(encode_frame_m20(
        gpssec=388815 + i)) for i in range(3)]), {}


def _lms6():
    from radiosonde_auto_rx_tpu.models.lms6 import (
        blocks_to_raw_bits, encode_block, encode_frame)
    return blocks_to_raw_bits([encode_block(encode_frame(
        frnr=100 + i, fill_seed=i)) for i in range(3)]), {}


def _imet5():
    from radiosonde_auto_rx_tpu.models.imet54 import (encode_frame,
                                                      encode_raw_bits)
    return np.concatenate([encode_raw_bits(encode_frame())
                           for _ in range(3)]), {}


def _meisei():
    from radiosonde_auto_rx_tpu.models.meisei import (
        encode_subframes_ims100, frames_to_raw_bits)
    return frames_to_raw_bits([encode_subframes_ims100(c)
                               for c in (16, 17)]), {}


def _mrz():
    from radiosonde_auto_rx_tpu.models.mrz import encode_flight_bits
    return encode_flight_bits(), {}


def _mts01():
    from radiosonde_auto_rx_tpu.models.mts01 import (encode_frame,
                                                     frame_to_bits)
    return np.concatenate([frame_to_bits(encode_frame(frnr=10 + i))
                           for i in range(3)]), {}


def _wxr301():
    from radiosonde_auto_rx_tpu.models.weathex import (encode_frame,
                                                       frame_to_bits)
    gap = np.tile(np.array([1, 0], np.uint8), 30)
    return np.concatenate(sum(([frame_to_bits(encode_frame(frid=i)), gap]
                               for i in range(3)), [])), {}


def _dropsonde():
    from radiosonde_auto_rx_tpu.models.dropsonde import (
        encode_frame_rd94, frames_to_raw_bits)
    return frames_to_raw_bits([encode_frame_rd94(frnr=i)
                               for i in range(3)]), {}


def _mk2lms():
    from radiosonde_auto_rx_tpu.models.mk2lms import encode_flight_bits
    return encode_flight_bits(n_frames=3), {}


def _imet():
    from radiosonde_auto_rx_tpu.models.imet4 import (
        encode_eptu_packet, encode_frame_bits, encode_gps_packet)
    return encode_frame_bits([encode_gps_packet(), encode_eptu_packet()]), {}


def _rs92():
    from radiosonde_auto_rx_tpu.models.rs92 import (encode_flight_bits,
                                                    make_test_ephemeris)
    ephs = make_test_ephemeris()
    return encode_flight_bits(n_frames=2, ephs=ephs, lat=-34.95,
                              lon=138.52, alt=12000.0), dict(ephemeris=ephs)


CASES = {"RS41": _rs41, "DFM": _dfm, "M10": _m10, "M20": _m20,
         "LMS6": _lms6, "IMET5": _imet5, "MEISEI": _meisei, "MRZ": _mrz,
         "MTS01": _mts01, "WXR301": _wxr301, "DROPSONDE": _dropsonde,
         "MK2LMS": _mk2lms, "IMET": _imet, "RS92": _rs92}


def test_registries_match():
    assert sorted(port_models.available_models()) == \
        sorted(ref_models.available_models())
    assert set(CASES) <= set(port_models.available_models())


@pytest.mark.parametrize("name", sorted(CASES))
def test_decoder_copy_decodes_the_same(name):
    bits, kw = CASES[name]()
    bits = np.asarray(bits, np.uint8)
    want = ref_models.get_model(name)(**kw).decode_bits(bits.copy())
    got = port_models.get_model(name)(**kw).decode_bits(bits.copy())
    assert want, f"{name}: the fixture decodes to nothing"
    assert got == want


def test_afsk_fm_audio_matches():
    from radiosonde_auto_rx_tpu.models.imet4 import afsk_fm_audio as ref
    from radiosonde_auto_rx_tpu_torch.models.imet4 import afsk_fm_audio
    rng = np.random.default_rng(4)
    x = rng.standard_normal((3, 2, 6000)).astype(np.float32)
    want = np.asarray(ref(jnp.asarray(x)))
    got = afsk_fm_audio(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (3, 6000)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-4 * np.abs(want).max())
    np.testing.assert_allclose(afsk_fm_audio(torch.from_numpy(x[0])).numpy(),
                               got[0], rtol=0, atol=1e-6)


def _dfm_blocks(k0, k1):
    """A DFM's stream as the benchmark's generator keys it (busy10's
    second DFM), cut into 2 s blocks [k0, k1): [(block, bits)]; and the
    first frame index and block of each frame."""
    import datetime
    from stationbench import generator
    spec = {"type": "DFM", "serial": "21098765", "level": 0.005,
            "site": [48.83, 9.2, 7500.0, 7.0, 5.0, 4.7], "phase_s": 0.59}
    t0 = generator.gps_start(datetime.datetime(
        2026, 10, 18, 10, 40, tzinfo=datetime.timezone.utc).timestamp())
    s = generator.Sonde(spec, 0.0, t0, np.random.default_rng(1))
    blk = 2 * s.rs
    s.ensure(k1 * blk)
    return [(k, s.syms[k * blk:(k + 1) * blk].copy())
            for k in range(k0, k1)], t0


@pytest.mark.parametrize("block, frame", [(161, 287), (73, 130)])
def test_dfm_header_like_data_shadows_no_frame(block, frame):
    """Block 161 holds a header-like pattern inside frame 287's cycle,
    after its true header: the port decodes the frame, the JAX package's
    decoder (which keeps the earlier of two overlapping candidates)
    loses it.  Block 73 holds one before frame 130's true header: both
    decode the frame.  On the blocks around, the port's telemetry is the
    JAX package's plus that frame."""
    blocks, t0 = _dfm_blocks(block - 3, block + 2)
    port = port_models.get_model("DFM")()
    ref = ref_models.get_model("DFM")()
    for k, bits in blocks:
        got = port.decode_bits(bits.copy())
        want = ref.decode_bits(bits.copy())
        frames = [t["frame"] - t0 for t in got]
        if k == block:
            assert frame in frames
            if block == 161:
                assert [t for t in got if t["frame"] - t0 != frame] == want
                continue
        assert got == want

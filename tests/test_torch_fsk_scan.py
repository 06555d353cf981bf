"""The buffered-scan kernel's source (``csrc/fsk_block.cuh``, the body of
``csrc/fsk_scan.cu``) on the CPU, against the plain scan ``fsk_scan_ref``.

A CUDA kernel has no CPU mode, so the header's device code is compiled
with g++ against the stand-in ``tests/cuda_shim/cuda_runtime.h`` (every
CUDA thread of a block a host thread, ``__syncthreads()`` a barrier,
``cp.async`` a plain copy) into ``tests/cuda_shim/fsk_scan_host.cc``,
which takes the operands exactly as the wrapper builds them for the card
(``demod/fsk.py::_scan_operands``, so the order of the C entry's three
flat arrays is checked too) and runs every channel's whole scan.  It runs
with one window buffer in shared memory and with two (the double-buffered
form the card takes where two fit).

Inputs: modulated signals with noise (``chip_smoke.fsk_signal``, the
port's copy of the modulator), 2 channels, a few demod blocks of each
chain geometry the station uses (M10's odd n = 745, M20, RS41's mask
estimator, LMS6's peak estimator, DFM at 50 kHz, MEISEI, MTS01's
ndft 512, the iMet AFSK audio with P = 8 and a real input, WXR301 at
96 kHz and WXRPN9 at 100 kHz with the mask comb over the whole ndft 256
spectrum, the L-band chains RS92NGP at 240 kHz with ndft 512 and one
window buffer, MK2LMS at 240.4 kHz with ndft 256) and an FSK4
configuration.  Tolerances (``chip_smoke.
scan_diff``, what the card is held to): bits, tone estimates, ptr and nin
equal; soft decisions, spectra and tone magnitudes within 1e-4 of their
peak; timing to 1e-4; the Eb/N0 bound of ``tests/test_torch_fsk.py``.
"""

import shutil
import struct
import subprocess
from pathlib import Path

import pytest
import torch

import chip_smoke as cs
from radiosonde_auto_rx_tpu_torch import kernels
from radiosonde_auto_rx_tpu_torch.demod import fsk

torch.set_num_threads(1)
CPU = torch.device("cpu")
SHIM = Path(__file__).parent / "cuda_shim"
CHAINS = ("M10", "M20", "RS41", "LMS6", "DFM", "MEISEI", "MTS01", "AFSK",
          "WXR301", "WXRPN9", "RS92NGP", "MK2LMS", "FSK4")


def _signal(name, c=2, blocks=3, seed=0):
    cfg = cs.cfg_of(name)
    t = cfg.nmem + fsk.SLACK_TS * cfg.ts + blocks * cfg.n + 3
    x = torch.from_numpy(cs.fsk_signal(cfg, c, t, seed))
    return cfg, x, fsk.fsk_num_blocks_buffered(cfg, t)


@pytest.fixture(scope="module")
def scan_host(tmp_path_factory):
    """``tests/cuda_shim/fsk_scan_host.cc`` built against the kernels'
    header ``csrc/fsk_block.cuh``."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to compile the kernels' header for the CPU")
    exe = tmp_path_factory.mktemp("cuda_shim") / "fsk_scan_host"
    subprocess.run(
        [gxx, "-std=c++17", "-O1", "-pthread", "-Wno-unknown-pragmas",
         f"-I{SHIM}", f"-I{kernels.CSRC}", str(SHIM / "fsk_scan_host.cc"),
         "-o", str(exe)], check=True, capture_output=True, text=True)
    return exe


def _run_host(exe, tmp_path, cfg, x, state, nb, probe=False, stages=2,
              smem=None):
    """The kernel source's scan on the CPU; returns (state, outs) as
    ``fsk_scan`` does.  ``smem``: a list that gets the bytes of shared
    memory a block of the kernel takes with these operands."""
    ptrs, ints, floats, result = fsk._scan_operands(cfg, x, state, nb,
                                                    probe)
    blob = [struct.pack("<i", len(ptrs))]
    for t in ptrs:
        raw = b"" if t is None else t.numpy().tobytes()
        blob += [struct.pack("<q", len(raw)), raw]
    blob += [struct.pack(f"<i{len(ints)}i", len(ints), *ints),
             struct.pack(f"<i{len(floats)}f", len(floats), *floats)]
    src, dst = tmp_path / "in.bin", tmp_path / "out.bin"
    src.write_bytes(b"".join(blob))
    run = subprocess.run([str(exe), str(src), str(dst), str(stages)],
                         check=True, capture_output=True, text=True,
                         timeout=300)
    if smem is not None:
        smem.append(4 * int(run.stdout.split(" floats")[0].split()[-1]))
    data, pos = dst.read_bytes(), 0
    for t in ptrs:
        (n,) = struct.unpack_from("<q", data, pos)
        pos += 8
        if t is not None:
            assert n == t.numel() * t.element_size()
            t.copy_(torch.frombuffer(bytearray(data[pos:pos + n]),
                                     dtype=t.dtype).reshape(t.shape))
        pos += n
    return result


@pytest.mark.parametrize("stages", [1, 2])
@pytest.mark.parametrize("name", CHAINS)
def test_kernel_source_matches_twin(scan_host, tmp_path, name, stages):
    cfg, x, nb = _signal(name, seed=len(name))
    st0 = fsk.fsk_init_state(cfg, 2, CPU)
    want = fsk.fsk_scan_ref(cfg, x, st0, nb, probe=True)
    got = _run_host(scan_host, tmp_path, cfg, x, st0, nb, probe=True,
                    stages=stages)
    assert set(got[1]) == set(want[1]) and set(got[0]) == set(want[0])
    for k, v in want[1].items():
        assert got[1][k].shape == v.shape and got[1][k].dtype == v.dtype, k
    cs.scan_diff(got, want, name)


# the H100's shared memory a block may opt in to (cudaDevAttrMaxShared-
# MemoryPerBlockOptin: 227 KB)
OPTIN_BYTES = 227 * 1024


@pytest.mark.parametrize("name,stages", [("RS92NGP", 1), ("MK2LMS", 2)])
def test_lband_scan_fits_the_card(scan_host, tmp_path, name, stages):
    """The L-band geometries' shared memory a block (the kernel's
    ``scan_map``): the wrapper takes two window buffers where they fit
    the opt-in, else one.  RS92NGP's window span (nmem 15,100 + 8 ts =
    15,500 samples a plane) fits only once; MK2LMS's twice."""
    cfg, x, nb = _signal(name, blocks=1)
    st0 = fsk.fsk_init_state(cfg, 2, CPU)
    sizes = []
    for k in (1, 2):
        _run_host(scan_host, tmp_path, cfg, x, st0, nb, stages=k,
                  smem=sizes)
    fits = [b <= OPTIN_BYTES for b in sizes]
    assert fits == [True, stages == 2], sizes


@pytest.mark.parametrize("name", ["RS41", "M10", "DFM", "AFSK", "WXR301",
                                  "RS92NGP"])
def test_kernel_source_carried_state(scan_host, tmp_path, name):
    """From the twin's final state (EMA spectrum, timing, ppm, pointer
    carried), over the same input again."""
    cfg, x, nb = _signal(name, seed=7)
    st1, _ = fsk.fsk_scan_ref(cfg, x, fsk.fsk_init_state(cfg, 2, CPU), nb)
    cs.scan_diff(_run_host(scan_host, tmp_path, cfg, x, st1, nb),
                 fsk.fsk_scan_ref(cfg, x, st1, nb), name)


def _split_equals_whole(scan, cfg, x, nb):
    """Two scans, the second from the first's state, equal one scan
    while no clock adjustment moved the window offset."""
    st0 = fsk.fsk_init_state(cfg, x.shape[0], CPU)
    st, whole = scan(cfg, x, st0, nb)
    k = nb // 2
    st_a, a = scan(cfg, x, st0, k)
    assert bool((a["f_est"].abs() > 0).all())
    st_b, b = scan(cfg, x[..., k * cfg.n:].contiguous(), st_a, nb - k)
    # the window offset restarts at each call: the split is exact only
    # where the first part made no +-ts/2 adjustment
    assert st_a["ptr"].tolist() == [cfg.nmem + k * cfg.n] * x.shape[0]
    for key in ("soft", "bits"):
        assert torch.equal(torch.cat([a[key], b[key]], 1), whole[key]), key
    for key in ("f_est", "ebno_db", "ppm"):
        assert torch.equal(torch.cat([a[key], b[key]], 1), whole[key]), key
    for key in st:
        assert torch.equal(st_b[key], st[key]), key


@pytest.mark.parametrize("name", ["RS41", "M20"])
def test_twin_two_calls_equal_one(name):
    cfg, x, nb = _signal(name, blocks=4, seed=3)
    _split_equals_whole(fsk.fsk_scan_ref, cfg, x, nb)


def test_kernel_source_two_calls_equal_one(scan_host, tmp_path):
    cfg, x, nb = _signal("RS41", blocks=4, seed=3)
    _split_equals_whole(
        lambda *a: _run_host(scan_host, tmp_path, *a), cfg, x, nb)


def test_scan_operands_match_the_c_entry():
    """The flat operand arrays have the C entry's lengths (fsk_block.cuh:
    23 pointer slots, 21 ints and 12 mask offsets, 4 floats), the probe
    slots are empty without probe, and the mask offsets are the twin's
    summation order."""
    cfg, x, nb = _signal("RS41", blocks=2)
    st0 = fsk.fsk_init_state(cfg, 2, CPU)
    ptrs, ints, floats, _ = fsk._scan_operands(cfg, x, st0, nb)
    assert (len(ptrs), len(ints), len(floats)) == (23, 33, 4)
    assert len(fsk.SCAN_POINTERS) == 23 and len(fsk.SCAN_INTS) == 33
    probe = [fsk.SCAN_POINTERS.index(k)
             for k in ("probe_sf", "probe_timing", "probe_tmag")]
    assert [ptrs[i] for i in probe] == [None] * 3
    geo = dict(zip(fsk.SCAN_INTS, ints))
    offs, _ = fsk._mask_offsets(cfg)
    assert [geo[f"offs{i}"] for i in range(geo["n_offs"])] == list(offs)
    assert geo["n_blocks"] == nb and geo["ndft"] == cfg.ndft


def test_scan_kernel_refuses_what_it_cannot_take():
    """A configuration outside the kernel's templates (ndft 2048), input
    of another type or layout, blocks that do not fit the input, a state
    of another type and a device with no kernel raise in the wrapper."""
    wide = fsk.FSKConfig(fs=48000, rs=300, m=2, p=5, nsym=100)   # ndft 2048
    assert wide.ndft not in (64, 128, 256, 512)
    x = torch.zeros(1, 2, wide.nmem + 8 * wide.ts + wide.n)
    st = fsk.fsk_init_state(wide, 1, CPU)
    with pytest.raises(ValueError):
        fsk._scan_operands(wide, x, st, 1)
    cfg, x, nb = _signal("RS41", blocks=2)
    st = fsk.fsk_init_state(cfg, 2, CPU)
    with pytest.raises(ValueError):
        fsk._scan_operands(cfg, x.double(), st, nb)
    with pytest.raises(ValueError):
        fsk._scan_operands(cfg, x[..., ::2], st, nb)
    with pytest.raises(ValueError):
        fsk._scan_operands(cfg, x, st, nb + 2)
    with pytest.raises(ValueError):
        fsk._scan_operands(cfg, x, dict(st, ptr=st["ptr"].long()), nb)
    meta = torch.device("meta")
    with pytest.raises(ValueError):
        fsk.fsk_scan(cfg, x.to(meta), {k: v.to(meta) for k, v in st.items()},
                     nb)

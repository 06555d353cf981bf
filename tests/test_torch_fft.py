"""K3: the port's ``ops.fft.fft`` (its plain twin on the CPU) against the
JAX package's ``pallas_fft.fft`` in Pallas interpret mode.

N = 64 .. 1024 go through one direct DFT in both packages (the Pallas
``_fft_kernel`` in the reference, ``fft_ref`` here); N = 2048 and 4096
through ``method="four-step"`` (the reference's two ``_cmatmul_pallas``
stages, the port's twiddle and transposes around two direct stages) and
``method="auto"`` (a plain matmul in both).  Inputs are made with numpy
from a seed, with a Hann window.  Tolerance per bin: |port - JAX| <=
1e-4·(|JAX| + the row's RMS), float32 on both sides in another
summation order — the tolerance ``chip_smoke.py`` holds the kernel to.

The CUDA kernels (``csrc/fft_smem.cuh``) cannot run without a card, so
their schedule is mirrored here in NumPy, thread by thread and stage by
stage (``_schedule_fft``): the radix plan, which row positions a thread
holds, the butterfly networks, the twiddle-table index
``(j % Ns)·r·N/(Ns·R)``, the write position of every stage and the
swizzled and padded shared-memory layouts.  The mirror is held to
``fft_ref`` and to the Pallas kernels for every N = 2 .. 4096, so an index
slip shows before a card is asked.  The header's own device code is
also compiled for the CPU with g++ against a stand-in ``cuda_runtime.h``
(``tests/cuda_shim/``: every CUDA thread of a block a host thread,
``__syncthreads()`` a barrier) and held to a float64 DFT.
"""

import shutil
import subprocess
from pathlib import Path

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from radiosonde_auto_rx_tpu.ops import pallas_fft
from radiosonde_auto_rx_tpu_torch import kernels
from radiosonde_auto_rx_tpu_torch.ops import fft

torch.set_num_threads(1)
TOL = 1e-4


def _inputs(b, n, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, 2, n)).astype(np.float32)
    win = np.hanning(n).astype(np.float32)
    return x, win


def _inputs_any_n(b, n, seed):
    """As ``_inputs`` with a window that is nowhere zero (a Hann window
    of 2 points is)."""
    x, win = _inputs(b, n, seed)
    return x, win + np.float32(0.5)


def _per_bin_close(got, want):
    want = np.asarray(want)
    mag = np.hypot(want[:, 0], want[:, 1])                    # [B, N]
    rms = np.sqrt(np.mean(mag ** 2, axis=-1, keepdims=True))
    diff = np.hypot(*(np.asarray(got) - want).transpose(1, 0, 2))
    assert float((diff / (mag + rms)).max()) <= TOL


@pytest.mark.parametrize("n", [64, 128, 256, 512, 1024])
def test_fft_matches_pallas_interpret(n):
    x, win = _inputs(5, n, n)
    want = pallas_fft.fft(jnp.asarray(x), win=jnp.asarray(win),
                          interpret=True)
    got = fft.fft(torch.from_numpy(x), torch.from_numpy(win))
    assert got.shape == (5, 2, n) and got.dtype == torch.float32
    _per_bin_close(got.numpy(), want)
    _per_bin_close(fft.fft_ref(torch.from_numpy(x), win).numpy(), want)


@pytest.mark.parametrize("n,method", [(2048, "four-step"), (4096, "four-step"),
                                      (2048, "auto")])
def test_fft_large_matches_pallas_interpret(n, method):
    x, win = _inputs(3, n, n + 1)
    want = pallas_fft.fft(jnp.asarray(x), win=jnp.asarray(win),
                          interpret=True, method=method)
    got = fft.fft(torch.from_numpy(x), torch.from_numpy(win), method=method)
    _per_bin_close(got.numpy(), want)


def test_fft_takes_complex_input_and_no_window():
    x, _ = _inputs(4, 256, 7)
    z = torch.complex(torch.from_numpy(x[:, 0]), torch.from_numpy(x[:, 1]))
    want = np.fft.fft(x[:, 0].astype(np.float64) + 1j * x[:, 1])
    got = fft.fft(z).numpy()
    _per_bin_close(got, np.stack([want.real, want.imag], axis=1))


# ---------------------------------------------------------------------- #
# the kernels' schedule, mirrored (csrc/fft_smem.cuh)

_H = np.float32(np.sqrt(0.5))
_POWERS_OF_TWO = [2 ** k for k in range(1, 13)]


def _pad(i):
    """Where entry i of the twiddle table is stored."""
    return i + (i >> 5)


def _swz(i):
    """Where position i of a row is stored."""
    return i ^ ((i >> 5) & 7) ^ (((i >> 5) & 6) << 2)


def _radix_plan(n):
    """Radix 8 while it fits, then one radix 4 or 2."""
    plan, ns = [], 1
    while ns < n:
        plan.append(min(8, n // ns))
        ns *= plan[-1]
    return plan


def _c64(z):
    return np.asarray(z).astype(np.complex64)


def _fft4(a0, a1, a2, a3):
    t0, t1, t2 = _c64(a0 + a2), _c64(a0 - a2), _c64(a1 + a3)
    t3 = _c64(-1j * (a1 - a3))
    return [_c64(t0 + t2), _c64(t1 + t3), _c64(t0 - t2), _c64(t1 - t3)]


def _butterfly(u):
    """Radix-2/4/8 DFT, natural order in and out, as the header's."""
    if len(u) == 2:
        return [_c64(u[0] + u[1]), _c64(u[0] - u[1])]
    if len(u) == 4:
        return _fft4(*u)
    e = _fft4(u[0], u[2], u[4], u[6])
    o = _fft4(u[1], u[3], u[5], u[7])
    o[1] = _c64(o[1] * (_H - 1j * _H))
    o[2] = _c64(-1j * o[2])
    o[3] = _c64(o[3] * (-_H - 1j * _H))
    return [_c64(e[k] + o[k]) for k in range(4)] + \
        [_c64(e[k] - o[k]) for k in range(4)]


def _schedule_fft(x, win):
    """The kernels' row FFT on [B, 2, N] float32 planes -> complex64
    [B, N]: T = N/8 threads a row, 8 values a thread, thread t holding
    positions t + m·T at every stage."""
    b, _, n = x.shape
    tw = fft._twiddles(n, torch.device("cpu")).numpy()
    table = np.zeros(n + n // 32, np.complex64)
    table[_pad(np.arange(n))] = tw[0] - 1j * tw[1]
    T = max(n // 8, 1)
    vals = n // T
    t = np.arange(T)
    xw = _c64((x[:, 0] + 1j * x[:, 1]) * win)
    v = [xw[:, t + m * T] for m in range(vals)]
    smem = None
    ns = 1
    for radix in _radix_plan(n):
        bpt = n // (radix * T)
        last = ns * radix == n
        if ns > 1:
            v = [smem[:, _swz(t + m * T)] for m in range(vals)]
        smem = np.full((b, n), np.nan, np.complex64)
        for bf in range(bpt):
            j = t + bf * T
            k = j & (ns - 1)
            if ns > 1:
                step = n // (ns * radix)
                for r in range(1, radix):
                    v[bf + r * bpt] = _c64(v[bf + r * bpt] *
                                           table[_pad(k * r * step)])
            out = _butterfly([v[bf + r * bpt] for r in range(radix)])
            for r in range(radix):
                v[bf + r * bpt] = out[r]
                if not last:
                    smem[:, _swz((j - k) * radix + k + r * ns)] = out[r]
        ns *= radix
    y = np.empty((b, n), np.complex64)
    for m in range(vals):
        y[:, t + m * T] = v[m]                 # thread t holds bins t + m·T
    return y


@pytest.mark.parametrize("n", _POWERS_OF_TWO)
def test_schedule_plan_covers_n(n):
    plan = _radix_plan(n)
    assert int(np.prod(plan)) == n
    assert all(r == 8 for r in plan[:-1]) and plan[-1] in (2, 4, 8)
    assert len(plan) == -(-int(np.log2(n)) // 3)
    # both layouts are one-to-one within their buffers
    i = np.arange(n)
    assert sorted(_swz(i)) == list(i)
    assert len(set(_pad(i))) == n and _pad(i).max() < n + n // 32 + (n < 32)


def _ways(addresses):
    """The most distinct addresses of one warp's access on one bank."""
    by_bank = {}
    for a in set(int(v) for v in addresses):
        by_bank[a % 32] = by_bank.get(a % 32, 0) + 1
    return max(by_bank.values())


@pytest.mark.parametrize("n", [256, 512, 1024, 2048, 4096])
def test_schedule_bank_conflicts(n):
    """What the header's note says of the layouts, counted warp by warp
    and stage by stage: with one row to a warp or more (N >= 256) every
    read and write of the row buffer is conflict-free under the swizzle,
    and the padded twiddle table is read at most 2-way."""
    T = n // 8
    rpb = max(1, 128 // T)
    data = table = 1
    ns = 1
    for radix in _radix_plan(n):
        bpt = n // (radix * T)
        for warp in range(T * rpb // 32):
            tid = np.arange(32) + 32 * warp
            row, t = (tid // T) * 2 * n, tid % T
            if ns > 1:
                for m in range(8):
                    data = max(data, _ways(row + _swz(t + m * T)))
            for bf in range(bpt):
                j = t + bf * T
                k = j & (ns - 1)
                for r in range(radix):
                    if ns > 1 and r:
                        table = max(table, _ways(
                            _pad(k * r * (n // (ns * radix)))))
                    if ns * radix < n:
                        data = max(data, _ways(
                            row + _swz((j - k) * radix + k + r * ns)))
        ns *= radix
    assert data == 1 and table <= 2


@pytest.mark.parametrize("n", _POWERS_OF_TWO)
def test_schedule_matches_twin(n):
    x, win = _inputs_any_n(3, n, 2 * n + 1)
    want = fft.fft_ref(torch.from_numpy(x), torch.from_numpy(win)).numpy()
    y = _schedule_fft(x, win)
    _per_bin_close(np.stack([y.real, y.imag], axis=1), want)


@pytest.mark.parametrize("n", [2, 8, 16, 64, 128, 256, 512, 1024])
def test_schedule_matches_pallas_interpret(n):
    x, win = _inputs_any_n(3, n, 3 * n + 1)
    want = pallas_fft.fft(jnp.asarray(x), win=jnp.asarray(win),
                          interpret=True)
    y = _schedule_fft(x, win)
    _per_bin_close(np.stack([y.real, y.imag], axis=1), want)


@pytest.mark.parametrize("n", [2048, 4096])
def test_schedule_large_matches_pallas_four_step(n):
    x, win = _inputs_any_n(2, n, 3 * n + 1)
    want = pallas_fft.fft(jnp.asarray(x), win=jnp.asarray(win),
                          interpret=True, method="four-step")
    y = _schedule_fft(x, win)
    _per_bin_close(np.stack([y.real, y.imag], axis=1), want)


@pytest.mark.parametrize("shift", [True, False])
@pytest.mark.parametrize("n", [2, 64, 1024, 2048])
def test_schedule_abs2_matches_pallas(n, shift):
    """K2's epilogue on the mirrored FFT: re^2 + im^2 of bin k stored at
    (k + N/2) mod N when shifted.  Per bin to 1e-4 of (|JAX| + the row's
    mean power), the tolerance ``chip_smoke.py`` holds K2 to."""
    x, win = _inputs_any_n(3, n, 5 * n + int(shift))
    want = np.asarray(pallas_fft.fft_abs2(
        jnp.asarray(x), win=jnp.asarray(win), shift=shift, interpret=True))
    y = _schedule_fft(x, win)
    got = np.empty((3, n), np.float32)
    k = np.arange(n)
    got[:, (k + (n // 2 if shift else 0)) & (n - 1)] = \
        y.real ** 2 + y.imag ** 2
    err = np.abs(got - want) / (np.abs(want) +
                                want.mean(-1, keepdims=True))
    assert float(err.max()) <= TOL
    twin = fft.fft_abs2(torch.from_numpy(x), torch.from_numpy(win), shift)
    err = np.abs(twin.numpy() - want) / (np.abs(want) +
                                         want.mean(-1, keepdims=True))
    assert float(err.max()) <= TOL


@pytest.fixture(scope="module")
def fft_rows_host(tmp_path_factory):
    """``tests/cuda_shim/fft_rows_host.cc`` built against the kernels'
    header ``csrc/fft_smem.cuh``."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to compile the kernels' header for the CPU")
    shim = Path(__file__).parent / "cuda_shim"
    exe = tmp_path_factory.mktemp("cuda_shim") / "fft_rows_host"
    subprocess.run(
        [gxx, "-std=c++17", "-O1", "-pthread", "-Wno-unknown-pragmas",
         f"-I{shim}", f"-I{kernels.CSRC}", str(shim / "fft_rows_host.cc"),
         "-o", str(exe)], check=True, capture_output=True, text=True)
    return exe


@pytest.mark.parametrize("log2n", range(1, 13))
def test_header_device_code_on_the_cpu(fft_rows_host, log2n):
    """The header's ``fft_rows`` itself (loads, window, stages, barriers,
    swizzle, the walk over rows by 1 and 2 blocks, ragged last block,
    unaligned rows), float32 against a float64 DFT: 2e-6 per bin of
    (|want| + row RMS), ten times what the schedule's rounding gives."""
    out = subprocess.run([str(fft_rows_host), str(log2n)], check=True,
                         capture_output=True, text=True, timeout=300).stdout
    n, rows, _, err_win, err_plain = out.split()
    assert int(n) == 2 ** log2n and int(rows) > 0
    assert float(err_win) <= 2e-6 and float(err_plain) <= 2e-6


def test_fft_methods_agree_above_the_kernels_largest_row():
    """N = 8192 > MAX_N, the one route a card factors: "four-step" (the
    factorization, ``fft_ref`` as both stages) against a float64 FFT.
    "auto" on the CPU is one matmul by two [N, N] planes, 512 MB at this
    N; it is held to "four-step" at N = MAX_N, where the planes are a
    quarter of that, and dropped from the cache again."""
    n = 2 * fft.MAX_N
    x, win = _inputs(2, n, 11)
    four = fft.fft(torch.from_numpy(x), torch.from_numpy(win),
                   method="four-step").numpy()
    want = np.fft.fft((x[:, 0].astype(np.float64) + 1j * x[:, 1]) * win)
    _per_bin_close(four, np.stack([want.real, want.imag], axis=1))
    x, win = _inputs(2, fft.MAX_N, 12)
    auto = fft.fft(torch.from_numpy(x), torch.from_numpy(win)).numpy()
    fft._dft_mat.cache_clear()
    four = fft.fft(torch.from_numpy(x), torch.from_numpy(win),
                   method="four-step").numpy()
    _per_bin_close(four, auto)


def test_fft_cpu_takes_the_twin_and_refuses_bad_input():
    before = dict(kernels.launches)
    fft.fft(torch.zeros(2, 2, 64))
    fft.fft(torch.zeros(2, 2, 2048), method="four-step")
    assert kernels.launches == before            # no kernel on the CPU
    with pytest.raises(ValueError):
        fft.fft(torch.zeros(2, 2, 96))
    with pytest.raises(ValueError):
        fft.fft(torch.zeros(2, 3, 64))

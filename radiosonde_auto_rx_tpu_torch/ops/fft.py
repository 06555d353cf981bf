"""K2 and K3: the windowed DFT kernels over rows of IQ planes.

Port of ``radiosonde_auto_rx_tpu/ops/pallas_fft.py``:

* ``fft_abs2(x, win, shift)`` (K2): fused |DFT(win·x)|^2 (+ fftshift).
  The Welch PSD (``detect/psd.py``) sends every segment through here.
* ``fft(x, win, method)`` (K3): the windowed complex DFT with re/im
  planes out.

Each wrapper dispatches on where its input lies, and there is no path
from a CUDA tensor to a plain twin:

* A CUDA tensor launches the hand-written kernel (``csrc/fft_abs2.cu``,
  ``csrc/fft_planes.cu``: one FFT per row in shared memory,
  ``csrc/fft_smem.cuh``).  One launch covers N = 2 .. 4096, whatever
  ``method`` says.  ``fft`` above that is the Bailey factorization
  N = 128·N2 with the kernel as both DFT stages and the twiddle and
  transposes as torch ops.
* A CPU tensor goes to the twins ``fft_abs2_ref`` and ``fft_ref``, the
  matmul form of the reference's ``_direct_xla``.  There ``fft`` follows
  the reference's ``method``: one matmul up to N = 1024; above, "auto"
  is one matmul too and "four-step" the factorization with ``fft_ref``
  as both stages.
"""

from functools import lru_cache

import numpy as np
import torch

from radiosonde_auto_rx_tpu_torch import kernels

MAX_N = 4096          # the kernels' largest row (csrc/fft_smem.cuh)
DIRECT_MAX = 1024     # on the CPU "four-step" factors above this


@lru_cache(maxsize=8)
def _dft_mat(n: int, device: torch.device):
    """W[a, b] = exp(-2πi a b / n) as (cos, -sin) float32 planes."""
    ang = 2.0 * np.pi * np.outer(np.arange(n), np.arange(n)) / n
    return (torch.from_numpy(np.cos(ang).astype(np.float32)).to(device),
            torch.from_numpy((-np.sin(ang)).astype(np.float32)).to(device))


@lru_cache(maxsize=8)
def _twiddles(n: int, device: torch.device):
    """[2, n]: cos and sin of 2πm/n — the same float32 values as the
    entries of ``_dft_mat`` (index (a·b) mod n)."""
    ang = 2.0 * np.pi * np.arange(n) / n
    tw = np.stack([np.cos(ang), np.sin(ang)]).astype(np.float32)
    return torch.from_numpy(tw).to(device)


def _rows4(x):
    """[B, 2, N] -> [B, 2, 1, N] view; [C, 2, S, N] as is."""
    if x.dim() == 3:
        return x.unsqueeze(2)
    if x.dim() != 4 or x.shape[1] != 2:
        raise ValueError(f"expect [B, 2, N] or [C, 2, S, N] planes, "
                         f"got {tuple(x.shape)}")
    return x


def fft_abs2_ref(x, win, shift: bool = True):
    """Plain twin: |(win·x) @ W|^2 with W the [N, N] DFT matrix, rolled
    by N/2 when ``shift``.  x: [B, 2, N] -> [B, N], or [C, 2, S, N] ->
    [C, S, N] float32."""
    x4 = _rows4(x)
    n = x4.shape[-1]
    wc, ws = _dft_mat(n, x4.device)
    w = win.to(torch.float32)
    xr = x4[:, 0].float() * w
    xi = x4[:, 1].float() * w
    yr = xr @ wc - xi @ ws
    yi = xr @ ws + xi @ wc
    p = yr * yr + yi * yi
    if shift:
        p = torch.roll(p, n // 2, dims=-1)
    return p[:, 0] if x.dim() == 3 else p


def _launch(x, win, shift: bool):
    x4 = _rows4(x)
    C, _, S, n = x4.shape
    if x4.dtype != torch.float32 or win.dtype != torch.float32:
        raise TypeError("fft_abs2 kernel takes float32 planes and window")
    if n & (n - 1) or not 2 <= n <= MAX_N:
        raise ValueError(f"fft_abs2 kernel: N={n} must be a power of two "
                         f"in [2, {MAX_N}]")
    if x4.stride(-1) != 1:
        raise ValueError("fft_abs2 kernel: the last axis must be contiguous")
    if win.device != x4.device or win.shape != (n,):
        raise ValueError("fft_abs2 kernel: window must be [N] on x's device")
    win = win.contiguous()
    tw = _twiddles(n, x4.device)
    out = torch.empty((C, S, n), dtype=torch.float32, device=x4.device)
    if C * S:
        lib = kernels.library()
        err = lib.rsx_fft_abs2(
            x4.data_ptr(), x4.stride(0), x4.stride(2), x4.stride(1), S,
            C * S, win.data_ptr(), tw.data_ptr(), out.data_ptr(), n,
            int(bool(shift)), x4.device.index or 0,
            torch.cuda.current_stream(x4.device).cuda_stream)
        kernels.check(err, "fft_abs2")
        kernels.launches["fft_abs2"] += 1
    return out[:, 0] if x.dim() == 3 else out


def fft_abs2(x, win, shift: bool = True):
    """Fused |FFT(win * x)|^2 -> float32, fftshifted by default.

    x: [B, 2, N] re/im planes -> [B, N], or a [C, 2, S, N] view of S
    segments per row -> [C, S, N] (strided views are read in place by
    the kernel).  ``win`` is an [N] tensor on x's device."""
    if x.device.type == "cpu":
        return fft_abs2_ref(x, win, shift)
    if x.device.type != "cuda":
        raise ValueError(f"fft_abs2: no kernel for device {x.device}")
    return _launch(x, win, shift)


# ---------------------------------------------------------------------- #
# K3: fft


def _split(n: int):
    """N = N1 * N2 with N1 = min(128, N) (reference ``_split``)."""
    n1 = min(128, n)
    return n1, n // n1


@lru_cache(maxsize=8)
def _twiddle(n: int, device: torch.device):
    """Tw[k1, n2] = exp(-2πi k1 n2 / n) as (cos, -sin) planes [N1, N2]."""
    n1, n2 = _split(n)
    ang = 2.0 * np.pi * np.outer(np.arange(n1), np.arange(n2)) / n
    return (torch.from_numpy(np.cos(ang).astype(np.float32)).to(device),
            torch.from_numpy((-np.sin(ang)).astype(np.float32)).to(device))


def _planes_in(x, win):
    """[B, 2, N] planes or complex [B, N] -> (float32 [B, 2, N], window
    [N] or None, N)."""
    if x.is_complex():
        x = torch.stack([x.real, x.imag], dim=1)
    elif x.dim() != 3 or x.shape[1] != 2:
        raise ValueError(f"expect [B, 2, N] planes or complex [B, N], got "
                         f"{tuple(x.shape)}")
    x = x.float()
    n = x.shape[-1]
    if n & (n - 1):
        raise ValueError(f"FFT size must be a power of two, got {n}")
    w = None if win is None else torch.as_tensor(
        win, dtype=torch.float32, device=x.device).reshape(n)
    return x, w, n


def fft_ref(x, win=None):
    """Plain twin: (win·x) @ W with W the [N, N] DFT matrix, as four real
    products.  x: [B, 2, N] planes or complex [B, N] -> [B, 2, N]
    float32, bins in natural order."""
    x, w, n = _planes_in(x, win)
    wc, ws = _dft_mat(n, x.device)
    xr, xi = x[:, 0], x[:, 1]
    if w is not None:
        xr, xi = xr * w, xi * w
    yr = xr @ wc - xi @ ws
    yi = xr @ ws + xi @ wc
    return torch.stack([yr, yi], dim=1)


def _launch_planes(x, win):
    """K3 on [R, 2, n] float32 planes (last axis contiguous) -> [R, 2, n]."""
    R, _, n = x.shape
    if n & (n - 1) or not 2 <= n <= MAX_N:
        raise ValueError(f"fft kernel: N={n} must be a power of two in "
                         f"[2, {MAX_N}]")
    if x.stride(-1) != 1:
        raise ValueError("fft kernel: the last axis must be contiguous")
    if win is not None:
        win = win.contiguous()
    tw = _twiddles(n, x.device)
    out = torch.empty((R, 2, n), dtype=torch.float32, device=x.device)
    if R:
        lib = kernels.library()
        err = lib.rsx_fft_planes(
            x.data_ptr(), x.stride(0), x.stride(1), R,
            None if win is None else win.data_ptr(), tw.data_ptr(),
            out.data_ptr(), n, x.device.index or 0,
            torch.cuda.current_stream(x.device).cuda_stream)
        kernels.check(err, "fft")
        kernels.launches["fft"] += 1
    return out


def _dft_rows(x, win):
    """Windowed DFT of whole [R, 2, n] rows: the twin on the CPU, K3 on
    a CUDA tensor."""
    if x.device.type == "cpu":
        return fft_ref(x, win)
    if x.device.type != "cuda":
        raise ValueError(f"fft: no kernel for device {x.device}")
    return _launch_planes(x, win)


def _four_step(x, n: int):
    """X[k1 + N1 k2] = sum_{n2} Tw[k1,n2] F2[n2,k2] sum_{n1} x[N2 n1 + n2]
    F1[n1,k1]: two DFT stages (lengths N1 and N2) with the twiddle and
    re-layouts between them.  x: windowed [B, 2, n] -> [B, 2, n]."""
    b = x.shape[0]
    n1, n2 = _split(n)
    # stage 1: contract over n1.  rows (b, n2), lanes n1
    a = x.reshape(b, 2, n1, n2).permute(0, 3, 1, 2).reshape(b * n2, 2, n1)
    s1 = _dft_rows(a, None).reshape(b, n2, 2, n1)          # lanes k1
    twc, tws = _twiddle(n, x.device)
    twc_t, tws_t = twc.T[None], tws.T[None]                 # [1, n2, n1]
    br, bi = s1[:, :, 0], s1[:, :, 1]
    c = torch.stack([br * twc_t - bi * tws_t,
                     br * tws_t + bi * twc_t], dim=2)       # [b, n2, 2, n1]
    # stage 2: contract over n2.  rows (b, k1), lanes n2
    c = c.permute(0, 3, 2, 1).reshape(b * n1, 2, n2)
    d = _dft_rows(c, None)                                  # lanes k2
    # X[k1 + N1 k2]: lanes k2 are the major digit
    return d.reshape(b, n1, 2, n2).permute(0, 2, 3, 1).reshape(b, 2, n)


def fft(x, win=None, method: str = "auto"):
    """Batched complex FFT.  x: [B, 2, N] float32 planes or complex
    [B, N]; optional window [N].  Returns [B, 2, N] float32 planes, bins
    in natural order.  A CUDA tensor is one transform of the whole row
    up to N = 4096 and the factored path above.  On the CPU ``method``
    chooses as in the reference: "auto" is one transform of any N,
    "four-step" the factored path for N > 1024."""
    x, w, n = _planes_in(x, win)
    if x.device.type == "cuda":
        direct = n <= MAX_N
    else:
        direct = n <= DIRECT_MAX or method != "four-step"
    if direct:
        return _dft_rows(x, w)
    return _four_step(x if w is None else x * w, n)

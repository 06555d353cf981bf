"""IQ ingestion: wire-format conversion + blocked stream reading.

The reference's decoders each re-implement cu8/cs16/f32 input conversion
per process (reference demod/mod/demod_mod.c f32read_* and iq_dec.c);
here conversion happens once at the host boundary, producing the float32
``[2, T]`` planes the device pipeline consumes.  Conversions prefer the
native C helper (radiosonde_auto_rx_tpu_torch.native) when built and fall back
to NumPy.

``IQStreamSource`` turns any byte stream (subprocess stdout, file, socket
file object) into fixed-size IQ blocks with an overlap tail so the
channelizer/demod windows stay phase-continuous across block boundaries —
the host-side analogue of the reference's in-process ring buffers
(demod_mod.c:855-865).
"""

import numpy as np


def _native():
    try:
        from radiosonde_auto_rx_tpu_torch import native
        return native if native.available() else None
    except ImportError:
        return None


def cu8_to_planes(buf: bytes) -> np.ndarray:
    """rtl_sdr unsigned 8-bit IQ → float32 [2, T] in [-1, 1)
    (x-127.5)/128, the convention the reference decoders use
    (demod_mod.c f32read_csample cu8 branch)."""
    nat = _native()
    if nat is not None:
        return nat.cu8_to_planes(buf)
    raw = np.frombuffer(buf, dtype=np.uint8)
    x = (raw.astype(np.float32) - 127.5) / 128.0
    return np.ascontiguousarray(x.reshape(-1, 2).T)


def cs16_to_planes(buf: bytes) -> np.ndarray:
    """Signed 16-bit IQ (rtl_fm -M raw / ss_iq / pcmrecord) → float32
    [2, T] scaled by 1/32768."""
    nat = _native()
    if nat is not None:
        return nat.cs16_to_planes(buf)
    raw = np.frombuffer(buf, dtype="<i2")
    x = raw.astype(np.float32) / 32768.0
    return np.ascontiguousarray(x.reshape(-1, 2).T)


def f32c_to_planes(buf: bytes) -> np.ndarray:
    """Interleaved complex float32 → [2, T] planes."""
    raw = np.frombuffer(buf, dtype="<f4")
    return np.ascontiguousarray(raw.reshape(-1, 2).T)


def cu8_to_planes_raw(buf: bytes) -> np.ndarray:
    """rtl_sdr unsigned 8-bit IQ → RAW uint8 [2, T] planes (no float
    conversion).  The device casts and applies the (x-127.5)/128 wire
    scale on-chip (Station._wide_planes) — shipping the native wire
    width quarters host→device transfer vs float32."""
    raw = np.frombuffer(buf, dtype=np.uint8)
    return np.ascontiguousarray(raw.reshape(-1, 2).T)


def cs16_to_planes_raw(buf: bytes) -> np.ndarray:
    """Signed 16-bit IQ → RAW int16 [2, T] planes; the 1/32768 wire
    scale is applied on-device (exact power of two: bit-identical to
    the host-side float conversion)."""
    raw = np.frombuffer(buf, dtype="<i2")
    return np.ascontiguousarray(raw.reshape(-1, 2).T)


_CONVERTERS = {"cu8": (cu8_to_planes, 2),
               "cs16": (cs16_to_planes, 4),
               "f32c": (f32c_to_planes, 8),
               # native-width variants: planes keep the wire dtype and
               # the scale/offset is applied on-device
               "cu8raw": (cu8_to_planes_raw, 2),
               "cs16raw": (cs16_to_planes_raw, 4)}


def open_pumped(stream, capacity: int = 1 << 22, timeout_ms: int = -1):
    """Wrap a pipe/file object in the native fd-pump ring buffer so the
    capture process never blocks on a slow Python consumer (the reference
    relies on kernel pipe buffering between its processes).  Returns the
    original stream unchanged when the native runtime isn't built or the
    object has no fd (e.g. BytesIO in tests)."""
    nat = _native()
    if nat is None or not hasattr(stream, "fileno"):
        return stream
    try:
        stream.fileno()
    except (OSError, ValueError):
        return stream
    return nat.PumpedReader(stream, capacity=capacity, timeout_ms=timeout_ms)


class IQStreamSource:
    """Fixed-block IQ reader with overlap carry.

    Reads ``block_samples`` new IQ samples per ``read_block`` call and
    returns ``[2, overlap + block_samples]`` float32 planes where the
    first ``overlap`` samples repeat the previous block's tail.  Fixed
    shapes keep the device pipeline jit-cached; the overlap supplies the
    halo the windowed DSP needs at block joins.
    """

    def __init__(self, stream, fmt: str = "cs16", block_samples: int = 48000,
                 overlap: int = 0):
        assert fmt in _CONVERTERS, f"unknown IQ format {fmt}"
        self.stream = stream
        self.convert, self.bytes_per_sample = _CONVERTERS[fmt]
        self.block_samples = block_samples
        self.overlap = overlap
        tail_dt = {"cu8raw": np.uint8, "cs16raw": np.int16}.get(
            fmt, np.float32)
        self._tail = np.zeros((2, overlap), tail_dt)
        if fmt == "cu8raw":
            # cu8 zero decodes to (0-127.5)/128 = full-scale negative
            # DC; the neutral wire value is ~127.5 -> use 127
            self._tail[:] = 127
        self.samples_read = 0

    def read_block(self, partial: bool = False):
        """One [2, overlap+block] float32 block, or None at EOF.

        With ``partial=True`` a short final block is returned instead of
        being dropped (shape [2, overlap+got]) — stream-CLI use."""
        want = self.block_samples * self.bytes_per_sample
        chunks = []
        got = 0
        while got < want:
            chunk = self.stream.read(want - got)
            if not chunk:
                break
            chunks.append(chunk)
            got += len(chunk)
        if got < want and not (partial and got >= self.bytes_per_sample):
            return None                       # partial block: EOF
        planes = self.convert(b"".join(chunks))
        self.samples_read += planes.shape[1]
        out = np.concatenate([self._tail, planes], axis=1)
        if self.overlap:
            self._tail = planes[:, -self.overlap:].copy()
        return out

    def blocks(self):
        while True:
            b = self.read_block()
            if b is None:
                return
            yield b

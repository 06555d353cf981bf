"""CRC16-CCITT (poly 0x1021, init 0xFFFF) — batch/table-driven.

Reference implementation: demod/mod/rs41mod.c:284-305 (same CRC in every
sonde decoder that frames with 0x1021).
"""

import numpy as np

_TABLE = None


def _table():
    global _TABLE
    if _TABLE is None:
        tab = np.zeros(256, dtype=np.uint16)
        for byte in range(256):
            rem = byte << 8
            for _ in range(8):
                rem = ((rem << 1) ^ 0x1021) if (rem & 0x8000) else (rem << 1)
                rem &= 0xFFFF
            tab[byte] = rem
        _TABLE = tab
    return _TABLE


def crc16_ccitt(data: np.ndarray, init: int = 0xFFFF) -> int | np.ndarray:
    """CRC over the last axis of a uint8 array; returns int (1-D input)
    or array of CRCs for batched input [..., L]."""
    tab = _table()
    data = np.asarray(data, dtype=np.uint8)
    if data.ndim == 1:
        rem = init
        for b in data:
            rem = ((rem << 8) & 0xFFFF) ^ int(tab[((rem >> 8) ^ b) & 0xFF])
        return rem
    batch = data.shape[:-1]
    rem = np.full(batch, init, dtype=np.uint16)
    for i in range(data.shape[-1]):
        idx = ((rem >> 8) ^ data[..., i]).astype(np.uint8)
        rem = ((rem << 8) ^ tab[idx]).astype(np.uint16)
    return rem

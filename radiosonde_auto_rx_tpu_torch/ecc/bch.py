"""Binary BCH(63,51) t=2 over GF(2^6) — Meisei frame ECC.

Parameters per the reference (reference demod/mod/bch_ecc_mod.c:817-833
rs_init_BCH64: GF(2^6) f=0x43, generator
g(x) = x^12+x^10+x^8+x^5+x^4+x^3+1; decoder :968-1016 two-error direct
solver).  Implementation is new: table-based GF(64) arithmetic, syndrome +
quadratic error locator with Chien search — fixed iteration counts, so the
same code paths vmap onto device if frame rates ever warrant it.
"""

import numpy as np

M = 6
N = 63
K = 51
T = 2
PRIM_POLY = 0x43              # x^6 + x + 1
GEN_POLY = 0b1010100111001    # x^12+x^10+x^8+x^5+x^4+x^3+1 (degree 12)

# GF(64) log/antilog tables
EXP = np.zeros(2 * N, dtype=np.int32)
LOG = np.zeros(N + 1, dtype=np.int32)
_x = 1
for _i in range(N):
    EXP[_i] = _x
    LOG[_x] = _i
    _x <<= 1
    if _x & 0x40:
        _x ^= PRIM_POLY
EXP[N:2 * N] = EXP[:N]


def _gmul(a, b):
    if a == 0 or b == 0:
        return 0
    return int(EXP[LOG[a] + LOG[b]])


def _gdiv(a, b):
    if a == 0:
        return 0
    return int(EXP[(LOG[a] - LOG[b]) % N])


def bch_encode(data_bits):
    """51 data bits (data_bits[i] = coeff of x^(12+i)) -> 63-bit codeword
    cw[0..11] parity, cw[12..62] data (systematic)."""
    data_bits = np.asarray(data_bits, dtype=np.uint8)
    assert len(data_bits) == K
    # LFSR division: rem = m(x)*x^12 mod g(x)
    rem = 0
    for bit in data_bits[::-1]:               # highest degree first
        fb = int(bit) ^ ((rem >> 11) & 1)
        rem = ((rem << 1) & 0xFFF) ^ ((GEN_POLY & 0xFFF) if fb else 0)
    cw = np.zeros(N, dtype=np.uint8)
    cw[12:] = data_bits
    for i in range(12):
        cw[i] = (rem >> i) & 1
    return cw


# per-bit-position syndrome contributions: S_i = XOR_j cw[j]·alpha^(i·j)
_J = np.arange(N)
_T1 = EXP[_J % N].astype(np.int64)            # alpha^j
_T3 = EXP[(3 * _J) % N].astype(np.int64)      # alpha^(3j)
_A1 = EXP[_J].astype(np.int64)                # Chien: alpha^j
_A2 = EXP[(2 * _J) % N].astype(np.int64)      # alpha^(2j)
_LOGV = LOG.astype(np.int64)


def _syndrome(cw, i):
    """S_i = c(alpha^i) — one masked XOR-reduce."""
    t = _T1 if i == 1 else _T3
    c = cw if len(cw) >= N else np.pad(cw, (0, N - len(cw)))
    return int(np.bitwise_xor.reduce(np.where(c[:N] != 0, t, 0)))


def _gmul_vec(s, v):
    """Scalar s (nonzero) times vector v over GF(64)."""
    out = EXP[_LOGV[v] + LOG[s]]
    return np.where(v == 0, 0, out)


def bch_decode(cw):
    """Decode a 63-bit codeword in place.

    Returns (corrected_cw, n_errors) with n_errors = -1 on failure.
    """
    cw = np.asarray(cw, dtype=np.uint8).copy()
    s1 = _syndrome(cw, 1)
    s3 = _syndrome(cw, 3)
    if s1 == 0 and s3 == 0:
        return cw, 0
    if s1 != 0:
        # one error at position log(S1) iff S3 == S1^3
        s1_3 = _gmul(_gmul(s1, s1), s1)
        if s3 == s1_3:
            pos = LOG[s1]
            cw[pos] ^= 1
            return cw, 1
        # two errors: sigma(x) = 1 + s1 x + (s3/s1 + s1^2) x^2;
        # Chien search vectorized over all 63 candidate roots
        sig1 = s1
        sig2 = _gdiv(s3, s1) ^ _gmul(s1, s1)
        v = 1 ^ _gmul_vec(sig1, _A1)
        if sig2:
            v ^= _gmul_vec(sig2, _A2)
        roots = np.flatnonzero(v == 0)
        if len(roots) == 2:
            # error positions are inverse roots
            for r in roots:
                cw[(N - int(r)) % N] ^= 1
            if _syndrome(cw, 1) == 0 and _syndrome(cw, 3) == 0:
                return cw, 2
            # recheck failed (>2 errors): undo the speculative flips so
            # the returned codeword is never WORSE than the input
            for r in roots:
                cw[(N - int(r)) % N] ^= 1
        return cw, -1
    return cw, -1

"""GF(2^m) arithmetic via exp/log tables, vectorized over numpy arrays.

Table-driven so every op is a gather + add + gather — the form that maps to
int vector ops on device.  A GF instance can be built on any primitive
polynomial; the ``beta`` parameter re-bases the tables on beta = alpha^p so
codes defined on a power of the primitive element (CCSDS p=11, reference
demod/mod/bch_ecc_mod.c RS256ccsds) use identical decode code paths.
"""

import numpy as np


class GF:
    """GF(2^m) with exp/log tables based on generator beta = alpha^p."""

    def __init__(self, poly: int, m: int, p: int = 1):
        self.poly = poly
        self.m = m
        self.q = 1 << m           # field size
        self.n = self.q - 1       # multiplicative order
        self.p = p

        # alpha-based antilog table
        exp_a = np.zeros(2 * self.n, dtype=np.int64)
        x = 1
        for i in range(self.n):
            exp_a[i] = x
            x <<= 1
            if x & self.q:
                x ^= poly
        assert x == 1, "poly is not primitive"
        exp_a[self.n:] = exp_a[:self.n]

        if p == 1:
            exp_b = exp_a
        else:
            assert np.gcd(p, self.n) == 1
            exp_b = np.zeros(2 * self.n, dtype=np.int64)
            for i in range(self.n):
                exp_b[i] = exp_a[(p * i) % self.n]
            exp_b[self.n:] = exp_b[:self.n]

        log_b = np.zeros(self.q, dtype=np.int64)
        log_b[exp_b[:self.n]] = np.arange(self.n)
        log_b[0] = 0  # never used without a zero mask

        self.exp = exp_b          # exp[i] = beta^i, doubled for mod-free index
        self.log = log_b          # log[beta^i] = i

    # --- vectorized ops (operands: int arrays with values < q) ---

    def mul(self, a, b):
        a = np.asarray(a, dtype=np.int64)
        b = np.asarray(b, dtype=np.int64)
        out = self.exp[self.log[a] + self.log[b]]
        return np.where((a == 0) | (b == 0), 0, out)

    def div(self, a, b):
        """a / b; caller guarantees b != 0 where a != 0."""
        a = np.asarray(a, dtype=np.int64)
        b = np.asarray(b, dtype=np.int64)
        out = self.exp[self.log[a] - self.log[b] + self.n]
        return np.where(a == 0, 0, out)

    def inv(self, a):
        a = np.asarray(a, dtype=np.int64)
        return np.where(a == 0, 0, self.exp[self.n - self.log[a]])

    def pow_beta(self, e):
        """beta^e for integer array e (any sign)."""
        e = np.mod(np.asarray(e, dtype=np.int64), self.n)
        return self.exp[e]

    def poly_eval(self, coeffs, x):
        """Evaluate poly sum_k coeffs[...,k] x^k at points x (Horner).

        coeffs: [..., D+1]; x: broadcastable with coeffs[..., 0].
        """
        coeffs = np.asarray(coeffs, dtype=np.int64)
        acc = np.zeros(np.broadcast(coeffs[..., 0], x).shape, dtype=np.int64)
        for k in range(coeffs.shape[-1] - 1, -1, -1):
            acc = self.mul(acc, x) ^ coeffs[..., k]
        return acc

    def poly_mul(self, a, b):
        """Polynomial product over GF; a [..., Da+1], b [..., Db+1]."""
        a = np.asarray(a, dtype=np.int64)
        b = np.asarray(b, dtype=np.int64)
        out = np.zeros(a.shape[:-1] + (a.shape[-1] + b.shape[-1] - 1,),
                       dtype=np.int64)
        for i in range(a.shape[-1]):
            for j in range(b.shape[-1]):
                out[..., i + j] ^= self.mul(a[..., i], b[..., j])
        return out


# Field instances used by the sonde codes (reference bch_ecc_mod.c:55-100)
GF256_RS = GF(0x11D, 8)            # RS41/RS92: X^8+X^4+X^3+X^2+1
GF256_CCSDS = GF(0x187, 8, p=11)   # LMS6: X^8+X^7+X^2+X+1, beta=alpha^11
GF64_BCH = GF(0x43, 6)             # Meisei: X^6+X+1

"""Standalone FSK demodulator CLI — the ``fsk_demod`` binary's drop-in.

Port of ``radiosonde_auto_rx_tpu/demod/cli.py``; mirrors the reference CLI
(reference utils/fsk_demod.c:359-457):

    python -m radiosonde_auto_rx_tpu_torch.demod.cli [options] Mode Fs Rs in out

* ``--device`` (default ``cuda``): where the demod runs.  On a CUDA
  device each chunk of 8 demod blocks is one launch of the scan kernel in
  its unbuffered mode (``demod/fsk.py::fsk_scan``); without a CUDA device
  the CLI exits 1 unless ``--device cpu`` was asked for.
* Mode 2 or 4 (tones); ``-`` for stdin/stdout.
* input: cs16 IQ by default (``--cu8`` / ``--f32c`` to switch).
* output: float32 soft bits (``-s``, default) or packed hard bits
  one-byte-per-bit (``--hardout``), negated soft convention with ``-i``
  exactly like the reference's ``-i`` soft inversion flag.
* ``--stats=N``: every N-ish blocks emit one JSON line on stderr with the
  same keys the reference prints (fsk_demod.c:370-406) — ``EbNodB``,
  ``ppm``, ``f1_est``/``f2_est``.., so existing stats consumers
  (FSKDemodStats-style parsers) keep working.

This exists for interoperability and harness testing; inside the
framework the demod is called as a batched function, not a pipe.
"""

import argparse
import json
import sys

import numpy as np
import torch

from radiosonde_auto_rx_tpu_torch.demod.fsk import (
    FSKConfig, fsk_demod_stream, fsk_init_state, fsk_num_blocks)
from radiosonde_auto_rx_tpu_torch.sources.iq_source import IQStreamSource


def parse_args(argv=None):
    ap = argparse.ArgumentParser(
        prog="fsk_demod",
        description="FSK demodulator on a CUDA device (fsk_demod "
                    "equivalent)")
    ap.add_argument("-p", type=int, default=8, dest="p",
                    help="timing offsets per symbol")
    ap.add_argument("--nsym", type=int, default=50)
    ap.add_argument("-b", type=int, default=0, dest="est_min",
                    help="estimator limit low (Hz)")
    ap.add_argument("-u", type=int, default=0, dest="est_max",
                    help="estimator limit high (Hz)")
    ap.add_argument("--mask", type=int, default=0,
                    help="tone spacing (Hz) for the mask estimator")
    ap.add_argument("-s", "--soft", action="store_true", default=True,
                    help="float32 soft output (default)")
    ap.add_argument("--hardout", action="store_true",
                    help="one hard bit per output byte instead of soft")
    ap.add_argument("-i", "--invert", action="store_true",
                    help="invert soft-bit polarity")
    ap.add_argument("--cu8", action="store_true", help="cu8 input")
    ap.add_argument("--cs16", action="store_true", help="cs16 input (default)")
    ap.add_argument("--f32c", action="store_true",
                    help="interleaved complex float32 input")
    ap.add_argument("--stats", type=int, default=0, metavar="N",
                    help="emit JSON stats on stderr every N blocks")
    ap.add_argument("--testframes", action="store_true",
                    help="BER self-test against the known 100-bit PRBS "
                         "frame (bit-identical to the reference's "
                         "fsk_get_test_bits, srand(158324))")
    ap.add_argument("--device", default="cuda",
                    help="torch device the demod runs on (default cuda)")
    ap.add_argument("mode", type=int, choices=(2, 4))
    ap.add_argument("fs", type=int)
    ap.add_argument("rs", type=int)
    ap.add_argument("infile")
    ap.add_argument("outfile")
    return ap.parse_args(argv)


TEST_FRAME_SIZE = 100      # reference utils/fsk_demod.c:30


def _glibc_rand_bits(seed: int, n: int) -> np.ndarray:
    """glibc rand()&1 sequence (TYPE_3 additive generator, 310 warmup
    discards) — reproduces the reference's srand(158324) test frame
    bit-exactly (fsk_demod.c:247-251, fsk_get_test_bits.c)."""
    discard = 310
    total = 34 + discard + n
    r = [0] * total
    r[0] = seed
    for i in range(1, 31):
        r[i] = (16807 * r[i - 1]) % 2147483647
    for i in range(31, 34):
        r[i] = r[i - 31]
    out = np.zeros(n, np.uint8)
    k = 0
    for i in range(34, total):
        r[i] = (r[i - 31] + r[i - 3]) % (1 << 32)
        if i >= 34 + discard:
            out[k] = (r[i] >> 1) & 1
            k += 1
    return out


def test_frame_bits() -> np.ndarray:
    """The known TX test frame (TEST_FRAME_SIZE bits)."""
    return _glibc_rand_bits(158324, TEST_FRAME_SIZE)


class _TestFrameCounter:
    """Sliding-window test-frame sync + BER accounting
    (reference fsk_demod.c:318-357)."""

    def __init__(self):
        self.tx = test_frame_bits()
        self.window = np.zeros(TEST_FRAME_SIZE, np.uint8)
        self.frames = 0
        self.bits = 0
        self.errs = 0

    def update(self, rx_bits, stderr):
        for b in np.asarray(rx_bits, np.uint8):
            self.window[:-1] = self.window[1:]
            self.window[-1] = b
            e = int(np.sum(self.window != self.tx))
            if e < 0.1 * TEST_FRAME_SIZE:
                self.frames += 1
                self.bits += TEST_FRAME_SIZE
                self.errs += e
                stderr.write(
                    f"errs: {e} FSK BER "
                    f"{self.errs / max(self.bits, 1):f}, bits tested "
                    f"{self.bits}, bit errors {self.errs}\n")


def run(args, stdin=None, stdout=None, stderr=None) -> int:
    stdin = stdin if stdin is not None else sys.stdin.buffer
    stdout = stdout if stdout is not None else sys.stdout.buffer
    stderr = stderr if stderr is not None else sys.stderr
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        stderr.write("fsk_demod: no CUDA device (pass --device cpu to run "
                     "on the CPU)\n")
        return 1

    fmt = "cu8" if args.cu8 else ("f32c" if args.f32c else "cs16")
    infile = stdin if args.infile == "-" else open(args.infile, "rb")
    outfile = stdout if args.outfile == "-" else open(args.outfile, "wb")

    cfg = FSKConfig(fs=args.fs, rs=args.rs, m=args.mode, p=args.p,
                    nsym=args.nsym, est_min=args.est_min,
                    est_max=args.est_max, tone_spacing=args.mask,
                    freq_est_type=1 if args.mask else 0)
    # stream in demod blocks: nmem window carried, advance nominal N/block.
    # One outer block = `chunk` demod blocks to amortize dispatch.
    # The single-channel CLI keeps the plain scan: its ptr/tail streaming
    # carries exact clock state across chunks (the gather-free buffered
    # scan is the default on the batch/station/sharded perf paths).
    chunk = 8
    t_need = cfg.nmem + chunk * cfg.block_advance_max
    src = IQStreamSource(infile, fmt=fmt, block_samples=t_need)

    state = fsk_init_state(cfg, 1, device)
    tf_counter = _TestFrameCounter() if args.testframes else None
    carry = None          # leftover samples [2, tail]
    nblk = 0
    total_in = 0
    while True:
        blk = src.read_block(partial=True)
        if blk is None:
            break
        x = blk if carry is None else np.concatenate([carry, blk], axis=1)
        nb = fsk_num_blocks(cfg, x.shape[1])
        if nb == 0:
            carry = x
            continue
        state_ptr0 = int(state["ptr"][0])
        soft, bits, outs, state = fsk_demod_stream(
            cfg, x[None], device, state=state, buffered=False)
        consumed = int(state["ptr"][0]) - state_ptr0
        # keep the un-consumed tail + nmem history for the next round
        keep = x.shape[1] - consumed
        carry = x[:, -keep:] if keep > 0 else None
        state = dict(state, ptr=torch.full((1,), cfg.nmem,
                                           dtype=torch.int32, device=device))
        soft = soft[0].cpu().numpy()
        bits = bits[0].cpu().numpy()
        outs = {k: v[0].cpu().numpy() for k, v in outs.items()}
        if args.invert:
            soft = -soft
            bits = 1 - bits
        if args.hardout:
            outfile.write(bits.astype(np.uint8).tobytes())
        else:
            outfile.write(soft.astype(np.float32).tobytes())
        outfile.flush()
        if tf_counter is not None:
            tf_counter.update(bits, stderr)
        total_in += x.shape[1]
        for b in range(nb):
            nblk += 1
            if args.stats and nblk % args.stats == 0:
                f_est = outs["f_est"][b]
                stats = {"EbNodB": round(float(outs["ebno_db"][b]), 2),
                         "ppm": round(float(outs["ppm"][b]), 2)}
                for mi in range(cfg.m):
                    stats[f"f{mi + 1}_est"] = round(float(f_est[mi]), 1)
                stderr.write(json.dumps(stats) + "\n")
                stderr.flush()
    if args.infile != "-":
        infile.close()
    if args.outfile != "-":
        outfile.close()
    return 0


def main(argv=None) -> int:
    return run(parse_args(argv))


if __name__ == "__main__":
    sys.exit(main())

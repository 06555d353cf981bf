"""Detector scoring harness: correlation scores vs Eb/N0 + noise FP rate.

The reference tracks detector health with test/dft_detect_scores.py
(correlation scores of dft_detect across samples, plus a noise-sample
set for false-positive checks — reference auto_rx/test/README.md:85).
This is that harness for the port's detector: per sonde type it
synthesizes a header burst at each Eb/N0, conditions it and runs the
detector's correlation (``detect.correlator.detect_types``) on a given
device, and logs the detection rate and mean score; a pure-noise set
measures false positives.  With ``--ref`` (and the reference tree that
``tests/oracle.py`` builds from) the identical IQ also runs through a
compiled ``dft_detect`` for an overlay.  ``--device`` (default ``cuda``):
where the conditioning and the correlation run; without a CUDA device
the CLI exits 1 unless ``--device cpu`` was asked for.

CLI::

    python -m radiosonde_auto_rx_tpu_torch.tools.detect_scores \
        --ebno 6:20:2 --trials 20 -o detect_scores_torch.csv --ref

CSV: ``type,chain,ebno_db,trials,detections,mean_score`` (the port's rows
labelled ``torch``)
(type=NOISE rows carry the false-positive count in ``detections``).
"""

import argparse
import subprocess
import sys

import numpy as np
import torch

from radiosonde_auto_rx_tpu_torch.demod.modulate import add_awgn, gfsk_mod
from radiosonde_auto_rx_tpu_torch.detect.templates import (TEMPLATES,
                                                     build_template_bank)
from radiosonde_auto_rx_tpu_torch.detect.correlator import detect_types

FS = 48000


def _condition(iq, device):
    """The detector's IQ front-end (IF lowpass -> FM -> audio lowpass),
    as in detect/scanner.py / tests/test_detect.py, on ``device``: the
    FM stream [T] float32 there."""
    from radiosonde_auto_rx_tpu_torch.ops.fm import fm_discriminate
    from radiosonde_auto_rx_tpu_torch.ops.fir import design_lowpass, fir_filter
    zi = torch.from_numpy(np.asarray(iq, np.complex64)).to(device)[None, :]
    h_if = design_lowpass(6e3 / FS, 97)
    zi = torch.complex(fir_filter(zi.real, h_if), fir_filter(zi.imag, h_if))
    fm = fm_discriminate(zi)
    h_fm = design_lowpass(4e3 / FS, 97)
    return fir_filter(fm, h_fm)[0]


def _burst(spec, rng, t_samples=FS):
    """One-second burst at a fixed sample count (the reference tool's, so
    that both score the same bursts)."""
    n_bits = int(np.ceil(t_samples / (FS / spec.sps))) + 4
    hdr = np.array([int(c) for c in spec.header])
    tail = max(0, n_bits - 600 - len(hdr))
    bits = np.concatenate([rng.integers(0, 2, 600), hdr,
                           rng.integers(0, 2, tail)])
    spacing = min(2 * spec.sps, 20000)
    iq = gfsk_mod(bits, FS, spec.sps, 2, 0.0, spacing, bt=spec.bt)
    return iq[:t_samples]


def _ref_detect(oracle, iq):
    binp = oracle.binary("dft_detect")
    if binp is None:
        return None
    r = subprocess.run(f"{binp} --iq - {FS} 32", shell=True,
                       input=iq.astype(np.complex64).tobytes(),
                       capture_output=True, cwd=oracle.BUILD)
    out = r.stdout.decode().strip()
    if ":" not in out:
        return "", 0.0
    name, score = out.split(":", 1)
    try:
        sc = abs(float(score.split(",")[0]))
    except ValueError:
        sc = 0.0
    return name.strip().lstrip("-"), sc


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--ebno", default="6:20:2")
    ap.add_argument("--trials", type=int, default=10)
    ap.add_argument("--types", default=None,
                    help="comma list (default: the narrowband IF class)")
    ap.add_argument("--ref", action="store_true")
    ap.add_argument("-o", "--output", default=None)
    ap.add_argument("--device", default="cuda",
                    help="torch device the detector runs on (default cuda)")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        print("detect_scores: no CUDA device (pass --device cpu to run on "
              "the CPU)", file=sys.stderr)
        return 1
    a, b, s = (float(v) for v in args.ebno.split(":"))
    ebnos = np.arange(a, b + s / 2, s)
    specs_all = TEMPLATES
    # IMETafsk is excluded by default: its preamble is Bell-202 AFSK on
    # an FM carrier, not GFSK, so this generator's burst doesn't apply
    # (neither chain detects it — the tone path is exercised by
    # tests/test_detect.py::test_imet_tone_disambiguation instead)
    names = (args.types.split(",") if args.types
             else [t.name for t in specs_all
                   if t.lp_iq == 1 and t.name != "IMETafsk"])
    bank, lens, specs = build_template_bank(FS)
    bank = torch.from_numpy(np.asarray(bank, np.float32)).to(device)
    oracle = None
    if args.ref:
        from radiosonde_auto_rx_tpu_torch.tools import repo_root
        sys.path.insert(0, repo_root())
        try:
            from tests import oracle as _o
            oracle = _o if _o.available() else None
        except ImportError:
            pass
    out = open(args.output, "w") if args.output else sys.stdout
    print("type,chain,ebno_db,trials,detections,mean_score", file=out,
          flush=True)
    for name in names:
        spec = next(t for t in specs_all if t.name == name)
        for eb in ebnos:
            det_n, scores, ref_n, ref_scores = 0, [], 0, []
            for k in range(args.trials):
                rng = np.random.default_rng(1000 * k + int(eb * 10))
                iq = add_awgn(_burst(spec, rng), float(eb), FS, spec.sps,
                              rng=rng)
                fm = _condition(iq, device)
                dets = detect_types(fm, bank, lens, specs, max_det=1)
                hit = [d for d in dets
                       if d.name.startswith(name[:4])]
                if hit:
                    det_n += 1
                    scores.append(hit[0].score)
                if oracle is not None:
                    rr = _ref_detect(oracle, iq)
                    if rr and rr[0].startswith(name[:4]):
                        ref_n += 1
                        ref_scores.append(rr[1])
            print(f"{name},torch,{eb:.1f},{args.trials},{det_n},"
                  f"{np.mean(scores) if scores else 0:.3f}", file=out,
                  flush=True)
            if oracle is not None:
                print(f"{name},ref,{eb:.1f},{args.trials},{ref_n},"
                      f"{np.mean(ref_scores) if ref_scores else 0:.3f}",
                      file=out, flush=True)
    # noise-only false-positive set
    fp = 0
    n_noise = max(20, 2 * args.trials)
    for k in range(n_noise):
        rng = np.random.default_rng(777 + k)
        noise = (rng.standard_normal(48000) + 1j *
                 rng.standard_normal(48000)).astype(np.complex64) * 0.3
        fm = _condition(noise, device)
        if detect_types(fm, bank, lens, specs, max_det=1):
            fp += 1
    print(f"NOISE,torch,0.0,{n_noise},{fp},0.000", file=out, flush=True)
    if args.output:
        out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())

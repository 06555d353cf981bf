"""Parallel host frame plane: a pool of decoder worker processes.

The demod emits bit/soft streams for hundreds of channels per capture
block in one device dispatch; turning those bits into telemetry is
host-side Python (frame sync, ECC, field extraction) and was previously
serial per channel — the system bottleneck well before the demod's
per-chip channel count (COMPONENTS.md known-gaps; VERDICT round 1 #6).

This plane is the TPU-native analogue of the reference's
process-per-sonde decoder isolation (reference auto_rx/autorx/decode.py
:1602-2002 runs one subprocess pipeline per active sonde): N worker
processes, each owning the *stateful* frame decoders (RS41 subframe
assembly, DFM serial confirmation, RS92 cal collection) for the
frequencies routed to it.  Routing is by stable frequency hash so a
sonde's decoder state always lives in the same worker.  The main
process keeps the light parts: telemetry enrichment, filtering and
exporter fan-out (station.py `_decode_frames` tail).

Workers are plain numpy processes — they never touch JAX or the TPU.
``workers=0`` (the default) keeps the fully inline single-process
behavior.
"""

import logging
import multiprocessing as mp
import os
import queue as queue_mod
import time
import traceback

from radiosonde_auto_rx_tpu_torch.utils import probe

log = logging.getLogger("frame_plane")


def _build_decoder(model_name: str, kwargs: dict):
    from radiosonde_auto_rx_tpu_torch.models import get_model
    return get_model(model_name)(**kwargs)


def _worker_main(inq, outq, w=0):
    """Worker loop: owns {freq -> (model_name, decoder)} state.  Each
    result carries the decode's timing: (worker ``w``, pid, start, end
    on ``time.time_ns()``, model, frames)."""
    decoders = {}
    while True:
        msg = inq.get()
        op = msg[0]
        if op == "stop":
            break
        if op == "drop":
            decoders.pop(msg[1], None)
            continue
        if op == "rekey":
            st = decoders.pop(msg[1], None)
            if st is not None:
                decoders[msg[2]] = st
            continue
        # ("decode", ticket, fz, model_name, kwargs, bits, soft)
        _, ticket, fz, model_name, kwargs, bits, soft = msg
        t0 = time.time_ns()
        try:
            st = decoders.get(fz)
            if st is None or st[0] != model_name:
                st = (model_name, _build_decoder(model_name, kwargs))
                decoders[fz] = st
            telems = st[1].decode_bits(bits, soft)
            err = None
        except Exception:
            telems, err = [], traceback.format_exc()
        outq.put((ticket, telems, err, (w, os.getpid(), t0, time.time_ns(),
                                        model_name, len(telems))))


class FramePlane:
    """Affinity-routed decoder pool.

    decode() enqueues one channel's bit stream and returns a ticket;
    gather() blocks until every outstanding ticket resolved and returns
    {ticket: telemetry_list}.  With ``workers=0`` decode() runs inline
    (identical semantics, zero processes).

    Each decode's timing (worker, pid, start and end ns, model, frames;
    worker None inline) rides beside its result: gather() counts it in
    ``decodes`` (a worker's decodes) and keeps it as a
    ``frame_plane.decode`` span while ``utils.probe`` records."""

    def __init__(self, workers: int = 0):
        self.workers = int(workers)
        self._decoders = {}          # inline mode state
        self._procs = []
        self._inqs = []
        self._outq = None
        self._pending = 0
        self._next_ticket = 0
        self._inline_results = {}
        self._ctx = {}               # ticket -> probe.context() at decode
        self.decodes = [0] * max(self.workers, 0)

    def _ensure_started(self):
        """Spawn the pool lazily on the first pooled decode: a station
        that never decodes (or is built just for scanning/tests) pays
        nothing for the default-parallel config."""
        if self._procs or self.workers <= 0:
            return
        # spawn re-imports __main__; an interpreter fed from stdin (or
        # an embedded one without a real main file) cannot do that — the
        # children would die with FileNotFoundError('<stdin>').  Fall
        # back to the inline plane rather than losing every frame.
        import __main__
        mf = getattr(__main__, "__file__", None)
        if mf is not None and not os.path.exists(mf):
            log.warning("frame plane: __main__ is %r (not spawnable) — "
                        "falling back to inline decode", mf)
            self.workers = 0
            return
        # spawn (not fork): the parent owns a live TPU client and
        # forked children must never inherit its handles.  Workers
        # import numpy-only decoder modules on startup.
        ctx = mp.get_context("spawn")
        self._outq = ctx.Queue()
        for w in range(self.workers):
            q = ctx.Queue()
            p = ctx.Process(target=_worker_main, args=(q, self._outq, w),
                            daemon=True)
            p.start()
            self._inqs.append(q)
            self._procs.append(p)
        log.info("frame plane: %d decoder workers started", self.workers)

    # ------------------------------------------------------------------ #

    def _route(self, fz: int) -> int:
        return int(fz) % self.workers

    def decode(self, fz: int, model_name: str, kwargs: dict,
               bits, soft) -> int:
        """Enqueue one channel's frame decode; returns a ticket."""
        ticket = self._next_ticket
        self._next_ticket += 1
        # start (or fall back) FIRST: _ensure_started may discover that
        # __main__ is not spawnable and set workers = 0 — the inline
        # branch below must then handle THIS decode, not a later one
        self._ensure_started()
        ctx = probe.context()
        if ctx is not None:
            self._ctx[ticket] = ctx
        if self.workers == 0:
            st = self._decoders.get(fz)
            if st is None or st[0] != model_name:
                st = (model_name, _build_decoder(model_name, kwargs))
                self._decoders[fz] = st
            t0 = time.time_ns()
            telems = st[1].decode_bits(bits, soft)
            self._inline_results[ticket] = (
                telems, (None, os.getpid(), t0, time.time_ns(), model_name,
                         len(telems)))
            return ticket
        w = self._route(fz)
        if not self._procs[w].is_alive():
            self._respawn_dead()
        self._inqs[w].put(
            ("decode", ticket, fz, model_name, kwargs, bits, soft))
        self._pending += 1
        return ticket

    def _respawn_dead(self):
        """Replace dead workers (OOM-kill / native segfault in a
        decoder): their queued tickets are lost — gather() logs the
        stall — but the plane keeps decoding instead of adding a full
        gather timeout to every subsequent capture cycle."""
        ctx = mp.get_context("spawn")
        for w, p in enumerate(self._procs):
            if not p.is_alive():
                log.error("frame plane worker %d died (exit %s) — "
                          "respawning", w, p.exitcode)
                q = ctx.Queue()
                np_ = ctx.Process(target=_worker_main,
                                  args=(q, self._outq, w), daemon=True)
                np_.start()
                self._inqs[w] = q
                self._procs[w] = np_

    def gather(self, timeout: float = 60.0) -> dict:
        """Resolve all outstanding tickets -> {ticket: telemetry list}.
        A worker traceback is logged and yields an empty list — one bad
        channel cannot take down the capture loop."""
        if self.workers == 0:
            done, self._inline_results = self._inline_results, {}
        else:
            with probe.span("frame_plane.gather", tickets=self._pending):
                done = self._gather_pool(timeout)
        for ticket, (_, tm) in done.items():
            if tm[0] is not None:
                self.decodes[tm[0]] += 1
            probe.add_span("frame_plane.decode", tm[2], tm[3],
                           self._ctx.get(ticket), tm[1], worker=tm[0],
                           model=tm[4], frames=tm[5])
        self._ctx = {}
        return {ticket: telems for ticket, (telems, _) in done.items()}

    def _gather_pool(self, timeout: float) -> dict:
        """{ticket: (telemetry, timing)} of every outstanding ticket."""
        out = {}
        while self._pending > 0:
            try:
                ticket, telems, err, tm = self._outq.get(timeout=timeout)
            except queue_mod.Empty:
                log.error("frame plane: %d tickets unresolved after %.0fs",
                          self._pending, timeout)
                # a dead/hung worker never resolves its tickets: write
                # them off (or every later cycle stalls the full
                # timeout) and replace any dead process
                self._pending = 0
                self._respawn_dead()
                break
            self._pending -= 1
            if err:
                log.error("frame plane worker error:\n%s", err)
            out[ticket] = (telems, tm)
        return out

    def drop(self, fz: int):
        """Evict a frequency's decoder state (channel reaped/blocked)."""
        if self.workers == 0:
            self._decoders.pop(fz, None)
        elif self._inqs:                 # pool not started: nothing held
            self._inqs[self._route(fz)].put(("drop", fz))

    def rekey(self, old_fz: int, new_fz: int):
        """Move a frequency's decoder state (drift retune): preserves
        accumulated decoder state (RS41 cal subframes, DFM serial
        confirmation) as the task frequency follows a drifting sonde."""
        if old_fz == new_fz:
            return
        if self.workers == 0:
            st = self._decoders.pop(old_fz, None)
            if st is not None:
                self._decoders[new_fz] = st
        elif self._inqs:
            if self._route(old_fz) == self._route(new_fz):
                self._inqs[self._route(old_fz)].put(
                    ("rekey", old_fz, new_fz))
            else:
                # the new key routes to a different worker: decoder
                # state cannot cross processes — drop it; stateless-by-
                # design decoders re-lock on the next block
                self._inqs[self._route(old_fz)].put(("drop", old_fz))

    def close(self):
        for q in self._inqs:
            try:
                q.put(("stop",))
            except Exception:
                pass
        for p in self._procs:
            p.join(timeout=5.0)
            if p.is_alive():
                p.terminate()
        self._procs, self._inqs = [], []

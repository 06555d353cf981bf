"""Parallel host frame plane: a pool of decoder worker processes.

The demod emits bit/soft streams for hundreds of channels per capture
block in one device dispatch; turning those bits into telemetry is
host-side Python (frame sync, ECC, field extraction) and was previously
serial per channel — the system bottleneck well before the demod's
per-chip channel count (COMPONENTS.md known-gaps; VERDICT round 1 #6).

This plane is the port's analogue of the reference's
process-per-sonde decoder isolation (reference auto_rx/autorx/decode.py
:1602-2002 runs one subprocess pipeline per active sonde): N worker
processes, each owning the *stateful* frame decoders (RS41 subframe
assembly, DFM serial confirmation, RS92 cal collection) of the tasks
placed on it.  A placement table in the main process, ``{fz: worker}``,
puts a task on the least-loaded worker at its first decode: a worker's
load is the sum of its tasks' costs, each an exponentially weighted mean
of the task's measured decode ms a gather (a task not yet measured costs
the mean of its model's measured tasks, else of all, else 1).  A task's
decoder state lives in its worker, and ``rekey`` and ``drop`` go there.
It changes worker only by an exact hand-over: once a gather has resolved
every ticket (the pool idle), one task a gather moves from the most
loaded worker to the least loaded one when that lowers the larger of the
two loads by a clear margin — the owner pickles the decoder out and
forgets it, the new worker takes it in.  The main process keeps the
light parts: telemetry enrichment, filtering and exporter fan-out
(station.py ``Station._decode_rows``, the station's one fan-out).

Workers are plain numpy processes: they import no torch and never touch
a device.  ``workers=0`` decodes inline in the calling process, with
the same decoder rules (``_decode``); the station's default,
``frame_plane_workers`` -1, sizes the pool from the CPU count.
"""

import logging
import multiprocessing as mp
import os
import pickle
import queue as queue_mod
import time
import traceback

from radiosonde_auto_rx_tpu_torch.utils import probe

log = logging.getLogger("frame_plane")

COST_ALPHA = 0.25    # a task's cost: its decode ms a gather, weighted over
                     # ~4 gathers (an RS41's cut frame cycles in 4 blocks)
MOVE_MARGIN = 0.1    # a move lowers the larger of the two loads by this share
MOVE_HOLD = 4        # gathers a moved task stays put


def _build_decoder(model_name: str, kwargs: dict):
    from radiosonde_auto_rx_tpu_torch.models import get_model
    return get_model(model_name)(**kwargs)


def _decode(decoders, msg, w):
    """One ``("decode", ticket, fz, name, model_name, kwargs, bits, soft)``
    against ``decoders``, ``{fz: (type name, decoder)}``: a task's decoder
    is rebuilt when its type changes, and a decoder's exception yields no
    telemetry and its traceback.  Returns (ticket, telemetry, traceback or
    None, timing): worker ``w``, pid, start, end on ``time.time_ns()``,
    model, frames."""
    _, ticket, fz, name, model_name, kwargs, bits, soft = msg
    t0 = time.time_ns()
    try:
        st = decoders.get(fz)
        if st is None or st[0] != name:
            st = (name, _build_decoder(model_name, kwargs))
            decoders[fz] = st
        telems = st[1].decode_bits(bits, soft)
        err = None
    except Exception:
        telems, err = [], traceback.format_exc()
    return ticket, telems, err, (w, os.getpid(), t0, time.time_ns(),
                                 model_name, len(telems))


def _worker_main(inq, outq, w=0):
    """Worker loop: owns {freq -> (type name, decoder)} state, decodes
    with ``_decode``.  ``export`` hands a task's state out pickled (and
    forgets it), ``import`` takes one in."""
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
        if op == "export":
            st = decoders.pop(msg[1], None)
            try:
                blob, err = pickle.dumps(st), None
            except Exception:
                if st is not None:
                    decoders[msg[1]] = st    # not handed over: kept here
                blob, err = None, traceback.format_exc()
            outq.put(("export", msg[1], blob, err))
            continue
        if op == "import":
            st = pickle.loads(msg[2])
            if st is not None:
                decoders[msg[1]] = st
            continue
        outq.put(_decode(decoders, msg, w))


class FramePlane:
    """Decoder pool with a placement table.

    decode() enqueues one channel's bit stream and returns a ticket;
    gather() blocks until every outstanding ticket resolved and returns
    {ticket: telemetry_list}.  With ``workers=0`` decode() runs inline
    (identical semantics, zero processes).  A task's decoder is keyed by
    its type name (``name``), built from its model (``model_name``).

    ``owner`` is the placement table, ``{fz: worker}``: a task is placed
    on the least-loaded worker at its first decode, and its state stays
    there until a hand-over at the end of a gather moves it (at most one
    task a gather, counted in ``moves`` and as ``pool_moves``).

    Each decode's timing (worker, pid, start and end ns, model, frames;
    worker None inline) rides beside its result: gather() counts it in
    ``decodes`` (a worker's decodes), adds it to its task's cost, and
    keeps it as a ``frame_plane.decode`` span while ``utils.probe``
    records."""

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
        self.owner = {}              # the placement table: fz -> worker
        self._model = {}             # fz -> model name of its last decode
        self._cost = {}              # fz -> decode ms a gather (weighted)
        self._hold = {}              # fz -> gathers before it may move
        self._fz_of = {}             # outstanding ticket -> fz
        self.moves = 0

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
        # spawn (not fork): the parent may hold a CUDA context and
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

    def _loads(self):
        """(load a worker, cost a task) from the placement table."""
        by_model, measured = {}, list(self._cost.values())
        for fz, c in self._cost.items():
            by_model.setdefault(self._model[fz], []).append(c)
        mean = {m: sum(v) / len(v) for m, v in by_model.items()}
        dflt = sum(measured) / len(measured) if measured else 1.0
        cost = {fz: self._cost.get(fz, mean.get(self._model.get(fz), dflt))
                for fz in self.owner}
        load = [0.0] * self.workers
        for fz, w in self.owner.items():
            load[w] += cost[fz]
        return load, cost

    def tasks(self) -> list:
        """Tasks a worker in the placement table."""
        n = [0] * self.workers
        for w in self.owner.values():
            n[w] += 1
        return n

    def decode(self, fz: int, name: str, model_name: str, kwargs: dict,
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
        msg = ("decode", ticket, fz, name, model_name, kwargs, bits, soft)
        if self.workers == 0:
            _, telems, err, tm = _decode(self._decoders, msg, None)
            if err:
                log.error("frame plane decode error:\n%s", err)
            self._inline_results[ticket] = (telems, tm)
            return ticket
        w = self.owner.get(fz)
        if w is None:
            load, _ = self._loads()
            w = self.owner[fz] = min(range(self.workers),
                                     key=lambda i: (load[i], i))
        self._model[fz] = model_name
        self._fz_of[ticket] = fz
        if not self._procs[w].is_alive():
            self._respawn_dead()
        self._inqs[w].put(msg)
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
                self._measure(done)
                if all(t in done for t in self._fz_of):
                    self._rebalance(timeout)     # the pool is idle
            self._fz_of = {}
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
            if ticket == "export":       # answered after its timeout
                continue
            self._pending -= 1
            if err:
                log.error("frame plane worker error:\n%s", err)
            out[ticket] = (telems, tm)
        return out

    def _measure(self, done: dict):
        """Adds each task's decode ms in this gather to its cost."""
        ms = {}
        for ticket, (_, tm) in done.items():
            fz = self._fz_of.get(ticket)
            if fz in self.owner:
                ms[fz] = ms.get(fz, 0.0) + (tm[3] - tm[2]) * 1e-6
        for fz, m in ms.items():
            c = self._cost.get(fz)
            self._cost[fz] = m if c is None else c + COST_ALPHA * (m - c)

    def _rebalance(self, timeout: float):
        """Moves one task from the most loaded worker to the least loaded
        one when that lowers the larger of the two loads by MOVE_MARGIN;
        only while no ticket is outstanding."""
        self._hold = {fz: n - 1 for fz, n in self._hold.items() if n > 1}
        load, cost = self._loads()
        src = max(range(self.workers), key=lambda i: (load[i], -i))
        dst = min(range(self.workers), key=lambda i: (load[i], i))
        best = None
        for fz, w in self.owner.items():
            if w == src and fz not in self._hold:
                top = max(load[src] - cost[fz], load[dst] + cost[fz])
                if best is None or top < best[0]:
                    best = (top, fz)
        if best is not None and best[0] < (1 - MOVE_MARGIN) * load[src]:
            self._hand_over(best[1], dst, timeout)

    def _hand_over(self, fz: int, dst: int, timeout: float = 60.0):
        """Moves task ``fz`` and its decoder state to worker ``dst``: the
        owner pickles the state out and forgets it, ``dst`` takes it in.
        Call only while no ticket is outstanding."""
        src = self.owner[fz]
        if not self._procs[src].is_alive():
            self._respawn_dead()         # its state is lost: nothing to move
            return
        self._inqs[src].put(("export", fz))
        while True:
            try:
                msg = self._outq.get(timeout=timeout)
            except queue_mod.Empty:
                log.error("frame plane: worker %d did not hand over %d "
                          "after %.0fs", src, fz, timeout)
                self._respawn_dead()
                return
            if msg[0] == "export":
                break
            # else a ticket an earlier gather wrote off: discard it
        _, _, blob, err = msg
        self._hold[fz] = MOVE_HOLD
        if err:
            log.error("frame plane: task %d stays on worker %d, its state "
                      "does not pickle:\n%s", fz, src, err)
            return
        self._inqs[dst].put(("import", fz, blob))
        self.owner[fz] = dst
        self.moves += 1
        probe.count("pool_moves")
        log.info("frame plane: task %.4f MHz moved from worker %d to %d",
                 fz / 1e6, src, dst)

    def drop(self, fz: int):
        """Evict a frequency's decoder state (channel reaped/blocked)."""
        if self.workers == 0:
            self._decoders.pop(fz, None)
            return
        w = self.owner.pop(fz, None)
        if w is not None:                # no entry: no worker holds it
            self._inqs[w].put(("drop", fz))
        for d in (self._model, self._cost, self._hold):
            d.pop(fz, None)

    def rekey(self, old_fz: int, new_fz: int):
        """Move a frequency's decoder state (drift retune): preserves
        accumulated decoder state (RS41 cal subframes, DFM serial
        confirmation) as the task frequency follows a drifting sonde.
        The table entry moves and the owner re-keys the state in place,
        wherever the new key lies."""
        if old_fz == new_fz:
            return
        if self.workers == 0:
            st = self._decoders.pop(old_fz, None)
            if st is not None:
                self._decoders[new_fz] = st
            return
        w = self.owner.pop(old_fz, None)
        if w is None:                    # no entry: no worker holds it
            return
        other = self.owner.get(new_fz)
        if other is not None and other != w:
            # the new key's old state is overwritten, as inline
            self._inqs[other].put(("drop", new_fz))
        self.owner[new_fz] = w
        self._inqs[w].put(("rekey", old_fz, new_fz))
        for d in (self._model, self._cost, self._hold):
            d.pop(new_fz, None)
            if old_fz in d:
                d[new_fz] = d.pop(old_fz)

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

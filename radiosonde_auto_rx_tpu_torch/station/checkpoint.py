"""Station checkpoint/resume.

The reference persists nothing across restarts by design — decoders
re-lock within seconds and durable state is append-only logs
(reference autorx/logger.py:210-222, SURVEY: checkpoint philosophy).
The TPU station keeps that philosophy but makes the *task state*
durable, so a restarted station resumes its channel assignments and
blocklists instantly instead of re-scanning from cold:

* active channel -> sonde-type assignments (decoder objects are NOT
  serialized — they are stateless by design and re-lock on the next
  block, like reference decoders after a restart)
* temporary frequency blocks with their expiry times
* web-control state (scanner enable, manual tasks)
* counters (frames_ok, detections, blocks processed)

Format: plain JSON, atomic replace.  Load tolerates a missing or
incompatible file (returns False) — a checkpoint must never be able to
keep a station from starting.
"""

import json
import logging
import os
import tempfile
import time

log = logging.getLogger("checkpoint")

# v2: task state keyed by absolute frequency (Hz) instead of channel
# index, so checkpoints survive band-plan retunes
FORMAT_VERSION = 2


def save_station_state(station, path: str) -> str:
    """Atomically write the station's resumable state to ``path``."""
    state = {
        "version": FORMAT_VERSION,
        "saved_at": time.time(),
        "center_freq": station.center_freq,
        "active": {str(ci): st["type"] for ci, st in station.active.items()},
        "last_ok": {str(ci): st["last_ok"]
                    for ci, st in station.active.items()},
        "temporary_blocks": {f"{f:.1f}": until for f, until
                             in station.temporary_blocks.items()},
        "manual_tasks": {str(ci): t for ci, t
                         in station.manual_tasks.items()},
        "scan_enabled": station.scan_enabled,
        "stats": dict(station.stats),
    }
    d = os.path.dirname(os.path.abspath(path)) or "."
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".ckpt")
    try:
        with os.fdopen(fd, "w") as f:
            json.dump(state, f, indent=1)
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise
    return path


def load_station_state(station, path: str) -> bool:
    """Restore task state saved by ``save_station_state``.

    Returns True on success.  Expired temporary blocks are dropped;
    decoders rebuild lazily on the next decode call."""
    try:
        with open(path) as f:
            state = json.load(f)
    except (OSError, ValueError) as e:
        log.warning("no usable checkpoint at %s: %s", path, e)
        return False
    if state.get("version") != FORMAT_VERSION:
        log.warning("checkpoint version %s unsupported",
                    state.get("version"))
        return False
    now = time.time()
    station.temporary_blocks = {
        float(f): until for f, until in state["temporary_blocks"].items()
        if until > now}
    station.manual_tasks = {int(ci): t for ci, t
                            in state["manual_tasks"].items()}
    station.scan_enabled = bool(state.get("scan_enabled", True))
    station.stats.update(state.get("stats", {}))
    last_ok = state.get("last_ok", {})
    station.active = {
        int(ci): dict(type=t, decoder=None,
                      last_ok=float(last_ok.get(ci, now)))
        for ci, t in state["active"].items()}
    log.info("resumed %d active channels, %d blocks, %d manual tasks",
             len(station.active), len(station.temporary_blocks),
             len(station.manual_tasks))
    return True

"""Black-box debug bundles — "what was the process doing" snapshots.

Counterpart of ``bigdl_tpu/obs/bundle.py``: the same file set, manifest
and publish order, so either package's ``verify_bundle`` and
``inventory`` read the other's bundles.  A bundle is one directory capturing everything the obs stack knows at
the moment of trouble, so a postmortem never depends on the process
surviving long enough for a human to attach tools:

=================  ====================================================
``ring.json``      the flight-recorder ring (tracer ``recent()``)
``metrics.json``   a full metrics-registry snapshot
``profile.json``   the continuous profiler's folded profile (prof.py)
``reqtraces.json`` every kept request trace in the reqtrace ring
``runtime.json``   step-time percentiles, host RSS and the card's
                   memory stats (the CUDA caching allocator's)
``alerts.json``    currently-firing alerts + the triggering transition
``MANIFEST.json``  sha256 + size per file, written LAST
=================  ====================================================

Torn-write safety follows the checkpoint manifests of
``utils/serializer.py``: every file is written and fsynced inside a
``<name>.tmp`` staging directory, the manifest is written last (its
presence certifies the files it names were durable first), and one
``os.replace`` publishes the directory — a crash at ANY point leaves
either a complete bundle or a ``.tmp`` leftover that
:func:`verify_bundle` rejects and the report inventory skips.

Bundles are produced on alert ``firing`` transitions (exactly one per
(engine, rule, episode), per-rule rate-limited by
``BIGDL_TORCH_BUNDLE_RATE_LIMIT``), by the restart supervisor around
hang/crash handling, and on demand via ``GET /debugz``.  Everything is
gated on ``BIGDL_TORCH_BUNDLE_DIR``: unset, the automatic triggers are one
config read and no disk is ever touched.
"""

from __future__ import annotations

import hashlib
import json
import logging
import os
import threading
import time
from typing import List, Optional, Tuple

from bigdl_tpu_torch.obs import names

log = logging.getLogger("bigdl_tpu_torch.obs")

MANIFEST = "MANIFEST.json"
#: bundle payload files, in write order (the manifest is written last)
BUNDLE_FILES = ("ring.json", "metrics.json", "profile.json",
                "reqtraces.json", "runtime.json", "alerts.json")

_lock = threading.Lock()
_seq = 0
# (engine_uid, rule, episode) already bundled — the exactly-once set
_seen: set = set()
# (engine_uid, rule) -> wall time of its newest bundle (rate limiting)
_last_rule: dict = {}


def _sha256(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as fh:
        for chunk in iter(lambda: fh.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def _fsync_dir(path: str):
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _write_json(directory: str, name: str, payload) -> dict:
    path = os.path.join(directory, name)
    with open(path, "w", encoding="utf-8") as fh:
        json.dump(payload, fh, default=str)
        fh.flush()
        os.fsync(fh.fileno())
    return {"size": os.path.getsize(path), "sha256": _sha256(path)}


def _payloads(reason: str, trigger: str, context: Optional[dict]) -> dict:
    """Collect every snapshot the bundle carries.  Each source is
    isolated: one failing provider costs its own file's content (an
    ``{"error": ...}`` stub), never the bundle."""
    from bigdl_tpu_torch import obs
    from bigdl_tpu_torch.obs import alerts, prof, reqtrace

    sources = {
        "ring.json": lambda: obs.get_tracer().recent(),
        "metrics.json": lambda: obs.get_registry().snapshot(),
        "profile.json": lambda: prof.get_profiler().snapshot(),
        "reqtraces.json": lambda: reqtrace.get_collector().completed(),
        "runtime.json": lambda: obs.get_runtime().snapshot(),
        "alerts.json": lambda: {"active": alerts.get_engine().active(),
                                "reason": reason, "trigger": trigger,
                                "transition": context},
    }
    out = {}
    for fname, thunk in sources.items():
        try:
            out[fname] = thunk()
        except Exception as e:  # noqa: BLE001 — isolate provider failures
            log.exception("obs.bundle: %s provider failed", fname)
            out[fname] = {"error": f"{type(e).__name__}: {e}"}
    return out


def build_bundle(reason: str = "", trigger: str = "manual",
                 bundle_dir: Optional[str] = None,
                 context: Optional[dict] = None) -> str:
    """Write one bundle under ``bundle_dir`` (default
    ``BIGDL_TORCH_BUNDLE_DIR``) and return its final directory path.

    Raises on hard failure (no directory configured, disk errors) —
    the automatic triggers wrap this; counted either way in
    ``bigdl_bundle_writes_total`` / ``bigdl_bundle_errors_total``."""
    global _seq
    from bigdl_tpu_torch import obs

    if bundle_dir is None:
        from bigdl_tpu_torch.config import refresh_from_env

        bundle_dir = refresh_from_env().obs.bundle_dir
    if not bundle_dir:
        raise ValueError("no bundle directory: pass bundle_dir or set "
                         "BIGDL_TORCH_BUNDLE_DIR")
    reg = obs.get_registry()
    try:
        from bigdl_tpu_torch.obs.trace import _host_id

        host = _host_id()
        with _lock:
            _seq += 1
            seq = _seq
        now = time.time()
        stamp = time.strftime("%Y%m%d-%H%M%S", time.gmtime(now))
        name = (f"bundle-{stamp}-h{host}-p{os.getpid()}"
                f"-{trigger}-{seq}")
        final = os.path.join(bundle_dir, name)
        tmp = final + ".tmp"
        os.makedirs(tmp, exist_ok=True)
        files = {}
        for fname, payload in _payloads(reason, trigger,
                                        context).items():
            files[fname] = _write_json(tmp, fname, payload)
        # manifest LAST: its presence certifies every file it names
        # was already durable when it was written
        _write_json(tmp, MANIFEST, {
            "format": 1, "reason": reason, "trigger": trigger,
            "ts": now, "host": host, "pid": os.getpid(),
            "files": files})
        os.replace(tmp, final)
        _fsync_dir(bundle_dir)
    except Exception:
        reg.counter(names.BUNDLE_ERRORS_TOTAL,
                    "Debug-bundle builds that failed").inc()
        raise
    reg.counter(names.BUNDLE_WRITES_TOTAL,
                "Debug bundles written, by trigger",
                labels=("trigger",)).labels(trigger=trigger).inc()
    reg.gauge(names.BUNDLE_LAST_WRITE_SECONDS,
              "Wall-clock timestamp of the newest debug bundle").set(now)
    log.warning("obs.bundle: wrote %s (%s)", final,
                reason or trigger)
    return final


# ----------------------------------------------------------- triggers
def on_alert_firing(transition: dict,
                    engine_uid: int = 0) -> Optional[str]:
    """The alert-engine hook: bundle exactly once per (engine, rule,
    episode), per-rule rate-limited, only when ``BIGDL_TORCH_BUNDLE_DIR`` is
    set.  Returns the bundle path, or None when gated off/deduped."""
    from bigdl_tpu_torch.config import refresh_from_env

    cfg = refresh_from_env().obs
    if not cfg.bundle_dir:
        return None
    rule = transition.get("rule")
    key = (engine_uid, rule, transition.get("episode"))
    now = time.time()
    with _lock:
        if key in _seen:
            return None
        last = _last_rule.get((engine_uid, rule))
        if cfg.bundle_rate_limit > 0 and last is not None \
                and now - last < cfg.bundle_rate_limit:
            log.info("obs.bundle: rate limit — no bundle for %s "
                     "episode %s (%.1fs since the rule's last, "
                     "limit %.1fs)", rule, transition.get("episode"),
                     now - last, cfg.bundle_rate_limit)
            return None
        # claim BEFORE the (slow) build: a second transition for the
        # same episode racing in never double-bundles
        _seen.add(key)
        _last_rule[(engine_uid, rule)] = now
    return build_bundle(
        reason=f"alert {rule} episode {transition.get('episode')}",
        trigger="alert", bundle_dir=cfg.bundle_dir, context=transition)


def reset():
    """Test hook: forget episode dedupe + rate-limit state."""
    global _seq
    with _lock:
        _seen.clear()
        _last_rule.clear()
        _seq = 0


# --------------------------------------------------------- inspection
def verify_bundle(path: str) -> Tuple[bool, str]:
    """``(ok, reason)`` — the checkpoint-manifest hardening applied to
    bundles: unreadable/missing manifest, a missing file, or a
    size/sha256 mismatch all fail; a ``.tmp`` directory is an
    interrupted write by construction."""
    if path.rstrip(os.sep).endswith(".tmp"):
        return False, "interrupted write (.tmp staging dir)"
    mpath = os.path.join(path, MANIFEST)
    if not os.path.isfile(mpath):
        return False, "no manifest"
    try:
        with open(mpath, encoding="utf-8") as fh:
            manifest = json.load(fh)
    except (OSError, ValueError) as e:
        return False, f"unreadable manifest: {e}"
    files = manifest.get("files")
    if not isinstance(files, dict) or not files:
        return False, "manifest names no files"
    for fname, meta in files.items():
        fpath = os.path.join(path, fname)
        if not os.path.isfile(fpath):
            return False, f"missing {fname}"
        size = os.path.getsize(fpath)
        if size != int(meta.get("size", -1)):
            return False, (f"{fname}: size {size} != manifest "
                           f"{meta.get('size')}")
        digest = _sha256(fpath)
        if digest != meta.get("sha256"):
            return False, f"{fname}: sha256 mismatch"
    return True, f"{len(files)} files verified"


def inventory(bundle_dir: Optional[str] = None) -> List[dict]:
    """Every bundle under ``bundle_dir`` (default ``BIGDL_TORCH_BUNDLE_DIR``),
    newest last, each verified — invalid/torn entries are flagged so
    the report can show *and skip* them."""
    if bundle_dir is None:
        from bigdl_tpu_torch.config import refresh_from_env

        bundle_dir = refresh_from_env().obs.bundle_dir
    if not bundle_dir or not os.path.isdir(bundle_dir):
        return []
    out = []
    for entry in sorted(os.listdir(bundle_dir)):
        if not entry.startswith("bundle-"):
            continue
        path = os.path.join(bundle_dir, entry)
        if not os.path.isdir(path):
            continue
        ok, why = verify_bundle(path)
        rec = {"name": entry, "path": path, "ok": ok, "reason": why,
               "trigger": None, "ts": None, "bytes": 0}
        if ok:
            try:
                with open(os.path.join(path, MANIFEST),
                          encoding="utf-8") as fh:
                    manifest = json.load(fh)
                rec["trigger"] = manifest.get("trigger")
                rec["ts"] = manifest.get("ts")
                rec["bundle_reason"] = manifest.get("reason")
                rec["bytes"] = sum(
                    int(m.get("size", 0))
                    for m in manifest.get("files", {}).values())
            except (OSError, ValueError):  # verified then torn: raced
                rec["ok"], rec["reason"] = False, "manifest vanished"
        out.append(rec)
    return out


__all__ = ["MANIFEST", "BUNDLE_FILES", "build_bundle", "on_alert_firing",
           "reset", "verify_bundle", "inventory"]

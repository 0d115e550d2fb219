"""LoggerFilter: chatty libraries to a file, the port's own logs on the
console.

Counterpart of ``bigdl_tpu/utils/logger_filter.py`` (the reference's
``LoggerFilter.redirectSparkInfoLogs``).  The chatty default names the
port's own stack (``torch`` and its distributed, compiler and profiler
loggers) where JAX names ``jax`` and ``absl``; the rest is JAX's:
``BIGDL_TORCH_DISABLE_LOGGER`` skips everything, ``BIGDL_TORCH_LOG_PATH``
(or ``log_path``) moves the file, whose default is a per-user file in
the system temp directory (never the working directory), and a second
call replaces the handlers of the first instead of stacking new ones.
"""

from __future__ import annotations

import logging
import os
from typing import Optional, Sequence

_DEFAULT_CHATTY = ("torch", "torch.distributed", "torch._dynamo",
                   "torch._inductor", "torch.profiler")
_MARK = "_bigdl_tpu_torch_logger_filter"
_FORMAT = "%(asctime)s %(levelname)s %(name)s: %(message)s"


def _default_log_path() -> str:
    """``bigdl-torch-<user>.log`` in the temp directory: a fixed name in
    a shared directory would collide across users."""
    import getpass
    import tempfile

    try:
        user = getpass.getuser()
    except (KeyError, OSError):
        user = str(os.getuid()) if hasattr(os, "getuid") else "user"
    return os.path.join(tempfile.gettempdir(), f"bigdl-torch-{user}.log")


def redirect_spark_info_logs(
    log_path: Optional[str] = None,
    chatty: Sequence[str] = _DEFAULT_CHATTY,
    keep: Sequence[str] = ("bigdl_tpu_torch",),
):
    """Each ``chatty`` logger writes INFO and up to the file and only
    warnings to the console, and stops propagating; each ``keep``
    logger logs INFO to the console (a handler is added only where it
    has none)."""
    from bigdl_tpu_torch.config import HostConfig

    cfg = HostConfig.from_env()
    if cfg.disable_logger:
        return
    log_path = log_path or cfg.log_path or _default_log_path()
    fmt = logging.Formatter(_FORMAT)
    file_handler = logging.FileHandler(log_path)
    file_handler.setLevel(logging.INFO)
    file_handler.setFormatter(fmt)
    setattr(file_handler, _MARK, True)
    stale = []          # a previous call's handlers, closed once detached
    for name in chatty:
        lg = logging.getLogger(name)
        for h in list(lg.handlers):
            if getattr(h, _MARK, False):
                lg.removeHandler(h)
                stale.append(h)
        lg.addHandler(file_handler)
        lg.setLevel(logging.INFO)
        lg.propagate = False
        console = logging.StreamHandler()
        console.setLevel(logging.WARNING)
        console.setFormatter(fmt)
        setattr(console, _MARK, True)
        lg.addHandler(console)
    # close only the handlers no logger holds any more (a previous call
    # may have put them on loggers outside this call's chatty list)
    manager = logging.Logger.manager
    attached = {id(h) for lg in [manager.root] + list(
        manager.loggerDict.values()) for h in getattr(lg, "handlers", ())}
    for h in {id(h): h for h in stale}.values():
        if id(h) not in attached:
            h.close()
    for name in keep:
        lg = logging.getLogger(name)
        lg.setLevel(logging.INFO)
        if not lg.handlers:
            h = logging.StreamHandler()
            h.setFormatter(logging.Formatter(_FORMAT))
            lg.addHandler(h)


class LoggerFilter:
    """The reference's spelling."""

    redirectSparkInfoLogs = staticmethod(redirect_spark_info_logs)
    redirect_spark_info_logs = staticmethod(redirect_spark_info_logs)


__all__ = ["redirect_spark_info_logs", "LoggerFilter"]

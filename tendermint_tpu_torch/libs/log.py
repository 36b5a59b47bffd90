"""Structured leveled logging with per-module filtering: the port's copy of
tendermint_tpu/libs/log.py (reference: libs/log/tm_logger.go,
libs/log/filter.go), built on stdlib logging.
"""

from __future__ import annotations

import logging
import sys
from typing import Optional

_FORMAT = "%(asctime)s %(levelname).1s %(name)s: %(message)s"


def setup(level: str = "info", module_levels: Optional[dict[str, str]] = None) -> None:
    """Configure root logging. `module_levels` mirrors the reference's
    ``log_level = "state:info,*:error"`` syntax (config/config.go BaseConfig)."""
    module_levels = dict(module_levels or {})
    default = module_levels.pop("*", level)
    logging.basicConfig(
        level=getattr(logging, default.upper(), logging.INFO),
        format=_FORMAT,
        stream=sys.stderr,
        force=True,
    )
    for mod, lvl in module_levels.items():
        logging.getLogger(mod).setLevel(getattr(logging, lvl.upper(), logging.INFO))


def parse_log_level(spec: str, default: str = "info") -> dict[str, str]:
    """Parse ``"state:info,consensus:debug,*:error"`` into module levels."""
    out: dict[str, str] = {}
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        if ":" in part:
            mod, lvl = part.split(":", 1)
            out[mod] = lvl
        else:
            out["*"] = part
    out.setdefault("*", default)
    return out


def get(name: str) -> logging.Logger:
    return logging.getLogger(name)


class TMLogger:
    """Structured key=value logger, reference tmfmt style:
    ``log.info("executed block", height=5, num_txs=2)``.
    `with_(**kv)` binds context keys (reference log.With)."""

    __slots__ = ("_l", "_ctx")

    def __init__(self, logger: logging.Logger, ctx: Optional[dict] = None):
        self._l = logger
        self._ctx = ctx or {}

    def with_(self, **kv) -> "TMLogger":
        return TMLogger(self._l, {**self._ctx, **kv})

    def _fmt(self, msg: str, kv: dict) -> str:
        pairs = {**self._ctx, **kv}
        if not pairs:
            return msg
        return msg + " " + " ".join(f"{k}={v}" for k, v in pairs.items())

    def debug(self, msg: str, **kv) -> None:
        self._l.debug(self._fmt(msg, kv))

    def info(self, msg: str, **kv) -> None:
        self._l.info(self._fmt(msg, kv))

    def warn(self, msg: str, **kv) -> None:
        self._l.warning(self._fmt(msg, kv))

    def error(self, msg: str, **kv) -> None:
        self._l.error(self._fmt(msg, kv))


def get_logger(name: str) -> TMLogger:
    return TMLogger(logging.getLogger(name))

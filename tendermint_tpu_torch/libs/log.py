"""Structured key=value logging: the port's copy of get_logger from
tendermint_tpu/libs/log.py (reference: libs/log/tm_logger.go), built on
stdlib logging.
"""

from __future__ import annotations

import logging
from typing import Optional


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

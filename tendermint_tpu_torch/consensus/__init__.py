"""Consensus: the ABCI handshake (Handshaker) so far.  The state machine,
its WAL, the timeout ticker and the WAL catchup replay are not ported yet
(ROADMAP 1.5)."""

from .replay import Handshaker

__all__ = ["Handshaker"]

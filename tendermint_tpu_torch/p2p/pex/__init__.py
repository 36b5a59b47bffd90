"""Peer exchange and the address book (the port's copy of
tendermint_tpu/p2p/pex/)."""

from .addrbook import AddrBook, KnownAddress
from .pex_reactor import PEX_CHANNEL, PEXReactor

__all__ = ["AddrBook", "KnownAddress", "PEXReactor", "PEX_CHANNEL"]

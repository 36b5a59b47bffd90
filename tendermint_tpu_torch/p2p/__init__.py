"""P2P networking: authenticated encrypted multiplexed peer connections (the
port's copy of tendermint_tpu/p2p/, with the fuzz layer of chaos/link.py).

Counterpart of the reference `p2p/` tree: Switch, Peer, Transport,
SecretConnection, MConnection, NodeInfo/NodeKey, PEX with the address book
and the trust metric, in-process test helpers.
"""

from .key import NodeKey, node_id_from_pubkey
from .node_info import NodeInfo
from .conn.secret_connection import SecretConnection
from .conn.connection import ChannelDescriptor, LocalFault, MConnection
from .base_reactor import Reactor
from .peer import Peer
from .transport import Transport
from .switch import Switch
from .pex import AddrBook, PEXReactor

__all__ = [
    "AddrBook",
    "ChannelDescriptor",
    "LocalFault",
    "MConnection",
    "NodeInfo",
    "NodeKey",
    "PEXReactor",
    "Peer",
    "Reactor",
    "SecretConnection",
    "Switch",
    "Transport",
    "node_id_from_pubkey",
]

"""Peer-to-peer: only the node identity key so far (the port's copy of
tendermint_tpu/p2p/key.py).  The switch, transport, secret connection and
reactors are ROADMAP 1.7."""

from .key import NodeKey, node_id_from_pubkey

__all__ = ["NodeKey", "node_id_from_pubkey"]

"""NodeInfo: identity + capability advertisement exchanged at handshake (the
port's copy of tendermint_tpu/p2p/node_info.py).

Reference parity: p2p/node_info.go (DefaultNodeInfo:85,
CompatibleWith:171 — same block protocol, same network, at least one
common channel).
"""

from __future__ import annotations

from dataclasses import dataclass

from ..version import BLOCK_PROTOCOL, P2P_PROTOCOL, SOFTWARE_VERSION

MAX_NUM_CHANNELS = 16

# Consensus-gossip capability level advertised in NodeInfo.  0 = legacy
# single-vote gossip (and what a peer whose handshake dict predates the
# field resolves to, via from_dict's unknown-field tolerance); 1 = the
# peer decodes byte-capped `vote_batch` frames on the VOTE channel; 2 =
# the peer additionally speaks the maj23 aggregation exchange
# (`vote_summary` on STATE, `vote_pull` on VOTE_SET_BITS) used by the
# degree-bounded relay topology at committee scale; 3 = the peer decodes
# optional wire-level trace context (origin node id / origin wall ns /
# hop count riding as extra keys on `vote` / `vote_batch` /
# `vote_summary` / `block_part` / `proposal` / `agg_commit` frames) and
# emits `gossip.hop` recorder events from it.  Capabilities are
# cumulative: a v2 peer accepts everything a v1 peer does, and frames to
# a peer below a level simply omit that level's fields.
GOSSIP_BATCH_VERSION = 1
GOSSIP_SUMMARY_VERSION = 2
GOSSIP_TRACE_VERSION = 3


@dataclass
class NodeInfo:
    node_id: str = ""
    listen_addr: str = ""
    network: str = ""  # chain id
    software_version: str = SOFTWARE_VERSION
    p2p_version: int = P2P_PROTOCOL
    block_version: int = BLOCK_PROTOCOL
    channels: bytes = b""
    moniker: str = "node"
    tx_index: str = "on"
    rpc_address: str = ""
    # Deliberately defaults to 0 (legacy): a NodeInfo deserialized from an
    # older peer lacks the field entirely, and the conservative default is
    # what keeps mixed-version nets converging.  The node assembly sets it
    # to GOSSIP_BATCH_VERSION when consensus.gossip_vote_batch is on.
    gossip_version: int = 0

    def validate_basic(self) -> None:
        if not self.node_id:
            raise ValueError("empty node id")
        # wire field, attacker-suppliable: a non-int here would TypeError
        # inside the gossip routines' capability comparison and kill them
        if not isinstance(self.gossip_version, int) or isinstance(self.gossip_version, bool):
            raise ValueError("gossip_version must be an integer")
        if len(self.channels) > MAX_NUM_CHANNELS:
            raise ValueError(f"too many channels: {len(self.channels)}")
        if len(set(self.channels)) != len(self.channels):
            raise ValueError("duplicate channel ids")

    def compatible_with(self, other: "NodeInfo") -> None:
        """node_info.go:171 — raises on incompatibility."""
        if self.block_version != other.block_version:
            raise ValueError(
                f"peer has different block version: {other.block_version} vs {self.block_version}"
            )
        if self.network != other.network:
            raise ValueError(f"peer is on another network: {other.network} vs {self.network}")
        if not set(self.channels) & set(other.channels):
            raise ValueError("no common channels with peer")

    def to_dict(self) -> dict:
        return {
            "node_id": self.node_id,
            "listen_addr": self.listen_addr,
            "network": self.network,
            "software_version": self.software_version,
            "p2p_version": self.p2p_version,
            "block_version": self.block_version,
            "channels": self.channels,
            "moniker": self.moniker,
            "tx_index": self.tx_index,
            "rpc_address": self.rpc_address,
            "gossip_version": self.gossip_version,
        }

    @classmethod
    def from_dict(cls, d: dict) -> "NodeInfo":
        # ignore unknown fields so newer peers with extra NodeInfo fields
        # still handshake (rolling-upgrade compatibility)
        import dataclasses

        names = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in names})

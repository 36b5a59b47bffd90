"""ABCI request/response types + Application interface (the port's copy
of tendermint_tpu/abci/types.py).

Reference parity: abci/types/types.proto (12-method Request/Response
oneof), abci/types/application.go (Application:11, BaseApplication:34).
Messages are dataclasses carried over the wire as tagged msgpack maps
instead of protobuf — same field surface, no codegen.
"""

from __future__ import annotations

from abc import ABC
from dataclasses import asdict, dataclass, field
from typing import List, Optional

CODE_TYPE_OK = 0


class CheckTxType:
    NEW = 0
    RECHECK = 1


@dataclass
class Event:
    """abci Event: type + key/value attributes (libs/kv KVPair)."""

    type: str = ""
    attributes: List[dict] = field(default_factory=list)  # {"key": bytes, "value": bytes}


@dataclass
class ValidatorUpdate:
    pub_key_type: str = "ed25519"
    pub_key: bytes = b""
    power: int = 0
    # BLS12-381 keys entering a live set MUST carry a proof of possession:
    # FastAggregateVerify is rogue-key-sound only over PoP-checked keys, and
    # genesis's PoP gate (types/genesis.py) doesn't see ABCI-driven joins.
    # Ignored (and must be empty) for non-BLS key types.
    pop: bytes = b""


@dataclass
class LastCommitInfo:
    round: int = 0
    votes: List[dict] = field(default_factory=list)  # {"address", "power", "signed_last_block"}


@dataclass
class Snapshot:
    """An application state snapshot offered for state sync
    (abci/types/types.proto Snapshot).  `metadata` is opaque to the node
    core; the example kvstore app stores its chunk-hash list there so both
    the syncer and the restoring app can verify chunks by hash."""

    height: int = 0
    format: int = 0
    chunks: int = 0
    hash: bytes = b""
    metadata: bytes = b""


class OfferSnapshotResult:
    """ResponseOfferSnapshot.Result (types.proto)."""

    UNKNOWN = 0
    ACCEPT = 1  # apply this snapshot
    ABORT = 2  # abort all snapshot restoration
    REJECT = 3  # reject this snapshot, try others
    REJECT_FORMAT = 4  # reject this format, try other formats
    REJECT_SENDER = 5  # reject all snapshots from these senders


class ApplySnapshotChunkResult:
    """ResponseApplySnapshotChunk.Result (types.proto)."""

    UNKNOWN = 0
    ACCEPT = 1  # chunk applied
    ABORT = 2  # abort all snapshot restoration
    RETRY = 3  # refetch + reapply this chunk
    RETRY_SNAPSHOT = 4  # restart this snapshot from scratch
    REJECT_SNAPSHOT = 5  # reject this snapshot, try others


# -- requests ---------------------------------------------------------------


@dataclass
class RequestEcho:
    message: str = ""


@dataclass
class RequestFlush:
    pass


@dataclass
class RequestInfo:
    version: str = ""
    block_version: int = 0
    p2p_version: int = 0


@dataclass
class RequestSetOption:
    key: str = ""
    value: str = ""


@dataclass
class RequestInitChain:
    time_ns: int = 0
    chain_id: str = ""
    consensus_params: Optional[dict] = None
    validators: List[ValidatorUpdate] = field(default_factory=list)
    app_state_bytes: bytes = b""


@dataclass
class RequestQuery:
    data: bytes = b""
    path: str = ""
    height: int = 0
    prove: bool = False


@dataclass
class RequestBeginBlock:
    hash: bytes = b""
    header: Optional[dict] = None
    last_commit_info: LastCommitInfo = field(default_factory=LastCommitInfo)
    byzantine_validators: List[dict] = field(default_factory=list)


@dataclass
class RequestCheckTx:
    tx: bytes = b""
    type: int = CheckTxType.NEW


@dataclass
class RequestDeliverTx:
    tx: bytes = b""


@dataclass
class RequestEndBlock:
    height: int = 0


@dataclass
class RequestCommit:
    pass


@dataclass
class RequestListSnapshots:
    pass


@dataclass
class RequestOfferSnapshot:
    snapshot: Optional[Snapshot] = None
    app_hash: bytes = b""  # light-client-verified app hash at snapshot height


@dataclass
class RequestLoadSnapshotChunk:
    height: int = 0
    format: int = 0
    chunk: int = 0  # chunk index


@dataclass
class RequestApplySnapshotChunk:
    index: int = 0
    chunk: bytes = b""
    sender: str = ""  # p2p id of the peer that served the chunk


# -- responses --------------------------------------------------------------


@dataclass
class ResponseException:
    error: str = ""


@dataclass
class ResponseEcho:
    message: str = ""


@dataclass
class ResponseFlush:
    pass


@dataclass
class ResponseInfo:
    data: str = ""
    version: str = ""
    app_version: int = 0
    last_block_height: int = 0
    last_block_app_hash: bytes = b""


@dataclass
class ResponseSetOption:
    code: int = CODE_TYPE_OK
    log: str = ""
    info: str = ""


@dataclass
class ResponseInitChain:
    consensus_params: Optional[dict] = None
    validators: List[ValidatorUpdate] = field(default_factory=list)


@dataclass
class ResponseQuery:
    code: int = CODE_TYPE_OK
    log: str = ""
    info: str = ""
    index: int = 0
    key: bytes = b""
    value: bytes = b""
    proof: Optional[dict] = None
    height: int = 0
    codespace: str = ""

    @property
    def is_ok(self) -> bool:
        return self.code == CODE_TYPE_OK


@dataclass
class ResponseBeginBlock:
    events: List[Event] = field(default_factory=list)


@dataclass
class ResponseCheckTx:
    code: int = CODE_TYPE_OK
    data: bytes = b""
    log: str = ""
    info: str = ""
    gas_wanted: int = 0
    gas_used: int = 0
    events: List[Event] = field(default_factory=list)
    codespace: str = ""
    # QoS rank for the priority mempool (the v0.35 direction): higher
    # reaps first and survives eviction longer; 0 = FIFO default
    priority: int = 0

    @property
    def is_ok(self) -> bool:
        return self.code == CODE_TYPE_OK


@dataclass
class ResponseDeliverTx:
    code: int = CODE_TYPE_OK
    data: bytes = b""
    log: str = ""
    info: str = ""
    gas_wanted: int = 0
    gas_used: int = 0
    events: List[Event] = field(default_factory=list)
    codespace: str = ""

    @property
    def is_ok(self) -> bool:
        return self.code == CODE_TYPE_OK


@dataclass
class ResponseEndBlock:
    validator_updates: List[ValidatorUpdate] = field(default_factory=list)
    consensus_param_updates: Optional[dict] = None
    events: List[Event] = field(default_factory=list)


@dataclass
class ResponseCommit:
    data: bytes = b""  # the app hash
    retain_height: int = 0


@dataclass
class ResponseListSnapshots:
    snapshots: List[Snapshot] = field(default_factory=list)


@dataclass
class ResponseOfferSnapshot:
    result: int = OfferSnapshotResult.UNKNOWN


@dataclass
class ResponseLoadSnapshotChunk:
    chunk: bytes = b""


@dataclass
class ResponseApplySnapshotChunk:
    result: int = ApplySnapshotChunkResult.UNKNOWN
    refetch_chunks: List[int] = field(default_factory=list)  # refetch + reapply
    reject_senders: List[str] = field(default_factory=list)  # ban these peers


# wire tags for the socket protocol; both directions share the registry
_MSG_TYPES = {
    "echo": (RequestEcho, ResponseEcho),
    "flush": (RequestFlush, ResponseFlush),
    "info": (RequestInfo, ResponseInfo),
    "set_option": (RequestSetOption, ResponseSetOption),
    "init_chain": (RequestInitChain, ResponseInitChain),
    "query": (RequestQuery, ResponseQuery),
    "begin_block": (RequestBeginBlock, ResponseBeginBlock),
    "check_tx": (RequestCheckTx, ResponseCheckTx),
    "deliver_tx": (RequestDeliverTx, ResponseDeliverTx),
    "end_block": (RequestEndBlock, ResponseEndBlock),
    "commit": (RequestCommit, ResponseCommit),
    "list_snapshots": (RequestListSnapshots, ResponseListSnapshots),
    "offer_snapshot": (RequestOfferSnapshot, ResponseOfferSnapshot),
    "load_snapshot_chunk": (RequestLoadSnapshotChunk, ResponseLoadSnapshotChunk),
    "apply_snapshot_chunk": (RequestApplySnapshotChunk, ResponseApplySnapshotChunk),
    "exception": (None, ResponseException),
}

_NESTED = {
    "validators": ValidatorUpdate,
    "validator_updates": ValidatorUpdate,
    "events": Event,
    "last_commit_info": LastCommitInfo,
    "snapshots": Snapshot,
    "snapshot": Snapshot,
}


def encode_msg(kind: str, msg) -> dict:
    d = asdict(msg) if msg is not None else {}
    d["@m"] = kind
    return d


def decode_msg(d: dict, direction: int):
    """direction 0=request, 1=response."""
    kind = d.pop("@m")
    cls = _MSG_TYPES[kind][direction]
    if cls is None:
        raise ValueError(f"no message class for {kind}/{direction}")
    for key, sub in _NESTED.items():
        if key in d and isinstance(d[key], list):
            d[key] = [sub(**v) if isinstance(v, dict) else v for v in d[key]]
        elif key in d and isinstance(d[key], dict):
            d[key] = sub(**d[key])
    return kind, cls(**d)


# ---------------------------------------------------------------------------
# Application
# ---------------------------------------------------------------------------


class Application(ABC):
    """The interface apps implement (abci/types/application.go:11).
    Methods are synchronous — the clients adapt them to the async node."""

    def echo(self, req: RequestEcho) -> ResponseEcho:
        return ResponseEcho(message=req.message)

    def info(self, req: RequestInfo) -> ResponseInfo:
        return ResponseInfo()

    def set_option(self, req: RequestSetOption) -> ResponseSetOption:
        return ResponseSetOption()

    def init_chain(self, req: RequestInitChain) -> ResponseInitChain:
        return ResponseInitChain()

    def query(self, req: RequestQuery) -> ResponseQuery:
        return ResponseQuery()

    def begin_block(self, req: RequestBeginBlock) -> ResponseBeginBlock:
        return ResponseBeginBlock()

    def check_tx(self, req: RequestCheckTx) -> ResponseCheckTx:
        return ResponseCheckTx()

    def deliver_tx(self, req: RequestDeliverTx) -> ResponseDeliverTx:
        return ResponseDeliverTx()

    def end_block(self, req: RequestEndBlock) -> ResponseEndBlock:
        return ResponseEndBlock()

    def commit(self, req: RequestCommit) -> ResponseCommit:
        return ResponseCommit()

    # -- state-sync snapshot protocol (abci/types/application.go) ----------
    def list_snapshots(self, req: RequestListSnapshots) -> ResponseListSnapshots:
        return ResponseListSnapshots()

    def offer_snapshot(self, req: RequestOfferSnapshot) -> ResponseOfferSnapshot:
        return ResponseOfferSnapshot()

    def load_snapshot_chunk(self, req: RequestLoadSnapshotChunk) -> ResponseLoadSnapshotChunk:
        return ResponseLoadSnapshotChunk()

    def apply_snapshot_chunk(self, req: RequestApplySnapshotChunk) -> ResponseApplySnapshotChunk:
        return ResponseApplySnapshotChunk()


class BaseApplication(Application):
    """All-default app (abci/types/application.go:34)."""

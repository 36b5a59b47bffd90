"""PartSetHeader, BlockID, CommitSig, Commit, Header, Block and
SignedHeader: the port's copy of tendermint_tpu/types/block.py, with its
to_dict / from_dict layout and codec tags.  A commit of a set with
BLS12-381 members carries one signature per vote, its BLS slots signed
over the timestamp-free layout.  A dict holding an aggregate (BLS) commit
decodes to types/agg_commit.py's AggregateCommit.

Reference parity: types/block.go (Header:323, CommitSig:452, Commit:556,
SignedHeader:748, BlockID:893).  Times are integer unix nanoseconds
throughout (deterministic, no tz).
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import List, Optional

from ..crypto import merkle
from ..encoding import codec
from ..encoding.proto import field_bytes, field_time, field_varint
from ..libs.bitarray import BitArray
from . import canonical
from .params import MAX_CHAIN_ID_LEN, MAX_SIGNATURE_SIZE, MAX_VOTES_COUNT

ADDRESS_SIZE = 20
HASH_SIZE = 32

# BlockIDFlag (types/block.go:442-449)
BLOCK_ID_FLAG_ABSENT = 1
BLOCK_ID_FLAG_COMMIT = 2
BLOCK_ID_FLAG_NIL = 3


def validate_hash(h: bytes) -> None:
    """Hashes are either empty or tmhash-sized (types/validation.go:32)."""
    if h and len(h) != HASH_SIZE:
        raise ValueError(f"expected size to be {HASH_SIZE} bytes, got {len(h)} bytes")


def _enc_bytes(v: bytes) -> bytes:
    """Deterministic single-value encoding for merkle leaves (cdcEncode-like)."""
    return field_bytes(1, v) if v else b""


def _enc_varint(v: int) -> bytes:
    return field_varint(1, v)


def _enc_str(v: str) -> bytes:
    return field_bytes(1, v)


def _enc_time(ns: int) -> bytes:
    return field_time(1, ns)


@dataclass(frozen=True)
class PartSetHeader:
    """types/part_set.go:59."""

    total: int = 0
    hash: bytes = b""

    def is_zero(self) -> bool:
        return self.total == 0 and len(self.hash) == 0

    def validate_basic(self) -> None:
        if self.total < 0:
            raise ValueError("negative Total")
        validate_hash(self.hash)

    def encode(self) -> bytes:
        return field_varint(1, self.total) + field_bytes(2, self.hash)

    def to_dict(self) -> dict:
        return {"total": self.total, "hash": self.hash}

    @classmethod
    def from_dict(cls, d: dict) -> "PartSetHeader":
        return cls(d["total"], d["hash"])

    def __str__(self) -> str:
        return f"{self.total}:{self.hash.hex()[:12]}"


@dataclass(frozen=True)
class BlockID:
    """types/block.go:893."""

    hash: bytes = b""
    parts_header: PartSetHeader = field(default_factory=PartSetHeader)

    def key(self) -> bytes:
        """Machine-readable identity (types/block.go:905)."""
        return self.hash + self.parts_header.encode()

    def is_zero(self) -> bool:
        return len(self.hash) == 0 and self.parts_header.is_zero()

    def is_complete(self) -> bool:
        return (
            len(self.hash) == HASH_SIZE
            and self.parts_header.total > 0
            and len(self.parts_header.hash) == HASH_SIZE
        )

    def validate_basic(self) -> None:
        validate_hash(self.hash)
        self.parts_header.validate_basic()

    def encode(self) -> bytes:
        inner = field_bytes(1, self.hash)
        psh = self.parts_header.encode()
        if self.parts_header != PartSetHeader():
            inner += field_bytes(2, psh)
        return inner

    def to_dict(self) -> dict:
        return {"hash": self.hash, "parts": self.parts_header.to_dict()}

    @classmethod
    def from_dict(cls, d: dict) -> "BlockID":
        return cls(d["hash"], PartSetHeader.from_dict(d["parts"]))

    def __str__(self) -> str:
        return f"{self.hash.hex()[:12]}:{self.parts_header}"


@dataclass(frozen=True)
class CommitSig:
    """One validator's slot in a Commit (types/block.go:452)."""

    block_id_flag: int = BLOCK_ID_FLAG_ABSENT
    validator_address: bytes = b""
    timestamp_ns: int = 0
    signature: bytes = b""

    @classmethod
    def absent(cls) -> "CommitSig":
        return cls(BLOCK_ID_FLAG_ABSENT, b"", 0, b"")

    def is_absent(self) -> bool:
        return self.block_id_flag == BLOCK_ID_FLAG_ABSENT

    def is_for_block(self) -> bool:
        return self.block_id_flag == BLOCK_ID_FLAG_COMMIT

    def block_id(self, commit_block_id: BlockID) -> BlockID:
        """The BlockID this sig signed over (types/block.go:497)."""
        if self.block_id_flag == BLOCK_ID_FLAG_COMMIT:
            return commit_block_id
        return BlockID()

    def validate_basic(self) -> None:
        if self.block_id_flag not in (
            BLOCK_ID_FLAG_ABSENT,
            BLOCK_ID_FLAG_COMMIT,
            BLOCK_ID_FLAG_NIL,
        ):
            raise ValueError(f"unknown BlockIDFlag: {self.block_id_flag}")
        if self.block_id_flag == BLOCK_ID_FLAG_ABSENT:
            if self.validator_address:
                raise ValueError("validator address is present")
            if self.timestamp_ns != 0:
                raise ValueError("time is present")
            if self.signature:
                raise ValueError("signature is present")
        else:
            if len(self.validator_address) != ADDRESS_SIZE:
                raise ValueError(
                    f"expected ValidatorAddress size {ADDRESS_SIZE}, got {len(self.validator_address)}"
                )
            if not self.signature:
                raise ValueError("signature is missing")
            if len(self.signature) > MAX_SIGNATURE_SIZE:
                raise ValueError(f"signature is too big (max: {MAX_SIGNATURE_SIZE})")

    def encode(self) -> bytes:
        return (
            field_varint(1, self.block_id_flag)
            + field_bytes(2, self.validator_address)
            + field_time(3, self.timestamp_ns)
            + field_bytes(4, self.signature)
        )

    def to_dict(self) -> dict:
        return {
            "block_id_flag": self.block_id_flag,
            "validator_address": self.validator_address,
            "timestamp_ns": self.timestamp_ns,
            "signature": self.signature,
        }

    @classmethod
    def from_dict(cls, d: dict) -> "CommitSig":
        return cls(d["block_id_flag"], d["validator_address"], d["timestamp_ns"], d["signature"])


class Commit:
    """Proof a block was committed: ordered CommitSigs (types/block.go:556).

    Signature order matches validator-set order, so the batch verifier can
    gather pubkeys by index — no per-sig address lookups.
    """

    def __init__(self, height: int, round_: int, block_id: BlockID, signatures: List[CommitSig]):
        self.height = height
        self.round = round_
        self.block_id = block_id
        self.signatures = signatures
        self._hash: Optional[bytes] = None
        self._bit_array = None

    def size(self) -> int:
        return len(self.signatures)

    def bit_array(self) -> BitArray:
        """Which validators signed (the consensus reactor's catchup gossip)."""
        if self._bit_array is None:
            ba = BitArray(len(self.signatures))
            for i, cs in enumerate(self.signatures):
                ba.set_index(i, not cs.is_absent())
            self._bit_array = ba
        return self._bit_array

    def get_vote(self, val_idx: int):
        """Reconstruct the precommit Vote at a validator index
        (types/block.go:603)."""
        from .vote import Vote

        cs = self.signatures[val_idx]
        return Vote(
            type=canonical.PRECOMMIT_TYPE,
            height=self.height,
            round=self.round,
            block_id=cs.block_id(self.block_id),
            timestamp_ns=cs.timestamp_ns,
            validator_address=cs.validator_address,
            validator_index=val_idx,
            signature=cs.signature,
        )

    def vote_sign_bytes(self, chain_id: str, val_idx: int, pub_key=None) -> bytes:
        """Sign-bytes for slot val_idx (types/block.go:621) — only the
        timestamp differs between validators.  When `pub_key` identifies a
        BLS validator, the timestamp-free aggregation domain applies (the
        slot in a mixed-set commit routes per scheme)."""
        cs = self.signatures[val_idx]
        bid = cs.block_id(self.block_id)
        if pub_key is not None:
            from .vote import is_bls_key

            if is_bls_key(pub_key):
                return canonical.canonical_vote_sign_bytes_no_ts(
                    chain_id,
                    canonical.PRECOMMIT_TYPE,
                    self.height,
                    self.round,
                    bid.hash,
                    bid.parts_header.total,
                    bid.parts_header.hash,
                )
        return canonical.canonical_vote_sign_bytes(
            chain_id,
            canonical.PRECOMMIT_TYPE,
            self.height,
            self.round,
            bid.hash,
            bid.parts_header.total,
            bid.parts_header.hash,
            cs.timestamp_ns,
        )

    def validate_basic(self) -> None:
        if self.height < 0:
            raise ValueError("negative Height")
        if self.round < 0:
            raise ValueError("negative Round")
        if self.block_id.is_zero():
            raise ValueError("commit cannot be for nil block")
        if not self.signatures:
            raise ValueError("no signatures in commit")
        if len(self.signatures) > MAX_VOTES_COUNT:
            raise ValueError("too many signatures")
        for i, cs in enumerate(self.signatures):
            try:
                cs.validate_basic()
            except ValueError as e:
                raise ValueError(f"wrong CommitSig #{i}: {e}") from e

    def hash(self) -> bytes:
        if self._hash is None:
            self._hash = merkle.hash_from_byte_slices([cs.encode() for cs in self.signatures])
        return self._hash

    def to_dict(self) -> dict:
        return {
            "height": self.height,
            "round": self.round,
            "block_id": self.block_id.to_dict(),
            "signatures": [cs.to_dict() for cs in self.signatures],
        }

    @classmethod
    def from_dict(cls, d: dict) -> "Commit":
        return cls(
            d["height"],
            d["round"],
            BlockID.from_dict(d["block_id"]),
            [CommitSig.from_dict(s) for s in d["signatures"]],
        )

    def __repr__(self) -> str:
        return f"Commit(H={self.height} R={self.round} sigs={len(self.signatures)})"


codec.register("tm/Commit")(Commit)


@dataclass(frozen=True)
class Header:
    """types/block.go:323.  version is (block, app) protocol ints."""

    version_block: int = 10
    version_app: int = 0
    chain_id: str = ""
    height: int = 0
    time_ns: int = 0
    last_block_id: BlockID = field(default_factory=BlockID)
    last_commit_hash: bytes = b""
    data_hash: bytes = b""
    validators_hash: bytes = b""
    next_validators_hash: bytes = b""
    consensus_hash: bytes = b""
    app_hash: bytes = b""
    last_results_hash: bytes = b""
    evidence_hash: bytes = b""
    proposer_address: bytes = b""

    def hash(self) -> bytes:
        """Merkle root over the 14 encoded fields in declaration order
        (types/block.go:377).  Empty if ValidatorsHash missing."""
        if not self.validators_hash:
            return b""
        version = field_varint(1, self.version_block) + field_varint(2, self.version_app)
        return merkle.hash_from_byte_slices(
            [
                version,
                _enc_str(self.chain_id),
                _enc_varint(self.height),
                _enc_time(self.time_ns),
                self.last_block_id.encode(),
                _enc_bytes(self.last_commit_hash),
                _enc_bytes(self.data_hash),
                _enc_bytes(self.validators_hash),
                _enc_bytes(self.next_validators_hash),
                _enc_bytes(self.consensus_hash),
                _enc_bytes(self.app_hash),
                _enc_bytes(self.last_results_hash),
                _enc_bytes(self.evidence_hash),
                _enc_bytes(self.proposer_address),
            ]
        )

    def to_dict(self) -> dict:
        return {
            "version": {"block": self.version_block, "app": self.version_app},
            "chain_id": self.chain_id,
            "height": self.height,
            "time_ns": self.time_ns,
            "last_block_id": self.last_block_id.to_dict(),
            "last_commit_hash": self.last_commit_hash,
            "data_hash": self.data_hash,
            "validators_hash": self.validators_hash,
            "next_validators_hash": self.next_validators_hash,
            "consensus_hash": self.consensus_hash,
            "app_hash": self.app_hash,
            "last_results_hash": self.last_results_hash,
            "evidence_hash": self.evidence_hash,
            "proposer_address": self.proposer_address,
        }

    @classmethod
    def from_dict(cls, d: dict) -> "Header":
        return cls(
            version_block=d["version"]["block"],
            version_app=d["version"]["app"],
            chain_id=d["chain_id"],
            height=d["height"],
            time_ns=d["time_ns"],
            last_block_id=BlockID.from_dict(d["last_block_id"]),
            last_commit_hash=d["last_commit_hash"],
            data_hash=d["data_hash"],
            validators_hash=d["validators_hash"],
            next_validators_hash=d["next_validators_hash"],
            consensus_hash=d["consensus_hash"],
            app_hash=d["app_hash"],
            last_results_hash=d["last_results_hash"],
            evidence_hash=d["evidence_hash"],
            proposer_address=d["proposer_address"],
        )


class Block:
    """The atomic unit of the chain (types/block.go:38)."""

    def __init__(
        self,
        header: Header,
        txs: List[bytes],
        evidence: Optional[list] = None,
        last_commit: Optional[Commit] = None,
    ):
        self.header = header
        self.txs = [bytes(t) for t in txs]
        self.evidence = evidence or []
        self.last_commit = last_commit
        self._hash: Optional[bytes] = None

    # -- header delegation -------------------------------------------------
    @property
    def height(self) -> int:
        return self.header.height

    @property
    def chain_id(self) -> str:
        return self.header.chain_id

    @property
    def time_ns(self) -> int:
        return self.header.time_ns

    def data_hash(self) -> bytes:
        from .tx import txs_hash

        return txs_hash(self.txs)

    def evidence_hash(self) -> bytes:
        from .evidence import evidence_list_hash

        return evidence_list_hash(self.evidence)

    def fill_header(self) -> None:
        """Complete hash fields derived from the block data
        (types/block.go:147)."""
        h = self.header
        updates = {}
        if not h.last_commit_hash:
            updates["last_commit_hash"] = self.last_commit.hash() if self.last_commit else merkle.hash_from_byte_slices([])
        if not h.data_hash:
            updates["data_hash"] = self.data_hash()
        if not h.evidence_hash:
            updates["evidence_hash"] = self.evidence_hash()
        if updates:
            self.header = replace(h, **updates)
            self._hash = None

    def hash(self) -> bytes:
        """Nil for incomplete blocks (types/block.go:161)."""
        if self.height > 1 and self.last_commit is None:
            return b""
        self.fill_header()
        if self._hash is None:
            self._hash = self.header.hash()
        return self._hash

    def hashes_to(self, h: bytes) -> bool:
        return bool(h) and self.hash() == h

    def serialize(self) -> bytes:
        return codec.dumps(self)

    @classmethod
    def deserialize(cls, data: bytes) -> "Block":
        blk = codec.loads(data)
        if not isinstance(blk, cls):
            raise ValueError("not a Block")
        return blk

    def make_part_set(self, part_size: int):
        from .part_set import PartSet

        return PartSet.from_data(self.serialize(), part_size)

    def block_id(self, part_size: int) -> BlockID:
        ps = self.make_part_set(part_size)
        return BlockID(self.hash(), ps.header())

    def size(self) -> int:
        return len(self.serialize())

    def validate_basic(self) -> None:
        """Internal consistency checks (types/block.go:49); state-dependent
        validation lives in state/validation.py."""
        h = self.header
        if len(h.chain_id) > MAX_CHAIN_ID_LEN:
            raise ValueError(f"chainID is too long; max {MAX_CHAIN_ID_LEN}")
        if h.height < 0:
            raise ValueError("negative Header.Height")
        if h.height == 0:
            raise ValueError("zero Header.Height")
        h.last_block_id.validate_basic()

        if h.height > 1:
            if self.last_commit is None:
                raise ValueError("nil LastCommit")
            self.last_commit.validate_basic()
        # compare received header fields against recomputed values — no
        # fill_header() here: an omitted hash must fail, and validation must
        # not mutate a block whose bytes peers signed over
        validate_hash(h.last_commit_hash)
        expected_lc = self.last_commit.hash() if self.last_commit else merkle.hash_from_byte_slices([])
        if h.last_commit_hash != expected_lc:
            raise ValueError("wrong Header.LastCommitHash")
        validate_hash(h.data_hash)
        if h.data_hash != self.data_hash():
            raise ValueError("wrong Header.DataHash")
        validate_hash(h.validators_hash)
        validate_hash(h.next_validators_hash)
        validate_hash(h.consensus_hash)
        validate_hash(h.last_results_hash)
        validate_hash(h.evidence_hash)
        for i, ev in enumerate(self.evidence):
            try:
                ev.validate_basic()
            except ValueError as e:
                raise ValueError(f"invalid evidence (#{i}): {e}") from e
        if h.evidence_hash != self.evidence_hash():
            raise ValueError("wrong Header.EvidenceHash")
        if len(h.proposer_address) != ADDRESS_SIZE:
            raise ValueError(
                f"expected len(Header.ProposerAddress) to be {ADDRESS_SIZE}, got {len(h.proposer_address)}"
            )

    def to_dict(self) -> dict:
        return {
            "header": self.header.to_dict(),
            "txs": list(self.txs),
            "evidence": [codec.dumps(e) for e in self.evidence],
            "last_commit": self.last_commit.to_dict() if self.last_commit else None,
        }

    @classmethod
    def from_dict(cls, d: dict) -> "Block":
        from .agg_commit import commit_from_dict

        return cls(
            header=Header.from_dict(d["header"]),
            txs=d["txs"],
            evidence=[codec.loads(e) for e in d["evidence"]],
            last_commit=commit_from_dict(d["last_commit"]),
        )

    def __repr__(self) -> str:
        return f"Block(H={self.height} txs={len(self.txs)})#{self.hash().hex()[:12]}"


codec.register("tm/Block")(Block)



@dataclass(frozen=True)
class SignedHeader:
    """Header + the commit that proves it — the light-client unit
    (types/block.go:748)."""

    header: Header
    commit: Commit

    def validate_basic(self, chain_id: str) -> None:
        if self.header is None:
            raise ValueError("signedHeader missing header")
        if self.commit is None:
            raise ValueError("signedHeader missing commit")
        if self.header.chain_id != chain_id:
            raise ValueError(
                f"signedHeader belongs to another chain {self.header.chain_id!r} not {chain_id!r}"
            )
        if self.commit.height != self.header.height:
            raise ValueError(
                f"signedHeader header and commit height mismatch: {self.header.height} vs {self.commit.height}"
            )
        if self.header.hash() != self.commit.block_id.hash:
            raise ValueError("signedHeader commit signs a different block")
        self.commit.validate_basic()

    @property
    def height(self) -> int:
        return self.header.height

    @property
    def time_ns(self) -> int:
        return self.header.time_ns

    def hash(self) -> bytes:
        return self.header.hash()

    def to_dict(self) -> dict:
        return {"header": self.header.to_dict(), "commit": self.commit.to_dict()}

    @classmethod
    def from_dict(cls, d: dict) -> "SignedHeader":
        from .agg_commit import commit_from_dict

        return cls(Header.from_dict(d["header"]), commit_from_dict(d["commit"]))


codec.register("tm/SignedHeader")(SignedHeader)

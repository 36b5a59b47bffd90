"""State persistence: per-height validator sets, consensus params, ABCI
responses (the port's copy of tendermint_tpu/state/store.py).

Reference parity: state/store.go (SaveState:97, LoadState:71,
LoadValidators:295 with the "last height changed" pointer scheme,
SaveABCIResponses:276, PruneStates).

The port keeps the last few decoded validator records, keyed by their
stored bytes, and the last few fast-forwarded sets, keyed by the full
record's bytes and the heights they were moved on: the RPC `validators` route pages a set
100 entries at a time and loads the whole set for each page, and decoding
a 10,000-validator record and replaying its priorities is most of a
page's time.  The bytes are the key, so a rewritten record is loaded
afresh.
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Optional

from ..encoding import codec
from ..libs.kvstore import KVStore
from ..types.genesis import GenesisDoc
from ..types.params import ConsensusParams
from ..types.validator import ValidatorSet
from .state import State, make_genesis_state

_K_STATE = b"stateKey"


def _k_validators(height: int) -> bytes:
    return b"validatorsKey:%d" % height


def _k_params(height: int) -> bytes:
    return b"consensusParamsKey:%d" % height


def _k_abci_responses(height: int) -> bytes:
    return b"abciResponsesKey:%d" % height


class StateStore:
    DECODED_RECORDS = 8  # decoded validator records and fast-forwarded sets kept

    def __init__(self, db: KVStore):
        self.db = db
        self._decoded: "OrderedDict[object, dict]" = OrderedDict()
        self._decoded_lock = threading.Lock()

    # -- whole state -------------------------------------------------------
    def save(self, state: State) -> None:
        """SaveState (state/store.go:97): persists state + the validator set
        / params that become active at the *next* height, using the
        pointer-to-last-changed scheme so a 10k-validator set isn't
        rewritten every block.

        ONE atomic batch: the per-height validator/params records and the
        state key land together or not at all — a crash (or injected
        ENOSPC) between separate sets used to leave the validator records
        for height H+2 on disk with the state key still at H-1, a
        half-applied save the handshake then reads as truth."""
        next_height = state.last_block_height + 1
        sets = []
        if next_height == 1:
            # genesis bootstrap: heights 1 and 2 both known at this point
            self._stage_validators(sets, next_height, next_height, state.validators)
        self._stage_validators(
            sets, next_height + 1, state.last_height_validators_changed, state.next_validators
        )
        self._stage_params(
            sets, next_height, state.last_height_consensus_params_changed, state.consensus_params
        )
        sets.append((_K_STATE, state.bytes()))
        self.db.write_batch(sets)

    def load(self) -> Optional[State]:
        raw = self.db.get(_K_STATE)
        if raw is None:
            return None
        return codec.loads(raw)

    def load_from_db_or_genesis(self, gen_doc: GenesisDoc) -> State:
        """state/store.go:56 LoadStateFromDBOrGenesisDoc."""
        state = self.load()
        if state is None or state.is_empty():
            state = make_genesis_state(gen_doc)
        return state

    def bootstrap(self, state: State) -> None:
        """state/store.go Bootstrap — persist a statesync-restored state
        whose history does NOT exist locally: full (non-pointer) validator
        records for the heights consensus and RPC will touch next, plus a
        full consensus-params record, so the pointer-to-last-changed
        scheme never dereferences a height below the snapshot.  Atomic
        for the same reason save() is."""
        h = state.last_block_height
        sets = []
        if state.last_validators is not None and state.last_validators.size() > 0:
            self._stage_validators(sets, h, h, state.last_validators)
        self._stage_validators(sets, h + 1, h + 1, state.validators)
        self._stage_validators(sets, h + 2, h + 2, state.next_validators)
        self._stage_params(sets, h + 1, h + 1, state.consensus_params)
        sets.append((_K_STATE, state.bytes()))
        self.db.write_batch(sets)

    # -- historical validator sets ----------------------------------------
    # Full-set checkpoint cadence for unchanged validator sets (reference
    # valSetCheckpointInterval, state/store.go:42, shrunk for Python):
    # load_validators replays proposer priority once per height since the
    # last full record, so a pointer chain growing with chain height makes
    # historical loads O(height) each.  A checkpoint bounds the replay.
    VALSET_CHECKPOINT_INTERVAL = 1024

    def _stage_validators(
        self, sets: list, height: int, last_changed: int, vals: ValidatorSet
    ) -> None:
        if height == last_changed or height % self.VALSET_CHECKPOINT_INTERVAL == 0:
            payload = {"last_changed": last_changed, "validators": vals.to_dict()}
        else:
            # pointer record only — the full set lives at last_changed
            payload = {"last_changed": last_changed, "validators": None}
        sets.append((_k_validators(height), codec.dumps(payload)))

    def load_validators(self, height: int) -> Optional[ValidatorSet]:
        """LoadValidators (state/store.go:295): follow the pointer to the
        nearest full record — the last set change or a later checkpoint —
        then fast-forward proposer priority by the remaining delta."""
        d = self._load_validators_info(height)
        if d is None:
            return None
        if d["validators"] is None:
            last_changed = d["last_changed"]
            stored = max(
                last_changed,
                (height // self.VALSET_CHECKPOINT_INTERVAL)
                * self.VALSET_CHECKPOINT_INTERVAL,
            )
            raw_full, d2 = self._load_record(stored)
            if d2 is None or d2["validators"] is None:
                # no checkpoint at that height (e.g. records written before
                # checkpointing existed): fall back to the change record
                stored = last_changed
                raw_full, d2 = self._load_record(stored)
            if d2 is None or d2["validators"] is None:
                return None
            if height == stored:
                return ValidatorSet.from_dict(d2["validators"])
            # the fast-forwarded set, kept by the full record's bytes and
            # the delta (pointer records of different heights are equal)
            key = (raw_full, height - stored)
            cached = self._cached(key)
            if cached is None:
                vals = ValidatorSet.from_dict(d2["validators"])
                vals.increment_proposer_priority(height - stored)
                self._keep(key, vals.to_dict())
                return vals
            return ValidatorSet.from_dict(cached)
        return ValidatorSet.from_dict(d["validators"])

    def _load_validators_info(self, height: int) -> Optional[dict]:
        return self._load_record(height)[1]

    def _load_record(self, height: int):
        """(stored bytes, decoded record) at `height`, (None, None) when
        absent; the record is shared, so callers only read it."""
        raw = self.db.get(_k_validators(height))
        if not raw:
            return None, None
        d = self._cached(raw)
        if d is None:
            d = codec.loads(raw)
            self._keep(raw, d)
        return raw, d

    def _cached(self, key):
        with self._decoded_lock:
            d = self._decoded.get(key)
            if d is not None:
                self._decoded.move_to_end(key)
            return d

    def _keep(self, key, d) -> None:
        with self._decoded_lock:
            self._decoded[key] = d
            while len(self._decoded) > self.DECODED_RECORDS:
                self._decoded.popitem(last=False)

    # -- historical consensus params --------------------------------------
    def _stage_params(
        self, sets: list, height: int, last_changed: int, params: ConsensusParams
    ) -> None:
        if height == last_changed:
            payload = {"last_changed": last_changed, "params": params.to_dict()}
        else:
            payload = {"last_changed": last_changed, "params": None}
        sets.append((_k_params(height), codec.dumps(payload)))

    def load_consensus_params(self, height: int) -> Optional[ConsensusParams]:
        raw = self.db.get(_k_params(height))
        if raw is None:
            return None
        d = codec.loads(raw)
        if d["params"] is None:
            raw2 = self.db.get(_k_params(d["last_changed"]))
            if raw2 is None:
                return None
            d2 = codec.loads(raw2)
            if d2["params"] is None:
                return None
            return ConsensusParams.from_dict(d2["params"])
        return ConsensusParams.from_dict(d["params"])

    # -- ABCI responses (for replay + RPC block_results) -------------------
    def save_abci_responses(self, height: int, responses: dict) -> None:
        """state/store.go:276 — responses = {"deliver_txs": [...],
        "begin_block": {...}, "end_block": {...}} as plain dicts."""
        self.db.set(_k_abci_responses(height), codec.dumps(responses))

    def load_abci_responses(self, height: int) -> Optional[dict]:
        raw = self.db.get(_k_abci_responses(height))
        return codec.loads(raw) if raw else None

    # -- pruning -----------------------------------------------------------
    def prune_states(self, retain_height: int) -> None:
        """Drop per-height records below retain_height, keeping records that
        later pointer entries still reference."""
        val_referenced = set()
        info = self._load_validators_info(retain_height)
        if info is not None:
            val_referenced.add(info["last_changed"])
        params_referenced = set()
        raw = self.db.get(_k_params(retain_height))
        if raw is not None:
            params_referenced.add(codec.loads(raw)["last_changed"])
        deletes = []
        for h in range(1, retain_height):
            if h not in val_referenced:
                deletes.append(_k_validators(h))
            if h not in params_referenced:
                deletes.append(_k_params(h))
            deletes.append(_k_abci_responses(h))
        self.db.write_batch([], deletes)

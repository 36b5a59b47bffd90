"""Staking: the bank-backed application that makes the validator set a
live, workload-driven quantity (the port's copy of
tendermint_tpu/apps/staking.py).

Stake txs ride the same signed-tx envelopes as bank transfers; the
envelope signer's account is the validator's OWNER (its control key), a
separate concern from the validator's CONSENSUS key — which is exactly
what lets a live ed25519→BLS12-381 consensus-key migration happen while
the owner keeps signing control txs with the same ed25519 key throughout.

Payload grammar (optional ``fee:<n>:`` prefix, debited like bank fees):

    stake:bond:<amount>:<nonce>            power += amount (debits balance;
                                           first bond registers the envelope
                                           key as the consensus key)
    stake:unbond:<amount>:<nonce>          power -= amount (credits balance;
                                           reaching 0 leaves the set)
    stake:edit:<power>:<nonce>             set power outright, settling the
                                           difference against the balance
                                           (0 = leave, full refund)
    stake:rotate:<key_type>:<b64 pub>[:<b64 pop>]:<nonce>
                                           swap the consensus key in place:
                                           end_block emits (old key, 0) +
                                           (new key, power).  bls12381 keys
                                           MUST carry a proof of possession
                                           (rogue-key soundness for the
                                           aggregate-commit path).

Set changes land in ``end_block.validator_updates`` and become effective
at H+2 (state/execution.py update_state) — the staking records here are
the app-side source of truth, the consensus ValidatorSet follows.

``epoch_length`` > 0 additionally rotates voting power among the bonded
validators at every epoch boundary deterministically (a barrel shift of
the power assignment in owner order), so a chain held at steady state
still exercises set updates every epoch with zero client traffic.
"""

from __future__ import annotations

import base64
import hashlib
import json
import struct
from typing import Dict, List, Optional

from ..abci import types as t
from ..libs.kvstore import KVStore
from ..mempool import make_signed_tx
from .bank import (
    BankApplication,
    CODE_BAD_NONCE,
    CODE_INSUFFICIENT_FUNDS,
    CODE_MALFORMED,
    CODE_OK,
    DEFAULT_FAUCET,
)

_STK_PREFIX = b"__stk__"

CODE_NO_VALIDATOR = 20
CODE_BAD_KEY = 21
CODE_BAD_POP = 22
CODE_KEY_IN_USE = 23

_KNOWN_CONSENSUS_KEY_TYPES = ("ed25519", "bls12381")


# -- client tx builders ----------------------------------------------------


def _wrap(priv_key, payload: bytes, fee: int) -> bytes:
    if fee > 0:
        payload = b"fee:%d:" % fee + payload
    return make_signed_tx(priv_key, payload)


def make_bond_tx(priv_key, amount: int, nonce: int, fee: int = 0) -> bytes:
    return _wrap(priv_key, b"stake:bond:%d:%d" % (amount, nonce), fee)


def make_unbond_tx(priv_key, amount: int, nonce: int, fee: int = 0) -> bytes:
    return _wrap(priv_key, b"stake:unbond:%d:%d" % (amount, nonce), fee)


def make_edit_power_tx(priv_key, power: int, nonce: int, fee: int = 0) -> bytes:
    return _wrap(priv_key, b"stake:edit:%d:%d" % (power, nonce), fee)


def make_rotate_key_tx(
    priv_key, key_type: str, new_pub: bytes, nonce: int, pop: bytes = b"", fee: int = 0
) -> bytes:
    parts = [b"stake:rotate", key_type.encode(), base64.b64encode(new_pub)]
    if pop:
        parts.append(base64.b64encode(pop))
    parts.append(b"%d" % nonce)
    return _wrap(priv_key, b":".join(parts), fee)


class StakingApplication(BankApplication):
    """Bank + validator records + end_block validator updates."""

    def __init__(
        self,
        db: Optional[KVStore] = None,
        faucet: int = DEFAULT_FAUCET,
        epoch_length: int = 0,
    ):
        # owner addr -> {"key_type", "pub_key", "pop", "power"} (records
        # loaded before super().__init__ runs _load_state? no — super's
        # _load_state only reads bank keys; staking records load below)
        self.validators: Dict[bytes, dict] = {}
        self.by_pubkey: Dict[bytes, bytes] = {}  # consensus pub -> owner
        self.epoch_length = epoch_length
        self._pending_updates: List[t.ValidatorUpdate] = []
        super().__init__(db=db, faucet=faucet)
        for k, v in self.db.iterate_prefix(_STK_PREFIX):
            rec = self._decode_record(v)
            owner = k[len(_STK_PREFIX):]
            self.validators[owner] = rec
            self.by_pubkey[rec["pub_key"]] = owner
        ep = self.db.get(b"__stk_epoch__")
        if ep:
            self.epoch_length = struct.unpack("<Q", ep)[0]

    # -- record persistence ------------------------------------------------
    @staticmethod
    def _decode_record(raw: bytes) -> dict:
        d = json.loads(raw.decode())
        return {
            "key_type": d["key_type"],
            "pub_key": bytes.fromhex(d["pub_key"]),
            "pop": bytes.fromhex(d.get("pop", "")),
            "power": int(d["power"]),
        }

    def _put_record(self, owner: bytes, rec: dict) -> None:
        self.validators[owner] = rec
        self.by_pubkey[rec["pub_key"]] = owner
        self.db.set(
            _STK_PREFIX + owner,
            json.dumps(
                {
                    "key_type": rec["key_type"],
                    "pub_key": rec["pub_key"].hex(),
                    "pop": rec["pop"].hex(),
                    "power": rec["power"],
                },
                sort_keys=True,
            ).encode(),
        )

    def _drop_record(self, owner: bytes) -> None:
        rec = self.validators.pop(owner, None)
        if rec is not None:
            self.by_pubkey.pop(rec["pub_key"], None)
        self.db.delete(_STK_PREFIX + owner)

    def _update_for(self, rec: dict, power: int) -> t.ValidatorUpdate:
        return t.ValidatorUpdate(
            pub_key_type=rec["key_type"],
            pub_key=rec["pub_key"],
            power=power,
            pop=rec["pop"] if power > 0 else b"",
        )

    # -- ABCI --------------------------------------------------------------
    def init_chain(self, req: t.RequestInitChain) -> t.ResponseInitChain:
        super().init_chain(req)
        if req.app_state_bytes:
            try:
                doc = json.loads(req.app_state_bytes.decode())
                stk = doc.get("staking", {}) if isinstance(doc, dict) else {}
                if "epoch_length" in stk:
                    self.epoch_length = int(stk["epoch_length"])
            except Exception:
                pass
        self.db.set(b"__stk_epoch__", struct.pack("<Q", self.epoch_length))
        # genesis validators: owner = the consensus key's own address (a
        # genesis val controls itself until it rotates to a foreign key)
        for vu in req.validators:
            if vu.power <= 0:
                continue
            owner = self._address_of(vu.pub_key_type, vu.pub_key)
            self._put_record(
                owner,
                {
                    "key_type": vu.pub_key_type,
                    "pub_key": vu.pub_key,
                    "pop": vu.pop or b"",
                    "power": vu.power,
                },
            )
        return t.ResponseInitChain()

    @staticmethod
    def _address_of(key_type: str, pub_key: bytes) -> bytes:
        if key_type == "bls12381":
            from ..crypto.bls.keys import BlsPubKey

            return BlsPubKey(pub_key).address()
        from ..crypto.keys import Ed25519PubKey

        return Ed25519PubKey(pub_key).address()

    def begin_block(self, req: t.RequestBeginBlock) -> t.ResponseBeginBlock:
        self._pending_updates = []
        return t.ResponseBeginBlock()

    def _payload_prefix(self):
        return (b"bank:", b"stake:")

    def _check_semantics(self, sender: bytes, fee: int, body: bytes):
        if body.startswith(b"bank:"):
            return super()._check_semantics(sender, fee, body)
        return self._check_stake(sender, fee, body)

    # -- stake verbs -------------------------------------------------------
    def _check_stake(self, sender: bytes, fee: int, body: bytes):
        """Returns (code, log, apply_thunk) like bank._check_semantics."""
        parts = body.split(b":")
        if len(parts) < 4:
            return CODE_MALFORMED, "malformed stake tx", None
        verb = parts[1]
        try:
            nonce = int(parts[-1])
        except ValueError:
            return CODE_MALFORMED, "malformed stake nonce", None
        balance, expected_nonce = self._account(sender)
        if nonce != expected_nonce:
            return CODE_BAD_NONCE, f"bad nonce: got {nonce}, want {expected_nonce}", None
        if fee > balance:
            return CODE_INSUFFICIENT_FUNDS, f"insufficient funds for fee: have {balance}", None
        balance -= fee
        rec = self.validators.get(sender)

        if verb == b"bond":
            try:
                amount = int(parts[2])
            except ValueError:
                return CODE_MALFORMED, "malformed bond amount", None
            if amount <= 0 or len(parts) != 4:
                return CODE_MALFORMED, "bond amount must be positive", None
            if amount > balance:
                return (
                    CODE_INSUFFICIENT_FUNDS,
                    f"insufficient funds: have {balance}, bond {amount}",
                    None,
                )
            if rec is None:
                holder = self.by_pubkey.get(self._sender_pubkey)
                if holder is not None and holder != sender:
                    return CODE_KEY_IN_USE, "consensus key already registered", None
            return CODE_OK, "", self._apply_bond(
                sender, fee, amount, expected_nonce, self._sender_pubkey
            )

        if verb == b"unbond":
            try:
                amount = int(parts[2])
            except ValueError:
                return CODE_MALFORMED, "malformed unbond amount", None
            if amount <= 0 or len(parts) != 4:
                return CODE_MALFORMED, "unbond amount must be positive", None
            if rec is None:
                return CODE_NO_VALIDATOR, "no validator bonded for sender", None
            if amount > rec["power"]:
                return CODE_NO_VALIDATOR, f"unbond {amount} > bonded {rec['power']}", None
            return CODE_OK, "", self._apply_delta(sender, fee, -amount, expected_nonce)

        if verb == b"edit":
            try:
                power = int(parts[2])
            except ValueError:
                return CODE_MALFORMED, "malformed power", None
            if power < 0 or len(parts) != 4:
                return CODE_MALFORMED, "power must be >= 0", None
            if rec is None:
                return CODE_NO_VALIDATOR, "no validator bonded for sender", None
            delta = power - rec["power"]
            if delta > balance:
                return (
                    CODE_INSUFFICIENT_FUNDS,
                    f"insufficient funds: have {balance}, need {delta}",
                    None,
                )
            return CODE_OK, "", self._apply_delta(sender, fee, delta, expected_nonce)

        if verb == b"rotate":
            if len(parts) not in (5, 6):
                return CODE_MALFORMED, "malformed rotate tx", None
            if rec is None:
                return CODE_NO_VALIDATOR, "no validator bonded for sender", None
            key_type = parts[2].decode(errors="replace")
            if key_type not in _KNOWN_CONSENSUS_KEY_TYPES:
                return CODE_BAD_KEY, f"unknown consensus key type {key_type}", None
            try:
                new_pub = base64.b64decode(parts[3], validate=True)
                pop = base64.b64decode(parts[4], validate=True) if len(parts) == 6 else b""
            except Exception:
                return CODE_MALFORMED, "malformed rotate key encoding", None
            expect_len = 48 if key_type == "bls12381" else 32
            if len(new_pub) != expect_len:
                return CODE_BAD_KEY, f"{key_type} pubkey must be {expect_len} bytes", None
            holder = self.by_pubkey.get(new_pub)
            if holder is not None and holder != sender:
                return CODE_KEY_IN_USE, "consensus key already registered", None
            if key_type == "bls12381":
                # PoP verified HERE so a forged key never reaches end_block
                # (validator_updates_from_abci would reject the whole block)
                if not pop:
                    return CODE_BAD_POP, "bls12381 rotation requires a proof of possession", None
                try:
                    from ..crypto.bls.keys import BlsPubKey

                    if not BlsPubKey(new_pub).verify_pop(pop):
                        return CODE_BAD_POP, "invalid proof of possession", None
                except Exception:
                    return CODE_BAD_POP, "invalid bls12381 pubkey", None
            return CODE_OK, "", self._apply_rotate(
                sender, fee, key_type, new_pub, pop, expected_nonce
            )

        return CODE_MALFORMED, f"unknown stake verb {verb!r}", None

    def _settle(self, sender: bytes, fee: int, stake_delta: int, expected_nonce: int) -> None:
        """Debit fee + stake delta (negative delta credits) and bump nonce."""
        balance, _ = self._account(sender)
        self._put_account(sender, balance - fee - stake_delta, expected_nonce + 1)
        self.fee_pool += fee
        self.tx_count += 1

    def _apply_bond(
        self, sender: bytes, fee: int, amount: int, expected_nonce: int, sender_pub: bytes
    ):
        def apply():
            rec = self.validators.get(sender)
            if rec is None:
                # first bond: the envelope (ed25519) key becomes the
                # consensus key — a joining validator in one tx
                rec = {"key_type": "ed25519", "pub_key": sender_pub,
                       "pop": b"", "power": 0}
            rec = dict(rec)
            rec["power"] += amount
            self._put_record(sender, rec)
            self._settle(sender, fee, amount, expected_nonce)
            self._pending_updates.append(self._update_for(rec, rec["power"]))

        return apply

    def _apply_delta(self, sender: bytes, fee: int, delta: int, expected_nonce: int):
        def apply():
            rec = dict(self.validators[sender])
            rec["power"] += delta
            if rec["power"] <= 0:
                self._pending_updates.append(self._update_for(rec, 0))
                self._drop_record(sender)
            else:
                self._put_record(sender, rec)
                self._pending_updates.append(self._update_for(rec, rec["power"]))
            self._settle(sender, fee, delta, expected_nonce)

        return apply

    def _apply_rotate(
        self, sender: bytes, fee: int, key_type: str, new_pub: bytes, pop: bytes,
        expected_nonce: int,
    ):
        def apply():
            old = dict(self.validators[sender])
            if new_pub != old["pub_key"]:
                self._pending_updates.append(self._update_for(old, 0))
                self.by_pubkey.pop(old["pub_key"], None)
            new = {"key_type": key_type, "pub_key": new_pub, "pop": pop,
                   "power": old["power"]}
            self._put_record(sender, new)
            self._pending_updates.append(self._update_for(new, new["power"]))
            self._settle(sender, fee, 0, expected_nonce)

        return apply

    # envelope pubkey of the tx currently being checked/delivered (first-
    # bond join registers it as the consensus key)
    _sender_pubkey: bytes = b""

    def check_tx(self, req: t.RequestCheckTx) -> t.ResponseCheckTx:
        from ..mempool import parse_signed_tx

        parsed = parse_signed_tx(req.tx)
        self._sender_pubkey = parsed[0] if parsed is not None else b""
        try:
            return super().check_tx(req)
        finally:
            self._sender_pubkey = b""

    def deliver_tx(self, req: t.RequestDeliverTx) -> t.ResponseDeliverTx:
        from ..mempool import parse_signed_tx

        parsed = parse_signed_tx(req.tx)
        self._sender_pubkey = parsed[0] if parsed is not None else b""
        try:
            return super().deliver_tx(req)
        finally:
            self._sender_pubkey = b""

    # -- epoch rotation + end_block ----------------------------------------
    def _epoch_rotation(self, height: int) -> List[t.ValidatorUpdate]:
        """Barrel-shift the power assignment among bonded validators in
        owner order — deterministic from committed state, so every node
        emits the identical updates with zero tx traffic."""
        if self.epoch_length <= 0 or height <= 0 or height % self.epoch_length != 0:
            return []
        owners = sorted(self.validators)
        if len(owners) < 2:
            return []
        powers = [self.validators[o]["power"] for o in owners]
        shifted = powers[-1:] + powers[:-1]
        out: List[t.ValidatorUpdate] = []
        for owner, power in zip(owners, shifted):
            if self.validators[owner]["power"] == power:
                continue
            rec = dict(self.validators[owner])
            rec["power"] = power
            self._put_record(owner, rec)
            out.append(self._update_for(rec, power))
        return out

    def end_block(self, req: t.RequestEndBlock) -> t.ResponseEndBlock:
        merged: Dict[tuple, t.ValidatorUpdate] = {}
        for vu in self._pending_updates + self._epoch_rotation(req.height):
            merged[(vu.pub_key_type, vu.pub_key)] = vu
        return t.ResponseEndBlock(validator_updates=list(merged.values()))

    # -- commit / query ----------------------------------------------------
    def _state_digest(self) -> bytes:
        h = hashlib.sha256(super()._state_digest())
        h.update(struct.pack("<Q", self.epoch_length))
        for owner in sorted(self.validators):
            rec = self.validators[owner]
            h.update(owner)
            h.update(rec["key_type"].encode())
            h.update(rec["pub_key"])
            h.update(struct.pack("<q", rec["power"]))
        return h.digest()

    def query(self, req: t.RequestQuery) -> t.ResponseQuery:
        if req.path == "validator":
            rec = self.validators.get(req.data)
            if rec is None:
                return t.ResponseQuery(code=1, log="no such validator")
            return t.ResponseQuery(
                code=t.CODE_TYPE_OK,
                key=req.data,
                value=json.dumps(
                    {
                        "key_type": rec["key_type"],
                        "pub_key": rec["pub_key"].hex(),
                        "power": rec["power"],
                    },
                    sort_keys=True,
                ).encode(),
                height=self.height,
            )
        if req.path == "validators":
            return t.ResponseQuery(
                code=t.CODE_TYPE_OK,
                value=json.dumps(
                    {
                        o.hex(): {
                            "key_type": r["key_type"],
                            "pub_key": r["pub_key"].hex(),
                            "power": r["power"],
                        }
                        for o, r in sorted(self.validators.items())
                    },
                    sort_keys=True,
                ).encode(),
                height=self.height,
            )
        return super().query(req)

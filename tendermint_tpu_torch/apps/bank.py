"""Bank: a contended-state account/transfer application (the port's copy of
tendermint_tpu/apps/bank.py).

Every tx rides the signed-tx envelope (mempool.py: pubkey ‖ sig ‖ payload,
batch-verified by the mempool's sig precheck); the account is the signer's
ed25519 address, so two clients fighting over one account produce REAL
app-level conflicts — bad nonces and overdrafts rejected by CheckTx and
DeliverTx — which is exactly the workload the QoS mempool and the chaos
checker could not generate from the kvstore app.

Payload grammar (after an optional ``fee:<n>:`` priority prefix — the fee
is not just a mempool hint here, it is DEBITED from the sender):

    bank:send:<to_hex40>:<amount>:<nonce>

Nonces are strictly sequential per account (the stored nonce is the next
expected), so replays and out-of-order floods are rejected deterministically
on every node.  Accounts are opened lazily with ``faucet`` units on first
touch (genesis `app_state` / InitChain `app_state_bytes` JSON can seed
explicit balances and override the faucet), keeping load generators free of
a separate funding round while overdrafts stay reachable.

app_hash commits to the full sorted account state every block — two nodes
that diverge on one balance halt with an app-hash mismatch instead of
silently forking.
"""

from __future__ import annotations

import hashlib
import json
import struct
from typing import Dict, Optional, Tuple

from ..abci import types as t
from ..crypto.keys import Ed25519PubKey
from ..libs.kvstore import KVStore, MemDB
from ..mempool import make_signed_tx, parse_signed_tx, tx_priority

_ACCT_PREFIX = b"__acct__"
_STATE_KEY = b"__bankstate__"

# deliver/check rejection codes (surface on ResponseDeliverTx/CheckTx.code)
CODE_OK = t.CODE_TYPE_OK
CODE_MALFORMED = 10
CODE_BAD_SIG = 11
CODE_BAD_NONCE = 12
CODE_INSUFFICIENT_FUNDS = 13

DEFAULT_FAUCET = 1_000_000


def make_transfer_tx(priv_key, to_addr: bytes, amount: int, nonce: int, fee: int = 0) -> bytes:
    """Client helper: a signed bank transfer (fee prefix inside the
    envelope so tx_priority sees it and the app debits it)."""
    payload = b"bank:send:%s:%d:%d" % (to_addr.hex().encode(), amount, nonce)
    if fee > 0:
        payload = b"fee:%d:" % fee + payload
    return make_signed_tx(priv_key, payload)


def _strip_fee(payload: bytes) -> Tuple[int, bytes]:
    """(fee, remaining payload) — mirrors mempool.tx_priority's bounded
    parse so the app and the mempool always agree on the fee."""
    if payload.startswith(b"fee:"):
        end = payload.find(b":", 4)
        if 4 < end <= 23:
            digits = payload[4:end]
            if digits.isdigit():
                return int(digits), payload[end + 1 :]
    return 0, payload


class BankApplication(t.Application):
    """Account balances + strictly-sequential nonces + fee debits."""

    def __init__(self, db: Optional[KVStore] = None, faucet: int = DEFAULT_FAUCET):
        self.db = db or MemDB()
        self.faucet = faucet
        self.height = 0
        self.app_hash = b""
        self.tx_count = 0
        self.fee_pool = 0
        # addr(20B) -> (balance, next_nonce); authoritative copy in db
        self.accounts: Dict[bytes, Tuple[int, int]] = {}
        self._load_state()

    # -- persistence -------------------------------------------------------
    def _load_state(self) -> None:
        raw = self.db.get(_STATE_KEY)
        if raw:
            self.height, self.tx_count, self.fee_pool, self.faucet = struct.unpack(
                "<QQQQ", raw[:32]
            )
            self.app_hash = raw[32:]
        for k, v in self.db.iterate_prefix(_ACCT_PREFIX):
            self.accounts[k[len(_ACCT_PREFIX):]] = struct.unpack("<QQ", v)

    def _save_state(self) -> None:
        self.db.set(
            _STATE_KEY,
            struct.pack("<QQQQ", self.height, self.tx_count, self.fee_pool, self.faucet)
            + self.app_hash,
        )

    def _put_account(self, addr: bytes, balance: int, nonce: int) -> None:
        self.accounts[addr] = (balance, nonce)
        self.db.set(_ACCT_PREFIX + addr, struct.pack("<QQ", balance, nonce))

    def _account(self, addr: bytes) -> Tuple[int, int]:
        """Balance/nonce with lazy faucet opening (NOT persisted until the
        first successful debit/credit — reads stay side-effect free so
        CheckTx cannot diverge state across nodes)."""
        acct = self.accounts.get(addr)
        return acct if acct is not None else (self.faucet, 0)

    # -- ABCI --------------------------------------------------------------
    def info(self, req: t.RequestInfo) -> t.ResponseInfo:
        return t.ResponseInfo(
            data='{"accounts":%d}' % len(self.accounts),
            version="0.1.0",
            app_version=1,
            last_block_height=self.height,
            last_block_app_hash=self.app_hash,
        )

    def init_chain(self, req: t.RequestInitChain) -> t.ResponseInitChain:
        self._apply_genesis_state(req.app_state_bytes)
        return t.ResponseInitChain()

    def _apply_genesis_state(self, app_state_bytes: bytes) -> None:
        if not app_state_bytes:
            return
        try:
            doc = json.loads(app_state_bytes.decode())
        except Exception:
            return
        bank = doc.get("bank", doc) if isinstance(doc, dict) else {}
        if "faucet" in bank:
            self.faucet = int(bank["faucet"])
        for addr_hex, balance in (bank.get("accounts") or {}).items():
            self._put_account(bytes.fromhex(addr_hex), int(balance), 0)

    # -- tx parsing --------------------------------------------------------
    def _parse(self, tx: bytes):
        """(sender_addr, fee, verb_args, pubkey, sign_bytes, sig) or an
        error-coded ResponseCheckTx-shaped tuple (None, code, log)."""
        parsed = parse_signed_tx(tx)
        if parsed is None:
            return None, CODE_MALFORMED, "not a signed-tx envelope"
        pubkey, sign_bytes, sig, payload = parsed
        fee, body = _strip_fee(payload)
        if not body.startswith(self._payload_prefix()):
            return None, CODE_MALFORMED, "unknown payload"
        sender = Ed25519PubKey(pubkey).address()
        return (sender, fee, body, pubkey, sign_bytes, sig), CODE_OK, ""

    def _payload_prefix(self):
        # tuple: subclasses widen the accepted verb space (staking)
        return (b"bank:",)

    def _verify_sig(self, pubkey: bytes, sign_bytes: bytes, sig: bytes) -> bool:
        try:
            return Ed25519PubKey(pubkey).verify(sign_bytes, sig)
        except Exception:
            return False

    def _check_semantics(self, sender: bytes, fee: int, body: bytes):
        """Stateless+stateful validation shared by CheckTx and DeliverTx.
        Returns (code, log, apply_thunk)."""
        try:
            _, verb, to_hex, amount_s, nonce_s = body.split(b":")
            if verb != b"send":
                raise ValueError
            to_addr = bytes.fromhex(to_hex.decode())
            amount, nonce = int(amount_s), int(nonce_s)
            if len(to_addr) != 20 or amount < 0:
                raise ValueError
        except ValueError:
            return CODE_MALFORMED, "malformed bank tx", None
        balance, expected_nonce = self._account(sender)
        if nonce != expected_nonce:
            return (
                CODE_BAD_NONCE,
                f"bad nonce: got {nonce}, want {expected_nonce}",
                None,
            )
        if amount + fee > balance:
            return (
                CODE_INSUFFICIENT_FUNDS,
                f"insufficient funds: have {balance}, need {amount + fee}",
                None,
            )

        def apply():
            if to_addr == sender:
                # self-transfer: only the fee leaves the account
                self._put_account(sender, balance - fee, expected_nonce + 1)
            else:
                self._put_account(sender, balance - amount - fee, expected_nonce + 1)
                to_balance, to_nonce = self._account(to_addr)
                self._put_account(to_addr, to_balance + amount, to_nonce)
            self.fee_pool += fee
            self.tx_count += 1

        return CODE_OK, "", apply

    def check_tx(self, req: t.RequestCheckTx) -> t.ResponseCheckTx:
        parsed, code, log = self._parse(req.tx)
        if parsed is None:
            return t.ResponseCheckTx(code=code, log=log)
        sender, fee, body, _, _, _ = parsed
        # signature: trusted to the mempool's batched sig precheck on the
        # CheckTx path (it rejects bad envelopes before the app sees them)
        code, log, _ = self._check_semantics(sender, fee, body)
        return t.ResponseCheckTx(
            code=code, log=log, gas_wanted=1, priority=tx_priority(req.tx)
        )

    def deliver_tx(self, req: t.RequestDeliverTx) -> t.ResponseDeliverTx:
        parsed, code, log = self._parse(req.tx)
        if parsed is None:
            return t.ResponseDeliverTx(code=code, log=log)
        sender, fee, body, pubkey, sign_bytes, sig = parsed
        # DeliverTx MUST verify: block txs arrive from the proposer without
        # ever passing this node's CheckTx (on the host, through the C
        # library, as the JAX app does)
        if not self._verify_sig(pubkey, sign_bytes, sig):
            return t.ResponseDeliverTx(code=CODE_BAD_SIG, log="bad signature")
        code, log, apply = self._check_semantics(sender, fee, body)
        if code != CODE_OK:
            return t.ResponseDeliverTx(code=code, log=log)
        apply()
        return t.ResponseDeliverTx(
            code=CODE_OK,
            events=[
                t.Event(
                    type="bank",
                    attributes=[{"key": b"sender", "value": sender.hex().encode()}],
                )
            ],
        )

    # -- commit ------------------------------------------------------------
    def _state_digest(self) -> bytes:
        h = hashlib.sha256()
        h.update(struct.pack("<QQQ", self.height, self.tx_count, self.fee_pool))
        for addr in sorted(self.accounts):
            balance, nonce = self.accounts[addr]
            h.update(addr + struct.pack("<QQ", balance, nonce))
        return h.digest()

    def commit(self, req: t.RequestCommit = None) -> t.ResponseCommit:
        self.height += 1
        self.app_hash = self._state_digest()
        self._save_state()
        return t.ResponseCommit(data=self.app_hash)

    # -- query -------------------------------------------------------------
    def query(self, req: t.RequestQuery) -> t.ResponseQuery:
        if req.path == "balance":
            balance, _ = self._account(req.data)
            return t.ResponseQuery(
                code=t.CODE_TYPE_OK, key=req.data, value=str(balance).encode(),
                height=self.height,
            )
        if req.path == "nonce":
            _, nonce = self._account(req.data)
            return t.ResponseQuery(
                code=t.CODE_TYPE_OK, key=req.data, value=str(nonce).encode(),
                height=self.height,
            )
        if req.path == "fee_pool":
            return t.ResponseQuery(
                code=t.CODE_TYPE_OK, value=str(self.fee_pool).encode(),
                height=self.height,
            )
        return t.ResponseQuery(code=1, log=f"unknown query path {req.path!r}")

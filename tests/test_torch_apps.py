"""The port's bank and staking apps (tendermint_tpu_torch/apps) against the
JAX package's (tendermint_tpu/apps), tolerance exact.

- Every scenario of tests/test_apps.py runs through both packages' apps
  from the same seeded keys: each gives a transcript of its codes, logs,
  events, validator updates, query answers, balances and app hashes, and
  the two transcripts must be equal (the JAX test's own assertions are
  checked on both), the bls12381 rotation with its proof of possession
  included.
- A seeded hypothesis property: random mixes of bank and stake txs, some
  malformed, some with bad nonces, fees or signatures, over 20 blocks give
  equal responses, validator updates and app hashes.
- Fault 3.13 (ROADMAP 3), kept as JAX: CheckTx reads a nonce against
  committed state only, so a sender's second tx before the next commit is
  refused with 12 in both packages.
- A 4-validator staking chain through each package's BlockExecutor
  (validator_updates_from_abci, update_state): a set that grows, shrinks,
  rotates a key and changes only its powers at an epoch gives equal states
  and app hashes at every height.
"""

import asyncio
import dataclasses
import json
import types

import pytest
from hypothesis import HealthCheck, given, settings
from hypothesis import seed as hseed
from hypothesis import strategies as st

import tendermint_tpu.abci.types as jabci
import tendermint_tpu.apps.bank as jbank
import tendermint_tpu.apps.staking as jstaking
import tendermint_tpu.libs.kvstore as jkvstore
import tendermint_tpu.mempool as jmempool
import tendermint_tpu.proxy as jproxy
from tendermint_tpu.crypto.keys import Ed25519PrivKey as JPrivKey
from tendermint_tpu_torch import proxy as pproxy
from tendermint_tpu_torch.abci import types as pabci
from tendermint_tpu_torch.apps import bank as pbank
from tendermint_tpu_torch.apps import staking as pstaking
from tendermint_tpu_torch.crypto.keys import Ed25519PrivKey as PPrivKey
from tendermint_tpu_torch.libs import kvstore as pkvstore
from tendermint_tpu_torch import mempool as pmempool

PORT = types.SimpleNamespace(name="port", t=pabci, bank=pbank, staking=pstaking,
                             Key=PPrivKey, MemDB=pkvstore.MemDB, mempool=pmempool,
                             proxy=pproxy)
JAX = types.SimpleNamespace(name="jax", t=jabci, bank=jbank, staking=jstaking,
                            Key=JPrivKey, MemDB=jkvstore.MemDB, mempool=jmempool,
                            proxy=jproxy)


def norm(x):
    """A package-free view: dataclasses as (class name, fields), recursively."""
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return (type(x).__name__, {f.name: norm(getattr(x, f.name)) for f in dataclasses.fields(x)})
    if isinstance(x, (list, tuple)):
        return [norm(v) for v in x]
    if isinstance(x, dict):
        return {k: norm(v) for k, v in x.items()}
    return x


def key(P, seed: int):
    return P.Key.from_secret(bytes([seed]) * 32)


def addr(priv) -> bytes:
    return priv.pub_key().address()


class Run:
    """One package's run of a scenario: the app calls, each answer logged."""

    def __init__(self, P):
        self.P, self.t, self.log = P, P.t, []

    def note(self, what, value):
        self.log.append((what, norm(value)))
        return value

    def block(self, app, height, *txs):
        """tests/test_apps.py `_block`: begin, deliver each tx, end, commit."""
        t = self.t
        app.begin_block(t.RequestBeginBlock())
        res = [self.note("deliver", app.deliver_tx(t.RequestDeliverTx(tx=tx))) for tx in txs]
        eb = self.note("end_block", app.end_block(t.RequestEndBlock(height=height)))
        self.note("commit", app.commit())
        return res, eb.validator_updates

    def deliver(self, app, tx):
        return self.note("deliver", app.deliver_tx(self.t.RequestDeliverTx(tx=tx)))

    def check(self, app, tx):
        return self.note("check", app.check_tx(self.t.RequestCheckTx(tx=tx)))

    def query(self, app, path, data=b""):
        return self.note("query", app.query(self.t.RequestQuery(path=path, data=data)))

    def account(self, app, a):
        return self.note("account", app._account(a))


# -- the scenarios of tests/test_apps.py, one function of the package each ------------


def bank_transfer_moves_balance_and_debits_fee(r):
    P = r.P
    app = P.bank.BankApplication()
    a, b = key(P, 1), key(P, 2)
    (res,), _ = r.block(app, 1, P.bank.make_transfer_tx(a, addr(b), 100, 0, fee=7))
    assert res.code == P.bank.CODE_OK
    assert r.account(app, addr(a)) == (P.bank.DEFAULT_FAUCET - 107, 1)
    assert r.account(app, addr(b)) == (P.bank.DEFAULT_FAUCET + 100, 0)
    assert r.note("fee_pool", app.fee_pool) == 7


def bank_nonces_strictly_sequential(r):
    P = r.P
    app = P.bank.BankApplication()
    a, b = key(P, 1), key(P, 2)
    replay = P.bank.make_transfer_tx(a, addr(b), 1, 0)
    (r0,), _ = r.block(app, 1, replay)
    assert r0.code == P.bank.CODE_OK
    assert r.deliver(app, replay).code == P.bank.CODE_BAD_NONCE
    assert r.deliver(app, P.bank.make_transfer_tx(a, addr(b), 1, 2)).code == P.bank.CODE_BAD_NONCE
    assert r.deliver(app, P.bank.make_transfer_tx(a, addr(b), 1, 1)).code == P.bank.CODE_OK


def bank_overdraft_rejected_checktx_and_delivertx(r):
    P = r.P
    app = P.bank.BankApplication(faucet=50)
    a, b = key(P, 1), key(P, 2)
    tx = P.bank.make_transfer_tx(a, addr(b), 51, 0)
    assert r.check(app, tx).code == P.bank.CODE_INSUFFICIENT_FUNDS
    assert r.deliver(app, tx).code == P.bank.CODE_INSUFFICIENT_FUNDS
    tx2 = P.bank.make_transfer_tx(a, addr(b), 45, 0, fee=6)
    assert r.deliver(app, tx2).code == P.bank.CODE_INSUFFICIENT_FUNDS


def bank_delivertx_verifies_signature(r):
    P = r.P
    app = P.bank.BankApplication()
    tx = bytearray(P.bank.make_transfer_tx(key(P, 1), addr(key(P, 2)), 10, 0))
    tx[-1] ^= 0x01
    assert r.deliver(app, bytes(tx)).code == P.bank.CODE_BAD_SIG


def bank_malformed_payloads_rejected(r):
    P = r.P
    app = P.bank.BankApplication()
    a = key(P, 1)
    for payload in (b"bank:send:zz:1:0", b"bank:mint:00:1:0", b"noise"):
        assert r.deliver(app, P.mempool.make_signed_tx(a, payload)).code == P.bank.CODE_MALFORMED
    assert r.deliver(app, b"raw bytes").code == P.bank.CODE_MALFORMED


def bank_self_transfer_conserves_balance(r):
    P = r.P
    app = P.bank.BankApplication()
    a = key(P, 1)
    (res,), _ = r.block(app, 1, P.bank.make_transfer_tx(a, addr(a), 500, 0))
    assert res.code == P.bank.CODE_OK
    assert r.account(app, addr(a)) == (P.bank.DEFAULT_FAUCET, 1)


def bank_apphash_deterministic_across_replicas(r):
    P = r.P
    txs = [
        P.bank.make_transfer_tx(key(P, 1), addr(key(P, 2)), 10, 0, fee=1),
        P.bank.make_transfer_tx(key(P, 2), addr(key(P, 3)), 20, 0),
        P.bank.make_transfer_tx(key(P, 1), addr(key(P, 3)), 30, 1),
    ]
    hashes = []
    for _ in range(2):
        app = P.bank.BankApplication()
        r.block(app, 1, *txs)
        hashes.append(r.note("app_hash", app.app_hash))
    assert hashes[0] == hashes[1] and hashes[0]


def bank_genesis_state_seeds_accounts_and_faucet(r):
    P = r.P
    app = P.bank.BankApplication()
    rich = addr(key(P, 9))
    state = json.dumps({"bank": {"faucet": 5, "accounts": {rich.hex(): 12345}}}).encode()
    r.note("init_chain", app.init_chain(r.t.RequestInitChain(app_state_bytes=state)))
    assert r.note("faucet", app.faucet) == 5
    assert r.account(app, rich) == (12345, 0)
    assert r.account(app, addr(key(P, 8))) == (5, 0)


def bank_query_paths(r):
    P = r.P
    app = P.bank.BankApplication()
    a, b = key(P, 1), key(P, 2)
    r.block(app, 1, P.bank.make_transfer_tx(a, addr(b), 10, 0, fee=3))
    q = r.query(app, "balance", addr(a))
    assert q.code == r.t.CODE_TYPE_OK and int(q.value) == P.bank.DEFAULT_FAUCET - 13
    assert int(r.query(app, "nonce", addr(a)).value) == 1
    assert int(r.query(app, "fee_pool").value) == 3
    assert r.query(app, "nope").code != r.t.CODE_TYPE_OK
    r.note("info", app.info(r.t.RequestInfo()))


def _genesis_update(r, priv, power):
    return r.t.ValidatorUpdate(pub_key_type="ed25519", pub_key=priv.pub_key().bytes(), power=power)


def staking_init_chain_registers_genesis_validators(r):
    P = r.P
    app = P.staking.StakingApplication()
    g = key(P, 1)
    r.note("init_chain", app.init_chain(r.t.RequestInitChain(
        validators=[_genesis_update(r, g, 10)],
        app_state_bytes=json.dumps({"staking": {"epoch_length": 16}}).encode())))
    assert r.note("epoch_length", app.epoch_length) == 16
    rec = r.note("record", app.validators[addr(g)])
    assert rec["power"] == 10 and rec["pub_key"] == g.pub_key().bytes()


def staking_bond_joins_and_emits_update(r):
    P = r.P
    app = P.staking.StakingApplication()
    owner = key(P, 5)
    (res,), updates = r.block(app, 1, P.staking.make_bond_tx(owner, 40, 0))
    assert res.code == P.bank.CODE_OK and len(updates) == 1
    vu = updates[0]
    assert (vu.pub_key_type, vu.pub_key, vu.power) == ("ed25519", owner.pub_key().bytes(), 40)
    assert r.account(app, addr(owner)) == (P.bank.DEFAULT_FAUCET - 40, 1)
    _, updates = r.block(app, 2, P.staking.make_bond_tx(owner, 5, 1))
    assert updates[0].power == 45


def staking_bond_overdraft_rejected(r):
    P = r.P
    app = P.staking.StakingApplication(faucet=30)
    assert (r.check(app, P.staking.make_bond_tx(key(P, 5), 31, 0)).code
            == P.bank.CODE_INSUFFICIENT_FUNDS)


def staking_unbond_partial_and_full(r):
    P = r.P
    app = P.staking.StakingApplication()
    owner = key(P, 5)
    r.block(app, 1, P.staking.make_bond_tx(owner, 40, 0))
    (res,), updates = r.block(app, 2, P.staking.make_unbond_tx(owner, 15, 1))
    assert res.code == P.bank.CODE_OK and updates[0].power == 25
    assert r.account(app, addr(owner)) == (P.bank.DEFAULT_FAUCET - 25, 2)
    assert (r.deliver(app, P.staking.make_unbond_tx(owner, 26, 2)).code
            == P.staking.CODE_NO_VALIDATOR)
    _, updates = r.block(app, 3, P.staking.make_unbond_tx(owner, 25, 2))
    assert updates[0].power == 0 and addr(owner) not in app.validators
    assert r.account(app, addr(owner)) == (P.bank.DEFAULT_FAUCET, 3)


def staking_edit_power_settles_difference(r):
    P = r.P
    app = P.staking.StakingApplication()
    owner = key(P, 5)
    r.block(app, 1, P.staking.make_bond_tx(owner, 40, 0))
    _, updates = r.block(app, 2, P.staking.make_edit_power_tx(owner, 25, 1))
    assert updates[0].power == 25
    assert r.account(app, addr(owner)) == (P.bank.DEFAULT_FAUCET - 25, 2)
    _, updates = r.block(app, 3, P.staking.make_edit_power_tx(owner, 0, 2))
    assert updates[0].power == 0 and addr(owner) not in app.validators
    assert r.account(app, addr(owner)) == (P.bank.DEFAULT_FAUCET, 3)


def staking_verbs_require_bonded_validator(r):
    P = r.P
    app = P.staking.StakingApplication()
    owner = key(P, 5)
    for tx in (P.staking.make_unbond_tx(owner, 1, 0), P.staking.make_edit_power_tx(owner, 1, 0),
               P.staking.make_rotate_key_tx(owner, "ed25519", key(P, 6).pub_key().bytes(), 0)):
        assert r.deliver(app, tx).code == P.staking.CODE_NO_VALIDATOR


def staking_bond_rejects_consensus_key_held_by_other_owner(r):
    P = r.P
    app = P.staking.StakingApplication()
    a, b = key(P, 5), key(P, 6)
    r.block(app, 1, P.staking.make_bond_tx(a, 10, 0))
    r.block(app, 2, P.staking.make_rotate_key_tx(a, "ed25519", b.pub_key().bytes(), 1))
    assert r.deliver(app, P.staking.make_bond_tx(b, 10, 0)).code == P.staking.CODE_KEY_IN_USE


def staking_rotate_to_bls_requires_valid_pop(r):
    """The JAX case: no PoP is 22 (and an unknown type or a wrong length
    21); another key's PoP is 22 and the key's own is accepted, in CheckTx
    and DeliverTx alike.  Each package's BLS key signs its own PoP."""
    P = r.P
    bls_mod = (__import__("tendermint_tpu_torch.crypto.bls.keys", fromlist=["BlsPrivKey"])
               if P is PORT else __import__("tendermint_tpu.crypto.bls.keys",
                                            fromlist=["BlsPrivKey"]))
    BlsPrivKey = bls_mod.BlsPrivKey
    app = P.staking.StakingApplication()
    owner = key(P, 5)
    r.block(app, 1, P.staking.make_bond_tx(owner, 40, 0))
    bls = BlsPrivKey.from_secret(b"\x07" * 32)
    pub = bls.pub_key().bytes()
    rotate = P.staking.make_rotate_key_tx
    assert r.deliver(app, rotate(owner, "bls12381", pub, 1)).code == P.staking.CODE_BAD_POP
    assert r.check(app, rotate(owner, "bls12381", pub, 1)).code == P.staking.CODE_BAD_POP
    assert r.deliver(app, rotate(owner, "bls12381", pub[:47], 1)).code == P.staking.CODE_BAD_KEY
    assert r.deliver(app, rotate(owner, "bls12382", pub, 1)).code == P.staking.CODE_BAD_KEY
    other_pop = BlsPrivKey.from_secret(b"\x08" * 32).pop()
    assert r.check(app, rotate(owner, "bls12381", pub, 1, pop=other_pop)).code == \
        P.staking.CODE_BAD_POP
    assert r.deliver(app, rotate(owner, "bls12381", pub, 1, pop=other_pop)).code == \
        P.staking.CODE_BAD_POP
    assert r.check(app, rotate(owner, "bls12381", pub, 1, pop=bls.pop())).code == P.staking.CODE_OK
    assert r.deliver(app, rotate(owner, "bls12381", pub, 1, pop=bls.pop())).code == \
        P.staking.CODE_OK
    r.note("updates", app.end_block(r.t.RequestEndBlock(height=2)).validator_updates)
    r.note("commit", app.commit())


def staking_rotate_rejects_key_in_use_and_bad_lengths(r):
    P = r.P
    app = P.staking.StakingApplication()
    a, b = key(P, 5), key(P, 6)
    r.block(app, 1, P.staking.make_bond_tx(a, 10, 0), P.staking.make_bond_tx(b, 10, 0))
    rotate = P.staking.make_rotate_key_tx
    assert r.deliver(app, rotate(a, "ed25519", b.pub_key().bytes(), 1)).code == P.staking.CODE_KEY_IN_USE
    assert r.deliver(app, rotate(a, "ed25519", b"\x01" * 31, 1)).code != P.bank.CODE_OK
    assert r.deliver(app, rotate(a, "sr25519", b"\x01" * 32, 1)).code != P.bank.CODE_OK


def staking_epoch_barrel_shift_is_deterministic(r):
    P = r.P

    def build():
        app = P.staking.StakingApplication(epoch_length=4)
        r.block(app, 1, *(P.staking.make_bond_tx(key(P, i), 10 * i, 0) for i in (1, 2, 3)))
        return app

    a, b = build(), build()
    assert r.block(a, 2)[1] == [] and r.block(b, 2)[1] == []
    assert r.block(a, 3)[1] == [] and r.block(b, 3)[1] == []
    ua, ub = r.block(a, 4)[1], r.block(b, 4)[1]
    assert ua == ub and ua
    assert sorted(rec["power"] for rec in a.validators.values()) == [10, 20, 30]
    for h in range(5, 8):
        r.block(a, h)
    assert r.block(a, 8)[1]
    for _ in range(4):
        for h in range(9, 13):
            r.block(a, h)
    assert r.note("app_hash", a.app_hash)


def staking_epoch_noop_for_single_validator(r):
    P = r.P
    app = P.staking.StakingApplication(epoch_length=2)
    r.block(app, 1, P.staking.make_bond_tx(key(P, 1), 10, 0))
    assert r.block(app, 2)[1] == []


def staking_records_persist_across_restart(r):
    P = r.P
    db = P.MemDB()
    app = P.staking.StakingApplication(db=db)
    r.note("init_chain", app.init_chain(r.t.RequestInitChain(
        app_state_bytes=json.dumps({"staking": {"epoch_length": 8}}).encode())))
    owner = key(P, 5)
    r.block(app, 1, P.staking.make_bond_tx(owner, 40, 0))
    app2 = P.staking.StakingApplication(db=db)
    assert r.note("epoch_length", app2.epoch_length) == 8
    rec = r.note("record", app2.validators[addr(owner)])
    assert rec["power"] == 40 and rec["pub_key"] == owner.pub_key().bytes()
    assert app2.by_pubkey[owner.pub_key().bytes()] == addr(owner)
    assert r.note("app_hash", app2.app_hash) == app.app_hash
    r.note("db", sorted(db.iterate_prefix(b"")))


def staking_query_paths(r):
    P = r.P
    app = P.staking.StakingApplication()
    owner = key(P, 5)
    r.block(app, 1, P.staking.make_bond_tx(owner, 40, 0))
    q = r.query(app, "validator", addr(owner))
    assert q.code == r.t.CODE_TYPE_OK
    rec = json.loads(q.value)
    assert rec["power"] == 40 and rec["key_type"] == "ed25519"
    assert addr(owner).hex() in json.loads(r.query(app, "validators").value)
    assert int(r.query(app, "nonce", addr(owner)).value) == 1
    assert r.query(app, "validator", b"\x00" * 20).code != 0


def staking_state_digest_covers_validator_records(r):
    P = r.P
    a, b = P.staking.StakingApplication(), P.staking.StakingApplication()
    r.block(a, 1, P.staking.make_bond_tx(key(P, 5), 40, 0))
    r.block(b, 1, P.staking.make_bond_tx(key(P, 5), 41, 0))
    assert r.note("a", a.app_hash) != r.note("b", b.app_hash)


def staking_bank_transfers_still_flow(r):
    P = r.P
    app = P.staking.StakingApplication()
    a, b = key(P, 1), key(P, 2)
    (r0, r1), updates = r.block(app, 1, P.bank.make_transfer_tx(a, addr(b), 10, 0),
                                P.staking.make_bond_tx(a, 5, 1))
    assert r0.code == P.bank.CODE_OK and r1.code == P.bank.CODE_OK
    assert len(updates) == 1 and updates[0].power == 5
    assert r.account(app, addr(a)) == (P.bank.DEFAULT_FAUCET - 15, 2)


SCENARIOS = [
    bank_transfer_moves_balance_and_debits_fee,
    bank_nonces_strictly_sequential,
    bank_overdraft_rejected_checktx_and_delivertx,
    bank_delivertx_verifies_signature,
    bank_malformed_payloads_rejected,
    bank_self_transfer_conserves_balance,
    bank_apphash_deterministic_across_replicas,
    bank_genesis_state_seeds_accounts_and_faucet,
    bank_query_paths,
    staking_init_chain_registers_genesis_validators,
    staking_bond_joins_and_emits_update,
    staking_bond_overdraft_rejected,
    staking_unbond_partial_and_full,
    staking_edit_power_settles_difference,
    staking_verbs_require_bonded_validator,
    staking_bond_rejects_consensus_key_held_by_other_owner,
    staking_rotate_to_bls_requires_valid_pop,
    staking_rotate_rejects_key_in_use_and_bad_lengths,
    staking_epoch_barrel_shift_is_deterministic,
    staking_epoch_noop_for_single_validator,
    staking_records_persist_across_restart,
    staking_query_paths,
    staking_state_digest_covers_validator_records,
    staking_bank_transfers_still_flow,
]


@pytest.mark.parametrize("scenario", SCENARIOS, ids=[f.__name__ for f in SCENARIOS])
def test_app_scenario_equals_jax(scenario):
    runs = {}
    for P in (JAX, PORT):
        runs[P.name] = Run(P)
        scenario(runs[P.name])
    assert runs["port"].log == runs["jax"].log and runs["port"].log


# -- builders, fee parse, BLS genesis ------------------------------------------------


@pytest.mark.parametrize("builder, args", [
    ("make_transfer_tx", (20, 0, 0)), ("make_transfer_tx", (7, 3, 9)),
    ("make_bond_tx", (40, 0, 0)), ("make_bond_tx", (1, 5, 2)),
    ("make_unbond_tx", (15, 1, 0)), ("make_edit_power_tx", (0, 2, 0)),
    ("make_edit_power_tx", (25, 4, 3)), ("make_rotate_key_tx", ("ed25519", 6, 1)),
    ("make_rotate_key_tx", ("bls12381", 6, 2, b"\x09" * 96, 1)),
])
def test_tx_builders_give_the_jax_bytes(builder, args):
    out = []
    for P in (JAX, PORT):
        k = key(P, 3)
        if builder == "make_transfer_tx":
            amount, nonce, fee = args
            out.append(P.bank.make_transfer_tx(k, addr(key(P, 4)), amount, nonce, fee=fee))
        elif builder == "make_rotate_key_tx":
            kt, seed, nonce, *rest = args
            pub = key(P, seed).pub_key().bytes() + (b"\x00" * 16 if kt == "bls12381" else b"")
            pop, fee = (rest + [b"", 0])[:2] if rest else (b"", 0)
            out.append(P.staking.make_rotate_key_tx(k, kt, pub, nonce, pop=pop, fee=fee))
        else:
            v, nonce, fee = args
            out.append(getattr(P.staking, builder)(k, v, nonce, fee=fee))
    assert out[0] == out[1]


@pytest.mark.parametrize("payload", [
    b"fee:12:bank:send", b"fee::x", b"fee:1a:x", b"fee:" + b"9" * 19 + b":x",
    b"fee:" + b"9" * 20 + b":x", b"bank:send:00:1:0", b"fee:0:stake:bond:1:0", b"fee:7"])
def test_strip_fee_agrees_with_the_mempools_priority(payload):
    tx = PORT.mempool.make_signed_tx(key(PORT, 1), payload)
    fee, rest = pbank._strip_fee(payload)
    assert (fee, rest) == jbank._strip_fee(payload)
    assert fee == pmempool.tx_priority(tx) == jmempool.tx_priority(tx)


def test_a_bls12381_genesis_validator_raises_naming_1_9():
    """A bls12381 genesis validator registers under its BLS address in both
    packages: equal InitChain answers, validator records and state digests
    (the name is from when the port refused it)."""
    from tendermint_tpu.crypto.bls.keys import BlsPrivKey

    pub = BlsPrivKey.from_secret(b"\x07" * 32).pub_key().bytes()
    out = []
    for P in (JAX, PORT):
        app = P.staking.StakingApplication()
        req = P.t.RequestInitChain(validators=[P.t.ValidatorUpdate("bls12381", pub, 10, b"\x01")])
        res = app.init_chain(req)
        out.append((norm(res), sorted((k, norm(v)) for k, v in app.validators.items()),
                    app._state_digest()))
    assert out[0] == out[1] and out[1][1]


# -- fault 3.13 -----------------------------------------------------------------------


@pytest.mark.parametrize("P", [JAX, PORT], ids=["jax", "port"])
def test_fault_3_13_checktx_refuses_a_second_nonce_before_the_commit(P):
    """ROADMAP 3.13, kept as JAX: CheckTx reads committed state only, so a
    sender's nonce 1 before the block with its nonce 0 commits is refused
    with 12 in both packages (what makes most of `loadgen --mode bank`'s
    txs come back app:12)."""
    app = P.bank.BankApplication()
    a, hot = key(P, 1), key(P, 2)
    t = P.t
    assert app.check_tx(t.RequestCheckTx(tx=P.bank.make_transfer_tx(a, addr(hot), 1, 0))).code == 0
    res = app.check_tx(t.RequestCheckTx(tx=P.bank.make_transfer_tx(a, addr(hot), 1, 1)))
    assert (res.code, res.log) == (P.bank.CODE_BAD_NONCE, "bad nonce: got 1, want 0")


# -- the property ---------------------------------------------------------------------

OPS = ("send", "bond", "unbond", "edit", "rotate", "malformed", "raw")
N_KEYS = 6


@hseed(17)
@settings(max_examples=12, deadline=None, derandomize=True,
          suppress_health_check=[HealthCheck.too_slow, HealthCheck.data_too_large])
@given(st.lists(st.lists(st.tuples(st.sampled_from(OPS), st.integers(0, N_KEYS - 1),
                                   st.integers(0, N_KEYS - 1), st.integers(-5, 60),
                                   st.sampled_from([0, 0, 0, 1, -1]), st.sampled_from([0, 0, 3]),
                                   st.booleans()),
                         max_size=5),
                min_size=20, max_size=20),
       st.sampled_from([0, 2, 3]))
def test_random_bank_and_stake_blocks_equal_jax(blocks, epoch):
    """20 blocks of random bank and stake txs (bad nonces, overdrafts,
    flipped signatures, garbage payloads among them) built once and fed to
    both packages' staking apps: equal responses, updates and app hashes."""
    jkeys = [JPrivKey.from_secret(b"prop-%d" % i) for i in range(N_KEYS)]
    apps = {"jax": jstaking.StakingApplication(epoch_length=epoch, faucet=200),
            "port": pstaking.StakingApplication(epoch_length=epoch, faucet=200)}
    runs = {"jax": Run(JAX), "port": Run(PORT)}
    ja = apps["jax"]
    for h, txs in enumerate(blocks, start=1):
        for P in (JAX, PORT):
            apps[P.name].begin_block(P.t.RequestBeginBlock())
        for op, s, o, amount, nonce_off, fee, flip in txs:
            sender = jkeys[s]
            nonce = ja._account(addr(sender))[1] + nonce_off
            if op == "send":
                tx = jbank.make_transfer_tx(sender, addr(jkeys[o]), amount, nonce, fee=fee)
            elif op == "bond":
                tx = jstaking.make_bond_tx(sender, amount, nonce, fee=fee)
            elif op == "unbond":
                tx = jstaking.make_unbond_tx(sender, amount, nonce, fee=fee)
            elif op == "edit":
                tx = jstaking.make_edit_power_tx(sender, amount, nonce, fee=fee)
            elif op == "rotate":
                tx = jstaking.make_rotate_key_tx(sender, "ed25519", jkeys[o].pub_key().bytes(),
                                                 nonce, fee=fee)
            elif op == "malformed":
                tx = jmempool.make_signed_tx(sender, b"stake:bond:x%d:%d" % (amount, nonce))
            else:
                tx = b"bank:send:%d" % amount
            if flip and op != "raw":
                tx = tx[:-1] + bytes([tx[-1] ^ 1])
            for P in (JAX, PORT):
                runs[P.name].check(apps[P.name], tx)
                runs[P.name].deliver(apps[P.name], tx)
        for P in (JAX, PORT):
            runs[P.name].note("end_block", apps[P.name].end_block(P.t.RequestEndBlock(height=h)))
            runs[P.name].note("commit", apps[P.name].commit())
    assert runs["port"].log == runs["jax"].log
    assert apps["port"].app_hash == apps["jax"].app_hash


# -- the proxy ------------------------------------------------------------------------


@pytest.mark.parametrize("name, cls", [("bank", "BankApplication"),
                                       ("staking", "StakingApplication")])
async def test_builtin_bank_and_staking_creators_keep_their_db(name, cls, tmp_path):
    """default_client_creator gives local clients sharing one app on the
    node's app db, as JAX proxy.py:61-67: a second creator on the same db
    resumes the committed state."""
    outs = []
    for P, db_mod in ((JAX, jkvstore), (PORT, pkvstore)):
        db = db_mod.open_db("app", str(tmp_path / P.name))
        creator = P.proxy.default_client_creator(name, app_db=db)
        c1, c2 = creator(), creator()
        assert c1.app is c2.app and type(c1.app).__name__ == cls and c1.app.db is db
        tx = P.bank.make_transfer_tx(key(P, 1), addr(key(P, 2)), 5, 0)
        c1.app.begin_block(P.t.RequestBeginBlock())
        c1.app.deliver_tx(P.t.RequestDeliverTx(tx=tx))
        c1.app.end_block(P.t.RequestEndBlock(height=1))
        c1.app.commit()
        again = P.proxy.default_client_creator(name, app_db=db)().app
        outs.append((again.height, again.app_hash, again.accounts))
        db.close()
    assert outs[0] == outs[1] and outs[0][0] == 1


# -- a staking chain through BlockExecutor ----------------------------------------------

SK_VALS, SK_EPOCH, SK_HEIGHTS = 4, 3, 8


async def staking_chain(ns):
    """One package's 4-validator chain on the staking app (genesis powers
    10/20/30/40, epoch 3): height 1 a bond (the set grows at 3), height 2 a
    leave and a key rotation (the set shrinks and swaps a key at 4), the
    epoch at 3 and 6 (powers only, at 5 and 8).  Returns per height the
    state, the app hash and the EndBlock updates through
    validator_updates_from_abci."""
    from test_torch_execution import CHAIN, SEC, T0, sign_commit

    keys = [ns.PrivKey.from_secret(b"stk-%d" % i) for i in range(SK_VALS + 2)]
    key_of = {k.pub_key().address(): k for k in keys}
    staking = jstaking if ns.name == "jax" else pstaking
    bank = jbank if ns.name == "jax" else pbank
    gen = ns.genesis.GenesisDoc(CHAIN, genesis_time_ns=T0, validators=[
        ns.genesis.GenesisValidator(k.pub_key().address(), k.pub_key(), 10 * (i + 1))
        for i, k in enumerate(keys[:SK_VALS])], app_state={"staking": {"epoch_length": SK_EPOCH}})
    gen.validate_and_complete()
    dbs = {name: ns.kvstore.open_db(name, None) for name in ("state", "blockstore", "app",
                                                             "evidence")}
    state_store, block_store = ns.state.StateStore(dbs["state"]), ns.BlockStore(dbs["blockstore"])
    state = ns.state.make_genesis_state(gen)
    state_store.save(state)
    conns = ns.proxy.AppConns(ns.proxy.default_client_creator("staking", app_db=dbs["app"]))
    await conns.start()
    app = conns.query().app
    txs = {1: [staking.make_bond_tx(keys[SK_VALS], 15, 0)],
           2: [staking.make_edit_power_tx(keys[0], 0, 0),
               staking.make_rotate_key_tx(keys[1], "ed25519",
                                          keys[SK_VALS + 1].pub_key().bytes(), 0),
               bank.make_transfer_tx(keys[2], keys[3].pub_key().address(), 3, 0)]}
    out = {}
    try:
        state = await ns.replay.Handshaker(state_store, state, block_store, gen).handshake(conns)
        mempool = ns.mempool.Mempool(conns.mempool(), {"sig_precheck": True})
        executor = ns.execution.BlockExecutor(state_store, conns.consensus(), mempool,
                                              ns.evpool.EvidencePool(dbs["evidence"], state_store,
                                                                     state))
        last_commit = None
        for h in range(1, SK_HEIGHTS + 1):
            for tx in txs.get(h, []):
                assert (await mempool.check_tx(tx)).code == 0
            block = executor.create_proposal_block(h, state, last_commit,
                                                   state.validators.get_proposer().address)
            assert list(block.txs) == txs.get(h, [])
            parts = block.make_part_set(256)
            bid = ns.BlockID(block.hash(), parts.header())
            commit = sign_commit(ns, state.validators, key_of, h, bid, block.time_ns + SEC)
            block_store.save_block(block, parts, commit)
            state, _ = await executor.apply_block(state, bid, block)
            updates = state_store.load_abci_responses(h)["end_block"]["validator_updates"]
            vals = ns.execution.validator_updates_from_abci(
                [ns.abci.ValidatorUpdate(**u) if isinstance(u, dict) else u for u in updates])
            out[h] = {"state": state.to_dict(), "app_hash": app.app_hash,
                      "updates": [(v.address, v.pub_key.bytes(), v.voting_power) for v in vals],
                      "sizes": (state.validators.size(), state.next_validators.size())}
            last_commit = commit
    finally:
        await conns.stop()
        for db in dbs.values():
            db.close()
    return out


def _staking_chains():
    from test_torch_execution import JAX as XJ, PORT as XP

    if not hasattr(_staking_chains, "out"):
        _staking_chains.out = {ns.name: asyncio.run(staking_chain(ns)) for ns in (XJ, XP)}
    return _staking_chains.out


@pytest.mark.parametrize("h", range(1, SK_HEIGHTS + 1))
def test_staking_chain_heights_equal_jax(h):
    chains = _staking_chains()
    assert chains["port"][h] == chains["jax"][h]


def test_staking_chain_grows_shrinks_rotates_and_shifts_powers():
    """After block h the state holds the set of h + 1: the bond of 1 serves
    from 3, the leave and rotation of 2 from 4, the epoch shift of 3 from 5."""
    c = _staking_chains()["port"]
    assert [c[h]["sizes"][0] for h in range(1, SK_HEIGHTS + 1)] == [4, 5, 4, 4, 4, 4, 4, 4]
    assert len(c[1]["updates"]) == 1 and len(c[2]["updates"]) == 3
    powers = {h: sorted(v["voting_power"] for v in c[h]["state"]["validators"]["validators"])
              for h in (3, 4)}
    assert powers[3] == powers[4]  # the epoch permutes powers, keeps the multiset
    by_addr = {h: {v["address"]: v["voting_power"]
                   for v in c[h]["state"]["validators"]["validators"]} for h in (2, 3, 4)}
    assert by_addr[2].keys() != by_addr[3].keys()  # a key left, one rotated
    assert by_addr[3].keys() == by_addr[4].keys() and by_addr[3] != by_addr[4]
    assert c[3]["updates"] and all(p > 0 for _, _, p in c[3]["updates"])


def test_port_apps_import_neither_jax_nor_the_jax_package():
    import os
    import subprocess
    import sys

    code = ("import sys; import tendermint_tpu_torch.apps, tendermint_tpu_torch.proxy, "
            "tendermint_tpu_torch.tools.loadgen, tendermint_tpu_torch.chaos.scenario; "
            "tendermint_tpu_torch.proxy.default_client_creator('staking')().app; "
            "bad = [m for m in sys.modules if m.split('.')[0] in ('msgpack', 'jax', "
            "'tendermint_tpu')]; print(bad); sys.exit(1 if bad else 0)")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    r = subprocess.run([sys.executable, "-c", code], cwd=root, capture_output=True, text=True,
                       timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr

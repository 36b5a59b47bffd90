"""chip_smoke.py phase 18 (a) (a validator of a staking chain whose set
changes by its own txs: bank transfers with overdrafts and flipped
signatures through the mempool's signed-tx lane, bonds, an edit, a leave
and a key rotation at height 2, the epoch's power shift at 3; a syncer
over the 6 blocks; a restart from the sqlite app db) end to end at 7
validators on the CPU, the kernels' plain versions behind the engine.
Every check is inside the phase (sets, balances, nonces, table misses,
app hashes); this test holds what it returns.
"""

import os

import torch

from tendermint_tpu_torch.crypto import batch as batch_hook

torch.set_num_threads(1)


def test_phase18a_staking_chain_on_cpu(monkeypatch):
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    monkeypatch.syspath_prepend(root)
    import chip_smoke as cs

    monkeypatch.setattr(cs, "STK_SENDERS", 20)
    monkeypatch.setattr(cs, "STK_CORRUPT", 2)
    monkeypatch.setattr(cs, "STK_BONDS", 3)
    monkeypatch.setattr(cs, "STK_OVERDRAFT_EVERY", 5)
    out = cs.phase_staking(cs.make_keys(7), "cpu", torch.device("cpu"))
    # the genesis set's first check and the check of the first set with new
    # pubkeys; the epoch's power-only set hits the cache
    assert out["misses"] == [2, cs.STK_STAKE_AT + 3]
    zero = dict.fromkeys(cs.KERNELS, 0)
    assert out["a"] == out["flushes"] == out["b"] == zero
    assert batch_hook.get_indexed_verifier() is None


def test_phase18a_expected_sets_follow_the_staking_app(monkeypatch):
    """The harness's own arithmetic (stk_sets) against the JAX staking
    app's barrel shift on the same records: the phase checks the port's
    sets against it."""
    import json

    import tendermint_tpu.abci.types as jabci
    from tendermint_tpu.apps import staking as jstaking
    from tendermint_tpu.crypto.keys import Ed25519PrivKey as JKey

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    monkeypatch.syspath_prepend(root)
    import chip_smoke as cs

    keys = cs.make_keys(9)
    bonds, rotated = cs.make_keys(3, prefix="bond"), cs.make_keys(1, prefix="rotated")[0]
    genesis, staked, shifted, n_shift = cs.stk_sets(keys, bonds, rotated)
    app = jstaking.StakingApplication()
    app.init_chain(jabci.RequestInitChain(
        validators=[jabci.ValidatorUpdate("ed25519", k.pub_key().bytes(), cs.stk_power(i))
                    for i, k in enumerate(keys)],
        app_state_bytes=json.dumps({"staking": {"epoch_length": 3}}).encode()))
    jk = {k.pub_key().bytes(): JKey(k.bytes()) for k in list(keys) + list(bonds)}
    txs = ([jstaking.make_bond_tx(jk[k.pub_key().bytes()], 10 + j, 0) for j, k in enumerate(bonds)]
           + [jstaking.make_edit_power_tx(jk[keys[cs.STK_EDIT].pub_key().bytes()], 25, 0),
              jstaking.make_edit_power_tx(jk[keys[cs.STK_LEAVE].pub_key().bytes()], 0, 0),
              jstaking.make_rotate_key_tx(jk[keys[cs.STK_ROTATE].pub_key().bytes()], "ed25519",
                                          rotated.pub_key().bytes(), 0)])

    def powers():
        return {r["pub_key"]: r["power"] for r in app.validators.values()}

    assert powers() == genesis
    for h, block in ((1, []), (2, txs), (3, [])):
        app.begin_block(jabci.RequestBeginBlock())
        for tx in block:
            assert app.deliver_tx(jabci.RequestDeliverTx(tx=tx)).code == 0
        updates = app.end_block(jabci.RequestEndBlock(height=h)).validator_updates
        app.commit()
        if h == 2:
            assert powers() == staked and len(updates) == len(txs) + 1
    assert powers() == shifted and len(updates) == n_shift


def test_a_commit_over_max_votes_count_is_refused_in_both_packages():
    """Why phase 18 (a)'s genesis holds 9,985 keys: its bonds and leave make
    the set 10,000 strong, MaxVotesCount; one validator more and the next
    block's LastCommit is invalid in both packages."""
    import pytest

    import tendermint_tpu.types.block as jblock
    from tendermint_tpu_torch.types import block as pblock
    from tendermint_tpu_torch.types.params import MAX_VOTES_COUNT

    assert MAX_VOTES_COUNT == 10_000
    for mod in (jblock, pblock):
        bid = mod.BlockID(b"\x01" * 32, mod.PartSetHeader(1, b"\x02" * 32))
        for n, ok in ((MAX_VOTES_COUNT, True), (MAX_VOTES_COUNT + 1, False)):
            commit = mod.Commit(3, 0, bid, [mod.CommitSig(2, bytes([i % 251]) * 20, i, b"\x00" * 64)
                                            for i in range(n)])
            if ok:
                commit.validate_basic()
            else:
                with pytest.raises(ValueError, match="too many signatures"):
                    commit.validate_basic()

"""The port's light client (tendermint_tpu_torch/lite2) and the types it
reads (Header, SignedHeader, Validator.bytes, ValidatorSet.hash, the dict
layout) against the JAX package's, on the same chain.

Both packages build one chain from the same secrets: 16 validators at
power 10, 40 heights, epochs of 10 heights, the 4 oldest validators
replaced by 4 new keys at each epoch boundary.  ed25519 signing is
deterministic, so the two chains are equal byte for byte.  Every scenario
of the JAX package's lite2 tests (tests/test_lite2.py) that the port
carries runs on both clients; the persisted heights, the bisection's steps
and each exception's type and message must be identical.  The JAX client
verifies on its default host hook; the port's verifies through an
installed TableCache on the CPU (its kernels' plain versions).
"""

import asyncio
import dataclasses
import types

import pytest
from hypothesis import given, settings
from hypothesis import strategies as st
import torch

import tendermint_tpu.lite2 as jlite2
import tendermint_tpu.types as jtypes
from tendermint_tpu.crypto import batch as jbatch
from tendermint_tpu.crypto.keys import Ed25519PrivKey as JPrivKey
from tendermint_tpu.lite2 import provider as jprovider
from tendermint_tpu_torch import lite2
from tendermint_tpu_torch.crypto import batch as batch_hook
from tendermint_tpu_torch.crypto import batch_verifier as bvm
from tendermint_tpu_torch.crypto.keys import Ed25519PrivKey
from tendermint_tpu_torch.lite2 import provider
from tendermint_tpu_torch.types import block as pblock
from tendermint_tpu_torch.types import validator as pvalidator

torch.set_num_threads(1)

CHAIN = "lite2-parity"
SEC = 1_000_000_000
T0 = 1_700_000_000_000_000_000
PERIOD = 3600 * SEC
N_VALS, HEIGHTS, EPOCH, ROTATE, POWER = 16, 40, 10, 4, 10
NOW = T0 + (HEIGHTS + 5) * SEC

PORT = types.SimpleNamespace(
    name="port", PrivKey=Ed25519PrivKey, Validator=pvalidator.Validator,
    ValidatorSet=pvalidator.ValidatorSet, Header=pblock.Header,
    SignedHeader=pblock.SignedHeader, Commit=pblock.Commit, CommitSig=pblock.CommitSig,
    BlockID=pblock.BlockID, PartSetHeader=pblock.PartSetHeader, lite2=lite2,
    ProviderError=provider.ProviderError,
)
JAX = types.SimpleNamespace(
    name="jax", PrivKey=JPrivKey, Validator=jtypes.Validator, ValidatorSet=jtypes.ValidatorSet,
    Header=jtypes.Header, SignedHeader=jtypes.SignedHeader, Commit=jtypes.Commit,
    CommitSig=jtypes.CommitSig, BlockID=jtypes.BlockID, PartSetHeader=jtypes.PartSetHeader,
    lite2=jlite2, ProviderError=jprovider.ProviderError,
)


def epoch_of(h: int) -> int:
    return (h - 1) // EPOCH


class Chain:
    """One package's copy of the chain: headers {h: SignedHeader}, sets
    {h: ValidatorSet}, and the signing key of every address."""

    def __init__(self, ns):
        self.ns = ns
        n_keys = N_VALS + ROTATE * epoch_of(HEIGHTS + 1)
        keys = [ns.PrivKey.from_secret(f"lite2-{i}".encode()) for i in range(n_keys)]
        self.key_of = {k.pub_key().address(): k for k in keys}
        sets = {}
        for e in range(epoch_of(HEIGHTS + 1) + 1):
            ks = keys[ROTATE * e: ROTATE * e + N_VALS]
            sets[e] = ns.ValidatorSet([ns.Validator.new(k.pub_key(), POWER) for k in ks])
        self.headers, self.vals = {}, {}
        last = ns.BlockID()
        for h in range(1, HEIGHTS + 1):
            vset = sets[epoch_of(h)]
            header = ns.Header(
                chain_id=CHAIN, height=h, time_ns=T0 + h * SEC, last_block_id=last,
                validators_hash=vset.hash(), next_validators_hash=sets[epoch_of(h + 1)].hash(),
                app_hash=bytes([h]) * 32, proposer_address=vset.validators[0].address,
            )
            bid = ns.BlockID(header.hash(), ns.PartSetHeader(1, header.hash()))
            self.headers[h] = ns.SignedHeader(header, self.sign(vset, h, bid))
            self.vals[h] = vset
            last = bid

    def sign(self, vset, h, bid):
        """A commit of every validator of vset for bid at height h."""
        sigs = [self.ns.CommitSig(2, v.address, T0 + h * SEC + i, b"")
                for i, v in enumerate(vset.validators)]
        unsigned = self.ns.Commit(h, 0, bid, sigs)
        sigs = [dataclasses.replace(cs, signature=self.key_of[cs.validator_address].sign(
            unsigned.vote_sign_bytes(CHAIN, i))) for i, cs in enumerate(sigs)]
        return self.ns.Commit(h, 0, bid, sigs)

    def provider(self, headers=None, vals=None):
        return self.ns.lite2.MockProvider(
            CHAIN, {**self.headers, **(headers or {})}, {**self.vals, **(vals or {})})

    def client(self, trust_height, primary=None, witnesses=(), **kw):
        opts = self.ns.lite2.TrustOptions(PERIOD, trust_height, self.headers[trust_height].hash())
        kw.setdefault("now_fn", lambda: NOW)
        return self.ns.lite2.Client(CHAIN, opts, primary or self.provider(), witnesses, **kw)


_chains = {}


def chain(ns) -> Chain:
    """Each package's chain, built once per test process."""
    if ns.name not in _chains:
        _chains[ns.name] = Chain(ns)
    return _chains[ns.name]


@pytest.fixture(autouse=True)
def engines():
    """The port verifies through a TableCache on the CPU; the JAX package
    on its default host hook.  Both packages' hooks are restored after."""
    saved = jbatch._verifier, jbatch._indexed_verifier
    jbatch.set_verifier(None)
    jbatch.set_indexed_verifier(None)
    cache = bvm.TableCache(bvm.BatchVerifier(device="cpu"), device="cpu").install()
    try:
        yield cache
    finally:
        batch_hook.set_indexed_verifier(None)
        batch_hook.set_verifier(None)
        jbatch.set_verifier(saved[0])
        jbatch.set_indexed_verifier(saved[1])


async def outcome(coro):
    """("ok", value) or (exception type name, message)."""
    try:
        return "ok", await coro
    except Exception as e:  # the outcome under comparison is the exception itself
        return type(e).__name__, str(e)


def sync_outcome(fn):
    try:
        return "ok", fn()
    except Exception as e:  # the outcome under comparison is the exception itself
        return type(e).__name__, str(e)


def height_of(res):
    status, value = res
    return (status, value.height) if status == "ok" and value is not None else res


async def parity(scenario):
    """Run one scenario on both packages; their results must be equal."""
    ours = await scenario(chain(PORT))
    theirs = await scenario(chain(JAX))
    assert ours == theirs
    return ours


# ---------------------------------------------------------------------------
# types: hashes and the dict layout
# ---------------------------------------------------------------------------


def test_hashes_and_encodings_match_jax():
    ours, theirs = chain(PORT), chain(JAX)
    for h in range(1, HEIGHTS + 1):
        a, b = ours.headers[h], theirs.headers[h]
        assert a.header.hash() == b.header.hash() == a.hash()
        assert a.commit.block_id.encode() == b.commit.block_id.encode()
        assert a.header.last_block_id.encode() == b.header.last_block_id.encode()
        assert ours.vals[h].hash() == theirs.vals[h].hash()
        assert [v.bytes() for v in ours.vals[h].validators] == [
            v.bytes() for v in theirs.vals[h].validators]
        assert a.to_dict() == b.to_dict()
        assert [cs.encode() for cs in a.commit.signatures] == [
            cs.encode() for cs in b.commit.signatures]
    # the empty BlockID of height 1 and a BlockID without parts
    assert pblock.BlockID().encode() == jtypes.BlockID().encode() == b""
    bare = b"\x07" * 32
    assert pblock.BlockID(bare).encode() == jtypes.BlockID(bare).encode()


def test_from_jax_dicts_hash_the_same():
    """A trusted store carries across: port objects rebuilt from the JAX
    objects' to_dict() hash and verify as the originals do."""
    ours, theirs = chain(PORT), chain(JAX)
    for h in (1, 10, 11, 40):
        sh = pblock.SignedHeader.from_dict(theirs.headers[h].to_dict())
        vals = pvalidator.ValidatorSet.from_dict(theirs.vals[h].to_dict())
        assert sh.hash() == theirs.headers[h].hash() == ours.headers[h].hash()
        assert vals.hash() == theirs.vals[h].hash()
        assert vals.to_dict() == theirs.vals[h].to_dict()
        assert sh.to_dict() == theirs.headers[h].to_dict()
        assert pblock.Header.from_dict(ours.headers[h].header.to_dict()) == ours.headers[h].header
        assert sh.commit.to_dict() == ours.headers[h].commit.to_dict()
        assert vals.has_address(vals.validators[3].address)
        assert not vals.has_address(b"\x00" * 20)
    sh = pblock.SignedHeader.from_dict(theirs.headers[40].to_dict())
    vals = pvalidator.ValidatorSet.from_dict(theirs.vals[40].to_dict())
    vals.verify_commit(CHAIN, sh.commit.block_id, 40, sh.commit)


def test_validate_basic_messages_match_jax():
    def cases(c):
        sh = c.headers[5]
        return [
            (sh, "other-chain"),
            (c.ns.SignedHeader(sh.header, c.headers[6].commit), CHAIN),
            (c.ns.SignedHeader(dataclasses.replace(sh.header, app_hash=b"\x09" * 32),
                               sh.commit), CHAIN),
        ]

    def run(c):
        out = []
        for sh, chain_id in cases(c):
            try:
                sh.validate_basic(chain_id)
                out.append("ok")
            except ValueError as e:
                out.append(str(e))
        return out

    assert run(chain(PORT)) == run(chain(JAX))
    assert len(set(run(chain(PORT)))) == 3


# ---------------------------------------------------------------------------
# the client: strategies
# ---------------------------------------------------------------------------


async def test_bisection_steps_and_heights_match_jax():
    """Bisection 1 -> 40 across three rotations with an honest witness:
    the same steps (trusted -> untrusted at each commit check), the same
    persisted heights."""

    async def scenario(c):
        steps = []
        client = None

        async def probe(sh, vals_sets):
            steps.append((client.store.latest_height(), sh.height, len(vals_sets)))
            return None  # verify through the installed hooks

        client = c.client(1, witnesses=[c.provider()], commit_preverify=probe)
        res = await outcome(client.verify_header_at_height(HEIGHTS, NOW))
        return height_of(res), steps, client.store.heights()

    res, steps, heights = await parity(scenario)
    assert res == ("ok", HEIGHTS)
    assert steps == [(0, 1, 1), (1, 40, 2), (1, 20, 2), (20, 40, 2)]
    assert heights == [40, 20, 1]


async def test_sequence_across_a_rotation_matches_jax():
    async def scenario(c):
        client = c.client(28, mode=c.ns.lite2.SEQUENCE)
        res = await outcome(client.verify_header_at_height(32, NOW))
        return height_of(res), client.store.heights()

    assert await parity(scenario) == (("ok", 32), [32, 31, 30, 29, 28])


async def test_backwards_matches_jax():
    async def scenario(c):
        client = c.client(30)
        res = await outcome(client.verify_header_at_height(25, NOW))
        again = await outcome(client.verify_header_at_height(27, NOW))
        return height_of(res), height_of(again), client.store.heights()

    assert await parity(scenario) == (("ok", 25), ("ok", 27), [30, 29, 28, 27, 26, 25])


async def test_update_and_cleanup_match_jax():
    async def scenario(c):
        client = c.client(30)
        first = height_of(await outcome(client.update(NOW)))
        second = height_of(await outcome(client.update(NOW)))
        heights = client.store.heights()
        latest = (await client.trusted_header()).height
        await client.cleanup()
        return first, second, heights, latest, client.store.heights()

    assert await parity(scenario) == (("ok", 40), ("ok", None), [40, 30], 40, [])


async def test_pruning_matches_jax():
    async def scenario(c):
        client = c.client(28, mode=c.ns.lite2.SEQUENCE, max_retained_headers=2)
        res = await outcome(client.verify_header_at_height(30, NOW))
        return height_of(res), client.store.heights()

    assert await parity(scenario) == (("ok", 30), [30, 29])


async def test_verify_header_matches_jax():
    async def scenario(c):
        client = c.client(30)
        out = [await outcome(client.verify_header(c.headers[31], c.vals[31], NOW)),
               await outcome(client.verify_header(c.headers[35], c.vals[35], NOW)),
               await outcome(client.verify_header(c.headers[31], c.vals[31], NOW)),
               await outcome(client.verify_header(c.headers[33], c.vals[33], NOW))]
        return out, client.store.heights()

    out, heights = await parity(scenario)
    assert out[:3] == [("ok", None)] * 3
    assert out[3][0] == "LightClientError"
    assert heights == [35, 31, 30]


# ---------------------------------------------------------------------------
# the client: failures
# ---------------------------------------------------------------------------


async def test_trusted_header_expired_matches_jax():
    async def scenario(c):
        client = c.client(30)
        await client.initialize()
        late = c.headers[30].time_ns + PERIOD + SEC
        return await outcome(client.verify_header_at_height(40, late)), client.store.heights()

    assert await parity(scenario) == (("InvalidHeaderError", "trusted header expired"), [30])


async def test_header_from_the_future_matches_jax():
    async def scenario(c):
        client = c.client(30, max_clock_drift_ns=SEC)
        now = c.headers[30].time_ns + 2 * SEC
        return await outcome(client.verify_header_at_height(40, now)), client.store.heights()

    (kind, msg), heights = await parity(scenario)
    assert kind == "InvalidHeaderError" and msg.startswith("new header has a time from the future")
    assert heights == [30]


async def test_wrong_validators_hash_matches_jax():
    async def scenario(c):
        client = c.client(30, primary=c.provider(vals={40: c.vals[20]}))
        return await outcome(client.verify_header_at_height(40, NOW)), client.store.heights()

    (kind, msg), heights = await parity(scenario)
    assert kind == "InvalidHeaderError" and msg.startswith("expected new header validators")
    assert heights == [30]


async def test_cant_trust_matches_jax():
    """Two rotations apart, 4 of 16 validators are shared: 40 of 160
    power is not more than a third."""

    async def scenario(c):
        return sync_outcome(lambda: c.ns.lite2.verify_non_adjacent(
            CHAIN, c.headers[1], c.vals[1], c.headers[40], c.vals[40], PERIOD, NOW, SEC))

    kind, msg = await parity(scenario)
    assert kind == "ErrNewValSetCantBeTrusted"
    assert msg == "invalid commit -- insufficient voting power: got 40, needed more than 53"


async def test_wrong_signature_matches_jax():
    async def scenario(c):
        sh = c.headers[40]
        bad = next(i for i, cs in enumerate(sh.commit.signatures)
                   if c.vals[30].has_address(cs.validator_address))
        sigs = list(sh.commit.signatures)
        flipped = bytearray(sigs[bad].signature)
        flipped[0] ^= 1
        sigs[bad] = dataclasses.replace(sigs[bad], signature=bytes(flipped))
        forged = c.ns.SignedHeader(sh.header, c.ns.Commit(40, 0, sh.commit.block_id, sigs))
        client = c.client(30, primary=c.provider(headers={40: forged}))
        res = await outcome(client.verify_header_at_height(40, NOW))
        return bad, res, client.store.heights()

    bad, (kind, msg), heights = await parity(scenario)
    assert kind == "ValueError" and msg.startswith(f"wrong signature (#{bad})")
    assert heights == [30]


# ---------------------------------------------------------------------------
# the client: witnesses
# ---------------------------------------------------------------------------


def lying_header(c, h):
    sh = c.headers[h]
    return c.ns.SignedHeader(dataclasses.replace(sh.header, app_hash=b"\xee" * 32), sh.commit)


async def test_witness_divergence_rolls_back_matches_jax():
    async def scenario(c):
        witness = c.provider(headers={40: lying_header(c, 40)})
        client = c.client(30, witnesses=[witness])
        await client.initialize()
        before = client.store.heights()
        res = await outcome(client.verify_header_at_height(40, NOW))
        return before, res, client.store.heights()

    before, res, after = await parity(scenario)
    assert res == ("DivergedHeaderError", "witness #0 diverged at height 40")
    assert before == after == [30]


class HungProvider:
    async def signed_header(self, height):
        await asyncio.sleep(30)

    async def validator_set(self, height):
        await asyncio.sleep(30)


class FailingProvider:
    def __init__(self, error_type):
        self.error_type = error_type

    async def signed_header(self, height):
        raise self.error_type(f"witness down at {height}")

    async def validator_set(self, height):
        raise self.error_type(f"witness down at {height}")


async def test_hung_witness_times_out_matches_jax():
    async def scenario(c):
        hung = HungProvider()
        client = c.client(30, witnesses=[hung, c.provider()], witness_timeout_s=0.05)
        res = height_of(await outcome(client.verify_header_at_height(40, NOW)))
        return res, client.store.heights(), client._witness_errors.get(id(hung)), len(client.witnesses)

    assert await parity(scenario) == (("ok", 40), [40, 30], 1, 2)


async def test_demotion_and_replace_primary_match_jax():
    async def scenario(c):
        demoted = []
        bad = FailingProvider(c.ns.ProviderError)
        honest = c.provider()
        client = c.client(30, witnesses=[bad, honest], witness_error_threshold=2,
                          on_witness_demoted=demoted.append)
        out = [height_of(await outcome(client.verify_header_at_height(h, NOW))) for h in (35, 40)]
        state = ([w is honest for w in client.witnesses], [w is bad for w in demoted],
                 [w is bad for w in client.demoted_witnesses])
        await client.replace_primary()
        promoted = client.primary is honest
        again = await outcome(client.replace_primary())
        return out, state, promoted, again, client.store.heights()

    out, state, promoted, again, heights = await parity(scenario)
    assert out == [("ok", 35), ("ok", 40)]
    assert state == ([True], [True], [True])
    assert promoted
    assert again == ("LightClientError", "no witnesses left to replace the primary with")
    assert heights == [40, 35, 30]


# ---------------------------------------------------------------------------
# the trusting check through the indexed hook
# ---------------------------------------------------------------------------


def test_trusting_check_gathers_trusted_rows_by_address(engines):
    """verify_commit_trusting hands the indexed hook the TRUSTED set's key
    and, for each shared signer, its row in the trusted set (matched by
    address), not its position in the commit; the table it builds is the
    trusted set's, and its verdicts agree with the JAX package's host path."""
    ours, theirs = chain(PORT), chain(JAX)
    calls = []

    def recording(set_key, pubkeys, idxs, msgs, sigs):
        calls.append((set_key, list(idxs), list(msgs)))
        return engines.verify_indexed(set_key, pubkeys, idxs, msgs, sigs)

    batch_hook.set_indexed_verifier(recording)
    trusted, sh = ours.vals[20], ours.headers[40]
    trusted.verify_commit_trusting(CHAIN, sh.commit.block_id, 40, sh.commit)
    theirs.vals[20].verify_commit_trusting(
        CHAIN, theirs.headers[40].commit.block_id, 40, theirs.headers[40].commit)
    [(set_key, idxs, msgs)] = calls
    assert set_key == trusted.pubkeys_digest()
    shared = [(i, cs) for i, cs in enumerate(sh.commit.signatures)
              if trusted.has_address(cs.validator_address)]
    assert len(shared) == N_VALS - 2 * ROTATE
    assert idxs == [trusted.get_by_address(cs.validator_address)[0] for _, cs in shared]
    assert idxs != [i for i, _ in shared]  # rows differ from commit positions
    assert msgs == [sh.commit.vote_sign_bytes(CHAIN, i) for i, _ in shared]
    table = engines.table_for(set_key, None)
    assert table.pubkeys == [v.pub_key.bytes() for v in trusted.validators]


def test_port_imports_neither_jax_nor_the_jax_package():
    """Every module of the port, the light client's included, imports in a
    fresh interpreter without pulling in jax or tendermint_tpu."""
    import os
    import subprocess
    import sys

    code = (
        "import importlib, pkgutil, sys, tendermint_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, 'tendermint_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(n for n in sys.modules if n.split('.')[0] in ('jax', 'tendermint_tpu'))\n"
        "print(len([n for n in sys.modules if n.startswith('tendermint_tpu_torch.')]), bad)\n"
    )
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "-c", code], cwd=root, capture_output=True,
                         text=True, timeout=300, env={**os.environ, "PYTHONPATH": root})
    assert out.returncode == 0, out.stderr
    count, bad = out.stdout.split(" ", 1)
    assert bad.strip() == "[]"
    assert int(count) > 40


# ---------------------------------------------------------------------------
# validator sets read back from a store, and proposer rotation
# ---------------------------------------------------------------------------

_RKEYS = {ns.name: [ns.PrivKey.from_secret(f"rotation-{i}".encode()).pub_key() for i in range(12)]
          for ns in (PORT, JAX)}


def _set(ns, powers):
    return ns.ValidatorSet([ns.Validator.new(_RKEYS[ns.name][i], p) for i, p in enumerate(powers)])


@pytest.mark.parametrize("variant", ["as stored", "reversed", "zero power"])
def test_from_dict_keeps_the_stored_set(variant):
    """A set read back through from_dict is the set that was written: its
    order and powers as given, nothing re-sorted or refused (JAX
    types/validator.py from_dict)."""
    d = _set(JAX, [10, 11, 12, 13, 14]).to_dict()
    if variant == "reversed":
        d["validators"] = d["validators"][::-1]
    elif variant == "zero power":
        d["validators"][2]["voting_power"] = 0
    ours = pvalidator.ValidatorSet.from_dict(d)
    theirs = jtypes.ValidatorSet.from_dict(d)
    assert ours.hash() == theirs.hash()
    assert ours.total_voting_power() == theirs.total_voting_power()
    assert ours.to_dict() == theirs.to_dict() == d
    assert [v.address for v in ours.validators] == [v["address"] for v in d["validators"]]


@pytest.mark.parametrize("powers", [[10], [10, 11, 12, 13, 14], [1, 1000, 7, 7, 300, 2, 2, 50]])
def test_fresh_sets_match_jax(powers):
    """A freshly built set has the JAX constructor's priorities and
    proposer (one increment_proposer_priority at construction)."""
    ours, theirs = _set(PORT, powers), _set(JAX, powers)
    assert ours.to_dict() == theirs.to_dict()
    assert ours.proposer is not None
    assert ours.get_proposer().address == theirs.get_proposer().address
    assert ours.copy_increment_proposer_priority(3).to_dict() == \
        theirs.copy_increment_proposer_priority(3).to_dict()


_round = st.tuples(
    st.integers(1, 3),
    st.lists(st.tuples(st.integers(0, 11), st.integers(0, 5000)), max_size=4),
)


@settings(max_examples=40, deadline=None)
@given(st.lists(st.integers(1, 5000), min_size=1, max_size=8), st.lists(_round, min_size=50,
                                                                         max_size=50))
def test_proposer_rotation_matches_jax(powers, rounds):
    """50 rounds of increment_proposer_priority with change sets between
    them (additions start at -1.125 x total power, so averages go
    negative; removals and re-bonding included): every round the same
    priorities, proposer and errors as the JAX package."""
    ours, theirs = _set(PORT, powers), _set(JAX, powers)
    for times, changes in rounds:
        if changes:
            res = [sync_outcome(lambda: s.update_with_change_set(
                [ns.Validator.new(_RKEYS[ns.name][i], p) for i, p in changes]))
                for ns, s in ((PORT, ours), (JAX, theirs))]
            assert res[0] == res[1]
        ours.increment_proposer_priority(times)
        theirs.increment_proposer_priority(times)
        assert ours.to_dict() == theirs.to_dict()
        assert ours.get_proposer().address == theirs.get_proposer().address
        assert ours.pubkeys_digest() == theirs.pubkeys_digest()

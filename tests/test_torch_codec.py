"""The port's storage codec (tendermint_tpu_torch/encoding/codec.py on its
own msgpack subset, encoding/msgpack.py) against the JAX package's codec
and the msgpack package: the same bytes for every registered type and for
plain values at every size boundary, each package reading the other's
bytes, and the same errors.
"""

import os
import subprocess
import sys

import msgpack
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

import tendermint_tpu.crypto.bls  # noqa: F401 - registers pk/bls12381, sk/bls12381
import tendermint_tpu.crypto.multisig  # noqa: F401 - registers pk/multisig
import tendermint_tpu.crypto.sr25519  # noqa: F401 - registers tm/PubKeySr25519
import tendermint_tpu_torch.crypto.bls  # noqa: F401
import tendermint_tpu_torch.crypto.multisig  # noqa: F401
import tendermint_tpu_torch.crypto.sr25519  # noqa: F401
from tendermint_tpu.encoding import codec as jcodec
from tendermint_tpu_torch.encoding import codec as pcodec
from tendermint_tpu_torch.encoding import msgpack as pmsgpack

from test_torch_chain_types import CHAIN, HEIGHTS, JAX, PORT, PART, chain, evidence_pair


def _instances(ns):
    """One instance of every type the port registers (the key types once
    their modules are imported, as above), built from the same inputs in
    either package."""
    c = chain(ns)
    blk = c["blocks"][3]
    ev = evidence_pair(ns)
    meta = ns.block_store.BlockMeta(c["ids"][3], len(blk.serialize()), blk.header, len(blk.txs))
    proposal = ns.codec.class_for("tm/Proposal")(height=3, round=1, pol_round=0,
                                                 block_id=c["ids"][3], timestamp_ns=blk.time_ns)
    proposal.signature = c["keys"][0].sign(proposal.sign_bytes(CHAIN))
    cls = ns.codec.class_for
    sr = cls("tm/PubKeySr25519")(bytes.fromhex(
        "d43593c715fdd31c61141abd04a99fd6822c8558854ccde39a5684e7a56da27d"))
    secp = cls("sk/secp256k1")(b"\x05" * 32)
    bls = cls("sk/bls12381")(b"\x06" * 32)
    return {
        "pk/bls12381": bls.pub_key(),
        "sk/bls12381": bls,
        "pk/ed25519": c["keys"][0].pub_key(),
        "tm/PubKeySr25519": sr,
        "pk/secp256k1": secp.pub_key(),
        "sk/secp256k1": secp,
        "pk/multisig": cls("pk/multisig")(2, [c["keys"][1].pub_key(), sr, secp.pub_key()]),
        "tm/Vote": ev.vote_a,
        "tm/Commit": c["commits"][2],
        "tm/AggCommit": cls("tm/AggCommit").from_dict({
            "height": 2, "round": 0, "block_id": c["ids"][2].to_dict(),
            "signers": b"\x00\x00\x00\x04\xe0", "agg_sig": b"\x07" * 96,
            "timestamp_ns": blk.time_ns}),
        "tm/SignedHeader": ns.SignedHeader(c["blocks"][2].header, c["commits"][2]),
        "tm/ValidatorSet": c["states"][HEIGHTS].validators,
        "tm/DuplicateVoteEvidence": ev,
        "tm/Block": blk,
        "tm/Part": c["parts"][3].parts[1],
        "tm/BlockMeta": meta,
        "tm/State": c["states"][HEIGHTS],
        "tm/Proposal": proposal,
    }


def test_port_registers_the_jax_tags():
    ours = set(pcodec.Codec.registry)
    assert ours == set(_instances(PORT))
    for tag in ours:
        assert jcodec.class_for(tag).__name__ == pcodec.class_for(tag).__name__
        assert pcodec.tag_for(pcodec.class_for(tag)) == tag


@pytest.mark.parametrize("tag", sorted(_instances(PORT)))
def test_dumps_equals_jax_and_loads_crosses(tag):
    ours, theirs = _instances(PORT)[tag], _instances(JAX)[tag]
    raw = pcodec.dumps(ours)
    assert raw == jcodec.dumps(theirs)
    back, jback = pcodec.loads(raw), jcodec.loads(raw)
    assert type(back) is pcodec.class_for(tag) and type(jback) is jcodec.class_for(tag)
    assert pcodec.dumps(back) == raw == jcodec.dumps(jback)
    assert back.to_dict() == ours.to_dict() and jback.to_dict() == theirs.to_dict()
    # nested inside plain containers, as the stores write them
    wrapped = {"k": [ours, None], 7: (ours,)}
    assert pcodec.dumps(wrapped) == jcodec.dumps({"k": [theirs, None], 7: (theirs,)})


_SIZES = [0, 1, 15, 16, 31, 32, 255, 256, 65535, 65536]
_INTS = [0, 1, 127, 128, 255, 256, 65535, 65536, 2**32 - 1, 2**32, 2**63 - 1, 2**64 - 1,
         -1, -32, -33, -128, -129, -32768, -32769, -2**31, -2**31 - 1, -2**63]


@pytest.mark.parametrize("n", _SIZES)
def test_size_boundaries_match_msgpack(n):
    values = [b"\x07" * n, "s" * n, "é" * (n // 2), [1] * n, tuple([None] * n),
              {i: i for i in range(n)}, {str(i).encode(): [] for i in range(n)}]
    for v in values:
        raw = msgpack.packb(v, use_bin_type=True)
        assert pcodec.dumps(v) == raw == jcodec.dumps(v)
        assert pcodec.loads(raw) == msgpack.unpackb(raw, raw=False, strict_map_key=False)


def test_int_boundaries_and_overflow_match_msgpack():
    for i in _INTS + [1.5, -0.0, float("inf"), True, False, None]:
        raw = msgpack.packb(i, use_bin_type=True)
        assert pmsgpack.packb(i) == raw
        assert pcodec.loads(raw) == i
    for big in (2**64, -2**63 - 1):
        with pytest.raises(OverflowError):
            msgpack.packb(big, use_bin_type=True)
        with pytest.raises(OverflowError):
            pcodec.dumps(big)


_plain = st.recursive(
    st.none() | st.booleans() | st.integers(-(2**63), 2**64 - 1)
    | st.floats(allow_nan=False) | st.binary(max_size=300) | st.text(max_size=300),
    lambda inner: st.lists(inner, max_size=20) | st.tuples(inner, inner)
    | st.dictionaries(st.text(max_size=8) | st.binary(max_size=8) | st.integers(-5, 300),
                      inner, max_size=20),
    max_leaves=60,
)


@settings(max_examples=300, deadline=None)
@given(_plain)
def test_plain_values_match_msgpack(v):
    raw = msgpack.packb(v, use_bin_type=True)
    assert pcodec.dumps(v) == raw == jcodec.dumps(v)
    assert pcodec.loads(raw) == msgpack.unpackb(raw, raw=False, strict_map_key=False)


def test_errors_match_jax():
    def err(fn):
        try:
            fn()
        except Exception as e:  # noqa: BLE001 - the parity is over any exception
            return type(e).__name__, str(e)
        return None

    unknown = msgpack.packb({"@t": "tm/Nope", "x": 1}, use_bin_type=True)
    assert err(lambda: pcodec.loads(unknown)) == err(lambda: jcodec.loads(unknown)) == (
        "ValueError", "unknown codec tag 'tm/Nope'")

    class Other:
        pass

    assert err(lambda: pcodec.register("tm/Vote")(Other)) == err(
        lambda: jcodec.register("tm/Vote")(Other)) == ("ValueError", "duplicate codec tag 'tm/Vote'")
    ours, theirs = err(lambda: pcodec.dumps(Other())), err(lambda: jcodec.dumps(Other()))
    assert ours == theirs and ours[0] == "TypeError"
    # truncated and trailing bytes: both refuse with a ValueError
    raw = pcodec.dumps(_instances(PORT)["tm/Commit"])
    for bad in (raw[:-1], raw + b"\x00", b"\xc1"):
        with pytest.raises(ValueError):
            pcodec.loads(bad)
        with pytest.raises(ValueError):
            jcodec.loads(bad)


def test_block_part_set_roundtrip_through_the_codec():
    """A block split into parts, each part through the codec, reassembles
    to the same block in either package."""
    blk = chain(PORT)["blocks"][HEIGHTS]
    parts = blk.make_part_set(PART)
    data = b"".join(jcodec.loads(pcodec.dumps(p)).bytes for p in parts.parts)
    assert JAX.Block.deserialize(data).hash() == blk.hash()


def test_port_imports_no_msgpack():
    """The card's machine has no msgpack: no module of the port imports it."""
    code = (
        "import importlib, pkgutil, sys, tendermint_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, 'tendermint_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "print(sorted(n for n in sys.modules if n.split('.')[0] in ('msgpack', 'jax', 'tendermint_tpu')))\n"
    )
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "-c", code], cwd=root, capture_output=True,
                         text=True, timeout=300, env={**os.environ, "PYTHONPATH": root})
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"

"""The port's other key types (tendermint_tpu_torch/crypto: strobe.py,
ristretto.py, sr25519.py, the secp256k1 half of keys.py and backend.py,
multisig.py, xchacha20poly1305.py, armor.py) and their verify paths
(types/validator.py mixed_batch_verify, verify_commit*) against the JAX
package's, on inputs made from seeded numpy.  Tolerance: exact — bytes and
verdicts equal, raised errors equal by type and message.

secp256k1 runs the JAX package's pure-Python branch in the port; the JAX
side is held to it with its `cryptography` tier switched off where bytes
are compared (RFC 6979 nonces), and with it on where each package verifies
the other's signatures.  A pure-Python secp256k1 verify takes ~0.2 s, so
each test keeps to a few of them.
"""

import base64
import hashlib
import json
import os
import time

import numpy as np
import pytest

import tendermint_tpu.cli as jcli
import tendermint_tpu.crypto.backend as jbackend
import tendermint_tpu.crypto.keys as jkeys
import tendermint_tpu.crypto.bls.keys as jbls
import tendermint_tpu.crypto.sr25519 as jsr
import tendermint_tpu.types as jtypes
from tendermint_tpu.crypto import armor as jarmor
from tendermint_tpu.crypto import batch_verifier as jbvm
from tendermint_tpu.crypto import ed25519_math as jem
from tendermint_tpu.crypto import multisig as jmultisig
from tendermint_tpu.crypto import ristretto as jristretto
from tendermint_tpu.crypto import strobe as jstrobe
from tendermint_tpu.crypto import xchacha20poly1305 as jxchacha
from tendermint_tpu.libs.bitarray import BitArray as JBitArray
from tendermint_tpu.privval import file as jfile
from tendermint_tpu_torch import cli as pcli
from tendermint_tpu_torch.crypto import armor as parmor
from tendermint_tpu_torch.crypto.bls import keys as pbls
from tendermint_tpu_torch.crypto import backend as pbackend
from tendermint_tpu_torch.crypto import batch as batch_hook
from tendermint_tpu_torch.crypto import batch_verifier as bvm
from tendermint_tpu_torch.crypto import ed25519_math as pem
from tendermint_tpu_torch.crypto import keys as pkeys
from tendermint_tpu_torch.crypto import multisig as pmultisig
from tendermint_tpu_torch.crypto import ristretto as pristretto
from tendermint_tpu_torch.crypto import sr25519 as psr
from tendermint_tpu_torch.crypto import strobe as pstrobe
from tendermint_tpu_torch.crypto import xchacha20poly1305 as pxchacha
from tendermint_tpu_torch.encoding import codec as pcodec
from tendermint_tpu_torch.libs.bitarray import BitArray as PBitArray
from tendermint_tpu_torch.libs.tracing import FlightRecorder
from tendermint_tpu_torch.privval import file as pfile
from tendermint_tpu_torch.types import block as pblock
from tendermint_tpu_torch.types import genesis as pgenesis
from tendermint_tpu_torch.types import validator as pvalidator
from tendermint_tpu_torch.types import vote as pvote

from test_sr25519 import RFC9496_BAD, RFC9496_MULTIPLES
from test_torch_chain_types import outcome

CHAIN = "keytypes-parity"
T0 = 1_700_000_000_000_000_000
RNG_SEED = 1818


def rng():
    return np.random.default_rng(RNG_SEED)


# ---------------------------------------------------------------------------
# Merlin / STROBE-128
# ---------------------------------------------------------------------------


def test_merlin_known_answer_and_transcripts_equal_jax():
    t = pstrobe.Transcript(b"test protocol")
    t.append_message(b"some label", b"some data")
    assert t.challenge_bytes(b"challenge", 32).hex() == (
        "d5a21972d0d5fe320c0d263fac7fffb8145aa640af6e9bca177c03c7efcf0615")
    r = rng()
    for _ in range(12):
        ops = [(r.bytes(int(r.integers(0, 12))), r.bytes(int(r.integers(0, 400))))
               for _ in range(int(r.integers(1, 5)))]
        n = int(r.integers(1, 200))  # past the 166-byte rate too
        out = []
        for mod in (pstrobe, jstrobe):
            tr = mod.Transcript(b"proto")
            for label, msg in ops:
                tr.append_message(label, msg)
            tr.append_u64(b"u64", 2**63 + 5)
            fork = tr.clone()
            fork.append_message(b"fork", b"x")
            out.append((tr.challenge_bytes(b"c", n), fork.challenge_bytes(b"c", n),
                        tr.strobe.state))
        assert out[0] == out[1]
    with pytest.raises(ValueError):
        pstrobe.Strobe128(b"x")._begin_op(pstrobe.FLAG_T, False)


# ---------------------------------------------------------------------------
# ristretto255
# ---------------------------------------------------------------------------


def test_ristretto_encodings_equal_jax():
    for i, want in enumerate(RFC9496_MULTIPLES):
        p = pem.scalar_mult(i, pristretto.BASEPOINT) if i else pem.IDENTITY
        assert pristretto.encode(p).hex() == want
        assert pristretto.equals(pristretto.decode(bytes.fromhex(want)), p)
    r = rng()
    for _ in range(8):
        k = int.from_bytes(r.bytes(32), "little") % pem.L
        enc = pristretto.encode(pem.scalar_mult(k, pristretto.BASEPOINT))
        assert enc == jristretto.encode(jem.scalar_mult(k, jristretto.BASEPOINT))
        assert pristretto.encode(pristretto.decode(enc)) == enc
    for bad in RFC9496_BAD:
        assert pristretto.decode(bytes.fromhex(bad)) is None
        assert jristretto.decode(bytes.fromhex(bad)) is None
    # random strings: about 1 in 8 decodes; both packages agree on which
    blobs = [r.bytes(32) for _ in range(64)] + [b"\x00" * 31, b"\xff" * 33]
    assert [pristretto.decode(b) for b in blobs] == [jristretto.decode(b) for b in blobs]


# ---------------------------------------------------------------------------
# sr25519
# ---------------------------------------------------------------------------


def test_sr25519_keys_and_signatures_equal_jax():
    alice = bytes.fromhex("e5be9a5092b81bca64be81d212e7f2f9eba183bb7a90954f7b76361f6edb5c0a")
    assert psr.Sr25519PrivKey(alice).pub_key().bytes().hex() == (
        "d43593c715fdd31c61141abd04a99fd6822c8558854ccde39a5684e7a56da27d")
    assert psr.SIGNING_CTX == jsr.SIGNING_CTX == b""
    r = rng()
    for secret in (b"a", b"validator-7", r.bytes(40)):
        ours, theirs = psr.Sr25519PrivKey.from_secret(secret), jsr.Sr25519PrivKey.from_secret(secret)
        assert ours.to_dict() == theirs.to_dict()
        assert ours.pub_key().to_dict() == theirs.pub_key().to_dict()
        assert ours.pub_key().address() == theirs.pub_key().address()
        assert repr(ours.pub_key()) == repr(theirs.pub_key())
        for msg, ctx in ((b"", b""), (r.bytes(300), b""), (b"m", b"other-context")):
            sig = ours.sign(msg, ctx=ctx)
            assert sig == theirs.sign(msg, ctx=ctx)
            assert ours.pub_key().verify(msg, sig, ctx=ctx)
    k = psr.Sr25519PrivKey.from_secret(b"codec")
    assert pcodec.loads(pcodec.dumps(k.pub_key())) == k.pub_key()
    assert pkeys.pubkey_from_dict(k.pub_key().to_dict()) == k.pub_key()
    assert psr.batch_verify([k.pub_key().bytes(), b"\x01" * 33], [b"m", b"m"],
                            [k.sign(b"m"), k.sign(b"m")]) == [True, False]


def _sr_corpus():
    """(pubkey bytes, msg, sig, ctx) cases: valid, and each way a signature
    can fail."""
    r = rng()
    k = psr.Sr25519PrivKey.from_secret(b"corpus")
    pub = k.pub_key().bytes()
    msg = r.bytes(120)
    sig = k.sign(msg)
    s = int.from_bytes(sig[32:63] + bytes([sig[63] & 0x7F]), "little")
    non_canonical = (s + pem.L).to_bytes(32, "little")
    cases = {
        "valid": (pub, msg, sig, b""),
        "marker cleared": (pub, msg, sig[:63] + bytes([sig[63] & 0x7F]), b""),
        "non-canonical s": (pub, msg, sig[:32] + non_canonical[:31]
                            + bytes([non_canonical[31] | 0x80]), b""),
        "undecodable R": (pub, msg, bytes.fromhex(RFC9496_BAD[4]) + sig[32:], b""),
        "another context": (pub, msg, sig, b"substrate"),
        "other message": (pub, msg + b"!", sig, b""),
        "flipped s": (pub, msg, sig[:40] + bytes([sig[40] ^ 1]) + sig[41:], b""),
        "undecodable key": (bytes.fromhex(RFC9496_BAD[2]), msg, sig, b""),
        "short signature": (pub, msg, sig[:63], b""),
    }
    return cases


@pytest.mark.parametrize("case", list(_sr_corpus()))
def test_sr25519_verdicts_equal_jax(case):
    pub, msg, sig, ctx = _sr_corpus()[case]
    ours = psr.Sr25519PubKey(pub).verify(msg, sig, ctx=ctx)
    assert ours == jsr.Sr25519PubKey(pub).verify(msg, sig, ctx=ctx)
    assert ours == (case == "valid")


# ---------------------------------------------------------------------------
# secp256k1
# ---------------------------------------------------------------------------


def test_secp256k1_keys_and_rfc6979_signatures_equal_jax(monkeypatch):
    monkeypatch.setattr(jbackend, "HAVE_CRYPTOGRAPHY", False)
    r = rng()
    for raw in (b"\x01" * 32, r.bytes(32)):
        ours, theirs = pkeys.Secp256k1PrivKey(raw), jkeys.Secp256k1PrivKey(raw)
        assert ours.pub_key().to_dict() == theirs.pub_key().to_dict()
        assert ours.pub_key().address() == theirs.pub_key().address()
        assert ours.to_dict() == theirs.to_dict()
        msg = r.bytes(90)
        sig = ours.sign(msg)
        assert sig == theirs.sign(msg)
        assert int.from_bytes(sig[32:], "big") <= pbackend.SECP_N // 2
        assert ours.pub_key().verify(msg, sig)
    assert pcodec.loads(pcodec.dumps(ours.pub_key())) == ours.pub_key()


def test_secp256k1_signatures_cross_verify():
    """The JAX package's `cryptography`-made signatures verify in the port,
    and the port's in the JAX package."""
    assert jbackend.HAVE_CRYPTOGRAPHY
    raw = rng().bytes(32)
    ours, theirs = pkeys.Secp256k1PrivKey(raw), jkeys.Secp256k1PrivKey(raw)
    msg = b"cross-verify"
    jsig, psig = theirs.sign(msg), ours.sign(msg)
    assert ours.pub_key().verify(msg, jsig)
    assert theirs.pub_key().verify(msg, psig)
    assert not ours.pub_key().verify(msg + b"!", jsig)


def test_secp256k1_refusals_equal_jax():
    key = pkeys.Secp256k1PrivKey(rng().bytes(32))
    pub = key.pub_key().bytes()
    msg = b"refusals"
    sig = key.sign(msg)
    r_int, s_int = int.from_bytes(sig[:32], "big"), int.from_bytes(sig[32:], "big")
    n = pbackend.SECP_N
    # an x with no point on the curve (x^3 + 7 not a square)
    off_x = next(x for x in range(1, 100) if pow((x ** 3 + 7) % pbackend.SECP_P,
                                                 (pbackend.SECP_P - 1) // 2, pbackend.SECP_P) != 1)
    cases = [
        (pub, sig[:32] + (n - s_int).to_bytes(32, "big")),  # high-S
        (pub, bytes(32) + sig[32:]),  # r = 0
        (pub, n.to_bytes(32, "big") + sig[32:]),  # r = n
        (pub, sig[:32] + bytes(32)),  # s = 0
        (b"\x02" + off_x.to_bytes(32, "big"), sig),  # off-curve key
        (b"\x04" + pub[1:], sig),  # not a compressed key
        (pub, sig[:63]),  # short
    ]
    assert r_int > 0
    for pk, s in cases:
        assert pkeys.Secp256k1PubKey(pk).verify(msg, s) is False
        assert jkeys.Secp256k1PubKey(pk).verify(msg, s) is False
    assert outcome(lambda: pkeys.Secp256k1PubKey(pub[:32])) == outcome(
        lambda: jkeys.Secp256k1PubKey(pub[:32]))


# ---------------------------------------------------------------------------
# threshold multisig
# ---------------------------------------------------------------------------


def _ms_pair(k, subs):
    """The same K-of-N key in each package."""
    return (pmultisig.MultisigThresholdPubKey(k, [s.pub_key() for s in subs]),
            jmultisig.MultisigThresholdPubKey(k, [jkeys.pubkey_from_dict(s.pub_key().to_dict())
                                                  for s in subs]))


def _multisig_sig(mod, bits_cls, n, signed, sigs):
    bits = bits_cls(n)
    for i in signed:
        bits.set_index(i, True)
    return mod.build_multisig_signature(bits, sigs)


def test_multisig_bytes_address_and_verdicts_equal_jax():
    subs = [psr.Sr25519PrivKey.from_secret(b"ms-%d" % i) for i in range(3)]
    ours, theirs = _ms_pair(2, subs)
    assert ours.bytes() == theirs.bytes()
    assert ours.address() == theirs.address()
    assert ours.to_dict() == theirs.to_dict()
    back = pkeys.pubkey_from_dict(theirs.to_dict())
    assert back == ours and back.bytes() == theirs.bytes()
    msg = b"threshold payload"
    s = [k.sign(msg) for k in subs]
    cases = {
        "threshold": ([0, 2], [s[0], s[2]], True),
        "all": ([0, 1, 2], s, True),
        "below threshold": ([1], [s[1]], False),
        "wrong position": ([0, 1], [s[0], s[2]], False),
        "count mismatch": ([0, 1], [s[0]], False),
    }
    for name, (signed, sigs, want) in cases.items():
        sig = _multisig_sig(pmultisig, PBitArray, 3, signed, sigs)
        assert sig == _multisig_sig(jmultisig, JBitArray, 3, signed, sigs), name
        assert ours.verify(msg, sig) == theirs.verify(msg, sig) == want, name
    # nested: a 1-of-2 of (ed25519, the 2-of-3 above)
    ed = pkeys.Ed25519PrivKey.from_secret(b"ms-ed")
    nested = pmultisig.MultisigThresholdPubKey(1, [ed.pub_key(), ours])
    jnested = jkeys.pubkey_from_dict(nested.to_dict())
    assert nested.bytes() == jnested.bytes() and nested.address() == jnested.address()
    inner = _multisig_sig(pmultisig, PBitArray, 3, [0, 1], s[:2])
    outer = _multisig_sig(pmultisig, PBitArray, 2, [1], [inner])
    assert nested.verify(msg, outer) is jnested.verify(msg, outer) is True
    assert outcome(lambda: pmultisig.MultisigThresholdPubKey(4, ours.pubkeys)) == outcome(
        lambda: jmultisig.MultisigThresholdPubKey(4, theirs.pubkeys))
    assert outcome(lambda: pmultisig.MultisigThresholdPubKey(0, ours.pubkeys)) == outcome(
        lambda: jmultisig.MultisigThresholdPubKey(0, theirs.pubkeys))


def _fuzzed(valid: bytes, r):
    """Malformed variants of a valid multisig signature: byte flips,
    truncations, insertions, and hand-made payloads that parse."""
    import msgpack

    out = []
    for _ in range(240):
        b = bytearray(valid)
        kind = int(r.integers(0, 4))
        if kind == 0:
            for _ in range(int(r.integers(1, 4))):
                b[int(r.integers(0, len(b)))] = int(r.integers(0, 256))
        elif kind == 1:
            b = b[:int(r.integers(0, len(b)))]
        elif kind == 2:
            pos = int(r.integers(0, len(b) + 1))
            b[pos:pos] = r.bytes(int(r.integers(1, 6)))
        else:
            b += r.bytes(int(r.integers(1, 4)))
        out.append(bytes(b))
    d = msgpack.unpackb(valid, raw=False)
    for payload in (
        {**d, 1: 2},  # an int map key (msgpack's strict_map_key refuses it)
        {**d, "x": {2: b""}},  # a nested one
        {**d, "sigs": [s.hex() for s in d["sigs"]]},  # str signatures
        {**d, "sigs": tuple(d["sigs"])[:1]},
        {**d, "bits": b"\x00\x00\x00\x03"},
        {**d, "bits": b""},
        {**d, "bits": "str"},
        {"bits": d["bits"]},
        [d["bits"], d["sigs"]],
        {**d, "extra": [1, 2.5, None, True]},
        {**d, "sigs": d["sigs"] + [b"\x00" * 64]},
    ):
        out.append(msgpack.packb(payload, use_bin_type=True))
    out.append(msgpack.packb(msgpack.ExtType(1, valid)))
    out.append(valid + b"\x00")
    return out


def test_multisig_verify_is_total_and_equal_jax_over_fuzz():
    subs = [pkeys.Ed25519PrivKey.from_secret(b"fz-%d" % i) for i in range(4)]
    ours, theirs = _ms_pair(2, subs)
    msg = b"fuzz"
    valid = _multisig_sig(pmultisig, PBitArray, 4, [1, 3], [subs[1].sign(msg), subs[3].sign(msg)])
    assert ours.verify(msg, valid) and theirs.verify(msg, valid)
    cases = _fuzzed(valid, rng())
    verdicts = [ours.verify(msg, c) for c in cases]
    assert verdicts == [theirs.verify(msg, c) for c in cases]
    assert verdicts.count(True) < len(cases) // 4


# ---------------------------------------------------------------------------
# XChaCha20-Poly1305 and armor
# ---------------------------------------------------------------------------


def test_xchacha20poly1305_draft_vectors_and_parity():
    key = bytes(range(32))
    nonce16 = bytes.fromhex("000000090000004a0000000031415927")
    assert pxchacha.hchacha20(key, nonce16).hex() == (
        "82413b4227b27bfed30e42508a877d73a0f9e4d58a74a853c12ec41326d3ecdc")
    pt = (b"Ladies and Gentlemen of the class of '99: If I could offer you "
          b"only one tip for the future, sunscreen would be it.")
    aad = bytes.fromhex("50515253c0c1c2c3c4c5c6c7")
    key = bytes.fromhex("808182838485868788898a8b8c8d8e8f909192939495969798999a9b9c9d9e9f")
    nonce = bytes.fromhex("404142434445464748494a4b4c4d4e4f5051525354555657")
    aead = pxchacha.XChaCha20Poly1305(key)
    ct = aead.seal(nonce, pt, aad)
    assert ct[:16].hex() == "bd6d179d3e83d43b9576579493c0e939"
    assert ct[-16:].hex() == "c0875924c1c7987947deafd8780acf49"
    assert aead.open(nonce, ct, aad) == pt
    with pytest.raises(pbackend.AEADError):
        aead.open(nonce, ct[:-1] + bytes([ct[-1] ^ 1]), aad)
    r = rng()
    for n in (0, 1, 64, 65, 300):
        k, no, data, ad = r.bytes(32), r.bytes(24), r.bytes(n), r.bytes(int(r.integers(0, 20)))
        sealed = pxchacha.XChaCha20Poly1305(k).seal(no, data, ad)
        assert sealed == jxchacha.XChaCha20Poly1305(k).seal(no, data, ad)
        assert jxchacha.XChaCha20Poly1305(k).open(no, sealed, ad) == data
    for make in (lambda: pxchacha.XChaCha20Poly1305(b"\x00" * 31),
                 lambda: pxchacha.XChaCha20Poly1305(key).seal(b"\x00" * 23, b""),
                 lambda: pxchacha.hchacha20(key, b"\x00" * 15)):
        with pytest.raises(ValueError):
            make()


def test_armor_cases_and_parity():
    r = rng()
    data = r.bytes(200)
    s = parmor.encode_armor("TENDERMINT PRIVATE KEY", {"kdf": "bcrypt", "salt": "abcd"}, data)
    assert s == jarmor.encode_armor("TENDERMINT PRIVATE KEY", {"kdf": "bcrypt", "salt": "abcd"},
                                    data)
    assert parmor.decode_armor(s) == ("TENDERMINT PRIVATE KEY", {"kdf": "bcrypt", "salt": "abcd"},
                                      data)
    plain = parmor.encode_armor("TEST BLOCK", {}, b"payload-bytes")
    lines = plain.splitlines()
    body = next(i for i, ln in enumerate(lines)
                if ln and not ln.startswith("-") and ":" not in ln and not ln.startswith("="))
    flipped = list(lines[body])
    flipped[0] = "B" if flipped[0] != "B" else "C"
    corrupt = "\n".join(lines[:body] + ["".join(flipped)] + lines[body + 1:])
    cases = [plain, corrupt, plain.replace("-----END TEST BLOCK-----", "-----END OTHER-----"),
             "no armor", "", plain.replace("=", "!", 1), "\r\n".join(lines) + "\r\n",
             "-----BEGIN X-----\nnotbase64!!\n-----END X-----"]
    for c in cases:
        assert outcome(lambda: parmor.decode_armor(c)) == outcome(lambda: jarmor.decode_armor(c))
    assert outcome(lambda: parmor.decode_armor(corrupt))[0] == "ValueError"


# ---------------------------------------------------------------------------
# mixed validator sets: hash, table rows and commit verification
# ---------------------------------------------------------------------------


def _mixed_keys():
    """Port keys of every type: 6 ed25519, 4 sr25519, 2 secp256k1, and the
    sub-keys of a 1-of-2 and a 2-of-3 multisig (sr25519)."""
    ed = [pkeys.Ed25519PrivKey.from_secret(b"mx-ed-%d" % i) for i in range(6)]
    sr = [psr.Sr25519PrivKey.from_secret(b"mx-sr-%d" % i) for i in range(4)]
    secp = [pkeys.Secp256k1PrivKey(hashlib.sha256(b"mx-secp-%d" % i).digest()) for i in range(2)]
    ms1 = [psr.Sr25519PrivKey.from_secret(b"mx-m1-%d" % i) for i in range(2)]
    ms2 = [psr.Sr25519PrivKey.from_secret(b"mx-m2-%d" % i) for i in range(3)]
    return ed, sr, secp, ms1, ms2


class _Ms1Signer:
    """A 1-of-2 multisig validator's signer: sub-key 0 signs (85 bytes,
    under the 96-byte cap)."""

    def __init__(self, subs):
        self.subs = subs
        self.pub = pmultisig.MultisigThresholdPubKey(1, [k.pub_key() for k in subs])

    def pub_key(self):
        return self.pub

    def sign(self, msg):
        return _multisig_sig(pmultisig, PBitArray, 2, [0], [self.subs[0].sign(msg)])


def _mixed_sets():
    ed, sr, secp, ms1, ms2 = _mixed_keys()
    signers = ed + sr + secp + [_Ms1Signer(ms1)]
    pubs = [k.pub_key() for k in signers]
    pubs.append(pmultisig.MultisigThresholdPubKey(2, [k.pub_key() for k in ms2]))
    powers = [10 + i for i in range(len(pubs))]
    pset = pvalidator.ValidatorSet([pvalidator.Validator.new(pk, p) for pk, p in zip(pubs, powers)])
    jset = jtypes.ValidatorSet([jtypes.Validator.new(jkeys.pubkey_from_dict(pk.to_dict()), p)
                                for pk, p in zip(pubs, powers)])
    return pset, jset, {k.pub_key().address(): k for k in signers}


def _bid(ns):
    return ns.BlockID(b"\x11" * 32, ns.PartSetHeader(2, b"\x22" * 32))


def _mixed_commit(pset, signer_of, tamper=None, height=5):
    """Each package's commit over the same signature bytes: every member
    with a signer signs; `tamper(pub_key, sig)` may change a signature."""
    sigs = []
    for i, v in enumerate(pset.validators):
        key = signer_of.get(v.address)
        if key is None:
            sigs.append(None)
            continue
        ts = T0 + i
        vote = pvote.Vote(2, height, 0, _bid(pblock), ts, v.address, i)
        sig = key.sign(vote.sign_bytes(CHAIN))
        if tamper is not None:
            sig = tamper(v.pub_key, sig)
        sigs.append((v.address, ts, sig))

    def build(ns):
        return ns.Commit(height, 0, _bid(ns), [
            ns.CommitSig.absent() if s is None else ns.CommitSig(2, s[0], s[1], s[2])
            for s in sigs])

    return build(pblock), build(jtypes)


def test_mixed_set_hash_digest_and_table_rows_equal_jax():
    pset, jset, _ = _mixed_sets()
    assert [v.address for v in pset.validators] == [v.address for v in jset.validators]
    assert pset.pubkeys_digest() == jset.pubkeys_digest()
    np.testing.assert_array_equal(pset.pubkey_table(), jset.pubkey_table())
    # a multisig member's Validator.bytes has no "value": the set cannot hash
    assert outcome(pset.hash) == outcome(jset.hash) == ("KeyError", "'value'")
    assert outcome(lambda: pset.to_dict()) == outcome(lambda: jset.to_dict())
    plain = [v for v in pset.validators
             if not isinstance(v.pub_key, pmultisig.MultisigThresholdPubKey)]
    hset = pvalidator.ValidatorSet([pvalidator.Validator.new(v.pub_key, v.voting_power)
                                    for v in plain])
    hjset = jtypes.ValidatorSet([jtypes.Validator.new(jkeys.pubkey_from_dict(
        v.pub_key.to_dict()), v.voting_power) for v in plain])
    assert hset.hash() == hjset.hash()
    assert pvalidator.ValidatorSet.from_dict(hjset.to_dict()).hash() == hjset.hash()
    # the device table's rows: a foreign 32-byte key (sr25519) decodes as
    # whatever Edwards point it encodes; other lengths are the identity
    rows = [v.pub_key.bytes() for v in pset.validators]
    ours = bvm.PubkeyTable(rows, device="cpu", tabulated=False)
    theirs = jbvm.PubkeyTable(rows)
    np.testing.assert_array_equal(ours.neg_a_rows.numpy(), np.asarray(theirs.neg_a_rows))
    np.testing.assert_array_equal(ours.row_valid, theirs.row_valid)
    short = [i for i, r in enumerate(rows) if len(r) != 32]
    assert short and not ours.row_valid[short].any()
    assert (ours.neg_a_rows.numpy()[short] == bvm.IDENTITY_ROW).all()


def _tampers():
    def flip(kind):
        def tamper(pk, sig):
            return bytes([sig[0] ^ 1]) + sig[1:] if type(pk).__name__ == kind else sig
        return tamper

    def high_s(pk, sig):
        if not isinstance(pk, pkeys.Secp256k1PubKey):
            return sig
        return sig[:32] + (pbackend.SECP_N - int.from_bytes(sig[32:], "big")).to_bytes(32, "big")

    def ms_flip(pk, sig):
        if not isinstance(pk, pmultisig.MultisigThresholdPubKey):
            return sig
        return sig[:-1] + bytes([sig[-1] ^ 1])

    return {"none": None, "ed25519": flip("Ed25519PubKey"), "sr25519": flip("Sr25519PubKey"),
            "secp256k1": flip("Secp256k1PubKey"), "secp256k1 high-S": high_s,
            "multisig": ms_flip}


@pytest.mark.parametrize("tamper", list(_tampers()))
def test_mixed_commit_verdicts_and_errors_equal_jax(tamper):
    """verify_commit and verify_commit_trusting (lite2's call) on the host
    hooks of both packages: the same pass or the same `wrong signature
    (#i)` for the first bad index, whichever key type it is."""
    pset, jset, signer_of = _mixed_sets()
    pc, jc = _mixed_commit(pset, signer_of, tamper=_tampers()[tamper])
    got = outcome(lambda: pset.verify_commit(CHAIN, _bid(pblock), 5, pc))
    assert got == outcome(lambda: jset.verify_commit(CHAIN, _bid(jtypes), 5, jc))
    assert (got[0] == "ok") == (tamper == "none")
    if tamper == "none":
        got = outcome(lambda: pset.verify_commit_trusting(CHAIN, _bid(pblock), 5, pc, 1, 3))
        assert got == outcome(lambda: jset.verify_commit_trusting(CHAIN, _bid(jtypes), 5, jc,
                                                                  1, 3)) == ("ok", None)


def test_mixed_batch_verify_routes_and_equals_jax():
    """mixed_batch_verify on the port's CPU engine (BatchVerifier and an
    installed TableCache): a call with any non-ed25519 signer declines the
    indexed hook and sends its ed25519 signatures alone to one flat batch;
    an all-ed25519 call takes the indexed path.  Verdicts equal the JAX
    package's host routing."""
    from tendermint_tpu.types.validator import mixed_batch_verify as jmixed

    pset, jset, signer_of = _mixed_sets()
    pc, _ = _mixed_commit(pset, signer_of, tamper=_tampers()["sr25519"])
    idxs = [i for i, cs in enumerate(pc.signatures) if not cs.is_absent()]
    pks = [pset.validators[i].pub_key for i in idxs]
    jpks = [jset.validators[i].pub_key for i in idxs]
    msgs = [pc.vote_sign_bytes(CHAIN, i) for i in idxs]
    sigs = [pc.signatures[i].signature for i in idxs]
    rec = FlightRecorder(size=256)
    bv = bvm.BatchVerifier(device="cpu", recorder=rec).install()
    bvm.TableCache(bv, tabulated=False).install()
    try:
        indexed = pset._indexed(idxs)
        got = pvalidator.mixed_batch_verify(pks, msgs, sigs, indexed=indexed)
        d = rec.events(kinds=["verify.dispatch"])
        n_ed = sum(isinstance(pk, pkeys.Ed25519PubKey) for pk in pks)
        assert [(e["path"], e["n"]) for e in d] == [("device", n_ed)]
        assert got == jmixed(jpks, msgs, sigs)
        assert got.count(False) == sum(isinstance(pk, psr.Sr25519PubKey) for pk in pks)
        ed = [j for j, pk in enumerate(pks) if isinstance(pk, pkeys.Ed25519PubKey)]
        seq = d[-1]["seq"] + 1
        got = pvalidator.mixed_batch_verify(
            [pks[j] for j in ed], [msgs[j] for j in ed], [sigs[j] for j in ed],
            indexed=pset._indexed([idxs[j] for j in ed]))
        assert got == [True] * len(ed)
        assert [e["path"] for e in rec.events(since=seq, kinds=["verify.dispatch"])] == ["indexed"]
    finally:
        batch_hook.set_verifier(None)
        batch_hook.set_indexed_verifier(None)


async def test_engine_commit_preverify_sends_only_ed25519_to_the_lane():
    """statesync's EngineCommitPreverify on a mixed commit: one arrival of
    the ed25519 signatures alone; the other keys verify in
    mixed_batch_verify, and the outcome equals the JAX package's."""
    import types

    import tendermint_tpu.statesync.syncer as jsyncer
    from tendermint_tpu.crypto.batch import host_batch_verify as jhost
    from tendermint_tpu_torch.statesync import syncer as psyncer

    from test_torch_statesync import _Lane

    pset, jset, signer_of = _mixed_sets()
    n_ed = sum(isinstance(v.pub_key, pkeys.Ed25519PubKey) for v in pset.validators)
    for tamper in (None, _tampers()["sr25519"]):
        got = []
        for mod, vset, commit, host in (
                (psyncer, pset, _mixed_commit(pset, signer_of, tamper)[0],
                 batch_hook.host_batch_verify),
                (jsyncer, jset, _mixed_commit(pset, signer_of, tamper)[1], jhost)):
            lane = _Lane(host)
            sh = types.SimpleNamespace(header=types.SimpleNamespace(chain_id=CHAIN), commit=commit)
            bv = await mod.EngineCommitPreverify(lane)(sh, [vset])
            assert lane.calls == [n_ed]
            got.append(outcome(lambda: vset.verify_commit(CHAIN, commit.block_id, 5, commit,
                                                          batch_verify=bv)))
        assert got[0] == got[1] and (got[0][0] == "ok") == (tamper is None)


def test_engine_key_and_abci_updates_route_as_jax():
    """The consensus reactor's _engine_key gives raw bytes only for ed25519
    (sr25519, secp256k1 and multisig votes verify on the host), and ABCI
    validator updates of sr25519 or secp256k1 keys raise the JAX
    package's ValueError."""
    from tendermint_tpu.abci.types import ValidatorUpdate as JUpdate
    from tendermint_tpu.consensus.reactor import ConsensusReactor as JReactor
    from tendermint_tpu.state.execution import validator_updates_from_abci as jupdates
    from tendermint_tpu_torch.abci.types import ValidatorUpdate as PUpdate
    from tendermint_tpu_torch.consensus.reactor import ConsensusReactor as PReactor
    from tendermint_tpu_torch.state.execution import validator_updates_from_abci as pupdates

    pset, jset, _ = _mixed_sets()
    for pv, jv in zip(pset.validators, jset.validators):
        ours, theirs = PReactor._engine_key(pv.pub_key), JReactor._engine_key(jv.pub_key)
        assert ours == theirs
        assert (ours is not None) == isinstance(pv.pub_key, pkeys.Ed25519PubKey)
    for v in pset.validators:
        kind = {"Sr25519PubKey": "sr25519", "Secp256k1PubKey": "secp256k1"}.get(
            type(v.pub_key).__name__)
        if kind is None:
            continue
        raw = v.pub_key.bytes()
        assert outcome(lambda: pupdates([PUpdate(kind, raw, 10)])) == outcome(
            lambda: jupdates([JUpdate(kind, raw, 10)]))
        assert outcome(lambda: pupdates([PUpdate(kind, raw, 10)]))[0] == "ValueError"


def test_signature_cap_refuses_a_multisig_validators_vote_as_jax():
    """MAX_SIGNATURE_SIZE is 96: a 2-of-3 multisig signature is larger, so
    such a validator sits in a set but cannot sign a vote or a commit."""
    _, _, _, _, ms2 = _mixed_keys()
    pub = pmultisig.MultisigThresholdPubKey(2, [k.pub_key() for k in ms2])
    vote = pvote.Vote(2, 5, 0, _bid(pblock), T0, pub.address(), 0)
    msg = vote.sign_bytes(CHAIN)
    sig = _multisig_sig(pmultisig, PBitArray, 3, [0, 1], [ms2[0].sign(msg), ms2[1].sign(msg)])
    assert len(sig) > 96 and pub.verify(msg, sig)
    vote.signature = sig
    jvote = jtypes.Vote(2, 5, 0, _bid(jtypes), T0, pub.address(), 0)
    jvote.signature = sig
    assert outcome(vote.validate_basic) == outcome(jvote.validate_basic)
    assert outcome(vote.validate_basic)[1].startswith("signature is too big (max: 96)")
    cs, jcs = pblock.CommitSig(2, pub.address(), T0, sig), jtypes.CommitSig(2, pub.address(), T0,
                                                                             sig)
    assert outcome(cs.validate_basic) == outcome(jcs.validate_basic)
    assert outcome(cs.validate_basic)[0] != "ok"


# ---------------------------------------------------------------------------
# keys on disk, init and testnet
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("key_type", ["ed25519", "sr25519", "secp256k1", "bls12381"])
def test_key_and_genesis_files_cross_load(key_type, tmp_path):
    for writer, reader in ((pfile, jfile), (jfile, pfile)):
        d = tmp_path / writer.__name__.split(".")[0]
        d.mkdir()
        kf, sf = str(d / "key.json"), str(d / "state.json")
        pv = writer.FilePV.generate(kf, sf, key_type)
        pv.save()
        other = reader.FilePV.load(kf, sf)
        assert other.get_pub_key().to_dict() == pv.get_pub_key().to_dict()
        assert other.address() == pv.address()
        msg = b"cross-load"
        assert pv.get_pub_key().verify(msg, other.key.priv_key.sign(msg))
        raw = open(kf, "rb").read()
        other.key.file_path = kf + ".again"
        other.key.save()
        assert open(kf + ".again", "rb").read() == raw
    ppv = pfile.FilePV.load(kf, sf)
    pub = ppv.get_pub_key()
    pop = pcli._pv_pop(ppv)
    assert (pop != b"") == (key_type == "bls12381")
    gen = pgenesis.GenesisDoc(CHAIN, genesis_time_ns=T0, validators=[
        pgenesis.GenesisValidator(pub.address(), pub, 10, pop=pop)])
    gen.save_as(str(tmp_path / "genesis.json"))
    jpub = jkeys.pubkey_from_dict(pub.to_dict())
    jgen = jtypes.GenesisDoc(CHAIN, genesis_time_ns=T0, validators=[
        jtypes.GenesisValidator(jpub.address(), jpub, 10, pop=pop)])
    jgen.save_as(str(tmp_path / "genesis-jax.json"))
    assert open(tmp_path / "genesis.json", "rb").read() == open(tmp_path / "genesis-jax.json",
                                                                "rb").read()
    back = pgenesis.GenesisDoc.from_file(str(tmp_path / "genesis-jax.json"))
    assert back.validators[0].pub_key == pub
    assert jtypes.GenesisDoc.from_file(str(tmp_path / "genesis.json")).validators[0].pub_key == jpub


def _seq_draws(cls, tag, make):
    seq = iter(range(1 << 20))
    return staticmethod(lambda: make(cls, b"%s-%d" % (tag, next(seq))))


def _patch_draws(monkeypatch):
    """The same key draws in both packages: ed25519 (node keys, and an
    ed25519 validator's) and the validator key type's."""
    def ed(cls, s):
        return cls.from_secret(s)

    def secp(cls, s):
        return cls(hashlib.sha256(s).digest())

    for blsmod in (jbls, pbls):
        monkeypatch.setattr(blsmod.BlsPrivKey, "generate", _seq_draws(blsmod.BlsPrivKey, b"bls", ed))
    for mod, srmod in ((jkeys, jsr), (pkeys, psr)):
        monkeypatch.setattr(mod.Ed25519PrivKey, "generate", _seq_draws(mod.Ed25519PrivKey, b"ed", ed))
        monkeypatch.setattr(srmod.Sr25519PrivKey, "generate",
                            _seq_draws(srmod.Sr25519PrivKey, b"sr", ed))
        monkeypatch.setattr(mod.Secp256k1PrivKey, "generate",
                            _seq_draws(mod.Secp256k1PrivKey, b"secp", secp))
    monkeypatch.setattr(time, "time_ns", lambda: 1_700_000_000_123_456_789)


FILES = ("config/config.toml", "config/genesis.json", "config/node_key.json",
         "config/priv_validator_key.json", "data/priv_validator_state.json")


@pytest.mark.parametrize("key_type", ["sr25519", "secp256k1", "bls12381"])
def test_init_and_testnet_trees_equal_jax(key_type, tmp_path, monkeypatch):
    _patch_draws(monkeypatch)
    for cmd, argv, homes in (
            ("init", ["init", "--chain-id", "kt-chain", "--key-type", key_type], [""]),
            ("testnet", ["testnet", "--validators", "3", "--chain-id", "kt-chain", "--key-type",
                         key_type], ["node0", "node1", "node2"])):
        out = {}
        for name, cli in (("j", jcli), ("p", pcli)):
            root = tmp_path / cmd / name
            args = (["--home", str(root)] + argv if cmd == "init"
                    else argv + ["--output", str(root)])
            parsed = cli.build_parser().parse_args(args)
            assert parsed.fn(parsed) == 0
            out[name] = root
        for home in homes:
            for f in FILES:
                a = (out["j"] / home / f).read_bytes()
                assert a == (out["p"] / home / f).read_bytes(), (cmd, home, f)
        key = json.loads((out["p"] / homes[0] / FILES[3]).read_text())
        want = {"sr25519": "tendermint/PrivKeySr25519",
                "secp256k1": "tendermint/PrivKeySecp256k1",
                "bls12381": "tendermint/PrivKeyBLS12381"}[key_type]
        assert key["priv_key"]["type"] == want
        gen = pgenesis.GenesisDoc.from_file(str(out["j"] / homes[0] / FILES[1]))
        assert base64.b64decode(json.loads((out["p"] / homes[0] / FILES[1]).read_text())[
            "validators"][0]["pub_key"]["value"]) == gen.validators[0].pub_key.bytes()


def test_bls_stays_refused_naming_the_roadmap_item(tmp_path):
    """bls12381 keys load, generate and make FilePVs as in the JAX package
    (the name is from when the port refused them)."""
    raw = pbls.BlsPrivKey.from_secret(b"kt-bls").pub_key().bytes()
    d = {"type": "tendermint/PubKeyBLS12381", "value": raw}
    ours, theirs = pkeys.pubkey_from_dict(d), jkeys.pubkey_from_dict(d)
    assert (ours.to_dict(), ours.address()) == (theirs.to_dict(), theirs.address())
    assert type(pkeys.generate_priv_key("bls12381")) is pbls.BlsPrivKey
    pv = pfile.FilePV.generate(str(tmp_path / "k"), str(tmp_path / "s"), "bls12381")
    assert jkeys.pubkey_from_dict(pv.get_pub_key().to_dict()).address() == pv.address()
    bad = {"type": "tendermint/PubKeyBLS12381", "value": b"\x00" * 47}
    assert outcome(lambda: pkeys.pubkey_from_dict(bad)) == outcome(
        lambda: jkeys.pubkey_from_dict(bad))


# ---------------------------------------------------------------------------
# consensus on sr25519 keys
# ---------------------------------------------------------------------------


async def test_sr25519_port_net_commits():
    """Four port nodes whose validators hold sr25519 keys commit 3 heights
    with identical blocks (the port's counterpart of
    tests/test_sr25519.py's net test); their votes verify on the host."""
    import asyncio

    from tendermint_tpu_torch.config import test_config
    from tendermint_tpu_torch.node import Node
    from tendermint_tpu_torch.types.params import BlockParams, ConsensusParams
    from tendermint_tpu_torch.types.priv_validator import MockPV

    import tempfile

    pvs = sorted([MockPV(priv_key=psr.Sr25519PrivKey.from_secret(b"net%d" % i))
                  for i in range(4)], key=lambda pv: pv.address())
    gen = pgenesis.GenesisDoc(
        chain_id="sr-chain", genesis_time_ns=T0,
        validators=[pgenesis.GenesisValidator(pv.address(), pv.get_pub_key(), 10) for pv in pvs],
        consensus_params=ConsensusParams(block=BlockParams(time_iota_ms=1)))
    nodes = []
    with tempfile.TemporaryDirectory() as tmp:
        for i, pv in enumerate(pvs):
            cfg = test_config(os.path.join(tmp, f"sr{i}"))
            cfg.rpc.laddr = ""
            cfg.base.db_backend = "memdb"
            cfg.p2p.laddr = "127.0.0.1:0"
            cfg.p2p.pex = False
            cfg.consensus.skip_timeout_commit = False
            cfg.consensus.timeout_commit = 0.1
            cfg.tpu.enabled = True
            nodes.append(Node(cfg, gen, priv_validator=pv, db_backend="memdb", device="cpu"))
        try:
            for node in nodes:
                await node.start()
            for i in range(4):
                for j in range(i + 1, 4):
                    await nodes[i].switch.dial_peer(
                        f"{nodes[j].node_key.id}@{nodes[j].switch.transport.listen_addr}")

            async def reached():
                while not all(n.block_store.height() >= 3 for n in nodes):
                    await asyncio.sleep(0.05)

            await asyncio.wait_for(reached(), 60.0)
            for h in (1, 2, 3):
                assert len({n.block_store.load_block(h).hash() for n in nodes}) == 1
            commit = nodes[0].block_store.load_block(3).last_commit
            assert sum(not cs.is_absent() for cs in commit.signatures) >= 3
            nodes[0].state_store.load_validators(2).verify_commit(
                "sr-chain", commit.block_id, 2, commit)
        finally:
            for n in nodes:
                if n.is_running:
                    await n.stop()
            batch_hook.set_verifier(None)
            batch_hook.set_indexed_verifier(None)


@pytest.mark.parametrize("client_pkg,server_pkg", [("port", "jax"), ("jax", "port")])
async def test_remote_signer_carries_an_sr25519_key(client_pkg, server_pkg):
    """The remote signer's pubkey response and signatures with an sr25519
    key, across packages: the client's key is the FilePV's, and every
    signature equals the one the FilePV makes locally."""
    import tempfile

    from test_torch_signer import CHAIN as CHAIN_SIGNER
    from test_torch_signer import PKGS, listening, proposal, seeded, signatures, vote

    c, s = PKGS[client_pkg], PKGS[server_pkg]
    srmod = psr if s.name == "port" else jsr

    def file_pv(ns, tmp, mod):
        key = mod.Sr25519PrivKey.from_secret(b"remote-sr")
        pv = ns.file.FilePV(
            ns.file.FilePVKey(key.pub_key().address(), key.pub_key(), key,
                              os.path.join(tmp, f"key-{ns.name}.json")),
            ns.file.FilePVLastSignState(file_path=os.path.join(tmp, f"state-{ns.name}.json")))
        pv.save()
        return pv

    with tempfile.TemporaryDirectory() as tmp:
        kw = {"conn_key": c.PrivKey.from_secret(b"conn-client"), "nonce_fn": seeded(1)} \
            if c.name == "port" else {}
        client = c.signer.SignerClient("tcp://127.0.0.1:0", **kw)
        task, addr = await listening(client)
        skw = {"conn_key": s.PrivKey.from_secret(b"conn-server")} if s.name == "port" else {}
        server = s.signer.SignerServer(addr, file_pv(s, tmp, srmod), **skw)
        await server.start()
        await task
        try:
            assert client.get_pub_key().to_dict() == psr.Sr25519PrivKey.from_secret(
                b"remote-sr").pub_key().to_dict()
            got = await signatures(c, client)
        finally:
            await client.stop()
            await server.stop()
        local = file_pv(c, tmp, psr if c.name == "port" else jsr)
        p = proposal(c, 5)
        local.sign_proposal(CHAIN_SIGNER, p)
        want = [p.signature]
        for kind in (1, 2):
            v = vote(c, local.get_pub_key().address(), 5, kind)
            local.sign_vote(CHAIN_SIGNER, v)
            want.append(v.signature)
    assert got == want + ["conflicting data: same HRS, different vote"]

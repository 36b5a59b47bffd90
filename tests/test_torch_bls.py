"""The port's BLS12-381 tier (tendermint_tpu_torch/crypto/bls and
csrc/bls12_381.c) against the JAX package's (tendermint_tpu/crypto/bls), bit
for bit.  Each case runs four times: each package's C tier and each
package's pure-Python tier (`ctier.set_forced("pure")`), and the four
results must be equal — bytes, points and verdicts.  Tolerance 0.

Cases (the JAX tests' own, tests/test_bls.py): the RFC 9380
expand_message_xmd vectors, the generator encodings, hash_to_g2, pairing
bilinearity and the pairing product's GT element, keygen, sign, verify,
aggregate, fast_aggregate_verify, batch_verify_aggregates with the liar
attributed, proof of possession, adversarial encodings (infinity,
non-canonical, off the subgroup), and the rogue-key attack that a proof of
possession stops.  Keys and messages come from seeded
numpy.  The pure tier is slow, so its runs keep to a few pairings.

Also: the C tier builds into the package's `_build/` with the source hash
in its name, a host without a toolchain falls back to the pure tier with
one warning, the codec tags equal JAX's, and the batched device fold
(`bls_jax_aggregation`, ported in crypto/bls/cuda_tier.py) is refused only
where it cannot run, on a host without a card unless the CPU is named; a
mesh is taken and folds on its first device's kind.
"""

import contextlib
import logging
import os

import numpy as np
import pytest
import torch

import tendermint_tpu.crypto.bls as jbls
import tendermint_tpu.crypto.bls.ctier as jctier
import tendermint_tpu.crypto.bls.curve as jcurve
import tendermint_tpu.crypto.bls.fields as jfields
import tendermint_tpu.crypto.bls.hash_to_curve as jh2c
import tendermint_tpu.crypto.bls.pairing as jpairing
import tendermint_tpu.crypto.bls.scheme as jscheme
from tendermint_tpu.encoding import codec as jcodec
from tendermint_tpu_torch.crypto import bls as pbls
from tendermint_tpu_torch.crypto.bls import ctier as pctier
from tendermint_tpu_torch.crypto.bls import curve as pcurve
from tendermint_tpu_torch.crypto.bls import fields as pfields
from tendermint_tpu_torch.crypto.bls import hash_to_curve as ph2c
from tendermint_tpu_torch.crypto.bls import pairing as ppairing
from tendermint_tpu_torch.crypto.bls import scheme as pscheme
from tendermint_tpu_torch.encoding import codec as pcodec

SEED = 381


class _Pkg:
    def __init__(self, name, bls, ctier, curve, fields, h2c, pairing, scheme, codec):
        self.name, self.bls, self.ctier, self.curve = name, bls, ctier, curve
        self.fields, self.h2c, self.pairing, self.scheme, self.codec = (
            fields, h2c, pairing, scheme, codec)


JAX = _Pkg("jax", jbls, jctier, jcurve, jfields, jh2c, jpairing, jscheme, jcodec)
PORT = _Pkg("port", pbls, pctier, pcurve, pfields, ph2c, ppairing, pscheme, pcodec)


@contextlib.contextmanager
def tier(pkg, name):
    pkg.ctier.set_forced("pure" if name == "pure" else None)
    pkg.scheme._memo.clear()
    try:
        assert pkg.scheme.active_tier() == name
        yield pkg
    finally:
        pkg.ctier.set_forced(None)
        pkg.scheme._memo.clear()


def four(fn, tiers=("c", "pure")):
    """fn(pkg) under each package's C and pure tiers; all results equal."""
    out = {}
    for name in tiers:
        for pkg in (JAX, PORT):
            with tier(pkg, name):
                out[(pkg.name, name)] = fn(pkg)
    first = next(iter(out.values()))
    for k, v in out.items():
        assert v == first, f"{k} differs from {next(iter(out))}"
    return first


def seeds(n, tag):
    r = np.random.default_rng(SEED + tag)
    return [bytes(r.integers(0, 256, 32, dtype=np.uint8)) for _ in range(n)]


# ---------------------------------------------------------------------------
# known answers
# ---------------------------------------------------------------------------

XMD_DST = b"QUUX-V01-CS02-with-expander-SHA256-128"
XMD_VECTORS = [
    (b"", "68a985b87eb6b46952128911f2a4412bbc302a9d759667f87f7a21d803f07235"),
    (b"abc", "d8ccab23b5985ccea865c6c97b6e5b8350e794e603b4b97902f53a8a0d605615"),
    (b"abcdef0123456789", "eff31487c770a893cfb36f912fbfcbff40d5661771ca4b2cb4eafe524333f5c1"),
    (b"q128_" + b"q" * 128, "b23a1d2b4d97b2ef7785562a7e8bac7eed54ed6e97e29aa51bfe3f12ddad1ff9"),
    (b"a512_" + b"a" * 512, "4623227bcc01293b8c130bf771da8c298dede7383243dc0993d2d94823958c4c"),
]


def test_expand_message_xmd_rfc9380_vectors_in_every_tier():
    for pkg in (JAX, PORT):
        for msg, want in XMD_VECTORS:
            assert pkg.h2c.expand_message_xmd(msg, XMD_DST, 0x20).hex() == want
            assert pkg.ctier.expand_message_xmd(msg, XMD_DST, 0x20).hex() == want
    r = np.random.default_rng(SEED)
    for n in (0, 1, 32, 96, 255):
        msg = bytes(r.integers(0, 256, int(r.integers(0, 300)), dtype=np.uint8))
        outs = {pkg.h2c.expand_message_xmd(msg, XMD_DST, n) for pkg in (JAX, PORT)}
        outs |= {pkg.ctier.expand_message_xmd(msg, XMD_DST, n) for pkg in (JAX, PORT)}
        assert len(outs) == 1 and len(outs.pop()) == n


def test_generator_encodings_and_decompression():
    def case(pkg):
        c = pkg.curve
        g1, g2 = c.g1_compress(c.G1_GEN), c.g2_compress(c.G2_GEN)
        out = [g1.hex(), g2.hex()]
        p = c.g1_mul(c.G1_GEN, 0xDEADBEEF)
        q = c.g2_mul(c.G2_GEN, 0xC0FFEE)
        out += [c.g1_compress(p), c.g2_compress(q),
                c.g1_eq(c.g1_decompress(c.g1_compress(p)), p),
                c.g2_eq(c.g2_decompress(c.g2_compress(q)), q),
                c.g1_decompress(b"\x99" + b"\x00" * 47), c.g2_decompress(b"\x99" + b"\x00" * 95)]
        ct = pkg.ctier
        b1, b2 = ct.g1_decompress(g1), ct.g2_decompress(g2)
        out += [b1, b2, ct.g1_decompress(bytes([0xC0]) + b"\x00" * 47) is ct.INF,
                ct.g2_decompress(bytes([0xC0]) + b"\x00" * 95) is ct.INF]
        return out

    out = four(case, tiers=("c",))
    assert out[0] == ("97f1d3a73197d7942695638c4fa9ac0fc3688c4f9774b905a14e3a3f171bac58"
                      "6c55e83ff97a1aeffb3af00adb22c6bb")
    assert out[1].startswith("93e02b6052719f607dacd3a088274f65596bd0d09920b61ab5da61bbdc7f5049")
    assert out[4] and out[5] and out[6] is None and out[7] is None and out[-1] and out[-2]


def test_hash_to_g2_bit_identical_across_tiers_and_packages():
    r = np.random.default_rng(SEED + 1)
    msgs = [b"consensus msg"] + [bytes(r.integers(0, 256, int(r.integers(1, 120)),
                                                   dtype=np.uint8)) for _ in range(3)]
    out = set()
    for pkg in (JAX, PORT):
        for dst in (pkg.scheme.DST_SIG, pkg.scheme.DST_POP):
            pts = [pkg.h2c.hash_to_g2(m, dst) for m in msgs]
            assert all(pkg.curve.g2_in_subgroup(p) for p in pts)
            out.add((dst, tuple(pkg.curve.g2_compress(p) for p in pts)))
            out.add((dst, tuple(pkg.curve.g2_compress(pkg.ctier.g2_point(
                pkg.ctier.hash_to_g2_blob(m, dst))) for m in msgs)))
    assert len(out) == 2  # one per DST, equal in all four lanes


def test_pairing_bilinearity_and_gt_element():
    """e(aP, Q)·e(-P, aQ) == 1 and != 1 for a+1 in every lane; the pairing
    product's GT element is the same in all four (the C tier's HHT final
    exponentiation equals the pure tier's)."""
    a = 0x1234567

    def case(pkg):
        c = pkg.curve
        p, q = c.G1_GEN, c.G2_GEN
        good = pkg.pairing.pairing_check([(c.g1_mul(p, a), q), (c.g1_neg(p), c.g2_mul(q, a))])
        bad = pkg.pairing.pairing_check([(c.g1_mul(p, a), q), (c.g1_neg(p), c.g2_mul(q, a + 1))])
        gt = pkg.pairing.pairing_product([(c.g1_mul(p, 7), c.g2_mul(q, 11))])
        return good, bad, gt

    good, bad, _ = four(case)
    assert good is True and bad is False


# ---------------------------------------------------------------------------
# the scheme
# ---------------------------------------------------------------------------


def test_keygen_sign_and_aggregate_bytes_equal():
    ikms = seeds(3, 2)

    def case(pkg):
        s = pkg.scheme
        sks = [s.keygen(i) for i in ikms]
        msg = b"the one aggregated message"
        sigs = [s.sign(sk, msg) for sk in sks]
        out = [sks, [s.sk_to_pk(sk) for sk in sks], sigs, s.aggregate_signatures(sigs),
               s.aggregate_pubkeys([s.sk_to_pk(sk) for sk in sks]), s.pop_prove(sks[0]),
               pkg.bls.BlsPrivKey(ikms[0]).pub_key().address()]
        return out

    out = four(case)
    assert all(0 < sk < pfields.R for sk in out[0]) and len(out[3]) == 96
    with pytest.raises(ValueError):
        pscheme.keygen(b"short")


def test_verify_and_fast_aggregate_verdicts_equal():
    ikms = seeds(4, 3)
    prepared = {}

    for pkg in (JAX, PORT):
        with tier(pkg, "c"):
            sks = [pkg.scheme.keygen(i) for i in ikms]
            msg = b"verdicts"
            prepared[pkg.name] = (sks, [pkg.scheme.sk_to_pk(sk) for sk in sks],
                                  pkg.scheme.aggregate_signatures(
                                      [pkg.scheme.sign(sk, msg) for sk in sks]),
                                  pkg.scheme.sign(sks[0], msg))

    def case(pkg):
        s = pkg.scheme
        sks, pks, agg, sig = prepared[pkg.name]
        return [s.verify(pks[0], b"verdicts", sig), s.verify(pks[0], b"other", sig),
                s.verify(pks[1], b"verdicts", sig),
                s.fast_aggregate_verify(pks, b"verdicts", agg),
                s.fast_aggregate_verify(pks[:-1], b"verdicts", agg),
                s.fast_aggregate_verify([], b"verdicts", agg)]

    assert four(case) == [True, False, False, True, False, False]


def test_batch_verify_aggregates_attributes_the_liar():
    def case(pkg):
        s = pkg.scheme
        sks = [s.keygen(i) for i in seeds(3, 4)]
        pks = [s.sk_to_pk(sk) for sk in sks]
        good = s.aggregate_signatures([s.sign(sk, b"m") for sk in sks])
        bad = s.aggregate_signatures([s.sign(sk, b"forged") for sk in sks])
        res = s.batch_verify_aggregates([(pks, b"m", good), (pks, b"m", bad), (pks, b"m", good)])
        return res, s.memo_get(pks, b"m", good), s.memo_get(pks, b"m", bad)

    assert four(case) == ([True, False, True], True, False)


def test_proof_of_possession_equal():
    def case(pkg):
        k = pkg.bls.BlsPrivKey(seeds(1, 5)[0])
        other = pkg.bls.BlsPrivKey(seeds(2, 5)[1])
        pk = k.pub_key()
        return [k.pop(), pk.verify_pop(k.pop()), pk.verify_pop(b"\x01" * 96),
                pk.verify_pop(other.pop()),
                pkg.scheme.batch_pop_verify([(pk.bytes(), k.pop()),
                                             (other.pub_key().bytes(), other.pop())]),
                pkg.scheme.batch_pop_verify([(pk.bytes(), other.pop())])]

    out = four(case)
    assert out[1:] == [True, False, False, True, False]


def test_rogue_key_attack_without_a_proof_of_possession():
    """pk_mal = pk_rogue - pk_victim lets an attacker forge an aggregate of
    {victim, mal} from the rogue key alone: fast_aggregate_verify accepts it
    in every lane, which is why genesis and ABCI updates demand a proof of
    possession, and none verifies for pk_mal (JAX
    TestScheme.test_rogue_key_attack_works_without_pop)."""
    def case(pkg):
        s, c = pkg.scheme, pkg.curve
        victim = pkg.bls.BlsPrivKey.from_secret(b"victim")
        rogue_sk = s.keygen(b"\x66" * 32)
        mal = c.g1_compress(c.g1_add(c.g1_mul(c.G1_GEN, rogue_sk),
                                     c.g1_neg(c.g1_decompress(victim.pub_key().bytes()))))
        forged = s.sign(rogue_sk, b"forged block")
        return [mal, s.fast_aggregate_verify([victim.pub_key().bytes(), mal], b"forged block",
                                             forged),
                s.pop_verify(mal, s.pop_prove(rogue_sk)),
                s.batch_pop_verify([(victim.pub_key().bytes(), victim.pop()),
                                    (mal, s.pop_prove(rogue_sk))])]

    assert four(case)[1:] == [True, False, False]


def _non_subgroup_g1(curve, fields):
    x = 5
    while True:
        y = fields.fp_sqrt((x * x * x + 4) % fields.P)
        if y is not None and not curve.g1_in_subgroup((x, y, 1)):
            return curve.g1_compress((x, y, 1))
        x += 1


def _non_subgroup_g2(curve, fields):
    x = (1, 0)
    while True:
        y = fields.f2_sqrt(fields.f2_add(fields.f2_mul(fields.f2_sq(x), x), (4, 4)))
        if y is not None and not curve.g2_in_subgroup((x, y, (1, 0))):
            return curve.g2_compress((x, y, (1, 0)))
        x = (x[0] + 1, x[1])


def test_adversarial_encodings_rejected_identically():
    """Infinity, non-canonical, off-subgroup and mangled encodings: the
    strict, fast-aggregate and batch lanes reject each the same way in all
    four tiers, and every one is rejected."""
    def case(pkg):
        s, c = pkg.scheme, pkg.curve
        sk1 = s.keygen(b"\x07" * 32)
        sk2 = pkg.fields.R - sk1
        inf_pair = [s.sk_to_pk(sk1), s.sk_to_pk(sk2)]
        forged = s.aggregate_signatures([s.sign(sk1, b"any"), s.sign(sk2, b"any")])
        pk, sig = s.sk_to_pk(sk1), s.sign(sk1, b"msg")
        pks = {
            "non_subgroup_g1": _non_subgroup_g1(c, pkg.fields),
            "compress_bit_clear": bytes([pk[0] & 0x7F]) + pk[1:],
            "x_ge_p": bytes([0x9F]) + b"\xff" * 47,
            "inf_with_tail": bytes([0xC0]) + b"\x00" * 46 + b"\x01",
            "inf_with_sign": bytes([0xE0]) + b"\x00" * 47,
            "flipped_bit": bytes([pk[0]]) + bytes([pk[1] ^ 1]) + pk[2:],
            "truncated": pk[:-1],
            "infinity_pk": bytes([0xC0]) + b"\x00" * 47,
        }
        sigs = {
            "non_subgroup_g2": _non_subgroup_g2(c, pkg.fields),
            "compress_bit_clear": bytes([sig[0] & 0x7F]) + sig[1:],
            "inf_with_tail": bytes([0xC0]) + b"\x00" * 94 + b"\x01",
            "truncated": sig[:-1],
            "infinity_sig": c.g2_compress(c.G2_INF),
        }
        v = {}
        for tag, mpk in pks.items():
            v[("verify", tag)] = s.verify(mpk, b"msg", sig)
            v[("fagg", tag)] = s.fast_aggregate_verify([mpk], b"msg", sig)
            v[("batch", tag)] = s.batch_verify_aggregates([([mpk], b"msg", sig)])
            v[("pure_decompress", tag)] = (c.g1_decompress(mpk) if len(mpk) == 48 else None)
        for tag, msig in sigs.items():
            v[("sig", tag)] = s.verify(pk, b"msg", msig)
        v["inf_apk_strict"] = s.fast_aggregate_verify(inf_pair, b"any", forged)
        v["inf_apk_batch"] = s.batch_verify_aggregates([(inf_pair, b"any", forged)])
        return v

    v = four(case)
    for k, got in v.items():
        if k[0] == "pure_decompress":
            assert got == (pcurve.G1_INF if k[1] == "infinity_pk" else None), k
        else:
            assert got in (False, [False]), k


# ---------------------------------------------------------------------------
# the C tier's build, its fallback, keys and the refused device fold
# ---------------------------------------------------------------------------


def test_c_tier_builds_into_the_package_build_dir():
    """The port's copy of bls12_381.c is the JAX one's code (comments
    aside), built into the port's `_build/` under its source hash."""
    import hashlib
    import re

    def code(path):
        text = open(os.path.join(path, "bls12_381.c")).read()
        return re.sub(r"/\*.*?\*/", "", text, flags=re.S)

    assert pctier.available()
    assert code(pctier._csrc_path()) == code(jctier._csrc_path())
    src_hash = hashlib.sha256(open(os.path.join(pctier._csrc_path(), "bls12_381.c"),
                                   "rb").read()).hexdigest()[:16]
    built = [f for f in os.listdir(pctier._build_path()) if f.startswith("bls12_381-")]
    assert any(f.endswith(f"-{src_hash}.so") for f in built), built
    assert os.path.dirname(pctier._build_path()) == os.path.dirname(pctier._csrc_path())


def test_no_toolchain_falls_back_pure_with_one_warning(monkeypatch, caplog):
    """The port's copy of JAX TestCTierFallback: no compiler → the pure tier,
    one warning, and a working scheme."""
    monkeypatch.setattr(pctier, "_lib", None)
    monkeypatch.setattr(pctier, "_lib_tried", False)
    monkeypatch.setattr(pctier, "_csrc_path", lambda: "/nonexistent-csrc")
    with caplog.at_level(logging.WARNING, logger=pctier.__name__):
        assert not pctier.available()
        assert not pctier.available()
    warnings = [r for r in caplog.records if "C pairing tier" in r.message]
    assert len(warnings) == 1
    assert pscheme.active_tier() == "pure"
    sk = pscheme.keygen(b"\x55" * 32)
    pk, sig = pscheme.sk_to_pk(sk), pscheme.sign(sk, b"fallback")
    assert pscheme.verify(pk, b"fallback", sig) and not pscheme.verify(pk, b"tampered", sig)
    with pytest.raises(ValueError):
        pscheme.keygen(b"")


def test_keys_codec_and_refused_device_fold():
    ikm = seeds(1, 6)[0]
    jk, pk = jbls.BlsPrivKey(ikm), pbls.BlsPrivKey(ikm)
    assert pcodec.dumps(pk.pub_key()) == jcodec.dumps(jk.pub_key())
    assert pcodec.dumps(pk) == jcodec.dumps(jk)
    assert pcodec.loads(jcodec.dumps(jk.pub_key())) == pk.pub_key()
    assert pk.to_dict() == jk.to_dict() and pk.pub_key().to_dict() == jk.pub_key().to_dict()
    assert pbls.BlsPrivKey.from_secret(b"s").bytes() == jbls.BlsPrivKey.from_secret(b"s").bytes()
    assert (pk.pub_key().verify(b"m", pk.sign(b"m")), pk.pub_key().verify(b"m", b"\x00" * 95)) == (
        True, False)
    pscheme.set_jax_aggregation(False)
    from tendermint_tpu_torch.crypto.backend import Mesh

    mesh = Mesh(["cpu", "cpu"])
    pscheme.set_jax_aggregation(True, mesh=mesh)
    assert pscheme._fold_mesh is mesh and pscheme._fold_device == torch.device("cpu")
    try:
        pscheme.set_jax_aggregation(True, device="cpu")
        assert pscheme._fold_device == torch.device("cpu")
        if not torch.cuda.is_available():
            with pytest.raises(RuntimeError, match="CUDA is not available"):
                pscheme.set_jax_aggregation(True)
    finally:
        pscheme.set_jax_aggregation(False)
    assert pscheme._fold_device is None and pscheme._fold_mesh is None
    from tendermint_tpu_torch.config import Config
    from tendermint_tpu_torch.node import check_ported

    cfg = Config(home="/nonexistent")
    cfg.tpu.bls_jax_aggregation = True
    check_ported(cfg)

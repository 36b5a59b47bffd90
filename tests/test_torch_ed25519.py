"""The port's plain ed25519 ladder and tabulated verify
(tendermint_tpu_torch/ops/ed25519.py, ops/ed25519_table.py) against the
JAX package's XLA ladder, window-table build and Pallas tabulated kernel,
and against the pure-Python oracle.

Verdicts must be identical; window tables bit-identical (integer math,
tolerance 0).  The batch is 16 signatures, the bucket the JAX package's own
tests compile.  The CUDA kernels themselves run only on the card
(chip_smoke.py); here the wrappers take their plain versions because the
tensors lie on the CPU.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tendermint_tpu.crypto.batch_verifier import prepare_batch as jax_prepare_batch
from tendermint_tpu.ops import ed25519 as jed
from tendermint_tpu.ops import ed25519_table as jtab
from tendermint_tpu_torch.crypto import batch_verifier as bvm
from tendermint_tpu_torch.crypto import ed25519_math as em
from tendermint_tpu_torch.crypto.keys import Ed25519PrivKey
from tendermint_tpu_torch.ops import ed25519, ed25519_cuda, ed25519_table

# B <= 16: intra-op threads buy nothing here and contend with other test workers
torch.set_num_threads(1)

B = 16
IDENT_PK = (1).to_bytes(32, "little")


def mixed_batch(seed=0):
    """16 (pubkey, msg, sig) triples: valid signatures and every corruption
    class (wrong message / key, flipped R and s bits, non-canonical S,
    identity key with canonical and non-canonical R, invalid pubkey)."""
    rng = np.random.default_rng(seed)
    keys = [Ed25519PrivKey.from_secret(f"val-{i}".encode()) for i in range(6)]
    pks = [k.pub_key().bytes() for k in keys]
    out = []
    for i in range(B):
        k = i % len(keys)
        msg = f"precommit-{i}".encode()
        sig = keys[k].sign(msg)
        pk = pks[k]
        kind = i % 8
        if kind == 1:
            msg += b"!"
        elif kind == 2:
            pk = pks[(k + 1) % len(keys)]
        elif kind == 3:
            b = bytearray(sig)
            b[int(rng.integers(0, 64))] ^= 1 << int(rng.integers(0, 8))
            sig = bytes(b)
        elif kind == 4:
            s = int.from_bytes(sig[32:], "little") + em.L
            sig = sig[:32] + s.to_bytes(32, "little")
        elif kind == 5:
            pk, sig = IDENT_PK, IDENT_PK + bytes(32)
        elif kind == 6:
            pk, sig = IDENT_PK, (em.P + 1).to_bytes(32, "little") + bytes(32)
        elif kind == 7 and i > 8:
            pk = b"\xff" * 32
        out.append((pk, msg, sig))
    return out, pks


def _jax_verdicts(triples):
    neg_a, h, s, ry, rs, valid = jax_prepare_batch(*zip(*triples))
    ok = np.asarray(jed.verify_prepared_jit(neg_a, h, s, ry, rs))
    return np.logical_and(ok, valid)


@pytest.fixture(scope="module")
def batch():
    triples, pks = mixed_batch()
    prepared = bvm.prepare_batch(*zip(*triples))
    oracle = np.array([em.verify(*t) for t in triples])
    return triples, pks, prepared, oracle


def test_tables_and_constants_match_jax():
    np.testing.assert_array_equal(ed25519.BASE_TABLE, jed.BASE_TABLE)
    np.testing.assert_array_equal(ed25519_table.base_windows(), jtab.base_windows())
    assert [bvm._neg_a_limbs(pk) is None for pk in (IDENT_PK, b"\xff" * 32)] == [False, True]


def test_plain_ladder_matches_jax_and_oracle(batch):
    triples, _, (neg_a, h, s, ry, rs, valid), oracle = batch
    assert oracle.sum() >= 4 and not oracle.all()
    got = ed25519.verify_prepared(*map(torch.as_tensor, (neg_a, h, s, ry, rs)))
    verdicts = np.logical_and(got.numpy(), valid)
    np.testing.assert_array_equal(verdicts, _jax_verdicts(triples))
    np.testing.assert_array_equal(verdicts, oracle)


def test_r_prime_encoding_is_signature_r(batch):
    """For every accepted signature the computed R' encodes to R."""
    triples, _, (neg_a, h, s, ry, rs, valid), oracle = batch
    ok, r = ed25519.verify_prepared(*map(torch.as_tensor, (neg_a, h, s, ry, rs)), want_r=True)
    for i, (pk, msg, sig) in enumerate(triples):
        if oracle[i]:
            assert r[i].numpy().tobytes() == sig[:32]
    non_canonical = [i for i, t in enumerate(triples) if t[2][:32] == (em.P + 1).to_bytes(32, "little")]
    assert non_canonical and all(r[i].numpy().tobytes() == IDENT_PK for i in non_canonical)
    assert not ok[non_canonical].any()


def test_expand_and_pack_round_trip():
    rng = np.random.default_rng(5)
    le = rng.integers(0, 256, (B, 32), dtype=np.uint8)
    digits = bvm._msb_digits(le)
    np.testing.assert_array_equal(ed25519.expand_digits(torch.as_tensor(le)).numpy(), digits)
    np.testing.assert_array_equal(np.asarray(jed.expand_digits(jnp.asarray(le))), digits)
    np.testing.assert_array_equal(bvm._pack_digits(digits), le)


def test_window_tables_bit_identical_to_jax(batch):
    _, pks, _, _ = batch
    rows = np.stack([bvm._neg_a_limbs(pk) for pk in pks[:4]])
    got = ed25519_table.build_window_tables_plain(torch.as_tensor(rows))
    want = np.asarray(jtab.build_window_tables(rows.astype(np.int32)))
    assert got.dtype == torch.int16 and want.dtype == np.int16
    np.testing.assert_array_equal(got.numpy(), want)
    # the wrapper on a CPU tensor is the plain build
    np.testing.assert_array_equal(ed25519_table.build_window_tables(torch.as_tensor(rows)).numpy(), want)


def _indexed_inputs(triples, pks):
    """Row table over pks (+ identity, invalid) and per-signature indices."""
    all_pks = list(pks) + [IDENT_PK, b"\xff" * 32]
    rows = np.stack([bvm._neg_a_limbs(pk) if bvm._neg_a_limbs(pk) is not None
                     else bvm.IDENTITY_ROW for pk in all_pks])
    idx = np.array([all_pks.index(t[0]) for t in triples], dtype=np.int32)
    return rows, idx


def test_plain_tabulated_matches_jax_ladder_and_oracle(batch):
    triples, pks, (_, h, s, ry, rs, valid), oracle = batch
    rows, idx = _indexed_inputs(triples, pks)
    tables = ed25519_table.build_window_tables_plain(torch.as_tensor(rows))
    got = ed25519_table.verify_tabulated_plain(tables, *map(torch.as_tensor, (idx, h, s, ry, rs)))
    verdicts = np.logical_and(got.numpy(), valid)
    np.testing.assert_array_equal(verdicts, _jax_verdicts(triples))
    np.testing.assert_array_equal(verdicts, oracle)


def test_wrappers_take_plain_versions_on_cpu(batch):
    triples, pks, (_, h, s, ry, rs, valid), oracle = batch
    rows, idx = _indexed_inputs(triples, pks)
    args = [torch.as_tensor(a) for a in (idx, bvm._pack_digits(h), bvm._pack_digits(s), ry, rs)]
    launches = (ed25519_cuda.LAUNCHES, ed25519_table.SUM_LAUNCHES)
    ok, r = ed25519_cuda.verify_indexed(torch.as_tensor(rows), *args, want_r=True)
    ok_p, r_p = ed25519.verify_prepared_packed(torch.as_tensor(rows)[args[0].long()], *args[1:], want_r=True)
    assert torch.equal(ok, ok_p) and torch.equal(r, r_p)
    tables = ed25519_table.build_window_tables(torch.as_tensor(rows))
    ok_t, r_t = ed25519_table.verify_tabulated(tables, *args, want_r=True)
    assert torch.equal(ok_t, ok) and torch.equal(r_t, r)
    np.testing.assert_array_equal(np.logical_and(ok.numpy(), valid), oracle)
    # plain runs are not kernel launches
    assert (ed25519_cuda.LAUNCHES, ed25519_table.SUM_LAUNCHES) == launches


@pytest.mark.slow  # the Pallas kernel in interpret mode: minutes on a small host
def test_plain_tabulated_matches_jax_pallas_interpret(batch):
    triples, pks, (_, h, s, ry, rs, valid), oracle = batch
    rows, idx = _indexed_inputs(triples, pks)
    tables = ed25519_table.build_window_tables_plain(torch.as_tensor(rows))
    got = ed25519_table.verify_tabulated_plain(tables, *map(torch.as_tensor, (idx, h, s, ry, rs)))
    want = np.asarray(jtab.verify_tabulated(
        jnp.asarray(tables.numpy()), idx, h, s, ry, rs, tile=B, interpret=True))
    np.testing.assert_array_equal(got.numpy(), want)

"""Kernel 3's design (csrc/ed25519_table.cu tabulated_kernel) held on the
CPU: its madd-form base table, and the order it sums in.

The kernel spreads a signature over two quads: quad q sums windows
32q ... 32q + 31, each window's validator-table row added from the cached
form (Y−X, Y+X, 2d·T, Z) and its base window by mixed add from
`base_windows_madd()`, then one add joins the two sums.  That is another
order, and other formulas, than the plain version's single chain of 128
complete adds, so the projective limbs differ; the verdicts and the
canonical R′ bytes must not.  Here a plain torch model of that order is held
against `verify_tabulated_plain`, the JAX package's XLA ladder and the
pure-Python oracle, at tolerance 0.  (The plain version itself is held
against the JAX Pallas kernel in interpret mode by the slow test in
tests/test_torch_ed25519.py.)  The CUDA kernel runs only on the card, where
chip_smoke.py holds it against the plain version.
"""

import numpy as np
import pytest
import torch

from tendermint_tpu.ops import ed25519 as jed
from tendermint_tpu_torch.crypto import batch_verifier as bvm
from tendermint_tpu_torch.crypto import ed25519_math as em
from tendermint_tpu_torch.crypto.keys import Ed25519PrivKey
from tendermint_tpu_torch.ops import curve, ed25519, ed25519_table, fe

torch.set_num_threads(1)

CPU = torch.device("cpu")
IDENT_PK = (1).to_bytes(32, "little")
QUADS = 2


def _canon(x):
    return curve.canonical(x).T.numpy()  # [N, 20]


def test_base_windows_madd_is_base_windows_in_madd_form():
    """Entry for entry, (y−x, y+x, 2d·x·y) of base_windows() as canonical
    limbs, computed here on the plain field layer."""
    ext = torch.as_tensor(ed25519_table.base_windows()).permute(1, 2, 0)  # [4, 20, 1024]
    x, y, z, t = ext
    assert (z[0] == 1).all() and (z[1:] == 0).all()  # affine: Z = 1, T = x·y
    two_d = fe.const(ed25519.TWO_D, CPU)
    madd = ed25519_table.base_windows_madd()
    assert madd.shape == (64 * 16, 3, 20) and madd.dtype == np.int32
    np.testing.assert_array_equal(madd[:, 0], _canon(fe.sub(y, x)))
    np.testing.assert_array_equal(madd[:, 1], _canon(fe.add(y, x)))
    np.testing.assert_array_equal(madd[:, 2], _canon(fe.mul(fe.mul(x, y), two_d)))


def test_base_windows_madd_entry_zero_and_window_zero():
    """Entry d = 0 of every window is the identity's (1, 1, 0); window 0
    (d·B) is the ladder's BASE_TABLE, in this package and in the JAX one."""
    madd = ed25519_table.base_windows_madd().reshape(64, 16, 3, 20)
    one = fe.from_int(1)[:, 0]
    np.testing.assert_array_equal(madd[:, 0, 0], np.broadcast_to(one, (64, 20)))
    np.testing.assert_array_equal(madd[:, 0, 1], np.broadcast_to(one, (64, 20)))
    assert not madd[:, 0, 2].any()
    np.testing.assert_array_equal(madd[0], ed25519.BASE_TABLE)
    np.testing.assert_array_equal(madd[0], jed.BASE_TABLE)


def _to_cached(p, two_d):
    x, y, z, t = p
    return fe.sub(y, x), fe.add(y, x), fe.mul(t, two_d), z


def _add_cached(p, q):
    """add-2008-hwcd-3 with q cached (ge_quad.cuh quad_add)."""
    x1, y1, z1, t1 = p
    ymx2, ypx2, t2d2, z2 = q
    a = fe.mul(fe.sub(y1, x1), ymx2)
    b = fe.mul(fe.add(y1, x1), ypx2)
    c = fe.mul(t1, t2d2)
    zz = fe.mul(z1, z2)
    d = fe.add(zz, zz)
    e, f, g, h = fe.sub(b, a), fe.sub(d, c), fe.add(d, c), fe.add(b, a)
    return (fe.mul(e, f), fe.mul(g, h), fe.mul(f, g), fe.mul(e, h))


def kernel_order(tables, idx, h_le, s_le, r_y, r_sign):
    """Kernel 3's sum in plain torch: QUADS halves of 64 / QUADS windows,
    each window the table row h_w from the cached form then the base window
    s_w by mixed add, one cached add joining the halves, then the finish.
    Returns (ok [B], R' [B, 32])."""
    b = idx.shape[0]
    w = torch.arange(64)
    hd = ed25519.expand_digits(h_le).flip(1).long()  # LSB first, as the tables
    sd = ed25519.expand_digits(s_le).flip(1).long()
    rows = tables[((idx.long()[:, None] * 64 + w) * 16 + hd).reshape(-1)]
    rows = rows.to(torch.int32).reshape(b, 64, 4, 20).permute(1, 2, 3, 0)  # [64, 4, 20, B]
    madd = fe.const(ed25519_table.base_windows_madd(), CPU)
    base = madd[(w * 16 + sd).reshape(-1)].reshape(b, 64, 3, 20).permute(1, 2, 3, 0)
    two_d = fe.const(ed25519.TWO_D, CPU)
    span = 64 // QUADS
    sums = []
    for q in range(QUADS):
        acc = ed25519.identity(b, CPU)
        for k in range(q * span, (q + 1) * span):
            acc = _add_cached(acc, _to_cached(tuple(rows[k]), two_d))
            acc = curve.point_madd(acc, tuple(base[k]))
        sums.append(acc)
    acc = sums[0]
    for other in sums[1:]:
        acc = _add_cached(acc, _to_cached(other, two_d))
    return ed25519.finish(acc, r_y, r_sign, want_r=True)


def tabulated_mix(n):
    """n rows cycling through the input classes kernel 3 sees, ordered so
    that a short batch already mixes them: valid, padding, identity key
    with R = identity and s = 0 (cofactorless accept), the same with R
    encoded non-canonically, flipped s bit, wrong key, flipped R bit,
    invalid pubkey (identity placeholder row), wrong message, random
    scalars on a real key.  Returns the table rows, the kernel inputs, the
    host-prep `valid` mask, the oracle's verdicts, each row's class and
    each signature's R bytes."""
    rng = np.random.default_rng(n)
    keys = [Ed25519PrivKey.from_secret(f"tab-{i}".encode()) for i in range(4)]
    pubkeys = [k.pub_key().bytes() for k in keys] + [IDENT_PK, b"\xff" * 32]
    ident, bad = len(keys), len(keys) + 1
    triples, idx, kinds = [], [], []
    for i in range(n):
        kind = i % 10
        k = i % len(keys)
        msg = f"precommit-{i}".encode()
        sig = keys[k].sign(msg)
        pk = k
        if kind == 2:
            pk, sig = ident, IDENT_PK + bytes(32)
        elif kind == 3:
            pk, sig = ident, (em.P + 1).to_bytes(32, "little") + bytes(32)
        elif kind == 4:
            b = bytearray(sig)
            b[32 + int(rng.integers(0, 31))] ^= 1 << int(rng.integers(0, 8))
            sig = bytes(b)
        elif kind == 5:
            pk = (k + 1) % len(keys)
        elif kind == 6:
            b = bytearray(sig)
            b[int(rng.integers(0, 32))] ^= 1 << int(rng.integers(0, 8))
            sig = bytes(b)
        elif kind == 7:
            pk = bad
        elif kind == 8:
            msg += b"!"
        triples.append((pubkeys[pk], msg, sig))
        idx.append(pk)
        kinds.append(kind)
    _, h_dig, s_dig, r_y, r_sign, valid = bvm.prepare_batch(*zip(*triples))
    h_le, s_le = bvm._pack_digits(h_dig), bvm._pack_digits(s_dig)
    oracle = np.array([em.verify(*t) for t in triples])
    idx = np.array(idx, dtype=np.int32)
    for i, kind in enumerate(kinds):
        if kind == 1:  # padding row
            idx[i], h_le[i], s_le[i], r_y[i], r_sign[i] = 0, 0, 0, 0, 0
        elif kind == 9:  # compares R' off the signature path
            h_le[i] = rng.integers(0, 256, 32, dtype=np.uint8)
            s_le[i] = rng.integers(0, 256, 32, dtype=np.uint8)
    rows = np.stack([bvm._neg_a_limbs(pk) if bvm._neg_a_limbs(pk) is not None
                     else bvm.IDENTITY_ROW for pk in pubkeys])
    r_sig = np.stack([np.frombuffer(t[2][:32], dtype=np.uint8) for t in triples])
    return rows, (idx, h_le, s_le, r_y, r_sign), valid, oracle, np.array(kinds), r_sig


@pytest.fixture(scope="module")
def mix_tables():
    rows, *_ = tabulated_mix(1)  # every mix tables the same six rows
    return ed25519_table.build_window_tables_plain(torch.as_tensor(rows))


@pytest.mark.parametrize("batch", [1, 7, 23])
def test_kernel_order_matches_plain_jax_and_oracle(batch, mix_tables):
    rows, inputs, valid, oracle, kinds, r_sig = tabulated_mix(batch)
    args = [torch.as_tensor(a) for a in inputs]
    ok, r = kernel_order(mix_tables, *args)
    idx, h_le, s_le, r_y, r_sign = args
    ok_p, r_p = ed25519_table.verify_tabulated_plain(
        mix_tables, idx, ed25519.expand_digits(h_le), ed25519.expand_digits(s_le),
        r_y, r_sign, want_r=True)
    assert torch.equal(ok, ok_p) and torch.equal(r, r_p)
    # the JAX ladder on the same rows and scalars, padded to one compiled shape
    pad = 32 - batch
    neg_a, h_dig, s_dig, ry, rs = (
        np.concatenate([a, np.zeros((pad,) + a.shape[1:], a.dtype)])
        for a in (rows[inputs[0]], bvm._msb_digits(inputs[1]), bvm._msb_digits(inputs[2]),
                  inputs[3], inputs[4]))
    want = np.asarray(jed.verify_prepared_jit(neg_a, h_dig, s_dig, ry, rs))[:batch]
    np.testing.assert_array_equal(ok.numpy(), want)
    verdicts = np.logical_and(ok.numpy(), valid)
    real = (kinds != 1) & (kinds != 9)
    np.testing.assert_array_equal(verdicts[real], oracle[real])
    assert verdicts[0] and not verdicts[kinds == 1].any()
    # an accepted R' is the signature's R; a non-canonical R (y = p + 1)
    # computes the identity's encoding and fails
    np.testing.assert_array_equal(r.numpy()[verdicts], r_sig[verdicts])
    non_canonical = kinds == 3
    assert not ok.numpy()[non_canonical].any()
    assert all(r[i].numpy().tobytes() == IDENT_PK for i in np.flatnonzero(non_canonical))

"""BLS12-381 min-pk signatures: pubkeys in G1 (48B), signatures in G2 (96B).

The port's copy of the reference package's BLS subsystem.  BLS12-381
validator keys load, sign, verify and prove possession here; a mixed
ed25519 + BLS set commits one signature per vote, its BLS members
verified on the host and its ed25519 members on the card.  A uniformly
BLS set's +2/3 commit folds into ONE 96-byte aggregate signature + signer
bitmap (types/agg_commit.py; "Performance of EdDSA and BLS Signatures in
Committee-Based Consensus", arXiv:2302.00418), checked here by
`fast_aggregate_verify` or, for a run of commits, one blinded pairing
product (`batch_verify_aggregates`), with a memo between the async
pre-verify lanes and the synchronous checks.

Two host tiers, as in the reference package:

* C fast tier (`ctier` loading csrc/bls12_381.c): Montgomery-limb field
  tower, multi-pairing Miller loop with one shared final exponentiation,
  subgroup-checked decompress and the aggregate/apk fold scalar work —
  compiled on demand (hostprep discipline) into `_build/`, GIL-dropping,
  far faster than the pure tier per aggregate check.  The default
  whenever a toolchain exists; `scheme.active_tier()` /
  `tendermint_verify_bls_tier` report it.
* reference tier (`fields`/`curve`/`pairing`/`hash_to_curve`/`scheme`):
  pure-Python field towers and pairings — the differential oracle the C
  tier is verdict- and bit-pinned against, and the dependency-less
  no-toolchain path.

A third tier, `cuda_tier`, folds the pure lanes' multi-point sums (Σpk,
Σsig, from 8 points on) on the card: the CUDA kernels of
csrc/bls12_381_fold.cu, a binary tree of complete G1 or G2 additions whose
Jacobian result equals the reference package's jax_tier limb for limb.
`scheme.set_jax_aggregation(True, device=...)` turns it on (a node does so
at start with `[tpu] bls_jax_aggregation`); the C tier's lanes sum on the
host and never reach it.  Where the fold's build, launch or card fails it
raises; the reference's tier returns None and folds on the host.

Key classes (`BlsPubKey`/`BlsPrivKey`) live in `crypto/bls/keys.py` and
slot into the polymorphic `crypto.PubKey` verify routing, so ed25519 and
sr25519 validator sets are untouched.
"""

from .keys import (  # noqa: F401
    BlsPrivKey,
    BlsPubKey,
    PUBKEY_SIZE,
    SIGNATURE_SIZE,
)
from . import scheme  # noqa: F401

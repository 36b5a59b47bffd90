"""Statesync's engine lane for the light client: the port's copy of
EngineCommitPreverify from tendermint_tpu/statesync/syncer.py (its ed25519
branch; aggregate commits and the snapshot syncer are not part of the port
yet).

Statesync fetches the light blocks at a snapshot height through the lite2
client, with every commit verification pre-batched through the node's
shared AsyncBatchVerifier: one engine flush per commit, the same ingress
consensus votes ride.
"""

from __future__ import annotations

import asyncio
from typing import Dict, List, Tuple

from ..crypto import batch as crypto_batch
from ..crypto.keys import Ed25519PubKey
from ..types.block import SignedHeader
from ..types.validator import ValidatorSet


class EngineCommitPreverify:
    """lite2 `commit_preverify` hook: pre-verify a whole commit's ed25519
    signatures through the shared AsyncBatchVerifier as ONE arrival (=>
    one flush, one host-prep pass), then serve the synchronous
    verify_commit path from the result cache.  Cache misses fall back to
    the installed process-wide batch hook — still the device path, just
    not coalesced."""

    def __init__(self, async_verifier):
        self.async_verifier = async_verifier
        self._cache: Dict[Tuple[bytes, bytes, bytes], bool] = {}

    async def __call__(self, sh: SignedHeader, vals_sets: List[ValidatorSet]):
        vals = vals_sets[0]  # index-aligned set; other sets share pubkeys by address
        if vals.size() != len(sh.commit.signatures):
            return None  # malformed; let verify_commit raise its own error
        items = []
        for idx, cs in enumerate(sh.commit.signatures):
            if cs.is_absent():
                continue
            pk = vals.validators[idx].pub_key
            if not isinstance(pk, Ed25519PubKey):
                continue  # non-ed25519 rides mixed_batch_verify's own path
            key = (pk.bytes(), sh.commit.vote_sign_bytes(sh.header.chain_id, idx), cs.signature)
            if key not in self._cache:
                items.append(key)
        if items:
            futs = self.async_verifier.verify_many(items)
            results = await asyncio.gather(*futs)
            self._cache.update(zip(items, (bool(r) for r in results)))
        return self._lookup

    def _lookup(self, pubkeys: List[bytes], msgs: List[bytes], sigs: List[bytes]) -> List[bool]:
        out: List[bool] = []
        miss: List[int] = []
        for i, key in enumerate(zip(pubkeys, msgs, sigs)):
            hit = self._cache.get(key)
            if hit is None:
                out.append(False)
                miss.append(i)
            else:
                out.append(hit)
        if miss:
            res = crypto_batch.get_verifier()(
                [pubkeys[i] for i in miss], [msgs[i] for i in miss], [sigs[i] for i in miss]
            )
            for i, r in zip(miss, res):
                out[i] = bool(r)
        return out

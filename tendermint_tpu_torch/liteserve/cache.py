"""Shared verification cache: N light clients cost ONE commit verification.
The port's copy of tendermint_tpu/liteserve/cache.py.

The cache sits at the `commit_preverify` hook point every lite2 Client
already exposes (the same seam statesync's EngineCommitPreverify uses), so
the bisection control flow stays per-tenant and cheap (hash comparisons,
power tallies in Python) while the expensive part — the whole-commit
signature batch (ed25519) or the aggregate pairing (BLS) — is keyed by
``(chain_id, height, header_hash)`` and paid at most once per header,
process-wide.

Two disciplines compose:

  - **LRU verdict cache**: per key, the per-signature verdict map (or the
    aggregate-pairing verdict) of the first verification.  Later tenants' synchronous ``verify_commit`` /
    ``verify_commit_trusting`` calls are served as table lookups.  A
    commit-digest guard protects against a different commit for the same
    header hash (stray-vote variance): a digest mismatch falls through to a
    real verification, never a stale verdict.
  - **Single-flight coalescing**: concurrent verifications of the same key
    join one in-flight future — a thousand tenants asking about a fresh
    height cost one engine batch, not a thousand.

Counters: hits / misses / coalesced / evictions (`stats()`).
"""

from __future__ import annotations

import asyncio
from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from ..crypto import batch as crypto_batch
from ..crypto.keys import Ed25519PubKey
from ..crypto.tmhash import sum_sha256
from ..encoding import codec
from ..libs.log import get_logger
from ..types.agg_commit import AggregateCommit
from ..types.block import SignedHeader
from ..types.vote import is_bls_key

Key = Tuple[str, int, bytes]  # (chain_id, height, header_hash)


@dataclass
class _Entry:
    commit_digest: bytes
    # ed25519 commits: (pubkey_bytes, msg, sig) -> verdict
    sig_ok: Optional[Dict[Tuple[bytes, bytes, bytes], bool]] = None
    # BLS aggregate commits: ((pk, ...), msg, agg_sig, verdict)
    agg: Optional[Tuple[tuple, bytes, bytes, bool]] = None
    extra: Dict[Tuple[bytes, bytes, bytes], bool] = field(default_factory=dict)


def _commit_digest(commit) -> bytes:
    return sum_sha256(codec.dumps(commit))


class VerifyCache:
    """LRU + single-flight commit-verification cache (see module doc)."""

    def __init__(self, capacity: int = 4096, async_verifier=None, recorder=None):
        if capacity < 1:
            raise ValueError("VerifyCache capacity must be >= 1")
        self.capacity = capacity
        # optional node engine lane: when liteserve is embedded in a full
        # node, misses coalesce through the shared AsyncBatchVerifier (one
        # flush rides with ingress consensus votes); standalone gateways
        # verify through the installed process-wide batch verifier
        self.async_verifier = async_verifier
        self.recorder = recorder
        self.log = get_logger("liteserve.cache")
        self._lru: "OrderedDict[Key, _Entry]" = OrderedDict()
        self._inflight: Dict[Key, asyncio.Future] = {}
        self.hits = 0
        self.misses = 0
        self.coalesced = 0
        self.evictions = 0

    # -- stats -------------------------------------------------------------

    def stats(self) -> dict:
        total = self.hits + self.misses
        return {
            "size": len(self._lru),
            "capacity": self.capacity,
            "hits": self.hits,
            "misses": self.misses,
            "coalesced": self.coalesced,
            "evictions": self.evictions,
            "hit_ratio": round(self.hits / total, 4) if total else 0.0,
            "coalesce_ratio": round(self.coalesced / total, 4) if total else 0.0,
        }

    # -- lite2 hook --------------------------------------------------------

    def preverify(self):
        """The ``commit_preverify`` callable to hand a lite2 Client."""
        return self._preverify

    async def _preverify(self, sh: SignedHeader, vals_sets):
        key: Key = (sh.header.chain_id, sh.height, sh.header.hash())
        digest = _commit_digest(sh.commit)
        entry = self._lru.get(key)
        if entry is not None and entry.commit_digest == digest:
            self.hits += 1
            self._lru.move_to_end(key)
            return self._serve(entry)
        fut = self._inflight.get(key)
        if fut is not None:
            # join the in-flight verification instead of paying our own
            self.coalesced += 1
            await asyncio.shield(fut)
            entry = self._lru.get(key)
            if entry is not None and entry.commit_digest == digest:
                # counted as coalesced, not a hit — hit_ratio measures
                # verifications avoided by the LRU alone
                return self._serve(entry)
            # different commit content for the same header: verify for real
        self.misses += 1
        loop = asyncio.get_event_loop()
        fut = loop.create_future()
        self._inflight[key] = fut
        try:
            entry = await self._verify(sh, vals_sets, digest)
            if entry is not None:
                self._put(key, entry)
        finally:
            self._inflight.pop(key, None)
            if not fut.done():
                fut.set_result(True)
        if self.recorder is not None:
            self.recorder.record(
                "liteserve.verify", height=sh.height,
                header_hash=sh.header.hash().hex()[:16],
                agg=entry.agg is not None if entry else False,
            )
        if entry is None:
            return None  # malformed shape; the sync path raises its own error
        return self._serve(entry)

    # -- internals ---------------------------------------------------------

    def _put(self, key: Key, entry: _Entry) -> None:
        self._lru[key] = entry
        self._lru.move_to_end(key)
        while len(self._lru) > self.capacity:
            self._lru.popitem(last=False)
            self.evictions += 1

    async def _verify(self, sh: SignedHeader, vals_sets, digest: bytes) -> Optional[_Entry]:
        vals = vals_sets[0]  # index-aligned set; other sets share pubkeys by address
        if isinstance(sh.commit, AggregateCommit):
            return await self._verify_agg(sh, vals, digest)
        if vals.size() != len(sh.commit.signatures):
            return None
        items: List[Tuple[bytes, bytes, bytes]] = []
        for idx, cs in enumerate(sh.commit.signatures):
            if cs.is_absent():
                continue
            pk = vals.validators[idx].pub_key
            if not isinstance(pk, Ed25519PubKey):
                continue  # other key types verify via their own PubKey path
            items.append(
                (pk.bytes(), sh.commit.vote_sign_bytes(sh.header.chain_id, idx), cs.signature)
            )
        if self.async_verifier is not None and items:
            futs = self.async_verifier.verify_many(items)
            results = await asyncio.gather(*futs)
        elif items:
            verify = crypto_batch.get_verifier()
            results = await asyncio.get_event_loop().run_in_executor(
                None,
                verify,
                [i[0] for i in items], [i[1] for i in items], [i[2] for i in items],
            )
        else:
            results = []
        return _Entry(
            commit_digest=digest,
            sig_ok=dict(zip(items, (bool(r) for r in results))),
        )

    async def _verify_agg(self, sh: SignedHeader, vals, digest: bytes) -> Optional[_Entry]:
        """ONE pairing for the whole commit; the scheme memo it warms
        serves every synchronous verify_commit(_trusting) that follows."""
        from ..crypto.bls import scheme

        commit = sh.commit
        if vals.size() != commit.signers.bits:
            return None
        pks = []
        for i in commit.signers.true_indices():
            pk = vals.validators[i].pub_key
            if not is_bls_key(pk):
                return None
            pks.append(pk.bytes())
        msg = commit.sign_message(sh.header.chain_id)
        ok = scheme.memo_get(pks, msg, commit.agg_sig)
        if ok is None:
            # a pairing is slow on the pure tier: off the event loop
            ok = await asyncio.get_running_loop().run_in_executor(
                None, scheme.fast_aggregate_verify, pks, msg, commit.agg_sig
            )
            scheme.memo_put(pks, msg, commit.agg_sig, ok)
        return _Entry(commit_digest=digest, agg=(tuple(pks), msg, commit.agg_sig, bool(ok)))

    def _serve(self, entry: _Entry):
        if entry.agg is not None:
            # warm the scheme memo again (it may have evicted the claim) so
            # the synchronous aggregate branch is a memo hit, then let the
            # sync path route itself
            from ..crypto.bls import scheme

            pks, msg, sig, ok = entry.agg
            if scheme.memo_get(list(pks), msg, sig) is None:
                scheme.memo_put(list(pks), msg, sig, ok)
            return None

        def lookup(pubkeys: List[bytes], msgs: List[bytes], sigs: List[bytes]) -> List[bool]:
            out: List[bool] = []
            miss: List[int] = []
            for i, key in enumerate(zip(pubkeys, msgs, sigs)):
                hit = entry.sig_ok.get(key)
                if hit is None:
                    hit = entry.extra.get(key)
                if hit is None:
                    out.append(False)
                    miss.append(i)
                else:
                    out.append(hit)
            if miss:
                res = crypto_batch.get_verifier()(
                    [pubkeys[i] for i in miss],
                    [msgs[i] for i in miss],
                    [sigs[i] for i in miss],
                )
                for i, r in zip(miss, res):
                    out[i] = bool(r)
                    entry.extra[(pubkeys[i], msgs[i], sigs[i])] = bool(r)
            return out

        return lookup

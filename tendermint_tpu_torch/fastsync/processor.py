"""Processor: pure verify-and-apply queue, and the cross-height commit
batch (the port's copy of tendermint_tpu/fastsync/processor.py).

Reference parity: blockchain/v2/processor.go:173 (pure state machine:
holds downloaded blocks, yields contiguous (first, second) pairs for
verification, tracks the verification rule "block N is proven by the
LastCommit inside block N+1" from blockchain/v0/reactor.go:216).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

from ..types.agg_commit import AggregateCommit
from ..types.block import Block, BlockID, Commit


class Processor:
    def __init__(self, height: int):
        self.height = height  # next height to apply
        self.blocks: Dict[int, Tuple[Block, str]] = {}  # height -> (block, peer)

    def add_block(self, height: int, block: Block, peer_id: str) -> None:
        self.blocks.setdefault(height, (block, peer_id))

    def peek_two(self) -> Optional[Tuple[Block, Block]]:
        """The v0 trySync pair: block H and block H+1 (whose LastCommit
        proves H)."""
        first = self.blocks.get(self.height)
        second = self.blocks.get(self.height + 1)
        if first is None or second is None:
            return None
        return first[0], second[0]

    def pop_processed(self) -> None:
        self.blocks.pop(self.height, None)
        self.height += 1

    def drop_invalid(self) -> Tuple[int, ...]:
        """Both blocks of the failing pair are suspect (v0 pool
        RedoRequest): drops them and returns the dropped heights.  Peer
        attribution/punishment is the scheduler's job (it tracks who
        delivered each height in `received`)."""
        dropped = []
        for h in (self.height, self.height + 1):
            if self.blocks.pop(h, None) is not None:
                dropped.append(h)
        return tuple(dropped)

    def drop_heights(self, heights) -> None:
        """Forget blocks whose delivering peer was removed so the scheduler's
        re-request actually replaces them (otherwise add_block's setdefault
        would keep the stale copy)."""
        for h in heights:
            self.blocks.pop(h, None)

    def pending_range(self) -> int:
        return len(self.blocks)


def verify_commit_run(
    val_set, chain_id: str, pairs: Sequence[Tuple[BlockID, int, Commit]]
) -> List[bool]:
    """Batch-verify the commits of a RUN of heights that share one validator
    set in a single device call — the cross-height batching that makes the
    10k-validator replay config (BASELINE config #5) saturate the card.

    pairs: (block_id, height, commit) per height.  Returns per-height ok.
    The per-vote commits' ed25519 signatures go to the card as one flat
    batch; the run's aggregate (BLS) commits fold into ONE blinded pairing
    product on the host."""
    from ..crypto.bls import scheme as bls_scheme
    from ..types.validator import mixed_batch_verify

    idxs: List[Tuple[int, int]] = []  # (pair_idx, sig_idx)
    pubkeys, msgs, sigs = [], [], []
    structural_ok = []
    agg_items: List[Tuple[int, tuple]] = []  # (pair_idx, claim): one batch
    agg_power: dict = {}
    for pi, (block_id, height, commit) in enumerate(pairs):
        try:
            if val_set.size() != commit.size():
                raise ValueError("commit size mismatch")
            commit.validate_basic()
            if height != commit.height or block_id != commit.block_id:
                raise ValueError("wrong height/block id")
        except ValueError:
            structural_ok.append(False)
            continue
        structural_ok.append(True)
        if isinstance(commit, AggregateCommit):
            # the run's aggregate commits become ONE blinded pairing
            # product below (k commits, one final exponentiation)
            signer_idxs = commit.signers.true_indices()
            try:
                pks = [val_set.validators[i].pub_key.bytes() for i in signer_idxs]
            except IndexError:
                structural_ok[pi] = False
                continue
            agg_items.append((pi, (pks, commit.sign_message(chain_id), commit.agg_sig)))
            agg_power[pi] = sum(val_set.validators[i].voting_power for i in signer_idxs)
            continue
        for i, cs in enumerate(commit.signatures):
            if cs.is_absent():
                continue
            idxs.append((pi, i))
            pk = val_set.validators[i].pub_key
            pubkeys.append(pk)
            msgs.append(commit.vote_sign_bytes(chain_id, i, pub_key=pk))
            sigs.append(cs.signature)

    ok = mixed_batch_verify(pubkeys, msgs, sigs)

    tallied = [0] * len(pairs)
    sig_ok = [True] * len(pairs)
    needed = val_set.total_voting_power() * 2 // 3
    for (pi, i), good in zip(idxs, ok):
        if not good:
            sig_ok[pi] = False
            continue
        cs = pairs[pi][2].signatures[i]
        if pairs[pi][0] == cs.block_id(pairs[pi][2].block_id):
            tallied[pi] += val_set.validators[i].voting_power
    if agg_items:
        agg_ok = bls_scheme.batch_verify_aggregates([c for _, c in agg_items])
        for (pi, _), good in zip(agg_items, agg_ok):
            if not good:
                sig_ok[pi] = False
            else:
                tallied[pi] = agg_power[pi]
    return [
        structural_ok[pi] and sig_ok[pi] and tallied[pi] > needed for pi in range(len(pairs))
    ]

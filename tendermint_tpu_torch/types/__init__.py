"""Domain types: canonical vote and proposal sign-bytes, BlockID /
CommitSig / Commit and the aggregate (BLS) commit, Header / Block /
SignedHeader, part sets, txs, evidence, consensus params, genesis, Vote,
VoteSet, Proposal, Validator and ValidatorSet, the PrivValidator signers,
and the EventBus."""

# every module that registers a codec tag, so that codec.loads knows them
from . import agg_commit, block, evidence, part_set, proposal, validator, vote  # noqa: F401,E402
from .agg_commit import (  # noqa: F401,E402
    AggregateCommit,
    AggregateLastCommit,
    commit_from_dict,
    fold_commit,
    set_is_uniform_bls,
)

"""Domain types: canonical vote and proposal sign-bytes, BlockID /
CommitSig / Commit, Header / Block / SignedHeader, part sets, txs,
evidence, consensus params, genesis, Vote, VoteSet, Proposal, Validator and
ValidatorSet, the PrivValidator signers, and the EventBus."""

# every module that registers a codec tag, so that codec.loads knows them
from . import block, evidence, part_set, proposal, validator, vote  # noqa: F401,E402

"""Domain types: canonical vote sign-bytes, BlockID / CommitSig / Commit,
Header / Block / SignedHeader, part sets, txs, evidence, consensus params,
genesis, Vote, VoteSet, Validator and ValidatorSet, and the EventBus."""

# every module that registers a codec tag, so that codec.loads knows them
from . import block, evidence, part_set, validator, vote  # noqa: F401,E402

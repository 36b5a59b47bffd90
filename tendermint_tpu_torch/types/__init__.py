"""Domain types needed for batched commit verification and the light
client: canonical vote sign-bytes, BlockID / CommitSig / Commit, Header /
SignedHeader, Vote, VoteSet, Validator and ValidatorSet."""

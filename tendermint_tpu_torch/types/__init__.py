"""Domain types needed for batched commit verification: canonical vote
sign-bytes, BlockID / CommitSig / Commit, Vote, Validator and
ValidatorSet."""

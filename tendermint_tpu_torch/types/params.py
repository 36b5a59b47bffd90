"""Consensus constants the commit-verification slice needs (a subset of
tendermint_tpu/types/params.py)."""

MAX_SIGNATURE_SIZE = 96  # fits ed25519(64) and future aggregated sigs
MAX_VOTES_COUNT = 10000  # types/vote_set.go:18

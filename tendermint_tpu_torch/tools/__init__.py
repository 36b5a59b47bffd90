"""Operator tools (the port's copy of tendermint_tpu/tools: the remote
signer harness and the tx-ingress load generator)."""

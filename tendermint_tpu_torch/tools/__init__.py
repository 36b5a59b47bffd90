"""Operator tools (the port's copy of tendermint_tpu/tools: the remote
signer harness, the tx-ingress load generator and the fleet telescope)."""

"""Version constants the port's State carries: a copy of
tendermint_tpu/version.py (reference: version/version.go:24-30)."""

SOFTWARE_VERSION = "0.1.0"
VERSION = SOFTWARE_VERSION
BLOCK_PROTOCOL = 10  # block format version
P2P_PROTOCOL = 7  # p2p wire version
ABCI_VERSION = "0.16.2"  # ABCI semantic surface mirrored

"""Validator signing: the file-backed PV with persisted double-sign
protection (the port's copy of tendermint_tpu/privval/file.py).  The
remote-signer socket pair (privval/signer.py) waits for p2p (ROADMAP 1.7),
and load_or_gen_file_pv for the node's Config (ROADMAP 1.6)."""

from .file import DoubleSignError, FilePV, FilePVKey, FilePVLastSignState  # noqa: F401

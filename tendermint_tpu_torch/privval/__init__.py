"""Validator signing: the file-backed PV with persisted double-sign
protection and its Config hook load_or_gen_file_pv (the port's copy of
tendermint_tpu/privval/file.py).  The remote-signer socket pair
(privval/signer.py) waits for p2p (ROADMAP 1.7)."""

from .file import (  # noqa: F401
    DoubleSignError,
    FilePV,
    FilePVKey,
    FilePVLastSignState,
    load_or_gen_file_pv,
)

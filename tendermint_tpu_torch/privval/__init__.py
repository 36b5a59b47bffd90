"""Validator signing: the file-backed PV with persisted double-sign
protection and its Config hook load_or_gen_file_pv (the port's copy of
tendermint_tpu/privval/file.py), and the remote-signer socket pair
(privval/signer.py)."""

from .file import (  # noqa: F401
    DoubleSignError,
    FilePV,
    FilePVKey,
    FilePVLastSignState,
    load_or_gen_file_pv,
)
from .signer import RemoteSignerError, SignerClient, SignerServer  # noqa: F401

"""Builtin stateful applications beyond the kvstore demo (the port's copy
of tendermint_tpu/apps).

- bank.py: contended-state account/transfer app (balances, nonces,
  priority fees with real debits, app-level rejections) — the workload
  generator's "real app" target under the QoS mempool.
- staking.py: bank-backed staking app driving live validator-set changes
  (bond/unbond/edit-power/rotate-key txs → end_block.validator_updates,
  optional epoch power rotation).
"""

from .bank import BankApplication, make_transfer_tx
from .staking import (
    StakingApplication,
    make_bond_tx,
    make_unbond_tx,
    make_edit_power_tx,
    make_rotate_key_tx,
)

__all__ = [
    "BankApplication",
    "StakingApplication",
    "make_transfer_tx",
    "make_bond_tx",
    "make_unbond_tx",
    "make_edit_power_tx",
    "make_rotate_key_tx",
]

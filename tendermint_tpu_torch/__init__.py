"""tendermint_tpu_torch: the PyTorch/CUDA port of tendermint_tpu.

This slice carries batched ed25519 commit verification: ValidatorSet
.verify_commit through the crypto.batch hooks into a device-resident
pubkey table and the hand-written Hopper kernels in csrc/.  It imports
nothing of the JAX package; the host modules it needs are its own copies.
Entry points run on the card (device=None means "cuda") and raise when no
card is present unless the caller passes device="cpu".
"""

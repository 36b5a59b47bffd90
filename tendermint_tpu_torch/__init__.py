"""tendermint_tpu_torch: the PyTorch/CUDA port of tendermint_tpu.

It carries batched ed25519 commit verification: ValidatorSet
.verify_commit through the crypto.batch hooks into a device-resident
pubkey table and the hand-written Hopper kernels in csrc/; vote ingress
(AsyncBatchVerifier, VoteSet); the light client (lite2) with statesync's
engine lane and liteserve's shared VerifyCache; and the chain on disk
(codec, kv stores, Block and part sets, State and StateStore, BlockStore)
with fast sync's pure Processor and Scheduler; and blocks applied to an
ABCI app (abci's local client and example apps, proxy's AppConns, the
event bus and tx index, the mempool with its signed-tx lane on the
AsyncBatchVerifier, the evidence pool, validate_block and BlockExecutor,
and the Handshaker); the consensus core (ConsensusState with its WAL and
the FilePV); and the node (the whole Config and its TOML, Node without
p2p, the loop profiler, the health watchdog and the CLI, `python -m
tendermint_tpu_torch`).  It imports
nothing of the JAX package; the host modules it needs are its own copies.
Entry points run on the card (device=None means "cuda") and raise when no
card is present unless the caller passes device="cpu".
"""

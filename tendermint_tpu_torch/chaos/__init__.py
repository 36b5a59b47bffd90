"""Chaos pieces the consensus core reads: the pluggable time source
(clock.py), the port's copy of tendermint_tpu/chaos/clock.py.  The rest of
the JAX package's chaos engine (link policies, twin signers, scenarios,
the checker, disk faults) is not ported."""

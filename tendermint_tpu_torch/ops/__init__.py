"""Device compute for the port: the plain torch field and curve layers, the
plain ed25519 ladder and tabulated verify, the plain BLS12-381 point fold,
and the wrappers of the hand-written CUDA kernels in ../csrc (built by
_build.py at first use)."""

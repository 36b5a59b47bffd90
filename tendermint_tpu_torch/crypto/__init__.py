"""Crypto layer of the port: ed25519 keys, tmhash, the pure-Python curve
oracle, host batch prep (C via ctypes), the batch-verify hooks and the
GPU batch verifier."""

#!/usr/bin/env python3
"""Smoke run of tendermint_tpu_torch on one CUDA card.

    python3 chip_smoke.py

1. Setup: prints the card (nvidia-smi name and power limit), builds the
   CUDA kernels from the checkout's sources and the host-prep C library.
2. Each kernel against its plain torch version on the card, on the same
   inputs, tolerance 0 (integer math), at ragged shapes (no multiple of 8
   or 32): kernel 1 (ladder) at B = 1021 and kernel 3 (tabulated verify)
   at B = 1, 7 and 1021 on a mix of valid signatures and every corruption
   class, comparing verdicts and the R' encodings; kernel 2 (window tables) for 67
   validators, bit for bit.  Verdicts of real signatures are also held
   against the pure-Python ed25519 oracle.  Then the four-lane point
   helpers (csrc/ge_quad.cuh) against the one-lane helpers (csrc/fe51.cuh)
   on real points: doubling and mixed add equal bit for bit, the add (which
   takes 2d*T cached) equal as canonical values.
3. The main path at full size: a 10,000-validator set signs a full commit;
   ValidatorSet.verify_commit runs through the crypto.batch hooks on the
   ladder, on the tabulated path and under the auto profile, then the
   failure cases and a flat 512-vote batch.  The installed recorder must
   hold one verify.tabulated_profile event with the JAX package's fields.
   Launch counters are zeroed just before this phase and read just after
   it.
4. Each kernel at the main path's shapes (B = V = 10,000): its output held
   against its plain version's on the same inputs, tolerance 0 (verdicts
   and R' encodings of the commit, window tables bit for bit), its time
   (CUDA events) beside the plain version's, and its bound from the shapes.
   Then the auto-profile's pick of phase 3 (also timed by CUDA events)
   against these times: wherever the two kernels differ by more than 10 %,
   the run fails unless the profile picked the faster one.
5. Vote ingress at full width, on phase 3's set and precommits (every
   100th signature corrupted), with the node's engine settings
   (BatchVerifier(min_device_batch=16) with a FlightRecorder,
   start_warmup, an installed TableCache on tabulated auto, rebuilt for
   the set): the 10,000 votes as a verify_one storm in one loop tick, as
   100 verify_direct relay frames from 4 concurrent senders, and as one
   verify_many batch through AsyncBatchVerifier; the storm's accepted
   votes into a precommit VoteSet (2/3 must turn at vote 6,667), a
   conflicting precommit (must raise with evidence), make_commit (must
   equal phase 3's commit but the corrupted slots) and its verify_commit
   through the TableCache; then TableCache.rebuild on a ladder cache and
   the 10k indexed verify with the chunked single shot on and off (equal
   verdicts).  Prints votes/s, flush sizes, queue wait, per-flush host-prep
   and device ms, dispatches by path, latency and the ladder's launches;
   fails on any wrong verdict, a batch of 16 or more votes on the host, or
   a ladder that was not launched.  Its launches add to the kernels line.
6. The light client at full width (lite2, statesync's engine lane,
   liteserve's VerifyCache): a chain of 1,005 heights whose 10,000-validator
   set (power 10) replaces its 2,500 oldest validators by new keys every
   100 heights; commits are signed on first request.  Run 1: bisection
   1 -> 1,000 through the installed BatchVerifier and TableCache (tabulated
   auto) with an honest witness; it must make the 12 expected steps, persist
   {1, 250, 437, 577, 788, 1000} and build tables for each new set.  Run 2:
   sequence 1,000 -> 1,005 on the next set, persisted to a sqlite DBStore
   that is reopened and read back.  Run 3: the same bisection with
   the node's engine settings and EngineCommitPreverify (each commit one
   verify_many arrival).  Run 4: eight tenants bisect concurrently through
   one VerifyCache(async_verifier=...): 9 misses, 95 hits or coalesced
   joins.  Run 5: a flipped signature in header 1,000 (ValueError "wrong
   signature (#i)") and a witness serving another header 1,000
   (DivergedHeaderError, store rolled back).  Prints per step the path,
   batch, host prep and device ms and the table cache's hit or miss; per new
   set the table build (host rows, kernel 2); per run wall time and headers
   per second; the cache's stats and the phase's launches, which add to the
   kernels line.  Fails on any other step, height, stat or error, or when
   kernel 2, the kernel serving the trusted commits (run 1) or the ladder
   (runs 3-4) was not launched.
7. Fast-sync replay from the stores at full width (BASELINE config #5):
   phase 3's 10,000 keys at power 10 sign a chain of 13 blocks (100 txs of
   250 bytes each, from height 2 on the previous height's commit); the
   height-5 state takes a change set that replaces the 2,500 oldest
   validators by new keys, so heights 1-6 carry set A and 7-13 set B.
   States go to a sqlite StateStore, blocks with their part sets and seen
   commits to a sqlite BlockStore.  Both are closed and reopened, then:
   (a) blocks 1-13 load into a fast-sync Processor; each peek_two pair's
   block id (hash and part set) must equal the stored meta's, and
   StateStore.load_validators verifies the pair's commit through the
   installed BatchVerifier and TableCache (tabulated auto): 12 checks, 2
   table misses and 10 hits; (b) one verify_commit_run per set over its
   six heights, 60,000 signatures in one flat ladder batch, all True;
   (c) a copy of block 5 whose last_commit has one flipped signature: the
   pair check raises the JAX package's "wrong signature (#i)" message and
   drop_invalid returns (4, 5), and the run is False at height 4 only.
   Prints the block's size and parts, the codec's encode and decode ms,
   per block the store write, load_block, hash with its part set and
   load_validators ms, per check verify_commit ms with host prep, dispatch
   and the table's hit or miss, per new set the host rows and kernel 2,
   per run ms and signatures/s, (a)'s blocks/s and the card's memory.
   Fails on any other verdict, message, height, id or hit count, or when
   the ladder, kernel 2 (twice) or the auto-profile's pick in (a) was not
   launched.  Its chain's states come from state.execution.update_state
   fed code-0 responses.
8. Blocks applied to the kvstore app at full width (BASELINE config #5):
   genesis is phase 3's 10,000 keys at power 10.  (a) A producer node on
   sqlite stores (StateStore, BlockStore, evidence, tx index) with a
   KVStoreApplication behind AppConns(local_client_creator(app)), a
   Handshaker sending InitChain, an EventBus with one NewBlock and one Tx
   subscriber and an IndexerService, a Mempool (sig_precheck on, size
   10,000, pre_check tx_pre_check) whose signed-tx lane is an
   AsyncBatchVerifier on the node's engine settings, an EvidencePool and a
   BlockExecutor.  Per height 1-9, 1,000 signed envelopes arrive as one
   asyncio.gather of check_tx (the next height's while the block commits,
   so that the commit's recheck has work); every 100th has a flipped
   signature and must raise "invalid tx signature".  Height 4 also carries
   5,000 val: txs, removing the 2,500 oldest keys and adding 2,500 new
   ones, so set B serves from height 6.  Each block comes from
   create_proposal_block, is signed by its set, saved with its part set and
   seen commit, and applied with apply_block (validate_block verifies its
   LastCommit through the installed TableCache: misses at 2 and 7, one per
   set).  (b) A syncing node on fresh stores and a fresh app runs fast
   sync's steps by hand with the Processor and Scheduler: verify_commit of
   each pair, save_block, apply_block, for heights 1-8 (9 stays pending);
   its state, app hash, events and tx index must equal the producer's.
   (c) Its stores reopened, the Handshaker runs with (c1) its own app (no
   replay), (c2) a fresh app (InitChain and 8 blocks replayed) and (c3)
   block 9 saved with its seen commit but not applied (apply_block, whose
   validate_block verifies 9's LastCommit).  Prints per height the
   check_tx burst's txs/s and p50/p99 latency, the verify.flush sizes and
   apply_block's split (validate_block with verify_commit, BeginBlock,
   DeliverTx, EndBlock, Commit, mempool update with recheck, state save,
   events, index drain); blocks/s of (a) and (b); (c)'s ms; the launches.
   Fails on any other verdict, rejection, block content, state, app hash,
   event count or index answer, or when the ladder (by the signed-tx
   flushes), kernel 2 (twice, in (a)) or the auto-profile's pick in (a),
   (b) and (c3) was not launched.

9. The consensus core at full width: one validator node of phase 8's
   genesis (phase 3's 10,000 keys at power 10) on phase 8's abci_node
   (sqlite stores, the kvstore app, EventBus, IndexerService) with a
   Mempool, an EvidencePool, a BlockExecutor and a ConsensusState at the
   JAX defaults (TimeoutTicker, timeout_commit 1 s, pipelined delivery and
   speculative assembly on), its WAL at <home>/data/cs.wal/wal and a
   FilePV holding the key of the validator that the genesis set's rotation
   makes round-0 proposer of height 3; a fresh installed TableCache serves
   validate_block.  One AsyncBatchVerifier on its own BatchVerifier
   (min_device_batch=16) is both the mempool's signed-tx lane and the
   vote-frame verifier.  Heights 1-6: a burst of 1,000 signed envelopes
   (1 in 100 corrupted) goes through check_tx before each height's
   proposal; the round's proposer (a peer) builds its block with the node's
   BlockExecutor from the node's LastCommit and hands over the signed
   Proposal and its 64 KB parts; after the node's own prevote, then its own
   precommit, the other 9,999 validators' votes (signed on SIGN_THREADS,
   stamped by _vote_time's rule) arrive as vote_batch frames of at most
   65,536 bytes of Vote.wire(), from 4 senders, each frame through
   verify_direct and then add_vote_input(verified=True); one precommit
   frame per round carries a flipped signature, must get exactly one
   False, and is re-sent clean by another sender.  Height 3 is proposed by
   the node (default_decide_proposal, signed by the FilePV).  At height 4
   the round-0 proposer withholds its proposal: the node prevotes nil on
   timeout_propose, the peers vote nil, and round 1 commits.  In height 6,
   after the proposal, the prevotes and the node's own precommit are in the
   WAL, the ConsensusState stops (on_stop drains height 5's delivery) and
   the stores close; reopened, the Handshaker replays 0 blocks, the FilePV
   loads from its files and a new ConsensusState runs
   reconstruct_last_commit_if_needed and catchup_replay; the peers'
   precommits then commit height 6, and the run stops at height 7's
   NEW_HEIGHT.  Prints per height the burst, the proposal, proposal
   complete -> own prevote, each vote kind's ingest (frames' verify_direct
   host prep and device ms p50/p99, the receive routine's Python per vote),
   vote-to-commit, validate_block with verify_commit, save_block, the
   pipelined apply_block and commit-to-commit; the restart's handshake,
   reconstruction and catchup ms; heights/s with signing and the timeouts
   apart, the dispatches' share, card memory and launches.  Fails unless
   heights 1-6 commit (4 in round 1, the others in round 0) with exactly
   their bursts' valid txs, block 3 is ours, every precommit either lands
   in the LastCommit or is refused as late (it reached the node after the
   next round began) and each block's LastCommit is what the node held
   (more than 2/3), block 6 is the proposal gossiped before the stop, the
   FilePV's re-signed votes equal what it signed before, no ERROR is
   logged by consensus, and kernel 2 launched once, the auto-profile's
   pick once per validate_block on heights >= 2 and the ladder at least
   once per accepted frame.
10. Node wiring at full width.  (a) One validator of a 10,000-validator
   chain run as a Node from its home directory: config.toml written by
   save_config at the JAX defaults but p2p.laddr "none", rpc.laddr "", the
   signed-tx precheck with its journal at data/mempool.wal and a mempool of
   10,000 (height 2 holds 6,000 txs; the default is 5,000); the genesis
   file (phase 3's keys at power 10); the FilePV files of phase 9's
   validator.  default_new_node(load_config(...)) builds everything: the
   stores, StorageHealth, the kvstore app on its durable app db, the tx
   index, the FlightRecorder, the loop profiler, one BatchVerifier on the
   card installed as the flat hook, a TableCache on it (the indexed hook)
   and the AsyncBatchVerifier on it (so in warmup mode: a set's first
   commit check declines and the flat ladder serves it while its table
   builds in the background), the handshake, the mempool with the engine as
   its signed-tx lane, the evidence pool, the BlockExecutor, the
   ConsensusState with its WAL, _valset_watch and the watchdog.  Phase 9's
   traffic goes to node.mempool and node.consensus: heights 1-5, a burst of
   1,000 envelopes each; height 2 also carries 5,000 val: txs that replace
   the 2,500 oldest validators by new keys, so set B signs from height 4
   and _valset_watch rebuilds its table before its first commit; height 3
   is ours.  In height 5, after the proposal, the prevotes and our
   precommit, the node stops and a second default_new_node on the same
   home resumes (boot scan, a handshake replaying 0 blocks, the FilePV
   from its files, catchup_replay); the peers' precommits commit height 5
   and the run stops at height 6's NEW_HEIGHT.  Prints what phase 9 prints
   per height, both starts' split (stores, boot scan, engine, handshake,
   consensus start) and the RTT probe, _valset_watch's state load and each
   table build (thread, host rows, kernel 2), the loop profiler's account
   of each height's timeout_commit window (busy ms per category, GC, lag
   p90 and max, shares), the watchdog's verdict and alarms, heights/s with
   signing, timeout_commit and the restart apart, the dispatches' share
   and the card's memory.  Fails unless the engine runs on the card with
   the node's hooks installed (and uninstalled after each stop), heights
   1-5 commit with exactly their bursts' valid txs (and height 2's val:
   txs), block 3 is ours, set B holds from height 4 with one valset.update
   event (5,000 updates, 10,000 validators), every validate_block on
   heights >= 2 makes one table lookup, the genesis set's first check
   declines and the flat path serves it, set B's first check is a table
   hit, every precommit lands or is refused as late, the restart replays 0
   blocks and reproduces block 5 and our votes, nothing is logged at ERROR
   and the watchdog raises no critical alarm (no autodump); and, on the
   card, kernel 2 launched once per table built (3: the genesis set after
   its decline, set B by _valset_watch, set B again by the restarted
   node's empty TableCache), the first node declined exactly once, the
   profile's pick served every table hit and the ladder every accepted
   frame and decline.  (b) The CLI in subprocesses: `python -m
   tendermint_tpu_torch --home H2 init --chain-id chip-smoke-solo`, p2p and
   RPC turned off through load_config/save_config, `node` until the block
   store reaches height 3, SIGTERM (exit 0 within 30 s), `node` again from
   height 3 to 5, and show_validator printing the genesis key; the "verify
   engine" log line must name a CUDA device.  A solo validator's commits
   carry one signature, below min_device_batch, so no kernel launches in
   (b).

Prints, before the last line, a JSON object {"kernels": [...]} (per kernel
also its threads and warps per SM at the 10k launch, registers, stack and
spill bytes from the ptxas log, and bound_ms / ms) and the card line; the last line is {"ok": true, "device": {...}}.  Exits non-zero,
printing no result, without a card, outside a checkout, or when any phase
fails.
"""

from __future__ import annotations

import collections
import contextlib
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))

N_VALIDATORS = 10_000
KERNEL_BATCH = 1021
TABLE_VALIDATORS = 67
SELFTEST_ITEMS = 512
FLAT_BATCH = 512
VOTE_FRAME = 100  # votes per relay frame in phase 5
RELAY_SENDERS = 4
CORRUPT_EVERY = 100  # phase 5: every 100th validator's precommit has a bad signature
CHAIN_ID = "chip-smoke"
SIGN_THREADS = min(8, os.cpu_count() or 1)  # key generation and commit signing

# Phase 6: the light client's chain (BASELINE config #5 widths)
SEC = 1_000_000_000
LITE_T0 = 1_700_000_000 * SEC
LITE_ROTATE = 2500  # validators replaced at each epoch boundary
LITE_EPOCH = 100  # heights per epoch
LITE_TOP = 1005  # the chain's last height
LITE_TARGET = 1000  # what the bisections verify
LITE_TENANTS = 8
# bisection 1 -> 1000: (trusted height, untrusted height, trusted?); the
# trust check passes when the two sets are at most two epochs apart
LITE_STEPS = [(1, 1000, False), (1, 500, False), (1, 250, True), (250, 1000, False),
              (250, 625, False), (250, 437, True), (437, 1000, False), (437, 718, False),
              (437, 577, True), (577, 1000, False), (577, 788, True), (788, 1000, True)]
LITE_HEIGHTS = [1000, 788, 577, 437, 250, 1]  # what it persists, descending
LITE_DISTINCT = 9  # distinct headers a bisection asks for: 1 and the 8 untrusted heights

# Phase 7: fast-sync replay from the stores (BASELINE config #5 widths)
REPLAY_TOP = 13  # heights 1 .. 13; block 13's own commit is stored as its seen commit
REPLAY_ROTATE_AT = 7  # the first height on set B
REPLAY_ROTATE = 2500  # set B replaces set A's oldest validators by new keys
REPLAY_TXS, REPLAY_TX_BYTES = 100, 250  # per block
REPLAY_BAD = 5  # a copy of this block carries one flipped signature in its last_commit
REPLAY_BAD_SIG = 1234  # the flipped slot (mod the set size)

# Phase 8: blocks applied to the kvstore app (BASELINE config #5 widths)
ABCI_TOP = 9  # the producer applies 1 .. 9, the syncer 1 .. 8 (9 stays pending, as at the tip)
ABCI_TXS = 1000  # signed envelopes per height
ABCI_CORRUPT = 100  # every 100th envelope carries a flipped signature byte
ABCI_ROTATE_AT = 4  # this block delivers the val: txs; set B serves from ABCI_ROTATE_AT + 2
ABCI_ROTATE = 2500  # val: txs remove this many of the oldest keys and add as many new ones
ABCI_MEMPOOL = 10_000  # an operator's size: the rotation block's txs exceed the default 5,000

# Published H100 SXM peaks (NVIDIA data sheet): 3.35 TB/s HBM3; 67 TFLOP/s
# float32 outside the tensor cores.  The integer multiply rate is not in the
# data sheet; the bound assumes one 32x32->64 partial product (one
# IMAD.WIDE.U32) per lane per clock on 64 of the 128 lanes of an SM, half
# the float32 FMA rate: 67e12 / 2 / 2 per second.
HBM_BYTES_PER_S = 3.35e12
IMAD_PER_S = 67e12 / 4
# A 64x64->128 product is 4 such partial products.  In 64x64->128 products
# (csrc/fe51.cuh, csrc/ge_quad.cuh): a field multiply 25, a squaring 15; a
# point doubling 4 squarings + 4 multiplies, a complete add 9 multiplies
# (8 when the second point carries 2d*T, as the ladder's table and the
# build's P_w and kernel 3's table rows do; the conversion to that form is 1
# multiply), a mixed add 7 (kernel 1's and kernel 3's base tables);
# the finish an inversion (254 squarings + 11 multiplies) and 2 multiplies.
IMAD_PER_PRODUCT = 4
MUL, SQ = 25, 15
DOUBLE, ADD, ADD_CACHED, MADD = 4 * SQ + 4 * MUL, 9 * MUL, 8 * MUL, 7 * MUL
FINISH = 254 * SQ + 11 * MUL + 2 * MUL


def log(*args):
    print(*args, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 else "nvidia-smi failed"


def sass_counts(so: str):
    """(function, IMAD instructions, of them IMAD.WIDE, all instructions)
    for each device function in the built library's SASS, from cuobjdump;
    the field helpers are __noinline__ and so show as functions of their
    own.  Empty when cuobjdump is missing."""
    import re
    import shutil

    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not os.path.exists(tool):
        return []
    out = subprocess.run([tool, "-sass", so], capture_output=True, text=True, timeout=120)
    counts, name = {}, None
    for line in out.stdout.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            name = m.group(1)
            counts.setdefault(name, [0, 0, 0])
            continue
        m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)", line)
        if name and m:
            op = m.group(1)
            c = counts[name]
            c[2] += 1
            if op.startswith("IMAD"):
                c[0] += 1
                c[1] += op.startswith("IMAD.WIDE")
    return [(k, *v) for k, v in counts.items()]


def bound(products: float, nbytes: float):
    ops_ms = products * IMAD_PER_PRODUCT / IMAD_PER_S * 1000
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1000
    return (ops_ms, "operations") if ops_ms >= bytes_ms else (bytes_ms, "bytes")


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def cuda_ms(fn, reps: int = 5) -> float:
    import torch

    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def wall_ms(fn) -> float:
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1000


def make_keys(n, prefix="val", start=0):
    """Keys prefix-start .. prefix-(n-1), made on SIGN_THREADS threads (the
    C key derivation releases the interpreter lock)."""
    from concurrent.futures import ThreadPoolExecutor

    from tendermint_tpu_torch.crypto.keys import Ed25519PrivKey

    with ThreadPoolExecutor(SIGN_THREADS) as ex:
        return list(ex.map(lambda i: Ed25519PrivKey.from_secret(f"{prefix}-{i}".encode()),
                           range(start, n), chunksize=512))


def kernel_mix(rng, keys):
    """KERNEL_BATCH rows cycling through every input class the kernels see.
    Returns the pubkey rows and the per-signature kernel inputs (idx, h_le,
    s_le, r_y, r_sign), the host-prep `valid` mask, the pure-Python oracle's
    verdicts, and `real`: the rows whose inputs are a real signature's."""
    import numpy as np

    from tendermint_tpu_torch.crypto import ed25519_math as em
    from tendermint_tpu_torch.crypto import batch_verifier as bvm

    ident_pk = (1).to_bytes(32, "little")  # the identity point (small order)
    bad_pk = b"\xff" * 32  # y >= p: fails decompression
    pubkeys = [k.pub_key().bytes() for k in keys] + [ident_pk, bad_pk]
    n_keys = len(keys)
    triples, idx, kinds = [], [], []
    p_plus_1 = (em.P + 1).to_bytes(32, "little")  # non-canonical encoding of y = 1
    for i in range(KERNEL_BATCH):
        kind = i % 10
        k = i % n_keys
        msg = f"vote-{i}".encode()
        sig = keys[k].sign(msg)
        pk_idx = k
        if kind == 1:  # wrong message
            msg = msg + b"!"
        elif kind == 2:  # wrong key
            pk_idx = (k + 1) % n_keys
        elif kind == 3:  # flipped R bit
            b = bytearray(sig)
            b[int(rng.integers(0, 32))] ^= 1 << int(rng.integers(0, 8))
            sig = bytes(b)
        elif kind == 4:  # flipped s bit
            b = bytearray(sig)
            b[32 + int(rng.integers(0, 31))] ^= 1 << int(rng.integers(0, 8))
            sig = bytes(b)
        elif kind == 5:  # identity key, R = identity, s = 0: cofactorless accept
            pk_idx, sig = n_keys, ident_pk + bytes(32)
        elif kind == 6:  # same, but R encoded non-canonically (y = p + 1)
            pk_idx, sig = n_keys, p_plus_1 + bytes(32)
        elif kind == 7:  # invalid pubkey row
            pk_idx = n_keys + 1
        triples.append((pubkeys[pk_idx], msg, sig))
        idx.append(pk_idx)
        kinds.append(kind)
    neg_a, h_dig, s_dig, r_y, r_sign, valid = bvm.prepare_batch(*zip(*triples))
    h_le, s_le = bvm._pack_digits(h_dig), bvm._pack_digits(s_dig)
    rows = np.stack(
        [bvm._neg_a_limbs(pk) if bvm._neg_a_limbs(pk) is not None else bvm.IDENTITY_ROW
         for pk in pubkeys]
    )
    oracle = np.array([em.verify(*t) for t in triples])
    for i, kind in enumerate(kinds):
        if kind == 8:  # real point, random scalars: compares R' off the signature path
            h_le[i] = rng.integers(0, 256, 32, dtype=np.uint8)
            s_le[i] = rng.integers(0, 256, 32, dtype=np.uint8)
        elif kind == 9:  # padding row
            idx[i] = 0
            h_le[i] = 0
            s_le[i] = 0
            r_y[i] = 0
            r_sign[i] = 0
    real = np.array([kind not in (8, 9) for kind in kinds])
    return rows, np.array(idx, dtype=np.int32), h_le, s_le, r_y, r_sign, valid, oracle, real


def phase_kernels(rng, keys, report, dev):
    """Every kernel against its plain version on the card, tolerance 0."""
    import numpy as np
    import torch

    from tendermint_tpu_torch.ops import ed25519, ed25519_cuda, ed25519_table

    rows, idx, h_le, s_le, r_y, r_sign, valid, oracle, real = kernel_mix(rng, keys)
    t = dict(
        rows=torch.as_tensor(rows, device=dev), idx=torch.as_tensor(idx, device=dev),
        h=torch.as_tensor(h_le, device=dev), s=torch.as_tensor(s_le, device=dev),
        ry=torch.as_tensor(r_y, device=dev), rs=torch.as_tensor(r_sign, device=dev),
    )

    def compare(name, got, want, b=len(idx)):
        """The kernel's verdicts and R' of the first b rows of the mix."""
        (ok_k, r_k), (ok_p, r_p) = got, want
        mismatched = int((ok_k != ok_p).sum())
        err = int((r_k.int() - r_p.int()).abs().max())
        verdicts = np.logical_and(ok_k.cpu().numpy(), valid[:b])
        oracle_bad = int((verdicts[real[:b]] != oracle[:b][real[:b]]).sum())
        log(f"  {name}: B={b} accepted={int(verdicts.sum())} verdict mismatches={mismatched} "
            f"R' max|diff|={err} oracle mismatches={oracle_bad}")
        if mismatched or err or oracle_bad:
            raise AssertionError(f"{name} disagrees with its plain version or the oracle")
        report[name]["max_abs_err"] = float(max(report[name].get("max_abs_err", 0.0),
                                                err, mismatched))

    got = ed25519_cuda.verify_indexed(t["rows"], t["idx"], t["h"], t["s"], t["ry"], t["rs"], want_r=True)
    want = ed25519.verify_prepared_packed(
        t["rows"][t["idx"].long()], t["h"], t["s"], t["ry"], t["rs"], want_r=True)
    compare("ed25519_ladder", got, want)

    tab_rows = t["rows"][:TABLE_VALIDATORS].contiguous()
    tables_k = ed25519_table.build_window_tables(tab_rows)
    tables_p = ed25519_table.build_window_tables_plain(tab_rows)
    diff = int((tables_k.int() - tables_p.int()).abs().max())
    log(f"  ed25519_window_tables: V={TABLE_VALIDATORS} entries={tables_k.shape[0]} max|diff|={diff}")
    if diff:
        raise AssertionError("window tables differ from the plain build")
    report["ed25519_window_tables"]["max_abs_err"] = float(diff)

    # the tabulated kernel needs every row tabulated: table the full row set;
    # B = 1 and 7 leave most lanes of a warp past the batch, 1021 a partial warp
    tables_all = ed25519_table.build_window_tables(t["rows"])
    for b in (1, 7, len(idx)):
        part = [t[k][:b].contiguous() for k in ("idx", "h", "s", "ry", "rs")]
        got = ed25519_table.verify_tabulated(tables_all, *part, want_r=True)
        want = ed25519_table.verify_tabulated_plain(
            tables_all, part[0], ed25519.expand_digits(part[1]), ed25519.expand_digits(part[2]),
            part[3], part[4], want_r=True)
        compare("ed25519_tabulated", got, want, b)

    if dev.type == "cuda":  # the quad helpers exist only on the card
        quad_vs_one_lane(rng, t["rows"], dev)


def quad_vs_one_lane(rng, rows, dev):
    """The four-lane point helpers against the one-lane helpers on real
    points (decompressed keys and the identity, doubled once in the kernel
    so Z is general; every 8th add is P + P)."""
    import numpy as np
    import torch

    from tendermint_tpu_torch.ops import ed25519_cuda

    pi = rng.integers(0, rows.shape[0], SELFTEST_ITEMS)
    qi = rng.integers(0, rows.shape[0], SELFTEST_ITEMS)
    qi[::8] = pi[::8]
    digits = torch.as_tensor(rng.integers(0, 16, SELFTEST_ITEMS, dtype=np.uint8), device=dev)
    raw, canon = ed25519_cuda.quad_selftest(
        rows[torch.as_tensor(pi, device=dev)].contiguous(),
        rows[torch.as_tensor(qi, device=dev)].contiguous(), digits)
    torch.cuda.synchronize()
    ops = ("dbl", "add", "madd")
    raw_diff = {op: int((raw[0, :, k] != raw[1, :, k]).any(dim=2).any(dim=1).sum())
                for k, op in enumerate(ops)}
    canon_diff = {op: int((canon[0, :, k] != canon[1, :, k]).any(dim=2).any(dim=1).sum())
                  for k, op in enumerate(ops)}
    log(f"  quad vs one-lane helpers, {SELFTEST_ITEMS} points: items whose raw limbs differ "
        f"{raw_diff}, whose canonical values differ {canon_diff}")
    if raw_diff["dbl"] or raw_diff["madd"] or any(canon_diff.values()):
        raise AssertionError("quad point helpers disagree with the one-lane helpers")


def build_commit(keys):
    from tendermint_tpu_torch.types.block import BlockID, Commit, PartSetHeader
    from tendermint_tpu_torch.types.canonical import PRECOMMIT_TYPE
    from tendermint_tpu_torch.types.validator import Validator, ValidatorSet
    from tendermint_tpu_torch.types.vote import Vote

    vset = ValidatorSet([Validator.new(k.pub_key(), 10) for k in keys])
    by_addr = {k.pub_key().address(): k for k in keys}
    bid = BlockID(b"\x11" * 32, PartSetHeader(1, b"\x22" * 32))
    sigs, msgs = [], []
    for i, v in enumerate(vset.validators):
        vote = Vote(PRECOMMIT_TYPE, 7, 0, bid, 1_700_000_000_000_000_000 + i, v.address, i)
        msg = vote.sign_bytes(CHAIN_ID)
        vote.signature = by_addr[v.address].sign(msg)
        sigs.append(vote.commit_sig())
        msgs.append(msg)
    return vset, bid, Commit(7, 0, bid, sigs), msgs


def phase_main(keys, card, dev):
    """The main path at full width; returns what the timing phase reuses."""
    import dataclasses

    from tendermint_tpu_torch.crypto import batch as batch_hook
    from tendermint_tpu_torch.crypto import batch_verifier as bvm
    from tendermint_tpu_torch.libs.tracing import FlightRecorder
    from tendermint_tpu_torch.types.block import CommitSig, Commit
    from tendermint_tpu_torch.types.validator import NotEnoughVotingPowerError

    t0 = time.perf_counter()
    vset, bid, commit, msgs = build_commit(keys)
    log(f"  built and signed a {vset.size()}-validator commit in {(time.perf_counter() - t0):.3f} s")
    rec = FlightRecorder(size=1 << 12)
    bv = bvm.BatchVerifier(device=dev, recorder=rec).install()

    def run(label, cache):
        cache.install()
        ms = wall_ms(lambda: vset.verify_commit(CHAIN_ID, bid, 7, commit))
        d = bv.last_dispatch
        log(f"  verify_commit [{label}] path={d['path']} n={d['n']} total_ms={ms:.3f} "
            f"host_prep_ms={d['host_prep_ms']:.3f} device_ms={d['device_ms']:.3f} ({card})")

    ladder = bvm.TableCache(bv, tabulated=False)
    run("ladder, cold table", ladder)
    run("ladder, warm table", ladder)
    tab = bvm.TableCache(bv, tabulated=True)
    run("tabulated, cold tables", tab)
    run("tabulated, warm tables", tab)
    auto = bvm.TableCache(bv, tabulated=None)
    run("auto, cold", auto)
    run("auto, warm", auto)
    prof = next(iter(bvm.tabulated_profiles.values()))
    log(f"  auto profile (CUDA events): tabulated="
        f"{'engaged' if prof['tab_ms'] < prof['ladder_ms'] else 'off'} "
        f"tab_ms={prof['tab_ms']:.3f} ladder_ms={prof['ladder_ms']:.3f} "
        f"table_build_ms={prof['table_build_ms']:.3f} at B={int(prof['batch'])} ({card})")
    events = rec.events(kinds=["verify.tabulated_profile"])
    fields = {"engaged", "tab_ms", "ladder_ms", "table_build_ms", "bucket", "validators"}
    log(f"  recorder: {len(events)} verify.tabulated_profile event(s) {events}")
    if dev.type == "cuda" and (len(events) != 1 or not fields <= set(events[0])
                               or events[0]["engaged"] != (prof["tab_ms"] < prof["ladder_ms"])):
        raise AssertionError("the auto-profile did not record one verify.tabulated_profile event")
    # the host work of verify_commit outside host prep and the dispatch
    t0 = time.perf_counter()
    commit.validate_basic()
    for i in range(commit.size()):
        commit.vote_sign_bytes(CHAIN_ID, i)
    log(f"  verify_commit host side: validate_basic + {commit.size()} sign-bytes "
        f"{(time.perf_counter() - t0) * 1000:.3f} ms ({card})")

    bad_i = min(1234, vset.size() - 1)
    sigs = list(commit.signatures)
    s = bytearray(sigs[bad_i].signature)
    s[0] ^= 1
    sigs[bad_i] = dataclasses.replace(sigs[bad_i], signature=bytes(s))
    try:
        vset.verify_commit(CHAIN_ID, bid, 7, Commit(7, 0, bid, sigs))
        raise AssertionError("tampered commit verified")
    except ValueError as e:
        if not str(e).startswith(f"wrong signature (#{bad_i})"):
            raise
        log(f"  tampered commit: raised '{str(e)[:40]}...'")

    absent = vset.size() // 3 + 1
    thin = Commit(7, 0, bid, [CommitSig.absent()] * absent + list(commit.signatures[absent:]))
    try:
        vset.verify_commit(CHAIN_ID, bid, 7, thin)
        raise AssertionError("commit with >= 1/3 absent verified")
    except NotEnoughVotingPowerError as e:
        log(f"  {absent} absent: raised NotEnoughVotingPowerError (got {e.got}, needed > {e.needed})")
    vset.verify_commit_trusting(CHAIN_ID, bid, 7, thin)
    log(f"  verify_commit_trusting at 1/3 with {absent} absent: passed")

    pks = [v.pub_key.bytes() for v in vset.validators[:FLAT_BATCH]]
    flat_sigs = [cs.signature for cs in commit.signatures[:FLAT_BATCH]]
    ok = bv.verify(pks, msgs[:FLAT_BATCH], flat_sigs)
    if ok != [True] * FLAT_BATCH:
        raise AssertionError("flat batch rejected valid votes")
    d = bv.last_dispatch
    log(f"  flat BatchVerifier.verify n={d['n']} host_prep_ms={d['host_prep_ms']:.3f} "
        f"device_ms={d['device_ms']:.3f} ({card})")
    batch_hook.set_verifier(None)
    batch_hook.set_indexed_verifier(None)
    return vset, commit, msgs, tab


def max_abs_diff(got, want) -> int:
    """Largest |kernel - plain| over paired tensors; 0 when they are equal."""
    import torch

    return max(0 if torch.equal(a, b) else int((a.int() - b.int()).abs().max())
               for a, b in zip(got, want))


def hold(name, report, got, want, what):
    """Kernel output against its plain version's at tolerance 0; the
    report's max_abs_err is the largest difference of any comparison."""
    err = max_abs_diff(got, want)
    log(f"  {name}: {what} max|kernel - plain|={err}")
    if err:
        raise AssertionError(f"{name} disagrees with its plain version at the main path's shapes")
    report[name]["max_abs_err"] = float(max(report[name].get("max_abs_err", 0.0), err))


def phase_timing(vset, commit, msgs, tab_cache, report):
    """Kernel against plain, kernel and plain times, and bounds, at the main
    path's shapes (the 10k commit, its 10k pubkey rows and window tables)."""
    import numpy as np
    import torch

    from tendermint_tpu_torch.crypto import batch_verifier as bvm
    from tendermint_tpu_torch.ops import _build, ed25519, ed25519_cuda, ed25519_table

    lib = _build.lib()  # its *_threads exports give each launch's thread count
    table = tab_cache.table_for(vset.pubkeys_digest(), None)
    n = vset.size()
    items = [(v.pub_key.bytes(), m, cs.signature)
             for v, m, cs in zip(vset.validators, msgs, commit.signatures)]
    idx, h, s, ry, rs = bvm._device_rows(table.device, np.arange(n), *bvm._scalar_rows(items)[:4])
    rows, tables = table.neg_a_rows, table.build_tables()
    plain = []

    def keep(fn):
        return lambda: plain.append(fn())

    # ladder: the commit's verdicts (all valid) and R' encodings
    k_ms = cuda_ms(lambda: ed25519_cuda.verify_indexed(rows, idx, h, s, ry, rs))
    got = ed25519_cuda.verify_indexed(rows, idx, h, s, ry, rs, want_r=True)
    p_ms = wall_ms(keep(lambda: ed25519.verify_prepared_packed(
        rows[idx.long()], h, s, ry, rs, want_r=True)))
    if not bool(got[0].all()):
        raise AssertionError("ed25519_ladder rejected a valid commit signature")
    hold("ed25519_ladder", report, got, plain.pop(), f"B={n} verdicts and R' bytes")
    products = n * (7 * DOUBLE + 7 * ADD_CACHED + 16 * MUL
                    + 64 * (4 * DOUBLE + ADD_CACHED + MADD) + FINISH)
    b_ms, b_by = bound(products, nbytes(rows, idx, h, s, ry, rs) + 2 * n)
    report["ed25519_ladder"].update(ms=k_ms, plain_ms=p_ms, bound_ms=b_ms, bound_by=b_by,
                                    threads=lib.ed25519_ladder_threads(n))

    # window tables: the kernel's build against the plain build, bit for bit
    k_ms = cuda_ms(lambda: ed25519_table.build_window_tables(rows), reps=2)
    p_ms = wall_ms(keep(lambda: ed25519_table.build_window_tables_plain(rows)))
    hold("ed25519_window_tables", report, (ed25519_table.build_window_tables(rows),),
         (plain.pop(),), f"V={rows.shape[0]} tables")
    # per window: P_w to the cached form, then 14 cached adds
    products = rows.shape[0] * (64 * (14 * ADD_CACHED + MUL) + 63 * 4 * DOUBLE)
    b_ms, b_by = bound(products, nbytes(rows, tables))
    threads_a, threads_b = (lib.ed25519_table_threads(p, rows.shape[0]) for p in (0, 1))
    pass_ms = kernel_device_ms(lambda: ed25519_table.build_window_tables(rows),
                               ("chain_kernel", "windows_kernel"))
    report["ed25519_window_tables"].update(
        ms=k_ms, plain_ms=p_ms, bound_ms=b_ms, bound_by=b_by, threads=threads_b,
        passes={"chain": {"kernel": "chain_kernel", "threads": threads_a,
                          "ms": pass_ms.get("chain_kernel")},
                "windows": {"kernel": "windows_kernel", "threads": threads_b,
                            "ms": pass_ms.get("windows_kernel")}})

    # tabulated verify: table bytes counted for the rows this commit reads
    k_ms = cuda_ms(lambda: ed25519_table.verify_tabulated(tables, idx, h, s, ry, rs))
    got = ed25519_table.verify_tabulated(tables, idx, h, s, ry, rs, want_r=True)
    hd, sd = ed25519.expand_digits(h), ed25519.expand_digits(s)
    p_ms = wall_ms(keep(lambda: ed25519_table.verify_tabulated_plain(
        tables, idx, hd, sd, ry, rs, want_r=True)))
    if not bool(got[0].all()):
        raise AssertionError("ed25519_tabulated rejected a valid commit signature")
    hold("ed25519_tabulated", report, got, plain.pop(), f"B={n} verdicts and R' bytes")
    w = torch.arange(64, device=idx.device)
    rows_read = torch.unique((idx.long()[:, None] * 64 + w) * 16 + hd.long().flip(1)).numel()
    row_bytes = 4 * 20 * tables.element_size()
    base_bytes = ed25519_table.base_windows_madd().nbytes
    # per signature: 64 rows to the cached form and added, 64 mixed adds of
    # base windows, one add joining the two quads' sums, the finish
    products = n * (64 * (MUL + ADD_CACHED) + 64 * MADD + (MUL + ADD_CACHED) + FINISH)
    b_ms, b_by = bound(products, rows_read * row_bytes + base_bytes + nbytes(idx, h, s, ry, rs) + 2 * n)
    report["ed25519_tabulated"].update(ms=k_ms, plain_ms=p_ms, bound_ms=b_ms, bound_by=b_by,
                                       threads=lib.ed25519_table_threads(2, n))


def check_profile(report, card):
    """The auto-profile's pick (phase 3) against phase 4's event times: where
    those differ by more than 10 %, the profile must have picked the faster
    kernel."""
    from tendermint_tpu_torch.crypto import batch_verifier as bvm

    prof = next(iter(bvm.tabulated_profiles.values()))
    tab, ladder = report["ed25519_tabulated"]["ms"], report["ed25519_ladder"]["ms"]
    picked_tab = prof["tab_ms"] < prof["ladder_ms"]
    log(f"  auto profile (CUDA events, median of 5): tab_ms={prof['tab_ms']:.4f} "
        f"ladder_ms={prof['ladder_ms']:.4f} -> {'tables' if picked_tab else 'ladder'}; "
        f"phase 4: tabulated {tab:.4f} ms, ladder {ladder:.4f} ms ({card})")
    if abs(tab - ladder) > 0.1 * min(tab, ladder) and picked_tab != (tab < ladder):
        raise AssertionError("the auto-profile picked the kernel that phase 4 times slower")


def percentile(values, q: float) -> float:
    import numpy as np

    return float(np.percentile(np.asarray(values, dtype=float), q)) if len(values) else float("nan")


def phase_ingress(keys, vset, commit, msgs, card, dev):
    """Vote ingress at full width on the node's engine settings, reusing
    phase 3's set and signed precommits.  Returns the per-mode numbers."""
    import asyncio
    import collections

    from tendermint_tpu_torch.crypto import batch as batch_hook
    from tendermint_tpu_torch.crypto import batch_verifier as bvm
    from tendermint_tpu_torch.libs.tracing import FlightRecorder
    from tendermint_tpu_torch.ops import _build, ed25519_cuda
    from tendermint_tpu_torch.types.block import BlockID, CommitSig, PartSetHeader
    from tendermint_tpu_torch.types.canonical import PRECOMMIT_TYPE
    from tendermint_tpu_torch.types.vote import ErrVoteConflictingVotes, Vote
    from tendermint_tpu_torch.types.vote_set import VoteSet

    n = vset.size()
    bid = commit.block_id
    set_key = vset.pubkeys_digest()
    pks = [v.pub_key.bytes() for v in vset.validators]
    sigs = [cs.signature for cs in commit.signatures]
    bad = set(range(0, n, CORRUPT_EVERY))
    for i in bad:
        s = bytearray(sigs[i])
        s[0] ^= 1  # a flipped bit of R
        sigs[i] = bytes(s)
    expect = [i not in bad for i in range(n)]
    triples = list(zip(pks, msgs, sigs))
    rec = FlightRecorder(size=1 << 17)

    def wait_rebuilds(count: int, timeout: float = 600.0):
        deadline = time.perf_counter() + timeout
        while time.perf_counter() < deadline:
            done = rec.events(kinds=["verify.table_rebuild"])
            if len(done) >= count:
                if not all(e["ok"] for e in done):
                    raise AssertionError(f"table rebuild failed: {done}")
                return done[count - 1]
            time.sleep(0.05)  # each poll walks the whole ring
        raise AssertionError("table rebuild did not finish")

    # 1. cold start: the library is loaded, so warmup serves the device at once
    bv = bvm.BatchVerifier(device=dev, min_device_batch=16, recorder=rec)
    bv.start_warmup()
    cache = bvm.TableCache(bv, tabulated=None).install()
    bv.install()
    ok = bv.verify(pks[1:17], msgs[1:17], sigs[1:17])
    if ok != expect[1:17] or bv.last_dispatch["path"] != "device":
        raise AssertionError(f"first batch after start_warmup: {bv.last_dispatch}")
    if rec.events(kinds=["verify.bucket_compile"]):
        raise AssertionError("start_warmup rebuilt a library that was already loaded")
    probe = bv.probe_dispatch_rtt()
    log(f"  start_warmup: library loaded={_build.loaded()}, first 16-vote batch path="
        f"{bv.last_dispatch['path']}; RTT probe dispatch_rtt_ms={probe['dispatch_rtt_ms']:.4f} "
        f"prep_ms_per_chunk={probe['prep_ms_per_chunk']:.4f} (chunk {bv.effective_chunk()}) "
        f"chunked_selected={bool(probe['chunked_selected'])} ({card})")
    t0 = time.perf_counter()
    if not cache.rebuild(set_key, pks):
        raise AssertionError("rebuild of the installed cache did not start")
    ev = wait_rebuilds(1)
    log(f"  installed TableCache (tabulated auto) rebuilt for {n} validators in "
        f"{(time.perf_counter() - t0) * 1000:.3f} ms (recorded {ev['ms']} ms)")

    # 2-4. the three arrival modes through one AsyncBatchVerifier
    async def storm(abv, loop, enq, done):
        futs = []
        for i, (pk, m, s) in enumerate(triples):  # one loop tick
            enq[i] = loop.time()
            futs.append(abv.verify_one(pk, m, s))
            futs[-1].add_done_callback(lambda f, i=i: done.__setitem__(i, loop.time()))
        log(f"    storm: {n} verify_one calls enqueued in {(loop.time() - enq[0]) * 1000:.3f} ms "
            f"(one loop tick)")
        return await asyncio.gather(*futs)

    async def relay(abv, loop, enq, done):
        frames = [list(range(i, min(i + VOTE_FRAME, n))) for i in range(0, n, VOTE_FRAME)]
        out = [None] * n

        async def sender(k):
            for frame in frames[k::RELAY_SENDERS]:
                for i in frame:
                    enq[i] = loop.time()
                res = await abv.verify_direct([triples[i] for i in frame])
                for i, r in zip(frame, res):
                    out[i], done[i] = r, loop.time()

        await asyncio.gather(*(sender(k) for k in range(RELAY_SENDERS)))
        return out

    async def many(abv, loop, enq, done):
        t = loop.time()
        futs = abv.verify_many(triples)
        for i, f in enumerate(futs):
            enq[i] = t
            f.add_done_callback(lambda f, i=i: done.__setitem__(i, loop.time()))
        return await asyncio.gather(*futs)

    async def drive():
        loop = asyncio.get_running_loop()
        abv = bvm.AsyncBatchVerifier(bv)  # the node's max_batch, flush_interval, flush_min
        await abv.start()
        out = {}
        try:
            for name, fn in (("verify_one storm", storm), ("verify_direct frames", relay),
                             ("verify_many batch", many)):
                since, launches = next_seq(rec), ed25519_cuda.LAUNCHES
                enq, done = [0.0] * n, [0.0] * n
                t0 = time.perf_counter()
                verdicts = await fn(abv, loop, enq, done)
                wall = time.perf_counter() - t0
                out[name] = {
                    "verdicts": [bool(v) for v in verdicts], "wall_s": wall,
                    "events": rec.events(since=since, kinds=["verify.flush", "verify.dispatch"]),
                    "latency_ms": [(d - e) * 1000 for d, e in zip(done, enq)],
                    "ladder_launches": ed25519_cuda.LAUNCHES - launches,
                }
        finally:
            await abv.stop()
        return out

    ladder_before = ed25519_cuda.LAUNCHES
    modes = asyncio.run(drive())
    device_flushes = 0
    for name, m in modes.items():
        wrong = sum(a != b for a, b in zip(m["verdicts"], expect))
        flush = [e for e in m["events"] if e["kind"] == "verify.flush"]
        disp = [e for e in m["events"] if e["kind"] == "verify.dispatch"]
        paths = collections.Counter(e["path"] for e in disp)
        waits = [e["wait_ms"] for e in flush]
        lat = m["latency_ms"]
        log(f"  {name}: {n} votes in {m['wall_s'] * 1000:.3f} ms = {n / m['wall_s']:.1f} votes/s, "
            f"verdict mismatches={wrong}; flushes={len(flush)} sizes={[e['batch'] for e in flush]}; "
            f"dispatches={len(disp)} by path {dict(paths)}; ladder launches={m['ladder_launches']} "
            f"({card})")
        if flush:
            log(f"    queue wait (oldest per flush) p50={percentile(waits, 50):.3f} "
                f"p99={percentile(waits, 99):.3f} ms; per flush host_prep_ms="
                f"{[e['host_prep_ms'] for e in disp]} device_ms={[e['device_ms'] for e in disp]}")
        else:
            log(f"    per frame host_prep_ms p50={percentile([e['host_prep_ms'] for e in disp], 50):.3f} "
                f"device_ms p50={percentile([e['device_ms'] for e in disp], 50):.3f} "
                f"max={max(e['device_ms'] for e in disp):.3f}")
        busy = sum(e["device_ms"] for e in disp) / (m["wall_s"] * 1000)
        log(f"    vote latency (enqueue to verdict) p50={percentile(lat, 50):.3f} "
            f"p99={percentile(lat, 99):.3f} ms; dispatches (copies, kernel, verdict copy; "
            f"host clock) cover {busy * 100:.2f} % of the mode's wall time")
        if wrong:
            raise AssertionError(f"{name}: {wrong} verdicts differ from the expected ones")
        big = [e for e in disp if e["n"] >= 16]
        if any(e["path"] in ("host", "host-cold") for e in big):
            raise AssertionError(f"{name}: a batch of 16 or more votes went to the host")
        device_flushes += sum(e["path"] == "device" for e in big)
        m["flush_sizes"] = [e["batch"] for e in flush]
        m["paths"] = dict(paths)
    if not device_flushes:
        raise AssertionError("no batch of 16 or more votes reached the ladder")
    if dev.type == "cuda" and ed25519_cuda.LAUNCHES == ladder_before:  # counts launches only
        raise AssertionError("the ladder's launch counter did not move during vote ingress")

    # 5. the storm's verdicts feed a precommit VoteSet, in arrival order
    storm_ok = modes["verify_one storm"]["verdicts"]
    vs = VoteSet(CHAIN_ID, commit.height, commit.round, PRECOMMIT_TYPE, vset)
    quorum = vset.total_voting_power() * 2 // 3 + 1
    power = vset.validators[0].voting_power
    want_cross = -(-quorum // power)
    added, crossed_at = 0, None
    t0 = time.perf_counter()
    for i, ok in enumerate(storm_ok):
        if not ok:
            continue
        cs = commit.signatures[i]
        vote = Vote(PRECOMMIT_TYPE, commit.height, commit.round, bid, cs.timestamp_ns,
                    cs.validator_address, i, sigs[i])
        if not vs.add_vote(vote, verify=False):
            raise AssertionError(f"VoteSet refused vote {i}")
        added += 1
        if crossed_at is None and vs.has_two_thirds_majority():
            crossed_at = added
    add_ms = (time.perf_counter() - t0) * 1000
    log(f"  VoteSet: {added} accepted precommits added in {add_ms:.3f} ms; 2/3 reached at vote "
        f"{crossed_at} (expected {want_cross} of power {power})")
    if crossed_at != want_cross:
        raise AssertionError("the VoteSet's 2/3 majority did not turn at the expected vote")
    by_addr = {k.pub_key().address(): k for k in keys}
    v5 = vset.validators[5]
    other = BlockID(b"\x33" * 32, PartSetHeader(1, b"\x44" * 32))
    conflict = Vote(PRECOMMIT_TYPE, commit.height, commit.round, other,
                    commit.signatures[5].timestamp_ns, v5.address, 5)
    conflict.signature = by_addr[v5.address].sign(conflict.sign_bytes(CHAIN_ID))
    try:
        vs.add_vote(conflict, verify=False)
        raise AssertionError("a conflicting precommit by validator 5 was accepted")
    except ErrVoteConflictingVotes as e:
        ev = e.evidence
        ev.verify(CHAIN_ID, v5.pub_key)
        if ev.address() != v5.address or {ev.vote_a.block_id, ev.vote_b.block_id} != {bid, other}:
            raise AssertionError("the conflict's evidence names the wrong votes")
        log(f"  conflicting precommit by validator 5: {str(e)[:60]}...; evidence verifies")
    made = vs.make_commit()
    diff = [i for i in range(n) if made.signatures[i] != (
        commit.signatures[i] if expect[i] else CommitSig.absent())]
    if diff or (made.height, made.round, made.block_id) != (commit.height, commit.round, bid):
        raise AssertionError(f"make_commit differs from phase 3's commit at {diff[:5]}")
    absent = sum(cs.is_absent() for cs in made.signatures)
    t0 = time.perf_counter()
    vset.verify_commit(CHAIN_ID, bid, commit.height, made)
    d = bv.last_dispatch
    log(f"  make_commit: equal to phase 3's commit but {absent} absent; verify_commit through the "
        f"installed TableCache passed in {(time.perf_counter() - t0) * 1000:.3f} ms, path={d['path']} "
        f"host_prep_ms={d['host_prep_ms']} device_ms={d['device_ms']} ({card})")

    # 6. TableCache.rebuild on a ladder cache, then the chunked single shot
    ladder_cache = bvm.TableCache(bv, tabulated=False)
    t0 = time.perf_counter()
    if not ladder_cache.rebuild(set_key, pks):
        raise AssertionError("rebuild of the ladder cache did not start")
    ev = wait_rebuilds(2)
    log(f"  ladder TableCache rebuilt in {(time.perf_counter() - t0) * 1000:.3f} ms "
        f"(warm dispatch path={bv.last_dispatch['path']})")
    table = ladder_cache.table_for(set_key, None)
    idxs = list(range(n))
    results, times = {}, collections.defaultdict(list)
    for chunked in (True, False, True, False):
        table.chunked_single_shot = chunked
        t0 = time.perf_counter()
        results[chunked] = table.verify_indexed(idxs, msgs, sigs)
        times[chunked].append((time.perf_counter() - t0) * 1000)
        if bv.last_dispatch["path"] != ("chunked" if chunked else "indexed"):
            raise AssertionError(f"chunked_single_shot={chunked} took path {bv.last_dispatch['path']}")
    log(f"  {n}-signature indexed verify, chunked single shot (chunk {bv.effective_chunk()}, "
        f"depth {bv.chunk_depth}): wall ms {[round(t, 3) for t in times[True]]}; monolithic: "
        f"{[round(t, 3) for t in times[False]]} ({card})")
    if results[True] != results[False] or results[True] != expect:
        raise AssertionError("chunked and monolithic verdicts differ")
    log(f"  chunked == monolithic == expected verdicts ({n - len(bad)} valid, {len(bad)} corrupted)")
    batch_hook.set_verifier(None)
    batch_hook.set_indexed_verifier(None)
    return modes


def sign_commit(vset, key_of, height, bid, ts):
    """A round-0 commit of `height` for `bid` by every validator of `vset`,
    validator i stamped ts + i, signed on SIGN_THREADS threads."""
    from concurrent.futures import ThreadPoolExecutor

    from tendermint_tpu_torch.types.block import BLOCK_ID_FLAG_COMMIT, Commit, CommitSig

    sigs = [CommitSig(BLOCK_ID_FLAG_COMMIT, v.address, ts + i, b"")
            for i, v in enumerate(vset.validators)]
    unsigned = Commit(height, 0, bid, sigs)
    jobs = [(key_of[cs.validator_address], unsigned.vote_sign_bytes(CHAIN_ID, i))
            for i, cs in enumerate(sigs)]
    with ThreadPoolExecutor(SIGN_THREADS) as ex:
        raw = list(ex.map(lambda job: job[0].sign(job[1]), jobs, chunksize=512))
    return Commit(height, 0, bid, [CommitSig(BLOCK_ID_FLAG_COMMIT, cs.validator_address,
                                             cs.timestamp_ns, r) for cs, r in zip(sigs, raw)])


class LiteChain:
    """Phase 6's chain: heights 1 .. top; the validator set of epoch e =
    (h - 1) // epoch is keys[rotate * e : rotate * e + n] at power 10, so
    each epoch replaces the `rotate` oldest validators by new keys.
    next_validators_hash and last_block_id chain the headers, all hashed
    here; a height's commit (every validator of its set, for its block) is
    signed on first request and kept."""

    def __init__(self, keys, n, rotate, epoch, top):
        from tendermint_tpu_torch.types.block import BlockID, Header, PartSetHeader
        from tendermint_tpu_torch.types.validator import Validator, ValidatorSet

        self.n, self.rotate, self.epoch_len, self.top = n, rotate, epoch, top
        self.key_of = {k.pub_key().address(): k for k in keys}
        self.index_of = {k.pub_key().bytes(): i for i, k in enumerate(keys)}
        self.sets = {e: ValidatorSet([Validator.new(k.pub_key(), 10)
                                      for k in keys[rotate * e: rotate * e + n]])
                     for e in range(self.epoch(top + 1) + 1)}
        set_hash = {e: vset.hash() for e, vset in self.sets.items()}
        self.headers, self.signed = {}, {}
        last = BlockID()
        for h in range(1, top + 1):
            e = self.epoch(h)
            header = Header(
                chain_id=CHAIN_ID, height=h, time_ns=self.time_ns(h), last_block_id=last,
                validators_hash=set_hash[e], next_validators_hash=set_hash[self.epoch(h + 1)],
                proposer_address=self.sets[e].validators[0].address,
            )
            last = BlockID(header.hash(), PartSetHeader(1, header.hash()))
            self.headers[h] = header
        self.sign_s = 0.0  # host seconds spent signing commits

    def epoch(self, h: int) -> int:
        return (h - 1) // self.epoch_len

    @staticmethod
    def time_ns(h: int) -> int:
        return LITE_T0 + h * SEC

    def now(self) -> int:
        return self.time_ns(self.top) + 5 * SEC

    def vals(self, h: int):
        return self.sets[self.epoch(h)]

    def trust(self, h: int):
        from tendermint_tpu_torch.lite2 import TrustOptions

        return TrustOptions(10 * self.top * SEC, h, self.headers[h].hash())

    def signed_header(self, h: int):
        from tendermint_tpu_torch.types.block import BlockID, PartSetHeader, SignedHeader

        if h not in self.signed:
            t0 = time.perf_counter()
            header = self.headers[h]
            bid = BlockID(header.hash(), PartSetHeader(1, header.hash()))
            commit = sign_commit(self.vals(h), self.key_of, h, bid, self.time_ns(h))
            self.signed[h] = SignedHeader(header, commit)
            self.sign_s += time.perf_counter() - t0
        return self.signed[h]

    def provider(self, overrides=None):
        """A lite2 Provider serving this chain; `overrides` {height:
        SignedHeader} are served in place of the chain's own."""
        from tendermint_tpu_torch.lite2.provider import Provider, SignedHeaderNotFound

        chain, served = self, dict(overrides or {})

        class ChainProvider(Provider):
            def chain_id(self) -> str:
                return CHAIN_ID

            async def signed_header(self, height: int):
                h = height or chain.top
                if not 1 <= h <= chain.top:
                    raise SignedHeaderNotFound(f"no signed header at height {height}")
                return served.get(h) or chain.signed_header(h)

            async def validator_set(self, height: int):
                return chain.vals(height or chain.top)

        return ChainProvider()


@contextlib.contextmanager
def table_timing(chain, builds: list, dev):
    """Record each PubkeyTable built meanwhile: its set's epoch in `chain`
    (None without one), the building thread, the host rows' ms
    (decompression and upload) and the window tables' ms (kernel 2), each
    between card synchronizations.  Restores the class after."""
    import threading

    import torch

    from tendermint_tpu_torch.crypto import batch_verifier as bvm

    cls = bvm.PubkeyTable
    orig_init, orig_build = cls.__init__, cls.build_tables
    by_table = {}

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize()

    def init(self, pubkeys, *args, **kwargs):
        t0 = time.perf_counter()
        orig_init(self, pubkeys, *args, **kwargs)
        sync()
        epoch = (None if chain is None else
                 min(chain.index_of[bytes(pk)] for pk in pubkeys) // chain.rotate)
        by_table[id(self)] = {"epoch": epoch, "validators": len(pubkeys),
                              "thread": threading.current_thread().name,
                              "rows_ms": _ms(t0), "build_ms": None}
        builds.append(by_table[id(self)])

    def build(self):
        if self._window_tables is not None or id(self) not in by_table:
            return orig_build(self)
        sync()
        t0 = time.perf_counter()
        out = orig_build(self)
        sync()
        by_table[id(self)]["build_ms"] = _ms(t0)
        return out

    cls.__init__, cls.build_tables = init, build
    try:
        yield
    finally:
        cls.__init__, cls.build_tables = orig_init, orig_build


def _ms(t0: float) -> float:
    return (time.perf_counter() - t0) * 1000


def next_seq(rec) -> int:
    return rec.snapshot(since=1 << 62)["next_seq"]


async def lite_run(chain, rec, mode="bisection", trust_h=1, target=LITE_TARGET,
                   preverify=None, store=None):
    """One client run with an honest witness; every commit check passes a
    probe that notes the step (trusted height from the store, untrusted
    height, recorder position, host clock) before `preverify` (None: the
    installed hooks verify)."""
    from tendermint_tpu_torch import lite2

    steps = []
    client = None

    async def probe(sh, vals_sets):
        steps.append({"trusted": client.store.latest_height(), "untrusted": sh.height,
                      "seq": next_seq(rec), "t": time.perf_counter(), "sign_s": chain.sign_s})
        return None if preverify is None else await preverify(sh, vals_sets)

    client = lite2.Client(CHAIN_ID, chain.trust(trust_h), chain.provider(), [chain.provider()],
                          store=store, mode=mode, commit_preverify=probe, now_fn=chain.now)
    sign0, t0 = chain.sign_s, time.perf_counter()
    sh = await client.verify_header_at_height(target, chain.now())
    end, end_seq = time.perf_counter(), next_seq(rec)
    for i, st in enumerate(steps):
        last = i + 1 == len(steps)
        st["ms"] = ((end if last else steps[i + 1]["t"]) - st["t"]) * 1000
        st["sign_ms"] = ((chain.sign_s if last else steps[i + 1]["sign_s"]) - st["sign_s"]) * 1000
        st["ok"] = (sh.height if last else steps[i + 1]["trusted"]) == st["untrusted"]
    if sh.hash() != chain.headers[target].hash():
        raise AssertionError(f"the client's header {target} is not the chain's")
    disp = [e for e in rec.events(since=steps[0]["seq"], kinds=["verify.dispatch"])
            if e["seq"] < end_seq]
    return {"client": client, "steps": steps, "wall_s": end - t0, "sign_s": chain.sign_s - sign0,
            "end_seq": end_seq, "dispatch_ms": sum(e["device_ms"] for e in disp)}


def check_bisection(name, run, card):
    """The bisection's steps and persisted heights against LITE_STEPS and
    LITE_HEIGHTS; prints them on a mismatch."""
    steps = [(st["trusted"], st["untrusted"], st["ok"]) for st in run["steps"]]
    heights = run["client"].store.heights()
    if steps[0][:2] != (0, 1) or steps[1:] != LITE_STEPS or heights != LITE_HEIGHTS:
        log(f"  {name}: steps {steps}; persisted {heights}")
        raise AssertionError(f"{name}: the bisection's steps or heights differ from the expected ones")
    log(f"  {name}: {len(LITE_STEPS)} steps as expected, persisted {heights}; "
        + run_summary(run, len(heights), card))


def card_memory(dev, cache) -> str:
    """The card's allocated memory beside the number of sets the table
    cache holds: an evicted set's tables must be freed."""
    import torch

    held = f"{len(cache._tables)} sets cached (max {cache.max_sets})"
    if dev.type != "cuda":
        return held
    return f"{held}, {torch.cuda.memory_allocated(dev) / 2**30:.3f} GiB allocated on the card"


def run_summary(run, headers, card) -> str:
    """Wall time, signing, headers/s without signing, and the dispatches'
    share of the rest (host clock: an upper bound on the card's busy share)."""
    verify_ms = (run["wall_s"] - run["sign_s"]) * 1000
    return (f"{len(run['steps'])} commit checks in {run['wall_s'] * 1000:.3f} ms wall, of which "
            f"signing {run['sign_s'] * 1000:.3f} ms; {headers / max(verify_ms, 1e-9) * 1000:.3f} "
            f"headers/s without signing; dispatches {run['dispatch_ms']:.3f} ms = "
            f"{run['dispatch_ms'] / max(verify_ms, 1e-9) * 100:.2f} % of that ({card})")


def print_steps(run, rec, card):
    """Per commit check: outcome, the engine's dispatches (path, batch,
    host prep and device ms) and the table cache's hit or miss."""
    steps = run["steps"]
    for i, st in enumerate(steps):
        until = steps[i + 1]["seq"] if i + 1 < len(steps) else run["end_seq"]
        evs = [e for e in rec.events(since=st["seq"], kinds=["verify.table", "verify.dispatch",
                                                             "verify.flush"])
               if e["seq"] < until]
        parts, table = [], None
        for e in evs:
            if e["kind"] == "verify.table":
                table = "hit" if e["hit"] else "miss, built"
            elif e["kind"] == "verify.flush":
                parts.append(f"flush {e['batch']}")
            else:
                parts.append(f"{e['path']} n={e['n']} host_prep_ms={e['host_prep_ms']} "
                             f"device_ms={e['device_ms']}" + (f" table {table}" if table else ""))
                table = None
        what = "init" if st["trusted"] == 0 else ("trusted" if st["ok"] else "can't trust")
        log(f"    {st['trusted']} -> {st['untrusted']} {what}: {st['ms']:.3f} ms "
            f"(signing the next request {st['sign_ms']:.3f} ms); "
            f"{'; '.join(parts) or 'no signature shared, no dispatch'} ({card})")


def host_breakdown(chain, card):
    """Host ms of the parts of one skipping step at full width, on the
    step 788 -> 1000 with a VerifyCache lookup serving the signatures (what
    a tenant of run 4 pays per call once the commit is verified)."""
    from tendermint_tpu_torch.liteserve.cache import _commit_digest
    from tendermint_tpu_torch.lite2 import verify_non_adjacent

    lo, hi = LITE_STEPS[-1][:2]
    trusted, sh, vals = chain.signed_header(lo), chain.signed_header(hi), chain.vals(hi)
    old = chain.vals(lo)
    ok = {}
    for i, cs in enumerate(sh.commit.signatures):
        ok[(vals.validators[i].pub_key.bytes(), sh.commit.vote_sign_bytes(CHAIN_ID, i),
            cs.signature)] = True

    def lookup(pubkeys, msgs, sigs):
        return [ok[k] for k in zip(pubkeys, msgs, sigs)]

    parts = {
        "validate_basic": lambda: sh.validate_basic(CHAIN_ID),
        "set hash": vals.hash,
        "sign-bytes": lambda: [sh.commit.vote_sign_bytes(CHAIN_ID, i)
                               for i in range(len(sh.commit.signatures))],
        "trusted-set lookups": lambda: [old.get_by_address(cs.validator_address)
                                        for cs in sh.commit.signatures],
        "commit digest": lambda: _commit_digest(sh.commit),
        "whole step": lambda: verify_non_adjacent(
            CHAIN_ID, trusted, old, sh, vals, 10 * chain.top * SEC, chain.now(), 10 * SEC,
            batch_verify=lookup),
    }
    out = {}
    for name, fn in parts.items():
        t0 = time.perf_counter()
        fn()
        out[name] = round(_ms(t0), 3)
    log(f"  host ms of one skipping step {lo} -> {hi} at {len(vals)} validators, signatures "
        f"served by a lookup: {out} ({card})")


def phase_light(keys, card, dev, report):
    """The light client at full width (see the module docstring, 6).
    Returns the launches of run 1 and of runs 3-4 by counter."""
    import asyncio
    import dataclasses

    import tempfile

    from tendermint_tpu_torch import lite2
    from tendermint_tpu_torch.crypto import batch as batch_hook
    from tendermint_tpu_torch.crypto import batch_verifier as bvm
    from tendermint_tpu_torch.libs.kvstore import open_db
    from tendermint_tpu_torch.libs.tracing import FlightRecorder
    from tendermint_tpu_torch.liteserve import VerifyCache
    from tendermint_tpu_torch.ops import ed25519_cuda, ed25519_table
    from tendermint_tpu_torch.statesync import EngineCommitPreverify
    from tendermint_tpu_torch.types.block import Commit, SignedHeader

    def counters():
        return {"ed25519_ladder": ed25519_cuda.LAUNCHES,
                "ed25519_window_tables": ed25519_table.BUILD_LAUNCHES,
                "ed25519_tabulated": ed25519_table.SUM_LAUNCHES}

    def since(before):
        return {k: v - before[k] for k, v in counters().items()}

    n = N_VALIDATORS
    t0 = time.perf_counter()
    need = n + LITE_ROTATE * (LITE_TOP // LITE_EPOCH)
    all_keys = list(keys[:n]) + make_keys(need, start=n)
    chain = LiteChain(all_keys, n, LITE_ROTATE, LITE_EPOCH, LITE_TOP)
    log(f"  chain: {LITE_TOP} headers hashed, {len(chain.sets)} validator sets of {n} "
        f"({need} keys) in {_ms(t0):.3f} ms")

    # run 1: bisection through the installed hooks, tables on auto
    rec = FlightRecorder(size=1 << 16)
    bv = bvm.BatchVerifier(device=dev, recorder=rec).install()
    cache = bvm.TableCache(bv, tabulated=None).install()
    builds = []
    before = counters()
    with table_timing(chain, builds, dev):
        run1 = asyncio.run(lite_run(chain, rec))
    launches_run1 = since(before)
    log("  run 1, bisection through the hooks:")
    print_steps(run1, rec, card)
    check_bisection("run 1", run1, card)
    for b in builds:
        log(f"    new set, epoch {b['epoch']} ({b['validators']} validators): host rows "
            f"{b['rows_ms']:.3f} ms, window tables (kernel 2) "
            f"{'not built' if b['build_ms'] is None else format(b['build_ms'], '.3f') + ' ms'} ({card})")
    met = sorted({chain.epoch(h) for h in LITE_HEIGHTS})
    built = sorted(b["epoch"] for b in builds if b["build_ms"] is not None)
    paths = {e["path"] for e in rec.events(kinds=["verify.dispatch"])}
    log(f"  run 1: sets met {met}, tables built for {built}, dispatch paths {sorted(paths)}, "
        f"launches {launches_run1}; {card_memory(dev, cache)}")
    if dev.type == "cuda":  # the counters count kernel launches only
        if built != met:
            raise AssertionError("run 1 did not build window tables for every new set it met")
        if "tabulated" in paths and not launches_run1["ed25519_tabulated"]:
            raise AssertionError("run 1 took the tabulated path without launching kernel 3")
        if paths & {"indexed", "chunked"} and not launches_run1["ed25519_ladder"]:
            raise AssertionError("run 1 took the ladder path without launching kernel 1")

    # run 2: sequence on from the stored header at 1000 into the next set,
    # persisted to a sqlite DBStore that starts as a copy of run 1's store
    light_home = tempfile.TemporaryDirectory(prefix="chip-smoke-light-")
    db = open_db("light", light_home.name)
    db_store = lite2.DBStore(db)
    for h in run1["client"].store.heights():
        db_store.save_signed_header_and_validator_set(
            run1["client"].store.signed_header(h), run1["client"].store.validator_set(h))
    with table_timing(chain, builds, dev):
        run2 = asyncio.run(lite_run(chain, rec, mode=lite2.SEQUENCE, trust_h=LITE_TARGET,
                                       target=LITE_TOP, store=db_store))
    log(f"  run 2, sequence {LITE_TARGET} -> {LITE_TOP} (sqlite DBStore):")
    print_steps(run2, rec, card)
    persisted = run2["client"].store.heights()
    seq_heights = persisted[: LITE_TOP - LITE_TARGET + 1]
    if seq_heights != list(range(LITE_TOP, LITE_TARGET - 1, -1)):
        raise AssertionError(f"run 2 persisted {seq_heights}")
    db.close()
    db = open_db("light", light_home.name)
    reopened = lite2.DBStore(db)
    t0 = time.perf_counter()
    back = {h: (reopened.signed_header(h), reopened.validator_set(h)) for h in seq_heights}
    read_ms = _ms(t0)
    if reopened.heights() != persisted or any(
            sh.hash() != chain.headers[h].hash() or vals.hash() != chain.vals(h).hash()
            or vals.to_dict() != chain.vals(h).to_dict() for h, (sh, vals) in back.items()):
        raise AssertionError("the reopened DBStore does not hold what run 2 persisted")
    log(f"  run 2: reopened DBStore holds {reopened.heights()}; headers and sets "
        f"{LITE_TARGET}-{LITE_TOP} read back equal in {read_ms:.3f} ms ({card})")
    db.close()
    light_home.cleanup()
    log(f"  run 2: {LITE_TOP - LITE_TARGET} adjacent headers; "
        + run_summary(run2, LITE_TOP - LITE_TARGET, card))
    for b in builds[len(met):]:
        log(f"    new set, epoch {b['epoch']}: host rows {b['rows_ms']:.3f} ms, window tables "
            f"(kernel 2) {b['build_ms']} ms ({card})")
    log(f"  run 2: {card_memory(dev, cache)}")

    # runs 3 and 4: the node's engine settings, one AsyncBatchVerifier on the loop
    rec3 = FlightRecorder(size=1 << 17)
    bv3 = bvm.BatchVerifier(device=dev, min_device_batch=16, recorder=rec3)
    bv3.start_warmup()
    bvm.TableCache(bv3, tabulated=None).install()
    bv3.install()

    async def engine_lane():
        abv = bvm.AsyncBatchVerifier(bv3)
        await abv.start()
        try:
            run3 = await lite_run(chain, rec3, preverify=EngineCommitPreverify(abv))
            vcache = VerifyCache(async_verifier=abv)
            hook, calls = vcache.preverify(), []

            async def counted(sh, vals_sets):
                calls.append(sh.height)
                return await hook(sh, vals_sets)

            tenants = [lite2.Client(CHAIN_ID, chain.trust(1), chain.provider(),
                                    commit_preverify=counted, now_fn=chain.now)
                       for _ in range(LITE_TENANTS)]
            seq4, t0 = next_seq(rec3), time.perf_counter()
            got = await asyncio.gather(*(t.verify_header_at_height(LITE_TARGET, chain.now())
                                         for t in tenants))
            wall4 = time.perf_counter() - t0
            disp4 = sum(e["device_ms"] for e in rec3.events(since=seq4, kinds=["verify.dispatch"]))
            return run3, vcache, calls, tenants, got, wall4, disp4
        finally:
            await abv.stop()

    before = counters()
    seq3 = next_seq(rec3)
    run3, vcache, calls, tenants, got, wall4, disp4 = asyncio.run(engine_lane())
    launches_34 = since(before)
    log("  run 3, bisection through EngineCommitPreverify (AsyncBatchVerifier):")
    print_steps(run3, rec3, card)
    check_bisection("run 3", run3, card)
    disp = rec3.events(since=seq3, kinds=["verify.dispatch"])
    by_path = collections.Counter(e["path"] for e in disp)
    if any(e["path"] in ("host", "host-cold") for e in disp if e["n"] >= 16):
        raise AssertionError("runs 3-4: a batch of 16 or more signatures went to the host")
    stats = vcache.stats()
    per_tenant = len(LITE_STEPS) + 1
    primary = chain.headers[LITE_TARGET].hash()
    log(f"  run 4, {LITE_TENANTS} tenants through one VerifyCache: {len(calls)} preverify calls, "
        f"stats {stats}; {LITE_TENANTS * len(LITE_HEIGHTS)} headers in {wall4 * 1000:.3f} ms wall = "
        f"{LITE_TENANTS * len(LITE_HEIGHTS) / wall4:.3f} headers/s; dispatches {disp4:.3f} ms = "
        f"{disp4 / (wall4 * 1000) * 100:.2f} % of the wall ({card})")
    host_breakdown(chain, card)
    log(f"  runs 3-4: dispatches by path {dict(by_path)}, launches {launches_34} ({card})")
    if len(calls) != LITE_TENANTS * per_tenant or stats["misses"] != LITE_DISTINCT \
            or stats["hits"] + stats["coalesced"] != LITE_TENANTS * per_tenant - LITE_DISTINCT:
        raise AssertionError("the shared VerifyCache's calls or stats differ from the expected ones")
    if any(sh.hash() != primary for sh in got) or any(
            t.store.heights() != LITE_HEIGHTS for t in tenants):
        raise AssertionError("a tenant's trusted header or heights differ from the primary's")

    # run 5: the failures, on run 1's engine
    bv.install()
    cache.install()
    trusted_h = LITE_STEPS[-1][0]
    honest = chain.signed_header(LITE_TARGET)
    bad = next(i for i, cs in enumerate(honest.commit.signatures)
               if chain.vals(trusted_h).has_address(cs.validator_address))
    sigs = list(honest.commit.signatures)
    flipped = bytearray(sigs[bad].signature)
    flipped[0] ^= 1
    sigs[bad] = dataclasses.replace(sigs[bad], signature=bytes(flipped))
    forged = SignedHeader(honest.header, Commit(LITE_TARGET, 0, honest.commit.block_id, sigs))
    lying = SignedHeader(dataclasses.replace(honest.header, app_hash=b"\xee" * 32), honest.commit)

    async def failures():
        client = lite2.Client(CHAIN_ID, chain.trust(trusted_h),
                              chain.provider({LITE_TARGET: forged}), now_fn=chain.now)
        try:
            await client.verify_header_at_height(LITE_TARGET, chain.now())
            raise AssertionError("a header with a flipped signature verified")
        except ValueError as e:
            if not str(e).startswith(f"wrong signature (#{bad})"):
                raise
            log(f"  run 5: primary with a flipped signature #{bad} in header {LITE_TARGET}: "
                f"raised ValueError '{str(e)[:40]}...'; persisted {client.store.heights()}")
        client = lite2.Client(CHAIN_ID, chain.trust(trusted_h), chain.provider(),
                              [chain.provider({LITE_TARGET: lying})], now_fn=chain.now)
        await client.initialize()
        held = client.store.heights()
        try:
            await client.verify_header_at_height(LITE_TARGET, chain.now())
            raise AssertionError("a diverging witness went unnoticed")
        except lite2.DivergedHeaderError as e:
            if client.store.heights() != held:
                raise AssertionError(f"the store kept {client.store.heights()}, not {held}")
            log(f"  run 5: witness serving another header {LITE_TARGET}: raised "
                f"DivergedHeaderError '{e}'; store rolled back to {held}")

    asyncio.run(failures())
    batch_hook.set_verifier(None)
    batch_hook.set_indexed_verifier(None)

    built_ms = [b["build_ms"] for b in builds if b["build_ms"] is not None]
    if built_ms and "ms" in report["ed25519_tabulated"]:
        saving = report["ed25519_ladder"]["ms"] - report["ed25519_tabulated"]["ms"]
        log(f"  window tables on this path: build (kernel 2) {min(built_ms):.3f}-{max(built_ms):.3f} "
            f"ms per set, rows {min(b['rows_ms'] for b in builds):.3f}-"
            f"{max(b['rows_ms'] for b in builds):.3f} ms; phase 4's per-commit kernel saving "
            f"(ladder - tabulated at 10k) {saving:.4f} ms; each set serves at most two commits "
            f"here ({card})")
    return launches_run1, launches_34


def next_state(state, block_id, block, changes=None):
    """The state after `block`: state.execution.update_state fed code-0
    DeliverTx responses and no EndBlock updates; validator `changes` land in
    the next set and take effect two heights on."""
    from tendermint_tpu_torch.abci import types as abci
    from tendermint_tpu_torch.state.execution import update_state

    responses = {"deliver_txs": [abci.ResponseDeliverTx() for _ in block.txs],
                 "end_block": abci.ResponseEndBlock()}
    return update_state(state, block_id, block, responses, list(changes or []))


def build_replay_chain(keys, new_keys, home):
    """Phase 7's chain on disk: genesis with `keys` at power 10, then blocks
    1 .. REPLAY_TOP of REPLAY_TXS txs each, from height 2 on carrying the
    previous height's commit; the height REPLAY_ROTATE_AT - 2 state takes a
    change set removing the REPLAY_ROTATE oldest keys and adding `new_keys`
    (set B from height REPLAY_ROTATE_AT on).  States go to a sqlite
    StateStore, blocks (with their part sets and seen commits) to a sqlite
    BlockStore, both under `home`.  Returns the blocks, the per-block write
    times and the signing seconds."""
    import numpy as np

    from tendermint_tpu_torch.libs.kvstore import open_db
    from tendermint_tpu_torch.state import StateStore, make_genesis_state
    from tendermint_tpu_torch.store import BlockStore
    from tendermint_tpu_torch.types.block import BlockID
    from tendermint_tpu_torch.types.genesis import GenesisDoc, GenesisValidator
    from tendermint_tpu_torch.types.params import BLOCK_PART_SIZE_BYTES
    from tendermint_tpu_torch.types.validator import Validator

    gen = GenesisDoc(CHAIN_ID, genesis_time_ns=LITE_T0, validators=[
        GenesisValidator(k.pub_key().address(), k.pub_key(), 10) for k in keys])
    state = make_genesis_state(gen)
    state_db, block_db = open_db("state", home), open_db("blockstore", home)
    state_store, block_store = StateStore(state_db), BlockStore(block_db)
    state_store.save(state)
    key_of = {k.pub_key().address(): k for k in list(keys) + list(new_keys)}
    changes = ([Validator.new(k.pub_key(), 0) for k in keys[:len(new_keys)]]
               + [Validator.new(k.pub_key(), 10) for k in new_keys])
    rng = np.random.default_rng(7)
    blocks, write_ms, sign_s, last_commit = {}, {}, 0.0, None
    for h in range(1, REPLAY_TOP + 1):
        txs = [row.tobytes() for row in
               rng.integers(0, 256, (REPLAY_TXS, REPLAY_TX_BYTES), dtype=np.uint8)]
        block = state.make_block(h, txs, last_commit, [], state.validators.get_proposer().address)
        part_set = block.make_part_set(BLOCK_PART_SIZE_BYTES)
        bid = BlockID(block.hash(), part_set.header())
        t0 = time.perf_counter()
        commit = sign_commit(state.validators, key_of, h, bid, block.time_ns + SEC)
        sign_s += time.perf_counter() - t0
        t0 = time.perf_counter()
        block_store.save_block(block, part_set, commit)
        write_ms[h] = _ms(t0)
        state = next_state(state, bid, block, changes if h == REPLAY_ROTATE_AT - 2 else None)
        state_store.save(state)
        blocks[h], last_commit = block, commit
    state_db.close()
    block_db.close()
    return blocks, write_ms, sign_s


def phase_replay(keys, card, dev):
    """Fast-sync replay from the stores (see the module docstring, 7).
    Returns the launches of (a) by counter."""
    import dataclasses
    import tempfile
    import types

    from tendermint_tpu_torch.crypto import batch as batch_hook
    from tendermint_tpu_torch.crypto import batch_verifier as bvm
    from tendermint_tpu_torch.encoding import codec
    from tendermint_tpu_torch.fastsync import Processor, Scheduler, verify_commit_run
    from tendermint_tpu_torch.libs.kvstore import open_db
    from tendermint_tpu_torch.libs.tracing import FlightRecorder
    from tendermint_tpu_torch.libs.watchdog import StorageHealth
    from tendermint_tpu_torch.ops import ed25519_cuda, ed25519_table
    from tendermint_tpu_torch.state import StateStore
    from tendermint_tpu_torch.store import BlockStore
    from tendermint_tpu_torch.types.block import Block, BlockID, Commit
    from tendermint_tpu_torch.types.params import BLOCK_PART_SIZE_BYTES

    def counters():
        return {"ed25519_ladder": ed25519_cuda.LAUNCHES,
                "ed25519_window_tables": ed25519_table.BUILD_LAUNCHES,
                "ed25519_tabulated": ed25519_table.SUM_LAUNCHES}

    n = len(keys)
    new_keys = make_keys(REPLAY_ROTATE, prefix="replay")
    tmp = tempfile.TemporaryDirectory(prefix="chip-smoke-replay-")
    try:
        t0 = time.perf_counter()
        blocks, write_ms, sign_s = build_replay_chain(keys, new_keys, tmp.name)
        build_s = time.perf_counter() - t0
        raw = blocks[REPLAY_TOP].serialize()
        t0 = time.perf_counter()
        codec.dumps(blocks[REPLAY_TOP])
        enc_ms = _ms(t0)
        t0 = time.perf_counter()
        codec.loads(raw)
        dec_ms = _ms(t0)
        parts = blocks[REPLAY_TOP].make_part_set(BLOCK_PART_SIZE_BYTES).total
        log(f"  chain: {REPLAY_TOP} blocks of {REPLAY_TXS} txs x {REPLAY_TX_BYTES} B, set A of {n} "
            f"until height {REPLAY_ROTATE_AT - 1}, set B ({len(new_keys)} replaced) from "
            f"{REPLAY_ROTATE_AT}, built in {build_s * 1000:.3f} ms of which signing "
            f"{sign_s * 1000:.3f} ms; block {REPLAY_TOP}: {len(raw)} B serialized, {parts} parts; "
            f"codec encode {enc_ms:.3f} ms, decode {dec_ms:.3f} ms ({card})")
        log(f"  store writes per block (save_block, ms): "
            f"{[round(write_ms[h], 3) for h in sorted(write_ms)]} ({card})")

        # reopen both stores with new handles
        state_db, block_db = open_db("state", tmp.name), open_db("blockstore", tmp.name)
        state_store, block_store = StateStore(state_db), BlockStore(block_db)
        health = StorageHealth(data_dir=os.path.join(tmp.name, "data"))  # as node.py builds it
        block_store.storage_health = health
        if (block_store.base(), block_store.height()) != (1, REPLAY_TOP):
            raise AssertionError(f"reopened block store holds {block_store.base()}..{block_store.height()}")

        rec = FlightRecorder(size=1 << 16)
        bv = bvm.BatchVerifier(device=dev, recorder=rec).install()
        cache = bvm.TableCache(bv, tabulated=None).install()
        builds = []
        ident = types.SimpleNamespace(index_of={k.pub_key().bytes(): i for i, k in
                                                enumerate(list(keys) + list(new_keys))},
                                      rotate=len(new_keys))

        # (a) per pair, as the fast-sync reactor's _try_sync does, without apply_block
        before = counters()
        t_a = time.perf_counter()
        proc, sched = Processor(1), Scheduler(1)
        sched.set_peer_range("store", 1, REPLAY_TOP)
        for peer, h in sched.next_requests(0.0):
            sched.mark_requested(peer, h, 0.0)
        load_ms, loaded = {}, {}
        for h in range(1, REPLAY_TOP + 1):
            t0 = time.perf_counter()
            block = block_store.load_block(h)
            load_ms[h] = _ms(t0)
            if block is None or block.hash() != blocks[h].hash() or not sched.block_received("store", h):
                raise AssertionError(f"block {h} did not load back as written")
            proc.add_block(h, block, "store")
            loaded[h] = block
        checks, hash_ms, vals_ms, sets = [], {}, {}, {}
        with table_timing(ident, builds, dev):
            while (pair := proc.peek_two()) is not None:
                first, second = pair
                t0 = time.perf_counter()
                first_id = BlockID(first.hash(), first.make_part_set(BLOCK_PART_SIZE_BYTES).header())
                hash_ms[first.height] = _ms(t0)
                if first_id != block_store.load_block_meta(first.height).block_id:
                    raise AssertionError(f"block {first.height}'s id differs from its stored meta")
                t0 = time.perf_counter()
                vals = state_store.load_validators(first.height)
                vals_ms[first.height] = _ms(t0)
                sets[first.height] = vals
                seq = next_seq(rec)
                t0 = time.perf_counter()
                vals.verify_commit(CHAIN_ID, first_id, first.height, second.last_commit)
                ms = _ms(t0)
                evs = rec.events(since=seq, kinds=["verify.table", "verify.dispatch"])
                checks.append({"height": first.height, "ms": ms, "id": first_id,
                               "hit": [e["hit"] for e in evs if e["kind"] == "verify.table"],
                               "disp": [e for e in evs if e["kind"] == "verify.dispatch"]})
                proc.pop_processed()
                sched.block_processed(first.height)
        wall_a = time.perf_counter() - t_a
        launches_a = {k: v - before[k] for k, v in counters().items()}
        for h in range(1, REPLAY_TOP + 1):
            log(f"    block {h}: store write {write_ms[h]:.3f} ms, load_block (sqlite + unseal + decode) "
                f"{load_ms[h]:.3f} ms" + (f", hash with its part set {hash_ms[h]:.3f} ms, "
                                         f"load_validators {vals_ms[h]:.3f} ms" if h in hash_ms else "")
                + f" ({card})")
        for c in checks:
            d = c["disp"][-1] if c["disp"] else {}
            log(f"    verify_commit {c['height']}: {c['ms']:.3f} ms, path={d.get('path')} "
                f"host_prep_ms={d.get('host_prep_ms')} device_ms={d.get('device_ms')}, table "
                f"{'hit' if c['hit'] == [True] else 'miss'} ({card})")
        for b in builds:
            log(f"    new set ({'B' if b['epoch'] else 'A'}, {b['validators']} validators): host rows "
                f"(decompression and upload) {b['rows_ms']:.3f} ms, window tables (kernel 2) "
                f"{'not built' if b['build_ms'] is None else format(b['build_ms'], '.3f') + ' ms'} ({card})")
        hits = [h for c in checks for h in c["hit"]]
        log(f"  (a) per pair: {len(checks)} checks, tables hit {hits.count(True)} / missed "
            f"{hits.count(False)}, {len(checks)} blocks in {wall_a * 1000:.3f} ms = "
            f"{len(checks) / wall_a:.3f} blocks/s (loads and checks; signing apart); launches "
            f"{launches_a}; {card_memory(dev, cache)} ({card})")
        if [c["height"] for c in checks] != list(range(1, REPLAY_TOP)) or proc.height != REPLAY_TOP \
                or sched.height != REPLAY_TOP or not sched.only_tip_outstanding():
            raise AssertionError("the processor or scheduler did not step through every pair")
        if any(len(c["hit"]) != 1 for c in checks) or hits.count(False) != 2 \
                or [c["height"] for c in checks if c["hit"] == [False]] != [1, REPLAY_ROTATE_AT]:
            raise AssertionError(f"table hits and misses differ from 2 misses at 1 and "
                                 f"{REPLAY_ROTATE_AT}: {[c['hit'] for c in checks]}")
        for h in range(2, REPLAY_TOP):
            same_set = (h < REPLAY_ROTATE_AT) == (h - 1 < REPLAY_ROTATE_AT)
            if (sets[h].pubkeys_digest() == sets[h - 1].pubkeys_digest()) != same_set:
                raise AssertionError(f"load_validators({h}) has the wrong members")

        # (b) cross-height: one verify_commit_run per set, the commits in one flat batch
        runs = [(1, REPLAY_ROTATE_AT - 1), (REPLAY_ROTATE_AT, REPLAY_TOP - 1)]
        run_pairs = {lo: [(c["id"], c["height"], loaded[c["height"] + 1].last_commit)
                          for c in checks if lo <= c["height"] <= hi] for lo, hi in runs}
        for lo, hi in runs:
            pairs = run_pairs[lo]
            n_sigs = sum(len(p[2].signatures) for p in pairs)
            seq = next_seq(rec)
            t0 = time.perf_counter()
            ok = verify_commit_run(sets[lo], CHAIN_ID, pairs)
            ms = _ms(t0)
            d = rec.events(since=seq, kinds=["verify.dispatch"])
            rest = ms - sum(e["host_prep_ms"] + e["device_ms"] for e in d)
            log(f"  (b) verify_commit_run heights {lo}-{hi}: {n_sigs} signatures in {ms:.3f} ms = "
                f"{n_sigs / ms * 1000:.1f} signatures/s, verdicts {ok}; dispatches "
                f"{[(e['path'], e['n'], e['host_prep_ms'], e['device_ms']) for e in d]}, host "
                f"outside prep and dispatch (validate_basic, sign-bytes) {rest:.3f} ms ({card})")
            if ok != [True] * len(pairs) or [e["n"] for e in d] != [n_sigs]:
                raise AssertionError(f"verify_commit_run {lo}-{hi} did not verify in one flat batch")

        # (c) a copy of block REPLAY_BAD whose last_commit has one flipped signature
        good = loaded[REPLAY_BAD].last_commit
        bad_i = REPLAY_BAD_SIG % len(good.signatures)
        sigs = list(good.signatures)
        flipped = bytearray(sigs[bad_i].signature)
        flipped[0] ^= 1
        sigs[bad_i] = dataclasses.replace(sigs[bad_i], signature=bytes(flipped))
        bad = Block(loaded[REPLAY_BAD].header, loaded[REPLAY_BAD].txs, loaded[REPLAY_BAD].evidence,
                    Commit(good.height, good.round, good.block_id, sigs))
        h = REPLAY_BAD - 1
        proc = Processor(h)
        proc.add_block(h, loaded[h], "store")
        proc.add_block(REPLAY_BAD, bad, "store")
        first, second = proc.peek_two()
        want = f"wrong signature (#{bad_i}): {bytes(flipped).hex()}"
        try:
            sets[h].verify_commit(CHAIN_ID, checks[h - 1]["id"], h, second.last_commit)
            raise AssertionError("a commit with a flipped signature verified")
        except ValueError as e:
            if str(e) != want:
                raise
            dropped = proc.drop_invalid()
        pairs = [p if p[1] != h else (p[0], h, bad.last_commit) for p in run_pairs[1]]
        ok = verify_commit_run(sets[1], CHAIN_ID, pairs)
        log(f"  (c) flipped signature #{bad_i} in the commit for {h}: per pair raised ValueError "
            f"'{want[:40]}...', drop_invalid {dropped}; verify_commit_run {ok} ({card})")
        if dropped != (h, REPLAY_BAD) or ok != [p[1] != h for p in pairs]:
            raise AssertionError("the fault case's dropped heights or run verdicts differ")
        log(f"  StorageHealth after the replay: {health.total_faults()} faults, "
            f"{health.free_bytes()} bytes free on the store's disk")
        if health.total_faults() or block_store.quarantined():
            raise AssertionError("the replay's block store noted a fault")
        batch_hook.set_verifier(None)
        batch_hook.set_indexed_verifier(None)
        state_db.close()
        block_db.close()
    finally:
        tmp.cleanup()
    return launches_a


class StepTimer:
    """Host ms of named steps: `wrap` replaces an object's method (sync or
    async) by one that adds each call's wall time to ms[name] and counts it
    in n[name], or under (name, height) with `height_of`, which reads the
    height from the call's arguments."""

    def __init__(self):
        self.ms = collections.defaultdict(float)
        self.n = collections.defaultdict(int)

    def add(self, name, t0):
        self.ms[name] += _ms(t0)
        self.n[name] += 1

    def wrap(self, obj, attr, name=None, height_of=None):
        """Returns the method it replaced."""
        import asyncio
        import functools

        fn, name = getattr(obj, attr), name or attr

        def key(a, k):
            return name if height_of is None else (name, height_of(*a, **k))

        if asyncio.iscoroutinefunction(fn):
            @functools.wraps(fn)
            async def timed(*a, **k):
                t0 = time.perf_counter()
                try:
                    return await fn(*a, **k)
                finally:
                    self.add(key(a, k), t0)
        else:
            @functools.wraps(fn)
            def timed(*a, **k):
                t0 = time.perf_counter()
                try:
                    return fn(*a, **k)
                finally:
                    self.add(key(a, k), t0)
        setattr(obj, attr, timed)
        return fn

    def reset(self) -> None:
        self.ms.clear()
        self.n.clear()

    def split(self) -> str:
        """apply_block's host ms by step since the last split; resets."""
        t, n = dict(self.ms), dict(self.n)
        self.reset()
        g = t.get
        abci = sum(g(k, 0.0) for k in ("begin_block", "deliver_tx", "end_block", "commit_abci"))
        return (f"apply_block {g('apply_block', 0.0):.3f} ms = validate_block "
                f"{g('validate_block', 0.0):.3f} (verify_commit {g('verify_commit', 0.0):.3f}) "
                f"+ ABCI {abci:.3f} (BeginBlock {g('begin_block', 0.0):.3f}, DeliverTx x"
                f"{n.get('deliver_tx', 0)} {g('deliver_tx', 0.0):.3f}, EndBlock "
                f"{g('end_block', 0.0):.3f}, Commit {g('commit_abci', 0.0):.3f}) + mempool update "
                f"with recheck {g('mempool_update', 0.0):.3f} + state save {g('state_save', 0.0):.3f}"
                f" + events {g('events', 0.0):.3f}; index drain {g('index_drain', 0.0):.3f} ms")


@contextlib.contextmanager
def verify_commit_timing(timer):
    """ValidatorSet.verify_commit's wall time into the timer's
    "verify_commit" step while the block runs."""
    from tendermint_tpu_torch.types.validator import ValidatorSet

    orig = ValidatorSet.verify_commit

    def timed(self, *a, **k):
        t0 = time.perf_counter()
        try:
            return orig(self, *a, **k)
        finally:
            timer.add("verify_commit", t0)

    ValidatorSet.verify_commit = timed
    try:
        yield
    finally:
        ValidatorSet.verify_commit = orig


def abci_traffic(keys, new_keys, top=None):
    """Phase 8's transactions, made in bulk before the run: per height
    1 .. top (ABCI_TOP), ABCI_TXS signed-tx envelopes (payload "k<h>-<i>="
    and 32 seeded random bytes in hex, signed by the validator keys in
    turn), every ABCI_CORRUPT-th with a flipped signature byte; and the
    rotation's val: txs, removing the len(new_keys) oldest keys and adding
    new_keys at power 10."""
    import base64
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np

    from tendermint_tpu_torch.mempool import SIGNED_TX_PREFIX, make_signed_tx

    rng = np.random.default_rng(8)
    jobs = [(h, i, keys[((h - 1) * ABCI_TXS + i) % len(keys)],
             b"k%d-%d=" % (h, i) + rng.bytes(32).hex().encode())
            for h in range(1, (top or ABCI_TOP) + 1) for i in range(ABCI_TXS)]
    with ThreadPoolExecutor(SIGN_THREADS) as ex:
        envelopes = list(ex.map(lambda j: make_signed_tx(j[2], j[3]), jobs, chunksize=256))
    bursts, bad = collections.defaultdict(list), set()
    off = len(SIGNED_TX_PREFIX) + 32  # the signature's first byte
    for (h, i, _, _), tx in zip(jobs, envelopes):
        if i % ABCI_CORRUPT == ABCI_CORRUPT - 1:
            tx = tx[:off] + bytes([tx[off] ^ 1]) + tx[off + 1:]
            bad.add(tx)
        bursts[h].append(tx)
    val_txs = ([b"val:" + base64.b64encode(k.pub_key().bytes()) + b"!0"
                for k in keys[:len(new_keys)]]
               + [b"val:" + base64.b64encode(k.pub_key().bytes()) + b"!10" for k in new_keys])
    return bursts, bad, val_txs


async def abci_node(home, gen, app_db=None):
    """A node's stores, app and services in `home` (sqlite), wired as
    node.py wires them: StateStore, BlockStore, a KVStoreApplication
    behind AppConns(local_client_creator(app)), an EventBus with an
    IndexerService over a TxIndexer and one subscriber each on NewBlock and
    Tx, then the Handshaker (InitChain at app height 0), timed.  `app_db`
    puts the app on another store than the node's.  The namespace's close()
    stops the services and closes the stores."""
    import asyncio
    import types

    from tendermint_tpu_torch.abci.examples import KVStoreApplication
    from tendermint_tpu_torch.consensus import Handshaker
    from tendermint_tpu_torch.libs.kvstore import open_db
    from tendermint_tpu_torch.proxy import AppConns, local_client_creator
    from tendermint_tpu_torch.state import StateStore
    from tendermint_tpu_torch.state.txindex import IndexerService, TxIndexer
    from tendermint_tpu_torch.store import BlockStore
    from tendermint_tpu_torch.types.events import (EVENT_NEW_BLOCK, EVENT_TX, EventBus,
                                                   query_for_event)
    from tendermint_tpu_torch.types.tx import tx_hash

    node = types.SimpleNamespace(events={"NewBlock": [], "Tx": []})
    node.dbs = {name: open_db(name, home)
                for name in ("state", "blockstore", "app", "evidence", "txindex")}
    node.state_store = StateStore(node.dbs["state"])
    node.block_store = BlockStore(node.dbs["blockstore"])
    node.app = KVStoreApplication(db=node.dbs["app"] if app_db is None else app_db)
    node.conns = AppConns(local_client_creator(node.app))
    node.bus = EventBus()
    node.indexer = TxIndexer(node.dbs["txindex"])
    node.svc = IndexerService(node.indexer, node.bus)
    await node.conns.start()
    await node.bus.start()
    await node.svc.start()
    buffer = 2 * (ABCI_TXS + 2 * ABCI_ROTATE)  # drained after every block
    node.subs = {kind: await node.bus.subscribe("chip-smoke", query_for_event(q), buffer)
                 for kind, q in (("NewBlock", EVENT_NEW_BLOCK), ("Tx", EVENT_TX))}
    node.handshaker = Handshaker(node.state_store, node.state_store.load_from_db_or_genesis(gen),
                                 node.block_store, gen)
    t0 = time.perf_counter()
    node.state = await node.handshaker.handshake(node.conns)
    node.handshake_ms = _ms(t0)

    async def settle(block):
        """Drain the subscribers and wait (bounded) until the
        IndexerService has indexed the block's last tx."""
        for kind, sub in node.subs.items():
            if sub.cancelled:
                raise AssertionError(f"the {kind} subscription was cancelled: {sub.cancel_reason}")
            while not sub.queue.empty():
                node.events[kind].append(sub.queue.get_nowait().data.data)
        for _ in range(100_000):
            if not block.txs or node.indexer.get(tx_hash(block.txs[-1])) is not None:
                return
            await asyncio.sleep(0)
        raise AssertionError(f"the indexer did not catch up with block {block.height}")

    async def close():
        await node.svc.stop()
        await node.bus.stop()
        await node.conns.stop()
        for db in node.dbs.values():
            db.close()

    node.settle, node.close = settle, close
    return node


def instrument(timer, executor, node):
    """Time apply_block's steps on this executor and node."""
    timer.wrap(executor, "apply_block")
    timer.wrap(executor, "validate_block")
    timer.wrap(executor, "_fire_events", "events")
    timer.wrap(executor.mempool, "update", "mempool_update")
    timer.wrap(node.state_store, "save", "state_save")
    client = node.conns.consensus()
    for attr in ("begin_block", "deliver_tx", "end_block"):
        timer.wrap(client, attr)
    timer.wrap(client, "commit", "commit_abci")


async def check_burst(mempool, txs):
    """check_tx of every tx at once (asyncio.gather): per tx its outcome
    (the response, or the exception) and its latency in ms, and the
    burst's wall ms."""
    import asyncio

    t_start = time.perf_counter()

    async def one(tx):
        try:
            res = await mempool.check_tx(tx)
        except Exception as e:  # noqa: BLE001 - every outcome is checked by the caller
            res = e
        return res, _ms(t_start)

    out = await asyncio.gather(*(one(tx) for tx in txs))
    return out, _ms(t_start)


def dispatch_share(rec, seq, wall_s) -> str:
    """The engine's dispatches since `seq`: count, host prep and device ms
    (host clock) and their share of `wall_s`, an upper bound on the card's
    busy share."""
    d = rec.events(since=seq, kinds=["verify.dispatch"])
    prep = sum(e["host_prep_ms"] for e in d)
    device = sum(e["device_ms"] for e in d)
    return (f"{len(d)} dispatches, host prep {prep:.3f} ms, dispatch {device:.3f} ms "
            f"({device / (wall_s * 1000) * 100:.3f} % of the wall time)")


def phase_abci(keys, card, dev):
    """Blocks applied to the kvstore app (see the module docstring, 8).
    Returns the launches of (a), its signed-tx flushes, (b) and (c3), by
    counter."""
    import asyncio

    return asyncio.run(abci_run(keys, card, dev))


async def abci_run(keys, card, dev):
    import tempfile

    from tendermint_tpu_torch.crypto import batch as batch_hook
    from tendermint_tpu_torch.crypto import batch_verifier as bvm
    from tendermint_tpu_torch.evidence import EvidencePool
    from tendermint_tpu_torch.fastsync import Processor, Scheduler
    from tendermint_tpu_torch.libs.kvstore import MemDB, open_db
    from tendermint_tpu_torch.libs.tracing import FlightRecorder
    from tendermint_tpu_torch.mempool import Mempool, MempoolError
    from tendermint_tpu_torch.ops import ed25519_cuda, ed25519_table
    from tendermint_tpu_torch.state.execution import BlockExecutor, tx_pre_check
    from tendermint_tpu_torch.store import BlockStore
    from tendermint_tpu_torch.types.block import BlockID
    from tendermint_tpu_torch.types.genesis import GenesisDoc, GenesisValidator
    from tendermint_tpu_torch.types.params import BLOCK_PART_SIZE_BYTES

    def counters():
        return {"ed25519_ladder": ed25519_cuda.LAUNCHES,
                "ed25519_window_tables": ed25519_table.BUILD_LAUNCHES,
                "ed25519_tabulated": ed25519_table.SUM_LAUNCHES}

    def since(before):
        return {k: v - before[k] for k, v in counters().items()}

    t0 = time.perf_counter()
    new_keys = make_keys(ABCI_ROTATE, prefix="abci")
    bursts, bad, val_txs = abci_traffic(keys, new_keys)
    key_of = {k.pub_key().address(): k for k in list(keys) + list(new_keys)}
    gen = GenesisDoc(CHAIN_ID, genesis_time_ns=LITE_T0, validators=[
        GenesisValidator(k.pub_key().address(), k.pub_key(), 10) for k in keys])
    log(f"  traffic: {ABCI_TOP} bursts of {ABCI_TXS} signed envelopes ({len(bad)} corrupted), "
        f"{len(val_txs)} val: txs at height {ABCI_ROTATE_AT}, {len(new_keys)} new keys; made in "
        f"{(time.perf_counter() - t0) * 1000:.3f} ms")

    rec = FlightRecorder(size=1 << 16)
    commit_bv = bvm.BatchVerifier(device=dev, recorder=rec).install()
    cache = bvm.TableCache(commit_bv, tabulated=None).install()
    # the mempool's lane: the node's engine settings on its own verifier, so
    # that its warmup mode leaves the commit checks' table builds synchronous
    lane = bvm.AsyncBatchVerifier(bvm.BatchVerifier(device=dev, min_device_batch=16,
                                                    recorder=rec))
    tmp = tempfile.TemporaryDirectory(prefix="chip-smoke-abci-")
    producer = syncer = None
    try:
        await lane.start()
        # (a) the producer
        producer = await abci_node(os.path.join(tmp.name, "producer"), gen)
        state = producer.state
        mempool = Mempool(producer.conns.mempool(), {"sig_precheck": True, "size": ABCI_MEMPOOL})
        mempool.pre_check = tx_pre_check(state)
        mempool.sig_verifier = lane
        evpool = EvidencePool(producer.dbs["evidence"], producer.state_store, state)
        executor = BlockExecutor(producer.state_store, producer.conns.consensus(), mempool,
                                 evpool, producer.bus)
        timer = StepTimer()
        instrument(timer, executor, producer)
        before_a, seq_a, t_a = counters(), next_seq(rec), time.perf_counter()
        flush_launches = dict.fromkeys(before_a, 0)
        rejected, blocks, parts, commits, states, app_hashes = [], {}, {}, {}, {}, {}
        table_hits = {}
        sign_s, wall_a = 0.0, 0.0

        async def submit(h):
            txs = list(bursts[h]) + (list(val_txs) if h == ABCI_ROTATE_AT else [])
            before = counters()
            seq = next_seq(rec)
            out, ms = await check_burst(mempool, txs)
            for k, v in since(before).items():
                flush_launches[k] += v
            lat = [lat for _, lat in out]
            for tx, (res, _) in zip(txs, out):
                if tx in bad:
                    if not (isinstance(res, MempoolError) and str(res) == "invalid tx signature"):
                        raise AssertionError(f"a corrupted envelope at {h} gave {res!r}")
                    rejected.append(tx)
                elif isinstance(res, Exception) or res.code != 0:
                    raise AssertionError(f"a valid tx at {h} was rejected: {res!r}")
            flushes = [e["batch"] for e in rec.events(since=seq, kinds=["verify.flush"])]
            log(f"    burst {h}: {len(txs)} check_tx in {ms:.3f} ms = {len(txs) / ms * 1000:.1f} "
                f"txs/s, latency p50 {percentile(lat, 50):.3f} ms p99 {percentile(lat, 99):.3f} ms, "
                f"verify.flush sizes {flushes}, pool {mempool.size()} ({card})")

        await submit(1)
        with verify_commit_timing(timer):
            last_commit = None
            for h in range(1, ABCI_TOP + 1):
                t_h = time.perf_counter()
                block = executor.create_proposal_block(h, state, last_commit,
                                                       state.validators.get_proposer().address)
                part_set = block.make_part_set(BLOCK_PART_SIZE_BYTES)
                bid = BlockID(block.hash(), part_set.header())
                made_ms = _ms(t_h)
                t0 = time.perf_counter()
                commit = sign_commit(state.validators, key_of, h, bid, block.time_ns + SEC)
                sign_s += time.perf_counter() - t0
                t0 = time.perf_counter()
                producer.block_store.save_block(block, part_set, commit)
                save_ms = _ms(t0)
                wall_a += made_ms / 1000 + save_ms / 1000
                if h < ABCI_TOP:  # the next burst arrives while this block commits
                    await submit(h + 1)
                seq = next_seq(rec)
                t0 = time.perf_counter()
                state, _ = await executor.apply_block(state, bid, block)
                t1 = time.perf_counter()
                await producer.settle(block)
                timer.add("index_drain", t1)
                wall_a += time.perf_counter() - t0
                blocks[h], parts[h], commits[h] = block, part_set, commit
                app_hashes[h] = producer.app.app_hash
                if h in (ABCI_ROTATE_AT, ABCI_ROTATE_AT + 1, ABCI_TOP - 1, ABCI_TOP):
                    states[h] = state.to_dict()
                table_hits[h] = [e["hit"] for e in rec.events(since=seq, kinds=["verify.table"])]
                log(f"    block {h}: {len(block.txs)} txs, create_proposal_block {made_ms:.3f} ms, "
                    f"save_block {save_ms:.3f} ms, table {table_hits[h]}; {timer.split()} ({card})")
                last_commit = commit
        launches_a = since(before_a)
        n_txs = sum(len(b.txs) for b in blocks.values())
        log(f"  (a) producer: {ABCI_TOP} blocks, {n_txs} txs in {wall_a * 1000:.3f} ms = "
            f"{ABCI_TOP / wall_a:.3f} blocks/s (signing {sign_s * 1000:.3f} ms and the bursts "
            f"apart); over all of (a), with signing and the bursts, "
            f"{dispatch_share(rec, seq_a, time.perf_counter() - t_a)}; "
            f"launches {launches_a}, of which the signed-tx flushes {flush_launches}; "
            f"{len(producer.events['NewBlock'])} NewBlock and {len(producer.events['Tx'])} Tx "
            f"events; pool {mempool.size()} ({card})")
        in_blocks = [tx for b in blocks.values() for tx in b.txs]
        if len(rejected) != len(bad) or set(rejected) & set(in_blocks):
            raise AssertionError("a corrupted envelope reached a block, or was not rejected")
        for h, b in blocks.items():
            want = {tx for tx in bursts[h] if tx not in bad}
            if h == ABCI_ROTATE_AT:
                want |= set(val_txs)
            if set(b.txs) != want or len(b.txs) != len(want):
                raise AssertionError(f"block {h} does not hold exactly burst {h}'s valid txs")
        if mempool.size() != 0:
            raise AssertionError(f"{mempool.size()} txs left in the pool")
        if len(producer.events["NewBlock"]) != ABCI_TOP or len(producer.events["Tx"]) != n_txs:
            raise AssertionError("the producer's NewBlock or Tx events differ from its blocks")
        # states[h] holds the set of height h + 1: A until ABCI_ROTATE_AT + 1, B from + 2
        # (kept at the heights compared below: the rotation, the syncer's top, the tip)
        set_of = {h: {v["address"] for v in states[h]["validators"]["validators"]} for h in states}
        old, new = keys[0].pub_key().address(), new_keys[0].pub_key().address()
        if not (old in set_of[ABCI_ROTATE_AT] and new not in set_of[ABCI_ROTATE_AT]
                and old not in set_of[ABCI_ROTATE_AT + 1] and new in set_of[ABCI_ROTATE_AT + 1]):
            raise AssertionError(f"set B does not serve from height {ABCI_ROTATE_AT + 2}")
        misses = [h for h, hits in table_hits.items() if False in hits]
        if misses != [2, ABCI_ROTATE_AT + 3]:
            raise AssertionError(f"the commit checks missed the table cache at {misses}, not at 2 "
                                 f"(set A) and {ABCI_ROTATE_AT + 3} (set B)")
        probe = ABCI_TOP // 2 + 1
        found = producer.indexer.search(f"tx.height={probe}", limit=1 << 20)
        if [r["tx"] for r in sorted(found, key=lambda r: r["index"])] != list(blocks[probe].txs):
            raise AssertionError(f"search(tx.height={probe}) differs from block {probe}'s txs")
        log(f"  search(\"tx.height={probe}\"): {len(found)} txs, block {probe}'s in order")

        # (b) a syncing node: fast sync's steps by hand (fastsync/reactor.py _try_sync)
        syncer = await abci_node(os.path.join(tmp.name, "syncer"), gen)
        state_b = syncer.state
        mempool_b = Mempool(syncer.conns.mempool(), {"size": ABCI_MEMPOOL})
        executor_b = BlockExecutor(syncer.state_store, syncer.conns.consensus(), mempool_b,
                                   EvidencePool(syncer.dbs["evidence"], syncer.state_store,
                                                state_b), syncer.bus)
        timer_b = StepTimer()
        instrument(timer_b, executor_b, syncer)
        proc, sched = Processor(1), Scheduler(1)
        sched.set_peer_range("producer", 1, ABCI_TOP)
        for peer, h in sched.next_requests(0.0):
            sched.mark_requested(peer, h, 0.0)
        for h in range(1, ABCI_TOP + 1):
            block = producer.block_store.load_block(h)
            if block is None or block.hash() != blocks[h].hash() or not sched.block_received(
                    "producer", h):
                raise AssertionError(f"block {h} did not load back from the producer's store")
            proc.add_block(h, block, "producer")
        before_b, seq_b = counters(), next_seq(rec)
        t_b = time.perf_counter()
        with verify_commit_timing(timer_b):
            while (pair := proc.peek_two()) is not None:
                first, second = pair
                t0 = time.perf_counter()
                first_parts = first.make_part_set(BLOCK_PART_SIZE_BYTES)
                first_id = BlockID(first.hash(), first_parts.header())
                state_b.validators.verify_commit(CHAIN_ID, first_id, first.height,
                                                 second.last_commit)
                pair_ms = _ms(t0)
                timer_b.reset()  # the split below is apply_block's alone
                t0 = time.perf_counter()
                syncer.block_store.save_block(first, first_parts, second.last_commit)
                save_ms = _ms(t0)
                state_b, _ = await executor_b.apply_block(state_b, first_id, first)
                t1 = time.perf_counter()
                await syncer.settle(first)
                timer_b.add("index_drain", t1)
                proc.pop_processed()
                sched.block_processed(first.height)
                log(f"    synced {first.height}: pair check {pair_ms:.3f} ms, save_block "
                    f"{save_ms:.3f} ms; {timer_b.split()} ({card})")
        wall_b = time.perf_counter() - t_b
        launches_b = since(before_b)
        top_b = ABCI_TOP - 1
        log(f"  (b) syncer: {top_b} blocks in {wall_b * 1000:.3f} ms = {top_b / wall_b:.3f} "
            f"blocks/s (pair check, save, apply); {dispatch_share(rec, seq_b, wall_b)}; "
            f"launches {launches_b}; "
            f"{len(syncer.events['NewBlock'])} NewBlock and {len(syncer.events['Tx'])} Tx events; "
            f"{card_memory(dev, cache)} ({card})")
        if state_b.last_block_height != top_b or not sched.only_tip_outstanding():
            raise AssertionError("the syncer did not stop with only the tip pending")
        if state_b.to_dict() != states[top_b] or syncer.app.app_hash != app_hashes[top_b]:
            raise AssertionError(f"the syncer's state or app hash at {top_b} differs")
        n_txs_b = sum(len(blocks[h].txs) for h in range(1, top_b + 1))
        if len(syncer.events["NewBlock"]) != top_b or len(syncer.events["Tx"]) != n_txs_b:
            raise AssertionError("the syncer's NewBlock or Tx events differ from its blocks")
        for h in range(1, top_b + 1):
            q = f"tx.height={h}"
            if syncer.indexer.search(q, limit=1 << 20) != producer.indexer.search(q, limit=1 << 20):
                raise AssertionError(f"the tx indexes answer {q} differently")
        await syncer.close()
        syncer = None

        # (c) restarts of the syncer's node, its stores reopened
        home_b = os.path.join(tmp.name, "syncer")

        async def restart(name, what, want_blocks, want_h, app_db=None):
            before = counters()
            node = await abci_node(home_b, gen, app_db)
            try:
                launches = since(before)
                got = (node.handshaker.n_blocks, node.state.to_dict(), node.app.app_hash)
                log(f"  ({name}) handshake, {what}: {got[0]} blocks replayed in "
                    f"{node.handshake_ms:.3f} ms, app at {node.app.height}; launches {launches} "
                    f"({card})")
            finally:
                await node.close()
            if got != (want_blocks, states[want_h], app_hashes[want_h]):
                raise AssertionError(f"({name}): replayed {got[0]} blocks, or the state or app "
                                     f"hash differs from the producer's at {want_h}")
            return launches

        await restart("c1", f"the syncer's own app at {top_b}", 0, top_b)
        await restart("c2", "a fresh app (InitChain, then every block without signature checks)",
                      top_b, top_b, MemDB())
        db = open_db("blockstore", home_b)
        try:  # the tip saved with its seen commit, not applied
            BlockStore(db).save_block(blocks[ABCI_TOP], parts[ABCI_TOP], commits[ABCI_TOP])
        finally:
            db.close()
        launches_c3 = await restart("c3", f"block {ABCI_TOP} stored but not applied "
                                    "(apply_block, validate_block)", 1, ABCI_TOP)
        await producer.close()
        producer = None
    finally:
        for node in (producer, syncer):
            if node is not None:
                await node.close()
        await lane.stop()
        batch_hook.set_verifier(None)
        batch_hook.set_indexed_verifier(None)
        tmp.cleanup()
    return {"a": launches_a, "flushes": flush_launches, "b": launches_b, "c3": launches_c3}


CS_HEIGHTS = 6  # heights 1 .. 6 commit; the run stops at height 7's NEW_HEIGHT
CS_OURS_AT = 3  # our validator is this height's round-0 proposer
CS_WITHHELD_AT = 4  # the round-0 proposer withholds its proposal; round 1 commits
CS_CRASH_AT = 6  # the node stops after its own precommit and recovers from its WAL
CS_FRAME_BYTES = 65536  # a vote_batch frame's cap of Vote.wire() bytes
CS_SENDERS = 4  # peers relaying vote frames, each under a fixed peer id
CS_DIRECT_MIN = 16  # frames this large go through verify_direct (the reactor's rule)


class CsWatch:
    """Hooks on one node's ConsensusState, FilePV and EventBus: the time of
    every step, of each vote our FilePV signs (with the signed vote) and of
    each completed proposal block, and an event the phase waits on."""

    def __init__(self, node):
        import asyncio

        self.node = node
        self.steps = []  # (t, height, round, step)
        self.signed = {}  # (height, round, type) -> (t, the signed vote's dict)
        self.complete = {}  # (height, round) -> t
        self.ev = asyncio.Event()
        node.cs.on_new_round_step.append(self._step)
        node.cs.on_vote.append(lambda vote: self.ev.set())
        sign = node.pv.sign_vote

        def sign_vote(chain_id, vote):
            sign(chain_id, vote)
            self.signed.setdefault((vote.height, vote.round, vote.type),
                                   (time.perf_counter(), vote.to_dict()))
            self.ev.set()

        node.pv.sign_vote = sign_vote
        publish = node.bus.publish_complete_proposal

        async def complete(rs):
            self.complete.setdefault((rs["height"], rs["round"]), time.perf_counter())
            await publish(rs)

        node.bus.publish_complete_proposal = complete

    def _step(self, rs):
        self.steps.append((time.perf_counter(), rs.height, rs.round, rs.step))
        self.ev.set()

    def at(self, h, r, step):
        rs = self.node.cs.rs
        return (rs.height, rs.round, rs.step) >= (h, r, step)

    def t(self, h, r, step):
        return next(t for t, *hrs in self.steps if tuple(hrs) == (h, r, step))

    async def until(self, cond, what, timeout=300.0):
        """Wait, woken by the hooks, until cond() holds; fail when consensus
        stopped or after `timeout` s."""
        import asyncio

        deadline = time.perf_counter() + timeout
        while not cond():
            cs = self.node.cs
            if cs._done.is_set():
                raise AssertionError(f"consensus stopped while waiting for {what}")
            if time.perf_counter() > deadline:
                raise AssertionError(f"timed out waiting for {what} at {cs.rs.height}/"
                                     f"{cs.rs.round}/{cs.rs.step}")
            self.ev.clear()
            try:
                await asyncio.wait_for(self.ev.wait(), 0.05)
            except asyncio.TimeoutError:
                pass


@contextlib.contextmanager
def consensus_errors(names=("consensus", "consensus-replay")):
    """ERROR records of the named loggers (the consensus ones by default)
    while the block runs."""
    import logging

    class Keep(logging.Handler):
        def __init__(self):
            super().__init__(logging.ERROR)
            self.records = []

        def emit(self, record):
            self.records.append(record.getMessage())

    keep = Keep()
    loggers = [logging.getLogger(n) for n in names]
    for lg in loggers:
        lg.addHandler(keep)
    try:
        yield keep.records
    finally:
        for lg in loggers:
            lg.removeHandler(keep)


async def cs_node(home, gen, lane, timer):
    """Phase 9's validator node in `home`: phase 8's abci_node (sqlite
    stores, the kvstore app, EventBus, IndexerService, the handshake), a
    Mempool whose signed-tx lane is `lane`, an EvidencePool, a BlockExecutor
    (validate_block, apply_block and save_block timed by height), the FilePV
    from <home>/config and <home>/data, and a ConsensusState at the JAX
    defaults with its TimeoutTicker and the WAL at <home>/data/cs.wal/wal,
    instrumented by instrument_cs."""
    from tendermint_tpu_torch.config import ConsensusConfig
    from tendermint_tpu_torch.consensus import WAL, ConsensusState
    from tendermint_tpu_torch.evidence import EvidencePool
    from tendermint_tpu_torch.mempool import Mempool
    from tendermint_tpu_torch.privval import FilePV
    from tendermint_tpu_torch.state.execution import BlockExecutor, tx_pre_check

    node = await abci_node(home, gen)
    state = node.state
    node.mempool = Mempool(node.conns.mempool(), {"sig_precheck": True, "size": ABCI_MEMPOOL},
                           height=state.last_block_height)
    node.mempool.pre_check = tx_pre_check(state)
    node.mempool.sig_verifier = lane
    node.evpool = EvidencePool(node.dbs["evidence"], node.state_store, state)
    node.executor = BlockExecutor(node.state_store, node.conns.consensus(), node.mempool,
                                  node.evpool, node.bus)
    timer.wrap(node.executor, "validate_block", height_of=lambda s, b: b.height)
    timer.wrap(node.executor, "apply_block", height_of=lambda s, bid, b: b.height)
    timer.wrap(node.block_store, "save_block", height_of=lambda b, parts, c: b.height)
    t0 = time.perf_counter()
    node.cs = ConsensusState(ConsensusConfig(), state, node.executor, node.block_store,
                             node.mempool, node.evpool, node.bus)
    node.init_ms = _ms(t0)  # with reconstruct_last_commit_if_needed
    node.pv = FilePV.load(os.path.join(home, "config", "priv_validator_key.json"),
                          os.path.join(home, "data", "priv_validator_state.json"))
    node.cs.set_priv_validator(node.pv)
    node.cs.wal = WAL(os.path.join(home, "data", "cs.wal", "wal"))
    instrument_cs(node)
    return node


def instrument_cs(node):
    """Time `node.cs`'s _try_add_vote and WAL writes per call (node.add_ms,
    node.wal_ms), count in node.late[h] height h's precommits that arrive
    after height h + 1's round began (refused by _add_vote as "not a
    LastCommit straggler"), and put a CsWatch on node.cs, node.pv and
    node.bus."""
    from tendermint_tpu_torch.consensus.types import RoundStep

    node.add_ms, node.wal_ms = [], [0.0]
    node.late = collections.Counter()
    add, rs, write = node.cs._try_add_vote, node.cs.rs, node.cs.wal.write

    async def try_add_vote(vote, *a, **k):
        if vote.height + 1 == rs.height and rs.step != RoundStep.NEW_HEIGHT:
            node.late[vote.height] += 1
        t0 = time.perf_counter()
        try:
            return await add(vote, *a, **k)
        finally:
            node.add_ms.append(_ms(t0))

    def wal_write(payload):
        t0 = time.perf_counter()
        try:
            return write(payload)
        finally:
            node.wal_ms.append(_ms(t0))

    node.cs._try_add_vote, node.cs.wal.write = try_add_vote, wal_write
    node.watch = CsWatch(node)


def cs_votes(vals, key_of, ours_addr, kind, h, r, block, bid, iota_ns):
    """The other validators' votes of `kind` for (h, r) on bid (the zero id
    for nil), stamped as _vote_time stamps them, signed on SIGN_THREADS
    threads, with their wire bytes; and their sign bytes."""
    from concurrent.futures import ThreadPoolExecutor

    from tendermint_tpu_torch.types.vote import Vote

    now = time.time_ns()
    ts = max(now, block.time_ns + iota_ns) if block is not None else now
    votes = [Vote(kind, h, r, bid, ts, v.address, i) for i, v in enumerate(vals.validators)
             if v.address != ours_addr]
    msgs = [v.sign_bytes(CHAIN_ID) for v in votes]
    with ThreadPoolExecutor(SIGN_THREADS) as ex:
        sigs = list(ex.map(lambda j: key_of[j[0].validator_address].sign(j[1]),
                           zip(votes, msgs), chunksize=512))
    for v, s in zip(votes, sigs):
        v.signature = s
        v.wire()
    return votes, msgs


def cs_frames(vals, votes, msgs):
    """vote_batch frames as the consensus reactor cuts them: at most
    CS_FRAME_BYTES of Vote.wire() each; per frame its votes and the
    (pubkey, sign bytes, signature) items the engine verifies."""
    frames, cur, total = [], [], 0
    for v, m in zip(votes, msgs):
        w = len(v.wire())
        if cur and total + w > CS_FRAME_BYTES:
            frames.append(cur)
            cur, total = [], 0
        cur.append((v, m))
        total += w
    if cur:
        frames.append(cur)
    return [([v for v, _ in f],
             [(vals.validators[v.validator_index].pub_key.bytes(), m, v.signature) for v, m in f])
            for f in frames]


async def cs_verify(lane, items):
    """A frame's verdicts: verify_direct from CS_DIRECT_MIN votes on, else
    verify_many (consensus/reactor.py's rule)."""
    import asyncio

    if len(items) >= CS_DIRECT_MIN:
        return await lane.verify_direct(items)
    return list(await asyncio.gather(*lane.verify_many(items)))


async def cs_send(node, frames, bad=None):
    """The frames from CS_SENDERS peers at once, each verified before its
    votes go to add_vote_input(verified=True).  `bad` (a frame with one
    flipped signature) goes first from sender-0 and must get exactly one
    False; nothing of it enters, and its clean copy (frames[0]) is re-sent
    by sender-1.  Returns the frames' count and the first send's time."""
    import asyncio

    lane = node.mempool.sig_verifier
    t0 = time.perf_counter()
    if bad is not None:
        verdicts = await cs_verify(lane, bad)
        if verdicts.count(False) != 1:
            raise AssertionError(f"the frame with one flipped signature got {verdicts.count(False)} "
                                 "False verdicts, not 1")
    per = [frames[(k - 1) % CS_SENDERS::CS_SENDERS] for k in range(CS_SENDERS)]

    async def sender(k):
        for votes, items in per[k]:
            if not all(await cs_verify(lane, items)):
                raise AssertionError(f"a clean frame from sender-{k} was rejected")
            for v in votes:
                await node.cs.add_vote_input(v, f"sender-{k}", verified=True)

    await asyncio.gather(*(sender(k) for k in range(CS_SENDERS)))
    return t0


def cs_flip(frame, j=7):
    """A copy of a frame's items with one signature's first byte flipped."""
    items = list(frame[1])
    pk, m, s = items[j % len(items)]
    items[j % len(items)] = (pk, m, bytes([s[0] ^ 1]) + s[1:])
    return items


def cs_ingest_line(node, rec, seq, t_sent, t_done, n_votes, add0, wal0, card):
    """One vote kind's ingest: frames' verify split (p50/p99), the receive
    routine's Python per vote, wall ms."""
    d = [e for e in rec.events(since=seq, kinds=["verify.dispatch"])
         if e["path"] in ("device", "host", "host-cold")]
    slow = [e for e in d if e["path"] != "device" and e["n"] >= CS_DIRECT_MIN]
    if slow:
        raise AssertionError(f"vote frames of {slow[0]['n']} votes went to the {slow[0]['path']} "
                             "path")
    prep = [e["host_prep_ms"] for e in d]
    dev = [e["device_ms"] for e in d]
    add = node.add_ms[add0:]
    wal = sum(node.wal_ms[wal0:])
    return (f"{n_votes} votes in {len(d)} frames, {(t_done - t_sent) * 1000:.3f} ms; per frame "
            f"host_prep p50 {percentile(prep, 50):.3f} p99 {percentile(prep, 99):.3f} ms, device "
            f"p50 {percentile(dev, 50):.3f} p99 {percentile(dev, 99):.3f} ms; receive routine "
            f"_try_add_vote p50 {percentile(add, 50) * 1000:.1f} us, mean "
            f"{sum(add) / max(1, len(add)) * 1000:.1f} us + WAL write "
            f"{wal / max(1, n_votes) * 1000:.1f} us per vote ({card})")


def phase_consensus(keys, card, dev):
    """The consensus core at full width (see the module docstring, 9).
    Returns the phase's launches by counter, the validate_block calls on
    heights >= 2, the indexed dispatches and the accepted vote frames."""
    import asyncio

    return asyncio.run(cs_run(keys, card, dev))


async def cs_run(keys, card, dev):
    import tempfile

    from tendermint_tpu_torch.consensus.types import RoundStep
    from tendermint_tpu_torch.crypto import batch as batch_hook
    from tendermint_tpu_torch.crypto import batch_verifier as bvm
    from tendermint_tpu_torch.libs.tracing import FlightRecorder
    from tendermint_tpu_torch.mempool import MempoolError
    from tendermint_tpu_torch.ops import ed25519_cuda, ed25519_table
    from tendermint_tpu_torch.privval import FilePV, FilePVKey, FilePVLastSignState
    from tendermint_tpu_torch.state import make_genesis_state
    from tendermint_tpu_torch.types.block import BLOCK_ID_FLAG_COMMIT, BlockID, Commit
    from tendermint_tpu_torch.types.canonical import PRECOMMIT_TYPE, PREVOTE_TYPE
    from tendermint_tpu_torch.types.genesis import GenesisDoc, GenesisValidator
    from tendermint_tpu_torch.types.params import BLOCK_PART_SIZE_BYTES
    from tendermint_tpu_torch.types.proposal import Proposal
    from tendermint_tpu_torch.types.validator import ValidatorSet

    def counters():
        return {"ed25519_ladder": ed25519_cuda.LAUNCHES,
                "ed25519_window_tables": ed25519_table.BUILD_LAUNCHES,
                "ed25519_tabulated": ed25519_table.SUM_LAUNCHES}

    n = len(keys)
    t0 = time.perf_counter()
    bursts, bad_txs, _ = abci_traffic(keys, [], top=CS_HEIGHTS)
    key_of = {k.pub_key().address(): k for k in keys}
    gen = GenesisDoc(CHAIN_ID, genesis_time_ns=LITE_T0, validators=[
        GenesisValidator(k.pub_key().address(), k.pub_key(), 10) for k in keys])
    vals = make_genesis_state(gen).validators.copy()
    vals.increment_proposer_priority(CS_OURS_AT - 1)
    ours = key_of[vals.get_proposer().address]
    ours_addr = ours.pub_key().address()
    log(f"  traffic: {CS_HEIGHTS} bursts of {ABCI_TXS} signed envelopes ({len(bad_txs)} corrupted) "
        f"made in {_ms(t0):.3f} ms; our validator {ours_addr.hex()[:12]} (round-0 proposer of "
        f"{CS_OURS_AT}) of {n}")

    rec = FlightRecorder(size=1 << 16)
    commit_bv = bvm.BatchVerifier(device=dev, recorder=rec).install()
    cache = bvm.TableCache(commit_bv, tabulated=None).install()
    # the node's engine: one lane for the signed-tx flushes and the vote frames
    # (as node.py shares its AsyncBatchVerifier), on its own verifier so that
    # its warmup mode leaves the commit checks' table builds synchronous
    lane = bvm.AsyncBatchVerifier(bvm.BatchVerifier(device=dev, min_device_batch=16,
                                                    recorder=rec))
    tmp = tempfile.TemporaryDirectory(prefix="chip-smoke-cs-")
    home = tmp.name
    for d in ("config", "data"):
        os.makedirs(os.path.join(home, d))
    FilePV(FilePVKey(ours_addr, ours.pub_key(), ours,
                     os.path.join(home, "config", "priv_validator_key.json")),
           FilePVLastSignState(file_path=os.path.join(home, "data",
                                                      "priv_validator_state.json"))).save()
    timer = StepTimer()
    verify_commit = timer.wrap(ValidatorSet, "verify_commit",
                               height_of=lambda vs, chain_id, bid, height, *a, **k: height + 1)
    node, old = None, None
    before, seq0 = counters(), next_seq(rec)
    sign_s, frames_ok, proposals = 0.0, 0, {}
    try:
        await lane.start()
        with consensus_errors() as errors:
            node = await cs_node(home, gen, lane, timer)
            per_h = {h: {"lines": []} for h in range(1, CS_HEIGHTS + 1)}

            async def burst(hb):
                """Height hb's envelopes through check_tx, before its proposal
                is made (height 1's before the node starts, the others while
                the node waits for the precommits of hb - 1)."""
                out, ms = await check_burst(node.mempool, bursts[hb])
                for tx, (res, _) in zip(bursts[hb], out):
                    if tx in bad_txs:
                        if not (isinstance(res, MempoolError) and str(res) == "invalid tx signature"):
                            raise AssertionError(f"a corrupted envelope for {hb} gave {res!r}")
                    elif isinstance(res, Exception) or res.code != 0:
                        raise AssertionError(f"a valid tx for {hb} was rejected: {res!r}")
                lat = [lat for _, lat in out]
                per_h[hb]["lines"].append(
                    f"burst of {len(out)} check_tx {ms:.3f} ms, p50 {percentile(lat, 50):.3f} p99 "
                    f"{percentile(lat, 99):.3f} ms")

            await burst(1)
            await node.cs.start()
            w = node.watch
            iota_ns = node.state.consensus_params.block.time_iota_ms * 1_000_000
            for h in range(1, CS_HEIGHTS + 1):
                st = per_h[h]
                await w.until(lambda: w.at(h, 0, RoundStep.NEW_HEIGHT), f"height {h}")
                r, built = 0, None
                proposer = node.cs.rs.validators.get_proposer().address
                if proposer != ours_addr and h != CS_WITHHELD_AT:
                    built = await cs_build(node, key_of[proposer], h, 0, BlockID, Commit, Proposal,
                                           BLOCK_PART_SIZE_BYTES)
                while True:
                    await w.until(lambda: w.at(h, r, RoundStep.PROPOSE), f"propose {h}/{r}")
                    proposer = node.cs.rs.validators.get_proposer().address
                    who = ("ours" if proposer == ours_addr else
                           "withheld" if (h, r) == (CS_WITHHELD_AT, 0) else "peer")
                    if who == "peer":
                        if built is None:
                            built = await cs_build(node, key_of[proposer], h, r, BlockID, Commit,
                                                   Proposal, BLOCK_PART_SIZE_BYTES)
                        prop, parts, build_ms = built
                        proposals[h] = prop
                        await node.cs.set_proposal_and_block(prop, parts, "sender-0")
                        st["lines"].append(f"round {r}: proposal of {parts.total} parts by a peer "
                                           f"(built in {build_ms:.3f} ms)")
                    built = None
                    await w.until(lambda: (h, r, PREVOTE_TYPE) in w.signed, f"our prevote {h}/{r}")
                    rs = node.cs.rs
                    block = rs.proposal_block
                    if who == "ours":
                        proposals[h] = rs.proposal
                    bid = (BlockID(block.hash(), rs.proposal_block_parts.header())
                           if block is not None else BlockID())
                    t_own = w.signed[(h, r, PREVOTE_TYPE)][0]
                    if block is not None:
                        st["lines"].append(
                            f"round {r} ({who}): {len(block.txs)} txs; proposal complete -> own "
                            f"prevote {(t_own - w.complete[(h, r)]) * 1000:.3f} ms")
                    else:
                        st["lines"].append(f"round {r} ({who}): no proposal; timeout_propose -> "
                                           f"own nil prevote")
                    t_s = time.perf_counter()
                    pv_votes = cs_votes(rs.validators, key_of, ours_addr, PREVOTE_TYPE, h, r, block,
                                        bid, iota_ns)
                    pc_votes = cs_votes(rs.validators, key_of, ours_addr, PRECOMMIT_TYPE, h, r,
                                        block, bid, iota_ns)
                    pv_frames = cs_frames(rs.validators, *pv_votes)
                    pc_frames = cs_frames(rs.validators, *pc_votes)
                    sign_s += time.perf_counter() - t_s
                    # prevotes
                    seq, add0, wal0 = next_seq(rec), len(node.add_ms), len(node.wal_ms)
                    t_sent = await cs_send(node, pv_frames)
                    frames_ok += len(pv_frames)
                    prevotes = rs.votes.prevotes(r)
                    await w.until(lambda: prevotes.bit_array().count() == n, f"prevotes {h}/{r}")
                    line = cs_ingest_line(node, rec, seq, t_sent, time.perf_counter(), n - 1,
                                             add0, wal0, card)
                    st["lines"].append(f"round {r} prevotes: {line}")
                    await w.until(lambda: (h, r, PRECOMMIT_TYPE) in w.signed
                                  and node.cs.rs.votes.precommits(r).get_by_address(ours_addr)
                                  is not None, f"our precommit {h}/{r}")
                    if block is not None and h < CS_HEIGHTS:
                        await burst(h + 1)
                    if (h, r) == (CS_CRASH_AT, 0):
                        old = node
                        node, restart = await cs_restart(old, home, gen, lane, timer, h,
                                                         ours_addr, card)
                        w = node.watch
                        per_h["restart"] = restart
                        rs = node.cs.rs
                    # precommits, one frame first with a flipped signature
                    seq, add0, wal0 = next_seq(rec), len(node.add_ms), len(node.wal_ms)
                    t_sent = await cs_send(node, pc_frames, bad=cs_flip(pc_frames[0]))
                    frames_ok += len(pc_frames)
                    if block is None:
                        precommits = rs.votes.precommits(r)
                        await w.until(lambda: precommits.bit_array().count() == n,
                                      f"precommits {h}/{r}")
                        t_done = time.perf_counter()
                        line = cs_ingest_line(node, rec, seq, t_sent, t_done, n - 1, add0, wal0,
                                                 card)
                        st["lines"].append(f"round {r} nil precommits: {line}")
                        st["nil_done"] = t_done
                        r += 1
                        continue
                    # every precommit lands in the LastCommit or is refused as late
                    await w.until(lambda: node.cs.rs.height == h + 1 and (
                        node.cs.rs.last_commit.bit_array().count() + node.late[h] == n),
                        f"height {h}'s precommits")
                    t_done = time.perf_counter()
                    st["last_commit"] = node.cs.rs.last_commit.bit_array().count()
                    st["late"] = node.late[h]
                    line = cs_ingest_line(node, rec, seq, t_sent, t_done, n - 1, add0, wal0, card)
                    st["lines"].append(f"round {r} precommits (one bad frame rejected, re-sent "
                                       f"clean): {line}; vote-to-commit "
                                       f"{(w.t(h, r, RoundStep.COMMIT) - t_sent) * 1000:.3f} ms")
                    st["round"], st["sent"] = r, t_sent
                    break
            await w.until(lambda: w.at(CS_HEIGHTS + 1, 0, RoundStep.NEW_HEIGHT), "the last height")
            await node.cs.stop()  # drains the last height's delivery
            launches = {k: v - before[k] for k, v in counters().items()}
            await node.settle(node.block_store.load_block(CS_HEIGHTS))
            cs_report(old, node, rec, seq0, per_h, timer, sign_s, launches, dev, cache, card)
            cs_check(node, n, ours_addr, proposals, per_h, bursts, bad_txs, errors,
                     BLOCK_ID_FLAG_COMMIT)
        validate_blocks = sum(timer.n.get(("validate_block", h), 0)
                              for h in range(2, CS_HEIGHTS + 1))
        indexed = [e for e in rec.events(since=seq0, kinds=["verify.dispatch"])
                   if e["path"] in ("tabulated", "indexed", "chunked")]
        await node.close()
        node = None
    finally:
        ValidatorSet.verify_commit = verify_commit
        for nd in (node,):
            if nd is not None:
                if nd.cs.is_running:
                    await nd.cs.stop()
                await nd.close()
        await lane.stop()
        batch_hook.set_verifier(None)
        batch_hook.set_indexed_verifier(None)
        tmp.cleanup()
    return {"launches": launches, "validate_blocks": validate_blocks,
            "indexed_dispatches": len(indexed), "frames": frames_ok}


async def cs_build(node, key, h, r, BlockID, Commit, Proposal, part_size):
    """A peer's proposal for (h, r): its block made by the node's
    BlockExecutor on the delivered state and the node's LastCommit, cut into
    parts, the Proposal signed by its key.  Returns (proposal, parts, ms)."""
    import asyncio

    task = node.cs._delivery_task
    if task is not None:
        await asyncio.wait({task})
    t0 = time.perf_counter()
    state = node.state_store.load()
    commit = node.cs.rs.last_commit.make_commit() if h > 1 else Commit(0, 0, BlockID(), [])
    block = node.executor.create_proposal_block(h, state, commit, key.pub_key().address())
    parts = block.make_part_set(part_size)
    prop = Proposal(height=h, round=r, pol_round=-1,
                    block_id=BlockID(block.hash(), parts.header()), timestamp_ns=time.time_ns())
    prop.signature = key.sign(prop.sign_bytes(CHAIN_ID))
    return prop, parts, _ms(t0)


async def cs_restart(old, home, gen, lane, timer, h, ours_addr, card):
    """Stop the node mid-height h (its own precommit in the WAL), close its
    stores, then reopen them: the Handshaker (0 blocks to replay), the FilePV
    from its files, a new ConsensusState (reconstruct_last_commit_if_needed)
    whose start runs catchup_replay on the WAL.  Fails unless the WAL holds
    no ENDHEIGHT h and every vote the FilePV re-signs equals what it signed
    before.  Returns the new node and the restart's numbers."""
    from tendermint_tpu_torch.consensus import ConsensusState
    from tendermint_tpu_torch.consensus import replay as cs_replay

    own = {k: v for k, v in old.watch.signed.items() if k[0] == h}
    t0 = time.perf_counter()
    await old.cs.stop()  # on_stop drains the previous height's delivery
    stop_ms = _ms(t0)
    await old.close()
    rebuild, catchup, records = [], [], collections.Counter()
    reconstruct = ConsensusState.reconstruct_last_commit_if_needed

    def timed_reconstruct(self, state):
        t = time.perf_counter()
        try:
            return reconstruct(self, state)
        finally:
            rebuild.append(_ms(t))

    replay, replay_record = cs_replay.catchup_replay, cs_replay._replay_record

    async def timed_catchup(cs, height):
        t = time.perf_counter()
        try:
            return await replay(cs, height)
        finally:
            catchup.append(_ms(t))

    async def counted_record(cs, rec):
        records[rec.get("type")] += 1
        return await replay_record(cs, rec)

    t1 = time.perf_counter()
    ConsensusState.reconstruct_last_commit_if_needed = timed_reconstruct
    try:
        node = await cs_node(home, gen, lane, timer)
    finally:
        ConsensusState.reconstruct_last_commit_if_needed = reconstruct
    cs_replay.catchup_replay, cs_replay._replay_record = timed_catchup, counted_record
    try:
        await node.cs.start()  # catchup_replay raises (logged) on an ENDHEIGHT h in the WAL
    finally:
        cs_replay.catchup_replay, cs_replay._replay_record = replay, replay_record
    await node.watch.until(lambda: node.cs.rs.votes.precommits(0).get_by_address(ours_addr)
                           is not None, "the replayed precommit")
    restart_ms = _ms(t0)
    resigned = {k: v for k, v in node.watch.signed.items() if k[0] == h}
    if not resigned or any(v[1] != own.get(k, (0, None))[1] for k, v in resigned.items()):
        raise AssertionError(f"the FilePV re-signed {sorted(resigned)} differently from what it "
                             f"signed before the stop ({sorted(own)})")
    if node.handshaker.n_blocks != 0 or len(catchup) != 1 or not records["msg"]:
        raise AssertionError(f"the handshake replayed {node.handshaker.n_blocks} blocks, or "
                             f"catchup_replay ran {len(catchup)} times over {dict(records)}")
    log(f"  restart in height {h}: stop {stop_ms:.3f} ms (drains height {h - 1}'s delivery); "
        f"handshake {node.handshake_ms:.3f} ms, 0 blocks replayed; ConsensusState "
        f"{node.init_ms:.3f} ms, of which reconstruct_last_commit_if_needed {rebuild[0]:.3f} ms "
        f"(host verifies of the seen commit); catchup_replay {catchup[0]:.3f} ms over "
        f"{sum(records.values())} WAL records {dict(records)}; the FilePV re-signed "
        f"{len(resigned)} vote(s) byte-equal; down {_ms(t1) + stop_ms:.3f} ms in all ({card})")
    return node, restart_ms


def cs_check(node, n, ours_addr, proposals, per_h, bursts, bad_txs, errors, flag_commit):
    """Phase 9's outcome on the node's stores (see the module docstring)."""
    for h in range(1, CS_HEIGHTS + 1):
        block, seen = node.block_store.load_block(h), node.block_store.load_seen_commit(h)
        if block is None or seen is None:
            raise AssertionError(f"height {h} did not commit")
        want_round = 1 if h == CS_WITHHELD_AT else 0
        if seen.round != want_round:
            raise AssertionError(f"height {h} committed in round {seen.round}, not {want_round}")
        if block.hash() != proposals[h].block_id.hash:
            raise AssertionError(f"block {h} is not the proposal gossiped for it")
        want = {tx for tx in bursts[h] if tx not in bad_txs}
        if set(block.txs) != want:
            raise AssertionError(f"block {h} does not hold exactly burst {h}'s valid txs: "
                                 f"{len(block.txs)} txs, {len(set(block.txs) - want)} of other "
                                 f"bursts, {len(want - set(block.txs))} missing")
        signed = sum(cs.block_id_flag == flag_commit for cs in block.last_commit.signatures)
        landed = per_h[h - 1]["last_commit"] if h > 1 else 0
        if h > 1 and (signed != landed or 3 * signed <= 2 * n):
            raise AssertionError(f"block {h}'s LastCommit has {signed} signatures, not the "
                                 f"{landed} the node held, or not more than 2/3 of {n}")
    if node.block_store.load_block(CS_OURS_AT).header.proposer_address != ours_addr:
        raise AssertionError(f"height {CS_OURS_AT} was not proposed by our validator")
    state = node.state_store.load()
    if state.last_block_height != CS_HEIGHTS or state.app_hash != node.app.app_hash:
        raise AssertionError("the state store and the app disagree after the last height")
    if errors:
        raise AssertionError(f"consensus logged errors: {errors[:3]}")


def cs_report(old, node, rec, seq0, per_h, timer, sign_s, launches, dev, cache, card):
    """Per height and for the phase (see the module docstring, 9)."""
    from tendermint_tpu_torch.consensus.types import RoundStep

    steps = {}
    for t, *hrs in old.watch.steps + node.watch.steps:
        steps.setdefault(tuple(hrs), t)
    commit_t = {h: steps[(h, per_h[h]["round"], RoundStep.COMMIT)]
                for h in range(1, CS_HEIGHTS + 1)}
    t_first = steps[(1, 0, RoundStep.PROPOSE)]
    waits = sum(steps[(h + 1, 0, RoundStep.PROPOSE)] - commit_t[h]
                for h in range(1, CS_HEIGHTS))  # timeout_commit, the bursts inside it
    w = CS_WITHHELD_AT
    waits += steps[(w, 0, RoundStep.PREVOTE)] - steps[(w, 0, RoundStep.PROPOSE)]
    waits += steps[(w, 1, RoundStep.PROPOSE)] - per_h[w]["nil_done"]
    def at(name, h):
        return timer.ms.get((name, h), 0.0), timer.n.get((name, h), 0)

    for h in range(1, CS_HEIGHTS + 1):
        v, c = at("validate_block", h), at("verify_commit", h)
        gap = (f"{(commit_t[h] - commit_t[h - 1]) * 1000:.3f} ms" if h > 1 else "-")
        log(f"    height {h}: " + "; ".join(per_h[h]["lines"]) + f"; LastCommit "
            f"{per_h[h]['last_commit']} of {per_h[h]['last_commit'] + per_h[h]['late']} "
            f"precommits, {per_h[h]['late']} refused as late")
        log(f"    height {h}: validate_block x{v[1]} {v[0]:.3f} ms (verify_commit x{c[1]} "
            f"{c[0]:.3f} ms), save_block {at('save_block', h)[0]:.3f} ms, pipelined "
            f"apply_block {at('apply_block', h)[0]:.3f} ms; commit-to-commit {gap} ({card})")
    span = commit_t[CS_HEIGHTS] - t_first
    busy = span - sign_s - waits - per_h["restart"] / 1000
    log(f"  heights 1-{CS_HEIGHTS}: {span * 1000:.3f} ms from height 1's propose to height "
        f"{CS_HEIGHTS}'s commit = {CS_HEIGHTS / span:.3f} heights/s; apart from signing and "
        f"framing {sign_s * 1000:.3f} ms, the timeouts {waits * 1000:.3f} ms (timeout_commit "
        f"x{CS_HEIGHTS - 1}, height {w}'s timeout_propose and precommit wait) and the restart "
        f"{per_h['restart']:.3f} ms: {busy * 1000:.3f} ms = {CS_HEIGHTS / busy:.3f} heights/s; "
        f"{dispatch_share(rec, seq0, span)}; launches {launches}; {card_memory(dev, cache)} "
        f"({card})")


NODE_HEIGHTS = 5  # phase 10: heights 1 .. 5 commit; the run stops at height 6's NEW_HEIGHT
NODE_ROTATE_AT = 2  # this block carries the val: txs; set B serves from NODE_ROTATE_AT + 2
NODE_ROTATE = 2500  # val: txs remove this many of the oldest keys and add as many new ones
NODE_CRASH_AT = 5  # the node stops after its own precommit; a second node resumes the home
NODE_LOGGERS = ("consensus", "consensus-replay", "node", "watchdog", "batch-verifier")
CLI_CHAIN = "chip-smoke-solo"


def phase_node(keys, card, dev):
    """One validator of a 10,000-validator chain run as a Node from its home
    directory (see the module docstring, 10 (a)).  Returns the launches'
    denominators: validate_block calls on heights >= 2, table hits and
    declines, and the accepted vote frames."""
    import asyncio

    return asyncio.run(node_run(keys, card, dev))


def node_home(home, gen, ours):
    """The phase's home: config.toml written by save_config at the JAX
    defaults but p2p and RPC off, the signed-tx precheck with its journal,
    and a mempool that holds height 2's 6,000 txs; the genesis file; the
    FilePV files of `ours`.  Returns the config file's path."""
    from tendermint_tpu_torch.config import Config, save_config
    from tendermint_tpu_torch.privval import FilePV, FilePVKey, FilePVLastSignState

    cfg = Config(home=home)
    cfg.base.chain_id = CHAIN_ID
    cfg.p2p.laddr, cfg.rpc.laddr = "none", ""
    cfg.mempool.sig_precheck = True
    cfg.mempool.wal_dir = "data/mempool.wal"
    cfg.mempool.size = ABCI_MEMPOOL  # the default 5,000 cannot hold height 2's 6,000
    cfg.ensure_dirs()
    path = os.path.join(home, "config", "config.toml")
    save_config(cfg, path)
    gen.save_as(cfg.genesis_file())
    addr = ours.pub_key().address()
    FilePV(FilePVKey(addr, ours.pub_key(), ours, cfg.priv_validator_key_file()),
           FilePVLastSignState(file_path=cfg.priv_validator_state_file())).save()
    return path


class NodeProbe:
    """Class-level hooks for the phase's nodes, removed by close(): each
    ConsensusState gets instrument_cs as it starts (views[-1]); a StepTimer
    times validate_block (with the recorder's sequence numbers around each
    call, for its verify.table events), verify_commit, save_block,
    apply_block and the start's steps (boot scan, BatchVerifier.install,
    the AsyncBatchVerifier's start, the handshake with its replayed blocks,
    ConsensusState.start); the StateStore.load of `_valset_watch` is timed
    apart."""

    def __init__(self):
        import asyncio
        import types

        from tendermint_tpu_torch.consensus import ConsensusState, Handshaker
        from tendermint_tpu_torch.crypto import batch_verifier as bvm
        from tendermint_tpu_torch.state import StateStore
        from tendermint_tpu_torch.state.execution import BlockExecutor
        from tendermint_tpu_torch.store import BlockStore
        from tendermint_tpu_torch.types.validator import ValidatorSet

        self.timer, self.start = StepTimer(), StepTimer()
        self.views, self.vb, self.handshakes, self.watch_loads = [], [], [], []
        self.rec = None  # the current node's FlightRecorder
        self._restore = []
        probe = self

        def patch(obj, attr, fn):
            self._restore.append((obj, attr, vars(obj).get(attr)))
            setattr(obj, attr, fn)

        def wrap(timer, obj, attr, name=None, height_of=None):
            own = vars(obj).get(attr)  # None: inherited (Service.start)
            timer.wrap(obj, attr, name, height_of)
            self._restore.append((obj, attr, own))

        cs_start, validate, handshake = ConsensusState.start, BlockExecutor.validate_block, \
            Handshaker.handshake
        load = StateStore.load

        async def start(cs):
            view = types.SimpleNamespace(
                cs=cs, pv=cs.priv_validator, bus=cs.event_bus, executor=cs.block_exec,
                state_store=cs.block_exec.state_store, mempool=cs.mempool)
            instrument_cs(view)
            probe.views.append(view)
            t0 = time.perf_counter()
            try:
                await cs_start(cs)
            finally:
                probe.start.add("consensus_start", t0)

        def validate_block(ex, state, block):
            s0, t0 = next_seq(probe.rec), time.perf_counter()
            try:
                return validate(ex, state, block)
            finally:
                probe.timer.add(("validate_block", block.height), t0)
                probe.vb.append((block.height, probe.rec, s0, next_seq(probe.rec)))

        async def timed_handshake(hs, conns):
            t0 = time.perf_counter()
            try:
                return await handshake(hs, conns)
            finally:
                probe.start.add("handshake", t0)
                probe.handshakes.append(hs.n_blocks)

        def state_load(store):
            t0 = time.perf_counter()
            try:
                return load(store)
            finally:
                try:
                    task = asyncio.current_task()
                except RuntimeError:  # a thread without a loop
                    task = None
                if task is not None and task.get_name() == "valset-watch":
                    probe.watch_loads.append(_ms(t0))

        patch(ConsensusState, "start", start)
        patch(BlockExecutor, "validate_block", validate_block)
        patch(Handshaker, "handshake", timed_handshake)
        patch(StateStore, "load", state_load)
        wrap(self.timer, ValidatorSet, "verify_commit",
             height_of=lambda vs, chain_id, bid, height, *a, **k: height + 1)
        wrap(self.timer, BlockStore, "save_block", height_of=lambda bs, b, parts, c: b.height)
        wrap(self.timer, BlockExecutor, "apply_block", height_of=lambda ex, s, bid, b: b.height)
        wrap(self.start, BlockStore, "integrity_scan", "boot_scan")
        wrap(self.start, bvm.BatchVerifier, "install")
        wrap(self.start, bvm.AsyncBatchVerifier, "start", "lane_start")

    def close(self):
        for obj, attr, own in reversed(self._restore):
            if own is None:
                delattr(obj, attr)
            else:
                setattr(obj, attr, own)
        self._restore.clear()


def loop_split(rec, t0, t1) -> str:
    """The loop profiler's account of [t0, t1] (perf_counter seconds; the
    recorder stamps time.monotonic_ns, the same clock on Linux): busy ms
    per category, GC pauses, loop lag p90 and max, and the attribution's
    shares."""
    from tendermint_tpu_torch.libs import loopprof

    off = time.monotonic_ns() - time.perf_counter_ns()
    a, b = int(t0 * 1e9) + off, int(t1 * 1e9) + off
    evs = [e for e in rec.events(kinds=["loop."]) if a < e["t_ns"] <= b]
    busy = collections.Counter()
    for e in evs:
        if e["kind"] == "loop.busy":
            busy.update(loopprof.busy_categories(e))
    gc_ms = sum(e["ms"] for e in evs if e["kind"] == "loop.gc_pause")
    lags = [e["lag_ms"] for e in evs if e["kind"] == "loop.lag"]
    att = loopprof.attribution(evs, a, b) or {}
    cats = ", ".join(f"{c} {busy[c]:.1f}" for c in ("consensus", "verify", "mempool", "other"))
    return (f"{(t1 - t0) * 1000:.1f} ms: busy ms {cats}; GC {gc_ms:.1f} ms; loop lag p90 "
            f"{percentile(lags, 90) if lags else 0.0:.1f} max {max(lags, default=0.0):.1f} ms "
            f"over {len(lags)} probes; shares {att}")


async def node_run(keys, card, dev):
    import base64
    import tempfile
    import threading

    from tendermint_tpu_torch.config import load_config
    from tendermint_tpu_torch.consensus import replay as cs_replay
    from tendermint_tpu_torch.consensus.types import RoundStep
    from tendermint_tpu_torch.crypto import batch as batch_hook
    from tendermint_tpu_torch.libs import loopprof
    from tendermint_tpu_torch.mempool import MempoolError
    from tendermint_tpu_torch.node import default_new_node
    from tendermint_tpu_torch.state import make_genesis_state
    from tendermint_tpu_torch.types.block import BLOCK_ID_FLAG_COMMIT, BlockID, Commit
    from tendermint_tpu_torch.types.canonical import PRECOMMIT_TYPE, PREVOTE_TYPE
    from tendermint_tpu_torch.types.genesis import GenesisDoc, GenesisValidator
    from tendermint_tpu_torch.types.params import BLOCK_PART_SIZE_BYTES
    from tendermint_tpu_torch.types.proposal import Proposal

    t0 = time.perf_counter()
    gen = GenesisDoc(CHAIN_ID, genesis_time_ns=LITE_T0, validators=[
        GenesisValidator(k.pub_key().address(), k.pub_key(), 10) for k in keys])
    vals = make_genesis_state(gen).validators.copy()
    vals.increment_proposer_priority(CS_OURS_AT - 1)
    key_of = {k.pub_key().address(): k for k in keys}
    ours = key_of[vals.get_proposer().address]
    ours_addr = ours.pub_key().address()
    out_keys = [k for k in keys if k is not ours][:NODE_ROTATE]
    new_keys = make_keys(NODE_ROTATE, prefix="node")
    key_of.update((k.pub_key().address(), k) for k in new_keys)
    val_txs = ([b"val:" + base64.b64encode(k.pub_key().bytes()) + b"!0" for k in out_keys]
               + [b"val:" + base64.b64encode(k.pub_key().bytes()) + b"!10" for k in new_keys])
    set_a = {k.pub_key().address() for k in keys}
    set_b = (set_a - {k.pub_key().address() for k in out_keys}) | {
        k.pub_key().address() for k in new_keys}
    bursts, bad_txs, _ = abci_traffic(keys, [], top=NODE_HEIGHTS)
    n = len(keys)
    log(f"  traffic: {NODE_HEIGHTS} bursts of {ABCI_TXS} signed envelopes ({len(bad_txs)} "
        f"corrupted), {len(val_txs)} val: txs at height {NODE_ROTATE_AT} ({len(new_keys)} new "
        f"keys), made in {_ms(t0):.3f} ms; our validator {ours_addr.hex()[:12]} (round-0 "
        f"proposer of {CS_OURS_AT}) of {n}")

    tmp = tempfile.TemporaryDirectory(prefix="chip-smoke-node-")
    home = tmp.name
    cfg_path = node_home(home, gen, ours)
    probe = NodeProbe()
    builds, per_h, proposals, starts = [], {}, {}, []
    recs, nodes, sign_s, frames_ok = [], [], 0.0, 0
    device = None if dev.type == "cuda" else dev  # the entry point's default is the card

    async def start_node(label):
        """default_new_node on the home, started, its wiring checked."""
        probe.start.reset()
        t = time.perf_counter()
        node = default_new_node(load_config(cfg_path), device=device)
        new_ms = _ms(t)
        probe.rec = node.flight_recorder
        nodes.append(node)
        recs.append(node.flight_recorder)
        t = time.perf_counter()
        await node.start()
        start_ms = _ms(t)
        bv = node.batch_verifier
        if bv.device.type != dev.type:
            raise AssertionError(f"the node's engine runs on {bv.device}, not {dev}")
        if (batch_hook.get_verifier() != bv.verify
                or batch_hook.get_indexed_verifier() != node.table_cache.verify_indexed):
            raise AssertionError("the installed hooks are not the node's engine")
        if node.mempool.sig_verifier is not node.async_verifier:
            raise AssertionError("the mempool's signed-tx lane is not the node's AsyncBatchVerifier")
        sm = probe.start.ms
        starts.append(
            f"{label}: default_new_node (stores, state, FilePV) {new_ms:.3f} ms; start "
            f"{start_ms:.3f} ms: boot scan {sm.get('boot_scan', 0.0):.3f} ms, engine (install "
            f"{sm.get('install', 0.0):.3f} ms + lane start {sm.get('lane_start', 0.0):.3f} ms), "
            f"handshake {sm.get('handshake', 0.0):.3f} ms ({probe.handshakes[-1]} blocks "
            f"replayed), consensus start {sm.get('consensus_start', 0.0):.3f} ms (with "
            f"catchup_replay)")
        return node

    async def stop_node(node):
        t = time.perf_counter()
        await node.stop()
        if (batch_hook.get_verifier() is not batch_hook.host_batch_verify
                or batch_hook.get_indexed_verifier() is not None):
            raise AssertionError("the node's hooks are still installed after its stop")
        if loopprof.active() is not None:
            raise AssertionError("the loop profiler's process hooks survived the node's stop")
        return _ms(t)

    async def burst(node, hb):
        """Height hb's envelopes (and at NODE_ROTATE_AT the val: txs)
        through node.mempool.check_tx, before its proposal is made."""
        txs = list(bursts[hb]) + (val_txs if hb == NODE_ROTATE_AT else [])
        out, ms = await check_burst(node.mempool, txs)
        for tx, (res, _) in zip(txs, out):
            if tx in bad_txs:
                if not (isinstance(res, MempoolError) and str(res) == "invalid tx signature"):
                    raise AssertionError(f"a corrupted envelope for {hb} gave {res!r}")
            elif isinstance(res, Exception) or res.code != 0:
                raise AssertionError(f"a valid tx for {hb} was rejected: {res!r}")
        lat = [lat for _, lat in out]
        per_h.setdefault(hb, {"lines": []})["lines"].append(
            f"burst of {len(out)} check_tx {ms:.3f} ms, p50 {percentile(lat, 50):.3f} p99 "
            f"{percentile(lat, 99):.3f} ms")

    node = old = None
    restart = {}
    try:
        with consensus_errors(NODE_LOGGERS) as errors, table_timing(None, builds, dev):
            node = await start_node("first start")
            v = probe.views[-1]
            w = v.watch
            await burst(node, 1)
            iota_ns = node.state.consensus_params.block.time_iota_ms * 1_000_000
            seq0 = next_seq(node.flight_recorder)
            for h in range(1, NODE_HEIGHTS + 1):
                st = per_h.setdefault(h, {"lines": []})
                await w.until(lambda: w.at(h, 0, RoundStep.PROPOSE), f"propose {h}/0")
                if h > 1:
                    per_h[h - 1]["window"] = (w.t(h - 1, 0, RoundStep.COMMIT),
                                              w.t(h, 0, RoundStep.PROPOSE))
                    per_h[h - 1]["split"] = loop_split(node.flight_recorder,
                                                       *per_h[h - 1]["window"])
                proposer = v.cs.rs.validators.get_proposer().address
                who = "ours" if proposer == ours_addr else "peer"
                if who == "peer":
                    prop, parts, build_ms = await cs_build(v, key_of[proposer], h, 0, BlockID,
                                                           Commit, Proposal, BLOCK_PART_SIZE_BYTES)
                    proposals[h] = prop
                    await v.cs.set_proposal_and_block(prop, parts, "sender-0")
                    st["lines"].append(f"proposal of {parts.total} parts by a peer (built in "
                                       f"{build_ms:.3f} ms)")
                await w.until(lambda: (h, 0, PREVOTE_TYPE) in w.signed, f"our prevote {h}")
                rs = v.cs.rs
                block = rs.proposal_block
                if block is None:
                    raise AssertionError(f"the node prevoted nil at height {h}")
                if who == "ours":
                    proposals[h] = rs.proposal
                bid = BlockID(block.hash(), rs.proposal_block_parts.header())
                st["lines"].append(
                    f"{who}: {len(block.txs)} txs; proposal complete -> own prevote "
                    f"{(w.signed[(h, 0, PREVOTE_TYPE)][0] - w.complete[(h, 0)]) * 1000:.3f} ms")
                nv = rs.validators.size()
                t_s = time.perf_counter()
                pv_votes = cs_votes(rs.validators, key_of, ours_addr, PREVOTE_TYPE, h, 0, block,
                                    bid, iota_ns)
                pc_votes = cs_votes(rs.validators, key_of, ours_addr, PRECOMMIT_TYPE, h, 0,
                                    block, bid, iota_ns)
                pv_frames = cs_frames(rs.validators, *pv_votes)
                pc_frames = cs_frames(rs.validators, *pc_votes)
                sign_s += time.perf_counter() - t_s
                seq, add0, wal0 = next_seq(node.flight_recorder), len(v.add_ms), len(v.wal_ms)
                t_sent = await cs_send(v, pv_frames)
                frames_ok += len(pv_frames)
                prevotes = rs.votes.prevotes(0)
                await w.until(lambda: prevotes.bit_array().count() == nv, f"prevotes {h}")
                st["lines"].append("prevotes: " + cs_ingest_line(
                    v, node.flight_recorder, seq, t_sent, time.perf_counter(), nv - 1, add0, wal0,
                    card))
                await w.until(lambda: (h, 0, PRECOMMIT_TYPE) in w.signed
                              and v.cs.rs.votes.precommits(0).get_by_address(ours_addr)
                              is not None, f"our precommit {h}")
                if h < NODE_HEIGHTS:
                    await burst(node, h + 1)
                if h == NODE_CRASH_AT:
                    own = {k: s for k, s in w.signed.items() if k[0] == h}
                    old = node
                    t_down = time.perf_counter()
                    restart["stop_ms"] = await stop_node(old)
                    restart["old_health"] = old.watchdog.health()
                    replay, replay_record = cs_replay.catchup_replay, cs_replay._replay_record
                    records, catchup = collections.Counter(), []

                    async def timed_catchup(cs, height):
                        t = time.perf_counter()
                        try:
                            return await replay(cs, height)
                        finally:
                            catchup.append(_ms(t))

                    async def counted_record(cs, rec):
                        records[rec.get("type")] += 1
                        return await replay_record(cs, rec)

                    cs_replay.catchup_replay = timed_catchup
                    cs_replay._replay_record = counted_record
                    try:
                        node = await start_node("restart")
                    finally:
                        cs_replay.catchup_replay, cs_replay._replay_record = replay, replay_record
                    v = probe.views[-1]
                    w = v.watch
                    await w.until(lambda: v.cs.rs.votes.precommits(0).get_by_address(ours_addr)
                                  is not None, "the replayed precommit")
                    restart["ms"] = _ms(t_down)
                    resigned = {k: s for k, s in w.signed.items() if k[0] == h}
                    if not resigned or any(s[1] != own.get(k, (0, None))[1]
                                           for k, s in resigned.items()):
                        raise AssertionError(f"the FilePV re-signed {sorted(resigned)} "
                                             f"differently from before the stop ({sorted(own)})")
                    if probe.handshakes[-1] != 0 or len(catchup) != 1 or not records["msg"]:
                        raise AssertionError(f"the handshake replayed {probe.handshakes[-1]} "
                                             f"blocks, or catchup_replay ran {len(catchup)} "
                                             f"times over {dict(records)}")
                    restart["line"] = (
                        f"restart in height {h}: stop {restart['stop_ms']:.3f} ms; "
                        f"catchup_replay {catchup[0]:.3f} ms over {sum(records.values())} WAL "
                        f"records {dict(records)}; the FilePV re-signed {len(resigned)} vote(s) "
                        f"byte-equal; the mempool reopened its journal "
                        f"({len(node.mempool.wal_txs())} txs in it); down {restart['ms']:.3f} ms "
                        f"in all")
                    rs = v.cs.rs
                seq, add0, wal0 = next_seq(node.flight_recorder), len(v.add_ms), len(v.wal_ms)
                t_sent = await cs_send(v, pc_frames, bad=cs_flip(pc_frames[0]))
                frames_ok += len(pc_frames)
                await w.until(lambda: v.cs.rs.height == h + 1 and (
                    v.cs.rs.last_commit.bit_array().count() + v.late[h] == nv),
                    f"height {h}'s precommits")
                t_done = time.perf_counter()
                st["last_commit"] = v.cs.rs.last_commit.bit_array().count()
                st["late"] = v.late[h]
                st["lines"].append(
                    "precommits (one bad frame rejected, re-sent clean): " + cs_ingest_line(
                        v, node.flight_recorder, seq, t_sent, t_done, nv - 1, add0, wal0, card)
                    + f"; vote-to-commit {(w.t(h, 0, RoundStep.COMMIT) - t_sent) * 1000:.3f} ms")
                st["commit_t"] = w.t(h, 0, RoundStep.COMMIT)
                if h == 1:
                    st["first_propose"] = w.t(1, 0, RoundStep.PROPOSE)
            await w.until(lambda: w.at(NODE_HEIGHTS + 1, 0, RoundStep.NEW_HEIGHT),
                          "the last height")
            restart["stop2_ms"] = await stop_node(node)
            out = node_check(probe, nodes, recs, per_h, proposals, bursts, bad_txs, val_txs,
                             set_a, set_b, ours_addr, errors, home, BLOCK_ID_FLAG_COMMIT)
        node_report(probe, nodes, recs, per_h, starts, builds, restart, sign_s, seq0, dev,
                    card)
        out["frames"] = frames_ok
        out["tables"] = [b["thread"] for b in builds]
        out["window_builds"] = sum(1 for b in builds if b["build_ms"] is not None)
        return out
    finally:
        probe.close()
        for nd in nodes:
            if nd.is_running:
                await nd.stop()
        for t in threading.enumerate():  # the engine's background builds and probe
            if t.name in ("table-build", "table-rebuild", "bv-rtt-probe", "bv-warmup"):
                t.join()
        tmp.cleanup()


def node_check(probe, nodes, recs, per_h, proposals, bursts, bad_txs, val_txs, set_a, set_b,
               ours_addr, errors, home, flag_commit):
    """Phase 10 (a)'s outcome (see the module docstring, 10).  Returns the
    counts main() holds the launches to."""
    node = nodes[-1]
    n = len(set_a)
    for h in range(1, NODE_HEIGHTS + 1):
        block, seen = node.block_store.load_block(h), node.block_store.load_seen_commit(h)
        if block is None or seen is None or seen.round != 0:
            raise AssertionError(f"height {h} did not commit in round 0")
        if block.hash() != proposals[h].block_id.hash:
            raise AssertionError(f"block {h} is not the proposal gossiped for it")
        want = {tx for tx in bursts[h] if tx not in bad_txs}
        if h == NODE_ROTATE_AT:
            want |= set(val_txs)
        if set(block.txs) != want:
            raise AssertionError(f"block {h} does not hold exactly its burst's valid txs")
        signed = sum(cs.block_id_flag == flag_commit for cs in block.last_commit.signatures)
        if h > 1:
            landed = per_h[h - 1]["last_commit"]
            if signed != landed or 3 * signed <= 2 * n:
                raise AssertionError(f"block {h}'s LastCommit has {signed} signatures, not the "
                                     f"{landed} the node held, or not more than 2/3 of {n}")
    if node.block_store.load_block(CS_OURS_AT).header.proposer_address != ours_addr:
        raise AssertionError(f"height {CS_OURS_AT} was not proposed by our validator")
    for h in range(1, NODE_HEIGHTS + 2):
        got = {v.address for v in node.state_store.load_validators(h).validators}
        if got != (set_b if h >= NODE_ROTATE_AT + 2 else set_a):
            raise AssertionError(f"the validators at height {h} are not set "
                                 f"{'B' if h >= NODE_ROTATE_AT + 2 else 'A'}")
    state = node.state_store.load()
    if state.last_block_height != NODE_HEIGHTS:
        raise AssertionError("the state store did not reach the last height")
    updates = [e for rec in recs for e in rec.events(kinds=["valset.update"])]
    if [(e["n_updates"], e["new_size"]) for e in updates] != [(len(val_txs), n)]:
        raise AssertionError(f"valset.update events {updates}, not one with {len(val_txs)} "
                             f"updates and {n} validators")
    # each validate_block's verify.table events: one lookup each; a miss
    # declines (the node's verifier is in warmup mode) and the flat path serves
    checks = []
    for h, rec, s0, s1 in probe.vb:
        if h < 2:
            continue
        evs = [e for e in rec.events(since=s0, kinds=["verify.table", "verify.dispatch"])
               if e["seq"] < s1]
        table = [e["hit"] for e in evs if e["kind"] == "verify.table"]
        if len(table) != 1:
            raise AssertionError(f"a validate_block at height {h} made {len(table)} table "
                                 "lookups, not 1")
        flat = [e for e in evs if e["kind"] == "verify.dispatch" and e["path"] in ("device", "host")
                and e["n"] >= 3 * n // 4]
        if not table[0] and not flat:
            raise AssertionError(f"a declined commit check at height {h} was not served by the "
                                 "flat path")
        checks.append((recs.index(rec), h, table[0]))
    log("  validate_block on heights >= 2 (node, height, table hit): " + ", ".join(
        f"({i + 1}, {h}, {hit})" for i, h, hit in checks))
    if checks[0][1:] != (2, False):
        raise AssertionError("the genesis set's first commit check was not declined")
    first_b = [hit for i, h, hit in checks if i == 0 and h == NODE_ROTATE_AT + 3]
    if not first_b or not first_b[0]:
        raise AssertionError(f"set B's first commit check (height {NODE_ROTATE_AT + 3}) missed "
                             "the table _valset_watch built")
    if errors:
        raise AssertionError(f"the node logged errors: {errors[:3]}")
    for nd in nodes:
        crit = [e for e in nd.flight_recorder.events(kinds=["health.alarm"])
                if e["severity"] == "critical"]
        if crit or nd.watchdog.autodumps:
            raise AssertionError(f"the watchdog raised critical alarms {crit}")
    if os.path.isdir(os.path.join(home, "data", "forensics")):
        raise AssertionError("the watchdog wrote an autodump bundle")
    declines = [sum(1 for i, _, hit in checks if i == k and not hit) for k in range(len(recs))]
    return {"validate_blocks": len(checks), "hits": len(checks) - sum(declines),
            "declines": declines}


def node_report(probe, nodes, recs, per_h, starts, builds, restart, sign_s, seq0, dev, card):
    """Per height and for the phase (see the module docstring, 10 (a))."""
    t = probe.timer

    def at(name, h):
        return t.ms.get((name, h), 0.0), t.n.get((name, h), 0)

    for line in starts:
        log(f"  {line} ({card})")
    for nd in nodes:
        log(f"  dispatch RTT probe: {nd.batch_verifier.rtt_probe} ({card})")
    for h in range(1, NODE_HEIGHTS + 1):
        st = per_h[h]
        vb, vc = at("validate_block", h), at("verify_commit", h)
        gap = (f"{(st['commit_t'] - per_h[h - 1]['commit_t']) * 1000:.3f} ms" if h > 1 else "-")
        log(f"    height {h}: " + "; ".join(st["lines"]) + f"; LastCommit {st['last_commit']} "
            f"of {st['last_commit'] + st['late']} precommits, {st['late']} refused as late")
        log(f"    height {h}: validate_block x{vb[1]} {vb[0]:.3f} ms (verify_commit x{vc[1]} "
            f"{vc[0]:.3f} ms), save_block {at('save_block', h)[0]:.3f} ms, pipelined "
            f"apply_block {at('apply_block', h)[0]:.3f} ms; commit-to-commit {gap} ({card})")
        if "split" in st:
            log(f"    height {h}: timeout_commit window, loop profiler: {st['split']} ({card})")
    log(f"  {restart['line']} ({card})")
    loads = ", ".join(f"{ms:.3f}" for ms in probe.watch_loads)
    log(f"  _valset_watch: state load {loads} ms on the event loop ({card})")
    for b in builds:
        log(f"    table of {b['validators']} validators on {b['thread']}: host rows "
            f"{b['rows_ms']:.3f} ms, window tables (kernel 2) "
            + (f"{b['build_ms']:.3f} ms" if b["build_ms"] is not None else "not built")
            + f" ({card})")
    for i, nd in enumerate(nodes):
        alarms = [(e["alarm"], e["severity"]) for e in nd.flight_recorder.events(
            kinds=["health.alarm"])]
        log(f"  watchdog of node {i + 1}: {nd.watchdog.ticks} ticks, verdict "
            f"{nd.watchdog.verdict}, alarms raised {alarms}; loop profiler "
            f"{nd.loop_profiler.snapshot()}")
    first = per_h[1]["first_propose"]
    span = per_h[NODE_HEIGHTS]["commit_t"] - first
    waits = sum(per_h[h]["window"][1] - per_h[h]["window"][0] for h in range(1, NODE_HEIGHTS))
    busy = span - sign_s - waits - restart["ms"] / 1000
    d = [e for rec in recs for e in rec.events(kinds=["verify.dispatch"])]
    device_ms = sum(e["device_ms"] for e in d)
    log(f"  heights 1-{NODE_HEIGHTS}: {span * 1000:.3f} ms from height 1's propose to height "
        f"{NODE_HEIGHTS}'s commit = {NODE_HEIGHTS / span:.3f} heights/s; apart from signing and "
        f"framing {sign_s * 1000:.3f} ms, timeout_commit x{NODE_HEIGHTS - 1} "
        f"{waits * 1000:.3f} ms and the restart {restart['ms']:.3f} ms: {busy * 1000:.3f} ms = "
        f"{NODE_HEIGHTS / busy:.3f} heights/s; {len(d)} dispatches, host prep "
        f"{sum(e['host_prep_ms'] for e in d):.3f} ms, dispatch {device_ms:.3f} ms "
        f"({device_ms / (span * 1000) * 100:.3f} % of the wall time); "
        f"{card_memory(dev, nodes[-1].table_cache)} ({card})")


def store_height(home) -> int:
    """The block store's height in `home`, read through a read-only sqlite
    connection while another process writes it."""
    import sqlite3

    from tendermint_tpu_torch.encoding import codec
    from tendermint_tpu_torch.store import unseal

    path = os.path.join(home, "data", "blockstore.db")
    if not os.path.exists(path):
        return 0
    con = sqlite3.connect(f"file:{path}?mode=ro", uri=True, timeout=5)
    try:
        row = con.execute("SELECT v FROM kv WHERE k = ?", (b"blockStore",)).fetchone()
    except sqlite3.OperationalError:  # the table is not made yet
        return 0
    finally:
        con.close()
    if row is None:
        return 0
    payload, _ = unseal(bytes(row[0]))
    return codec.loads(payload)["height"]


def phase_cli(card):
    """The CLI in a subprocess on the card (see the module docstring, 10 (b))."""
    import base64
    import re
    import select
    import signal
    import tempfile

    from tendermint_tpu_torch.config import load_config, save_config

    tmp = tempfile.TemporaryDirectory(prefix="chip-smoke-cli-")
    home = os.path.join(tmp.name, "h2")
    env = dict(os.environ, PYTHONUNBUFFERED="1",
               PYTHONPATH=os.pathsep.join(p for p in (HERE, os.environ.get("PYTHONPATH")) if p))
    argv = [sys.executable, "-m", "tendermint_tpu_torch", "--home", home]

    def cli(*args):
        r = subprocess.run(argv + list(args), capture_output=True, text=True, timeout=300,
                           env=env, cwd=tmp.name)
        if r.returncode != 0:
            raise AssertionError(f"{' '.join(args)} exited {r.returncode}: {r.stderr[-2000:]}")
        return r.stdout

    def run_node(until_height):
        """`node` until the home's block store reaches until_height, then
        SIGTERM; returns (s to "node started", the height it started
        from, heights committed, exit code, its log)."""
        log_path = os.path.join(tmp.name, f"node-{until_height}.log")
        with open(log_path, "w") as err:
            t0 = time.perf_counter()
            proc = subprocess.Popen(argv + ["node"], stdout=subprocess.PIPE, stderr=err,
                                    text=True, env=env, cwd=tmp.name)
            try:
                line, deadline = "", t0 + 300
                while not line:  # "node started: chain=..." once started
                    if select.select([proc.stdout], [], [], 1.0)[0]:
                        line = proc.stdout.readline() or "exited"
                    elif proc.poll() is not None or time.perf_counter() > deadline:
                        break
                started_s = time.perf_counter() - t0
                if not line.startswith("node started"):
                    raise AssertionError(f"node did not start (exit {proc.wait(30)})")
                with open(log_path) as f:
                    text = f.read()
                m = re.search(r"node started chain_id=\S+ height=(\d+)", text)
                from_h = int(m.group(1)) if m else -1
                deadline = time.perf_counter() + 120
                while store_height(home) < until_height:
                    if proc.poll() is not None or time.perf_counter() > deadline:
                        raise AssertionError(f"node did not reach height {until_height}")
                    time.sleep(0.1)
                proc.send_signal(signal.SIGTERM)
                rc = proc.wait(30)
            finally:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
        with open(log_path) as f:
            text = f.read()
        return started_s, from_h, store_height(home), rc, text

    try:
        t0 = time.perf_counter()
        cli("init", "--chain-id", CLI_CHAIN)
        path = os.path.join(home, "config", "config.toml")
        cfg = load_config(path)
        cfg.p2p.laddr, cfg.rpc.laddr = "none", ""
        save_config(cfg, path)
        init_ms = _ms(t0)
        runs = [run_node(3), run_node(5)]
        for i, (started_s, from_h, top, rc, text) in enumerate(runs):
            engine = [ln for ln in text.splitlines() if "verify engine" in ln]
            if not engine or "device=cuda" not in engine[0]:
                raise AssertionError(f"the verify engine line names no CUDA device: {engine}")
            if rc != 0:
                raise AssertionError(f"node exited {rc} on SIGTERM: {text[-2000:]}")
            want_from = 0 if i == 0 else runs[0][2]
            if from_h != want_from:
                raise AssertionError(f"node started from height {from_h}, not {want_from}")
            log(f"    node run {i + 1}: 'node started' after {started_s:.3f} s (from height "
                f"{from_h}), committed to height {top}, exit code {rc} on SIGTERM; "
                f"{engine[0].split(': ', 1)[-1]} ({card})")
        if runs[1][2] < 5:
            raise AssertionError("the resumed node did not reach height 5")
        shown = json.loads(cli("show_validator"))
        with open(os.path.join(home, "config", "genesis.json")) as f:
            (val,) = json.load(f)["validators"]
        if (shown["type"], bytes.fromhex(shown["value"])) != (
                val["pub_key"]["type"], base64.b64decode(val["pub_key"]["value"])):
            raise AssertionError("show_validator does not print the genesis key")
        log(f"  init and config edit {init_ms:.3f} ms; show_validator prints the genesis key. A "
            f"solo validator's commits carry one signature, below min_device_batch (16): the "
            f"engine serves them on the host and no kernel launches here; this part proves the "
            f"entry point on the card ({card})")
    finally:
        tmp.cleanup()


def kernel_device_ms(fn, names) -> dict:
    """Device ms of each named kernel in one run of fn, from torch.profiler;
    a name is missing where the profiler records no device time for it."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    out = {}
    for ev in prof.key_averages():
        us = getattr(ev, "device_time_total", None) or getattr(ev, "cuda_time_total", 0)
        for name in names:
            if name in ev.key and us:
                out[name] = us / 1000
    return out


def add_resources(report, log_text, sm_count):
    """Registers, stack and spill bytes (ptxas log), warps per SM and the
    bound share into each kernel's report."""
    from tendermint_tpu_torch.ops import _build

    lib = _build.lib()
    passes = report["ed25519_window_tables"]["passes"]
    entries = [(report["ed25519_ladder"], "ladder_kernel", lib.ed25519_ladder_resident_warps()),
               (report["ed25519_tabulated"], "tabulated_kernel", lib.ed25519_table_resident_warps(2)),
               (report["ed25519_window_tables"], "windows_kernel", lib.ed25519_table_resident_warps(1)),
               (passes["chain"], "chain_kernel", lib.ed25519_table_resident_warps(0)),
               (passes["windows"], "windows_kernel", lib.ed25519_table_resident_warps(1))]
    for r, kernel, resident in entries:
        r.update(_build.resources_of(kernel, log_text))
        # warps launched per SM; how many of them one SM holds at once
        r["warps_per_sm"] = r["threads"] / 32 / sm_count
        r["resident_warps_per_sm"] = resident
    for r in report.values():
        r["bound_share"] = r["bound_ms"] / r["ms"]


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(HERE, "tendermint_tpu_torch")):
        print("chip_smoke: run from a checkout (tendermint_tpu_torch/ not found)", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)

    import numpy as np

    from tendermint_tpu_torch.crypto import batch_verifier as bvm
    from tendermint_tpu_torch.crypto import hostprep
    from tendermint_tpu_torch.ops import _build, ed25519_cuda, ed25519_table

    t_start = time.perf_counter()
    card = card_line()
    log(f"card: {card}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda}; {torch.cuda.get_device_name(0)}")

    log("[1] setup")
    t0 = time.perf_counter()
    _build.lib()
    log(f"  CUDA kernels built in {time.perf_counter() - t0:.3f} s ({_build.library_path()})")
    with open(_build.ptxas_log_path()) as f:
        ptxas_log = f.read()
    for line in ptxas_log.splitlines():
        if "Used" in line or "spill" in line or line.startswith("=="):
            log("  ptxas: " + line.strip())
    for fn, imad, wide, total in sass_counts(_build.library_path()):
        log(f"  sass: {fn} IMAD={imad} (IMAD.WIDE={wide}) instructions={total}")
    if not hostprep.have_fast_prep():
        raise AssertionError("host-prep C library did not build")
    t0 = time.perf_counter()
    keys = make_keys(N_VALIDATORS)
    log(f"  {N_VALIDATORS} keys in {time.perf_counter() - t0:.3f} s")

    report = {
        name: {"name": name, "route": "cuda", "source": src, "replaces": rep, "library_ms": None}
        for name, src, rep in (
            ("ed25519_ladder", "tendermint_tpu_torch/csrc/ed25519_ladder.cu",
             "tendermint_tpu/ops/ed25519_pallas.py:161"),
            ("ed25519_tabulated", "tendermint_tpu_torch/csrc/ed25519_table.cu",
             "tendermint_tpu/ops/ed25519_table.py:176"),
            ("ed25519_window_tables", "tendermint_tpu_torch/csrc/ed25519_table.cu",
             "tendermint_tpu/ops/ed25519_table.py:65"),
        )
    }

    log("[2] kernels vs plain versions (tolerance 0)")
    dev = torch.device("cuda")
    phase_kernels(np.random.default_rng(2024), keys[:TABLE_VALIDATORS], report, dev)

    log("[3] main path: 10k-validator commit through the hooks")
    ed25519_cuda.LAUNCHES = 0
    ed25519_table.BUILD_LAUNCHES = 0
    ed25519_table.SUM_LAUNCHES = 0
    vset, commit, msgs, tab_cache = phase_main(keys, card, dev)
    counts = {
        "ed25519_ladder": ed25519_cuda.LAUNCHES,
        "ed25519_window_tables": ed25519_table.BUILD_LAUNCHES,
        "ed25519_tabulated": ed25519_table.SUM_LAUNCHES,
    }
    log(f"  launches on the main path: {counts}")
    for name, c in counts.items():
        if c == 0:
            raise AssertionError(f"kernel {name} was not launched on the main path")
        report[name]["launches"] = c

    log("[4] kernels vs plain versions and timing at the main path's shapes")
    phase_timing(vset, commit, msgs, tab_cache, report)
    add_resources(report, ptxas_log, torch.cuda.get_device_properties(0).multi_processor_count)
    for r in report.values():
        log(f"  {r['name']}: {r['ms']:.4f} ms (plain {r['plain_ms']:.1f} ms, bound "
            f"{r['bound_ms']:.4f} ms by {r['bound_by']}, share {r['bound_share']:.4f}; "
            f"{r['threads']} threads, {r['warps_per_sm']:.2f} warps/SM launched, "
            f"{r['resident_warps_per_sm']} resident, {r['regs']} regs, "
            f"stack {r['stack_bytes']} B, spill {r['spill_bytes']} B) ({card})")
    for name, p in report["ed25519_window_tables"]["passes"].items():
        log(f"  ed25519_window_tables pass {name}: {p['ms']} ms (profiler), {p['threads']} threads, "
            f"{p['warps_per_sm']:.2f} warps/SM launched, {p['resident_warps_per_sm']} resident, "
            f"{p['regs']} regs, stack {p['stack_bytes']} B, "
            f"spill {p['spill_bytes']} B ({card})")
    check_profile(report, card)

    log("[5] vote ingress: 10k precommits through AsyncBatchVerifier, VoteSet, commit")
    ed25519_cuda.LAUNCHES = 0
    ed25519_table.BUILD_LAUNCHES = 0
    ed25519_table.SUM_LAUNCHES = 0
    t0 = time.perf_counter()
    phase_ingress(keys, vset, commit, msgs, card, dev)
    counts = {
        "ed25519_ladder": ed25519_cuda.LAUNCHES,
        "ed25519_window_tables": ed25519_table.BUILD_LAUNCHES,
        "ed25519_tabulated": ed25519_table.SUM_LAUNCHES,
    }
    log(f"  launches in phase 5: {counts}; phase 5 took {time.perf_counter() - t0:.3f} s")
    if counts["ed25519_ladder"] == 0:
        raise AssertionError("the ladder was not launched during vote ingress")
    for name, c in counts.items():
        report[name]["launches"] += c

    log("[6] light client: bisection, sequence, engine lane and shared cache at 10k validators")
    ed25519_cuda.LAUNCHES = 0
    ed25519_table.BUILD_LAUNCHES = 0
    ed25519_table.SUM_LAUNCHES = 0
    t0 = time.perf_counter()
    _, launches_34 = phase_light(keys, card, dev, report)
    counts = {
        "ed25519_ladder": ed25519_cuda.LAUNCHES,
        "ed25519_window_tables": ed25519_table.BUILD_LAUNCHES,
        "ed25519_tabulated": ed25519_table.SUM_LAUNCHES,
    }
    log(f"  launches in phase 6: {counts}; phase 6 took {time.perf_counter() - t0:.3f} s")
    if counts["ed25519_window_tables"] == 0:
        raise AssertionError("kernel 2 (window tables) was not launched in phase 6")
    if launches_34["ed25519_ladder"] == 0:
        raise AssertionError("the ladder was not launched in phase 6's engine lane")
    for name, c in counts.items():
        report[name]["launches"] += c

    log("[7] fast-sync replay from sqlite stores at 10k validators across a set rotation")
    ed25519_cuda.LAUNCHES = 0
    ed25519_table.BUILD_LAUNCHES = 0
    ed25519_table.SUM_LAUNCHES = 0
    t0 = time.perf_counter()
    launches_a = phase_replay(keys, card, dev)
    counts = {
        "ed25519_ladder": ed25519_cuda.LAUNCHES,
        "ed25519_window_tables": ed25519_table.BUILD_LAUNCHES,
        "ed25519_tabulated": ed25519_table.SUM_LAUNCHES,
    }
    log(f"  launches in phase 7: {counts}; phase 7 took {time.perf_counter() - t0:.3f} s")
    prof = next(iter(bvm.tabulated_profiles.values()))
    picked = "ed25519_tabulated" if prof["tab_ms"] < prof["ladder_ms"] else "ed25519_ladder"
    if counts["ed25519_ladder"] == 0:
        raise AssertionError("the ladder was not launched in phase 7")
    if counts["ed25519_window_tables"] != 2:
        raise AssertionError("kernel 2 (window tables) was not launched once per set in phase 7")
    if launches_a[picked] == 0:
        raise AssertionError(f"the auto-profile's pick ({picked}) was not launched in phase 7 (a)")
    for name, c in counts.items():
        report[name]["launches"] += c

    log("[8] blocks applied to the kvstore app at 10k validators: mempool, BlockExecutor, "
        "fast sync, handshake")
    ed25519_cuda.LAUNCHES = 0
    ed25519_table.BUILD_LAUNCHES = 0
    ed25519_table.SUM_LAUNCHES = 0
    t0 = time.perf_counter()
    launches = phase_abci(keys, card, dev)
    counts = {
        "ed25519_ladder": ed25519_cuda.LAUNCHES,
        "ed25519_window_tables": ed25519_table.BUILD_LAUNCHES,
        "ed25519_tabulated": ed25519_table.SUM_LAUNCHES,
    }
    log(f"  launches in phase 8: {counts}; phase 8 took {time.perf_counter() - t0:.3f} s")
    if launches["flushes"]["ed25519_ladder"] == 0:
        raise AssertionError("the ladder was not launched by the mempool's signed-tx flushes")
    if launches["a"]["ed25519_window_tables"] != 2:
        raise AssertionError("kernel 2 (window tables) was not launched once per set in phase 8 (a)")
    for part in ("a", "b", "c3"):
        if launches[part][picked] == 0:
            raise AssertionError(f"the auto-profile's pick ({picked}) was not launched in phase 8 "
                                 f"({part})")
    for name, c in counts.items():
        report[name]["launches"] += c

    log("[9] consensus at 10k validators: proposals, vote frames, a round change and a restart "
        "from the WAL")
    ed25519_cuda.LAUNCHES = 0
    ed25519_table.BUILD_LAUNCHES = 0
    ed25519_table.SUM_LAUNCHES = 0
    t0 = time.perf_counter()
    out = phase_consensus(keys, card, dev)
    counts = {
        "ed25519_ladder": ed25519_cuda.LAUNCHES,
        "ed25519_window_tables": ed25519_table.BUILD_LAUNCHES,
        "ed25519_tabulated": ed25519_table.SUM_LAUNCHES,
    }
    log(f"  launches in phase 9: {counts}; {out['validate_blocks']} validate_block calls on heights "
        f">= 2, {out['indexed_dispatches']} indexed dispatches, {out['frames']} vote frames "
        f"accepted; phase 9 took {time.perf_counter() - t0:.3f} s")
    if counts["ed25519_window_tables"] != 1:
        raise AssertionError("kernel 2 (window tables) was not launched exactly once in phase 9")
    if out["indexed_dispatches"] != out["validate_blocks"] or counts[picked] < out["validate_blocks"]:
        raise AssertionError(f"the auto-profile's pick ({picked}) was not launched once per "
                             "validate_block in phase 9")
    if picked == "ed25519_tabulated" and counts[picked] != out["validate_blocks"]:
        raise AssertionError("the tabulated sum launched other than once per validate_block")
    if counts["ed25519_ladder"] < out["frames"]:
        raise AssertionError("the ladder was not launched for every accepted vote frame in phase 9")
    for name, c in counts.items():
        report[name]["launches"] += c

    log("[10] node wiring: a 10,000-validator node from its home directory, stopped and "
        "resumed; then the CLI")
    ed25519_cuda.LAUNCHES = 0
    ed25519_table.BUILD_LAUNCHES = 0
    ed25519_table.SUM_LAUNCHES = 0
    t0 = time.perf_counter()
    out = phase_node(keys, card, dev)
    counts = {
        "ed25519_ladder": ed25519_cuda.LAUNCHES,
        "ed25519_window_tables": ed25519_table.BUILD_LAUNCHES,
        "ed25519_tabulated": ed25519_table.SUM_LAUNCHES,
    }
    log(f"  launches in phase 10 (a): {counts}; {out['validate_blocks']} validate_block calls on "
        f"heights >= 2, {out['hits']} table hits, declines by node {out['declines']}, tables "
        f"built {out['tables']}, {out['frames']} vote frames accepted; phase 10 (a) took "
        f"{time.perf_counter() - t0:.3f} s")
    if out["tables"] != ["table-build", "table-rebuild", "table-build"]:
        raise AssertionError(f"phase 10 built tables {out['tables']}, not the genesis set's, set "
                             "B's by _valset_watch and set B's by the restarted node")
    if picked == "ed25519_tabulated" and counts["ed25519_window_tables"] != 3:
        raise AssertionError("kernel 2 (window tables) was not launched once per table in "
                             "phase 10")
    if out["declines"][0] != 1:
        raise AssertionError("the first node declined other than exactly once (the genesis "
                             "set's first check)")
    if counts[picked] < out["hits"]:
        raise AssertionError(f"the auto-profile's pick ({picked}) did not serve every table hit "
                             "in phase 10")
    if counts["ed25519_ladder"] < out["frames"] + sum(out["declines"]):
        raise AssertionError("the ladder did not serve every accepted vote frame and declined "
                             "check in phase 10")
    for name, c in counts.items():
        report[name]["launches"] += c
    t0 = time.perf_counter()
    phase_cli(card)
    log(f"  phase 10 (b) took {time.perf_counter() - t0:.3f} s")

    log(f"whole run: {time.perf_counter() - t_start:.3f} s")
    keys_order = ("name", "route", "source", "replaces", "launches", "max_abs_err",
                  "ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "bound_share",
                  "threads", "warps_per_sm", "resident_warps_per_sm", "regs", "stack_bytes",
                  "spill_bytes")
    kernels = [{k: r[k] for k in keys_order + (("passes",) if "passes" in r else ())}
               for r in report.values()]
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

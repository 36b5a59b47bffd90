#!/usr/bin/env python3
"""Smoke run of tendermint_tpu_torch on one CUDA card.

    python3 chip_smoke.py

1. Setup: prints the card (nvidia-smi name and power limit), builds the
   CUDA kernels from the checkout's sources and the host-prep C library,
   and (on a thread beside nvcc) the BLS12-381 C tier from
   tendermint_tpu_torch/csrc/bls12_381.c into tendermint_tpu_torch/_build/;
   fails unless scheme.active_tier() is "c".
2. Each kernel against its plain torch version on the card, on the same
   inputs, tolerance 0 (integer math), at ragged shapes (no multiple of 8
   or 32): kernel 1 (ladder) at B = 1021 and kernel 3 (tabulated verify)
   at B = 1, 7 and 1021 on a mix of valid signatures and every corruption
   class, comparing verdicts and the R' encodings; kernel 2 (window tables) for 67
   validators, bit for bit.  Verdicts of real signatures are also held
   against the pure-Python ed25519 oracle.  Then the four-lane point
   helpers (csrc/ge_quad.cuh) against the one-lane helpers (csrc/fe51.cuh)
   on real points: doubling and mixed add equal bit for bit, the add (which
   takes 2d*T cached) equal as canonical values.  Then both BLS12-381 fold
   kernels (csrc/bls12_381_fold.cu) against their plain version, every
   output limb, and against the pure fold as compressed points, on keys and
   signatures made by the C tier: 8, 9 and 33 points (buckets 8, 16, 64,
   every other point a sum of two so Z != 1), the edge rows (a doubling,
   P + (-P), the identity on either side), 8 rows at infinity with one
   finite point, and the seams of the fold's tiers (LEAVES points a block
   of the first, ops/bls12_381_fold.py plan()): 2 x LEAVES copies of one
   point (every pair a doubling, in both tiers), two halves that sum to S
   and -S (the last tier's one addition P + (-P)), and LEAVES rows at
   infinity before the live ones (every live row in the last block).
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
   liteserve's VerifyCache): a chain of 302 heights whose 10,000-validator
   set (power 10) replaces its 3,400 oldest validators by new keys every
   100 heights (3 replacements; 505 heights of 2,500 until phase 19 needed
   the time); commits are signed on first request.  Run 1: bisection
   1 -> 300 through the installed BatchVerifier and TableCache (tabulated
   auto) with an honest witness; it must make the 3 expected steps, persist
   {1, 150, 300} and build tables for each new set.  Run 2:
   sequence 300 -> 302 on the next set, persisted to a sqlite DBStore
   that is reopened and read back.  Run 3: the same bisection with
   the node's engine settings and EngineCommitPreverify (each commit one
   verify_many arrival).  Run 4: eight tenants bisect concurrently through
   one VerifyCache(async_verifier=...): 3 misses, 29 hits or coalesced
   joins.  Run 5: a flipped signature in header 300 (ValueError "wrong
   signature (#i)") and a witness serving another header 300
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
   KVStoreApplication from proxy.default_client_creator behind AppConns, a
   Handshaker sending InitChain, an EventBus with one NewBlock and one Tx
   subscriber and an IndexerService, a Mempool (sig_precheck on, size
   10,000, pre_check tx_pre_check) whose signed-tx lane is an
   AsyncBatchVerifier on the node's engine settings, an EvidencePool and a
   BlockExecutor.  Per height 1-7 (9 before phase 18 needed the time),
   1,000 signed envelopes arrive as one
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
   each pair, save_block, apply_block, for heights 1-6 (7 stays pending);
   its state, app hash, events and tx index must equal the producer's.
   (c) Its stores reopened, the Handshaker runs with (c1) its own app (no
   replay), (c2) a fresh app (InitChain and 6 blocks replayed) and (c3)
   block 7 saved with its seen commit but not applied (apply_block, whose
   validate_block verifies 7's LastCommit).  Prints per height the
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
   vote-frame verifier.  Heights 1-4 (cut from 6 to pay for phase 18's
   time): a burst of 1,000 signed envelopes
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
   the node (default_decide_proposal, signed by the FilePV).  At height 2
   the round-0 proposer withholds its proposal: the node prevotes nil on
   timeout_propose, the peers vote nil, and round 1 commits.  In height 4,
   after the proposal, the prevotes and the node's own precommit are in the
   WAL, the ConsensusState stops (on_stop drains height 5's delivery) and
   the stores close; reopened, the Handshaker replays 0 blocks, the FilePV
   loads from its files and a new ConsensusState runs
   reconstruct_last_commit_if_needed and catchup_replay; the peers'
   precommits then commit height 4, and the run stops at height 5's
   NEW_HEIGHT.  Prints per height the burst, the proposal, proposal
   complete -> own prevote, each vote kind's ingest (frames' verify_direct
   host prep and device ms p50/p99, the receive routine's Python per vote),
   vote-to-commit, validate_block with verify_commit, save_block, the
   pipelined apply_block and commit-to-commit; the restart's handshake,
   reconstruction and catchup ms; heights/s with signing and the timeouts
   apart, the dispatches' share, card memory and launches.  Fails unless
   heights 1-4 commit (2 in round 1, the others in round 0) with exactly
   their bursts' valid txs, block 3 is ours, every precommit either lands
   in the LastCommit or is refused as late (it reached the node after the
   next round began) and each block's LastCommit is what the node held
   (more than 2/3), block 4 is the proposal gossiped before the stop, the
   FilePV's re-signed votes equal what it signed before, no ERROR is
   logged by consensus, and kernel 2 launched once, the auto-profile's
   pick once per validate_block on heights >= 2 and the ladder at least
   once per accepted frame.
10. Node wiring at full width.  (a) One validator of a 10,000-validator
   chain run as a Node from its home directory: config.toml written by
   save_config at the JAX defaults but p2p.laddr "none", rpc.laddr "", the
   signed-tx precheck with its journal at data/mempool.wal and a mempool of
   10,000 (height 1 holds 6,000 txs; the default is 5,000); the genesis
   file (phase 3's keys at power 10); the FilePV files of our validator
   (below).  default_new_node(load_config(...)) builds everything: the
   stores, StorageHealth, the kvstore app on its durable app db, the tx
   index, the FlightRecorder, the loop profiler, one BatchVerifier on the
   card installed as the flat hook, a TableCache on it (the indexed hook)
   and the AsyncBatchVerifier on it (so in warmup mode: a set's first
   commit check declines and the flat ladder serves it while its table
   builds in the background), the handshake, the mempool with the engine as
   its signed-tx lane, the evidence pool, the BlockExecutor, the
   ConsensusState with its WAL, _valset_watch and the watchdog.  Phase 9's
   traffic goes to node.mempool and node.consensus: heights 1-4, a burst of
   1,000 envelopes each; height 1 also carries 5,000 val: txs that replace
   the 2,500 oldest validators by new keys, so set B signs from height 3
   and _valset_watch rebuilds its table before its first commit (height
   3's, checked at 4); height 3 is ours (the validator is set B's round-0
   proposer there, its priorities derived as update_state derives them).
   In height 4, after the proposal, the prevotes and our precommit, the
   node stops and a second default_new_node on the same home resumes (boot
   scan, a handshake replaying 0 blocks, the FilePV from its files,
   catchup_replay); the peers' precommits commit height 4 and the run stops at height 5's NEW_HEIGHT.  Prints what phase 9 prints
   per height, both starts' split (stores, boot scan, engine, handshake,
   consensus start) and the RTT probe, _valset_watch's state load and each
   table build (thread, host rows, kernel 2), the loop profiler's account
   of each height's timeout_commit window (busy ms per category, GC, lag
   p90 and max, shares), the watchdog's verdict and alarms, heights/s with
   signing, timeout_commit and the restart apart, the dispatches' share
   and the card's memory.  Fails unless the engine runs on the card with
   the node's hooks installed (and uninstalled after each stop), heights
   1-4 commit with exactly their bursts' valid txs (and height 1's val:
   txs), block 3 is ours, set B holds from height 3 with one valset.update
   event (5,000 updates, 10,000 validators), every validate_block on
   heights >= 2 makes one table lookup, the genesis set's first check
   declines and the flat path serves it, set B's first check is a table
   hit, every precommit lands or is refused as late, the restart replays 0
   blocks and reproduces block 4 and our votes, nothing is logged at ERROR
   and the watchdog raises no critical alarm (no autodump); and, on the
   card, kernel 2 launched once per table built (3: the genesis set after
   its decline, set B by _valset_watch, set B again by the restarted
   node's empty TableCache), the first node declined exactly once, the
   profile's pick served every table hit and the ladder every accepted
   frame and decline.  (b) The CLI in subprocesses (on a thread beside
   phase 13 since phase 20: it launches nothing in this process): `python -m
   tendermint_tpu_torch --home H2 init --chain-id chip-smoke-solo`, p2p and
   RPC turned off through load_config/save_config, `node` until the block
   store reaches height 3, SIGTERM (exit 0 within 30 s), `node` again from
   height 3 to 5, and show_validator printing the genesis key; the "verify
   engine" log line must name a CUDA device.  A solo validator's commits
   carry one signature, below min_device_batch, so no kernel launches in
   (b).

11. Two port nodes of the 10,000-validator chain over TCP (phase 3's keys at
   power 10, the kvstore app, sqlite stores; no rotation).  Node A is built
   by default_new_node from its home (config.toml at the JAX defaults but
   its moniker, p2p.laddr on a free local port, PEX off, duplicate IPs
   allowed since every peer is on 127.0.0.1, RPC on a free local port (for
   phase 16), the flight spool on with a 32,768-event recorder ring, the
   signed-tx precheck and a mempool of 10,000, timeout_propose 120 s (B
   proposes height 5 after hearing height 4's commit second-hand, and
   height 4's proposal waits for B, see net_home); fast sync on; the FilePV
   of height 3's round-0 proposer) and
   instrumented as phase 10's node.  Four relay peers in a process of their
   own (so their packing and sealing is not charged to A), each with its own
   NodeKey, Transport and Switch of the port, dial A as persistent peers;
   each holds a quarter of the 9,998 validators that neither node holds,
   and runs a driver reactor on channels 0x20-0x23 that follows A's
   new_round_step (and ignores what A gossips back); each
   relay's frames carry the possession bitmap of all 9,998 relayed votes
   (it stands for a part of the network that has heard them), so A's
   anti-echo sends the relays only A's and B's votes back.  With no
   peer ahead, A's fast sync hands over to consensus after its 1 s grace.
   Per height: a burst of 1,000 signed envelopes (1 in 100 corrupted) goes
   to A's check_tx only; a relay whose validator proposes builds the
   Proposal and its 64 KB parts as soon as A has delivered the previous
   height (as phase 9's peers build them) and sends them on DATA_CHANNEL
   once A, and from height 4 on B in A's view, is in its PROPOSE step (a
   proposer proposes after its own timeout_commit; a node that holds the
   proposal complete before its PROPOSE step skips the step, ROADMAP
   3.10); after A's own prevote, then its own precommit, each relay sends
   its quarter of the votes (signed on SIGN_THREADS) as vote_batch frames of
   at most 65,536 bytes in the consensus reactor's format.  Node B starts
   through the CLI (`python -m tendermint_tpu_torch --home HB node`, a
   subprocess) once A has committed height 3 (at height 2 the fast-sync
   reactor's tip-1 rule lets B switch before it fetches a block), with A as
   its only (persistent) peer: it fast-syncs at least one pair from A on
   the BLOCKCHAIN channel (the pair checks on its own engine; on the card
   one pair, switching at height 1), switches to consensus and gets the
   blocks up to A's height (on the card 2-3) through A's catch-up gossip;
   height 4's proposal waits until A sees B in its PROPOSE step of 4, so
   every proposal, part and vote B sees from then on crosses A's consensus
   reactor.  B's FilePV holds height 5's proposer: B proposes block 5 from
   txs that reached it by mempool gossip, and the relays vote
   for the block id A received from B.  In height 4 relay 1's last
   precommit frame carries one flipped signature (A must stop relay 1 with
   "invalid vote signature in batch"; relay 2 re-sends the frame clean and
   relay 1 re-dials), and relay 0 sends a second, nil prevote of one of its
   validators (A's DuplicateVoteEvidence must reach B by the evidence
   reactor and commit in block 5 or 6).  Once both nodes have committed
   height 6, phase 16 runs on the live net and ends with B SIGKILLed by
   `debug kill` (exit -9); B's stores are opened here, A stops.  Prints per height on A: proposal complete -> own prevote, each
   vote kind's ingest (first frame to +2/3, verify_direct host prep and
   device ms p50/p99, the receive routine's us per vote), vote-to-commit,
   commit-to-commit, the consensus frames received by kind, A's link bytes
   sent and received by peer class (relays, B) from the MConnection meters,
   B's commit lag behind A (B's log timestamps, the same host clock) and the
   loop profiler's account of each COMMIT -> PROPOSE window (the gossip
   tasks their own category); on B, seconds to "node started", its
   fast-synced blocks and their time and the height it switched at; heights/s
   as run and apart from signing, timeout_commit and B's start; the
   dispatches' share; the card's memory; one link's handshake ms, the AEAD's
   seal and open MB/s on the C tier and 16 MB through a link in 1 KB
   messages.  Fails unless heights 1-6 commit in round 0, A and B hold
   byte-equal blocks 1-6 and equal app hashes, each valid envelope is
   committed once, block 3 is A's and block 5 is B's with gossiped txs,
   every LastCommit holds more than 2/3, B fast-synced a pair and then
   committed every later height in consensus, A stopped relay 1 for exactly
   that reason (and no other peer) and readmitted it, the evidence is
   committed once and marked committed in both pools, neither node logs an
   ERROR, B exits -9 and its output holds no traceback, every validate_block of A on
   heights >= 2 makes one table lookup, and on the card kernel 2 built A's
   genesis table, the profile's pick served every table hit and the ladder
   every vote_batch frame of >= 16 entries and every declined check.  B's
   launches happen in its own process and are not in the kernels line.
12. A third node joins the 10,000-validator chain by state sync.
   Phase 11's nodes take app snapshots every 2 heights (the kvstore app
   keeps the last 2, in chunks of 65,536 bytes: the 10,000 validators'
   entries and phase 11's txs), and their homes outlive phase 11.  A and
   B restart from them through the CLI (`node`, each in its own process),
   with p2p and RPC on free local ports, PEX on (the JAX default; the
   address book not strict, every address being 127.0.0.1) and B dialing
   A; the relays are gone, so the chain stands at height 6.  Node C,
   `default_new_node` in this process on the card with an empty home and
   PEX on, has `[statesync] enable`,
   A (primary) and B (witness) as its trust servers, A's header at height
   6 (read from A's /commit through the port's HTTPClient) as its trust
   root, A and B as persistent peers and its own RPC on.  Height 6 is the
   trust height because it needs the fewest `/validators` fetches: each
   is 100 pages, and each page decodes the whole set on A.  C must
   discover A's and B's snapshots (4 and 6), try 6 five times and reject
   it with the JAX messages (its header 7 does not exist), verify the
   trust root of 4 (each commit one ladder flush through
   EngineCommitPreverify), offer it, fetch and apply every chunk, pass
   the Info check, bootstrap its stores at 4, hand over to fast sync
   (which applies block 5 if it arrives within the reactor's 1 s grace,
   else its tip-1 rule switches at once) and get the rest by catch-up
   gossip.  Prints
   C's time from its start to each milestone, the trust root's RPC calls
   by route (bytes, ms p50/max) and its verify flushes (host prep and
   device ms), the chunks and chunks/s, A's flight recorder over the sync
   (read over A's RPC) and C's launches by stage.  Fails unless C
   restored the snapshot at 4 after rejecting 6, its blocks 5-6 are
   byte-equal to A's, its header at 4 and its sets at 4-8 hash as A's,
   its state equals A's (but the two change heights, H + 1 on a restored
   state, and the sets' proposer priorities, ROADMAP 3.6), its /status
   says caught up, no ERROR comes from the statesync, rpc, fastsync or
   p2p loggers of A, B or C, A and B exit 0 on SIGTERM, and on the card
   the ladder launched for the trust root, kernel 2 once for the
   restored set and the profile's pick in the tail.  A's and B's
   launches happen in their own processes and are not in the kernels
   line.  `phase_statesync(..., keep_running=True)`, as the run calls it,
   hands A, B and C over to phase 13 alive once C has caught up (with the
   event loop C runs on); phase 13's end stops them and makes the checks
   above that need them stopped (exit codes, logs, A's stores).
13. A node from a stock home joins the 10,000-validator chain.  Node D's
   home is written by the port's `init` with its defaults kept (PEX on,
   fast sync on, 10 outbound peers, no persistent peers); added are only
   A as its one seed (`id@host:port`), p2p and RPC on local ports, the
   address book not strict and duplicate IPs allowed (one host), and
   phase 11's genesis.  D is `default_new_node` in this process on the
   card.  As soon as its RPC listens, the port's WSClient subscribes on
   D's /websocket to NewBlock.  D dials A, asks it for addresses, learns
   B and C (source A) and ends connected to A, B and C (either end may
   dial, since B and C learn D from A too); it fast-syncs blocks 1-5 from
   them on the engine (its genesis table built once by kernel 2, the
   first pair check declining onto the ladder while it builds, the later
   ones on the profile's pick) and gets block 6 by catch-up gossip.
   Every block it applies after the subscription must arrive as a
   notification whose block is A's; `status` over the same socket must
   give D's height.  Then the wiring Node.start runs for
   `liteserve.enable` (`Node._start_liteserve`) starts D's gateway: its
   LocalProvider primary, A and B as HTTP witnesses (quorum 2, a 30 s
   witness timeout: each witness read is a 1.4 MB /commit), trust root
   A's header at height 2 (read from A's /commit through the port's
   HTTPClient), its VerifyCache on D's AsyncBatchVerifier.  Starting it
   after catch-up is deliberate: at Node.start D's stores do not hold
   header 2 yet, and the bootstrap gives up after five tries (the JAX
   node does the same).  4 tenants (8 until phase 19 needed the time)
   each open a session (`lite_session_new`) and ask for the commits of
   heights 2-6 at once (20 `lite_commit` answers of ~2 MB of JSON).  Prints D's time from
   its start to the subscription, `node started`, the seed dial, each
   peer learned by PEX, each dial, each applied block, caught up and
   meshed; its book and the PEX frames; the notifications and their lag
   behind `apply_block`; the gateway's bootstrap, its provider reads
   (the witnesses' cross-check ms) and verify flushes; the tenants'
   ms p50/p99/max, bytes and requests/s; the gateway's hits, misses and
   coalesced joins; D's launches by stage.  Fails unless D dialed A
   first and asked it for addresses, holds B and C from A and ends
   connected to A, B and C, its blocks 1-6 are A's byte for byte with
   A's app hash, every notification is A's block, each tenant answer's
   header is A's, the VerifyCache verified at most one commit per height,
   `lite_status` shows 16 sessions and both witnesses without errors, no
   ERROR comes from the pex, addrbook, rpc, liteserve, lite2, fastsync or
   p2p loggers of A, B, C or D, D's stop saves its address book with A,
   B and C, and A's addrbook.json after its SIGTERM holds B, C and D; and
   on the card kernel 2 built D's table once, the ladder served D's
   declined check and the gateway's forward step, the profile's pick
   every table hit of D, and nothing launched for answers the gateway's
   store served.  A's and B's launches are not in the kernels line.
14. A validator across its process boundaries.  Genesis: phase 3's 10,000
   keys at power 10 under a chain id of its own, its time the run's start
   (so `light` keeps its default trusting period of a week).  The node's
   home is phase 10's (config.toml by save_config at the JAX defaults, p2p
   off, the signed-tx precheck with its journal, a mempool of 10,000;
   `timeout_propose` 30 s, as phase 15's) with
   RPC on a local port, `proxy_app` an ABCI socket address,
   `priv_validator_laddr` a local tcp address and `instrumentation
   .prometheus` on with its listener on a local port; no FilePV in it.
   Processes: `python -m tendermint_tpu_torch.abci_cli --address
   tcp://127.0.0.1:<a> kvstore` (the phase waits for its "serving" line);
   a signer (signer_child, by `python -c`) running the port's SignerServer
   over the FilePV files of phase 9's validator (the round-0 proposer of
   height 3), copied to a directory of its own, dialing the node over a
   SecretConnection; the node, default_new_node(load_config(...)) in this
   process on the card, whose start waits for the signer and sends
   InitChain with the 10,000 validators over the socket.  Heights 1-3 run
   phase 10's traffic (a burst of 1,000 signed envelopes before each
   proposal, 1 in 100 corrupted: check_tx verifies on the engine, then
   crosses the socket; the peers' proposals and 64 KB vote_batch frames
   of the other 9,999 validators, one precommit frame a round flipped and
   re-sent clean); height 3 is ours, its proposal and every vote of ours
   signed by the signer process; the run stops at height 4's NEW_HEIGHT.
   Then, the node up: `python -m tendermint_tpu_torch light` (its own
   process and engine, trusting header 1) in front of the node's RPC,
   read for /status, /commit at 2 and 3, /validators at 3 (its 10k set
   paged from the node), /block at 3, an unknown route and /status again;
   /metrics from the node's listener; `abci_cli info` and a `query` of one
   key of height 2's burst against the app; `python -m
   tendermint_tpu_torch.tools.signer_harness` against a second signer
   process on a fresh FilePV.  Then the node stops (hooks given back,
   SignerClient stopped), the signer exits 0 on the closed connection,
   `light` exits 0 on SIGTERM, the app server on SIGINT.  Prints the
   node's start split (the signer's connect wait and InitChain over the
   socket apart), per height what phase 10 prints with the ABCI socket's
   round trips by kind and check_tx over the socket p50/p99, the remote
   signer's ms per vote and per proposal (p50, max), light's start and
   each route's ms and bytes, /metrics' size and ms, the harness's checks,
   the node's launches by stage and the account light logs at its exit
   (its own launches, dispatch paths and table lookups).  Fails unless heights 1-3 commit
   with exactly their bursts' valid txs, block 3 is ours with a proposal
   signature that verifies under the validator key, our precommits in the
   LastCommits of blocks 2-3 and in block 3's seen commit verify, every
   precommit lands or is refused as late, `abci_cli info` gives height 3
   and the node's app hash, the query gives its tx's value, every header,
   block and set light serves equals the node's (JSON; a set but its
   proposer priorities, which the light client's ValidatorSet derives
   itself), its last /status trusts height 3 or more, the unknown route
   gets the JAX error, light's "verify engine" line names a CUDA device
   and its exit account shows launches, a window-table build and no
   dispatch on the host path ("host" or "host-cold"), /metrics has the JAX content type, height 3 and the engine's table
   hits and misses, the harness passes its four checks, every child exits
   0, nothing is logged at ERROR by the node's loggers (consensus,
   privval, abci, mempool, state, lite2, rpc, metrics) or the children,
   and on the card kernel 2 built the node's genesis table once, the
   ladder served every accepted frame and the genesis set's decline and
   the profile's pick every table hit.  light's launches happen in its own
   process and are not in the kernels line.
15. Transactions from outside.  Genesis: phase 3's 10,000 keys at power
   10 under a chain id of its own (chip-smoke-grpc); our validator, the
   round-0 proposer of height 2, signs with a FilePV in the node's home.
   The home is phase 14's without the signer and /metrics (p2p off, the
   signed-tx precheck, a mempool of 10,000) with `abci = "grpc"`,
   `proxy_app` the app's address, `rpc.laddr` and `rpc.grpc_laddr` on local
   ports and `[tpu] min_device_batch = 1` (so the signed-tx lane's flushes
   of a few txs verify on the card).  Processes: `python -m
   tendermint_tpu_torch.abci_cli --abci grpc --address tcp://127.0.0.1:<a>
   kvstore`; the node, default_new_node(load_config(...)) in this process
   on the card, whose handshake sends InitChain of the 10,000 validators
   over gRPC; (a) `python -m tendermint_tpu_torch.tools.loadgen <rpc>
   --connections 8 --rate 1000 --tx-bytes 250 --mode sync --json` (tm-bench's
   rate and size) for 20 s, heights 1-2, which height 1's proposal waits
   for (200 of its txs in the mempool); heights 1-4 with the peers'
   proposals and 64 KB vote frames of the other 9,999 validators as in
   phase 14, height 2 ours, `timeout_propose` 30 s (the peers' proposals
   are built after the node's apply of the firehose's block, see gr_home);
   loadgen's exit is awaited before height 2's precommits, so block 3
   takes its whole backlog; (b) a BroadcastAPIClient in this process: at
   height 4's PROPOSE with block 3 applied (an empty pool) and before the
   proposal, Ping, then BroadcastTx of 8 signed txs with keys of their own
   and of one envelope with a flipped signature byte, each in a task of
   its own.
   Under the firehose the JAX BroadcastTx's fixed 10 s wait for the commit
   expired (10.2-10.6 s: a height at 10k plus DeliverTx and the recheck of
   thousands of txs, each a gRPC round trip), and after it while a block
   held the backlog (10.0 s with 5,959 txs), so (b) follows both.  The run
   stops at height 5's NEW_HEIGHT.  Then (c) `abci_cli --abci grpc info` and
   a `query` of one of (b)'s keys, the node stops and the app exits 0 on
   SIGINT.  Prints the node's start split (InitChain over gRPC apart),
   per height the txs in its block, what phase 14 prints and the ABCI gRPC
   round trips by kind (DeliverTx sum, p50/p99), CheckTx over gRPC (new and
   recheck) p50/p99, validate_block ms, loadgen's JSON line in full, (b)'s
   round trips with the commit wait apart, each gRPC connection's HTTP/2
   frames by type and bytes both ways, the signed-tx lane's verify.flush
   sizes with the engine's dispatches by path, and the launches by stage.
   Fails unless heights 1-4 commit in round 0 as proposed, every tx in
   blocks 1-4 is byte for byte one loadgen sent or one of (b)'s 8, all 8
   are in them, loadgen's accepted equals its txs in blocks 1-4 plus those
   left in the mempool, its transport errors and rejections are 0 (its
   throttled may not be), each of the 8 answers check_tx and deliver_tx
   code 0, the flipped one is refused at CheckTx (the JAX BroadcastTx
   answers the mempool's "invalid tx signature" as gRPC status 2 UNKNOWN),
   Ping answers {}, `info` gives height 4 and the node's app hash, `query`
   the tx's value, every child exits 0, nothing is logged at ERROR by the
   node's loggers or the children, no flat check ran on the host, and on
   the card kernel 2 built the genesis table once, the ladder served every
   signed-tx flush, accepted frame and the genesis set's decline, and the
   profile's pick every table hit.
16. A node's flight record, on phase 11's net (inside phase 11, once both
   nodes hold height 6 and before B's stop).  Every tool runs as `python -m
   tendermint_tpu_torch ...` in a subprocess against A's and B's RPC or
   homes: (1) `trace --check`, `trace --budget --json` and `trace
   --net-budget --json` against each node, at once; (2) `trace-net --rpc
   A,B --check --json`; (3) `debug watch --once --rpc A,B`; (4) `debug dump`
   of A's home and RPC (a live bundle); (5) `debug kill <B's pid>` with B's
   home and RPC: B's bundle, then SIGKILL; (6) `debug dump --offline` of
   B's home; (7) `trace-net <A's recorder.json> <B's spool.json> --check`;
   (8) `debug watch --once` again.  Prints the spool's cost on A over
   heights 1-6 (flushes, events, ms per flush p50 and max, the flight-spool
   task's busy ms by the loop profiler's trampoline, bytes on disk: its
   task starts before the node's profiler, so SpoolProbe drives it through
   the trampoline itself), each node's stage and net budgets, the merge's
   offsets with their sources, the bundles' sections, B's replay (runs,
   events, its newest anchor's age at B's death, writer_lost, torn, bytes),
   each command's seconds and A's launches during the phase.  Fails unless
   A shows at least 3 complete step chains and none broken, B at least 3
   and broken ones only at heights it committed by catch-up before
   NET_JOIN_AT (missing PROPOSE and/or PREVOTE: ROADMAP 3.10; trace-net's
   failures likewise), each budget holds the six stages (A's each over
   heights 2-5), both net budgets are there, the merge aligns heights 2-5,
   the telescope shows both nodes up within a tip spread of 1 and then B
   down and A up, A's bundle holds the JAX live sections, the kill bundle
   is on disk before B dies with exit -9, B's replay holds one run, an
   anchor at most 1 s older than B's death, every event of the kill
   bundle's recorder.json up to its last seq unchanged, at least 3
   complete chains and, on the card, verify.dispatch events of B's kernels
   with their device ms.  Phase 11's checks then open B's SIGKILLed stores,
   and phase 12 restarts B from that home.
17. The chaos rig (the JAX networks/local/chaos_smoke.py and
   disk_smoke.py on the port): two 4-validator localnets, run at the same
   time (a thread each in this process), each made by
   `python -m tendermint_tpu_torch testnet --validators 4 --fast
   --db-backend sqlite --chaos --chaos-seed 7` (with `--twin 0` for (a)) on
   free local ports, then `[tpu] enabled = true` and `min_device_batch = 1`
   in each home (`--fast` turns the engine off, as in the JAX rigs; here
   every vote batch, commit and refill verifies on the card) and /metrics
   on; each node runs `python -m tendermint_tpu_torch --home H node` in its
   own process.  Each scenario is parsed twice (equal fingerprints) and
   staged through the `unsafe_chaos_*` routes and signals while the
   port's InvariantChecker scrapes /status and /blockchain (agreement, no
   height regression).  (a) `twin 0; partition 0,1|2,3 @2~0.5; heal
   @8~0.5; kill 2 @11; restart 2 @13`: fails unless commits stop during
   the partition, resume within 30 s of the heal and of the restart, the
   twin's DuplicateVoteEvidence is committed and reaches the kvstore's
   `__byzantine__` key, a non-twin node's watchdog raises consensus_stall
   during the partition and every live one clears it after, and an honest
   node counts the twin's forged trace fields as clamped.  (b) `rot 3
   blockstore h=3 @2; disk 2 enospc @8~0.5; disk 2 heal @16; kill 2 @18;
   restart 2 @20`: fails unless node 3's integrity scan finds and
   quarantines height 3 and it is refilled from the peers and served
   re-hashing within 45 s, node 2 under ENOSPC raises disk_fault CRITICAL
   with /status and /health up and no CONSENSUS FAILURE (its log names the
   storage halt) while the others commit, node 2 rejoins within 45 s of its
   restart, and every scraped block re-hashes.  Each node's kernel
   dispatches by path are read from its flight recorder over its RPC
   (watermarked); on the card each honest node must have launched kernels
   and verified no batch on the host.  Prints the fingerprints, the rigs'
   numbers (chaos_partition_recovery_ms, disk_fault_recovery_ms,
   store_integrity_scan_ms, enospc_recovery_ms, ...), each node's
   dispatches and its chaos series from /metrics.  The nodes' launches are
   in their own processes and not in the kernels line.
18. Validator sets that change while the card verifies (the bank and
   staking apps).  (a) Full width, in a process of its own (PhaseChild:
   its own launch counters, read there and added to the kernels line)
   beside phases 9, 10 (a) and 15 (see the schedule below): phase 8's
   harness
   (abci_node on sqlite stores, the mempool's signed-tx lane on an
   AsyncBatchVerifier at min_device_batch 16, the installed BatchVerifier
   and TableCache for validate_block) with the app taken through
   proxy.default_client_creator("staking", app_db=<the sqlite app db>);
   genesis: the first 9,985 of phase 3's keys, validator i at power 10 +
   (i mod 7), app_state {"staking": {"epoch_length": 3}} (9,985, so that
   height 4's set is 10,000 strong: the reference refuses a commit of more
   than MaxVotesCount = 10,000 signatures, and a 10,015-validator set
   halts the chain at its first commit).  Per height 1-6, one
   asyncio.gather of check_tx: 990 bank transfers of 1 unit to loadgen's
   hot account from 990 keys outside the set, each at nonce h - 1 (so each
   sends one tx per block; the burst goes in after the previous block
   committed, as CheckTx reads committed nonces, ROADMAP 3.13), an
   overdraft of 2^62 (from a key of its own) in every 50 txs, which CheckTx
   answers 13, and 10 envelopes with a flipped signature byte, which the
   lane refuses.  Height 2 also carries 16 bonds from fresh keys, an edit
   of genesis validator 1 to 25, a leave (edit 0) of validator 2 and an
   ed25519 rotation of validator 3 to a fresh key: height 4's set has
   10,000 validators and new pubkeys.  At the epoch boundary 3 the app's
   barrel shift gives ~8,600 power-only updates: height 5's set keeps
   height 4's pubkeys, so its table comes from the cache (keyed by the
   pubkey digest).  A syncer replays blocks 1-6 by fast sync's Processor
   (block 7 carries 6's commit), and the producer restarts from its sqlite
   stores and app db (0 blocks replayed; the staking records and
   __stk_epoch__ reloaded).  Fails unless each block holds exactly its
   burst's accepted txs, every set's members and powers and EndBlock's
   update counts equal what the harness computes from the txs
   (stk_sets), the hot account's balance and every sender's nonce are the
   harness's, the commit checks miss the table cache only at 2 and 5,
   the app hashes agree on producer, syncer and restart, no flush of 16 or
   more envelopes verifies on the host, all three kernels launch, kernel 2
   exactly twice, and the auto-profile's pick in the producer and the
   syncer.  Prints per height the burst (codes, flush sizes), the
   apply_block split, EndBlock ms with its updates, validator_updates_
   from_abci and update_state ms, each new table's host rows and kernel 2.
   (b) At the same time as phase 17 (a thread of its own): the JAX
   networks/local/rotation_smoke.py on 7 in-process port nodes (the
   staking app, powers 10/20/30/40, epoch 16, blocks paced at 0.25 s, node
   4 the twin, [tpu] enabled at min_device_batch 1): growth 4 -> 7 through
   InProcRig.valset and the JAX scenario (a partition across the set
   change), the twin's evidence committed, the epoch shift, the twin voted
   out; then the JAX rig's BLS step: every node but the twin holds a
   RotatingPV of its ed25519 key and a BLS12-381 one, validators 0-3, 5
   and 6 migrate live to BLS12-381 by `valset migrate N bls` (their six
   txs in flight together), a stored commit above the uniform height
   becomes an AggregateCommit with a 96-byte agg_sig, and after node 0
   rotates back to ed25519 the commits are per vote again; the nodes'
   recorders split the step where every node is past the first aggregate
   height and at the rotation back's tx, and on the card the aggregate
   window (4 aggregate heights) holds no kernel dispatch and
   the windows around it at least one each (the ladder and tabulated
   launches of each window printed); a fresh node fast-syncs the rotated
   history, the aggregate heights included, and lite2 bisects from height
   2 to the tip; then `python -m
   tendermint_tpu_torch.tools.loadgen --mode bank` runs 5 s at 200 tx/s
   over 8 connections against node 0's RPC.  Fails on a checker violation
   (the twin exempt), a missing step, no valset.update or
   verify.table_rebuild event, or when the nodes launched no ladder, no
   pick or (tabulated) no kernel 2.  Prints valset_update_latency_ms,
   lite2_skip_across_rotation_ok, the joiner's height, loadgen's counters
   (its app:12 share is fault 3.13) and the rebuild events beside kernel
   2's launches.
19. The other key types.  (a), in a process of its own beside the end
   of 18 (b) and then (b) (its launches read there, and required to be
   0): BASELINE config #3 (kvstore, 100
   validators, sr25519 keys + multisig): `python -m tendermint_tpu_torch
   init --key-type sr25519` (in the process) writes a home whose FilePV
   holds a random sr25519 key; 99 seeded sr25519 keys join it so that it
   is the round-0 proposer of height 3 (kt_init, kt_sr_keys); phase 9's
   consensus core (cs_run) then runs heights 1-4 on that home at power 10
   each, with 100 plain kvstore txs a height, peers' proposals, vote
   frames routed as the consensus reactor routes them (an sr25519 key
   verifies on the host), one flipped precommit frame a round, the round
   change at 2, our proposal at 3 and the WAL restart at 4.  The chain's
   commits then go through verify_commit and verify_commit_trusting (1/3,
   lite2's call); a 2-of-3 multisig over sr25519 sub-keys verifies on the
   host (valid, below threshold, wrong position), and its vote is refused
   by the 96-byte signature cap, as in the JAX package.  Fails unless the
   ladder and the tabulated sum launch 0 times from the node's start on.
   (b) Phase 3's set with 100 of its keys replaced by sr25519, 4 by
   secp256k1 and 100 by bls12381 keys (9,796 keep ed25519 and phase 3's
   signatures; the BLS members sign the timestamp-free layout, and their
   proofs of possession pass one batch_pop_verify) on an installed
   BatchVerifier and TableCache (tabulated auto): 1. the full commit
   through verify_commit: one flat ladder batch of 9,796 (its
   verify.dispatch event) beside 204 host verifies; one bad signature of
   each type and a high-S secp256k1 signature each raise "wrong signature
   (#i)" at their index; 2. the ed25519 members' commit (the others
   absent) takes the indexed path: kernel 2 builds the mixed set's tables
   (foreign rows as in the JAX package) and the profile's pick serves, cold
   and warm; 3. verify_commit_trusting over the full commit.  Prints each
   check's ms, dispatches and host verify ms by key type.

20. BLS12-381 keys on a mixed set (the state an ed25519 -> BLS12-381
   migration passes through, which the staking app exists for).  `python
   -m tendermint_tpu_torch init --key-type bls12381` (in the process)
   writes a home whose FilePV holds a random BLS key and whose
   genesis.json carries its proof of possession; 49 more seeded bls12381
   keys and 50 ed25519 keys join it so that it is the round-0 proposer of
   height 3 (kt_bls_keys); phase 9's consensus core (cs_run) then runs
   heights 1-4 on that home at power 10 each (genesis checks the 50
   proofs of possession in one batch), `[consensus]
   bls_aggregate_commits` at its default (true), with 100 plain kvstore
   txs a height, peers' proposals, vote frames routed as the consensus
   reactor routes them (ed25519 members to the lane and the ladder, BLS
   members on the host, over the timestamp-free sign-bytes), one flipped
   precommit frame a round, the round change at 2, our proposal at 3 and
   the WAL restart at 4; in a process of its own beside the end of
   18 (b) and then 19 (b), its launches read there and added to the
   kernels line.  A mixed set does
   not fold (only a uniformly BLS set folds: phase 21), so every
   stored commit must be a per-vote Commit; each height's commit then
   goes through verify_commit and verify_commit_trusting (1/3) on an
   installed BatchVerifier, each one flat ladder batch of its ed25519
   signatures.  The BLS tier is the C tier built in phase 1.  Prints the
   host verifies by key type with their count and ms, and fails unless
   the ladder launched in the node's run.
21. A uniformly BLS12-381 net (the JAX networks/local/bls_smoke.py), in a
   process of its own beside the end of 18 (b) and then 19 (b):
   `testnet --validators 4
   --key-type bls12381` (in the process) writes four homes at the default
   config (aggregation on, the engine on the card, sqlite, PEX, fast sync
   on); the four validators run in the process, leaving fast sync
   together, until each is at height 6.  Every
   stored block commit and seen commit below the tip, on every node, must
   be an AggregateCommit whose bitmap holds more than 2/3 of the set, and
   each node's `/commit` must answer with `agg_sig` and `signers` and no
   `signatures` (bls_smoke's check).  Then two empty non-validators join:
   one with fast sync off must catch up through the consensus reactor's
   `agg_commit` lane (its `commit.agg_catchup` events), one with fast sync
   on must fast-sync; its stored aggregate commits then go through
   verify_commit_run in one call, the scheme's memo cleared, one blinded
   pairing product.  Last, validator 3 stops and restarts from its home:
   it must rebuild its AggregateLastCommit and commit again.  Prints each
   part's seconds, the host BLS verifies and pairing checks by count and
   ms, and one height's stored commit (the block store's codec) against
   the per-vote Commit of the same precommits; a uniformly BLS set
   launches no kernel.
22. The batched BLS12-381 point fold (the JAX package's
   crypto/bls/jax_tier.py behind `[tpu] bls_jax_aggregation`), in a
   process of its own beside the end of 18 (b) and then 19 (b).  (a) At
   BASELINE config #5's set size: 10,000 BLS keys from seeds, all signing
   one message (the C tier, SIGN_THREADS threads), decompressed to
   Jacobian ints; cuda_tier.aggregate_g1 / g2 fold the pubkeys (G1) and the
   signatures (G2) once (counted), then each kernel's output is held
   against its plain version's (every limb), the pure fold's and the C
   tier's sum (compressed points), and timed (CUDA events, mean of 5 after
   one warm-up) beside the plain version, the host prep (ints -> limbs) and
   the pure fold (host clock), with its bound.  (b) The aggregate-commit
   paths through the normal entry points on a uniformly BLS set of 1,024
   validators at power 10, (a)'s first 1,024 keys (cut from 10,000: the
   pure tier decompresses every key in Python): 4 heights of precommits
   signed on the C tier; fold_commit, ValidatorSet.verify_commit
   (verify_aggregate_commit) and batch_verify_aggregates over the 4 commits (the second carrying the
   third's aggregate, a valid point: the pairing product fails and the
   per-claim checks attribute it) on the C tier with the fold off, then the
   same calls with the pure tier forced (ctier.set_forced("pure")) and
   scheme.set_jax_aggregation(True) on the card.  Fails unless the bytes and
   verdicts are equal, every fold ran at bucket 1,024 and each launched its
   kernel once.  Prints the pure lane's
   decompressions, host prep, kernels (CUDA events) and pairings by count
   and ms.

Schedule (the run must end within 1,200 s on a slow host): phases 1-5 in
this process; then phases 6-8 (one after another), 14 and 18 (a), each in
a process of its own (PhaseChild), beside phases 9, 10 (a) and 15 in this
one; then phases 11-13 alone (10 (b) on a thread beside 13); then phase 17
with 18 (b), then 19 (b), in this process, with 19 (a), 20, 21 and 22,
each in a process of its own, beside 18 (b) from the end of phase 17 on
and then beside 19 (b).  A child reads its own launch counters and its
own auto-profile's pick (the parent's where it has profiled nothing), and
its result line carries the launches that the parent adds to the kernels
line.

Prints, before the last line, a JSON object {"kernels": [...]} (per kernel
also its threads and warps per SM at the 10k launch (the fold's at its
first, widest tier), registers, stack and spill bytes from the ptxas
log, and bound_ms / ms; the fold kernels' numbers come from phase 22 (a),
their launches, one a fold, from its two entry-point folds and (b)) and
the card line; the last line is {"ok": true, "device": {...}}.  Exits
non-zero, printing no result, without a card, outside a checkout, or when
any phase fails.
"""

from __future__ import annotations

import collections
import contextlib
import io
import json
import os
import subprocess
import sys
import threading
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
SIGN_POOL_MIN = 2000  # from this many votes on, cs_votes signs in worker processes

# Phase 6: the light client's chain (BASELINE config #5 widths)
SEC = 1_000_000_000
LITE_T0 = 1_700_000_000 * SEC
LITE_ROTATE = 3400  # validators replaced at each epoch boundary (34 %)
LITE_EPOCH = 100  # heights per epoch
LITE_TOP = 302  # the chain's last height: 3 set replacements (every LITE_EPOCH heights)
LITE_TARGET = 300  # what the bisections verify: the last height of epoch 2
LITE_TENANTS = 8
# bisection 1 -> 300: (trusted height, untrusted height, trusted?); the
# trust check passes when the two sets are one epoch apart (66 % shared),
# not two (32 %, under the 1/3 trust level)
LITE_STEPS = [(1, 300, False), (1, 150, True), (150, 300, True)]
LITE_HEIGHTS = [300, 150, 1]  # what it persists, descending
LITE_DISTINCT = 3  # distinct headers a bisection asks for: 1 and the 2 untrusted heights

# Phase 7: fast-sync replay from the stores (BASELINE config #5 widths)
REPLAY_TOP = 13  # heights 1 .. 13; block 13's own commit is stored as its seen commit
REPLAY_ROTATE_AT = 7  # the first height on set B
REPLAY_ROTATE = 2500  # set B replaces set A's oldest validators by new keys
REPLAY_TXS, REPLAY_TX_BYTES = 100, 250  # per block
REPLAY_BAD = 5  # a copy of this block carries one flipped signature in its last_commit
REPLAY_BAD_SIG = 1234  # the flipped slot (mod the set size)

# Phase 8: blocks applied to the kvstore app (BASELINE config #5 widths)
ABCI_TOP = 7  # the producer applies 1 .. 7, the syncer 1 .. 6 (7 stays pending, as at the tip)
ABCI_TXS = 1000  # signed envelopes per height
ABCI_CORRUPT = 100  # every 100th envelope carries a flipped signature byte
ABCI_ROTATE_AT = 4  # this block delivers the val: txs; set B serves from ABCI_ROTATE_AT + 2
ABCI_ROTATE = 2500  # val: txs remove this many of the oldest keys and add as many new ones
ABCI_MEMPOOL = 10_000  # an operator's size: the rotation block's txs exceed the default 5,000

# The kernels of the kernels line: the ed25519 path's (phases 2-21) and the
# BLS12-381 fold's (phases 2 and 22)
ED_KERNELS = ("ed25519_ladder", "ed25519_tabulated", "ed25519_window_tables")
FOLD_KERNELS = ("bls12_381_fold_g1", "bls12_381_fold_g2")
KERNELS = ED_KERNELS + FOLD_KERNELS

# Phases 2 and 22: the BLS12-381 point fold
FOLD_SIZES = (8, 9, 33)  # phase 2: points per fold (buckets 8, 16 and 64)
FOLD_POINTS = 10_000  # phase 22 (a): BASELINE config #5's set size
FOLD_SET = 1024  # phase 22 (b): validators (cut from 10,000: the pure tier decompresses in Python)
FOLD_HEIGHTS = 4  # phase 22 (b): commits in one batch_verify_aggregates, one with a wrong aggregate
# The fold's work in 32x32->64 partial products: a 12-limb CIOS multiply
# 144 (a x b) + 144 (m x P) + 12 (m) = 300, a squaring 78 + 144 + 12 = 234
# (a x a's half); an Fp2 multiply 3 Fp multiplies (Karatsuba), an Fp2
# squaring 2 (complex squaring).  A pair of two distinct finite points needs
# add-2007-bl's 12 multiplies and 4 squarings; a pair of equal ones the
# same-x and same-y test (6 multiplies, 2 squarings) and dbl-2009-l (2
# multiplies, 5 squarings); a pair with the identity none (fold_work
# counts the pairs of a run's data)
FOLD_MUL_SQR = {"bls12_381_fold_g1": (300, 234), "bls12_381_fold_g2": (900, 600)}

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


def launch_counts(zero=False, add=None) -> dict:
    """The kernels' launch counters as {report name: count}, every kernel
    of KERNELS; `zero` sets them to 0 after reading, `add` adds to them."""
    from tendermint_tpu_torch.ops import bls12_381_fold, ed25519_cuda, ed25519_table

    where = {"ed25519_ladder": (ed25519_cuda, "LAUNCHES"),
             "ed25519_window_tables": (ed25519_table, "BUILD_LAUNCHES"),
             "ed25519_tabulated": (ed25519_table, "SUM_LAUNCHES"),
             "bls12_381_fold_g1": (bls12_381_fold, "G1_LAUNCHES"),
             "bls12_381_fold_g2": (bls12_381_fold, "G2_LAUNCHES")}
    counts = {k: getattr(m, attr) for k, (m, attr) in where.items()}
    for k, (m, attr) in where.items():
        setattr(m, attr, (0 if zero else counts[k]) + (add or {}).get(k, 0))
    return counts


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
    validator i stamped ts + i, signed by pool_sign from SIGN_POOL_MIN
    validators on, else on SIGN_THREADS threads."""
    from concurrent.futures import ThreadPoolExecutor

    from tendermint_tpu_torch.types.block import BLOCK_ID_FLAG_COMMIT, Commit, CommitSig

    sigs = [CommitSig(BLOCK_ID_FLAG_COMMIT, v.address, ts + i, b"")
            for i, v in enumerate(vset.validators)]
    unsigned = Commit(height, 0, bid, sigs)
    keys = [key_of[cs.validator_address] for cs in sigs]
    msgs = [unsigned.vote_sign_bytes(CHAIN_ID, i) for i in range(len(sigs))]
    if len(keys) >= SIGN_POOL_MIN:
        raw = pool_sign(keys, msgs)
    else:
        with ThreadPoolExecutor(SIGN_THREADS) as ex:
            raw = list(ex.map(lambda job: job[0].sign(job[1]), zip(keys, msgs),
                              chunksize=512))
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
    last step (150 -> 300) with a VerifyCache lookup serving the signatures (what
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
    from tendermint_tpu_torch.statesync import EngineCommitPreverify
    from tendermint_tpu_torch.types.block import Commit, SignedHeader

    def since(before):
        return {k: v - before[k] for k, v in launch_counts().items()}

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
    before = launch_counts()
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

    # run 2: sequence on from the stored header at 500 into the next set,
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

    before = launch_counts()
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
    from tendermint_tpu_torch.state import StateStore
    from tendermint_tpu_torch.store import BlockStore
    from tendermint_tpu_torch.types.block import Block, BlockID, Commit
    from tendermint_tpu_torch.types.params import BLOCK_PART_SIZE_BYTES

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
        before = launch_counts()
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
        launches_a = {k: v - before[k] for k, v in launch_counts().items()}
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


async def abci_node(home, gen, app_db=None, app_name="kvstore"):
    """A node's stores, app and services in `home` (sqlite), wired as
    node.py wires them: StateStore, BlockStore, the builtin app that
    proxy.default_client_creator gives for `app_name` on the app store,
    behind AppConns, an EventBus with an
    IndexerService over a TxIndexer and one subscriber each on NewBlock and
    Tx, then the Handshaker (InitChain at app height 0), timed.  `app_db`
    puts the app on another store than the node's.  The namespace's close()
    stops the services and closes the stores."""
    import asyncio
    import types

    from tendermint_tpu_torch.consensus import Handshaker
    from tendermint_tpu_torch.libs.kvstore import open_db
    from tendermint_tpu_torch.proxy import AppConns, default_client_creator
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
    creator = default_client_creator(app_name, app_db=node.dbs["app"] if app_db is None else app_db)
    node.app = creator().app  # every connection's client shares this app
    node.conns = AppConns(creator)
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
    from tendermint_tpu_torch.state.execution import BlockExecutor, tx_pre_check
    from tendermint_tpu_torch.store import BlockStore
    from tendermint_tpu_torch.types.block import BlockID
    from tendermint_tpu_torch.types.genesis import GenesisDoc, GenesisValidator
    from tendermint_tpu_torch.types.params import BLOCK_PART_SIZE_BYTES

    def since(before):
        return {k: v - before[k] for k, v in launch_counts().items()}

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
        before_a, seq_a, t_a = launch_counts(), next_seq(rec), time.perf_counter()
        flush_launches = dict.fromkeys(before_a, 0)
        rejected, blocks, parts, commits, states, app_hashes = [], {}, {}, {}, {}, {}
        table_hits = {}
        sign_s, wall_a = 0.0, 0.0

        async def submit(h):
            txs = list(bursts[h]) + (list(val_txs) if h == ABCI_ROTATE_AT else [])
            before = launch_counts()
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
        before_b, seq_b = launch_counts(), next_seq(rec)
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
            before = launch_counts()
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


CS_HEIGHTS = 4  # heights 1 .. 4 commit; the run stops at height 5's NEW_HEIGHT
CS_OURS_AT = 3  # our validator is this height's round-0 proposer
CS_WITHHELD_AT = 2  # the round-0 proposer withholds its proposal; round 1 commits
CS_CRASH_AT = 4  # the node stops after its own precommit and recovers from its WAL
CS_FRAME_BYTES = 65536  # a vote_batch frame's cap of Vote.wire() bytes
CS_SENDERS = 4  # peers relaying vote frames, each under a fixed peer id
CS_DIRECT_MIN = 16  # frames this large go through verify_direct (the reactor's rule)


class CsWatch:
    """Hooks on one node's ConsensusState, signer (a FilePV, or a remote
    signer's SignerClient) and EventBus: the time of every step, of each
    vote our signer signs (with the signed vote) and of each completed
    proposal block, and an event the phase waits on."""

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

        def signed(vote):
            self.signed.setdefault((vote.height, vote.round, vote.type),
                                   (time.perf_counter(), vote.to_dict()))
            self.ev.set()

        if asyncio.iscoroutinefunction(sign):  # a remote signer
            async def sign_vote(chain_id, vote):
                await sign(chain_id, vote)
                signed(vote)
        else:
            def sign_vote(chain_id, vote):
                sign(chain_id, vote)
                signed(vote)

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
    node.pv = FilePV.load(*pv_files(home))
    node.cs.set_priv_validator(node.pv)
    node.cs.wal = WAL(os.path.join(home, "data", "cs.wal", "wal"))
    instrument_cs(node)
    return node


def pv_files(home):
    """A home's FilePV key and state files, where `init` writes them."""
    return (os.path.join(home, "config", "priv_validator_key.json"),
            os.path.join(home, "data", "priv_validator_state.json"))


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


def cs_votes(vals, key_of, ours_addr, kind, h, r, block, bid, iota_ns, skip=(),
             chain_id=CHAIN_ID):
    """The other validators' votes of `kind` for (h, r) on bid (the zero id
    for nil), but those of the addresses in `skip`, stamped as _vote_time
    stamps them, signed (pool_sign from SIGN_POOL_MIN votes on, else on
    SIGN_THREADS threads), with their wire bytes; and their sign bytes,
    which are one message for every member of one key domain (a vote's
    sign bytes name no validator; a BLS12-381 member signs the
    timestamp-free layout, Vote.sign_bytes_for_key)."""
    from concurrent.futures import ThreadPoolExecutor

    from tendermint_tpu_torch.types.vote import Vote, is_bls_key

    now = time.time_ns()
    ts = max(now, block.time_ns + iota_ns) if block is not None else now
    votes = [Vote(kind, h, r, bid, ts, v.address, i) for i, v in enumerate(vals.validators)
             if v.address != ours_addr and v.address not in skip]
    bls = [is_bls_key(vals.validators[v.validator_index].pub_key) for v in votes]
    msg = votes[0].sign_bytes(chain_id) if votes else b""
    msg_bls = votes[0].bls_sign_bytes(chain_id) if any(bls) else b""
    msgs = [msg_bls if b else msg for b in bls]
    keys = [key_of[v.validator_address] for v in votes]
    if len(votes) >= SIGN_POOL_MIN and not any(bls):
        sigs = pool_sign(keys, msgs)
    else:
        with ThreadPoolExecutor(SIGN_THREADS) as ex:
            sigs = list(ex.map(lambda k, m: k.sign(m), keys, msgs, chunksize=512))
    for v, s in zip(votes, sigs):
        v.signature = s
        v.wire()
    return votes, msgs


_SIGN_POOL = []  # the worker processes of pool_sign, made at its first call


def pool_sign(keys, msgs):
    """Each key's signature of its message, made by worker processes on
    half the cores (spawned at the first call, shut down at exit; the
    phases' other processes, B, the relays and the apps, keep the rest)
    through the host-prep C library: threads scale poorly on the ctypes
    call, and the node's loop runs meanwhile."""
    import atexit
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    if not _SIGN_POOL:
        _SIGN_POOL.append(ProcessPoolExecutor(
            max(1, SIGN_THREADS // 2), mp_context=multiprocessing.get_context("spawn")))
        atexit.register(_SIGN_POOL[0].shutdown)
    jobs = [(k.bytes(), k.pub_key().bytes(), m) for k, m in zip(keys, msgs)]
    n = -(-len(jobs) // (SIGN_THREADS * 4))
    futs = [_SIGN_POOL[0].submit(sign_chunk, jobs[i:i + n]) for i in range(0, len(jobs), n)]
    return [s for f in futs for s in f.result()]


def sign_chunk(jobs):
    """pool_sign's worker: the signature of each (seed, public key, message)."""
    import ctypes

    sys.path.insert(0, HERE)
    from tendermint_tpu_torch.crypto import hostprep

    lib = hostprep._load_lib()
    if lib is None:
        raise RuntimeError("the host-prep C library did not build")
    out, buf = [], ctypes.create_string_buffer(64)
    for seed, pub, msg in jobs:
        lib.ed25519_sign(seed, pub, msg, len(msg), buf)
        out.append(buf.raw)
    return out


def cut_frames(votes):
    """The votes in vote_batch frames as the consensus reactor cuts them:
    at most CS_FRAME_BYTES of Vote.wire() each."""
    frames, cur, total = [], [], 0
    for v in votes:
        w = len(v.wire())
        if cur and total + w > CS_FRAME_BYTES:
            frames.append(cur)
            cur, total = [], 0
        cur.append(v)
        total += w
    if cur:
        frames.append(cur)
    return frames


def cs_frames(vals, votes, msgs):
    """vote_batch frames (cut_frames); per frame its votes and the
    (pubkey, sign bytes, signature) items it verifies: the raw key where the
    consensus reactor's _engine_key gives one (ed25519), else the PubKey
    itself, which verifies on the host."""
    from tendermint_tpu_torch.consensus.reactor import ConsensusReactor

    msg_of = {id(v): m for v, m in zip(votes, msgs)}

    def key(v):
        pk = vals.validators[v.validator_index].pub_key
        raw = ConsensusReactor._engine_key(pk)
        return pk if raw is None else raw

    return [(f, [(key(v), msg_of[id(v)], v.signature) for v in f]) for f in cut_frames(votes)]


async def cs_verify(lane, items):
    """A frame's verdicts, routed as the consensus reactor's vote_batch
    handler routes them: raw ed25519 keys to the engine (verify_direct from
    CS_DIRECT_MIN of them on, else verify_many), other keys' own verify on
    the host."""
    import asyncio

    engine = [j for j, (pk, _, _) in enumerate(items) if isinstance(pk, bytes)]
    out = [None] * len(items)
    for j, (pk, m, s) in enumerate(items):
        if not isinstance(pk, bytes):
            out[j] = bool(pk.verify(m, s))
    if engine:
        sub = [items[j] for j in engine]
        if len(sub) >= CS_DIRECT_MIN:
            res = await lane.verify_direct(sub)
        else:
            res = await asyncio.gather(*lane.verify_many(sub))
        for j, ok in zip(engine, res):
            out[j] = bool(ok)
    return out


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
    split = (f"per frame host_prep p50 {percentile(prep, 50):.3f} p99 {percentile(prep, 99):.3f} "
             f"ms, device p50 {percentile(dev, 50):.3f} p99 {percentile(dev, 99):.3f} ms" if d
             else "every frame verified on the host by its keys")
    return (f"{n_votes} votes in {len(d)} engine frames, {(t_done - t_sent) * 1000:.3f} ms; "
            f"{split}; receive routine "
            f"_try_add_vote p50 {percentile(add, 50) * 1000:.1f} us, mean "
            f"{sum(add) / max(1, len(add)) * 1000:.1f} us + WAL write "
            f"{wal / max(1, n_votes) * 1000:.1f} us per vote ({card})")


def phase_consensus(keys, card, dev, **kw):
    """The consensus core at full width (see the module docstring, 9).
    Returns the phase's launches by counter, the validate_block calls on
    heights >= 2, the indexed dispatches and the accepted vote frames."""
    import asyncio

    return asyncio.run(cs_run(keys, card, dev, **kw))


async def cs_run(keys, card, dev, traffic=None, home=None, inspect=None):
    """Phase 9's run (cs_run's defaults) or phase 19 (a)'s: `traffic` is
    (bursts by height, the corrupted txs) in place of abci_traffic's
    signed envelopes, `home` a home whose FilePV (config/ and data/, as
    `init` writes them) is the round-0 proposer of CS_OURS_AT among `keys`,
    and `inspect(node)` runs on the stopped node before its stores close."""
    import tempfile

    from tendermint_tpu_torch.consensus.types import RoundStep
    from tendermint_tpu_torch.crypto import batch as batch_hook
    from tendermint_tpu_torch.crypto import batch_verifier as bvm
    from tendermint_tpu_torch.libs.tracing import FlightRecorder
    from tendermint_tpu_torch.mempool import MempoolError
    from tendermint_tpu_torch.privval import FilePV, FilePVKey, FilePVLastSignState
    from tendermint_tpu_torch.state import make_genesis_state
    from tendermint_tpu_torch.types.block import BLOCK_ID_FLAG_COMMIT, BlockID, Commit
    from tendermint_tpu_torch.types.canonical import PRECOMMIT_TYPE, PREVOTE_TYPE
    from tendermint_tpu_torch.types.genesis import GenesisDoc, GenesisValidator
    from tendermint_tpu_torch.types.params import BLOCK_PART_SIZE_BYTES
    from tendermint_tpu_torch.types.proposal import Proposal
    from tendermint_tpu_torch.types.validator import ValidatorSet
    from tendermint_tpu_torch.types.vote import is_bls_key

    n = len(keys)
    t0 = time.perf_counter()
    bursts, bad_txs = traffic or abci_traffic(keys, [], top=CS_HEIGHTS)[:2]
    key_of = {k.pub_key().address(): k for k in keys}
    # a BLS12-381 member carries its proof of possession (genesis checks
    # them in one batch)
    gen = GenesisDoc(CHAIN_ID, genesis_time_ns=LITE_T0, validators=[
        GenesisValidator(k.pub_key().address(), k.pub_key(), 10,
                         pop=k.pop() if is_bls_key(k.pub_key()) else b"") for k in keys])
    vals = make_genesis_state(gen).validators.copy()
    vals.increment_proposer_priority(CS_OURS_AT - 1)
    ours = key_of[vals.get_proposer().address]
    ours_addr = ours.pub_key().address()
    if home is not None and FilePV.load(*pv_files(home)).address() != ours_addr:
        raise AssertionError(f"the FilePV in {home} is not the round-0 proposer of {CS_OURS_AT}")
    log(f"  traffic: {CS_HEIGHTS} bursts of {len(bursts[1])} txs ({len(bad_txs)} corrupted) "
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
    tmp = None
    if home is None:
        tmp = tempfile.TemporaryDirectory(prefix="chip-smoke-cs-")
        home = tmp.name
        for d in ("config", "data"):
            os.makedirs(os.path.join(home, d))
        key_file, state_file = pv_files(home)
        FilePV(FilePVKey(ours_addr, ours.pub_key(), ours, key_file),
               FilePVLastSignState(file_path=state_file)).save()
    timer = StepTimer()
    verify_commit = timer.wrap(ValidatorSet, "verify_commit",
                               height_of=lambda vs, chain_id, bid, height, *a, **k: height + 1)
    node, old = None, None
    before, seq0 = launch_counts(), next_seq(rec)
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
            launches = {k: v - before[k] for k, v in launch_counts().items()}
            await node.settle(node.block_store.load_block(CS_HEIGHTS))
            cs_report(old, node, rec, seq0, per_h, timer, sign_s, launches, dev, cache, card)
            cs_check(node, n, ours_addr, proposals, per_h, bursts, bad_txs, errors,
                     BLOCK_ID_FLAG_COMMIT)
            if inspect is not None:
                inspect(node)
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
        if tmp is not None:
            tmp.cleanup()
    return {"launches": launches, "validate_blocks": validate_blocks,
            "indexed_dispatches": len(indexed), "frames": frames_ok}


async def cs_build(node, key, h, r, BlockID, Commit, Proposal, part_size, chain_id=CHAIN_ID):
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
    prop.signature = key.sign(prop.sign_bytes(chain_id))
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
    from tendermint_tpu_torch.types.vote import is_bls_key

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

    def signed_part(d):
        # a BLS12-381 key signs no timestamp: its FilePV re-signs with the
        # stored signature and leaves the request's timestamp (as in the
        # JAX package), so only the signed fields must be equal
        if d is None or not is_bls_key(node.pv.get_pub_key()):
            return d
        return {k: v for k, v in d.items() if k != "timestamp_ns"}

    if not resigned or any(signed_part(v[1]) != signed_part(own.get(k, (0, None))[1])
                           for k, v in resigned.items()):
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
        f"{len(resigned)} vote(s) with equal signed fields; down {_ms(t1) + stop_ms:.3f} ms in all ({card})")
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


NODE_HEIGHTS = 4  # phase 10: heights 1 .. 4 commit; the run stops at height 5's NEW_HEIGHT
NODE_ROTATE_AT = 1  # this block carries the val: txs; set B serves from NODE_ROTATE_AT + 2
NODE_ROTATE = 2500  # val: txs remove this many of the oldest keys and add as many new ones
NODE_CRASH_AT = 4  # the node stops after its own precommit; a second node resumes the home
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
    and a mempool that holds height 1's 6,000 txs; the genesis file; the
    FilePV files of `ours`.  Returns the config file's path."""
    from tendermint_tpu_torch.config import Config, save_config
    from tendermint_tpu_torch.privval import FilePV, FilePVKey, FilePVLastSignState

    cfg = Config(home=home)
    cfg.base.chain_id = CHAIN_ID
    cfg.p2p.laddr, cfg.rpc.laddr = "none", ""
    cfg.mempool.sig_precheck = True
    cfg.mempool.wal_dir = "data/mempool.wal"
    cfg.mempool.size = ABCI_MEMPOOL  # the default 5,000 cannot hold height 1's 6,000
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
        from tendermint_tpu_torch.crypto import batch as batch_hook
        from tendermint_tpu_torch.crypto import batch_verifier as bvm
        from tendermint_tpu_torch.state import StateStore
        from tendermint_tpu_torch.state.execution import BlockExecutor
        from tendermint_tpu_torch.store import BlockStore
        from tendermint_tpu_torch.types.validator import ValidatorSet

        self.timer, self.start = StepTimer(), StepTimer()
        self.views, self.vb, self.handshakes, self.watch_loads = [], [], [], []
        self.lookups = []  # (height, [hit, ...]) of each recorded validate_block
        self.rec = None  # the current node's FlightRecorder
        self.executor = None  # when set, only its validate_block calls are recorded
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
            if probe.executor is not None and ex is not probe.executor:
                return validate(ex, state, block)
            # the recorder of the installed TableCache's engine, which
            # records the call's verify.table event (the current node's)
            cache = getattr(batch_hook.get_indexed_verifier(), "__self__", None)
            rec = getattr(getattr(cache, "verifier", None), "recorder", None) or probe.rec
            s0, t0 = next_seq(rec), time.perf_counter()
            try:
                return validate(ex, state, block)
            finally:
                probe.timer.add(("validate_block", block.height), t0)
                s1 = next_seq(rec)
                probe.vb.append((block.height, rec, s0, s1))
                probe.lookups.append((block.height, [
                    e["hit"] for e in rec.events(since=s0, kinds=["verify.table"])
                    if e["seq"] < s1]))

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
    cats = ", ".join(f"{c} {busy[c]:.1f}" for c in loopprof.CATEGORIES)
    return (f"{(t1 - t0) * 1000:.1f} ms: busy ms {cats}; GC {gc_ms:.1f} ms; loop lag p90 "
            f"{percentile(lags, 90) if lags else 0.0:.1f} max {max(lags, default=0.0):.1f} ms "
            f"over {len(lags)} probes; shares {att}")


async def drive_heights(node, v, top, key_of, ours_addr, burst, per_h, proposals, card,
                        chain_id=CHAIN_ID, on_precommitted=None, before_propose=None):
    """Heights 1 .. top of one node's consensus (`v` its CsWatch view)
    under phase 9's traffic, phases 10 (a) and 14; height 1's burst is
    already in its mempool.  Each height: a peer's proposal (built by
    cs_build) or the node's own; the other validators' prevote frames;
    once our precommit is signed, `burst(node, h + 1)` of the next
    height's envelopes; their precommit frames, one flipped and re-sent
    clean.  Stops at height top + 1's NEW_HEIGHT.  Into per_h[h]: the
    lines phase 10 prints, the LastCommit and the precommits refused as
    late, the COMMIT time and, for h < top, the COMMIT -> PROPOSE window
    with the loop profiler's split.  `on_precommitted(h, node, v)`,
    awaited once our precommit for h is signed and the next burst is in,
    may replace the node (phase 10's restart) by returning the (node,
    view) to go on with.  `before_propose(h, node, v)` is awaited once the
    node is at height h's PROPOSE, before a peer's proposal is built.
    Returns (node, view, the s spent signing and
    framing the peers' votes (on a thread, the loop running), the frames
    sent)."""
    import asyncio

    from tendermint_tpu_torch.consensus.types import RoundStep
    from tendermint_tpu_torch.types.block import BlockID, Commit
    from tendermint_tpu_torch.types.canonical import PRECOMMIT_TYPE, PREVOTE_TYPE
    from tendermint_tpu_torch.types.params import BLOCK_PART_SIZE_BYTES
    from tendermint_tpu_torch.types.proposal import Proposal

    w = v.watch
    iota_ns = node.state.consensus_params.block.time_iota_ms * 1_000_000
    sign_s, frames_ok = 0.0, 0
    for h in range(1, top + 1):
        st = per_h.setdefault(h, {"lines": []})
        await w.until(lambda: w.at(h, 0, RoundStep.PROPOSE), f"propose {h}/0")
        if h > 1:
            per_h[h - 1]["window"] = (w.t(h - 1, 0, RoundStep.COMMIT),
                                      w.t(h, 0, RoundStep.PROPOSE))
            per_h[h - 1]["split"] = loop_split(node.flight_recorder, *per_h[h - 1]["window"])
        proposer = v.cs.rs.validators.get_proposer().address
        who = "ours" if proposer == ours_addr else "peer"
        if before_propose is not None:
            await before_propose(h, node, v)
        if who == "peer":
            prop, parts, build_ms = await cs_build(v, key_of[proposer], h, 0, BlockID, Commit,
                                                   Proposal, BLOCK_PART_SIZE_BYTES,
                                                   chain_id=chain_id)
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

        def sign_frames(kind):
            return cs_frames(rs.validators, *cs_votes(
                rs.validators, key_of, ours_addr, kind, h, 0, block, bid, iota_ns,
                chain_id=chain_id))

        # on a thread: the node's loop goes on serving its RPC and apps meanwhile
        pv_frames, pc_frames = await asyncio.get_running_loop().run_in_executor(
            None, lambda: (sign_frames(PREVOTE_TYPE), sign_frames(PRECOMMIT_TYPE)))
        sign_s += time.perf_counter() - t_s
        seq, add0, wal0 = next_seq(node.flight_recorder), len(v.add_ms), len(v.wal_ms)
        t_sent = await cs_send(v, pv_frames)
        frames_ok += len(pv_frames)
        prevotes = rs.votes.prevotes(0)
        await w.until(lambda: prevotes.bit_array().count() == nv, f"prevotes {h}")
        st["lines"].append("prevotes: " + cs_ingest_line(
            v, node.flight_recorder, seq, t_sent, time.perf_counter(), nv - 1, add0, wal0, card))
        await w.until(lambda: (h, 0, PRECOMMIT_TYPE) in w.signed
                      and v.cs.rs.votes.precommits(0).get_by_address(ours_addr) is not None,
                      f"our precommit {h}")
        if h < top:
            await burst(node, h + 1)
        if on_precommitted is not None:
            swapped = await on_precommitted(h, node, v)
            if swapped is not None:
                node, v = swapped
                w = v.watch
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
    await w.until(lambda: w.at(top + 1, 0, RoundStep.NEW_HEIGHT), "the last height")
    return node, v, sign_s, frames_ok


async def node_run(keys, card, dev):
    import base64
    import tempfile
    import threading

    from tendermint_tpu_torch.config import load_config
    from tendermint_tpu_torch.consensus import replay as cs_replay
    from tendermint_tpu_torch.crypto import batch as batch_hook
    from tendermint_tpu_torch.libs import loopprof
    from tendermint_tpu_torch.mempool import MempoolError
    from tendermint_tpu_torch.node import default_new_node
    from tendermint_tpu_torch.state import make_genesis_state
    from tendermint_tpu_torch.types.block import BLOCK_ID_FLAG_COMMIT
    from tendermint_tpu_torch.types.genesis import GenesisDoc, GenesisValidator
    from tendermint_tpu_torch.types.validator import Validator

    t0 = time.perf_counter()
    gen = GenesisDoc(CHAIN_ID, genesis_time_ns=LITE_T0, validators=[
        GenesisValidator(k.pub_key().address(), k.pub_key(), 10) for k in keys])
    key_of = {k.pub_key().address(): k for k in keys}
    out_keys = keys[:NODE_ROTATE]
    new_keys = make_keys(NODE_ROTATE, prefix="node")
    key_of.update((k.pub_key().address(), k) for k in new_keys)
    # our validator: the round-0 proposer of CS_OURS_AT in set B, whose
    # priorities are derived as update_state derives them in the node
    vals = make_genesis_state(gen).validators
    changes = ([Validator.new(k.pub_key(), 0) for k in out_keys]
               + [Validator.new(k.pub_key(), 10) for k in new_keys])
    for h in range(1, CS_OURS_AT):
        vals = vals.copy()
        if h == NODE_ROTATE_AT + 1:
            vals.update_with_change_set(changes)
        vals.increment_proposer_priority(1)
    ours = key_of[vals.get_proposer().address]
    if ours in new_keys:
        raise AssertionError(f"set B's proposer of height {CS_OURS_AT} is one of its new keys")
    ours_addr = ours.pub_key().address()
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
    recs, nodes = [], []
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

    async def restart_at(h, old, v):
        """In height NODE_CRASH_AT, once our precommit is signed: the node
        stops and a second one resumes its home (catchup_replay timed, its
        WAL records counted, our re-signed votes held to what the first
        signed)."""
        if h != NODE_CRASH_AT:
            return None
        own = {k: s for k, s in v.watch.signed.items() if k[0] == h}
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
        if not resigned or any(s[1] != own.get(k, (0, None))[1] for k, s in resigned.items()):
            raise AssertionError(f"the FilePV re-signed {sorted(resigned)} differently from "
                                 f"before the stop ({sorted(own)})")
        if probe.handshakes[-1] != 0 or len(catchup) != 1 or not records["msg"]:
            raise AssertionError(f"the handshake replayed {probe.handshakes[-1]} blocks, or "
                                 f"catchup_replay ran {len(catchup)} times over {dict(records)}")
        restart["line"] = (
            f"restart in height {h}: stop {restart['stop_ms']:.3f} ms; catchup_replay "
            f"{catchup[0]:.3f} ms over {sum(records.values())} WAL records {dict(records)}; the "
            f"FilePV re-signed {len(resigned)} vote(s) byte-equal; the mempool reopened its "
            f"journal ({len(node.mempool.wal_txs())} txs in it); down {restart['ms']:.3f} ms in "
            f"all")
        return node, v

    node = None
    restart = {}
    try:
        with consensus_errors(NODE_LOGGERS) as errors, table_timing(None, builds, dev):
            node = await start_node("first start")
            await burst(node, 1)
            seq0 = next_seq(node.flight_recorder)
            node, _, sign_s, frames_ok = await drive_heights(
                node, probe.views[-1], NODE_HEIGHTS, key_of, ours_addr, burst, per_h, proposals,
                card, on_precommitted=restart_at)
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


class Beside:
    """fn, a phase part whose work runs in subprocesses (it launches no
    kernel in this process), on a thread of its own beside the phase the
    caller runs next; join() waits for it, logs its seconds and re-raises
    its error."""

    def __init__(self, phase, fn):
        self.phase, self.fn, self.error, self.t0 = phase, fn, None, time.perf_counter()
        self.thread = threading.Thread(target=self._run, name=f"phase {phase}", daemon=True)
        self.thread.start()

    def _run(self):
        try:
            self.fn()
        except BaseException as e:  # noqa: BLE001 - re-raised by join()
            self.error = e

    def join(self):
        self.thread.join()
        if self.error is not None:
            raise self.error
        log(f"  phase {self.phase} took {time.perf_counter() - self.t0:.3f} s, beside")


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
    env = child_env()
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


NET_HEIGHTS = 6  # phase 11: heights 1 .. 6 commit on both nodes
NET_B_START = 3  # node B starts once A has committed this height
NET_JOIN_AT = 4  # the relays hold this height's votes until A sees B at it
NET_B_AT = 5  # B's validator is this height's round-0 proposer
NET_BAD_AT = 4  # a flipped precommit frame and a conflicting prevote
NET_RELAYS = 4  # relay peers standing in for the other validators
NET_TIMEOUT_PROPOSE = 120.0  # s: A's PROPOSE of 4 waits for B's start (net_home says why)
NET_LOGGERS = NODE_LOGGERS + ("p2p", "mconn", "cs-reactor", "fastsync", "mempool-reactor",
                              "evidence-reactor", "evidence", "p2p-transport")
SS_SNAPSHOT_INTERVAL = 2  # phase 11's nodes leave app snapshots at even heights (phase 12)
NET_RECORDER_SIZE = 32768  # phase 11's flight recorder rings (net_home says why)


class NetRelay:
    """A relay peer of phase 11, in the relay process (relay_child): its own
    NodeKey, Transport and Switch of the port, dialing A as a persistent
    peer; a driver reactor on channels 0x20-0x23 that follows A's
    new_round_step (and announces the same height, round and step back),
    and a sink for A's mempool, evidence and fast-sync gossip, which the
    relays ignore."""

    def __init__(self, i):
        from tendermint_tpu_torch.consensus import reactor as cs_reactor
        from tendermint_tpu_torch.encoding import codec
        from tendermint_tpu_torch.p2p import NodeInfo, NodeKey, Reactor, Switch, Transport
        from tendermint_tpu_torch.p2p.conn.connection import ChannelDescriptor
        from tendermint_tpu_torch.p2p.node_info import GOSSIP_TRACE_VERSION

        self.i = i
        nk = NodeKey.generate()
        ni = NodeInfo(node_id=nk.id, network=CHAIN_ID, moniker=f"relay{i}",
                      gossip_version=GOSSIP_TRACE_VERSION)
        self.switch = Switch(Transport(nk, ni), allow_duplicate_ip=True)

        class Driver(Reactor):
            def get_channels(self):
                return cs_reactor.ConsensusReactor.get_channels(None)

            async def receive(self, chan_id, peer, msg_bytes):
                if chan_id != cs_reactor.STATE_CHANNEL:
                    return  # A's votes, parts and proposals: ignored
                msg = codec.loads(msg_bytes)  # not _dec: the phase counts A's decodes there
                if msg.pop("k") == "new_round_step":  # announce A's height, round and step back
                    await peer.send(cs_reactor.STATE_CHANNEL, cs_reactor._enc(
                        "new_round_step", dict(msg, seconds_since_start=0.0)))

        class Sink(Reactor):
            def get_channels(self):
                return [ChannelDescriptor(id=c, priority=1, send_queue_capacity=8)
                        for c in (0x30, 0x38, 0x40)]

        self.switch.add_reactor("DRIVER", Driver(f"relay{i}-driver"))
        self.switch.add_reactor("SINK", Sink(f"relay{i}-sink"))

    @property
    def node_id(self):
        return self.switch.node_id

    async def start(self, a_addr):
        await self.switch.start()
        await self.switch.dial_peers_async([a_addr], persistent=True)

    def peer(self, a_id):
        return self.switch.peers.get(a_id)

    async def send(self, a_id, chan, frames):
        """The frames to A in order, through the switch's peer."""
        peer = self.peer(a_id)
        if peer is None:
            raise AssertionError(f"relay {self.i} is not connected to A")
        for f in frames:
            if not await peer.send(chan, f):
                raise AssertionError(f"relay {self.i}'s send to A was refused")


def relay_child() -> int:
    """Phase 11's relay process (see NetRelays): NET_RELAYS NetRelays on
    this process's own event loop, so their packing and sealing is not
    charged to node A.  Requests come on stdin and replies go to stdout,
    each a 4-byte big-endian length and a pickle: (id, op, args) in, (id,
    ok, value) out.  Ops: "start" (A's id and address; returns the relays'
    node ids), "load" (frames by (kind, relay)), "send" (relay, channel,
    frames or a loaded kind, a replacement for the last frame, a frame to
    append), "connected" (per relay, whether it holds a link to A) and
    "stop" (returns the ERROR records of the relays' loggers)."""
    import asyncio
    import pickle

    sys.path.insert(0, HERE)
    out_fd = os.dup(1)
    os.dup2(2, 1)  # stray prints go to the log, not into the replies

    def reply(rid, ok, value):
        data = pickle.dumps((rid, ok, value))
        buf = memoryview(len(data).to_bytes(4, "big") + data)
        while buf:
            buf = buf[os.write(out_fd, buf):]

    async def serve(errors):
        loop = asyncio.get_running_loop()
        reader = asyncio.StreamReader()
        await loop.connect_read_pipe(lambda: asyncio.StreamReaderProtocol(reader),
                                     sys.stdin.buffer)
        relays = [NetRelay(k) for k in range(NET_RELAYS)]
        loaded, tasks, a = {}, set(), {}

        async def handle(rid, op, args):
            try:
                value = None
                if op == "start":
                    a["id"] = args[0]
                    for r in relays:
                        await r.start(args[1])
                    value = [r.node_id for r in relays]
                elif op == "load":
                    loaded.update(args[0])
                elif op == "send":
                    k, chan, frames, last, extra = args
                    frames = list(loaded.pop((frames, k)) if isinstance(frames, str) else frames)
                    if last is not None:
                        frames[-1] = last
                    if extra is not None:
                        frames.append(extra)
                    await relays[k].send(a["id"], chan, frames)
                elif op == "connected":
                    value = [r.peer(a["id"]) is not None for r in relays]
                elif op == "stop":
                    for r in relays:
                        await r.switch.stop()
                    value = list(errors)
                else:
                    raise ValueError(f"unknown op {op!r}")
                reply(rid, True, value)
            except Exception as e:
                reply(rid, False, f"{type(e).__name__}: {e}")

        try:
            while True:
                n = int.from_bytes(await reader.readexactly(4), "big")
                rid, op, args = pickle.loads(await reader.readexactly(n))
                t = loop.create_task(handle(rid, op, args))
                tasks.add(t)
                t.add_done_callback(tasks.discard)
                if op == "stop":
                    await t
                    return 0
        finally:
            for r in relays:
                if r.switch.is_running:
                    await r.switch.stop()

    with consensus_errors(NET_LOGGERS) as errors:
        return asyncio.run(serve(errors))


CHILD_READY_S = 300.0  # a child's ready line (light's is after its trust root's ~100 pages)
CHILD_STOP_S = 30.0  # a child's exit after its signal (or, a signer's, after the node's stop)


def child_env() -> dict:
    """The environment of a process the phases start: this checkout first
    on PYTHONPATH, output unbuffered."""
    return dict(os.environ, PYTHONUNBUFFERED="1",
                PYTHONPATH=os.pathsep.join(p for p in (HERE, os.environ.get("PYTHONPATH")) if p))


class Child:
    """One Python process of a phase (phase 11's relays, phase 14's app
    server, signers, `light`, harness and one-shot abci_cli): stdout piped
    (stdin too with `stdin`), stderr in `log_dir`/`name`.log."""

    def __init__(self, name, argv, log_dir, stdin=False):
        self.name, self.argv, self.stdin = name, argv, stdin
        self.log_path = os.path.join(log_dir, f"{name}.log")
        self.proc = self._log = None
        self.rc, self.out = None, ""

    async def start(self, ready=None):
        """Spawn; with `ready`, wait for the first stdout line and require
        it to start with `ready`.  Returns the seconds to that line."""
        import asyncio

        self._log = open(self.log_path, "w")
        t0 = time.perf_counter()
        self.proc = await asyncio.create_subprocess_exec(
            sys.executable, *self.argv, stdout=asyncio.subprocess.PIPE, stderr=self._log,
            stdin=asyncio.subprocess.PIPE if self.stdin else None, env=child_env(), cwd=HERE)
        if ready is None:
            return 0.0
        try:
            line = (await asyncio.wait_for(self.proc.stdout.readline(), CHILD_READY_S)).decode()
        except asyncio.TimeoutError:
            line = ""
        if not line.startswith(ready):
            raise AssertionError(f"{self.name} did not start ({line!r}): {self.read_log()[-3000:]}")
        return time.perf_counter() - t0

    async def wait_log(self, text, timeout=CHILD_READY_S):
        """Wait until the log holds `text` (the process must stay up)."""
        import asyncio

        deadline = time.perf_counter() + timeout
        while text not in self.read_log():
            if self.proc.returncode is not None:
                raise AssertionError(f"{self.name} exited {self.proc.returncode}: "
                                     f"{self.read_log()[-3000:]}")
            if time.perf_counter() > deadline:
                raise AssertionError(f"{self.name} logged no {text!r}: {self.read_log()[-3000:]}")
            await asyncio.sleep(0.05)

    def read_log(self):
        with open(self.log_path) as f:
            return f.read()

    async def finish(self, sig=None, timeout=CHILD_STOP_S):
        """Signal (or not) and wait for the exit; the exit code and stdout."""
        import asyncio

        if self.proc is None or self.rc is not None:
            return self.rc
        if sig is not None and self.proc.returncode is None:
            self.proc.send_signal(sig)
        try:
            out, _ = await asyncio.wait_for(self.proc.communicate(), timeout)
            self.out = out.decode()
            self.rc = self.proc.returncode
        finally:
            if self.proc.returncode is None:
                self.proc.kill()
                await self.proc.wait()
            self._log.close()
        return self.rc

    def errors(self):
        """Tracebacks, and ERROR lines of libs/log.py's format."""
        return [ln for ln in self.read_log().splitlines()
                if ln.startswith("Traceback") or ln[24:26] == "E " or "abci app error" in ln]


class NetRelays:
    """Phase 11's relay peers in a process of their own (relay_child, by
    `python -c`): the packing and sealing of their ~10,000 votes a kind,
    and their reading of what A gossips back, run on another core and
    another event loop than node A's, so A's ingest, its heights/s and its
    loop profiler's account are A's alone.  `call` sends one request and
    awaits its reply; the frames of a height are loaded before the clock of
    their ingest starts, then sent by kind."""

    def __init__(self, log_dir):
        self.child = Child("relays", ["-c", "import sys, chip_smoke; "
                                      "sys.exit(chip_smoke.relay_child())"], log_dir, stdin=True)
        self.proc, self.ids = None, []
        self._calls, self._n, self._reader = {}, 0, None

    async def spawn(self):
        import asyncio

        await self.child.start()
        self.proc = self.child.proc
        self._reader = asyncio.get_running_loop().create_task(self._read())

    def read_log(self):
        return self.child.read_log()

    async def _read(self):
        import asyncio
        import pickle

        try:
            while True:
                n = int.from_bytes(await self.proc.stdout.readexactly(4), "big")
                rid, ok, value = pickle.loads(await self.proc.stdout.readexactly(n))
                fut = self._calls.pop(rid)
                if ok:
                    fut.set_result(value)
                else:
                    fut.set_exception(AssertionError(f"the relay process: {value}"))
        except asyncio.IncompleteReadError:
            pass
        for fut in self._calls.values():
            fut.set_exception(AssertionError(
                f"the relay process exited: {self.read_log()[-3000:]}"))
        self._calls.clear()

    async def call(self, op, *args):
        import asyncio
        import pickle

        if self._reader.done():
            raise AssertionError(f"the relay process exited: {self.read_log()[-3000:]}")
        self._n += 1
        fut = asyncio.get_running_loop().create_future()
        self._calls[self._n] = fut
        data = pickle.dumps((self._n, op, args))
        self.proc.stdin.write(len(data).to_bytes(4, "big") + data)
        await self.proc.stdin.drain()
        return await fut

    async def start(self, a_id, a_addr):
        self.ids = await self.call("start", a_id, a_addr)

    async def send(self, k, chan, frames, last=None, extra=None):
        await self.call("send", k, chan, frames, last, extra)

    async def linked(self, a):
        """Every relay holds a link to A, and A one to each relay."""
        return all(await self.call("connected")) and all(i in a.switch.peers for i in self.ids)

    async def stop(self):
        """Stops the relays' switches and the process; returns the ERROR
        records of the relays' loggers."""
        errors = await self.call("stop")
        rc = await self.proc.wait()
        if rc != 0:
            raise AssertionError(f"the relay process exited {rc}: {self.read_log()[-3000:]}")
        return errors

    async def close(self):
        if self.proc is not None and self.proc.returncode is None:
            self.proc.kill()
            await self.proc.wait()
        if self._reader is not None:
            await self._reader
        if self.child._log is not None:
            self.child._log.close()


def net_frames(votes, have):
    """(votes, encoded vote_batch frame) in the consensus reactor's format
    (consensus/reactor.py _send_vote_batch and _enc), cut by cut_frames,
    with the sender's possession bitmap `have`."""
    from tendermint_tpu_torch.consensus.reactor import _enc

    return [(f, _enc("vote_batch", {"votes": [v.wire() for v in f], "h": f[0].height,
                                    "r": f[0].round, "t": f[0].type, "have": have}))
            for f in cut_frames(votes)]


def net_home(home, gen, key, moniker, rpc_port, peers=""):
    """A phase 11 node's home: config.toml by save_config at the JAX
    defaults but `moniker`, p2p.laddr on a free local port, PEX off,
    duplicate IPs allowed (every peer is on 127.0.0.1), RPC on `rpc_port`
    (phase 16's tools read it), the flight spool on at its JAX defaults
    (0.25 s flushes, a 4 MiB cap) and a flight recorder of
    NET_RECORDER_SIZE events, the signed-tx precheck with its journal
    and a mempool of 10,000, app snapshots every 2 heights (the JAX
    defaults keep 2, in chunks of 65,536 bytes; phase 12 restores one),
    `timeout_propose = NET_TIMEOUT_PROPOSE` and `peers` as persistent
    peers; the genesis file; the FilePV files of `key`; the node key.
    Returns the config file's path and the node id.

    B hears every vote of height 4 second-hand, through A's gossip, so it
    commits 4 1-3.3 s after A does (on the H100's host), and then has its
    own COMMIT -> PROPOSE window (~3 s at 10k) before it proposes 5: its
    proposal reaches A 3-5.3 s into A's round, past the default 3 s
    `timeout_propose`, at which A would prevote nil.  And height 4's relay
    proposal waits, with A in its PROPOSE step, until B has started,
    fast-synced, caught up and entered its own PROPOSE step of 4: tens of
    seconds on the card, hence 120 s.  A node of this net records about
    13,000 events over heights 1-6 on the H100's host, past the default
    ring of 8,192: B's then holds only heights 4-7, so `trace` reads two
    of its chains.  The ring is sized to the run, as `trace
    --check`'s warning tells an operator to size it."""
    from tendermint_tpu_torch.config import Config, save_config
    from tendermint_tpu_torch.p2p import NodeKey
    from tendermint_tpu_torch.privval import FilePV, FilePVKey, FilePVLastSignState

    cfg = Config(home=home)
    cfg.base.chain_id, cfg.base.moniker = CHAIN_ID, moniker
    cfg.p2p.laddr, cfg.p2p.pex = "127.0.0.1:0", False
    cfg.rpc.laddr = f"tcp://127.0.0.1:{rpc_port}"
    cfg.instrumentation.flight_spool = True
    cfg.instrumentation.flight_recorder_size = NET_RECORDER_SIZE
    cfg.p2p.persistent_peers = peers
    cfg.p2p.allow_duplicate_ip = True  # every peer dials from 127.0.0.1
    cfg.mempool.sig_precheck = True
    cfg.mempool.wal_dir = "data/mempool.wal"
    cfg.mempool.size = ABCI_MEMPOOL
    cfg.statesync.snapshot_interval = SS_SNAPSHOT_INTERVAL
    cfg.consensus.timeout_propose = NET_TIMEOUT_PROPOSE
    cfg.ensure_dirs()
    path = os.path.join(home, "config", "config.toml")
    save_config(cfg, path)
    gen.save_as(cfg.genesis_file())
    addr = key.pub_key().address()
    FilePV(FilePVKey(addr, key.pub_key(), key, cfg.priv_validator_key_file()),
           FilePVLastSignState(file_path=cfg.priv_validator_state_file())).save()
    return path, NodeKey.load_or_gen(cfg.node_key_file()).id


class NetB:
    """Node B: through the CLI in a subprocess (`python -m
    tendermint_tpu_torch --home HB node`), or in this process for the CPU
    rehearsal.  Gives its start time, its stop's exit code and what it did:
    the fast-sync hand-over (wall time, height, blocks synced) and the wall
    time of each commit, read from its log (libs/log.py's format) or, in
    this process, from its reactor and its ConsensusState's hooks."""

    _holding = 0  # in-process starts under way (their engines install no hooks)
    _installs = None

    def __init__(self, home, cfg_path, dev, inproc):
        self.home, self.cfg_path, self.dev, self.inproc = home, cfg_path, dev, inproc
        self.node = self.proc = self.rc = self.started_s = None
        self.t_start = time.time()
        self.handover = None  # (wall s, height, blocks synced)
        self.commits = {}  # height -> wall s of "finalizing commit of block"
        self.errors, self.text = [], ""

    async def start(self):
        import asyncio

        t0 = time.perf_counter()
        self.t_start = time.time()
        if self.inproc:
            from tendermint_tpu_torch.config import load_config
            from tendermint_tpu_torch.crypto.batch_verifier import BatchVerifier, TableCache
            from tendermint_tpu_torch.node import default_new_node

            self.node = default_new_node(load_config(self.cfg_path), device=self.dev)
            # one process has one set of crypto.batch hooks: A's stay, so A's
            # checks are served by A's engine as on the card (B's start would
            # take the hooks over, and whether B's cold cache then declines
            # one of A's checks is a race with B's own first check).  Starts
            # may overlap (phase 12 starts A and B at once): the first saves
            # the real installs, the last puts them back.
            if not NetB._holding:
                NetB._installs = BatchVerifier.install, TableCache.install
                BatchVerifier.install = TableCache.install = lambda engine: engine
            NetB._holding += 1
            try:
                await self.node.start()
            finally:
                NetB._holding -= 1
                if not NetB._holding:
                    BatchVerifier.install, TableCache.install = NetB._installs
            reactor = self.node.blockchain_reactor
            orig = reactor._switch_to_consensus

            async def handover():
                self.handover = (time.time(), reactor.state.last_block_height,
                                 reactor.blocks_synced)
                return await orig()

            reactor._switch_to_consensus = handover
            self.started_s = time.perf_counter() - t0
            return
        self.err_path = os.path.join(self.home, "node.log")
        self._err = open(self.err_path, "w")
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "tendermint_tpu_torch", "--home", self.home, "node"],
            stdout=subprocess.PIPE, stderr=self._err, text=True, env=child_env(), cwd=self.home)
        line = await asyncio.get_running_loop().run_in_executor(None, self.proc.stdout.readline)
        self.started_s = time.perf_counter() - t0
        if not line.startswith("node started"):
            raise AssertionError(f"node B did not start (exit {self.proc.wait(30)}): "
                                 f"{self.read_log()[-3000:]}")

    def read_log(self):
        with open(self.err_path) as f:
            return f.read()

    def exited(self):
        return self.proc is not None and self.proc.poll() is not None

    def height(self):
        return self.node.block_store.height() if self.inproc else store_height(self.home)

    def watch_commits(self, view):
        """In this process: B's commit times from its CsWatch."""
        from tendermint_tpu_torch.consensus.types import RoundStep

        off = time.time() - time.perf_counter()
        for t, h, _, step in view.watch.steps:
            if step == RoundStep.COMMIT:
                self.commits.setdefault(h, t + off)

    def parse_log(self):
        import datetime
        import re

        self.text = self.read_log()
        for ln in self.text.splitlines():
            try:
                t = datetime.datetime.strptime(ln[:23], "%Y-%m-%d %H:%M:%S,%f").timestamp()
            except ValueError:
                continue
            body = ln[24:]
            if body.startswith("E "):
                self.errors.append(body)
            m = re.search(r"switching to consensus height=(\d+) synced=(\d+)", body)
            if m and self.handover is None:
                self.handover = (t, int(m.group(1)), int(m.group(2)))
            m = re.search(r"finalizing commit of block height=(\d+)", body)
            if m:
                self.commits.setdefault(int(m.group(1)), t)

    async def stop(self):
        import asyncio
        import signal

        if self.inproc:
            if self.node is not None and self.node.is_running:
                await self.node.stop()
                self.rc = 0
            return
        if self.proc is None or self.rc is not None:
            return
        if self.proc.poll() is None:
            self.proc.send_signal(signal.SIGTERM)
        try:
            self.rc = await asyncio.get_running_loop().run_in_executor(
                None, lambda: self.proc.wait(60))
        finally:
            if self.proc.poll() is None:
                self.proc.kill()
                self.proc.wait()
            self._err.close()
            self.parse_log()


def net_link(card) -> str:
    """One SecretConnection link on 127.0.0.1: its handshake ms, the C
    tier's seal and open rate on 1,024-byte frames, and 16 MB through the
    link as MConnection moves it (1,024-byte messages by write_msg, read by
    read_msg at the other end meanwhile)."""
    import asyncio

    from tendermint_tpu_torch.crypto import backend, hostprep
    from tendermint_tpu_torch.p2p import NodeKey, SecretConnection

    if hostprep._load_lib() is None:
        raise AssertionError("the host C library (the AEAD's C tier) did not load")
    key, nonce, frame = bytes(range(32)), bytes(12), bytes(1024)
    reps = 20_000
    t0 = time.perf_counter()
    for _ in range(reps):
        sealed = backend.chacha20poly1305_seal(key, nonce, frame)
    seal_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    for _ in range(reps):
        backend.chacha20poly1305_open(key, nonce, sealed)
    open_s = time.perf_counter() - t0
    mb = reps * len(frame) / 1e6

    async def link():
        ka, kb = NodeKey.generate(), NodeKey.generate()
        got = asyncio.get_running_loop().create_future()

        async def on_accept(r, w):
            got.set_result(await SecretConnection.make(r, w, kb.priv_key))

        server = await asyncio.start_server(on_accept, "127.0.0.1", 0)
        try:
            port = server.sockets[0].getsockname()[1]
            t = time.perf_counter()
            r, w = await asyncio.open_connection("127.0.0.1", port)
            ca = await SecretConnection.make(r, w, ka.priv_key)
            cb = await got
            hs_ms = _ms(t)
            msgs = [os.urandom(1024) for _ in range(16 << 10)]

            async def send():
                for m in msgs:
                    await ca.write_msg(m)

            async def recv():
                return [await cb.read_msg() for _ in msgs]

            t = time.perf_counter()
            _, back = await asyncio.gather(send(), recv())
            xfer_s = time.perf_counter() - t
            if back != msgs:
                raise AssertionError("the link did not carry the messages unchanged")
            ca.close()
            cb.close()
            return hs_ms, xfer_s
        finally:
            server.close()
            await server.wait_closed()

    hs_ms, xfer_s = asyncio.run(link())
    return (f"one link: handshake {hs_ms:.3f} ms (X25519 pure, ed25519 challenge); AEAD on the C "
            f"tier, 1,024-byte frames: seal {mb / seal_s:.3f} MB/s, open {mb / open_s:.3f} MB/s; "
            f"16 MB in 1,024-byte messages through write_msg/read_msg "
            f"{16 * 1.048576 / xfer_s:.3f} MB/s "
            f"({card})")


def phase_net(keys, card, dev, b_inproc=False, keep_homes=False):
    """Two port nodes of a 10,000-validator chain over TCP (see the module
    docstring, 11).  `b_inproc` runs node B in this process (the CPU
    rehearsal) instead of through the CLI.  Returns the launches'
    denominators and the run's numbers; with `keep_homes`, also A's and B's
    homes under out["net"] (phase 12 restarts them; its caller removes
    them with out["net"]["tmp"].cleanup())."""
    import asyncio

    out = asyncio.run(net_run(keys, card, dev, b_inproc, keep_homes))
    out["link"] = net_link(card)
    log(f"  {out['link']}")
    return out


async def net_run(keys, card, dev, b_inproc, keep_homes=False):
    import asyncio
    import tempfile
    import threading

    from tendermint_tpu_torch.config import load_config
    from tendermint_tpu_torch.consensus import reactor as cs_reactor
    from tendermint_tpu_torch.consensus.types import RoundStep
    from tendermint_tpu_torch.libs.bitarray import BitArray
    from tendermint_tpu_torch.mempool import MempoolError
    from tendermint_tpu_torch.node import default_new_node
    from tendermint_tpu_torch.state import make_genesis_state
    from tendermint_tpu_torch.types.block import BLOCK_ID_FLAG_COMMIT, BlockID, Commit
    from tendermint_tpu_torch.types.canonical import PRECOMMIT_TYPE, PREVOTE_TYPE
    from tendermint_tpu_torch.types.genesis import GenesisDoc, GenesisValidator
    from tendermint_tpu_torch.types.params import BLOCK_PART_SIZE_BYTES
    from tendermint_tpu_torch.types.proposal import Proposal
    from tendermint_tpu_torch.types.vote import Vote

    t0 = time.perf_counter()
    gen = GenesisDoc(CHAIN_ID, genesis_time_ns=LITE_T0, validators=[
        GenesisValidator(k.pub_key().address(), k.pub_key(), 10) for k in keys])
    key_of = {k.pub_key().address(): k for k in keys}

    def proposer_at(h):
        vals = make_genesis_state(gen).validators.copy()
        vals.increment_proposer_priority(h - 1)
        return key_of[vals.get_proposer().address]

    ours, b_key = proposer_at(CS_OURS_AT), proposer_at(NET_B_AT)
    if ours is b_key:
        raise AssertionError("A's and B's validators coincide")
    ours_addr, b_addr = ours.pub_key().address(), b_key.pub_key().address()
    vals0 = make_genesis_state(gen).validators
    others = [i for i, x in enumerate(vals0.validators) if x.address not in (ours_addr, b_addr)]
    relay_of = {i: k % NET_RELAYS for k, i in enumerate(others)}
    bursts, bad_txs, _ = abci_traffic(keys, [], top=NET_HEIGHTS)
    valid = [tx for h in sorted(bursts) for tx in bursts[h] if tx not in bad_txs]
    n = len(keys)
    log(f"  traffic: {NET_HEIGHTS} bursts of {ABCI_TXS} signed envelopes ({len(bad_txs)} "
        f"corrupted) made in {_ms(t0):.3f} ms; A's validator {ours_addr.hex()[:12]} (round-0 "
        f"proposer of {CS_OURS_AT}), B's {b_addr.hex()[:12]} (of {NET_B_AT}); {NET_RELAYS} relays "
        f"hold the other {len(others)} of {n}")

    tmp = tempfile.TemporaryDirectory(prefix="chip-smoke-net-")
    home_a, home_b = os.path.join(tmp.name, "a"), os.path.join(tmp.name, "b")
    rpc_a, rpc_b = f"127.0.0.1:{free_port()}", f"127.0.0.1:{free_port()}"
    cfg_a, a_id = net_home(home_a, gen, ours, "a", rpc_a.rpartition(":")[2])
    probe = NodeProbe()
    builds, per_h, proposals = [], {}, {}
    sign_s, join_s = 0.0, 0.0
    kinds = collections.Counter()  # consensus frames A's reactor decoded, by kind
    kinds_seen = collections.Counter()
    device = None if dev.type == "cuda" else dev  # the entry point's default is the card
    relays = NetRelays(tmp.name)
    spool = SpoolProbe()
    a = b = out = None
    dec = cs_reactor._dec
    stopped = []  # (peer id, reason) of A's stop_peer_for_error calls
    admitted = collections.Counter()  # node id -> connections A admitted
    meters = {}  # id(peer) -> (sent, received) at the last snapshot

    def counted_dec(msg_bytes):
        kind, msg = dec(msg_bytes)
        kinds[kind] += 1
        return kind, msg

    async def burst(hb):
        """Height hb's envelopes through A's check_tx only."""
        txs = list(bursts[hb])
        out, ms = await check_burst(a.mempool, txs)
        for tx, (res, _) in zip(txs, out):
            if tx in bad_txs:
                if not (isinstance(res, MempoolError) and str(res) == "invalid tx signature"):
                    raise AssertionError(f"a corrupted envelope for {hb} gave {res!r}")
            elif isinstance(res, Exception) or res.code != 0:
                raise AssertionError(f"a valid tx for {hb} was rejected: {res!r}")
        lat = [lat for _, lat in out]
        per_h.setdefault(hb, {"lines": []})["lines"].append(
            f"burst of {len(out)} check_tx to A {ms:.3f} ms, p50 {percentile(lat, 50):.3f} p99 "
            f"{percentile(lat, 99):.3f} ms")

    def link_bytes(b_id):
        """A's bytes sent and received since the last call, by peer class,
        from the peers' MConnection meters."""
        out = {"relays": [0, 0], "B": [0, 0]}
        for p in list(a.switch.peers.values()):
            s, r = p.mconn.send_meter.total, p.mconn.recv_meter.total
            s0, r0 = meters.get(id(p), (0, 0))
            meters[id(p)] = (s, r)
            cls = out["B" if p.id == b_id else "relays"]
            cls[0] += s - s0
            cls[1] += r - r0
        return out

    async def until(cond, what, timeout=600.0):
        t = time.perf_counter()
        while not cond():
            if b is not None and b.exited():
                raise AssertionError(f"node B exited {b.proc.returncode} while waiting for {what}: "
                                     f"{b.read_log()[-3000:]}")
            if time.perf_counter() - t > timeout:
                raise AssertionError(f"timed out waiting for {what}")
            await asyncio.sleep(0.02)

    async def relays_linked(what):
        t = time.perf_counter()
        while not await relays.linked(a):
            if time.perf_counter() - t > 120:
                raise AssertionError(f"timed out waiting for {what}")
            await asyncio.sleep(0.05)

    try:
        with consensus_errors(NET_LOGGERS) as errors, table_timing(None, builds, dev):
            cs_reactor._dec = counted_dec
            await relays.spawn()  # its start overlaps A's
            t = time.perf_counter()
            a = default_new_node(load_config(cfg_a), device=device)
            probe.rec = a.flight_recorder
            await a.start()
            a_start_ms = _ms(t)
            probe.executor = a.consensus.block_exec  # B's calls (in this process) are not A's
            a_addr = f"{a_id}@{a.switch.transport.listen_addr}"
            sw_stop, sw_add = a.switch.stop_peer_for_error, a.switch._add_peer_conn_locked

            async def stop_peer_for_error(peer, reason):
                stopped.append((peer.id, reason))
                return await sw_stop(peer, reason)

            async def add_peer_conn(conn, ni, *args):
                admitted[ni.node_id] += 1
                return await sw_add(conn, ni, *args)

            a.switch.stop_peer_for_error = stop_peer_for_error
            a.switch._add_peer_conn_locked = add_peer_conn
            await burst(1)
            t = time.perf_counter()
            await relays.start(a_id, a_addr)
            await until(lambda: any(x.cs is a.consensus for x in probe.views),
                        "A's switch to consensus", 60)
            v = next(x for x in probe.views if x.cs is a.consensus)
            w = v.watch
            log(f"  A: default_new_node + start {a_start_ms:.3f} ms, listening on "
                f"{a.switch.transport.listen_addr}; fast sync handed over to consensus "
                f"{time.perf_counter() - t:.3f} s after the {NET_RELAYS} relays dialed (the "
                f"reactor's 1 s grace) ({card})")
            iota_ns = a.state.consensus_params.block.time_iota_ms * 1_000_000
            seq0 = next_seq(a.flight_recorder)
            b_id = None
            tally = {"seq": seq0, "dispatch": [], "frames": 0}

            def tally_events():
                """A's dispatches and vote_batch frames of >= 16 entries since
                the last call, read while the recorder's ring still holds them."""
                evs = a.flight_recorder.events(since=tally["seq"], kinds=[
                    "verify.dispatch", "gossip.vote_batch_recv"])
                tally["seq"] = next_seq(a.flight_recorder)
                tally["dispatch"] += [e for e in evs if e["kind"] == "verify.dispatch"]
                tally["frames"] += sum(1 for e in evs if e["kind"] == "gossip.vote_batch_recv"
                                       and e["n"] >= cs_reactor.DIRECT_VERIFY_MIN)

            def round_start(h):
                """When A's round 0 of height h began: its first step past
                NEW_HEIGHT (PROPOSE is skipped when the proposal is complete)."""
                return min(t for t, hh, r, step in w.steps
                           if (hh, r) == (h, 0) and step > RoundStep.NEW_HEIGHT)
            for h in range(1, NET_HEIGHTS + 1):
                st = per_h.setdefault(h, {"lines": []})
                await w.until(lambda: w.at(h, 0, RoundStep.NEW_HEIGHT), f"height {h}")
                proposer = v.cs.rs.validators.get_proposer().address
                who = "A" if proposer == ours_addr else "B" if proposer == b_addr else "relay"
                t_prop = None
                if h == NET_B_START + 1:  # B's start takes seconds; the proposal waits for it
                    cfg_b, b_id = net_home(home_b, gen, b_key, "b", rpc_b.rpartition(":")[2],
                                           peers=a_addr)
                    b = NetB(home_b, cfg_b, device, b_inproc)
                    await b.start()
                    log(f"  B: 'node started' {b.started_s:.3f} s after its start "
                        f"({'in this process' if b_inproc else 'python -m tendermint_tpu_torch node'}"
                        f") ({card})")
                if who == "relay":
                    # the relay builds its proposal as soon as A has delivered
                    # h - 1 and sends it once A, and from NET_JOIN_AT on B in
                    # A's view, is in its PROPOSE step: a proposer enters
                    # height h with everyone else and proposes after its own
                    # timeout_commit, so no node holds the proposal complete
                    # before its PROPOSE step (which it would then skip,
                    # leaving the step out of its span chain: ROADMAP 3.10)
                    k = relay_of[v.cs.rs.validators.get_by_address(proposer)[0]]
                    prop, parts, build_ms = await cs_build(v, key_of[proposer], h, 0, BlockID,
                                                           Commit, Proposal, BLOCK_PART_SIZE_BYTES)
                    proposals[h] = prop
                    frames = [cs_reactor._enc("proposal", {"proposal": prop.to_dict()})] + [
                        cs_reactor._enc("block_part", {"height": h, "round": 0,
                                                       "part": parts.get_part(j).to_dict()})
                        for j in range(parts.total)]
                    await w.until(lambda: w.at(h, 0, RoundStep.PROPOSE), f"propose {h}/0")
                    if h >= NET_JOIN_AT:
                        t = time.perf_counter()

                        def b_here():
                            ps = a.consensus_reactor.peer_states.get(b_id)
                            return ps is not None and (ps.height, ps.round, ps.step) >= (
                                h, 0, RoundStep.PROPOSE)

                        await until(b_here, f"B in its PROPOSE step of height {h}", 600)
                        join_s += time.perf_counter() - t
                        st["lines"].append(f"B in its PROPOSE step {time.perf_counter() - t:.3f} s"
                                           " after A's (the relay held its proposal)")
                    await relays.send(k, cs_reactor.DATA_CHANNEL, frames)
                    t_prop = time.perf_counter()
                    st["lines"].append(f"proposal of {parts.total} parts by relay {k} over TCP "
                                       f"(built in {build_ms:.3f} ms)")
                await w.until(lambda: w.at(h, 0, RoundStep.PROPOSE), f"propose {h}/0")
                if h > 1:
                    prev = per_h[h - 1]
                    prev["window"] = (w.t(h - 1, 0, RoundStep.COMMIT), round_start(h))
                    prev["split"] = loop_split(a.flight_recorder, *prev["window"])
                await w.until(lambda: (h, 0, PREVOTE_TYPE) in w.signed, f"A's prevote {h}", 600)
                rs = v.cs.rs
                block = rs.proposal_block
                if block is None:
                    t_pv, t_pr = w.signed[(h, 0, PREVOTE_TYPE)][0], round_start(h)
                    raise AssertionError(
                        f"A prevoted nil at height {h} (proposer {who}): round 0 began at +0, the "
                        f"relay's frames sent at "
                        f"{'-' if t_prop is None else f'{t_prop - t_pr:+.3f}'} s, A's prevote at "
                        f"{t_pv - t_pr:+.3f} s; proposal held {rs.proposal is not None}, parts "
                        f"{None if rs.proposal_block_parts is None else rs.proposal_block_parts.bit_array().count()}")
                if who != "relay":
                    proposals[h] = rs.proposal
                bid = BlockID(block.hash(), rs.proposal_block_parts.header())
                st["who"] = who
                st["lines"].append(
                    f"proposer {who}: {len(block.txs)} txs; proposal complete "
                    f"{w.complete[(h, 0)] - round_start(h):+.3f} s into A's round 0 (timeout_propose "
                    f"{NET_TIMEOUT_PROPOSE} s); proposal complete -> A's prevote "
                    f"{(w.signed[(h, 0, PREVOTE_TYPE)][0] - w.complete[(h, 0)]) * 1000:.3f} ms")
                await relays_linked(f"the relays at height {h}")  # relay 1 is back after NET_BAD_AT
                nv = rs.validators.size()
                t_s = time.perf_counter()
                pv, _ = cs_votes(rs.validators, key_of, ours_addr, PREVOTE_TYPE, h, 0, block, bid,
                                 iota_ns, skip=(b_addr,))
                pc, _ = cs_votes(rs.validators, key_of, ours_addr, PRECOMMIT_TYPE, h, 0, block,
                                 bid, iota_ns, skip=(b_addr,))
                frames = {}
                for name, votes in (("pv", pv), ("pc", pc)):
                    # each relay stands for a part of the network that has
                    # heard all 9,998 relayed votes: its possession bitmap
                    # says so, and A's anti-echo (the frame's `have`) sends
                    # the relays back only A's and B's votes
                    have = BitArray.from_indices(nv, [x.validator_index for x in votes]).to_bytes()
                    for k in range(NET_RELAYS):
                        mine = [x for x in votes if relay_of[x.validator_index] == k]
                        frames[(name, k)] = net_frames(mine, have)
                n_relay = len(pv)
                conflict = None
                if h == NET_BAD_AT:
                    # relay 0 also sends a second, nil prevote of one of its
                    # validators: evidence of a double sign
                    x = frames[("pv", 0)][0][0][0]
                    conflict = Vote(PREVOTE_TYPE, h, 0, BlockID(), x.timestamp_ns,
                                    x.validator_address, x.validator_index)
                    conflict.signature = key_of[x.validator_address].sign(
                        conflict.sign_bytes(CHAIN_ID))
                    st["conflict"] = (x.validator_address, x.validator_index)
                await relays.call("load", {key: [f for _, f in fs] for key, fs in frames.items()})
                sign_s += time.perf_counter() - t_s

                async def send_all(name, last=None, extra=None):
                    """Every relay's loaded frames of one kind at once; `last`
                    replaces relay 1's last frame, `extra` follows relay 0's."""
                    await asyncio.gather(*(relays.send(
                        k, cs_reactor.VOTE_CHANNEL, name, last if k == 1 else None,
                        extra if k == 0 else None) for k in range(NET_RELAYS)))

                # prevotes
                seq, add0, wal0 = next_seq(a.flight_recorder), len(v.add_ms), len(v.wal_ms)
                t_sent = time.perf_counter()
                await send_all("pv", extra=None if conflict is None else cs_reactor._enc(
                    "vote_batch", {"votes": [conflict.wire()]}))
                prevotes = rs.votes.prevotes(0)
                await w.until(lambda: prevotes.bit_array().count() >= 1 + n_relay,
                              f"prevotes {h}", 600)
                st["lines"].append("prevotes: " + cs_ingest_line(
                    v, a.flight_recorder, seq, t_sent, time.perf_counter(), n_relay, add0, wal0,
                    card))
                tally_events()
                await w.until(lambda: (h, 0, PRECOMMIT_TYPE) in w.signed
                              and v.cs.rs.votes.precommits(0).get_by_address(ours_addr)
                              is not None, f"A's precommit {h}", 600)
                if h < NET_HEIGHTS:
                    await burst(h + 1)
                # precommits; at NET_BAD_AT relay 1's last frame carries one
                # flipped signature: A stops relay 1, relay 2 re-sends it clean
                seq, add0, wal0 = next_seq(a.flight_recorder), len(v.add_ms), len(v.wal_ms)
                t_sent = time.perf_counter()
                if h == NET_BAD_AT:
                    bad_votes = [Vote(x.type, x.height, x.round, x.block_id, x.timestamp_ns,
                                      x.validator_address, x.validator_index, x.signature)
                                 for x in frames[("pc", 1)][-1][0]]
                    j = len(bad_votes) // 2
                    bad_votes[j].signature = (bytes([bad_votes[j].signature[0] ^ 1])
                                              + bad_votes[j].signature[1:])
                    n_stop = len(stopped)
                    await send_all("pc", last=cs_reactor._enc(
                        "vote_batch", {"votes": [x.wire() for x in bad_votes]}))
                    await until(lambda: len(stopped) > n_stop, "A's stop of relay 1", 120)
                    st["stop"] = stopped[n_stop:]
                    await relays.send(2, cs_reactor.VOTE_CHANNEL, [frames[("pc", 1)][-1][1]])
                    st["lines"].append(f"relay 1's last precommit frame ({len(bad_votes)} votes, "
                                       f"one flipped): A stopped relay 1 ({stopped[n_stop][1]!r}); "
                                       "relay 2 re-sent the frame clean")
                else:
                    await send_all("pc")
                await w.until(lambda: v.cs.rs.height == h + 1 and (
                    v.cs.rs.last_commit.bit_array().count() + v.late[h] >= 1 + n_relay),
                    f"height {h}'s precommits", 600)
                t_done = time.perf_counter()
                st["last_commit"] = v.cs.rs.last_commit.bit_array().count()
                st["late"] = v.late[h]
                st["lines"].append(
                    "precommits: " + cs_ingest_line(v, a.flight_recorder, seq, t_sent, t_done,
                                                    n_relay, add0, wal0, card)
                    + f"; vote-to-commit {(w.t(h, 0, RoundStep.COMMIT) - t_sent) * 1000:.3f} ms"
                    + f"; loop profiler over the precommits' ingest: "
                    + loop_split(a.flight_recorder, t_sent, t_done))
                st["commit_t"] = w.t(h, 0, RoundStep.COMMIT)
                st["commit_wall"] = time.time() - (time.perf_counter() - st["commit_t"])
                st["bytes"] = link_bytes(b_id)
                tally_events()
                st["kinds"] = dict(kinds - kinds_seen)
                kinds_seen.update(st["kinds"])
                log(f"    height {h}: " + "; ".join(st["lines"]) + f"; LastCommit "
                    f"{st['last_commit']} of {st['last_commit'] + st['late']} precommits, "
                    f"{st['late']} refused as late")
                if h == 1:
                    st["first_propose"] = round_start(1)
            await until(lambda: b.height() >= NET_HEIGHTS, f"B's height {NET_HEIGHTS}", 300)
            await relays_linked("the relays at the end")
            if b_inproc:
                b.watch_commits(next(x for x in probe.views if x.cs is b.node.consensus))
            run_stops = list(stopped)  # the peers' stops below are phase 16's and the teardown's
            before = launch_counts(zero=True)
            fx = await fx_run(a, b, (rpc_a, rpc_b), (home_a, home_b),
                              os.path.join(tmp.name, "forensics"), spool, card, b_inproc)
            fx["launches"] = launch_counts(zero=True)
            launch_counts(add={k: before[k] + fx["launches"][k] for k in before})
            await b.stop()
            errors += [f"relay process: {e}" for e in await relays.stop()]
            await a.stop()
            out = net_check(a, b, per_h, proposals, valid, ours_addr, b_addr, errors, run_stops,
                            relays, admitted, n, probe, BLOCK_ID_FLAG_COMMIT)
            out["frames"] = tally["frames"]
            out["fx"] = fx
        net_report(a, b, per_h, builds, sign_s, join_s, tally["dispatch"], dev, card,
                   dict(kinds), out, probe)
        out["tables"] = [x["thread"] for x in builds]
        if keep_homes:
            out["net"] = {"tmp": tmp, "a": (home_a, cfg_a, a_id), "b": (home_b, cfg_b, b_id)}
        return out
    finally:
        cs_reactor._dec = dec
        probe.close()
        spool.close()
        await relays.close()
        if b is not None:
            await b.stop()
        if a is not None and a.is_running:
            await a.stop()
        for t in threading.enumerate():  # the engine's background builds and probe
            if t.name in ("table-build", "table-rebuild", "bv-rtt-probe", "bv-warmup"):
                t.join()
        if a is not None:  # its sqlite files are reopened by phase 12's processes
            for db in (a.block_store.db, a.state_db, getattr(a.tx_indexer, "db", None),
                       a.evidence_pool.db if a.evidence_pool is not None else None):
                if db is not None:
                    db.close()
        if "net" not in (out or {}):  # kept only for a phase 11 that passed
            tmp.cleanup()


def net_check(a, b, per_h, proposals, valid, ours_addr, b_addr, errors, stopped, relays,
              admitted, n, probe, flag_commit):
    """Phase 11's outcome (see the module docstring, 11).  Returns the
    counts main() holds A's launches to."""
    from tendermint_tpu_torch.evidence import EvidencePool
    from tendermint_tpu_torch.libs.kvstore import open_db
    from tendermint_tpu_torch.state import StateStore
    from tendermint_tpu_torch.store import BlockStore

    dbs = {name: open_db(name, b.home) for name in ("blockstore", "state", "evidence")}
    try:
        store_b = BlockStore(dbs["blockstore"])
        pool_b = EvidencePool(dbs["evidence"], StateStore(dbs["state"]))
        txs, evidence = [], []
        for h in range(1, NET_HEIGHTS + 1):
            blk_a, blk_b = a.block_store.load_block(h), store_b.load_block(h)
            seen = a.block_store.load_seen_commit(h)
            if blk_a is None or blk_b is None or seen is None or seen.round != 0:
                raise AssertionError(f"height {h} did not commit in round 0 on both nodes")
            if blk_a.serialize() != blk_b.serialize():
                raise AssertionError(f"A and B hold different blocks at height {h}")
            if blk_a.hash() != proposals[h].block_id.hash:
                raise AssertionError(f"block {h} is not the proposal gossiped for it")
            if h > 1:
                signed = sum(c.block_id_flag == flag_commit for c in blk_a.last_commit.signatures)
                if 3 * signed <= 2 * n:
                    raise AssertionError(f"block {h}'s LastCommit has {signed} of {n} signatures")
            txs += blk_a.txs
            evidence += [(h, ev) for ev in blk_a.evidence]
        if sorted(txs) != sorted(valid):
            raise AssertionError(f"blocks 1-{NET_HEIGHTS} hold {len(txs)} txs, not each of the "
                                 f"{len(valid)} valid envelopes once")
        if a.block_store.load_block(CS_OURS_AT).header.proposer_address != ours_addr:
            raise AssertionError(f"block {CS_OURS_AT} is not A's")
        blk5 = a.block_store.load_block(NET_B_AT)
        if blk5.header.proposer_address != b_addr or not blk5.txs:
            raise AssertionError(f"block {NET_B_AT} is not B's, or holds no gossiped txs")
        state_a, state_b = a.state_store.load(), StateStore(dbs["state"]).load()
        if not (state_a.last_block_height == state_b.last_block_height == NET_HEIGHTS):
            raise AssertionError(f"A stopped at {state_a.last_block_height}, B at "
                                 f"{state_b.last_block_height}, not {NET_HEIGHTS}")
        if state_a.app_hash != state_b.app_hash:
            raise AssertionError("A's and B's app hashes differ")
        addr, _ = per_h[NET_BAD_AT]["conflict"]
        if len(evidence) != 1 or evidence[0][0] not in (NET_B_AT, NET_B_AT + 1) or \
                evidence[0][1].vote_a.validator_address != addr:
            raise AssertionError(f"the double sign's evidence is not committed once at height "
                                 f"{NET_B_AT} or {NET_B_AT + 1}: {[(h, e) for h, e in evidence]}")
        ev = evidence[0][1]
        if not (a.evidence_pool.is_committed(ev) and pool_b.is_committed(ev)):
            raise AssertionError("the evidence is not marked committed in both pools")
    finally:
        for db in dbs.values():
            db.close()
    if b.handover is None or b.handover[2] < 1:
        raise AssertionError(f"B did not fast-sync a pair before it switched: {b.handover}")
    if sorted(b.commits) != list(range(b.handover[1] + 1, NET_HEIGHTS + 1)):
        raise AssertionError(f"B committed {sorted(b.commits)} in consensus after switching at "
                             f"{b.handover[1]}")
    want = [(relays.ids[1], "invalid vote signature in batch")]
    if per_h[NET_BAD_AT]["stop"] != want or [s for s in stopped if s not in want]:
        raise AssertionError(f"A stopped {stopped}, not relay 1 for the flipped signature only")
    if admitted[relays.ids[1]] < 2:
        raise AssertionError("relay 1 was not readmitted after its stop")
    if errors or b.errors:
        raise AssertionError(f"errors logged: A and the relays {errors[:3]}, B {b.errors[:3]}")
    if b.rc != (0 if b.inproc else -9) or "Traceback" in b.text:
        raise AssertionError(f"node B exited {b.rc} on phase 16's `debug kill` (SIGKILL) or "
                             f"printed a traceback: {b.text[-3000:]}")
    checks = []
    for h, hits in probe.lookups:  # A's calls (probe.executor)
        if h < 2:
            continue
        if len(hits) != 1:
            raise AssertionError(f"a validate_block of A at height {h} made {len(hits)} table "
                                 "lookups, not 1")
        checks.append(hits[0])
    return {"validate_blocks": len(checks), "hits": sum(checks),
            "declines": len(checks) - sum(checks)}


def net_report(a, b, per_h, builds, sign_s, join_s, d, dev, card, kinds, out, probe):
    """Per height and for the phase (see the module docstring, 11)."""
    t = probe.timer

    def at(name, h):
        return t.ms.get((name, h), 0.0), t.n.get((name, h), 0)

    for h in range(1, NET_HEIGHTS + 1):
        st = per_h[h]
        vb, vc = at("validate_block", h), at("verify_commit", h)
        gap = (f"{(st['commit_t'] - per_h[h - 1]['commit_t']) * 1000:.3f} ms" if h > 1 else "-")
        lag = (f"{(b.commits[h] - st['commit_wall']) * 1000:.3f} ms"
               + (" (catching up)" if h < NET_JOIN_AT else "") if h in b.commits
               else "- (fast-synced)")
        by = st["bytes"]
        log(f"    height {h}: validate_block x{vb[1]} {vb[0]:.3f} ms (verify_commit x{vc[1]} "
            f"{vc[0]:.3f} ms), save_block {at('save_block', h)[0]:.3f} ms, pipelined apply_block "
            f"{at('apply_block', h)[0]:.3f} ms; commit-to-commit {gap}; A's link bytes sent / "
            f"received: relays {by['relays'][0]} / {by['relays'][1]}, B {by['B'][0]} / "
            f"{by['B'][1]}; consensus frames received by kind {st['kinds']}; B's commit lag "
            f"behind A {lag} ({card})")
        if "split" in st:
            log(f"    height {h}: COMMIT -> PROPOSE window, loop profiler: {st['split']} ({card})")
    log(f"  consensus frames A's reactor received, by kind: {kinds}; accepted vote_batch frames "
        f"of >= 16 entries: {out['frames']}")
    th, hh, synced = b.handover
    log(f"  B: 'node started' {b.started_s:.3f} s; fast sync of {synced} block(s) "
        f"in {th - b.t_start - b.started_s:.3f} s after 'node started', switched to consensus at "
        f"height {hh}; exit code {b.rc} on phase 16's `debug kill` ({card})")
    for x in builds:
        log(f"    table of {x['validators']} validators on {x['thread']}: host rows "
            f"{x['rows_ms']:.3f} ms, window tables (kernel 2) "
            + (f"{x['build_ms']:.3f} ms" if x["build_ms"] is not None else "not built")
            + f" ({card})")
    first = per_h[1]["first_propose"]
    span = per_h[NET_HEIGHTS]["commit_t"] - first
    waits = sum(per_h[h]["window"][1] - per_h[h]["window"][0] for h in range(1, NET_HEIGHTS))
    busy = span - sign_s - waits - join_s
    device_ms = sum(e["device_ms"] for e in d)
    log(f"  heights 1-{NET_HEIGHTS} on A: {span * 1000:.3f} ms from height 1's propose to height "
        f"{NET_HEIGHTS}'s commit = {NET_HEIGHTS / span:.3f} heights/s; apart from signing and "
        f"framing {sign_s * 1000:.3f} ms, timeout_commit x{NET_HEIGHTS - 1} {waits * 1000:.3f} ms "
        f"and the relays' holds for B's PROPOSE steps {join_s * 1000:.3f} ms: {busy * 1000:.3f} ms = "
        f"{NET_HEIGHTS / busy:.3f} heights/s; {len(d)} dispatches on A, host prep "
        f"{sum(e['host_prep_ms'] for e in d):.3f} ms, dispatch {device_ms:.3f} ms "
        f"({device_ms / (span * 1000) * 100:.3f} % of the wall time); "
        f"{card_memory(dev, a.table_cache)} ({card})")


FX_SECTIONS = ("status.json", "net_info.json", "consensus_state.json", "recorder.json",
               "health.json", "storage.json", "tasks.json", "config.toml", "cs_wal.tail",
               "mempool_wal.tail", "flight.spool.tail", "spool.json", "span_report.json",
               "loop_report.json", "manifest.json")  # the JAX live bundle's sections
FX_RPC_SECTIONS = ("status", "net_info", "consensus_state", "recorder", "health", "storage",
                   "tasks")
FX_CHAINS = 3  # complete step chains each node's `trace --check` must show
FX_HEIGHTS = range(2, NET_HEIGHTS)  # heights 2-5: the stage budget's and the merge's interior
FX_ANCHOR_S = 1.0  # B's newest spool anchor is at most this long before its death
FX_CLI_S = 120.0  # one forensics command, at most
FX_STANDIN = "import time; time.sleep(600)"  # `debug kill`'s target in the CPU rehearsal


class SpoolProbe:
    """Class-level hooks for phase 16's account of the spool's cost: each
    FlightSpool.flush timed (ms, per spool), and each node's `flight-spool`
    task driven through the loop profiler's resume-timing trampoline
    (loopprof._drive).  The node starts that task before its profiler (the
    JAX order), so the node's own profiler never accounts it."""

    def __init__(self):
        from tendermint_tpu_torch.libs import loopprof
        from tendermint_tpu_torch.libs.tracing import FlightSpool
        from tendermint_tpu_torch.node import Node

        self.flush_ms = collections.defaultdict(list)  # id(spool) -> [ms]
        self.busy_ns = collections.Counter()  # id(node) -> ns
        self._flush, self._loop = FlightSpool.flush, Node._spool_flush_loop
        flush, loop, probe = self._flush, self._loop, self

        def timed_flush(spool, sync=False):
            t = time.perf_counter()
            try:
                return flush(spool, sync)
            finally:
                probe.flush_ms[id(spool)].append(_ms(t))

        def timed_loop(node):
            def acct(ns):
                probe.busy_ns[id(node)] += ns

            async def runner():
                return await loopprof._drive(loop(node).__await__(), acct)

            return runner()

        FlightSpool.flush, Node._spool_flush_loop = timed_flush, timed_loop

    def close(self):
        from tendermint_tpu_torch.libs.tracing import FlightSpool
        from tendermint_tpu_torch.node import Node

        FlightSpool.flush, Node._spool_flush_loop = self._flush, self._loop

    def line(self, node, card) -> str:
        """The spool's cost on `node` so far."""
        from tendermint_tpu_torch.libs.tracing import spool_paths

        sp = node.flight_spool
        ms = self.flush_ms[id(sp)]
        size = sum(os.path.getsize(p) for p in spool_paths(node.config.flight_spool_file()))
        return (f"{sp.flushes} flushes, {sp.spooled} events spooled ({sp.lost} lost to ring "
                f"wrap), ms per flush p50 {percentile(ms, 50):.3f} max "
                f"{max(ms, default=float('nan')):.3f} (sum {sum(ms):.3f}), the flight-spool "
                f"task's busy ms by the loop profiler's trampoline "
                f"{self.busy_ns[id(node)] / 1e6:.3f}, {size} bytes on disk ({card})")


async def fx_cli(*argv, timeout=FX_CLI_S):
    """`python -m tendermint_tpu_torch *argv` in a subprocess: its exit
    code, stdout, stderr and seconds."""
    import asyncio

    t0 = time.perf_counter()
    proc = await asyncio.create_subprocess_exec(
        sys.executable, "-m", "tendermint_tpu_torch", *argv, stdout=asyncio.subprocess.PIPE,
        stderr=asyncio.subprocess.PIPE, env=child_env(), cwd=HERE)
    try:
        out, err = await asyncio.wait_for(proc.communicate(), timeout)
    except asyncio.TimeoutError:
        proc.kill()
        await proc.wait()
        raise AssertionError(f"`{' '.join(argv)}` did not finish in {timeout} s") from None
    return proc.returncode, out.decode(), err.decode(), time.perf_counter() - t0


async def fx_ok(*argv):
    """fx_cli that must exit 0: its stdout and seconds."""
    rc, out, err, s = await fx_cli(*argv)
    if rc != 0:
        raise AssertionError(f"`{' '.join(argv)}` exited {rc}: {err[-3000:]}")
    return out, s


def fx_bundle(path) -> dict:
    """A debug bundle's sections: {file name: bytes}."""
    import tarfile

    with tarfile.open(path) as tar:
        return {os.path.basename(m.name): tar.extractfile(m).read() for m in tar.getmembers()}


def fx_one(directory) -> str:
    """The one bundle `debug dump` wrote into `directory`."""
    names = [n for n in os.listdir(directory) if n.endswith(".tar.gz")]
    if len(names) != 1:
        raise AssertionError(f"debug dump wrote {names} into {directory}")
    return os.path.join(directory, names[0])


def fx_last_json(text):
    return json.loads(text.strip().splitlines()[-1])


def fx_broken(text) -> dict:
    """The broken chains named by a failed `trace --check` (its stderr) or
    by a trace-net failure line: {height: missing steps}."""
    import ast
    import re

    m = re.search(r"broken (?:span )?chains:? (\{.*\})", text)
    return ast.literal_eval(m.group(1)) if m else {}


def fx_caught_up(bad) -> bool:
    """Every broken chain is one of a height B committed by catch-up,
    before it joined A's rounds at NET_JOIN_AT: the +2/3 precommits came
    from A's catch-up gossip, so B's state machine skipped its own prevote
    (and its PROPOSE step when they came before it), which the JAX
    span_report counts as broken (ROADMAP 3.10)."""
    return all(int(h) < NET_JOIN_AT and set(miss) <= {"Propose", "Prevote"}
               for h, miss in bad.items())  # a JSON report's heights are strings


async def fx_check(who, rpc):
    """`trace --check` against one node: its complete chains, its broken
    ones and the tool's summary line.  A must pass; B may fail only on its
    catch-up heights (fx_caught_up)."""
    import re

    rc, text, err, s = await fx_cli("trace", "--rpc-laddr", rpc, "--check")
    if rc == 0:
        m = re.search(r"trace check ok: (\d+) blocks with complete span chains(.*)", text)
        return int(m.group(1)), {}, m.group(0), s
    m = re.search(r"trace check FAILED: .*complete=(\d+).*", err)
    bad = fx_broken(err)
    if rc != 1 or m is None or who != "B" or not bad or not fx_caught_up(bad):
        raise AssertionError(f"trace --check on {who} exited {rc}: {err[-3000:]}")
    return int(m.group(1)), bad, m.group(0), s


def fx_failures(failures):
    """trace-net --check's failures, but for B's catch-up chains."""
    return [f for f in failures if not (f.startswith("b: broken span chains ")
                                        and fx_caught_up(fx_broken(f)))]


async def fx_run(a, b, rpcs, homes, work, spool, card, inproc):
    """Phase 16 (see the module docstring, 16) on phase 11's live net: A
    in this process, B through the CLI (or, in the CPU rehearsal, in this
    process with a stand-in child as `debug kill`'s target).  Every tool
    runs as `python -m tendermint_tpu_torch ...`.  B is dead when it
    returns: `b.stop()` then only reaps it."""
    import asyncio

    from tendermint_tpu_torch.libs.tracing import BUDGET_STAGES, spool_paths

    t_phase = time.perf_counter()
    rpc_a, rpc_b = rpcs
    home_a, home_b = homes
    both = f"{rpc_a},{rpc_b}"
    out = {"secs": {}}
    log(f"  [16] spool on A over heights 1-{NET_HEIGHTS}: {spool.line(a, card)}")
    # 1. trace --check, --budget and --net-budget against each node, at once
    argvs = {(who, what): ("trace", "--rpc-laddr", rpc) + extra
             for who, rpc in (("A", rpc_a), ("B", rpc_b))
             for what, extra in (("budget", ("--budget", "--json")),
                                 ("net", ("--net-budget", "--json")))}
    got = await asyncio.gather(fx_check("A", rpc_a), fx_check("B", rpc_b),
                               *(fx_ok(*v) for v in argvs.values()))
    checks = {"A": got[0], "B": got[1]}
    got = dict(zip(argvs, got[2:]))
    out["secs"]["trace"] = max([s for _, s in got.values()] + [c[3] for c in checks.values()])
    for who in ("A", "B"):
        complete, bad, summary, _ = checks[who]
        if complete < FX_CHAINS:
            raise AssertionError(f"trace --check on {who}: {summary}")
        budget = fx_last_json(got[(who, "budget")][0])["budget"]
        if budget is None or [s for s in BUDGET_STAGES if s not in budget["stages"]]:
            raise AssertionError(f"{who}'s stage budget lacks stages: {budget}")
        if who == "A" and min(st["n"] for st in budget["stages"].values()) < len(FX_HEIGHTS):
            raise AssertionError(f"A's stage budget does not cover heights {FX_HEIGHTS[0]}-"
                                 f"{FX_HEIGHTS[-1]}: {budget}")
        net = fx_last_json(got[(who, "net")][0])["net_budget"]
        if net is None:
            raise AssertionError(f"{who}'s net budget is null")
        out[who] = {"chains": complete, "caught_up": bad, "budget": budget, "net": net}
        stages = "; ".join(f"{k} n={v['n']} p50 {v['p50_ms']} p90 {v['p90_ms']} max "
                           f"{v['max_ms']} ms" for k, v in budget["stages"].items())
        fan = "; ".join(f"{k} n={v['n']} p50 {v['p50_ms']} p90 {v['p90_ms']} ms"
                        for k, v in net["stages"].items())
        log(f"  [16] {who}: trace --check: {summary!r}; stage "
            f"budget over {budget['blocks']} blocks, commit-to-commit p50 "
            f"{budget['commit_to_commit_p50_ms']} p90 {budget['commit_to_commit_p90_ms']} ms: "
            f"{stages}; net budget over {net['blocks']} blocks {net['heights']}: {fan}; hop "
            f"latency {net.get('hop_lat_all_ms')} ({card})")
    # 2. trace-net over both nodes' RPC
    rc, text, err, out["secs"]["trace_net"] = await fx_cli("trace-net", "--rpc", both, "--check",
                                                           "--json")
    if rc not in (0, 1):
        raise AssertionError(f"trace-net --rpc exited {rc}: {err[-3000:]}")
    doc = fx_last_json(text)
    merged = doc["merged"]
    heights = sorted(int(h) for h in merged["heights"])
    if fx_failures(doc["failures"]) or not set(FX_HEIGHTS) <= set(heights):
        raise AssertionError(f"trace-net --rpc: failures {doc['failures']}, heights {heights}")
    out["offsets"] = list(zip(merged["nodes"], merged["offsets_ms"], merged["offset_sources"],
                              merged["offset_samples"]))
    log(f"  [16] trace-net --rpc A,B --check: heights {heights} aligned, failures "
        f"{doc['failures']}; offsets "
        + ", ".join(f"{n} {o:+.3f} ms ({src}, n={k})" for n, o, src, k in out["offsets"])
        + f"; commit skew p50/p90 {merged['commit_skew_ms_p50']}/{merged['commit_skew_ms_p90']}"
        f" ms; part coverage p50/p90 {merged['coverage_ms_p50']}/{merged['coverage_ms_p90']} ms; "
        f"attribution {doc['attribution']} ({card})")
    # 3. the telescope, both alive
    text, out["secs"]["watch"] = await fx_ok("debug", "watch", "--once", "--rpc", both)
    snap = fx_last_json(text)
    alive = {n["name"]: n["alive"] for n in snap["nodes"]}
    if alive != {"a": True, "b": True} or not 0 <= (snap["fleet"]["tip_spread"] or 0) <= 1 \
            or snap["fleet"]["tip_spread"] is None:
        raise AssertionError(f"debug watch: nodes {alive}, fleet {snap['fleet']}")
    log(f"  [16] debug watch --once: {alive}, tip {snap['fleet']['tip']} spread "
        f"{snap['fleet']['tip_spread']}, quorum latency {snap['fleet'].get('quorum_latency_ms')}"
        f", hop latency {snap['fleet'].get('hop_latency_ms')}")
    # 4. a live bundle of A
    _, out["secs"]["dump"] = await fx_ok("--home", home_a, "debug", "dump", "--rpc-laddr", rpc_a,
                                         "--output", os.path.join(work, "a"))
    live = fx_bundle(fx_one(os.path.join(work, "a")))
    missing = [s for s in FX_SECTIONS if s not in live]
    if missing:
        raise AssertionError(f"A's live bundle lacks {missing}: {sorted(live)}")
    gated = [s for s in FX_RPC_SECTIONS if "error" in json.loads(live[f"{s}.json"])]
    log(f"  [16] debug dump of A: {len(live)} sections, {sum(map(len, live.values()))} bytes; "
        f"routes answering with their error: {gated}")
    # 5. debug kill B: its bundle first, then SIGKILL
    loop = asyncio.get_running_loop()
    target = (await asyncio.create_subprocess_exec(sys.executable, "-c", FX_STANDIN)
              if inproc else b.proc)
    died = loop.run_in_executor(None, lambda: (target.wait(), time.time_ns())) \
        if not inproc else loop.create_task(target.wait())
    kill_path = os.path.join(work, "kill-b.tar.gz")
    text, out["secs"]["kill"] = await fx_ok("--home", home_b, "debug", "kill", str(target.pid),
                                            "--rpc-laddr", rpc_b, "--output", kill_path)
    if inproc:
        rc = await asyncio.wait_for(died, 30)
        # B in this process: its spool dropped as SIGKILL would drop it,
        # without the final flush of its stop
        sp = b.node.flight_spool
        with sp._lock:
            sp._closed = True
            sp._group.close()
        sp.remove_crash_hooks()
        t_dead = time.time_ns()
        await b.stop()
    else:
        rc, t_dead = await asyncio.wait_for(died, 30)
    if rc != -9 or os.stat(kill_path).st_mtime_ns > t_dead:
        raise AssertionError(f"debug kill: the target exited {rc}, bundle written "
                             f"{(os.stat(kill_path).st_mtime_ns - t_dead) / 1e6:+.3f} ms after")
    killed = fx_bundle(kill_path)
    out["rc_b"] = rc
    log(f"  [16] debug kill of B: {text.strip().splitlines()}, exit {rc}")
    # 6. B's bundle from its home alone
    _, out["secs"]["offline"] = await fx_ok("--home", home_b, "debug", "dump", "--offline",
                                            "--output", os.path.join(work, "b"))
    dead = fx_bundle(fx_one(os.path.join(work, "b")))
    replay = json.loads(dead["spool.json"])
    recorded = json.loads(killed["recorder.json"])["events"]
    by_seq = {e["seq"]: e for e in replay["events"]}
    last = replay["next_seq"] - 1
    held = [e for e in recorded if e["seq"] <= last]
    lag_ms = (t_dead - replay["anchor"]["wall_ns"]) / 1e6
    span = json.loads(dead["span_report.json"])
    dispatch = [e for e in replay["events"] if e["kind"] == "verify.dispatch"]
    on_card = [e for e in dispatch if e["path"] not in ("host", "host-cold") and e["device_ms"] > 0]
    size = sum(os.path.getsize(p) for p in spool_paths(os.path.join(home_b, "data",
                                                                     "flight.spool")))
    if replay["runs"] != 1:
        raise AssertionError(f"B's spool holds {replay['runs']} runs, not its one session")
    if not 0 <= lag_ms <= FX_ANCHOR_S * 1000:
        raise AssertionError(f"B's newest spool anchor is {lag_ms:.3f} ms before its death")
    if not held or any(by_seq.get(e["seq"]) != e for e in held):
        bad = [e["seq"] for e in held if by_seq.get(e["seq"]) != e]
        raise AssertionError(f"B's replay differs from its last live dump at seqs {bad[:10]} "
                             f"({len(held)} compared)")
    if not fx_caught_up(span["bad"]) or len(span["complete"]) < FX_CHAINS:
        raise AssertionError(f"B's replayed span report: {span}")
    if not dispatch or any("path" not in e or "device_ms" not in e for e in dispatch) or (
            not inproc and not on_card):
        raise AssertionError(f"B's replay holds {len(dispatch)} verify.dispatch events, "
                             f"{len(on_card)} on the card")
    out["replay"] = {"runs": replay["runs"], "events": len(replay["events"]),
                     "compared": len(held), "anchor_ms": lag_ms, "dispatch": len(dispatch),
                     "on_card": len(on_card), "writer_lost": replay["writer_lost"],
                     "torn": replay["torn"], "bytes": size, "complete": span["complete"]}
    paths = collections.Counter(e["path"] for e in dispatch)
    log(f"  [16] debug dump --offline of B: {len(dead)} sections, manifest "
        f"{json.loads(dead['manifest.json'])['event_source']}; the replay holds "
        f"{replay['runs']} run, {len(replay['events'])} events, its newest anchor {lag_ms:.3f} ms "
        f"before B's death; {len(held)} events of the kill bundle's recorder.json up to seq "
        f"{last} all in it, identical; complete chains {span['complete']}, caught up "
        f"{span['bad']}; verify.dispatch "
        f"{len(dispatch)} by path {dict(paths)}, device ms "
        f"{sum(e['device_ms'] for e in on_card):.3f} on {len(on_card)}; writer_lost "
        f"{replay['writer_lost']}, torn {replay['torn']}, {size} bytes on disk ({card})")
    # 7. A's live dump merged with B's dead spool
    path_a, path_b = os.path.join(work, "a-recorder.json"), os.path.join(work, "b-spool.json")
    for path, data in ((path_a, live["recorder.json"]), (path_b, dead["spool.json"])):
        with open(path, "wb") as f:
            f.write(data)
    rc, text, err, out["secs"]["merge"] = await fx_cli("trace-net", path_a, path_b, "--check")
    failures = [ln[4:] for ln in err.splitlines() if ln.startswith("  - ")]
    if rc != 0 and (rc != 1 or not failures or fx_failures(failures)):
        raise AssertionError(f"trace-net <A's recorder.json> <B's spool.json> exited {rc}: "
                             f"{err[-3000:]}")
    log(f"  [16] trace-net <A's recorder.json> <B's spool.json> --check: exit {rc}, "
        f"{text.strip().splitlines()[-1] if rc == 0 else failures}")
    # 8. the telescope with B dead
    text, out["secs"]["watch_down"] = await fx_ok("debug", "watch", "--once", "--rpc", both)
    snap = fx_last_json(text)
    alive = {n["name"]: n["alive"] for n in snap["nodes"]}
    if alive.get("a") is not True or [n for n in snap["nodes"] if n["name"] != "a" and n["alive"]]:
        raise AssertionError(f"debug watch after the kill: {alive}")
    log(f"  [16] debug watch --once after the kill: {alive} (B DOWN), fleet {snap['fleet']['alive']}"
        f"/{snap['fleet']['total']} up")
    out["s"] = time.perf_counter() - t_phase
    log(f"  [16] phase 16 took {out['s']:.3f} s; per command (s): "
        + ", ".join(f"{k} {v:.3f}" for k, v in out["secs"].items()) + f" ({card})")
    return out


SS_TRUST_AT = NET_HEIGHTS  # C's trust height: A's tip (the module docstring, 12, says why)
SS_LOGGERS = ("statesync", "rpc", "rpc.server", "fastsync", "p2p", "p2p-transport", "mconn")
SS_CAUGHT_UP_S = 600.0  # C's start to caught up, at most


_HELD_PORTS = []  # free_port's sockets, bound for the life of the process


def free_port() -> int:
    """A local port nobody else is handed: the socket that found it stays
    bound (SO_REUSEADDR, never listening) until this process exits, so the
    kernel gives the port to no other bind to port 0, while the server it
    is meant for (asyncio's, SO_REUSEADDR too), here or in a child
    process, still binds it."""
    import socket

    sock = socket.socket()
    sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    sock.bind(("127.0.0.1", 0))
    _HELD_PORTS.append(sock)
    return sock.getsockname()[1]


def ss_serving_config(cfg_path, p2p_port, rpc_port, peers=""):
    """A phase 11 home's config.toml for phase 12: p2p and RPC on the given
    local ports, `peers` as persistent peers and PEX on (the JAX default),
    with the address book not strict (every address is 127.0.0.1, as in the
    JAX package's PEX tests); the rest as phase 11 left it."""
    from tendermint_tpu_torch.config import load_config, save_config

    cfg = load_config(cfg_path)
    cfg.p2p.laddr = f"tcp://127.0.0.1:{p2p_port}"
    cfg.rpc.laddr = f"tcp://127.0.0.1:{rpc_port}"
    cfg.p2p.persistent_peers = peers
    cfg.p2p.pex, cfg.p2p.addr_book_strict = True, False
    save_config(cfg, cfg_path)


def ss_home(home, gen_file, rpc_port, servers, trust_hash, peers):
    """C's home: config.toml by save_config at the JAX defaults but p2p on a
    free local port, PEX on with the address book not strict (A and B run
    PEX, and a peer without the PEX channel is dropped by the first
    pex_request it gets, ROADMAP 3.7), duplicate IPs allowed, RPC on `rpc_port`, the
    signed-tx precheck and a mempool of 10,000 as A's, state sync on with
    `servers` as its trust servers and A's header at SS_TRUST_AT as its
    root, A and B as persistent peers; phase 11's genesis; a new FilePV key
    (C is no validator) and node key, made by default_new_node."""
    import shutil

    from tendermint_tpu_torch.config import Config, save_config

    cfg = Config(home=home)
    cfg.base.chain_id = CHAIN_ID
    cfg.p2p.laddr = "127.0.0.1:0"
    cfg.p2p.pex, cfg.p2p.addr_book_strict = True, False
    cfg.rpc.laddr = f"tcp://127.0.0.1:{rpc_port}"
    cfg.p2p.persistent_peers = peers
    cfg.p2p.allow_duplicate_ip = True
    cfg.mempool.sig_precheck = True
    cfg.mempool.size = ABCI_MEMPOOL
    cfg.statesync.enable = True
    cfg.statesync.rpc_servers = servers
    cfg.statesync.trust_height = SS_TRUST_AT
    cfg.statesync.trust_hash = trust_hash.hex()
    cfg.validate_basic()
    cfg.ensure_dirs()
    path = os.path.join(home, "config", "config.toml")
    save_config(cfg, path)
    shutil.copyfile(gen_file, cfg.genesis_file())
    return path


class SsProbe:
    """Class-level hooks on the syncer, its providers' HTTP client, the
    fast-sync reactor's hand-over and the engine's launch counters, for C
    alone (A and B run in other processes on the card).  Every time is
    perf_counter seconds; `launches()` reads the three counters."""

    def __init__(self):
        from tendermint_tpu_torch.fastsync.reactor import BlockchainReactor
        from tendermint_tpu_torch.rpc.client import HTTPClient
        from tendermint_tpu_torch.statesync.syncer import StateSyncer

        self.t = {}  # milestone -> perf_counter s
        self.trust = []  # (t0, t1, snapshot height, error or None, launches before, after)
        self.rpc = []  # {"method", "ms", "bytes", "t"}
        self.restores = []  # heights whose restore began
        self._undo = []
        probe = self

        def wrap(cls, name, make):
            orig = getattr(cls, name)
            setattr(cls, name, make(orig))
            self._undo.append((cls, name, orig))

        def discover(orig):
            async def hooked(syncer):
                await orig(syncer)
                probe.t.setdefault("discovery", time.perf_counter())
            return hooked

        def trust_root(orig):
            async def hooked(syncer, height):
                t0, l0 = time.perf_counter(), probe.launches()
                try:
                    out = await orig(syncer, height)
                except Exception as e:
                    probe.trust.append((t0, time.perf_counter(), height, e, l0, probe.launches()))
                    raise
                probe.trust.append((t0, time.perf_counter(), height, None, l0, probe.launches()))
                probe.t["trust_root"] = time.perf_counter()
                return out
            return hooked

        def fetch_and_apply(orig):
            async def hooked(syncer, snap, sched, conn):
                probe.restores.append(snap.height)
                await orig(syncer, snap, sched, conn)
                probe.t["last_chunk"] = time.perf_counter()
                probe.l_restore = probe.launches()
            return hooked

        def call(orig):
            async def hooked(client, method, params=None):
                t0 = time.perf_counter()
                rec = {"method": method, "bytes": 0, "t": t0}
                probe.rpc.append(rec)
                try:
                    return await orig(client, method, params)
                finally:
                    rec["ms"] = _ms(t0)
            return hooked

        def roundtrip(orig):
            async def hooked(client, body):
                raw = await orig(client, body)
                if probe.rpc:
                    probe.rpc[-1]["bytes"] += len(body) + len(raw)
                return raw
            return hooked

        def handover(orig):
            async def hooked(reactor):
                probe.t.setdefault("tail", time.perf_counter())
                probe.tail_height = reactor.state.last_block_height
                probe.tail_synced = reactor.blocks_synced
                return await orig(reactor)
            return hooked

        wrap(StateSyncer, "_discover", discover)
        wrap(StateSyncer, "_trust_root", trust_root)
        wrap(StateSyncer, "_fetch_and_apply", fetch_and_apply)
        wrap(HTTPClient, "_call", call)
        wrap(HTTPClient, "_roundtrip", roundtrip)
        wrap(BlockchainReactor, "_switch_to_consensus", handover)
        self.l_restore = None
        self.tail_height = self.tail_synced = None

    @staticmethod
    def launches():
        return launch_counts()

    def on_node(self, node):
        """Instance hooks on C once it is built: Info after the restore and
        the two bootstraps."""
        probe = self
        conn = node.proxy_app.query()
        info = conn.info

        async def timed_info(req):
            res = await info(req)
            if "last_chunk" in probe.t:
                probe.t.setdefault("info", time.perf_counter())
            return res

        conn.info = timed_info
        for store, name in ((node.state_store, "bootstrap"),
                            (node.block_store, "bootstrap_light_block")):
            orig = getattr(store, name)

            def timed(*args, orig=orig, key=name):
                out = orig(*args)
                probe.t[key] = time.perf_counter()
                return out

            setattr(store, name, timed)

    def close(self):
        for cls, name, orig in reversed(self._undo):
            setattr(cls, name, orig)
        self._undo = []


def ss_rpc_line(calls, card) -> str:
    """The trust root's RPC fetches: calls by route, pages of /validators,
    bytes, ms per call p50/max."""
    by = collections.defaultdict(list)
    for c in calls:
        by[c["method"]].append(c)
    parts = []
    for m, cs in sorted(by.items()):
        ms = [c["ms"] for c in cs if "ms" in c]
        parts.append(f"{m} x{len(cs)} {sum(c['bytes'] for c in cs) / 1e6:.3f} MB, ms p50 "
                     f"{percentile(ms, 50):.3f} max {max(ms):.3f}")
    total = sum(c.get("ms", 0.0) for c in calls) / 1000
    return (f"{len(calls)} calls in {total:.3f} s: " + "; ".join(parts) + f" ({card})")


def phase_statesync(keys, card, dev, net, inproc=False, keep_running=False):
    """A third node joins phase 11's chain by state sync (see the module
    docstring, 12).  `net` is phase 11's out["net"]: A's and B's homes.
    `inproc` runs A and B in this process (the CPU rehearsal) instead of
    through the CLI.  Returns C's launches by stage and the run's numbers.
    With `keep_running`, A, B and C stay up once C has caught up: out["live"]
    holds them and the event loop they run on, phase 13 (phase_stockhome)
    joins them, and its end stops them with this phase's checks."""
    import asyncio

    if not keep_running:
        return asyncio.run(ss_run(keys, card, dev, net, inproc))
    loop = asyncio.new_event_loop()
    try:
        return loop.run_until_complete(ss_run(keys, card, dev, net, inproc, loop=loop))
    except BaseException:
        loop.close()
        raise


async def until(cond, what, timeout, nodes=()):
    """Poll the async `cond` every 50 ms; fail when it takes longer than
    `timeout` s or a node of `nodes` (NetB) exited."""
    import asyncio

    t = time.perf_counter()
    while not await cond():
        for x in nodes:
            if x.exited():
                raise AssertionError(f"a serving node exited {x.proc.returncode} while "
                                     f"waiting for {what}: {x.read_log()[-3000:]}")
        if time.perf_counter() - t > timeout:
            raise AssertionError(f"timed out waiting for {what}")
        await asyncio.sleep(0.05)


async def ss_run(keys, card, dev, net, inproc, loop=None):
    import asyncio
    import logging
    import tempfile

    from tendermint_tpu_torch.config import load_config
    from tendermint_tpu_torch.node import default_new_node
    from tendermint_tpu_torch.rpc.client import HTTPClient

    home_a, cfg_a, a_id = net["a"]
    home_b, cfg_b, b_id = net["b"]
    device = None if dev.type == "cuda" else dev
    ports = {k: free_port() for k in ("a_p2p", "a_rpc", "b_p2p", "b_rpc", "c_rpc")}
    a_peer = f"{a_id}@127.0.0.1:{ports['a_p2p']}"
    b_peer = f"{b_id}@127.0.0.1:{ports['b_p2p']}"
    ss_serving_config(cfg_a, ports["a_p2p"], ports["a_rpc"])
    ss_serving_config(cfg_b, ports["b_p2p"], ports["b_rpc"], peers=a_peer)
    a_rpc, b_rpc = f"127.0.0.1:{ports['a_rpc']}", f"127.0.0.1:{ports['b_rpc']}"
    a, b = NetB(home_a, cfg_a, device, inproc), NetB(home_b, cfg_b, device, inproc)
    ss_lines = []

    class Keep(logging.Handler):
        def emit(self, record):
            ss_lines.append(record.getMessage())

    live = {"a": a, "b": b, "c": None, "probe": None, "client": None, "net": net,
            "tmp": tempfile.TemporaryDirectory(prefix="chip-smoke-ss-"), "close": [],
            "stack": contextlib.ExitStack(), "keep": Keep(logging.INFO), "ss_lines": ss_lines,
            "home_a": home_a, "a_id": a_id, "b_id": b_id, "a_peer": a_peer, "b_peer": b_peer,
            "a_rpc": a_rpc, "b_rpc": b_rpc}
    home_c = os.path.join(live["tmp"].name, "c")
    ss_log = logging.getLogger("statesync")
    live["level"] = ss_log.level
    handed_over = False
    try:
        live["errors"] = live["stack"].enter_context(consensus_errors(SS_LOGGERS))
        ss_log.addHandler(live["keep"])
        ss_log.setLevel(logging.INFO)
        t = time.perf_counter()
        await asyncio.gather(a.start(), b.start())
        client = live["client"] = HTTPClient(a_rpc, timeout=60.0)

        async def served():
            try:
                st = await client.status()
            except OSError:
                return False
            return st["sync_info"]["latest_block_height"] == NET_HEIGHTS

        await until(served, "A's RPC", 120, (a, b))
        log(f"  A and B restarted from their homes in {time.perf_counter() - t:.3f} s "
            f"({'in this process' if inproc else 'python -m tendermint_tpu_torch node, each in its own process'}, "
            f"PEX on); RPC {a_rpc} and {b_rpc}, chain at height {NET_HEIGHTS} ({card})")
        root = (await client.commit(SS_TRUST_AT))["signed_header"]
        a_seq = (await client._call("dump_flight_recorder", {"kinds": "none."}))["next_seq"]
        cfg_c = ss_home(home_c, os.path.join(home_a, "config", "genesis.json"),
                        ports["c_rpc"], f"{a_rpc},{b_rpc}", root.header.hash(),
                        f"{a_peer},{b_peer}")
        log(f"  C's trust root: A's /commit at height {SS_TRUST_AT}, header "
            f"{root.header.hash().hex()[:16]}; trust servers A (primary) and B (witness)")
        probe = live["probe"] = SsProbe()
        t_c = time.perf_counter()
        c = live["c"] = default_new_node(load_config(cfg_c), device=device)
        await c.start()
        probe.on_node(c)
        t_started = time.perf_counter()
        if not c.statesync_reactor.syncing:
            raise AssertionError("C did not start state sync")
        c_client = HTTPClient(f"127.0.0.1:{ports['c_rpc']}", timeout=60.0)

        async def caught_up():
            if c.block_store.height() < NET_HEIGHTS or c.consensus_reactor.wait_sync:
                return False
            st = await c_client.status()
            return not st["sync_info"]["catching_up"]

        try:
            await until(caught_up, "C caught up", SS_CAUGHT_UP_S, (a, b))
            probe.t["caught_up"] = time.perf_counter()
            live["status"] = await c_client.status()
        finally:
            await c_client.close()
        dump = await client._call("dump_flight_recorder", {"since": a_seq})
        l_end = probe.launches()
        out = ss_report(c, probe, t_c, t_started, dump, l_end, card)
        if loop is not None:
            probe.close()  # C's milestones are in; phase 13's nodes must not add to them
            handed_over = True
            out["live"] = dict(live, loop=loop)
            return out
        out.update(await ss_finish(live))
        return out
    finally:
        if not handed_over:
            await ss_cleanup(live)


async def ss_finish(live, extra=None):
    """Phase 12's end: C stops, then A and B (SIGTERM through the CLI), then
    its checks on A's reopened stores; `extra(store_a, state_store_a)`, when
    given, runs with them open and its result is under "extra"."""
    import asyncio

    from tendermint_tpu_torch.libs.kvstore import open_db
    from tendermint_tpu_torch.state import StateStore
    from tendermint_tpu_torch.store import BlockStore

    a, b, c = live["a"], live["b"], live["c"]
    try:
        await c.stop()
        await live["client"].close()
        await asyncio.gather(a.stop(), b.stop())
        live["stack"].close()  # the ERROR capture ends with the nodes
        dbs_a = {n: open_db(n, live["home_a"]) for n in ("blockstore", "state")}
        try:
            store_a, state_store_a = BlockStore(dbs_a["blockstore"]), StateStore(dbs_a["state"])
            out = ss_check(c, store_a, state_store_a, a, b, live["probe"], live["ss_lines"],
                           live["errors"], live["status"])
            if extra is not None:
                out["extra"] = extra(store_a, state_store_a)
        finally:
            for db in dbs_a.values():
                db.close()
        return out
    finally:
        await ss_cleanup(live)


async def ss_cleanup(live):
    """Stop whatever still runs of phase 12 (and 13), close the stores this
    process opened and remove every home.  Runs once."""
    import logging
    import threading

    if live.get("cleaned"):
        return
    live["cleaned"] = True
    ss_log = logging.getLogger("statesync")
    ss_log.removeHandler(live["keep"])
    ss_log.setLevel(live["level"])
    live["stack"].close()
    if live["probe"] is not None:
        live["probe"].close()
    if live["client"] is not None:
        await live["client"].close()
    c = live["c"]
    if c is not None and c.is_running:
        await c.stop()
    for x in (live["a"], live["b"]):
        await x.stop()
    nodes = [c] + live["close"]
    for node in nodes:
        if node is None:
            continue
        for db in (node.block_store.db, node.state_db, getattr(node.tx_indexer, "db", None)):
            if db is not None:
                db.close()
    for t in threading.enumerate():  # the engine's background builds and probe
        if t.name in ("table-build", "table-rebuild", "bv-rtt-probe", "bv-warmup"):
            t.join()
    live["tmp"].cleanup()
    live["net"]["tmp"].cleanup()


def ss_check(c, store_a, state_store_a, a, b, probe, ss_lines, errors, status):
    """Phase 12's outcome (see the module docstring, 12).  Returns the
    snapshot height and C's launches by stage."""
    if len(probe.restores) != 1:
        raise AssertionError(f"C began {len(probe.restores)} restores, not one: {probe.restores}")
    snap_h = probe.restores[0]
    if snap_h >= NET_HEIGHTS or snap_h % SS_SNAPSHOT_INTERVAL:
        raise AssertionError(f"C restored the snapshot at {snap_h}, not one below the tip")
    # the highest snapshot (at the tip) cannot verify: its H+1 header does
    # not exist, so each of the syncer's 5 attempts fails and it is rejected
    top = [x for x in probe.trust if x[2] == NET_HEIGHTS]
    if len(top) != 5 or not all(x[3] is not None for x in top):
        raise AssertionError(f"the tip's snapshot was tried {len(top)} times, not 5 failed times")
    want = f"statesync: snapshot rejected height={NET_HEIGHTS}"
    hits = [m for m in ss_lines if m.startswith(want)]
    if len(hits) != 1 or "trust root unavailable: commit(" not in hits[0] or \
            f"height {NET_HEIGHTS + 1} must be less than or equal to {NET_HEIGHTS}" not in hits[0]:
        raise AssertionError(f"the tip's snapshot was not rejected with the JAX messages: {hits}")
    for m in ("statesync: discovery complete", "statesync: restoring snapshot",
              "statesync: snapshot restored", "statesync: handing over to fastsync"):
        if not any(x.startswith(m) for x in ss_lines):
            raise AssertionError(f"C's statesync log lacks {m!r}")
    for k in ("discovery", "trust_root", "last_chunk", "info", "bootstrap",
              "bootstrap_light_block", "tail", "caught_up"):
        if k not in probe.t:
            raise AssertionError(f"C never reached {k}")
    if c.block_store.base() != snap_h or c.block_store.height() < NET_HEIGHTS:
        raise AssertionError(f"C's block store holds {c.block_store.base()}..."
                             f"{c.block_store.height()}, not {snap_h}..{NET_HEIGHTS}")
    # the tip is H + 2: fast sync applies H + 1 if it arrives within the
    # reactor's 1 s grace, else its tip-1 rule hands over at H and H + 1
    # comes by catch-up gossip with H + 2 (both seen on the card)
    if probe.tail_height not in (snap_h, snap_h + 1) or \
            probe.tail_synced != probe.tail_height - snap_h:
        raise AssertionError(f"C's fast sync switched at {probe.tail_height} after "
                             f"{probe.tail_synced} blocks, not at {snap_h} or {snap_h + 1}")
    meta_a, meta_c = store_a.load_block_meta(snap_h), c.block_store.load_block_meta(snap_h)
    if meta_c.header.hash() != meta_a.header.hash():
        raise AssertionError(f"C's header at {snap_h} is not A's")
    for h in range(snap_h + 1, NET_HEIGHTS + 1):
        if c.block_store.load_block(h).serialize() != store_a.load_block(h).serialize():
            raise AssertionError(f"C's block {h} is not byte-equal to A's")
    for h in range(snap_h, NET_HEIGHTS + 3):
        va, vc = state_store_a.load_validators(h), c.state_store.load_validators(h)
        if vc is None or va.hash() != vc.hash():
            raise AssertionError(f"C's validators at {h} are not A's")
    # A restored state dates its last set and params change at H + 1, and
    # its sets are rebuilt from /validators pages by ValidatorSet(vals),
    # which resets the proposer priorities (the JAX syncer's State and
    # provider do both; ROADMAP 3.6).  Every other field must equal A's,
    # and the sets their hashes (which leave the priorities out).
    st_a, st_c = state_store_a.load(), c.state_store.load()
    da, dc = st_a.to_dict(), st_c.to_dict()
    since = ("last_height_validators_changed", "last_height_consensus_params_changed")
    sets = ("validators", "next_validators", "last_validators")
    diff = sorted(k for k in da if da[k] != dc.get(k) and k not in since + sets)
    if st_c.last_block_height != NET_HEIGHTS or diff or any(dc[k] != snap_h + 1 for k in since) \
            or any(getattr(st_a, k).hash() != getattr(st_c, k).hash() for k in sets):
        raise AssertionError(f"C's state at {st_c.last_block_height} is not A's: {diff}, "
                             f"{[(dc[k], da[k]) for k in since]}")
    priorities = sum(x.proposer_priority != y.proposer_priority for x, y in
                     zip(st_a.validators.validators, st_c.validators.validators))
    if status["sync_info"]["catching_up"] or status["sync_info"]["sync_phase"] != "caught_up":
        raise AssertionError(f"C's /status says {status['sync_info']}")
    if status["sync_info"]["earliest_block_height"] != snap_h:
        raise AssertionError("C's /status earliest height is not the snapshot's")
    bad = [e for x in (a, b) for e in x.errors
           if e.split(" ", 2)[1].rstrip(":") in SS_LOGGERS]
    if errors or bad:
        raise AssertionError(f"errors logged: C {errors[:3]}, A and B {bad[:3]}")
    for x, name in ((a, "A"), (b, "B")):
        if x.rc != 0 or "Traceback" in x.text:
            raise AssertionError(f"node {name} exited {x.rc} on SIGTERM or printed a traceback: "
                                 f"{x.text[-3000:]}")
    return {"snapshot": snap_h, "priorities": priorities, "fast_synced": probe.tail_synced}


def ss_report(c, probe, t_c, t_started, dump, l_end, card) -> dict:
    """C's milestones, the trust root's split, the chunks and A's side (see
    the module docstring, 12).  Returns C's launches by stage."""
    t = probe.t
    ok = [x for x in probe.trust if x[3] is None][-1]
    marks = [("node start", t_started), ("end of discovery", t["discovery"]),
             ("trust root", t["trust_root"])]
    evs = c.flight_recorder.events()
    off = time.perf_counter() - time.monotonic_ns() / 1e9
    kinds = collections.Counter(e["kind"] for e in evs)
    offer = [e for e in evs if e["kind"] == "statesync.offer"]
    chunks = [e for e in evs if e["kind"] == "statesync.chunk"]
    marks += [("offer", offer[-1]["t_ns"] / 1e9 + off), ("last chunk", t["last_chunk"]),
              ("Info", t["info"]), ("bootstrap", max(t["bootstrap"], t["bootstrap_light_block"])),
              ("tail (fast sync's hand-over)", t["tail"]), ("caught up", t["caught_up"])]
    log("  C from its start: " + "; ".join(f"{k} +{v - t_c:.3f} s" for k, v in marks)
        + f"; fast sync applied {probe.tail_synced} block(s) and handed over at height "
        f"{probe.tail_height}, the rest came by catch-up gossip ({card})")
    rpc = [x for x in probe.rpc if x["t"] <= ok[1]]
    log(f"  trust root: {len(probe.trust)} attempts ({sum(1 for x in probe.trust if x[3])} "
        f"failed), {ok[1] - probe.trust[0][0]:.3f} s from the first; RPC fetch " + ss_rpc_line(
            rpc, card))
    pages = sum(1 for x in rpc if x["method"] == "validators")
    val_ms = [x["ms"] for x in rpc if x["method"] == "validators"]
    log(f"  /validators: {pages} pages of at most 100 ({pages / 100:.2f} sets of 10,000), "
        f"{sum(val_ms) / 1000:.3f} s, ms per page p50 {percentile(val_ms, 50):.3f} max "
        f"{max(val_ms):.3f} (each page decodes the whole set in A's load_validators) ({card})")
    t0_trust = probe.trust[0][0] - off
    dispatch = [e for e in evs if e["kind"] == "verify.dispatch"
                and t0_trust <= e["t_ns"] / 1e9 <= ok[1] - off]
    flushes = [e for e in evs if e["kind"] == "verify.flush"
               and t0_trust <= e["t_ns"] / 1e9 <= ok[1] - off]
    log(f"  trust root verify: {len(flushes)} flushes of {[e['batch'] for e in flushes]}; "
        f"dispatches " + ", ".join(f"{e['path']} n={e['n']} host_prep_ms {e['host_prep_ms']} "
                                   f"device_ms {e['device_ms']}" for e in dispatch)
        + f" ({card})")
    if chunks:
        span = (chunks[-1]["t_ns"] - offer[-1]["t_ns"]) / 1e9
        log(f"  chunks: {len(chunks)} applied (of {c.statesync_reactor.syncer.chunks_total}), "
            f"offer to last chunk {span:.3f} s, {len(chunks) / max(span, 1e-9):.3f} chunks/s; "
            f"recorder events {dict((k, v) for k, v in kinds.items() if k.startswith('statesync.'))}"
            f" ({card})")
    akinds = collections.Counter(e["kind"] for e in dump["events"])
    log(f"  A's flight recorder over C's sync (dump_flight_recorder over A's RPC): "
        f"{len(dump['events'])} events, dropped {dump['dropped']}: "
        + ", ".join(f"{k} {v}" for k, v in akinds.most_common(12)))
    stages = {"trust_root": {k: ok[5][k] - probe.trust[0][4][k] for k in ok[5]}}
    if probe.l_restore is not None:
        stages["tail"] = {k: l_end[k] - probe.l_restore[k] for k in l_end}
    stages["all"] = l_end
    log(f"  C's launches: trust root {stages['trust_root']}, after the restore "
        f"{stages.get('tail')}, in all {l_end}")
    return {"stages": stages, "snapshot": probe.restores[0] if probe.restores else None}


SH_TENANTS = 4  # phase 13: the gateway's light-client tenants (16 before phase 17, 8 before 19)
SH_ROOT = 2  # the gateway's trust height; tenants ask for SH_ROOT .. NET_HEIGHTS
SH_WITNESS_TIMEOUT = 30.0  # s: a witness /commit of the 10k set is ~1.4 MB (see sh_gateway)
SH_CAUGHT_UP_S = 300.0  # D's start to caught up, at most
SH_LOGGERS = ("pex", "addrbook", "rpc", "rpc.server", "liteserve", "liteserve.cache",
              "liteserve.witness", "liteserve.sessions", "liteserve.bootstrap", "lite2",
              "fastsync", "p2p", "p2p-transport", "mconn")


class ShProbe:
    """Class-level hooks for phase 13: the switch's dials, the address
    book's adds, the PEX reactor's frames, apply_block's end by height and
    the gateway's provider reads (each kept with the object it ran on, so
    D's are told from A's, B's and C's where those run in this process).
    Times are perf_counter seconds."""

    def __init__(self):
        from tendermint_tpu_torch.encoding import codec
        from tendermint_tpu_torch.lite2.provider import _RPCProvider
        from tendermint_tpu_torch.p2p import AddrBook, PEXReactor, Switch
        from tendermint_tpu_torch.state.execution import BlockExecutor

        self.dials = []  # (t, switch, addr)
        self.adds = []  # (t, book, addr, src, accepted)
        self.pex_in = []  # (t, reactor, kind)
        self.pex_req = []  # (t, reactor, peer id): requests sent
        self.applied = {}  # height -> t of apply_block's end (first)
        self.reads = []  # (t0, t1, provider, height)
        self._undo = []
        probe = self

        def wrap(cls, name, make):
            orig = getattr(cls, name)
            setattr(cls, name, make(orig))
            self._undo.append((cls, name, orig))

        def dial(orig):
            async def hooked(sw, addr, persistent=False):
                probe.dials.append((time.perf_counter(), sw, addr))
                return await orig(sw, addr, persistent)
            return hooked

        def add(orig):
            def hooked(book, addr, src=""):
                ok = orig(book, addr, src)
                probe.adds.append((time.perf_counter(), book, addr, src, ok))
                return ok
            return hooked

        def receive(orig):
            async def hooked(r, chan_id, peer, msg_bytes):
                try:
                    kind = codec.loads(msg_bytes).get("t")
                except Exception:
                    kind = None
                probe.pex_in.append((time.perf_counter(), r, kind))
                return await orig(r, chan_id, peer, msg_bytes)
            return hooked

        def request(orig):
            async def hooked(r, peer):
                before = peer.id in r._requests_sent
                await orig(r, peer)
                if not before and peer.id in r._requests_sent:
                    probe.pex_req.append((time.perf_counter(), r, peer.id))
            return hooked

        def apply(orig):
            async def hooked(ex, state, block_id, block, *a, **k):
                out = await orig(ex, state, block_id, block, *a, **k)
                probe.applied.setdefault(block.height, time.perf_counter())
                return out
            return hooked

        def read(orig):
            async def hooked(prov, height):
                t0 = time.perf_counter()
                try:
                    return await orig(prov, height)
                finally:
                    probe.reads.append((t0, time.perf_counter(), prov, height))
            return hooked

        wrap(Switch, "dial_peer", dial)
        wrap(AddrBook, "add_address", add)
        wrap(PEXReactor, "receive", receive)
        wrap(PEXReactor, "_request_addrs", request)
        wrap(BlockExecutor, "apply_block", apply)
        wrap(_RPCProvider, "signed_header", read)

    launches = staticmethod(SsProbe.launches)

    def close(self):
        for cls, name, orig in reversed(self._undo):
            setattr(cls, name, orig)
        self._undo = []


def sh_home(home, gen_file, seed, rpc_port):
    """D's home as an operator makes it: the port's `init` (the JAX defaults:
    PEX on, fast sync on, 10 outbound peers), then `seed` as its one seed,
    p2p and RPC on local ports, the address book not strict and duplicate
    IPs allowed (every node is on 127.0.0.1), and phase 11's genesis."""
    import io
    import shutil

    from tendermint_tpu_torch import cli
    from tendermint_tpu_torch.config import load_config, save_config

    with contextlib.redirect_stdout(io.StringIO()):
        if cli.main(["--home", home, "init", "--chain-id", CHAIN_ID]) != 0:
            raise AssertionError("init failed for D's home")
    path = os.path.join(home, "config", "config.toml")
    cfg = load_config(path)
    got = (cfg.p2p.pex, cfg.base.fast_sync, cfg.p2p.max_num_outbound_peers,
           cfg.p2p.persistent_peers, cfg.p2p.seeds)
    if got != (True, True, 10, "", ""):
        raise AssertionError(f"init's home is not the stock one: {got}")
    cfg.p2p.seeds = seed
    cfg.p2p.laddr = "tcp://127.0.0.1:0"
    cfg.rpc.laddr = f"tcp://127.0.0.1:{rpc_port}"
    cfg.p2p.addr_book_strict = False
    cfg.p2p.allow_duplicate_ip = True
    save_config(cfg, path)
    shutil.copyfile(gen_file, cfg.genesis_file())
    return path


def phase_stockhome(keys, card, dev, ss):
    """A node from a stock home joins the 10,000-validator chain by PEX,
    fast-syncs it, streams NewBlock over /websocket and serves light-client
    tenants from its gateway (see the module docstring, 13).  `ss` is
    phase 12's out with keep_running: A, B and C, alive, and their loop.
    Stops them with phase 12's checks.  Returns D's launches by stage and
    its table checks."""
    loop = ss["live"]["loop"]
    try:
        return loop.run_until_complete(sh_run(keys, card, dev, ss["live"]))
    finally:
        loop.run_until_complete(loop.shutdown_asyncgens())
        loop.run_until_complete(loop.shutdown_default_executor())
        loop.close()


async def sh_run(keys, card, dev, live):
    import asyncio

    from tendermint_tpu_torch.config import load_config
    from tendermint_tpu_torch.node import default_new_node
    from tendermint_tpu_torch.rpc.client import HTTPClient, WSClient

    device = None if dev.type == "cuda" else dev
    a, b, c = live["a"], live["b"], live["c"]
    nodes = (a, b)
    t_phase = time.perf_counter()
    d = ws = probe = client_a = drain = None
    stack = contextlib.ExitStack()
    finished = False
    try:
        errors = stack.enter_context(consensus_errors(SH_LOGGERS))
        cfg_d = sh_home(os.path.join(live["tmp"].name, "d"),
                        os.path.join(live["home_a"], "config", "genesis.json"),
                        live["a_peer"], free_port())
        probe = ShProbe()
        t_d = time.perf_counter()
        d = default_new_node(load_config(cfg_d), device=device)
        live["close"].append(d)
        starting = asyncio.ensure_future(d.start())
        while d.rpc_server is None or not d.rpc_server.listen_addr:
            if starting.done():
                starting.result()
                break
            await asyncio.sleep(0.002)
        # the WebSocket subscription, as soon as D's RPC listens
        ws = WSClient(d.rpc_server.listen_addr, timeout=120.0)
        await ws.connect()
        events = await ws.subscribe("tm.event = 'NewBlock'")
        h_sub = d.block_store.height()
        t_sub = time.perf_counter()
        notes = []  # (t, height, block hash) per NewBlock notification

        async def consume():
            async for ev in events:
                blk = ev["data"]["value"]["block"]
                notes.append((time.perf_counter(), blk.header.height, blk.hash()))

        drain = asyncio.ensure_future(consume())
        await starting
        t_started = time.perf_counter()
        rec = d.flight_recorder

        async def caught_up():
            if d.block_store.height() < NET_HEIGHTS or d.consensus_reactor.wait_sync:
                return False
            st = await ws.status()
            return not st["sync_info"]["catching_up"]

        await until(caught_up, "D caught up", SH_CAUGHT_UP_S, nodes)
        t_caught = time.perf_counter()
        status = await ws.status()  # over the same socket
        want = set(range(h_sub + 1, NET_HEIGHTS + 1))

        async def notified():
            return want <= {h for _, h, _ in notes}

        await until(notified, "D's NewBlock notifications", 30, nodes)
        mesh = {live["a_id"], live["b_id"], c.node_key.id}

        async def meshed():
            return mesh <= set(d.switch.peers)

        # PEX's ensure-peers loop dials what A gossiped every 2 s; a sync
        # faster than that (the CPU rehearsal's) finishes first
        await until(meshed, "D connected to A, B and C", 60, nodes)
        t_meshed = time.perf_counter()
        l_sync = probe.launches()
        tables = [e["hit"] for e in rec.events(kinds=["verify.table"])
                  if e["kind"] == "verify.table"]
        client_a = HTTPClient(live["a_rpc"], timeout=120.0)
        metas = (await client_a.blockchain(1, NET_HEIGHTS))["block_metas"]
        a_hash = {m.header.height: m.block_id.hash for m in metas}
        gw = await sh_gateway(d, client_a, live, probe, card)
        l_tenants = probe.launches()
        await ws.close()
        drain.cancel()
        t_stop = time.perf_counter()
        await d.stop()  # with the gateway; saves D's address book
        stop_s = time.perf_counter() - t_stop
        probe.close()

        def on_a_stores(store_a, state_store_a):
            return sh_check(d, live, store_a, state_store_a, a_hash, status, notes, h_sub,
                            tables, errors, probe, gw)

        finished = True
        ss_out = await ss_finish(live, extra=on_a_stores)
        stack.close()
        out = ss_out.pop("extra")
        out["ss"] = ss_out
        out["stages"] = {"sync": l_sync,
                         "gateway": {k: gw["l_gw"][k] - l_sync[k] for k in l_sync},
                         "tenants": {k: l_tenants[k] - gw["l_gw"][k] for k in l_sync}}
        sh_report(d, live, probe, out, gw, notes, h_sub, t_d, t_sub, t_started, t_caught,
                  t_meshed, stop_s, card)
        log(f"  phase 13 took {time.perf_counter() - t_phase:.3f} s ({card})")
        return out
    finally:
        if probe is not None:
            probe.close()
        if drain is not None:
            drain.cancel()
        if ws is not None and ws._ws is not None and not ws._ws.closed:
            await ws.close()
        if client_a is not None:
            await client_a.close()
        if d is not None and d.is_running:
            await d.stop()
        stack.close()
        if not finished:
            await ss_cleanup(live)


async def sh_gateway(d, client_a, live, probe, card) -> dict:
    """D's gateway through the wiring Node.start runs for liteserve.enable,
    rooted at A's header 2 with A and B as witnesses, then SH_TENANTS tenants: each
    opens a session and asks for the commits of heights 2-6 at once.  The
    witness timeout is 30 s, not the JAX default 3 s: each witness read is a
    1.4 MB /commit, and this loop also serves the tenants' answers."""
    import asyncio

    from tendermint_tpu_torch.rpc.http import read_response
    from tendermint_tpu_torch.rpc.jsonrpc import from_jsonable
    from tendermint_tpu_torch.types.block import Header

    root = (await client_a.commit(SH_ROOT))["signed_header"]
    ls = d.config.liteserve
    ls.enable = True
    ls.laddr = f"tcp://127.0.0.1:{free_port()}"
    ls.trust_height, ls.trust_hash = SH_ROOT, root.header.hash().hex()
    ls.witnesses = f"{live['a_rpc']},{live['b_rpc']}"
    ls.witness_quorum = 2
    ls.witness_timeout = SH_WITNESS_TIMEOUT
    rec = d.flight_recorder
    seq = next_seq(rec)
    n_reads = len(probe.reads)
    t0 = time.perf_counter()
    await d._start_liteserve()
    start_s = time.perf_counter() - t0
    l_gw = probe.launches()
    reads = probe.reads[n_reads:]
    evs = rec.events(since=seq, kinds=["verify.", "liteserve."])
    host, port = d.liteserve.listen_addr.rsplit(":", 1)

    async def post(method, **params):
        body = json.dumps({"jsonrpc": "2.0", "id": 1, "method": method,
                           "params": params}).encode()
        t = time.perf_counter()
        r, w = await asyncio.open_connection(host, int(port), limit=1 << 20)
        try:
            w.write(b"POST / HTTP/1.1\r\nHost: x\r\nContent-Type: application/json\r\n"
                    b"Content-Length: %d\r\n\r\n" % len(body) + body)
            status, _, raw = await read_response(r)
        finally:
            w.close()
        ms = _ms(t)
        d_ = json.loads(raw)
        if status != 200 or "result" not in d_:
            raise AssertionError(f"the gateway answered {method} {params} with {status} "
                                 f"{str(d_)[:300]}")
        return d_["result"], ms, len(raw)

    async def tenant():
        res, ms, n = await post("lite_session_new", trust_height=SH_ROOT,
                                trust_hash=root.header.hash().hex())
        sid = res["session"]
        answers = await asyncio.gather(*(post("lite_commit", session=sid, height=h)
                                         for h in range(SH_ROOT, NET_HEIGHTS + 1)))
        out = []
        for h, (res, ms_h, n_h) in zip(range(SH_ROOT, NET_HEIGHTS + 1), answers):
            header = Header.from_dict(from_jsonable(res["signed_header"]["header"]))
            out.append((h, header.hash(), ms_h, n_h))
        return ms, out

    t1 = time.perf_counter()
    tenants = await asyncio.gather(*(tenant() for _ in range(SH_TENANTS)))
    tenants_s = time.perf_counter() - t1
    status = (await post("lite_status"))[0]
    return {"peers": {pid: p.outbound for pid, p in d.switch.peers.items()},
            "start_s": start_s, "l_gw": l_gw, "events": evs, "tenants": tenants,
            "tenants_s": tenants_s, "status": status, "reads": reads,
            "cache": d.liteserve.cache.stats(),
            "lookups": (d.liteserve.lookup_hits, d.liteserve.lookup_misses,
                        d.liteserve.coalesced_requests)}


def sh_check(d, live, store_a, state_store_a, a_hash, status, notes, h_sub, tables, errors,
             probe, gw) -> dict:
    """Phase 13's outcome (see the module docstring, 13), with A's stores
    open after every node stopped.  Returns D's table checks."""
    from tendermint_tpu_torch.p2p import AddrBook

    a_id, b_id = live["a_id"], live["b_id"]
    c_id = live["c"].node_key.id
    d_id = d.node_key.id
    seed_dials = [x for x in probe.dials if x[1] is d.switch]
    if not seed_dials or seed_dials[0][2] != live["a_peer"]:
        raise AssertionError(f"D's first dial was not its seed A: {[x[2] for x in seed_dials]}")
    if not any(r is d.pex_reactor and pid == a_id for _, r, pid in probe.pex_req):
        raise AssertionError("D did not ask its seed A for addresses")
    book = d.addr_book
    for pid, name in ((b_id, "B"), (c_id, "C")):
        ka = book.addrs.get(pid)
        if ka is None or ka.src != a_id:
            raise AssertionError(f"D's book holds {name} from {ka and ka.src}, not from A")
    # B and C learned D from A too, so either end may dial first; D ends
    # connected to both (PEX's own rule, not a persistent peer)
    if not {a_id, b_id, c_id} <= set(gw["peers"]):
        raise AssertionError(f"D's peers at the end are {sorted(gw['peers'])}, not A, B and C")
    saved = AddrBook(d.config.addr_book_file(), strict=False)
    if not {a_id, b_id, c_id} <= set(saved.addrs):
        raise AssertionError("D's stop did not save its address book with A, B and C")
    saved_a = AddrBook(os.path.join(live["home_a"], "config", "addrbook.json"), strict=False)
    if not {b_id, c_id, d_id} <= set(saved_a.addrs):
        raise AssertionError(f"A's addrbook.json holds {sorted(saved_a.addrs)}, not B, C and D")
    # fast sync and catch-up: D's blocks are A's, byte for byte
    if d.block_store.height() < NET_HEIGHTS or d.block_store.base() != 1:
        raise AssertionError(f"D's store holds {d.block_store.base()}..{d.block_store.height()}")
    for h in range(1, NET_HEIGHTS + 1):
        if d.block_store.load_block(h).serialize() != store_a.load_block(h).serialize():
            raise AssertionError(f"D's block {h} is not byte-equal to A's")
    st_a, st_d = state_store_a.load(), d.state_store.load()
    if st_d.last_block_height != NET_HEIGHTS or st_d.app_hash != st_a.app_hash:
        raise AssertionError("D's state or app hash is not A's")
    if status["sync_info"]["latest_block_height"] != NET_HEIGHTS or \
            status["sync_info"]["catching_up"]:
        raise AssertionError(f"D's /status over /websocket says {status['sync_info']}")
    # every block D applied after the subscription was notified, as A's
    got = {}
    for _, h, hsh in notes:
        if h in got:
            raise AssertionError(f"two NewBlock notifications of height {h}")
        got[h] = hsh
    if set(got) != set(range(h_sub + 1, NET_HEIGHTS + 1)) or NET_HEIGHTS not in got:
        raise AssertionError(f"NewBlock notified {sorted(got)} after subscribing at {h_sub}")
    for h, hsh in got.items():
        if hsh != a_hash[h]:
            raise AssertionError(f"the NewBlock notification of {h} is not A's block")
    # the gateway: every answer A's, each header verified at most once
    answers = [x for _, per in gw["tenants"] for x in per]
    if len(answers) != SH_TENANTS * (NET_HEIGHTS - SH_ROOT + 1):
        raise AssertionError(f"{len(answers)} tenant answers")
    for h, hsh, _, _ in answers:
        if hsh != a_hash[h]:
            raise AssertionError(f"a tenant's header {h} is not A's")
    cache = gw["cache"]
    if cache["misses"] > NET_HEIGHTS - SH_ROOT + 1:
        raise AssertionError(f"the gateway's VerifyCache verified {cache['misses']} commits")
    st = gw["status"]
    if st["sessions"]["sessions"] != SH_TENANTS or st["witnesses"]["active"] != 2 or \
            any(w["errors"] for w in st["witnesses"]["witnesses"]):
        raise AssertionError(f"lite_status: sessions {st['sessions']}, witnesses "
                             f"{st['witnesses']}")
    bad = [e for x in (live["a"], live["b"]) for e in x.errors
           if e.split(" ", 2)[1].rstrip(":") in SH_LOGGERS]
    if errors or bad:
        raise AssertionError(f"errors logged: C and D {errors[:3]}, A and B {bad[:3]}")
    return {"declines": sum(1 for hit in tables if not hit),
            "hits": sum(1 for hit in tables if hit)}


def sh_report(d, live, probe, out, gw, notes, h_sub, t_d, t_sub, t_started, t_caught, t_meshed,
              stop_s, card):
    """Phase 13's prints (see the module docstring, 13)."""
    a_id = live["a_id"]
    dials = [(t, addr) for t, sw, addr in probe.dials if sw is d.switch]
    learned = [(t, addr.split("@")[0]) for t, book, addr, src, ok in probe.adds
               if book is d.addr_book and ok and src == a_id]
    names = {live["b_id"]: "B", live["c"].node_key.id: "C", a_id: "A"}
    marks = [("RPC up and NewBlock subscribed", t_sub), ("node started", t_started)]
    if dials:
        marks.append(("seed dial", dials[0][0]))
    seen = set()
    for t, pid in learned:
        if pid not in seen:
            seen.add(pid)
            marks.append((f"{names.get(pid, pid[:8])} learned by PEX", t))
    for t, addr in dials[1:]:
        marks.append((f"dial {names.get(addr.split('@')[0], addr[:8])}", t))
    for h in sorted(probe.applied):
        marks.append((f"block {h} applied", probe.applied[h]))
    marks += [("caught up", t_caught), ("connected to A, B and C", t_meshed)]
    marks.sort(key=lambda m: m[1])
    log("  D from its start: " + "; ".join(f"{k} +{v - t_d:.3f} s" for k, v in marks)
        + f" ({card})")
    book = d.addr_book
    n_old = sum(1 for ka in book.addrs.values() if ka.is_old())
    mine_in = collections.Counter(k for _, r, k in probe.pex_in if r is d.pex_reactor)
    mine_out = sum(1 for _, r, _ in probe.pex_req if r is d.pex_reactor)
    log(f"  D's book: {book.size()} addresses ({book.size() - n_old} new, {n_old} old); PEX "
        f"frames: D sent {mine_out} pex_request and {mine_in['pex_request']} pex_addrs, "
        f"received {dict(mine_in)}; peers at the end (outbound = D dialed) "
        + ", ".join(f"{names.get(p, p[:8])} {'outbound' if o else 'inbound'}"
                    for p, o in sorted(gw["peers"].items())))
    lags = [(h, (t - probe.applied[h]) * 1000) for t, h, _ in notes if h in probe.applied]
    log(f"  /websocket NewBlock: subscribed at height {h_sub}, {len(notes)} notifications "
        f"{[h for _, h, _ in notes]}, lag behind apply_block ms "
        + ", ".join(f"{h}: {ms:.3f}" for h, ms in lags) + f" ({card})")
    evs = gw["events"]
    boot = [e for e in evs if e["kind"] == "liteserve.bootstrap"]
    flushes = [e for e in evs if e["kind"] == "verify.flush"]
    dispatch = [e for e in evs if e["kind"] == "verify.dispatch"]
    by_prov = collections.defaultdict(list)
    for t0, t1, prov, h in gw["reads"]:
        url = getattr(prov.client, "url", "local")
        by_prov[url].append((h, (t1 - t0) * 1000))
    log(f"  gateway start {gw['start_s']:.3f} s: bootstrap {boot[0]['ms'] if boot else '?'} ms "
        f"(root {SH_ROOT}, tip {boot[0]['tip'] if boot else '?'}); provider reads "
        + "; ".join(f"{u}: " + ", ".join(f"h{h} {ms:.3f} ms" for h, ms in v)
                    for u, v in by_prov.items())
        + f"; verify flushes {[e['batch'] for e in flushes]}, dispatches "
        + ", ".join(f"{e['path']} n={e['n']} host_prep_ms {e['host_prep_ms']} device_ms "
                    f"{e['device_ms']}" for e in dispatch) + f" ({card})")
    ms = [x[2] for _, per in gw["tenants"] for x in per]
    nbytes = [x[3] for _, per in gw["tenants"] for x in per]
    new_ms = [t for t, _ in gw["tenants"]]
    log(f"  tenants: {SH_TENANTS} sessions (lite_session_new ms p50 {percentile(new_ms, 50):.3f} "
        f"max {max(new_ms):.3f}), {len(ms)} lite_commit answers in {gw['tenants_s']:.3f} s "
        f"({len(ms) / gw['tenants_s']:.3f} requests/s): ms p50 {percentile(ms, 50):.3f} p99 "
        f"{percentile(ms, 99):.3f} max {max(ms):.3f}, bytes p50 {percentile(nbytes, 50):.0f} "
        f"max {max(nbytes)} ({card})")
    hits, misses, coalesced = gw["lookups"]
    log(f"  gateway lookups: {hits} hits, {misses} misses, {coalesced} coalesced joins; "
        f"VerifyCache {gw['cache']}; lite_status sessions {gw['status']['sessions']['sessions']}, "
        f"witnesses {gw['status']['witnesses']['active']} active")
    log(f"  D's launches: discovery and fast sync {out['stages']['sync']}, gateway start "
        f"{out['stages']['gateway']}, tenants {out['stages']['tenants']}; table checks "
        f"{out['hits']} hits, {out['declines']} declines; D's stop {stop_s:.3f} s")


BD_HEIGHTS = 3  # phase 14: heights 1 .. 3 commit; the run stops at height 4's NEW_HEIGHT
BD_CHAIN = "chip-smoke-boundary"
BD_LOGGERS = NODE_LOGGERS + ("privval.client", "abci-server", "mempool", "state", "lite2",
                             "lite2.proxy", "rpc", "rpc.server", "metrics")
BD_ROUTES = (("status", "/status"), ("commit 2", "/commit?height=2"),
             ("commit 3", "/commit?height=3"), ("validators 3", "/validators?height=3"),
             ("block 3", "/block?height=3"), ("nope", "/nope"), ("status after", "/status"))


def signer_child(key_dir, laddr) -> int:
    """Phase 14's remote signer process: the port's SignerServer over the
    FilePV files in `key_dir` (made there when absent), dialing `laddr`
    until it answers; serves until the node closes the connection, then
    exits 0."""
    import asyncio

    sys.path.insert(0, HERE)
    from tendermint_tpu_torch.libs.log import setup
    from tendermint_tpu_torch.privval import FilePV, SignerServer

    setup()
    pv = FilePV.load_or_generate(os.path.join(key_dir, "priv_validator_key.json"),
                                 os.path.join(key_dir, "priv_validator_state.json"))

    async def run():
        server = SignerServer(laddr, pv, retries=int(CHILD_READY_S * 10), retry_interval=0.1)
        await server.start()
        print("signer connected", flush=True)
        try:
            await server._task
        finally:
            await server.stop()
        return 0

    return asyncio.run(run())


def bd_home(home, gen, ports):
    """Phase 14's node home: config.toml by save_config at the JAX defaults
    but p2p off, RPC, the app's socket, the signer's listener and /metrics
    on local ports, the signed-tx precheck with its journal, a mempool of
    10,000 as phase 10's and phase 15's timeout_propose; the genesis file.
    No FilePV: the key is the signer's."""
    from tendermint_tpu_torch.config import Config, save_config

    cfg = Config(home=home)
    cfg.base.chain_id = BD_CHAIN
    cfg.p2p.laddr = "none"
    cfg.rpc.laddr = f"tcp://127.0.0.1:{ports['rpc']}"
    cfg.base.proxy_app = f"tcp://127.0.0.1:{ports['app']}"
    cfg.base.priv_validator_laddr = f"tcp://127.0.0.1:{ports['signer']}"
    cfg.instrumentation.prometheus = True
    cfg.instrumentation.prometheus_listen_addr = f"tcp://127.0.0.1:{ports['metrics']}"
    cfg.mempool.sig_precheck = True
    cfg.mempool.wal_dir = "data/mempool.wal"
    cfg.mempool.size = ABCI_MEMPOOL
    # the peers' proposals are built once the node is at PROPOSE, after the
    # height's burst: on a slow host that took longer than the default 3 s
    # (the node prevoted nil at height 2), as phase 15 found first
    cfg.consensus.timeout_propose = GR_TIMEOUT_PROPOSE
    cfg.ensure_dirs()
    path = os.path.join(home, "config", "config.toml")
    save_config(cfg, path)
    gen.save_as(cfg.genesis_file())
    return path


async def http_get(addr, path):
    """One GET over a fresh connection: status, content type, body, ms."""
    import asyncio

    from tendermint_tpu_torch.rpc.http import read_response

    host, port = addr.split("://", 1)[-1].rsplit(":", 1)
    t0 = time.perf_counter()
    reader, writer = await asyncio.open_connection(host, int(port))
    try:
        writer.write(f"GET {path} HTTP/1.1\r\nHost: {host}\r\nConnection: close\r\n\r\n"
                     .encode())
        await writer.drain()
        status, headers, body = await read_response(reader)
    finally:
        writer.close()
    return status, headers.get("content-type", ""), body, _ms(t0)


def phase_boundary(keys, card, dev, inproc_light=False):
    """One validator of the 10,000-validator chain across its process
    boundaries (see the module docstring, 14).  `inproc_light` runs the
    light proxy in this process (the CPU rehearsal: `light` needs a card).
    Returns the launches' denominators and the stages' launches."""
    import asyncio

    return asyncio.run(boundary_run(keys, card, dev, inproc_light))


async def boundary_run(keys, card, dev, inproc_light):
    import asyncio
    import json
    import signal
    import tempfile
    import threading

    from tendermint_tpu_torch.abci.client import SocketClient
    from tendermint_tpu_torch.config import load_config
    from tendermint_tpu_torch.crypto import batch as batch_hook
    from tendermint_tpu_torch.mempool import MempoolError
    from tendermint_tpu_torch.node import default_new_node
    from tendermint_tpu_torch.privval import FilePV, FilePVKey, FilePVLastSignState, SignerClient
    from tendermint_tpu_torch.state import make_genesis_state
    from tendermint_tpu_torch.types.block import BLOCK_ID_FLAG_COMMIT
    from tendermint_tpu_torch.types.genesis import GenesisDoc, GenesisValidator

    def since(c0):
        return {k: v - c0[k] for k, v in launch_counts().items()}

    t0 = time.perf_counter()
    # genesis now: `light` keeps its default trusting period of a week
    gen = GenesisDoc(BD_CHAIN, genesis_time_ns=time.time_ns(), validators=[
        GenesisValidator(k.pub_key().address(), k.pub_key(), 10) for k in keys])
    vals = make_genesis_state(gen).validators.copy()
    vals.increment_proposer_priority(CS_OURS_AT - 1)
    key_of = {k.pub_key().address(): k for k in keys}
    ours = key_of[vals.get_proposer().address]
    ours_addr = ours.pub_key().address()
    bursts, bad_txs, _ = abci_traffic(keys, [], top=BD_HEIGHTS)
    n = len(keys)
    log(f"  traffic: {BD_HEIGHTS} bursts of {ABCI_TXS} signed envelopes ({len(bad_txs)} "
        f"corrupted) made in {_ms(t0):.3f} ms; our validator {ours_addr.hex()[:12]} (round-0 "
        f"proposer of {CS_OURS_AT}) of {n}, its key in the signer process")

    tmp = tempfile.TemporaryDirectory(prefix="chip-smoke-boundary-")
    home, key_dir = os.path.join(tmp.name, "node"), os.path.join(tmp.name, "signer")
    os.makedirs(key_dir)
    FilePV(FilePVKey(ours_addr, ours.pub_key(), ours,
                     os.path.join(key_dir, "priv_validator_key.json")),
           FilePVLastSignState(file_path=os.path.join(key_dir, "priv_validator_state.json"))).save()
    ports = {k: free_port() for k in ("rpc", "app", "signer", "metrics", "light", "harness")}
    cfg_path = bd_home(home, gen, ports)
    app = Child("app", ["-m", "tendermint_tpu_torch.abci_cli", "--address",
                        f"tcp://127.0.0.1:{ports['app']}", "kvstore"], tmp.name)
    signer = Child("signer", ["-c", "import sys, chip_smoke; sys.exit(chip_smoke.signer_child("
                              f"{key_dir!r}, 'tcp://127.0.0.1:{ports['signer']}'))"], tmp.name)
    children = [app, signer]
    probe = NodeProbe()
    builds, per_h, proposals, out = [], {}, {}, {}
    sign_ms = collections.defaultdict(list)  # "vote" / "proposal" -> ms of each remote sign
    rt = collections.defaultdict(list)  # (height or "check_tx", kind) -> ms of each round trip
    cur = {"h": 0}
    stages, light_stop_ms = {}, None
    device = None if dev.type == "cuda" else dev  # the entry point's default is the card
    restore = [(SocketClient, "_request", SocketClient._request),
               (SignerClient, "sign_vote", SignerClient.sign_vote),
               (SignerClient, "sign_proposal", SignerClient.sign_proposal)]
    request, sign_vote, sign_proposal = (r[2] for r in restore)

    async def timed_request(client, kind, req):
        if kind == "begin_block":
            cur["h"] = req.header["height"]
        t = time.perf_counter()
        try:
            return await request(client, kind, req)
        finally:
            rt[("check_tx" if kind == "check_tx" else cur["h"], kind)].append(_ms(t))

    async def timed_vote(client, chain_id, vote):
        t = time.perf_counter()
        await sign_vote(client, chain_id, vote)
        sign_ms["vote"].append(_ms(t))

    async def timed_proposal(client, chain_id, prop):
        t = time.perf_counter()
        await sign_proposal(client, chain_id, prop)
        sign_ms["proposal"].append(_ms(t))

    SocketClient._request = timed_request
    SignerClient.sign_vote, SignerClient.sign_proposal = timed_vote, timed_proposal
    start_t = StepTimer()
    restore += [(SignerClient, "on_start", start_t.wrap(SignerClient, "on_start", "signer_wait")),
                (SocketClient, "init_chain", start_t.wrap(SocketClient, "init_chain"))]

    async def burst(node, hb):
        """Height hb's envelopes through node.mempool.check_tx (verified on
        the engine, then over the app's socket), before its proposal."""
        txs = list(bursts[hb])
        k0 = len(rt[("check_tx", "check_tx")])
        res, ms = await check_burst(node.mempool, txs)
        for tx, (r, _) in zip(txs, res):
            if tx in bad_txs:
                if not (isinstance(r, MempoolError) and str(r) == "invalid tx signature"):
                    raise AssertionError(f"a corrupted envelope for {hb} gave {r!r}")
            elif isinstance(r, Exception) or r.code != 0:
                raise AssertionError(f"a valid tx for {hb} was rejected: {r!r}")
        lat = [lat for _, lat in res]
        sock = rt[("check_tx", "check_tx")][k0:]
        per_h.setdefault(hb, {"lines": []})["lines"].append(
            f"burst of {len(res)} check_tx {ms:.3f} ms, p50 {percentile(lat, 50):.3f} p99 "
            f"{percentile(lat, 99):.3f} ms; {len(sock)} over the socket p50 "
            f"{percentile(sock, 50):.3f} p99 {percentile(sock, 99):.3f} ms")

    node = light = None
    try:
        with consensus_errors(BD_LOGGERS) as errors, table_timing(None, builds, dev):
            app_s = await app.start(ready="ABCI KVStoreApplication serving on")
            await signer.start()
            c0 = launch_counts()
            probe.start.reset()
            t = time.perf_counter()
            node = default_new_node(load_config(cfg_path), device=device)
            new_ms = _ms(t)
            probe.rec = node.flight_recorder
            t = time.perf_counter()
            await node.start()
            start_ms = _ms(t)
            stages["start"] = since(c0)
            c0 = launch_counts()
            bv = node.batch_verifier
            if bv.device.type != dev.type:
                raise AssertionError(f"the node's engine runs on {bv.device}, not {dev}")
            if (batch_hook.get_verifier() != bv.verify
                    or batch_hook.get_indexed_verifier() != node.table_cache.verify_indexed):
                raise AssertionError("the installed hooks are not the node's engine")
            if not isinstance(node.priv_validator, SignerClient):
                raise AssertionError("the node does not sign through the remote signer")
            if not all(isinstance(c, SocketClient) for c in (
                    node.proxy_app.consensus(), node.proxy_app.mempool(), node.proxy_app.query())):
                raise AssertionError("the node's app connections are not ABCI sockets")
            if node.priv_validator.get_pub_key().bytes() != ours.pub_key().bytes():
                raise AssertionError("the signer serves another key")
            sm = probe.start.ms
            out["start"] = (
                f"app server ready in {app_s:.3f} s; default_new_node (stores, state, "
                f"SignerClient) {new_ms:.3f} ms; start {start_ms:.3f} ms: engine (install "
                f"{sm.get('install', 0.0):.3f} ms + lane start {sm.get('lane_start', 0.0):.3f} "
                f"ms), the signer's connect wait and pubkey {start_t.ms['signer_wait']:.3f} ms, "
                f"handshake {sm.get('handshake', 0.0):.3f} ms (InitChain of {n} validators over "
                f"the socket {start_t.ms['init_chain']:.3f} ms), consensus start "
                f"{sm.get('consensus_start', 0.0):.3f} ms")
            v = probe.views[-1]
            await burst(node, 1)
            seq0 = next_seq(node.flight_recorder)
            t_heights = time.perf_counter()
            node, v, sign_s, frames_ok = await drive_heights(
                node, v, BD_HEIGHTS, key_of, ours_addr, burst, per_h, proposals, card,
                chain_id=BD_CHAIN)
            heights_s = time.perf_counter() - t_heights
            if v.cs._delivery_task is not None:  # the last block's pipelined apply
                await asyncio.wait({v.cs._delivery_task})
            stages["heights"] = since(c0)
            c0 = launch_counts()

            # -- with the node up: light, /metrics, abci_cli, the harness --------
            rpc_addr = node.rpc_server.listen_addr
            trust = node.block_store.load_block(1).hash()
            t = time.perf_counter()
            if inproc_light:
                from tendermint_tpu_torch.lite2 import BISECTION, Client, HTTPProvider, TrustOptions
                from tendermint_tpu_torch.lite2.proxy import LightProxy

                primary = HTTPProvider(BD_CHAIN, rpc_addr)
                light = LightProxy(Client(BD_CHAIN, TrustOptions(168 * 3600 * SEC, 1, trust),
                                          primary, mode=BISECTION),
                                   f"tcp://127.0.0.1:{ports['light']}")
                await light.start()
            else:
                light = Child("light", [
                    "-m", "tendermint_tpu_torch", "light", "--chain-id", BD_CHAIN, "--primary",
                    rpc_addr, "--laddr", f"tcp://127.0.0.1:{ports['light']}", "--height", "1",
                    "--hash", trust.hex()], tmp.name)
                children.append(light)
                await light.start()
                await light.wait_log("light proxy listening")
            light_s = time.perf_counter() - t
            light_addr = f"127.0.0.1:{ports['light']}"
            served, direct = {}, {}
            # /status again last: what light trusts after verifying 2 and 3
            for name, route in BD_ROUTES:
                served[name] = await http_get(light_addr, route)
            for route in ("/commit?height=2", "/commit?height=3", "/block?height=3"):
                direct[route] = await http_get(rpc_addr, route)
            pages = []
            for page in range(1, (n + 99) // 100 + 1):
                st_, _, body, _ = await http_get(rpc_addr,
                                                 f"/validators?height=3&page={page}&per_page=100")
                pages += json.loads(body)["result"]["validators"]
            metrics = await http_get(node.metrics_server.bound_addr, "/metrics")
            stages["light"] = since(c0)
            c0 = launch_counts()
            cli = {}
            info = Child("abci-info", ["-m", "tendermint_tpu_torch.abci_cli", "--address",
                                       f"tcp://127.0.0.1:{ports['app']}", "info"], tmp.name)
            key_tx = next(tx for tx in bursts[2] if tx not in bad_txs and b"\n" not in tx
                          and b"\r" not in tx)
            key, value = key_tx.split(b"=", 1)
            query = Child("abci-query", ["-m", "tendermint_tpu_torch.abci_cli", "--address",
                                         f"tcp://127.0.0.1:{ports['app']}", "query",
                                         "0x" + key.hex()], tmp.name)
            for ch in (info, query):
                t = time.perf_counter()
                await ch.start()
                cli[ch.name] = (await ch.finish(), ch.out, _ms(t))
            cli["value"] = value.decode(errors="replace")
            harness = Child("harness", ["-m", "tendermint_tpu_torch.tools.signer_harness",
                                        "--laddr", f"tcp://127.0.0.1:{ports['harness']}"],
                            tmp.name)
            fresh = os.path.join(tmp.name, "fresh-signer")
            os.makedirs(fresh)
            signer2 = Child("signer2", ["-c", "import sys, chip_smoke; sys.exit(chip_smoke."
                                        f"signer_child({fresh!r}, "
                                        f"'tcp://127.0.0.1:{ports['harness']}'))"], tmp.name)
            children += [harness, signer2]
            t = time.perf_counter()
            await harness.start()
            await signer2.start()
            cli["harness"] = (await harness.finish(timeout=CHILD_READY_S), harness.out, _ms(t))
            cli["signer2"] = (await signer2.finish(), signer2.out, 0.0)
            stages["after"] = since(c0)

            # -- stop ----------------------------------------------------------------
            t = time.perf_counter()
            await node.stop()
            stop_ms = _ms(t)
            if (batch_hook.get_verifier() is not batch_hook.host_batch_verify
                    or batch_hook.get_indexed_verifier() is not None):
                raise AssertionError("the node's hooks are still installed after its stop")
            if node.priv_validator.is_running:
                raise AssertionError("the node's SignerClient is still running after its stop")
            rcs = {"signer": await signer.finish()}
            if inproc_light:
                await light.stop()
                await primary.close()
            else:
                t = time.perf_counter()
                rcs["light"] = await light.finish(signal.SIGTERM)
                light_stop_ms = _ms(t)
            rcs["app"] = await app.finish(signal.SIGINT)
            out.update(bd_check(node, per_h, proposals, bursts, bad_txs, ours, errors, served,
                                direct, pages, metrics, cli, rcs, children,
                                None if inproc_light else light.read_log(),
                                BLOCK_ID_FLAG_COMMIT, probe))
        out.update(frames=frames_ok, stages=stages)
        bd_report(node, per_h, out, rt, sign_ms, served, metrics, cli, rcs, builds, seq0,
                  heights_s, sign_s, light_s, (stop_ms, light_stop_ms), dev, card)
        return out
    finally:
        for obj, attr, fn in reversed(restore):
            setattr(obj, attr, fn)
        probe.close()
        if node is not None and node.is_running:
            await node.stop()
        if inproc_light and light is not None:
            await light.stop()
        for ch in children:
            if ch.proc is not None and ch.rc is None:
                await ch.finish(signal.SIGKILL, timeout=10)
        for th in threading.enumerate():  # the engine's background builds and probe
            if th.name in ("table-build", "table-rebuild", "bv-rtt-probe", "bv-warmup"):
                th.join()
        tmp.cleanup()


def bd_check(node, per_h, proposals, bursts, bad_txs, ours, errors, served, direct, pages,
             metrics, cli, rcs, children, light_log, flag_commit, probe):
    """Phase 14's outcome (see the module docstring, 14).  Returns the
    counts main() holds the launches to."""
    import json

    from tendermint_tpu_torch.libs.metrics import MetricsServer

    n = node.state.validators.size()
    ours_addr, pub = ours.pub_key().address(), ours.pub_key()
    for h in range(1, BD_HEIGHTS + 1):
        block, seen = node.block_store.load_block(h), node.block_store.load_seen_commit(h)
        if block is None or seen is None or seen.round != 0:
            raise AssertionError(f"height {h} did not commit in round 0")
        if block.hash() != proposals[h].block_id.hash:
            raise AssertionError(f"block {h} is not the proposal made for it")
        if set(block.txs) != {tx for tx in bursts[h] if tx not in bad_txs}:
            raise AssertionError(f"block {h} does not hold exactly its burst's valid txs")
        if h > 1:
            signed = sum(cs.block_id_flag == flag_commit for cs in block.last_commit.signatures)
            if signed != per_h[h - 1]["last_commit"] or 3 * signed <= 2 * n:
                raise AssertionError(f"block {h}'s LastCommit has {signed} signatures, not "
                                     f"what the node held, or not more than 2/3 of {n}")
    if node.block_store.load_block(CS_OURS_AT).header.proposer_address != ours_addr:
        raise AssertionError(f"height {CS_OURS_AT} was not proposed by our validator")
    prop = proposals[CS_OURS_AT]
    if not pub.verify(prop.sign_bytes(BD_CHAIN), prop.signature):
        raise AssertionError("our proposal's signature does not verify under the validator key")
    # our precommits in the LastCommits of blocks 2-3 and block 3's seen commit
    idx, _ = node.state.validators.get_by_address(ours_addr)
    for h, commit in [(h, node.block_store.load_block(h + 1).last_commit)
                      for h in range(1, BD_HEIGHTS)] + [
            (BD_HEIGHTS, node.block_store.load_seen_commit(BD_HEIGHTS))]:
        sig = commit.signatures[idx]
        if sig.validator_address != ours_addr or not pub.verify(
                commit.vote_sign_bytes(BD_CHAIN, idx), sig.signature):
            raise AssertionError(f"our precommit for height {h} does not verify")
    for h in range(1, BD_HEIGHTS + 1):
        if per_h[h]["last_commit"] + per_h[h]["late"] != n:
            raise AssertionError(f"height {h}'s precommits did not all land or get refused late")
    state = node.state_store.load()
    # the app process, through abci_cli
    rc, text, _ = cli["abci-info"]
    want = ["-> last_block_height: 3", f"-> last_block_app_hash: 0x{state.app_hash.hex().upper()}"]
    if rc != 0 or text.splitlines()[-2:] != want:
        raise AssertionError(f"abci_cli info gave {rc}: {text!r}, not {want}")
    rc, text, _ = cli["abci-query"]
    if rc != 0 or cli_value(text) != cli["value"]:
        raise AssertionError(f"abci_cli query gave {rc}: {text!r}, not the value "
                             f"{cli['value']!r}")
    # what light served is the node's own
    res = {r: json.loads(s[2]) for r, s in served.items()}
    if any(served[r][0] != 200 for r in served):
        raise AssertionError(f"light answered {[(r, s[0]) for r, s in served.items()]}")
    for name, route in (("commit 2", "/commit?height=2"), ("commit 3", "/commit?height=3")):
        if (res[name]["result"]["signed_header"]
                != json.loads(direct[route][2])["result"]["signed_header"]):
            raise AssertionError(f"light's {route} is not the node's signed header")
    if res["block 3"]["result"] != json.loads(direct["/block?height=3"][2])["result"]:
        raise AssertionError("light's block 3 is not the node's")
    got = res["validators 3"]["result"]

    def no_priority(vs):
        return [{k: x for k, x in v.items() if k != "proposer_priority"} for v in vs]

    if ((got["block_height"], got["total"]) != (3, n)
            or no_priority(got["validators"]) != no_priority(pages)):
        raise AssertionError("light's validator set at 3 is not the node's")
    status = res["status after"]["result"]
    if status["chain_id"] != BD_CHAIN or status["latest_trusted_height"] < 3:
        raise AssertionError(f"light's status is {status}")
    if res["nope"] != {"jsonrpc": "2.0", "id": -1,
                       "error": {"code": -32602, "message": "unknown route nope"}}:
        raise AssertionError(f"light's unknown route gave {res['nope']}")
    light_account = None
    if light_log is not None:
        engine = [ln for ln in light_log.splitlines() if "verify engine device=" in ln]
        if not engine or "device=cuda" not in engine[0]:
            raise AssertionError(f"light's engine line is {engine}")
        light_account = engine_account_of(light_log)
        launches, paths = light_account["launches"], light_account["paths"]
        if (not paths or set(paths) & {"host", "host-cold"} or not sum(launches.values())
                or not launches["ed25519_window_tables"]):
            raise AssertionError(f"light's checks did not all run on the card: {light_account}")
    # /metrics: the JAX content type, the node's height and its engine's counters
    status_, ctype, body, _ = metrics
    if (status_, ctype) != (200, MetricsServer.CONTENT_TYPE):
        raise AssertionError(f"/metrics answered {status_} {ctype!r}")
    series = metric_values(body.decode(), BD_CHAIN)
    table = [e["hit"] for e in node.flight_recorder.events(kinds=["verify.table"])]
    got = (series.get("tendermint_consensus_height"),
           series.get("tendermint_verify_table_cache_hits_total"),
           series.get("tendermint_verify_table_cache_misses_total"))
    if got != (float(BD_HEIGHTS), float(sum(table)), float(len(table) - sum(table))):
        raise AssertionError(f"/metrics says height, table hits, misses {got}, the node "
                             f"{BD_HEIGHTS}, {sum(table)}, {len(table) - sum(table)}")
    rc, text, _ = cli["harness"]
    if rc != 0 or [ln.split(" ")[:2] for ln in text.splitlines()] != [
            ["PASS", c] for c in ("PubKey", "SignProposal", "SignVote", "DoubleSign")]:
        raise AssertionError(f"the signer harness gave {rc}: {text!r}")
    bad_rcs = {k: v for k, v in rcs.items() if v != 0}
    if bad_rcs or cli["signer2"][0] != 0:
        raise AssertionError(f"children exited {bad_rcs} (second signer {cli['signer2'][0]})")
    if errors:
        raise AssertionError(f"the node logged errors: {errors[:3]}")
    for ch in children:
        if ch.errors():
            raise AssertionError(f"{ch.name} logged errors: {ch.errors()[:3]}")
    checks = []
    for h, rec, s0, s1 in probe.vb:
        if h < 2:
            continue
        table = [e["hit"] for e in rec.events(since=s0, kinds=["verify.table"]) if e["seq"] < s1]
        if len(table) != 1:
            raise AssertionError(f"a validate_block at height {h} made {len(table)} table "
                                 "lookups, not 1")
        checks.append((h, table[0]))
    log("  validate_block on heights >= 2 (height, table hit): " + ", ".join(
        f"({h}, {hit})" for h, hit in checks))
    if checks[0] != (2, False):
        raise AssertionError("the genesis set's first commit check was not declined")
    declines = sum(1 for _, hit in checks if not hit)
    return {"validate_blocks": len(checks), "hits": len(checks) - declines,
            "declines": declines, "light": light_account}


def engine_account_of(log_text) -> dict:
    """The `verify engine account` line a `light` process logs at exit
    (cli.engine_account): launches, dispatch paths and table lookups."""
    import json
    import re

    lines = [ln for ln in log_text.splitlines() if "verify engine account " in ln]
    if not lines:
        raise AssertionError("light logged no engine account at its exit")
    return {k: json.loads(v) for k, v in re.findall(r"(\w+)=(\{\S*\})", lines[-1])}


def cli_value(text) -> str:
    """The `-> value: ` line's value in abci_cli's output ('' if none)."""
    for ln in text.splitlines():
        if ln.startswith("-> value: "):
            return ln[len("-> value: "):]
    return ""


def metric_values(text, chain_id) -> dict:
    """Each unlabelled-but-chain_id series of an exposition: name -> value."""
    out = {}
    tag = f'{{chain_id="{chain_id}"}}'
    for ln in text.splitlines():
        if not ln.startswith("#") and tag in ln:
            name, _, value = ln.partition(tag)
            out[name] = float(value)
    return out


def bd_report(node, per_h, out, rt, sign_ms, served, metrics, cli, rcs, builds, seq0,
              heights_s, sign_s, light_s, stops, dev, card):
    """Per height and for the phase (see the module docstring, 14)."""
    log(f"  {out['start']} ({card})")
    for h in range(1, BD_HEIGHTS + 1):
        st = per_h[h]
        kinds = []
        for kind in ("begin_block", "deliver_tx", "end_block", "commit"):
            ms = rt.get((h, kind), [])
            kinds.append(f"{kind} x{len(ms)} {sum(ms):.3f} ms" + (
                f" (p50 {percentile(ms, 50):.3f} p99 {percentile(ms, 99):.3f})"
                if len(ms) > 1 else ""))
        log(f"    height {h}: " + "; ".join(st["lines"]) + f"; LastCommit {st['last_commit']} "
            f"of {st['last_commit'] + st['late']} precommits, {st['late']} refused as late")
        log(f"    height {h}: ABCI socket round trips " + ", ".join(kinds) + f" ({card})")
    for kind in ("proposal", "vote"):
        ms = sign_ms.get(kind, [])
        log(f"  remote signer: {len(ms)} {kind}(s), p50 {percentile(ms, 50) if ms else 0:.3f} "
            f"max {max(ms, default=0.0):.3f} ms ({card})")
    for b in builds:
        log(f"    table of {b['validators']} validators on {b['thread']}: host rows "
            f"{b['rows_ms']:.3f} ms, window tables (kernel 2) "
            + (f"{b['build_ms']:.3f} ms" if b["build_ms"] is not None else "not built")
            + f" ({card})")
    d = node.flight_recorder.events(since=seq0, kinds=["verify.dispatch"])
    log(f"  heights 1-{BD_HEIGHTS}: {heights_s * 1000:.3f} ms = {BD_HEIGHTS / heights_s:.3f} "
        f"heights/s (signing and framing the peers' votes {sign_s * 1000:.3f} ms of it); "
        f"{len(d)} dispatches; {card_memory(dev, node.table_cache)} ({card})")
    log(f"  light: up in {light_s:.3f} s (its trust root's set paged from the node and "
        f"verified); " + ", ".join(f"{r} {s[0]} {len(s[2])} B {s[3]:.3f} ms"
                                   for r, s in served.items()) + f" ({card})")
    log(f"  /metrics: {len(metrics[2])} B in {metrics[3]:.3f} ms; abci_cli info "
        f"{cli['abci-info'][2]:.3f} ms, query {cli['abci-query'][2]:.3f} ms (each a process); "
        f"signer harness {cli['harness'][2]:.3f} ms: "
        + "; ".join(cli["harness"][1].splitlines()) + f" ({card})")
    node_ms, light_ms = stops
    log(f"  stop: node {node_ms:.3f} ms" + (f", light {light_ms:.3f} ms from its SIGTERM"
                                             if light_ms is not None else "")
        + f"; exit codes {rcs}")
    log(f"  launches by stage: {out['stages']}")


GR_HEIGHTS = 4  # phase 15: heights 1 .. 4 commit; the run stops at height 5's NEW_HEIGHT
GR_OURS_AT = 2  # our validator is this height's round-0 proposer
GR_BROADCAST_AT = 4  # (b)'s txs go out before this height's proposal, after the firehose's
                     # backlog went into the block before it
GR_CHAIN = "chip-smoke-grpc"
GR_RATE = 1000  # tm-bench's default -r (tx/s offered, all connections)
GR_TX_BYTES = 250  # tm-bench's default -s
GR_CONNECTIONS = 8  # loadgen's own default (tm-bench's is 1)
GR_LOAD_S = 20.0  # loadgen's --duration: heights 1-2 (19.8-21.4 s at 10k on the H100)
GR_FIRST = 200  # height 1's proposal waits for this many of loadgen's txs in the mempool
GR_BROADCAST = 8  # BroadcastTx txs with keys of their own, plus one with a flipped signature byte
GR_MIN_DEVICE_BATCH = 1  # [tpu] min_device_batch: every signed-tx flush verifies on the card
GR_TIMEOUT_PROPOSE = 30.0  # s: the peers' proposals come after the node's apply (see gr_home)
GR_LOGGERS = NODE_LOGGERS + ("abci-grpc", "http2", "mempool", "state", "rpc", "rpc.server",
                             "rpc.grpc")


def gr_home(home, gen, ours, ports):
    """Phase 15's node home: config.toml by save_config at the JAX defaults
    but p2p off, the app over gRPC (`abci = "grpc"`), RPC and the
    BroadcastAPI on local ports, the signed-tx precheck and a mempool of
    10,000 as phase 8's, and `[tpu] min_device_batch = GR_MIN_DEVICE_BATCH`
    (1: the signed-tx lane's flushes of a few txs verify on the card, where
    the JAX default of 16 sends them to the host), and `timeout_propose =
    GR_TIMEOUT_PROPOSE`: a peer's proposal is built from the node's own
    state once it has applied the previous block (cs_build), and the
    firehose's block takes longer to apply over gRPC (~5,000 DeliverTx)
    than the default 3 s; a flight recorder that holds the whole phase's
    events; our validator's FilePV; the genesis file."""
    from tendermint_tpu_torch.config import Config, save_config
    from tendermint_tpu_torch.privval import FilePV, FilePVKey, FilePVLastSignState

    cfg = Config(home=home)
    cfg.base.chain_id = GR_CHAIN
    cfg.base.abci = "grpc"
    cfg.base.proxy_app = f"tcp://127.0.0.1:{ports['app']}"
    cfg.p2p.laddr = "none"
    cfg.rpc.laddr = f"tcp://127.0.0.1:{ports['rpc']}"
    cfg.rpc.grpc_laddr = f"tcp://127.0.0.1:{ports['grpc']}"
    cfg.mempool.sig_precheck = True
    cfg.mempool.size = ABCI_MEMPOOL
    cfg.tpu.min_device_batch = GR_MIN_DEVICE_BATCH
    cfg.consensus.timeout_propose = GR_TIMEOUT_PROPOSE
    cfg.instrumentation.flight_recorder_size = 1 << 17  # the phase counts every flush in it
    cfg.ensure_dirs()
    FilePV(FilePVKey(ours.pub_key().address(), ours.pub_key(), ours,
                     cfg.priv_validator_key_file()),
           FilePVLastSignState(file_path=cfg.priv_validator_state_file())).save()
    path = os.path.join(home, "config", "config.toml")
    save_config(cfg, path)
    gen.save_as(cfg.genesis_file())
    return path


def loadgen_tx(tx):
    """(worker, seq) when `tx` is byte for byte the envelope loadgen sends
    as that worker's seq-th tx, else None."""
    import re

    from tendermint_tpu_torch.mempool import parse_signed_tx
    from tendermint_tpu_torch.tools.loadgen import make_tx, worker_key

    env = parse_signed_tx(tx)
    m = env and re.match(rb"ld(\d+)\.(\d+)=", env[3])
    if not m:
        return None
    w, seq = int(m.group(1)), int(m.group(2))
    if w >= GR_CONNECTIONS or make_tx(worker_key(w), w, seq, GR_TX_BYTES) != tx:
        return None
    return w, seq


def phase_grpc(keys, card, dev):
    """One validator of the 10,000-validator set fed from outside (see the
    module docstring, 15).  Returns the launches' denominators and the
    stages' launches."""
    import asyncio

    return asyncio.run(grpc_run(keys, card, dev))


async def grpc_run(keys, card, dev):
    import asyncio
    import signal
    import tempfile
    import threading

    from tendermint_tpu_torch.abci.grpc import GRPCClient
    from tendermint_tpu_torch.abci.types import CheckTxType
    from tendermint_tpu_torch.config import load_config
    from tendermint_tpu_torch.crypto import batch as batch_hook
    from tendermint_tpu_torch.crypto.keys import Ed25519PrivKey
    from tendermint_tpu_torch.mempool import SIGNED_TX_PREFIX, make_signed_tx
    from tendermint_tpu_torch.node import default_new_node
    from tendermint_tpu_torch.rpc.grpc import RpcError
    from tendermint_tpu_torch.rpc.grpc_api import BroadcastAPIClient
    from tendermint_tpu_torch.state import make_genesis_state
    from tendermint_tpu_torch.types.genesis import GenesisDoc, GenesisValidator
    from tendermint_tpu_torch.types.tx import tx_hash

    def since(c0):
        return {k: v - c0[k] for k, v in launch_counts().items()}

    gen = GenesisDoc(GR_CHAIN, genesis_time_ns=time.time_ns(), validators=[
        GenesisValidator(k.pub_key().address(), k.pub_key(), 10) for k in keys])
    vals = make_genesis_state(gen).validators.copy()
    vals.increment_proposer_priority(GR_OURS_AT - 1)
    key_of = {k.pub_key().address(): k for k in keys}
    ours = key_of[vals.get_proposer().address]
    ours_addr = ours.pub_key().address()
    btxs = [make_signed_tx(Ed25519PrivKey.from_secret(b"broadcast-%d" % i),
                           b"bcast%d=value-%d" % (i, i)) for i in range(GR_BROADCAST)]
    flipped = bytearray(make_signed_tx(Ed25519PrivKey.from_secret(b"broadcast-bad"),
                                       b"bcastbad=value"))
    flipped[len(SIGNED_TX_PREFIX) + 32 + 7] ^= 0x01  # a byte of the signature
    flipped = bytes(flipped)

    tmp = tempfile.TemporaryDirectory(prefix="chip-smoke-grpc-")
    ports = {k: free_port() for k in ("rpc", "grpc", "app")}
    app_addr = f"tcp://127.0.0.1:{ports['app']}"
    cfg_path = gr_home(os.path.join(tmp.name, "node"), gen, ours, ports)
    app = Child("app", ["-m", "tendermint_tpu_torch.abci_cli", "--abci", "grpc", "--address",
                        app_addr, "kvstore"], tmp.name)
    children = [app]
    probe = NodeProbe()
    builds, per_h, proposals, out, stages = [], {}, {}, {}, {}
    rt = collections.defaultdict(list)  # (height or "check_tx", kind) -> ms of each gRPC call
    cur = {"h": 0}
    device = None if dev.type == "cuda" else dev  # the entry point's default is the card
    restore = [(GRPCClient, "_call", GRPCClient._call)]
    call = restore[0][2]

    async def timed_call(client, kind, req):
        if kind == "begin_block":
            cur["h"] = req.header["height"]
        t = time.perf_counter()
        try:
            return await call(client, kind, req)
        finally:
            if kind == "check_tx":
                rt[("check_tx", "recheck" if req.type == CheckTxType.RECHECK else "new")].append(
                    _ms(t))
            else:
                rt[(cur["h"], kind)].append(_ms(t))

    GRPCClient._call = timed_call
    start_t = StepTimer()
    restore.append((GRPCClient, "init_chain", start_t.wrap(GRPCClient, "init_chain")))
    client = BroadcastAPIClient(f"tcp://127.0.0.1:{ports['grpc']}")
    bcast, load = {"tasks": []}, {}

    async def one_broadcast(tx):
        t = time.perf_counter()
        try:
            res = await client.broadcast_tx(tx)
        except RpcError as e:
            res = e
        return res, _ms(t)

    async def burst(node, hb):
        """drive_heights' hook after our precommit of hb - 1: before the
        height ahead of GR_BROADCAST_AT, wait for the firehose's end
        (loadgen's exit), so that height's block takes all its backlog."""
        if hb == GR_BROADCAST_AT - 1:
            load["rc"] = await load["child"].finish(timeout=GR_LOAD_S + CHILD_READY_S)
            load["s"] = time.perf_counter() - load["t0"]

    async def before_propose(h, node, v):
        """(b): at GR_BROADCAST_AT's PROPOSE, once the previous block (the
        firehose's backlog) is applied and before the proposal, so the
        pool is empty, Ping, then BroadcastTx of the 8
        and of the flipped envelope, each awaited in a task of its own;
        returns once the 8 are in the mempool and the flipped one was
        refused."""
        if h != GR_BROADCAST_AT:
            return
        if v.cs._delivery_task is not None:
            await asyncio.wait({v.cs._delivery_task})
        t = time.perf_counter()
        out["ping"] = (await client.ping(), _ms(t))
        t = time.perf_counter()
        bcast["pool_at_send"] = node.mempool.size()
        bcast["tasks"] = [asyncio.ensure_future(one_broadcast(tx)) for tx in btxs + [flipped]]
        want = {tx_hash(tx) for tx in btxs}

        async def in_pool():
            return want <= set(node.mempool.txs) and bcast["tasks"][-1].done()

        await until(in_pool, "the BroadcastTx txs in the mempool", CHILD_READY_S)
        bcast["in_pool_ms"] = _ms(t)

    node = None
    try:
        with consensus_errors(GR_LOGGERS) as errors, table_timing(None, builds, dev):
            app_s = await app.start(ready="ABCI KVStoreApplication serving on")
            c0 = launch_counts()
            probe.start.reset()
            t = time.perf_counter()
            node = default_new_node(load_config(cfg_path), device=device)
            new_ms = _ms(t)
            probe.rec = node.flight_recorder
            t = time.perf_counter()
            await node.start()
            start_ms = _ms(t)
            stages["start"] = since(c0)
            c0 = launch_counts()
            seq0 = next_seq(node.flight_recorder)
            bv = node.batch_verifier
            if bv.device.type != dev.type:
                raise AssertionError(f"the node's engine runs on {bv.device}, not {dev}")
            if (batch_hook.get_verifier() != bv.verify
                    or batch_hook.get_indexed_verifier() != node.table_cache.verify_indexed):
                raise AssertionError("the installed hooks are not the node's engine")
            conns = {name: getattr(node.proxy_app, name)()
                     for name in ("consensus", "mempool", "query")}
            if not all(isinstance(c, GRPCClient) for c in conns.values()):
                raise AssertionError("the node's app connections are not ABCI gRPC clients")
            if node.grpc_server is None or not node.grpc_server.bound_addr:
                raise AssertionError("the node serves no BroadcastAPI")
            sm = probe.start.ms
            out["start"] = (
                f"app server (gRPC) ready in {app_s:.3f} s; default_new_node {new_ms:.3f} ms; "
                f"start {start_ms:.3f} ms: engine (install {sm.get('install', 0.0):.3f} ms + lane "
                f"start {sm.get('lane_start', 0.0):.3f} ms), handshake "
                f"{sm.get('handshake', 0.0):.3f} ms (InitChain of {len(keys)} validators over gRPC "
                f"{start_t.ms['init_chain']:.3f} ms), consensus start "
                f"{sm.get('consensus_start', 0.0):.3f} ms")
            v = probe.views[-1]
            await client.start()
            # (a) the firehose, in its own process
            rpc_addr = node.rpc_server.listen_addr
            loadgen = Child("loadgen", [
                "-m", "tendermint_tpu_torch.tools.loadgen", rpc_addr, "--connections",
                str(GR_CONNECTIONS), "--rate", str(GR_RATE), "--tx-bytes", str(GR_TX_BYTES),
                "--mode", "sync", "--duration", str(GR_LOAD_S), "--json"], tmp.name)
            children.append(loadgen)
            load.update(child=loadgen, t0=time.perf_counter())
            t = time.perf_counter()
            await loadgen.start()
            async def first_txs():
                if loadgen.proc.returncode is not None:
                    await loadgen.finish()
                    raise AssertionError(f"loadgen exited {loadgen.rc}: {loadgen.out[-2000:]} "
                                         f"{loadgen.read_log()[-3000:]}")
                return node.mempool.size() >= GR_FIRST

            await until(first_txs, f"{GR_FIRST} of loadgen's txs in the mempool", CHILD_READY_S)
            out["first_s"] = time.perf_counter() - t
            t_heights = time.perf_counter()
            node, v, sign_s, frames_ok = await drive_heights(
                node, v, GR_HEIGHTS, key_of, ours_addr, burst, per_h, proposals, card,
                chain_id=GR_CHAIN, before_propose=before_propose)
            heights_s = time.perf_counter() - t_heights
            if v.cs._delivery_task is not None:  # the last block's pipelined apply
                await asyncio.wait({v.cs._delivery_task})
            answers = await asyncio.gather(*bcast["tasks"])
            stages["heights"] = since(c0)
            c0 = launch_counts()
            rcs = {"loadgen": load["rc"]}
            load_line = loadgen.out.strip().splitlines()[-1] if loadgen.out.strip() else "{}"
            load_s = load["s"]
            pool = [m.tx for m in node.mempool.txs.values()]
            # (c) abci_cli over gRPC against the app
            cli = {}
            # the kvstore's key is the whole tx up to its first "=" (envelope included)
            key, value = next(tx.split(b"=", 1) for tx in btxs
                              if tx.split(b"=", 1)[1].startswith(b"value-"))
            for name, argv in (("abci-info", ["info"]), ("abci-query", ["query", "0x" + key.hex()])):
                ch = Child(name, ["-m", "tendermint_tpu_torch.abci_cli", "--abci", "grpc",
                                  "--address", app_addr] + argv, tmp.name)
                children.append(ch)
                t = time.perf_counter()
                await ch.start()
                cli[name] = (await ch.finish(), ch.out, _ms(t))
            cli["value"] = value.decode()
            h2 = {f"proxy {name}": c.channel.stats() for name, c in conns.items()}
            h2["broadcast client"] = client.channel.stats()
            h2["broadcast server"] = [c.stats() for c in node.grpc_server.server.connections]
            await client.stop()
            stages["after"] = since(c0)
            if node.flight_recorder.dropped:
                raise AssertionError("the flight recorder dropped events: the lane's counts "
                                     "would be short")
            lane = {"flushes": [e["batch"] for e in node.flight_recorder.events(
                since=seq0, kinds=["verify.flush"])],
                    "paths": collections.Counter(e["path"] for e in node.flight_recorder.events(
                        since=seq0, kinds=["verify.dispatch"]))}
            t = time.perf_counter()
            await node.stop()
            stop_ms = _ms(t)
            if (batch_hook.get_verifier() is not batch_hook.host_batch_verify
                    or batch_hook.get_indexed_verifier() is not None):
                raise AssertionError("the node's hooks are still installed after its stop")
            rcs["app"] = await app.finish(signal.SIGINT)
            out.update(frames=frames_ok, stages=stages)
            vb_ms = {k[1]: round(ms, 3) for k, ms in probe.timer.ms.items()
                     if isinstance(k, tuple) and k[0] == "validate_block"}
            try:
                out.update(gr_check(node, per_h, proposals, btxs, flipped, answers, load_line,
                                    pool, cli, rcs, children, errors, lane, out["ping"][0],
                                    probe))
            finally:  # the numbers, also of a run whose checks failed
                gr_report(node, per_h, out, rt, answers, bcast, load_line, pool, cli, h2, lane,
                          builds, vb_ms, heights_s, sign_s, load_s, stop_ms, dev, card)
        return out
    finally:
        for obj, attr, fn in reversed(restore):
            setattr(obj, attr, fn)
        probe.close()
        if client.is_running:
            await client.stop()
        if node is not None and node.is_running:
            await node.stop()
        for ch in children:
            if ch.proc is not None and ch.rc is None:
                await ch.finish(signal.SIGKILL, timeout=10)
        for th in threading.enumerate():  # the engine's background builds and probe
            if th.name in ("table-build", "table-rebuild", "bv-rtt-probe", "bv-warmup"):
                th.join()
        tmp.cleanup()


def gr_check(node, per_h, proposals, btxs, flipped, answers, load_line, pool, cli, rcs,
             children, errors, lane, ping, probe):
    """Phase 15's outcome (see the module docstring, 15).  Returns the
    counts main() holds the launches to."""
    import json

    from tendermint_tpu_torch.rpc.grpc import RpcError, StatusCode
    from tendermint_tpu_torch.types.block import BLOCK_ID_FLAG_COMMIT

    n = node.state.validators.size()
    b_in, a_in = set(), 0
    for h in range(1, GR_HEIGHTS + 1):
        block, seen = node.block_store.load_block(h), node.block_store.load_seen_commit(h)
        if block is None or seen is None or seen.round != 0:
            raise AssertionError(f"height {h} did not commit in round 0")
        if block.hash() != proposals[h].block_id.hash:
            raise AssertionError(f"block {h} is not the proposal made for it")
        for tx in block.txs:
            if tx in btxs:
                b_in.add(tx)
            elif loadgen_tx(tx) is not None:
                a_in += 1
            else:
                raise AssertionError(f"block {h} holds a tx neither loadgen nor BroadcastTx sent: "
                                     f"{tx[:48]!r}")
        if h > 1:
            signed = sum(cs.block_id_flag == BLOCK_ID_FLAG_COMMIT
                         for cs in block.last_commit.signatures)
            if signed != per_h[h - 1]["last_commit"] or 3 * signed <= 2 * n:
                raise AssertionError(f"block {h}'s LastCommit has {signed} signatures, not what "
                                     f"the node held, or not more than 2/3 of {n}")
    ours_addr = node.priv_validator.address()
    if node.block_store.load_block(GR_OURS_AT).header.proposer_address != ours_addr:
        raise AssertionError(f"height {GR_OURS_AT} was not proposed by our validator")
    if b_in != set(btxs):
        raise AssertionError(f"{len(b_in)} of the {len(btxs)} BroadcastTx txs are in blocks "
                             f"1-{GR_HEIGHTS}")
    for h in range(1, GR_HEIGHTS + 1):
        if per_h[h]["last_commit"] + per_h[h]["late"] != n:
            raise AssertionError(f"height {h}'s precommits did not all land or get refused late")
    # (a): loadgen's split against the chain and the mempool
    load = json.loads(load_line)
    a_pool = sum(1 for tx in pool if loadgen_tx(tx) is not None)
    if load.get("transport_errors") != 0 or load.get("rejected") != 0:
        raise AssertionError(f"loadgen had transport errors or rejections: {load_line}")
    if load.get("accepted") != a_in + a_pool:
        raise AssertionError(f"loadgen's accepted {load.get('accepted')} is not its txs in blocks "
                             f"1-{GR_HEIGHTS} ({a_in}) plus those in the mempool ({a_pool})")
    # (b): the BroadcastAPI
    if ping != {}:
        raise AssertionError(f"Ping answered {ping!r}")
    for tx, (res, _) in zip(btxs, answers):
        if not isinstance(res, dict) or res["check_tx"]["code"] != 0 \
                or res["deliver_tx"]["code"] != 0:
            raise AssertionError(f"BroadcastTx of a valid tx answered {res!r}")
    res = answers[-1][0]
    if not (isinstance(res, RpcError) and res.code() == StatusCode.UNKNOWN
            and "invalid tx signature" in res.details()):
        raise AssertionError(f"BroadcastTx of the flipped envelope answered {res!r}")
    if any(flipped in node.block_store.load_block(h).txs for h in range(1, GR_HEIGHTS + 1)):
        raise AssertionError("the flipped envelope was committed")
    # (c): the app process over gRPC
    state = node.state_store.load()
    rc, text, _ = cli["abci-info"]
    want = [f"-> last_block_height: {GR_HEIGHTS}",
            f"-> last_block_app_hash: 0x{state.app_hash.hex().upper()}"]
    if rc != 0 or text.splitlines()[-2:] != want:
        raise AssertionError(f"abci_cli --abci grpc info gave {rc}: {text!r}, not {want}")
    rc, text, _ = cli["abci-query"]
    if rc != 0 or cli_value(text) != cli["value"]:
        raise AssertionError(f"abci_cli --abci grpc query gave {rc}: {text!r}, not the value "
                             f"{cli['value']!r}")
    bad_rcs = {k: v for k, v in rcs.items() if v != 0}
    bad_rcs.update({ch.name: ch.rc for ch in children if ch.rc != 0})
    if bad_rcs:
        raise AssertionError(f"children exited {bad_rcs}")
    if errors:
        raise AssertionError(f"the node logged errors: {errors[:3]}")
    for ch in children:
        if ch.errors():
            raise AssertionError(f"{ch.name} logged errors: {ch.errors()[:3]}")
    # the engine: every flat check on the card, the tables as in phase 14
    host = {"host-cold"} | ({"host"} if GR_MIN_DEVICE_BATCH <= 1 else set())
    if set(lane["paths"]) & host or not lane["flushes"]:
        raise AssertionError(f"the engine's dispatches {dict(lane['paths'])}, flushes "
                             f"{len(lane['flushes'])}: not every signed-tx flush on the card")
    checks = []
    for h, rec, s0, s1 in probe.vb:
        if h < 2:
            continue
        table = [e["hit"] for e in rec.events(since=s0, kinds=["verify.table"]) if e["seq"] < s1]
        if len(table) != 1:
            raise AssertionError(f"a validate_block at height {h} made {len(table)} table "
                                 "lookups, not 1")
        checks.append((h, table[0]))
    log("  validate_block on heights >= 2 (height, table hit): " + ", ".join(
        f"({h}, {hit})" for h, hit in checks))
    if not checks or checks[0] != (2, False):
        raise AssertionError("the genesis set's first commit check was not declined")
    declines = sum(1 for _, hit in checks if not hit)
    return {"validate_blocks": len(checks), "hits": len(checks) - declines,
            "declines": declines, "flushes": len(lane["flushes"]), "a_blocks": a_in,
            "a_pool": a_pool}


def gr_report(node, per_h, out, rt, answers, bcast, load_line, pool, cli, h2, lane, builds,
              vb_ms, heights_s, sign_s, load_s, stop_ms, dev, card):
    """Per height and for the phase (see the module docstring, 15)."""
    log(f"  {out['start']} ({card})")
    log(f"  {GR_FIRST} of loadgen's txs in the mempool {out['first_s']:.3f} s after its start; "
        f"Ping {out['ping'][1]:.3f} ms")
    for h in range(1, GR_HEIGHTS + 1):
        st = per_h[h]
        kinds = []
        for kind in ("begin_block", "deliver_tx", "end_block", "commit"):
            ms = rt.get((h, kind), [])
            kinds.append(f"{kind} x{len(ms)} {sum(ms):.3f} ms" + (
                f" (p50 {percentile(ms, 50):.3f} p99 {percentile(ms, 99):.3f})"
                if len(ms) > 1 else ""))
        vb = node.block_store.load_block(h)
        log(f"    height {h}: {len(vb.txs)} txs; " + "; ".join(st["lines"])
            + f"; LastCommit {st['last_commit']} of {st['last_commit'] + st['late']} precommits, "
            f"{st['late']} refused as late")
        log(f"    height {h}: ABCI gRPC round trips " + ", ".join(kinds) + f" ({card})")
    for k in ("new", "recheck"):
        ms = rt.get(("check_tx", k), [])
        log(f"  CheckTx ({k}) over gRPC: {len(ms)} calls"
            + (f", p50 {percentile(ms, 50):.3f} p99 {percentile(ms, 99):.3f} ms, sum "
               f"{sum(ms):.3f} ms" if ms else "") + f" ({card})")
    for b in builds:
        log(f"    table of {b['validators']} validators on {b['thread']}: host rows "
            f"{b['rows_ms']:.3f} ms, window tables (kernel 2) "
            + (f"{b['build_ms']:.3f} ms" if b["build_ms"] is not None else "not built")
            + f" ({card})")
    log(f"  heights 1-{GR_HEIGHTS}: {heights_s * 1000:.3f} ms = {GR_HEIGHTS / heights_s:.3f} "
        f"heights/s (signing and framing the peers' votes {sign_s * 1000:.3f} ms of it); "
        f"validate_block ms by height {vb_ms}; {card_memory(dev, node.table_cache)} ({card})")
    log(f"  loadgen ({load_s:.3f} s from its start to its exit): {load_line}")
    log(f"  {len(pool)} txs left in the mempool")
    ms = [m for _, m in answers]
    log(f"  BroadcastTx at height {GR_BROADCAST_AT}: {len(answers) - 1} valid txs and one "
        f"flipped; in the mempool (the "
        f"flipped refused) {bcast['in_pool_ms']:.3f} ms after the sends, with "
        f"{bcast['pool_at_send']} txs in the pool; round trips ms "
        + ", ".join(f"{m:.3f}" for m in ms[:-1]) + f"; commit wait after CheckTx p50 "
        f"{percentile(ms[:-1], 50) - bcast['in_pool_ms']:.3f} ms; the flipped one "
        f"{ms[-1]:.3f} ms: {answers[-1][0]!r} ({card})")
    for name, conns in h2.items():  # each a list of one connection's stats
        for conn in conns:
            log(f"  HTTP/2 {name}: frames in {conn['frames_in']}, out {conn['frames_out']}; "
                f"bytes in {conn['bytes_in']}, out {conn['bytes_out']}")
    fl = lane["flushes"]
    log(f"  signed-tx lane and vote frames: {len(fl)} verify.flush of {sum(fl)} txs (sizes "
        f"min {min(fl)} p50 {percentile(fl, 50):.0f} max {max(fl)}), dispatches by path "
        f"{dict(lane['paths'])}")
    log(f"  abci_cli --abci grpc: info {cli['abci-info'][2]:.3f} ms, query "
        f"{cli['abci-query'][2]:.3f} ms (each a process); node stop {stop_ms:.3f} ms")
    log(f"  launches by stage: {out['stages']}")


# Phase 17: the chaos rig (the JAX networks/local/chaos_smoke.py and disk_smoke.py)
CH_SCENARIO_A = "twin 0; partition 0,1|2,3 @2~0.5; heal @8~0.5; kill 2 @11; restart 2 @13"
CH_SCENARIO_B = ("rot 3 blockstore h=3 @2; disk 2 enospc @8~0.5; disk 2 heal @16; kill 2 @18; "
                 "restart 2 @20")
CH_SEED = 7  # --chaos-seed of both nets and the scenarios' seed
CH_ROT_HEIGHT = 3  # (b): the height whose stored block part rots on node 3
CH_RECOVERY_A_S = 30.0  # (a): heal and restart to the next commit, at most (chaos_smoke's bound)
CH_RECOVERY_B_S = 45.0  # (b): rot to refill and restart to rejoin, at most (disk_smoke's bound)
CH_BUDGET_S = 90.0  # after the last fault, for recovery and accountability (both rigs' budget)
CH_READY_S = 180.0  # the four node processes' start to their first commits, at most
CH_MIN_DEVICE_BATCH = 1  # [tpu] min_device_batch: every vote batch and commit goes to the card
CH_POLL_S = 0.4  # the rigs' scrape interval
CH_LAUNCH_PATHS = ("device", "indexed", "chunked", "tabulated")  # dispatches that launch a kernel


def ch_node_argv(home):
    """A phase 17 node's process: the port's CLI `node` on its home."""
    return ["-m", "tendermint_tpu_torch", "--home", home, "node"]


def ch_rpc(port, path, timeout=5.0):
    import urllib.request

    with urllib.request.urlopen(f"http://127.0.0.1:{port}/{path}", timeout=timeout) as r:
        return json.load(r)


def ch_call(port, method, **params):
    import urllib.parse

    qs = urllib.parse.urlencode({k: str(v) for k, v in params.items()})
    return ch_rpc(port, f"{method}?{qs}" if qs else method)


def ch_height(port):
    try:
        return int(ch_rpc(port, "status")["result"]["sync_info"]["latest_block_height"])
    except Exception:  # noqa: BLE001 — a node down or starting is not a fault here
        return None


def ch_health(port):
    try:
        return ch_rpc(port, "health")["result"]
    except Exception:  # noqa: BLE001
        return None


def ch_base_port(avoid=()):
    """A base port whose 4 x 10 ports are free now (testnet takes p2p at
    base + 10 i, RPC at + 1; the phase puts /metrics at + 2), 40 or more
    from each base in `avoid`, and below the kernel's ephemeral range:
    connections and binds to port 0 take their ports from that range, so a
    port there can be taken between this check and the node's bind (the
    card's machine starts it at 16000)."""
    import random
    import socket

    try:
        with open("/proc/sys/net/ipv4/ip_local_port_range") as f:
            ephemeral_lo = int(f.read().split()[0])
    except (OSError, ValueError, IndexError):
        ephemeral_lo = 32768
    hi = min(30000, ephemeral_lo) - 40
    lo = max(1024, hi - 10000)
    rng = random.Random()
    for _ in range(100):
        base = rng.randrange(lo, hi, 10)
        if any(abs(base - other) < 40 for other in avoid):
            continue
        try:
            for i in range(40):
                with socket.socket() as s:
                    s.bind(("127.0.0.1", base + i))
        except OSError:
            continue
        return base
    raise AssertionError("no free range of 40 local ports for phase 17")


class ChNet:
    """One 4-validator localnet of phase 17: homes by the port's `testnet
    --fast --db-backend sqlite --chaos`, the engine on at
    CH_MIN_DEVICE_BATCH and /metrics on, each node through the CLI in a
    process of its own (stdout and stderr in its home's node.log); polls
    each node's flight recorder (watermarked) for its kernel dispatches and
    gossip.hop events."""

    def __init__(self, root, part, twin, avoid=()):
        self.root, self.part, self.twin = root, part, twin
        self.base = ch_base_port(avoid)
        self.homes = [os.path.join(root, f"node{i}") for i in range(4)]
        self.rpc = [self.base + 10 * i + 1 for i in range(4)]
        self.metrics = [self.base + 10 * i + 2 for i in range(4)]
        self.procs = [None] * 4
        self.live = [False] * 4
        self.wm = [0] * 4
        self.dispatch = [collections.Counter() for _ in range(4)]
        self.lost = [0] * 4
        self.hops = self.clamps = 0
        self.last_poll = 0.0
        self.before_kill = {}  # node -> its chaos series read just before its SIGKILL

    def build(self):
        from tendermint_tpu_torch.config import load_config, save_config

        argv = [sys.executable, "-m", "tendermint_tpu_torch", "testnet", "--validators", "4",
                "--output", self.root, "--base-port", str(self.base), "--fast",
                "--db-backend", "sqlite", "--chaos", "--chaos-seed", str(CH_SEED)]
        if self.twin is not None:
            argv += ["--twin", str(self.twin)]
        res = subprocess.run(argv, env=child_env(), cwd=HERE, capture_output=True, text=True,
                             timeout=120)
        if res.returncode != 0:
            raise AssertionError(f"testnet exited {res.returncode}: {res.stderr[-2000:]}")
        for i, home in enumerate(self.homes):
            path = os.path.join(home, "config", "config.toml")
            cfg = load_config(path)
            if not (cfg.chaos.enabled and cfg.chaos.seed == CH_SEED and cfg.rpc.unsafe
                    and cfg.chaos.twin == (i == self.twin) and not cfg.tpu.enabled):
                raise AssertionError(f"testnet --chaos wrote another [chaos] for node{i}")
            # the one deviation from the JAX rigs: --fast turns the engine
            # off (4-vote batches are below the default min_device_batch of
            # 16); here every batch, commit and refill verifies on the card
            cfg.tpu.enabled = True
            cfg.tpu.min_device_batch = CH_MIN_DEVICE_BATCH
            # the chaos counters are read from /metrics
            cfg.instrumentation.prometheus = True
            cfg.instrumentation.prometheus_listen_addr = f"127.0.0.1:{self.metrics[i]}"
            save_config(cfg, path)

    def say(self, msg):
        log(f"  ({self.part}) {msg}")

    def start(self, i):
        log_f = open(os.path.join(self.homes[i], "node.log"), "ab")
        self.procs[i] = subprocess.Popen([sys.executable, *ch_node_argv(self.homes[i])],
                                         env=child_env(), cwd=HERE, stdout=log_f,
                                         stderr=subprocess.STDOUT)
        log_f.close()
        self.live[i], self.wm[i] = True, 0

    def kill(self, i):
        self.poll_recorders(force=True)
        self.before_kill[i] = self.chaos_metrics(i)
        self.procs[i].send_signal(9)
        self.procs[i].wait(30)
        self.live[i] = False

    def stop(self):
        for p in self.procs:
            if p is not None and p.poll() is None:
                p.send_signal(15)
        for p in self.procs:
            if p is None:
                continue
            try:
                p.wait(30)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()

    def wait_ready(self, check, what):
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < CH_READY_S:
            hs = [ch_height(p) for p in self.rpc]
            if check(hs):
                return hs, time.perf_counter() - t0
            dead = [i for i, p in enumerate(self.procs) if p.poll() is not None]
            if dead:
                raise AssertionError(f"node{dead[0]} exited {self.procs[dead[0]].returncode} "
                                     f"during startup: {self.log(dead[0])[-3000:]}")
            time.sleep(0.5)
        raise AssertionError(f"phase 17 startup timeout ({what}): heights "
                             f"{[ch_height(p) for p in self.rpc]}")

    def log(self, i):
        with open(os.path.join(self.homes[i], "node.log"), "rb") as f:
            return f.read().decode(errors="replace")

    def poll_recorders(self, force=False):
        """Each live node's verify.dispatch and gossip.hop events since the
        last poll: dispatches by path, and the hops' clamped trace fields
        (a twin's forged hop count and origin time must be clamped)."""
        if not force and time.perf_counter() - self.last_poll < 1.0:
            return
        self.last_poll = time.perf_counter()
        for i, port in enumerate(self.rpc):
            if not self.live[i]:
                continue
            try:
                snap = ch_call(port, "dump_flight_recorder", since=self.wm[i],
                               kinds="verify.dispatch,gossip.hop")["result"]
            except Exception:  # noqa: BLE001 — read again at the next poll
                continue
            if not snap.get("enabled", True):
                continue
            nxt = snap["next_seq"]
            self.lost[i] += max(0, nxt - self.wm[i] - snap["size"])
            self.wm[i] = nxt
            for ev in snap["events"]:
                if ev["kind"] == "verify.dispatch":
                    self.dispatch[i][ev["path"]] += 1
                elif i != self.twin:
                    self.hops += 1
                    self.clamps += 1 if ev.get("clamped") else 0

    def launches(self, i):
        return sum(self.dispatch[i][p] for p in CH_LAUNCH_PATHS)

    def chaos_metrics(self, i):
        """The node's chaos series from /metrics, by name and labels."""
        import urllib.request

        try:
            with urllib.request.urlopen(f"http://127.0.0.1:{self.metrics[i]}/metrics",
                                        timeout=5.0) as r:
                text = r.read().decode()
        except Exception as e:  # noqa: BLE001
            return {"error": repr(e)}
        out = {}
        for line in text.splitlines():
            if not line.startswith("tendermint_chaos_"):
                continue
            series, _, value = line.rpartition(" ")
            name, _, labels = series[len("tendermint_chaos_"):].partition("{")
            if name.endswith("_created"):
                continue
            labels = ",".join(kv for kv in labels.rstrip("}").split(",")
                              if kv and not kv.startswith("chain_id="))
            out[f"{name}{{{labels}}}" if labels else name] = float(value)
        return out

    def node_lines(self, card):
        for i in range(4):
            self.say(f"node{i}: kernel dispatches by path {dict(self.dispatch[i])} "
                f"({self.launches(i)} launches; {self.lost[i]} events aged out of the ring "
                f"unread); chaos series from /metrics {self.chaos_metrics(i)}"
                + (f", before its kill {self.before_kill[i]}" if i in self.before_kill else "")
                + f" ({card})")


def ch_scrape(net, checker, window=19):
    """Every node's height and its last `window` + 1 block hashes (/status,
    /blockchain) into the checker; returns the heights."""
    from tendermint_tpu_torch.rpc.jsonrpc import from_jsonable

    hs = []
    for i, p in enumerate(net.rpc):
        h = ch_height(p)
        hs.append(h)
        checker.observe_height(i, h)
        if h is None or h < 1:
            continue
        try:
            metas = from_jsonable(ch_rpc(p, f"blockchain?min_height={max(1, h - window)}"
                                            f"&max_height={h}")["result"])["block_metas"]
        except Exception:  # noqa: BLE001
            continue
        for meta in metas:
            checker.observe_block_hash(i, meta.header.height, meta.block_id.hash)
    return hs


def ch_tip(net, checker, idxs):
    known = [h for h in (ch_height(net.rpc[i]) for i in idxs) if h is not None]
    if known:
        return max(known)
    seen = [checker.last_height.get(i) for i in idxs]
    return max((h for h in seen if h is not None), default=1)


def ch_partition(net, groups, node_ids):
    for gi, g1 in enumerate(groups):
        for g2 in groups[gi + 1:]:
            for a in g1:
                for b in g2:
                    ch_call(net.rpc[a], "unsafe_chaos_link", peer_id=node_ids[b], drop=1.0)
                    ch_call(net.rpc[b], "unsafe_chaos_link", peer_id=node_ids[a], drop=1.0)


def phase_chaos(card, dev, parts="ab"):
    """Phase 17: (a) partition, crash and twin and (b) disk faults, each on
    its own 4-validator localnet, run at the same time (a thread each: the
    phase's time is the longer part's); returns the parts' numbers."""
    import tempfile
    import threading

    import tendermint_tpu_torch.store  # noqa: F401 — registers BlockMeta with the codec
    import tendermint_tpu_torch.types  # noqa: F401 — registers Block and evidence types
    from tendermint_tpu_torch.chaos.scenario import Scenario

    runs = {"a": (CH_SCENARIO_A, 0, ch_run_a), "b": (CH_SCENARIO_B, None, ch_run_b)}
    out, errors, threads, nets = {}, {}, [], []
    with contextlib.ExitStack() as stack:
        for part in parts:
            text, twin, run = runs[part]
            scenario = Scenario.parse(text, seed=CH_SEED)
            if scenario.fingerprint() != Scenario.parse(text, seed=CH_SEED).fingerprint():
                raise AssertionError(f"phase 17 ({part}): the scenario's resolution is not "
                                     "deterministic")
            log(f"  ({part}) scenario fingerprint {scenario.fingerprint()} (seed {CH_SEED}):")
            for ev in scenario.timeline():
                log(f"  ({part})   {ev.describe()}")
            root = stack.enter_context(tempfile.TemporaryDirectory(prefix=f"phase17{part}-"))
            net = ChNet(os.path.join(root, "net"), part, twin, [n.base for n in nets])
            net.build()
            nets.append(net)
            stack.callback(net.stop)

            def body(part=part, net=net, run=run, scenario=scenario):
                t0 = time.perf_counter()
                try:
                    for i in range(4):
                        net.start(i)
                    out[part] = run(net, scenario, card, dev)
                    out[part]["s"] = time.perf_counter() - t0
                    net.say(f"took {out[part]['s']:.3f} s ({card})")
                except BaseException as e:  # noqa: BLE001 — re-raised below, after both parts
                    errors[part] = e

            threads.append(threading.Thread(target=body, name=f"phase17{part}"))
        for t in threads:
            t.start()
        for t in threads:
            t.join()
    for part in parts:
        if part in errors:
            raise errors[part]
    return out


def ch_run_a(net, scenario, card, dev):
    """(a), the JAX chaos_smoke.py's run: readiness, the timeline staged
    through the unsafe_chaos_* routes and signals with scrapes between
    events, then recovery and accountability within CH_BUDGET_S."""
    from tendermint_tpu_torch.chaos.checker import InvariantChecker, RecoveryTimer
    from tendermint_tpu_torch.rpc.jsonrpc import from_jsonable

    hs, ready_s = net.wait_ready(
        lambda hs: all(h is not None for h in hs) and all(h >= 1 for h in hs[1:]),
        "every RPC up, nodes 1-3 at height 1")
    node_ids = [ch_rpc(p, "status")["result"]["node_info"]["id"] for p in net.rpc]
    twin_addr = from_jsonable(ch_rpc(net.rpc[0], "status")["result"]["validator_info"]["address"])
    net.say(f"ready in {ready_s:.3f} s at heights {hs}; twin address {twin_addr.hex()[:12]}")
    checker = InvariantChecker(4, liveness_exempt=[0])  # the twin halts by design
    heal_timer, restart_timer = RecoveryTimer(), RecoveryTimer()
    hstate = {"phase": "quiet", "t_partition": None, "detect_t": None, "quiet": set(),
              "clear_t": None}
    failures = []

    def poll_health():
        stall_free = True
        for i, p in enumerate(net.rpc):
            if i == 0 or not net.live[i]:
                continue
            h = ch_health(p)
            if h is None:
                stall_free = False
                continue
            alarms = set(h.get("alarms", {}))
            if hstate["phase"] == "quiet" and alarms:
                hstate["quiet"].update(f"node{i}:{a}" for a in alarms)
            if hstate["phase"] == "partition" and hstate["detect_t"] is None \
                    and "consensus_stall" in alarms:
                hstate["detect_t"] = time.perf_counter()
                net.say(f"watchdog: node{i} raised consensus_stall "
                    f"{hstate['detect_t'] - hstate['t_partition']:.3f} s after the partition")
            if "consensus_stall" in alarms:
                stall_free = False
        return stall_free

    def scrape():
        hs = ch_scrape(net, checker)
        known = [h for h in hs if h is not None]
        if known:
            heal_timer.observe(max(known))
        live_non_twin = [h for j, h in enumerate(hs) if j != 0 and net.live[j] and h is not None]
        if live_non_twin and all(net.live[j] and hs[j] is not None for j in range(1, 4)):
            restart_timer.observe(min(live_non_twin))
        net.poll_recorders()

    t0 = time.perf_counter()
    stall = None
    for ev in scenario.timeline():
        while time.perf_counter() < t0 + ev.t:
            scrape()
            poll_health()
            time.sleep(CH_POLL_S)
        net.say(f"+{time.perf_counter() - t0:.3f} s executing {ev.describe()}")
        if ev.action == "twin":
            continue  # installed from genesis by the node's config
        if ev.action == "partition":
            ch_partition(net, ev.args["groups"], node_ids)
            time.sleep(1.0)  # drain in-flight gossip
            stall = (time.perf_counter(), ch_tip(net, checker, range(4)))
            hstate["phase"], hstate["t_partition"] = "partition", time.perf_counter()
        elif ev.action == "heal":
            if stall is not None:
                tip = ch_tip(net, checker, range(4))
                if tip > stall[1] + 1:
                    checker.violations.append(f"commits continued during the partition: "
                                              f"{stall[1]} -> {tip}")
                net.say(f"the partition held the net at {stall[1]} for "
                    f"{time.perf_counter() - stall[0]:.3f} s (tip {tip})")
            if hstate["detect_t"] is None:
                poll_health()
            hstate["phase"] = "post_heal"
            baseline = ch_tip(net, checker, range(4))
            for i, p in enumerate(net.rpc):
                if net.live[i]:
                    ch_call(p, "unsafe_chaos_heal")
            heal_timer.mark("heal", baseline)
        elif ev.action == "kill":
            net.kill(ev.args["node"])
        elif ev.action == "restart":
            i = ev.args["node"]
            baseline = ch_tip(net, checker, [j for j in range(1, 4) if net.live[j]])
            net.start(i)
            restart_timer.mark("restart", baseline)

    evidence_height, byz = None, False
    scanned = set()
    deadline = time.perf_counter() + CH_BUDGET_S
    while time.perf_counter() < deadline:
        scrape()
        if poll_health() and hstate["clear_t"] is None:
            hstate["clear_t"] = time.perf_counter()
            net.say(f"watchdog: consensus_stall clear on every live non-twin node at "
                f"+{hstate['clear_t'] - t0:.3f} s")
        if evidence_height is None:
            for h in range(1, (ch_height(net.rpc[1]) or 0) + 1):
                if h in scanned:
                    continue
                try:
                    blk = from_jsonable(ch_rpc(net.rpc[1], f"block?height={h}")["result"])["block"]
                except Exception:  # noqa: BLE001
                    continue
                scanned.add(h)
                if blk is not None and blk.evidence:
                    if blk.evidence[0].address() != twin_addr:
                        failures.append("the committed evidence names another validator")
                    evidence_height = h
                    break
        if not byz:
            try:
                res = ch_call(net.rpc[1], "abci_query", data='"__byzantine__"')
                val = from_jsonable(res["result"]["response"]).get("value") or b""
                byz = twin_addr.hex().encode() in val
            except Exception:  # noqa: BLE001
                pass
        if (not heal_timer.unrecovered() and not restart_timer.unrecovered()
                and evidence_height is not None and byz and hstate["clear_t"] is not None):
            break
        time.sleep(CH_POLL_S)
    net.poll_recorders(force=True)
    status = ch_call(net.rpc[0], "unsafe_chaos_status")["result"]
    heights = [ch_height(p) for p in net.rpc]
    res = {
        "fingerprint": scenario.fingerprint(),
        "chaos_partition_recovery_ms": heal_timer.recovery_ms.get("heal", -1.0),
        "restart_recovery_ms": restart_timer.recovery_ms.get("restart", -1.0),
        "health_detect_latency_ms": ((hstate["detect_t"] - hstate["t_partition"]) * 1000
                                     if hstate["detect_t"] is not None else -1.0),
        "health_quiet_alarms": sorted(hstate["quiet"]),
        "evidence_height": evidence_height,
        "byzantine_validators_delivered": byz,
        "twin_equivocations": status["equivocations"],
        "trace_clamps": net.clamps,
        "gossip_hop_events": net.hops,
        "heights": heights,
        "launches": [net.launches(i) for i in range(4)],
        **checker.summary(),
    }
    net.say(f"{json.dumps(res, sort_keys=True)} ({card})")
    net.node_lines(card)
    for name, tmr in (("heal", heal_timer), ("restart", restart_timer)):
        ms = tmr.recovery_ms.get(name)
        if ms is None:
            failures.append(f"the net never recovered after the {name}")
        elif ms > CH_RECOVERY_A_S * 1000:
            failures.append(f"{name} recovery {ms:.3f} ms exceeds {CH_RECOVERY_A_S} s")
    if evidence_height is None:
        failures.append("the twin's evidence was never committed into a block")
    if not byz:
        failures.append("byzantine_validators never reached the app by BeginBlock")
    if len(checker.agreed_heights()) < 3:
        failures.append("too few heights cross-checked for agreement")
    if hstate["detect_t"] is None:
        failures.append("the watchdog never raised consensus_stall during the partition")
    if hstate["clear_t"] is None:
        failures.append("consensus_stall never cleared on every live non-twin node")
    if net.clamps < 1:
        failures.append("no honest node clamped the twin's forged trace fields")
    if status["equivocations"] < 1:
        failures.append("the twin never equivocated")
    ch_launch_failures(net, range(1, 4), dev, failures)
    failures += [f"invariant: {v}" for v in checker.violations]
    if failures:
        raise AssertionError("phase 17 (a) failed: " + "; ".join(failures))
    return res


def ch_launch_failures(net, honest, dev, failures):
    """Each honest node's dispatches: on the card at least one kernel
    launch, and none on the host (min_device_batch = 1)."""
    for i in honest:
        host = net.dispatch[i]["host"] + net.dispatch[i]["host-cold"]
        if dev.type == "cuda" and net.launches(i) == 0:
            failures.append(f"node{i} launched no kernel")
        if dev.type == "cuda" and host:
            failures.append(f"node{i} verified {host} batches on the host")


def ch_run_b(net, scenario, card, dev):
    """(b), the JAX disk_smoke.py's run: rot, scan and refill on node 3,
    ENOSPC on node 2 (a clean halt with the read path up), heal, kill and
    restart, every served block re-hashed."""
    from tendermint_tpu_torch.chaos.checker import InvariantChecker, RecoveryTimer
    from tendermint_tpu_torch.rpc.jsonrpc import from_jsonable

    hs, ready_s = net.wait_ready(
        lambda hs: all(h is not None and h >= CH_ROT_HEIGHT + 1 for h in hs),
        f"every node past height {CH_ROT_HEIGHT}")
    net.say(f"ready in {ready_s:.3f} s at heights {hs}")
    checker = InvariantChecker(4)
    restart_timer = RecoveryTimer()
    st = {"scan": None, "rot_t": None, "rot_launches": 0, "refill_t": None, "refill_launches": None,
          "enospc_t": None, "enospc_tip": None, "halt": False, "heal_tip": None}
    failures = []

    def served(i, height):
        p = net.rpc[i]
        try:
            blk = from_jsonable(ch_rpc(p, f"block?height={height}")["result"])["block"]
            meta = from_jsonable(ch_rpc(p, f"blockchain?min_height={height}"
                                           f"&max_height={height}")["result"])["block_metas"]
        except Exception:  # noqa: BLE001
            return False
        if blk is None or not meta:
            return False
        checker.observe_served_block(i, height, meta[0].block_id.hash, blk.hash())
        return True

    def scrape():
        hs = ch_scrape(net, checker, window=9)
        if all(net.live[j] and hs[j] is not None for j in range(4)):
            restart_timer.observe(min(hs))
        net.poll_recorders()
        return hs

    def poll_faults(now):
        if st["rot_t"] is not None and st["refill_t"] is None:
            try:
                sinfo = ch_rpc(net.rpc[3], "storage_info")["result"]
            except Exception:  # noqa: BLE001
                sinfo = None
            if sinfo is not None and not sinfo.get("refill", {}).get("pending") \
                    and not sinfo["blockstore"]["quarantined"] and served(3, CH_ROT_HEIGHT):
                st["refill_t"] = now
                net.poll_recorders(force=True)
                st["refill_launches"] = net.launches(3) - st["rot_launches"]
                net.say(f"node3 refilled height {CH_ROT_HEIGHT} from its peers "
                    f"{(now - st['rot_t']) * 1000:.3f} ms after the rot, "
                    f"{st['refill_launches']} kernel launches on node3 since the rot")
        if st["enospc_t"] is not None and not st["halt"]:
            h2, health = ch_height(net.rpc[2]), ch_health(net.rpc[2])
            if h2 is not None and health is not None:
                alarm = health.get("alarms", {}).get("disk_fault")
                if alarm is not None and alarm["severity"] == "critical":
                    st["halt"] = True
                    net.say(f"watchdog: node2 disk_fault CRITICAL with /status (height {h2}) "
                        f"and /health answering, "
                        f"{(now - st['enospc_t']) * 1000:.3f} ms after the fault")

    t0 = time.perf_counter()
    for ev in scenario.timeline():
        while time.perf_counter() < t0 + ev.t:
            scrape()
            poll_faults(time.perf_counter())
            time.sleep(CH_POLL_S)
        net.say(f"+{time.perf_counter() - t0:.3f} s executing {ev.describe()}")
        i = ev.args["node"]
        if ev.action == "rot":
            net.poll_recorders(force=True)
            st["rot_launches"] = net.launches(3)
            info = ch_call(net.rpc[i], "unsafe_chaos_rot", height=ev.args["height"])["result"]
            st["rot_t"] = time.perf_counter()
            report = ch_call(net.rpc[i], "unsafe_store_integrity_scan")["result"]
            st["scan"] = report
            net.say(f"rot {info['rotted']}; integrity scan: checked {report['checked']}, "
                f"corrupt {report['corrupt']}, quarantined {report['quarantined']} in "
                f"{report['ms']} ms")
            if ev.args["height"] not in report["corrupt"]:
                checker.violations.append(f"the integrity scan missed the rot at height "
                                          f"{ev.args['height']}: {report}")
        elif ev.action == "disk":
            if ev.args["kind"] == "heal":
                ch_call(net.rpc[i], "unsafe_chaos_disk", kind="heal", store=ev.args["store"])
                st["heal_tip"] = ch_tip(net, checker, [0, 1, 3])
            else:
                ch_call(net.rpc[i], "unsafe_chaos_disk", kind=ev.args["kind"],
                        store=ev.args["store"], p=ev.args["p"])
                st["enospc_t"] = time.perf_counter()
                st["enospc_tip"] = ch_tip(net, checker, [0, 1, 3])
        elif ev.action == "kill":
            net.kill(i)
        elif ev.action == "restart":
            baseline = ch_tip(net, checker, [j for j in range(4) if net.live[j]])
            net.start(i)
            restart_timer.mark("restart", baseline)

    deadline = time.perf_counter() + CH_BUDGET_S
    while time.perf_counter() < deadline:
        scrape()
        poll_faults(time.perf_counter())
        if st["refill_t"] is not None and "restart" in restart_timer.recovery_ms:
            health = ch_health(net.rpc[2])
            if health is not None and "disk_fault" not in health.get("alarms", {}):
                break
        time.sleep(CH_POLL_S)

    if st["scan"] is None:
        failures.append("the integrity scan never ran")
    if st["refill_t"] is None:
        failures.append(f"the quarantined block {CH_ROT_HEIGHT} was never refilled from peers")
    elif st["refill_t"] - st["rot_t"] > CH_RECOVERY_B_S:
        failures.append(f"the refill took {st['refill_t'] - st['rot_t']:.3f} s")
    if not st["halt"]:
        failures.append("node2 never raised a critical disk_fault alarm under ENOSPC")
    if st["heal_tip"] is None or st["enospc_tip"] is None or st["heal_tip"] <= st["enospc_tip"]:
        failures.append(f"nodes 0, 1 and 3 did not commit while node2's disk was full "
                        f"({st['enospc_tip']} -> {st['heal_tip']})")
    if "restart" not in restart_timer.recovery_ms:
        failures.append("node2 never rejoined consensus after the heal and the restart")
    elif restart_timer.recovery_ms["restart"] > CH_RECOVERY_B_S * 1000:
        failures.append(f"node2's rejoin took {restart_timer.recovery_ms['restart']:.3f} ms")
    log2 = net.log(2)
    if "CONSENSUS FAILURE" in log2:
        failures.append("node2 hit CONSENSUS FAILURE!!! under ENOSPC")
    if "consensus halted on storage fault" not in log2:
        failures.append("node2's log holds no attributed storage halt")
    heights = [ch_height(p) for p in net.rpc]
    tip = min(h for h in heights if h is not None)
    for i in range(4):
        for h in range(max(1, tip - 4), tip + 1):
            served(i, h)
    net.poll_recorders(force=True)
    res = {
        "fingerprint": scenario.fingerprint(),
        "disk_fault_recovery_ms": ((st["refill_t"] - st["rot_t"]) * 1000
                                   if st["refill_t"] is not None else -1.0),
        "store_integrity_scan_ms": st["scan"]["ms"] if st["scan"] else -1.0,
        "scan_checked": st["scan"]["checked"] if st["scan"] else 0,
        "enospc_recovery_ms": restart_timer.recovery_ms.get("restart", -1.0),
        "refill_launches": st["refill_launches"],
        "heights": heights,
        "heights_checked": len(checker.agreed_heights()),
        "launches": [net.launches(i) for i in range(4)],
        "violations": list(checker.violations),
    }
    net.say(f"{json.dumps(res, sort_keys=True)} ({card})")
    net.node_lines(card)
    ch_launch_failures(net, range(4), dev, failures)
    if dev.type == "cuda" and not st["refill_launches"]:
        failures.append("node3 launched no kernel between the rot and its refill")
    failures += [f"invariant: {v}" for v in checker.violations]
    if failures:
        raise AssertionError("phase 17 (b) failed: " + "; ".join(failures))
    return res


STK_TOP = 6  # phase 18 (a): heights 1 .. 6 applied; block 7 goes to the syncer unapplied
STK_SENDERS = 990  # bank senders outside the set: one transfer of 1 unit each per height
STK_OVERDRAFT_EVERY = 50  # every 50th tx of a burst overdraws (2^62): CheckTx code 13
STK_CORRUPT = 10  # envelopes per height with a flipped signature byte
STK_EPOCH = 3  # the staking app's epoch_length: powers shift at 3 (serving from 5) and 6
STK_STAKE_AT = 2  # the stake txs' height; the new set serves from STK_STAKE_AT + 2
STK_BONDS = 16  # bonds from fresh keys at STK_STAKE_AT, of power 10 + j
# genesis holds the run's first len(keys) - STK_BONDS + 1 keys, so that the
# set with the bonds and the leave is MAX_VOTES_COUNT (10,000) strong: a
# commit of more signatures is invalid (types/vote_set.go MaxVotesCount)
STK_EDIT, STK_LEAVE, STK_ROTATE = 1, 2, 3  # genesis validators edited to 25, leaving, rotating


def stk_power(i: int) -> int:
    """Genesis validator i's power: 10 + (i mod 7), so the shift changes most."""
    return 10 + i % 7


def stk_traffic(keys, hot):
    """Phase 18 (a)'s transactions, made in bulk before the run: per height
    h, STK_SENDERS transfers of 1 unit to `hot` at nonce h - 1, an
    overdraft (2^62, from a key of its own at nonce 0) in every
    STK_OVERDRAFT_EVERY txs and STK_CORRUPT transfers with a flipped
    signature byte; at STK_STAKE_AT the stake txs.  Returns the bursts,
    the overdrafts, the corrupted envelopes, the stake txs and the keys
    they bring (senders, bonds, the rotation's new key)."""
    from concurrent.futures import ThreadPoolExecutor

    from tendermint_tpu_torch.apps.bank import make_transfer_tx
    from tendermint_tpu_torch.apps.staking import (make_bond_tx, make_edit_power_tx,
                                                   make_rotate_key_tx)
    from tendermint_tpu_torch.mempool import SIGNED_TX_PREFIX

    senders = make_keys(STK_SENDERS, prefix="bank")
    n_over = STK_SENDERS // (STK_OVERDRAFT_EVERY - 1)
    over = make_keys(STK_TOP * n_over, prefix="overdraft")
    forge = make_keys(STK_TOP * STK_CORRUPT, prefix="forge")
    bonds = make_keys(STK_BONDS, prefix="bond")
    rotated = make_keys(1, prefix="rotated")[0]
    jobs = [(h, "send", (k, hot, 1, h - 1)) for h in range(1, STK_TOP + 1) for k in senders]
    jobs += [(h, "over", (over[(h - 1) * n_over + j], hot, 1 << 62, 0))
             for h in range(1, STK_TOP + 1) for j in range(n_over)]
    jobs += [(h, "bad", (forge[(h - 1) * STK_CORRUPT + j], hot, 1, 0))
             for h in range(1, STK_TOP + 1) for j in range(STK_CORRUPT)]
    with ThreadPoolExecutor(SIGN_THREADS) as ex:
        txs = list(ex.map(lambda j: make_transfer_tx(*j[2]), jobs, chunksize=256))
    off = len(SIGNED_TX_PREFIX) + 32  # the signature's first byte
    by_h = collections.defaultdict(lambda: collections.defaultdict(list))
    for (h, kind, _), tx in zip(jobs, txs):
        if kind == "bad":
            tx = tx[:off] + bytes([tx[off] ^ 1]) + tx[off + 1:]
        by_h[h][kind].append(tx)
    stake = ([make_bond_tx(k, 10 + j, 0) for j, k in enumerate(bonds)]
             + [make_edit_power_tx(keys[STK_EDIT], 25, 0),
                make_edit_power_tx(keys[STK_LEAVE], 0, 0),
                make_rotate_key_tx(keys[STK_ROTATE], "ed25519", rotated.pub_key().bytes(), 0)])
    bursts, overdrafts, bad = {}, set(), set()
    for h in range(1, STK_TOP + 1):
        sends, overs = list(by_h[h]["send"]), list(by_h[h]["over"])
        burst = []
        while sends:
            burst.append(overs.pop() if len(burst) % STK_OVERDRAFT_EVERY ==
                         STK_OVERDRAFT_EVERY - 1 and overs else sends.pop(0))
        burst += overs
        for j, tx in enumerate(by_h[h]["bad"]):
            burst.insert((j * len(burst)) // STK_CORRUPT, tx)
        if h == STK_STAKE_AT:
            burst += stake
        bursts[h] = burst
        overdrafts |= set(by_h[h]["over"])
        bad |= set(by_h[h]["bad"])
    return bursts, overdrafts, bad, stake, senders, bonds, rotated


def stk_sets(keys, bonds, rotated):
    """The sets the harness expects from the txs, as {pubkey: power}: the
    genesis set, the set serving from STK_STAKE_AT + 2 (bonds, the edit,
    the leave, the rotation in place) and the one serving from STK_EPOCH +
    2 (the staking app's barrel shift: powers in owner order moved one
    place, the last to the first), with the number of updates it takes."""
    power = {k.pub_key().bytes(): stk_power(i) for i, k in enumerate(keys)}
    owner = {k.pub_key().bytes(): k.pub_key().address() for k in keys}
    genesis = dict(power)
    for j, k in enumerate(bonds):
        power[k.pub_key().bytes()] = 10 + j
        owner[k.pub_key().bytes()] = k.pub_key().address()
    power[keys[STK_EDIT].pub_key().bytes()] = 25
    del power[keys[STK_LEAVE].pub_key().bytes()]
    p = power.pop(keys[STK_ROTATE].pub_key().bytes())
    power[rotated.pub_key().bytes()] = p
    owner[rotated.pub_key().bytes()] = keys[STK_ROTATE].pub_key().address()
    staked = dict(power)
    order = sorted(power, key=lambda pk: owner[pk])
    powers = [power[pk] for pk in order]
    shifted = dict(zip(order, powers[-1:] + powers[:-1]))
    n_updates = sum(1 for pk in order if shifted[pk] != power[pk])
    return genesis, staked, shifted, n_updates


def stk_powers(state_dict) -> dict:
    """{pubkey: power} of a state dict's current set."""
    return {v["pub_key"]["value"]: v["voting_power"]
            for v in state_dict["validators"]["validators"]}


def phase_staking(keys, card, dev):
    """Phase 18 (a): one validator of the 10,000-validator chain on the
    staking app (see the module docstring, 18).  Returns the launches of
    the producer, its signed-tx flushes, the syncer and the restart."""
    import asyncio

    return asyncio.run(stk_run(keys, card, dev))


async def stk_run(keys, card, dev):
    import tempfile

    from tendermint_tpu_torch.crypto import batch as batch_hook
    from tendermint_tpu_torch.crypto import batch_verifier as bvm
    from tendermint_tpu_torch.evidence import EvidencePool
    from tendermint_tpu_torch.fastsync import Processor, Scheduler
    from tendermint_tpu_torch.libs.tracing import FlightRecorder
    from tendermint_tpu_torch.mempool import Mempool, MempoolError
    from tendermint_tpu_torch.state import execution
    from tendermint_tpu_torch.state.execution import BlockExecutor, tx_pre_check
    from tendermint_tpu_torch.tools.loadgen import _HOT_ACCOUNT
    from tendermint_tpu_torch.types.block import BlockID
    from tendermint_tpu_torch.types.genesis import GenesisDoc, GenesisValidator
    from tendermint_tpu_torch.types.params import BLOCK_PART_SIZE_BYTES

    def since(before):
        return {k: v - before[k] for k, v in launch_counts().items()}

    t0 = time.perf_counter()
    keys = keys[:len(keys) - STK_BONDS + 1]
    bursts, overdrafts, bad, stake, senders, bonds, rotated = stk_traffic(keys, _HOT_ACCOUNT)
    genesis_set, staked_set, shifted_set, n_shift = stk_sets(keys, bonds, rotated)
    key_of = {k.pub_key().address(): k for k in list(keys) + list(bonds) + [rotated]}
    gen = GenesisDoc(CHAIN_ID, genesis_time_ns=LITE_T0, validators=[
        GenesisValidator(k.pub_key().address(), k.pub_key(), stk_power(i))
        for i, k in enumerate(keys)], app_state={"staking": {"epoch_length": STK_EPOCH}})
    log(f"  traffic: {STK_TOP} bursts of {len(bursts[1])} envelopes ({STK_SENDERS} transfers to "
        f"loadgen's hot account, {len(overdrafts) // STK_TOP} overdrafts, {STK_CORRUPT} "
        f"corrupted), {len(stake)} stake txs at height {STK_STAKE_AT} ({STK_BONDS} bonds, an "
        f"edit to 25, a leave, a rotation); expected sets: {len(genesis_set)} -> "
        f"{len(staked_set)} validators from {STK_STAKE_AT + 2}, {n_shift} power-only updates "
        f"at the epoch {STK_EPOCH} (serving from {STK_EPOCH + 2}); made in "
        f"{_ms(t0):.3f} ms")

    rec = FlightRecorder(size=1 << 16)
    commit_bv = bvm.BatchVerifier(device=dev, recorder=rec).install()
    cache = bvm.TableCache(commit_bv, tabulated=None).install()
    lane = bvm.AsyncBatchVerifier(bvm.BatchVerifier(device=dev, min_device_batch=16,
                                                    recorder=rec))
    tmp = tempfile.TemporaryDirectory(prefix="chip-smoke-staking-")
    producer = syncer = None
    timer = StepTimer()
    orig = {name: getattr(execution, name) for name in ("update_state",
                                                        "validator_updates_from_abci")}
    try:
        await lane.start()
        home_a = os.path.join(tmp.name, "producer")
        producer = await abci_node(home_a, gen, app_name="staking")
        log(f"  (a) producer: InitChain of {len(keys)} staking records through the handshake "
            f"in {producer.handshake_ms:.3f} ms, epoch_length {producer.app.epoch_length}")
        state = producer.state
        mempool = Mempool(producer.conns.mempool(), {"sig_precheck": True, "size": ABCI_MEMPOOL})
        mempool.pre_check = tx_pre_check(state)
        mempool.sig_verifier = lane
        executor = BlockExecutor(producer.state_store, producer.conns.consensus(), mempool,
                                 EvidencePool(producer.dbs["evidence"], producer.state_store,
                                              state), producer.bus)
        instrument(timer, executor, producer)
        for name in orig:
            timer.wrap(execution, name)
        before_a, seq_a, t_a = launch_counts(), next_seq(rec), time.perf_counter()
        flush_launches = dict.fromkeys(before_a, 0)
        blocks, commits, states, app_hashes, table_hits, builds = {}, {}, {}, {}, {}, []
        n_updates, sign_s = {}, 0.0

        async def submit(h):
            txs = bursts[h]
            before, seq = launch_counts(), next_seq(rec)
            out, ms = await check_burst(mempool, txs)
            for k, v in since(before).items():
                flush_launches[k] += v
            codes = collections.Counter()
            for tx, (res, _) in zip(txs, out):
                if tx in bad:
                    if not (isinstance(res, MempoolError) and str(res) == "invalid tx signature"):
                        raise AssertionError(f"a corrupted envelope at {h} gave {res!r}")
                    codes["bad signature"] += 1
                elif isinstance(res, Exception):
                    raise AssertionError(f"a tx at {h} raised {res!r}")
                elif res.code != (13 if tx in overdrafts else 0):
                    raise AssertionError(f"a tx at {h} gave code {res.code}: {res.log}")
                else:
                    codes[res.code] += 1
            flushes = rec.events(since=seq, kinds=["verify.flush"])
            big = [e for e in rec.events(since=seq, kinds=["verify.dispatch"]) if e["n"] >= 16]
            if any(e["path"] in ("host", "host-cold") for e in big):
                raise AssertionError(f"a flush of >= 16 envelopes verified on the host at {h}")
            lat = [lat for _, lat in out]
            log(f"    burst {h}: {len(txs)} check_tx in {ms:.3f} ms = {len(txs) / ms * 1000:.1f} "
                f"txs/s, latency p50 {percentile(lat, 50):.3f} ms p99 {percentile(lat, 99):.3f} ms, "
                f"codes {dict(codes)}, verify.flush sizes {[e['batch'] for e in flushes]}, "
                f"dispatch paths {dict(collections.Counter(e['path'] for e in big))} ({card})")

        with verify_commit_timing(timer), table_timing(None, builds, dev):
            last_commit = None
            for h in range(1, STK_TOP + 1):
                await submit(h)
                t_h = time.perf_counter()
                block = executor.create_proposal_block(h, state, last_commit,
                                                       state.validators.get_proposer().address)
                part_set = block.make_part_set(BLOCK_PART_SIZE_BYTES)
                bid = BlockID(block.hash(), part_set.header())
                made_ms = _ms(t_h)
                t0 = time.perf_counter()
                commit = sign_commit(state.validators, key_of, h, bid, block.time_ns + SEC)
                sign_s += time.perf_counter() - t0
                producer.block_store.save_block(block, part_set, commit)
                seq, n_builds = next_seq(rec), len(builds)
                state, _ = await executor.apply_block(state, bid, block)
                t1 = time.perf_counter()
                await producer.settle(block)
                timer.add("index_drain", t1)
                blocks[h], commits[h] = block, commit
                states[h], app_hashes[h] = state.to_dict(), producer.app.app_hash
                table_hits[h] = [e["hit"] for e in rec.events(since=seq, kinds=["verify.table"])]
                eb = producer.state_store.load_abci_responses(h)["end_block"]
                n_updates[h] = len(eb["validator_updates"])
                g = timer.ms.get
                extra = (f"; EndBlock {g('end_block', 0.0):.3f} ms with {n_updates[h]} updates, "
                         f"validator_updates_from_abci {g('validator_updates_from_abci', 0.0):.3f}"
                         f" ms, update_state {g('update_state', 0.0):.3f} ms; the set serving "
                         f"{h + 1}: {state.validators.size()} validators")
                for b in builds[n_builds:]:
                    extra += (f"; new table of {b['validators']} validators: host rows "
                              f"{b['rows_ms']:.3f} ms, kernel 2 {b['build_ms']} ms")
                log(f"    block {h}: {len(block.txs)} txs, create_proposal_block {made_ms:.3f} ms, "
                    f"table {table_hits[h]}; {timer.split()}{extra} ({card})")
                last_commit = commit
        launches_a = since(before_a)
        log(f"  (a) producer: {STK_TOP} blocks; signing {sign_s * 1000:.3f} ms; "
            f"{dispatch_share(rec, seq_a, time.perf_counter() - t_a)}; launches {launches_a}, of which the "
            f"signed-tx flushes {flush_launches} ({card})")
        stk_check_producer(producer, mempool, blocks, states, table_hits, n_updates, bursts,
                           overdrafts, bad, stake, senders, genesis_set, staked_set, shifted_set,
                           n_shift)
        # block 7 for the syncer's last pair: it carries block 6's commit, not applied
        block7 = executor.create_proposal_block(STK_TOP + 1, state, commits[STK_TOP],
                                                state.validators.get_proposer().address)
        saved = producer.app.validators, producer.app._state_digest()
        await producer.close()
        producer = None

        # (b) a syncing node: fast sync's steps by hand over blocks 1 .. 7
        syncer = await abci_node(os.path.join(tmp.name, "syncer"), gen, app_name="staking")
        state_b = syncer.state
        executor_b = BlockExecutor(syncer.state_store, syncer.conns.consensus(),
                                   Mempool(syncer.conns.mempool(), {"size": ABCI_MEMPOOL}),
                                   EvidencePool(syncer.dbs["evidence"], syncer.state_store,
                                                state_b), syncer.bus)
        proc, sched = Processor(1), Scheduler(1)
        sched.set_peer_range("producer", 1, STK_TOP + 1)
        for peer, h in sched.next_requests(0.0):
            sched.mark_requested(peer, h, 0.0)
        for h in range(1, STK_TOP + 2):
            if not sched.block_received("producer", h):
                raise AssertionError(f"the scheduler refused block {h}")
            proc.add_block(h, blocks.get(h, block7), "producer")
        before_b, seq_b, t_b = launch_counts(), next_seq(rec), time.perf_counter()
        while (pair := proc.peek_two()) is not None:
            first, second = pair
            first_parts = first.make_part_set(BLOCK_PART_SIZE_BYTES)
            first_id = BlockID(first.hash(), first_parts.header())
            state_b.validators.verify_commit(CHAIN_ID, first_id, first.height, second.last_commit)
            syncer.block_store.save_block(first, first_parts, second.last_commit)
            state_b, _ = await executor_b.apply_block(state_b, first_id, first)
            await syncer.settle(first)
            proc.pop_processed()
            sched.block_processed(first.height)
        launches_b = since(before_b)
        hits_b = [e["hit"] for e in rec.events(since=seq_b, kinds=["verify.table"])]
        log(f"  (b) syncer: {STK_TOP} blocks in {_ms(t_b):.3f} ms (pair check, save, apply); "
            f"table {hits_b}; launches {launches_b}; {card_memory(dev, cache)} ({card})")
        if state_b.to_dict() != states[STK_TOP] or syncer.app.app_hash != app_hashes[STK_TOP]:
            raise AssertionError(f"the syncer's state or app hash at {STK_TOP} differs")
        if False in hits_b or len(hits_b) != 2 * STK_TOP - 1:  # 6 pairs, 5 LastCommits
            raise AssertionError(f"the syncer's commit checks missed the table cache: {hits_b}")
        await syncer.close()
        syncer = None

        # (c) the producer restarted from its sqlite stores and app db
        before_c = launch_counts()
        restarted = await abci_node(home_a, gen, app_name="staking")
        try:
            app = restarted.app
            got = (restarted.handshaker.n_blocks, restarted.state.to_dict(), app.app_hash,
                   app.epoch_length, app.validators, app._state_digest())
            log(f"  (c) restart: handshake replayed {got[0]} blocks in "
                f"{restarted.handshake_ms:.3f} ms; app at {app.height} with {len(app.validators)} "
                f"records, epoch_length {app.epoch_length}; launches {since(before_c)} ({card})")
        finally:
            await restarted.close()
        if got != (0, states[STK_TOP], app_hashes[STK_TOP], STK_EPOCH) + saved:
            raise AssertionError("the restarted producer's state, app hash, epoch or staking "
                                 "records differ")
    finally:
        for name, fn in orig.items():
            setattr(execution, name, fn)
        for node in (producer, syncer):
            if node is not None:
                await node.close()
        await lane.stop()
        batch_hook.set_verifier(None)
        batch_hook.set_indexed_verifier(None)
        tmp.cleanup()
    return {"a": launches_a, "flushes": flush_launches, "b": launches_b,
            "misses": [h for h, hits in table_hits.items() if False in hits]}


def stk_check_producer(node, mempool, blocks, states, table_hits, n_updates, bursts, overdrafts,
                       bad, stake, senders, genesis_set, staked_set, shifted_set, n_shift):
    """Phase 18 (a)'s producer against what the harness computes from its
    txs: each block's txs, each set's members and powers, the epoch's
    updates, the table misses, the hot account's balance, every sender's
    nonce."""
    from tendermint_tpu_torch.abci.types import RequestQuery
    from tendermint_tpu_torch.apps.bank import DEFAULT_FAUCET
    from tendermint_tpu_torch.tools.loadgen import _HOT_ACCOUNT

    for h, b in blocks.items():
        want = [tx for tx in bursts[h] if tx not in bad and tx not in overdrafts]
        if sorted(b.txs) != sorted(want):
            raise AssertionError(f"block {h} does not hold exactly burst {h}'s accepted txs")
    if mempool.size() != 0:
        raise AssertionError(f"{mempool.size()} txs left in the pool")
    # states[h] holds the set serving h + 1
    want_sets = {h: genesis_set if h + 1 < STK_STAKE_AT + 2 else
                 staked_set if h + 1 < STK_EPOCH + 2 else shifted_set for h in states}
    for h, st in states.items():
        if stk_powers(st) != want_sets[h]:
            raise AssertionError(f"the set serving {h + 1} differs from the harness's")
    if n_updates[STK_STAKE_AT] != len(stake) + 1 or n_updates[STK_EPOCH] != n_shift:
        raise AssertionError(f"EndBlock's updates {n_updates} differ: want {len(stake) + 1} at "
                             f"{STK_STAKE_AT} and {n_shift} at {STK_EPOCH}")
    misses = [h for h, hits in table_hits.items() if False in hits]
    if misses != [2, STK_STAKE_AT + 3]:
        raise AssertionError(f"the commit checks missed the table cache at {misses}, not at 2 "
                             f"(the genesis set) and {STK_STAKE_AT + 3} (the new pubkeys); the "
                             f"epoch's power-only set must hit")
    hot = int(node.app.query(RequestQuery(path="balance", data=_HOT_ACCOUNT)).value)
    if hot != DEFAULT_FAUCET + STK_SENDERS * STK_TOP:
        raise AssertionError(f"the hot account holds {hot}")
    nonces = {int(node.app.query(RequestQuery(path="nonce", data=k.pub_key().address())).value)
              for k in senders}
    if nonces != {STK_TOP}:
        raise AssertionError(f"the senders' nonces are {nonces}, not {STK_TOP}")
    log(f"  (a) checks: blocks hold the accepted txs; sets {len(genesis_set)} -> "
        f"{len(staked_set)} (from {STK_STAKE_AT + 2}) -> powers shifted by {n_shift} updates "
        f"(from {STK_EPOCH + 2}); table misses at {misses}; hot account {hot}; "
        f"{len(senders)} senders at nonce {STK_TOP}")


RT_GENESIS = [0, 1, 2, 3]  # the genesis validators' nodes (networks/local/rotation_smoke.py)
RT_POWERS = [10, 20, 30, 40]
RT_TWIN = 4  # the configured double-signer; bonds in through the DSL
RT_JOINER_A = 5  # bonds in through the rig (the latency measurement)
RT_JOINER_B = 6  # bonds in through the DSL
RT_FRESH = 7  # the fast-sync bootstrapper over the rotated history
RT_EPOCH = 16  # the staking app's epoch_length (the JAX rig's default)
RT_PACE = 0.25  # s: timeout_commit (the JAX rig's --block-pace)
RT_SEED = 7  # the chaos seed and the scenario's (the JAX rig's --seed)
RT_BUDGET_S = 120.0  # a step's wait, at most (the JAX rig's --budget)
RT_SCENARIO = "\n".join([  # the JAX rig's scenario (rotation_smoke.py:335-341)
    f"valset join {RT_JOINER_B} power=10 @0",
    f"valset join {RT_TWIN} power=5 @3",
    f"partition {RT_TWIN},{RT_JOINER_A}|0,1,2,3,{RT_JOINER_B} @6",
    "heal @12",
    "valset power 1=25 @15",
])
RT_MIN_DEVICE_BATCH = 1  # [tpu] min_device_batch: every batch verifies on the card
RT_LOAD_S = 5.0  # loadgen --mode bank's --duration against node 0's RPC
RT_LOAD_RATE = 200  # its --rate (tx/s over all connections)
RT_LOAD_CONNECTIONS = 8  # loadgen's default


def rt_config(tmp, i, dev, rpc_port=None):
    """Node i's config, as the JAX rig's _node_cfg: the staking app, memdb,
    p2p on 127.0.0.1 without PEX, the engine on at RT_MIN_DEVICE_BATCH (on
    the CPU at 65,536, the host path, as the JAX rig on a host without an
    accelerator), chaos on (node RT_TWIN the twin), blocks paced at RT_PACE,
    fast sync as the launch gate, no watchdog and a 2^17-event recorder."""
    from tendermint_tpu_torch.config import test_config

    cfg = test_config(os.path.join(tmp, f"n{i}"))
    cfg.rpc.laddr = f"tcp://127.0.0.1:{rpc_port}" if rpc_port else ""
    cfg.base.db_backend = "memdb"
    cfg.base.proxy_app = "staking"
    cfg.p2p.laddr = "127.0.0.1:0"
    cfg.p2p.pex = False
    cfg.p2p.dial_timeout = 20.0
    cfg.p2p.max_num_inbound_peers = 16
    cfg.p2p.max_num_outbound_peers = 16
    cfg.tpu.enabled = True
    cfg.tpu.min_device_batch = RT_MIN_DEVICE_BATCH if dev.type == "cuda" else 1 << 16
    cfg.chaos.enabled = True
    cfg.chaos.seed = RT_SEED
    cfg.chaos.twin = i == RT_TWIN
    cfg.consensus.timeout_commit = RT_PACE
    cfg.consensus.skip_timeout_commit = False
    cfg.base.fast_sync = True
    cfg.instrumentation.watchdog = False
    cfg.instrumentation.flight_recorder_size = 1 << 17
    return cfg


async def rt_build(tmp, dev, rpc_port):
    """Seven nodes: 0-3 the genesis validators (powers 10/20/30/40, sorted by
    address), 4 the twin (a MockPV, which TwinSigner wraps), 5 and 6
    followers; every node but the twin holds a RotatingPV of its ed25519
    identity (the stake-tx owner key) and a BLS12-381 candidate, as in the
    JAX rig (its keys seeded here).  The nodes start behind the fast-sync
    gate while the mesh forms, and every node must then switch to
    consensus."""
    import asyncio

    from tendermint_tpu_torch.crypto.bls.keys import BlsPrivKey
    from tendermint_tpu_torch.crypto.keys import Ed25519PrivKey
    from tendermint_tpu_torch.fastsync import reactor as fs_reactor
    from tendermint_tpu_torch.node import Node
    from tendermint_tpu_torch.types.genesis import GenesisDoc, GenesisValidator
    from tendermint_tpu_torch.types.params import BlockParams, ConsensusParams
    from tendermint_tpu_torch.types.priv_validator import MockPV, RotatingPV

    def key(i):
        return Ed25519PrivKey.from_secret(f"rotation-id-{i}".encode())

    pvs = [MockPV(key(i)) if i == RT_TWIN else
           RotatingPV(MockPV(key(i)), MockPV(BlsPrivKey.from_secret(b"rotation-bls-%d" % i)))
           for i in range(7)]
    pvs[:4] = sorted(pvs[:4], key=lambda pv: pv.get_pub_key().address())
    gen = GenesisDoc(
        chain_id="rotation-smoke", genesis_time_ns=time.time_ns(),
        validators=[GenesisValidator(pv.get_pub_key().address(), pv.get_pub_key(), power)
                    for pv, power in zip(pvs[:4], RT_POWERS)],
        consensus_params=ConsensusParams(block=BlockParams(time_iota_ms=1)),
        app_state={"staking": {"epoch_length": RT_EPOCH}})
    nodes = [Node(rt_config(tmp, i, dev, rpc_port if i == 0 else None), gen,
                  priv_validator=pvs[i], db_backend="memdb", device=dev) for i in range(7)]
    orig = fs_reactor.SWITCH_TO_CONSENSUS_INTERVAL
    fs_reactor.SWITCH_TO_CONSENSUS_INTERVAL = 3600.0
    t0 = time.perf_counter()
    try:
        for node in nodes:
            await node.start()
        for _ in range(4):
            dials = [(i, f"{nodes[j].node_key.id}@{nodes[j].switch.transport.listen_addr}")
                     for i in range(7) for j in range(i + 1, 7)
                     if nodes[j].node_key.id not in nodes[i].switch.peers]
            if not dials:
                break
            await asyncio.gather(*(nodes[i].switch.dial_peer(a) for i, a in dials),
                                 return_exceptions=True)
            await asyncio.sleep(0.5)
        await rt_wait(lambda: all(n.switch.num_peers() >= 6 for n in nodes), 60.0,
                      "the 7-node mesh", nodes=nodes)
    finally:
        fs_reactor.SWITCH_TO_CONSENSUS_INTERVAL = orig
    await rt_wait(lambda: all(n.consensus is not None and n.consensus.is_running for n in nodes),
                  30.0, "every node's switch from fast sync to consensus", nodes=nodes)
    return nodes, gen, time.perf_counter() - t0


async def rt_wait(pred, budget, what, tick=0.1, nodes=(), phase="18 (b)"):
    """Wait for pred(); on a timeout the error names each of `nodes` by its
    store height, round state, peers and fast-sync progress."""
    import asyncio

    deadline = time.monotonic() + budget
    while not pred():
        if time.monotonic() > deadline:
            raise AssertionError(f"phase {phase}: timed out after {budget:.0f} s waiting for "
                                 f"{what}; nodes (store, height/round/step, peers, synced): "
                                 f"{[rt_node_state(n) for n in nodes]}")
        await asyncio.sleep(tick)


def rt_node_state(node):
    rs = node.consensus.rs if node.consensus is not None else None
    running = node.consensus is not None and node.consensus.is_running
    return (node.block_store.height(),
            f"{rs.height}/{rs.round}/{rs.step}{'' if running else ' stopped'}" if rs else None,
            node.switch.num_peers() if node.switch is not None else 0,
            node.blockchain_reactor.blocks_synced if node.blockchain_reactor else None)


async def rt_mesh_keeper(nodes, interval=2.0):
    """The JAX rig's keeper: redial dropped links (i < j); partitions are
    drop policies on live links, so a redial never bypasses one."""
    import asyncio

    while True:
        await asyncio.sleep(interval)
        dials = [a.switch.dial_peer(f"{b.node_key.id}@{b.switch.transport.listen_addr}")
                 for i, a in enumerate(nodes) if a.is_running
                 for b in nodes[i + 1:] if b.is_running and b.node_key.id not in a.switch.peers]
        if dials:
            await asyncio.gather(*dials, return_exceptions=True)


def rt_set(node):
    return node.state_store.load().validators


def rt_powers(vset) -> dict:
    return {v.address.hex(): v.voting_power for v in vset.validators}


def rt_recorder_counts(nodes) -> dict:
    """networks/local/rotation_smoke.py's recorder_counts."""
    out = collections.Counter()
    for node in nodes:
        for e in node.flight_recorder.events():
            if e["kind"] == "valset.update":
                out["valset_update_events"] += 1
            elif e["kind"] == "verify.table_rebuild":
                out["table_rebuild_events"] += 1
                out["table_rebuild_ok_events"] += 1 if e.get("ok") else 0
    return out


def rt_dispatches(nodes, since_ns, until_ns=None) -> dict:
    """The nodes' kernel dispatches by path between two monotonic times:
    in-process nodes share the process's batch hooks, so a commit check's
    dispatch lands in the recorder of whichever node installed them last."""
    return dict(collections.Counter(
        e["path"] for node in nodes for e in node.flight_recorder.events(kinds=["verify.dispatch"])
        if e["t_ns"] >= since_ns and (until_ns is None or e["t_ns"] < until_ns)))


RT_HOST_PATHS = ("host", "host-cold")  # dispatch paths that stay off the card


async def rt_bls_step(nodes, rig, ids, say):
    """Step 6 of phase 18 (b): the JAX rig's live ed25519 -> BLS12-381
    migration of validators 0-3, 5 and 6 (`valset migrate N bls`, each
    waited for as the JAX rig waits), the first aggregate commit above the
    uniform height, then node 0 back to ed25519 and per-vote commits
    again.  Two moments split the step into three windows: every node past
    the first aggregate height, and the rotation back's tx; on the card,
    the nodes' recorders hold no kernel dispatch in the aggregate window
    and at least one in each of the others.  Returns the step's numbers."""
    from tendermint_tpu_torch.types.agg_commit import AggregateCommit
    from tendermint_tpu_torch.types.vote import is_bls_key

    rec = nodes[0].flight_recorder
    out = {}
    t = time.monotonic()
    seq0, t0_ns, launches0 = next_seq(rec), time.monotonic_ns(), launch_counts()
    migrators = RT_GENESIS + [RT_JOINER_A, RT_JOINER_B]
    for i in migrators:  # the six txs in flight together (the JAX rig waits for each)
        await rig.valset("migrate", i, scheme="bls12381")
    bls_addrs = [rig._candidate_key(i, "bls12381").pub_key().address() for i in migrators]
    await rt_wait(lambda: (all(rt_set(nodes[0]).has_address(a) for a in bls_addrs)
                           and not any(rt_set(nodes[0]).has_address(ids[i]) for i in migrators)),
                  RT_BUDGET_S, "validators 0-3, 5 and 6 migrating to bls12381")
    vset = rt_set(nodes[0])
    if not all(is_bls_key(v.pub_key) for v in vset.validators):
        raise AssertionError("phase 18 (b): the set is not uniformly BLS after the migrations")
    h_uniform = out["bls_uniform_height"] = nodes[0].state_store.load().last_block_height

    def engaged():
        bs = nodes[0].block_store
        for h in range(h_uniform, bs.height() + 1):
            if isinstance(bs.load_block_commit(h), AggregateCommit):
                out["agg_engaged_height"] = h
                return True
        return False

    await rt_wait(engaged, RT_BUDGET_S, "BLS aggregation to engage")
    h_agg = out["agg_engaged_height"]
    out["bls_migration_height_gap"] = h_agg - h_uniform
    commit = nodes[0].block_store.load_block_commit(h_agg)
    if len(commit.agg_sig) != 96 or commit.signers.count() * 3 <= commit.signers.bits * 2:
        raise AssertionError(f"phase 18 (b): the aggregate commit at {h_agg} is malformed: "
                             f"{commit!r}, a {len(commit.agg_sig)}-byte signature")
    # the aggregate window opens once every node has applied the height
    # after the first aggregate one (the last per-vote commit, checked in
    # each validate_block of the first aggregate height, is behind them)
    # and closes at the rotation back's tx, a few aggregate heights later
    running = [x for x in nodes if x.is_running]
    await rt_wait(lambda: all(x.state_store.load().last_block_height > h_agg for x in running),
                  RT_BUDGET_S, f"every node applying height {h_agg + 1}")
    t_agg_ns, launches_agg = time.monotonic_ns(), launch_counts()
    await rt_wait(lambda: nodes[0].block_store.height() >= h_agg + 4, RT_BUDGET_S,
                  "4 heights past the first aggregate commit")
    folds = rec.events(since=seq0, kinds=["commit.aggregate"])
    t_back_ns, launches_back = time.monotonic_ns(), launch_counts()
    out["agg_last_height"] = nodes[0].block_store.height() - 1
    await rig.valset("migrate", 0, scheme="ed25519")
    await rt_wait(lambda: rt_set(nodes[0]).has_address(ids[0]), RT_BUDGET_S,
                  "node 0 rotating back to ed25519")
    h_mixed = nodes[0].state_store.load().last_block_height

    def disengaged():
        bs = nodes[0].block_store
        tip = bs.height()
        if tip < h_mixed + 3:
            return False
        c = bs.load_block_commit(tip - 1)
        if isinstance(c, AggregateCommit):
            return False
        out["agg_disengaged_height"] = tip - 1
        return True

    await rt_wait(disengaged, RT_BUDGET_S, "aggregation to disengage")
    windows = {"before": (t0_ns, t_agg_ns, launches0, launches_agg),
               "aggregate": (t_agg_ns, t_back_ns, launches_agg, launches_back),
               "after": (t_back_ns, None, launches_back, launch_counts())}
    for name, (a, b, l0, l1) in windows.items():
        out[f"dispatch_{name}"] = rt_dispatches(nodes, a, b)
        out[f"launches_{name}"] = {k: l1[k] - l0[k] for k in l0}
    out["bls_ms"] = (time.monotonic() - t) * 1000
    say(f"every validator migrated to bls12381: uniform at height {h_uniform}, aggregation "
        f"engaged at {h_agg} (gap {out['bls_migration_height_gap']}) with a 96-byte agg_sig "
        f"of {commit.signers.count()}/{commit.signers.bits} signers, {len(folds)} folds on "
        f"node 0 to height {out['agg_last_height']}; node 0 back on ed25519 at {h_mixed}, "
        f"per-vote commits again at {out['agg_disengaged_height']}; "
        f"{out['bls_ms']:.1f} ms")
    for name, what in (("before", "before the aggregate window"), ("aggregate", "in the "
                       "aggregate window"), ("after", "from the rotation back's tx on")):
        say(f"  {what}: the nodes' verify.dispatch by path {out[f'dispatch_{name}']}, "
            f"launches {out[f'launches_{name}']}")
    device = {name: sum(n for p, n in out[f"dispatch_{name}"].items() if p not in RT_HOST_PATHS)
              for name in windows}
    if device["aggregate"]:
        raise AssertionError(f"phase 18 (b): a node dispatched to the card in the aggregate "
                             f"window: {out['dispatch_aggregate']}")
    if nodes[0].device is not None and nodes[0].device.type == "cuda" and (
            not device["before"] or not device["after"]):
        raise AssertionError(f"phase 18 (b): no node dispatched to the card before "
                             f"uniformity or after the rotation back: {device}")
    return out


def phase_rotation(card, dev):
    """Phase 18 (b): the JAX rotation rig on 7 in-process port nodes (see
    the module docstring, 18); returns its numbers."""
    import asyncio

    return asyncio.run(rt_run(card, dev))


async def rt_run(card, dev):
    import asyncio
    import tempfile

    from tendermint_tpu_torch.chaos import InProcRig, InvariantChecker, Scenario, ScenarioRunner
    from tendermint_tpu_torch.chaos.checker import scan_committed_evidence
    from tendermint_tpu_torch.crypto import batch as batch_hook
    from tendermint_tpu_torch.fastsync import reactor as fs_reactor
    from tendermint_tpu_torch.lite2 import BISECTION, Client, LocalProvider, TrustOptions
    from tendermint_tpu_torch.node import Node
    from tendermint_tpu_torch.types.agg_commit import AggregateCommit
    from tendermint_tpu_torch.types.evidence import DuplicateVoteEvidence
    from tendermint_tpu_torch.types.priv_validator import MockPV

    def say(msg):
        log(f"  [18 b] {msg}")

    out = {}
    t_start = time.perf_counter()
    rpc_port = free_port()
    with tempfile.TemporaryDirectory(prefix="phase18b-") as tmp:
        nodes, gen, startup_s = await rt_build(tmp, dev, rpc_port)
        out["startup_s"] = startup_s
        say(f"net up: 4 genesis validators + 3 followers in {startup_s:.3f} s")
        pvs = [n.priv_validator for n in nodes]
        ids = [pv.get_pub_key().address() for pv in pvs]  # each node's first key
        fresh = None
        keeper_nodes = list(nodes)
        keeper = asyncio.ensure_future(rt_mesh_keeper(keeper_nodes))
        loadgen = None
        try:
            # 1. growth: a join through the rig, timed to the set's change
            await rt_wait(lambda: min(n.block_store.height() for n in nodes) >= 3, RT_BUDGET_S,
                          "3 commits everywhere", nodes=nodes)
            rig = InProcRig(nodes)
            t = time.monotonic()
            await rig.valset("join", RT_JOINER_A, power=15)
            await rt_wait(lambda: rt_set(nodes[0]).has_address(ids[RT_JOINER_A]), RT_BUDGET_S,
                          f"node {RT_JOINER_A} joining the set")
            out["valset_update_latency_ms"] = (time.monotonic() - t) * 1000
            say(f"node {RT_JOINER_A} bonded in: the set changed "
                f"{out['valset_update_latency_ms']:.1f} ms after the tx")
            # 2. the DSL: two joins (the twin's), a partition across the set
            # change, the heal and a power edit
            scenario = Scenario.parse(RT_SCENARIO, seed=RT_SEED)
            out["scenario_fingerprint"] = scenario.fingerprint()[:16]
            t = time.perf_counter()
            await ScenarioRunner(scenario, rig).run()
            await rt_wait(lambda: (rt_set(nodes[0]).has_address(ids[RT_JOINER_B])
                                   and rt_set(nodes[0]).has_address(ids[RT_TWIN])
                                   and 25 in rt_powers(rt_set(nodes[0])).values()),
                          RT_BUDGET_S, "the DSL's joins and power edit")
            out["set_size_after_growth"] = rt_set(nodes[0]).size()
            if out["set_size_after_growth"] != 7:
                raise AssertionError(f"phase 18 (b): {out['set_size_after_growth']} validators "
                                     "after the growth, not 7")
            say(f"scenario {out['scenario_fingerprint']} ran in {time.perf_counter() - t:.3f} s: "
                f"the set grew to 7 across a partition; twin armed")

            # 3. the twin's evidence committed
            def twin_evidence():
                for h, ev in scan_committed_evidence(nodes[0].block_store, max_back=500):
                    if (isinstance(ev, DuplicateVoteEvidence)
                            and ev.vote_a.validator_address == ids[RT_TWIN]):
                        out["twin_evidence_height"] = h
                        return True
                return False

            await rt_wait(twin_evidence, RT_BUDGET_S, "the twin's DuplicateVoteEvidence")
            say(f"twin evidence committed at height {out['twin_evidence_height']}")
            # 4. the epoch's barrel shift, with no client traffic
            before = rt_powers(rt_set(nodes[0]))
            h0 = nodes[0].state_store.load().last_block_height
            boundary = (h0 // RT_EPOCH + 1) * RT_EPOCH
            await rt_wait(lambda: nodes[0].state_store.load().last_block_height >= boundary + 3,
                          RT_BUDGET_S, f"epoch boundary {boundary} + 2")
            after = rt_powers(rt_set(nodes[0]))
            if not (set(before) == set(after) and before != after):
                raise AssertionError(f"phase 18 (b): epoch boundary {boundary} did not shift the "
                                     f"powers: {before} -> {after}")
            out["epoch_rotation_observed"] = boundary
            say(f"epoch shift observed at boundary {boundary}")
            # 5. the twin voted out by its owner key, through a live node
            await rig.valset("leave", RT_TWIN)
            await rt_wait(lambda: not rt_set(nodes[0]).has_address(ids[RT_TWIN]), RT_BUDGET_S,
                          "the twin leaving the set")
            out["set_size_after_leave"] = rt_set(nodes[0]).size()
            say(f"twin voted out: {out['set_size_after_leave']} validators")
            counts_mid = rt_recorder_counts(nodes)
            # 6. every validator migrates live to BLS12-381 through the chaos
            # clause; aggregation engages on the uniform set and disengages
            # when node 0 rotates back to ed25519 (rotation_smoke.py:424-485)
            out.update(await rt_bls_step(nodes, rig, ids, say))
            # 7. a fresh node fast-syncs the rotated history
            tip = max(n.block_store.height() for n in nodes)
            cfg = rt_config(tmp, RT_FRESH, dev)
            cfg.chaos.twin = False
            fresh = Node(cfg, gen, priv_validator=MockPV(), db_backend="memdb", device=dev)
            t = time.perf_counter()
            # as the launch: the fast-sync gate held while its links form
            # and until a peer's status has reported the tip (a peer counts
            # at height 0 until then, and a switch check in between would
            # hand the node to consensus's catch-up with nothing synced)
            fs_gate = fs_reactor.SWITCH_TO_CONSENSUS_INTERVAL
            fs_reactor.SWITCH_TO_CONSENSUS_INTERVAL = 3600.0
            try:
                await fresh.start()
                await asyncio.gather(*(
                    fresh.switch.dial_peer(f"{x.node_key.id}@{x.switch.transport.listen_addr}")
                    for j, x in enumerate(nodes) if j != RT_TWIN), return_exceptions=True)
                keeper_nodes.append(fresh)
                await rt_wait(lambda: fresh.blockchain_reactor.scheduler.max_peer_height() >= tip,
                              60.0, "the fresh node's peers reporting their heights",
                              nodes=nodes + [fresh])
            finally:
                fs_reactor.SWITCH_TO_CONSENSUS_INTERVAL = fs_gate
            await rt_wait(lambda: fresh.block_store.height() >= tip, RT_BUDGET_S,
                          f"the fresh node fast-syncing {tip} heights", tick=0.25,
                          nodes=nodes + [fresh])
            out["fastsync_joiner_height"] = fresh.block_store.height()
            if fresh.blockchain_reactor.blocks_synced < tip - 1:
                raise AssertionError(f"phase 18 (b): the fresh node fast-synced "
                                     f"{fresh.blockchain_reactor.blocks_synced} of {tip} heights")
            if not isinstance(fresh.block_store.load_block_commit(out["agg_engaged_height"]),
                              AggregateCommit):
                raise AssertionError("phase 18 (b): the fresh node stored no aggregate commit at "
                                     f"height {out['agg_engaged_height']}")
            say(f"fresh node fast-synced to {out['fastsync_joiner_height']} in "
                f"{time.perf_counter() - t:.3f} s across every set change, the aggregate "
                f"heights {out['agg_engaged_height']}-{out['agg_last_height']} included")
            # 8. lite2 bisects from height 2 to the tip across the rotations
            root = nodes[0].block_store.load_block(2)
            lite_tip = nodes[0].block_store.height() - 1
            client = Client(gen.chain_id, TrustOptions(period_ns=3600 * SEC, height=2,
                                                       hash=root.header.hash()),
                            LocalProvider(nodes[0]), witnesses=[LocalProvider(nodes[1])],
                            mode=BISECTION)
            t = time.perf_counter()
            await client.initialize()
            sh = await client.verify_header_at_height(lite_tip, time.time_ns())
            out["lite2_skip_across_rotation_ok"] = sh is not None and sh.height == lite_tip
            if not out["lite2_skip_across_rotation_ok"]:
                raise AssertionError("phase 18 (b): lite2 returned a bogus header")
            say(f"lite2 bisected 2 -> {lite_tip} across the rotations in "
                f"{time.perf_counter() - t:.3f} s")
            # bank load at node 0's RPC (fault 3.13 shows as app:12)
            loadgen = Child("loadgen", [
                "-m", "tendermint_tpu_torch.tools.loadgen", f"127.0.0.1:{rpc_port}",
                "--connections", str(RT_LOAD_CONNECTIONS), "--rate", str(RT_LOAD_RATE),
                "--mode", "bank", "--duration", str(RT_LOAD_S), "--json"], tmp)
            t = time.perf_counter()
            await loadgen.start()
            rc = await loadgen.finish(timeout=RT_LOAD_S + CHILD_READY_S)
            lines = loadgen.out.strip().splitlines()
            if rc != 0 or not lines:
                raise AssertionError(f"loadgen --mode bank exited {rc}: "
                                     f"{loadgen.read_log()[-3000:]}")
            out["bank_load"] = json.loads(lines[-1])
            load = out["bank_load"]
            say(f"loadgen --mode bank ({time.perf_counter() - t:.3f} s with its start): offered "
                f"{load['offered']}, accepted {load['accepted']}, rejected {load['rejected']} "
                f"{load['reject_codes']}, throttled {load['throttled']}, transport "
                f"{load['transport_errors']}; {load['commits_under_load']} commits under load "
                f"(app:12 is ROADMAP 3.13)")
            if load["accepted"] == 0 or load["offered"] != (
                    load["accepted"] + load["rejected"] + load["throttled"]
                    + load["transport_errors"]):
                raise AssertionError(f"phase 18 (b): the bank load's split is off: {load}")
            # 9. the judgement
            checker = InvariantChecker(8, liveness_exempt=[RT_TWIN])
            for i, node in enumerate(nodes + [fresh]):
                checker.observe_node(i, node)
            out["agreed_heights"] = len(checker.agreed_heights())
            out["max_height"] = max(n.block_store.height() for n in nodes)
            if checker.violations:
                raise AssertionError(f"phase 18 (b): invariant violations {checker.violations}")
            counts = rt_recorder_counts(nodes + [fresh])
            out.update({k: max(counts_mid[k], counts[k]) for k in counts | counts_mid})
            if not out.get("valset_update_events") or not out.get("table_rebuild_events"):
                raise AssertionError(f"phase 18 (b): no valset.update or verify.table_rebuild "
                                     f"event: {dict(counts)}")
        finally:
            keeper.cancel()
            if loadgen is not None:
                await loadgen.finish(sig=15)
            stopping = [n for n in nodes + [fresh] if n is not None and n.is_running]
            await asyncio.gather(*(n.stop() for n in stopping), return_exceptions=True)
            batch_hook.set_verifier(None)
            batch_hook.set_indexed_verifier(None)
    out["s"] = time.perf_counter() - t_start
    say(f"0 violations over {out['agreed_heights']} agreed heights (tip {out['max_height']}); "
        f"{out['valset_update_events']} valset.update and {out['table_rebuild_events']} "
        f"verify.table_rebuild events ({out['table_rebuild_ok_events']} ok); took "
        f"{out['s']:.3f} s ({card})")
    return out


def process_pick(default=None):
    """The kernel this process's auto-profile picked (its first profile,
    which every later table of the process follows), or `default` where
    it has profiled nothing."""
    from tendermint_tpu_torch.crypto import batch_verifier as bvm

    prof = next(iter(bvm.tabulated_profiles.values()), None)
    if prof is None:
        return default
    return "ed25519_tabulated" if prof["tab_ms"] < prof["ladder_ms"] else "ed25519_ladder"


def add_launches(report, counts, tag):
    """Adds a phase's launch counts to `report`, also under the phase's tag."""
    for name, c in counts.items():
        report[name]["launches"] += c
        report[name][tag] = c


def run_light(keys, card, dev, picked, report):
    """Phase 6 with its launch checks, its launches added to `report`."""
    log("[6] light client: bisection, sequence, engine lane and shared cache at 10k validators")
    launch_counts(zero=True)
    t0 = time.perf_counter()
    _, launches_34 = phase_light(keys, card, dev, report)
    counts = launch_counts()
    log(f"  launches in phase 6: {counts}; phase 6 took {time.perf_counter() - t0:.3f} s")
    if counts["ed25519_window_tables"] == 0:
        raise AssertionError("kernel 2 (window tables) was not launched in phase 6")
    if launches_34["ed25519_ladder"] == 0:
        raise AssertionError("the ladder was not launched in phase 6's engine lane")
    add_launches(report, counts, "6")


def run_replay(keys, card, dev, picked, report):
    """Phase 7 with its launch checks, its launches added to `report`."""
    log("[7] fast-sync replay from sqlite stores at 10k validators across a set rotation")
    launch_counts(zero=True)
    t0 = time.perf_counter()
    launches_a = phase_replay(keys, card, dev)
    counts = launch_counts()
    log(f"  launches in phase 7: {counts}; phase 7 took {time.perf_counter() - t0:.3f} s")
    picked = process_pick(picked)
    if counts["ed25519_ladder"] == 0:
        raise AssertionError("the ladder was not launched in phase 7")
    if counts["ed25519_window_tables"] != 2:
        raise AssertionError("kernel 2 (window tables) was not launched once per set in phase 7")
    if launches_a[picked] == 0:
        raise AssertionError(f"the auto-profile's pick ({picked}) was not launched in phase 7 (a)")
    add_launches(report, counts, "7")


def run_abci(keys, card, dev, picked, report):
    """Phase 8 with its launch checks, its launches added to `report`."""
    log("[8] blocks applied to the kvstore app at 10k validators: mempool, BlockExecutor, "
        "fast sync, handshake")
    launch_counts(zero=True)
    t0 = time.perf_counter()
    launches = phase_abci(keys, card, dev)
    counts = launch_counts()
    log(f"  launches in phase 8: {counts}; phase 8 took {time.perf_counter() - t0:.3f} s")
    picked = process_pick(picked)
    if launches["flushes"]["ed25519_ladder"] == 0:
        raise AssertionError("the ladder was not launched by the mempool's signed-tx flushes")
    if launches["a"]["ed25519_window_tables"] != 2:
        raise AssertionError("kernel 2 (window tables) was not launched once per set in phase 8 (a)")
    for part in ("a", "b", "c3"):
        if launches[part][picked] == 0:
            raise AssertionError(f"the auto-profile's pick ({picked}) was not launched in phase 8 "
                                 f"({part})")
    add_launches(report, counts, "8")


def run_boundary(keys, card, dev, picked, report):
    """Phase 14 with its launch checks, its launches added to `report`."""
    log("[14] a validator across its process boundaries: its app behind the ABCI socket "
        "(abci_cli kvstore), its key in a remote signer process, /metrics, and `light` in "
        "front of its RPC, at 10,000 validators")
    launch_counts(zero=True)
    t0 = time.perf_counter()
    out = phase_boundary(keys, card, dev)
    counts = launch_counts()
    log(f"  launches in phase 14 on the node (light's, in its own process, are not counted): "
        f"{counts}; {out['validate_blocks']} validate_block calls on heights >= 2, "
        f"{out['hits']} table hits, {out['declines']} declines, {out['frames']} vote frames "
        f"accepted; phase 14 took {time.perf_counter() - t0:.3f} s")
    log(f"  light's engine in its own process (its exit line; not in the kernels line): "
        f"launches {out['light']['launches']}, dispatch paths {out['light']['paths']}, "
        f"table lookups {out['light']['tables']}")
    picked = process_pick(picked)
    if picked == "ed25519_tabulated" and counts["ed25519_window_tables"] != 1:
        raise AssertionError("kernel 2 (window tables) did not build the node's genesis table "
                             "exactly once in phase 14")
    if counts[picked] < out["hits"]:
        raise AssertionError(f"the auto-profile's pick ({picked}) did not serve every table hit "
                             "in phase 14")
    if counts["ed25519_ladder"] < out["frames"] + out["declines"]:
        raise AssertionError("the ladder did not serve every accepted vote frame and the "
                             "genesis set's declined check in phase 14")
    add_launches(report, counts, "14")


def run_side(keys, card, dev, picked, report):
    """Phases 9, 10 (a) and 15, one after another, with their launch
    checks, their launches added to `report` (phases 6-8, 14 and 18 (a)
    run beside them, each in a process of its own)."""
    log("[9] consensus at 10k validators: proposals, vote frames, a round change and a restart "
        "from the WAL")
    launch_counts(zero=True)
    t0 = time.perf_counter()
    out = phase_consensus(keys, card, dev)
    counts = launch_counts()
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
    launch_counts(zero=True)
    t0 = time.perf_counter()
    out = phase_node(keys, card, dev)
    counts = launch_counts()
    log(f"  launches in phase 10 (a): {counts}; {out['validate_blocks']} validate_block calls on "
        f"heights >= 2, {out['hits']} table hits, declines by node {out['declines']}, tables "
        f"built {out['tables']}, {out['frames']} vote frames accepted; phase 10 (a) took "
        f"{time.perf_counter() - t0:.3f} s")
    if sorted(out["tables"]) != ["table-build", "table-build", "table-rebuild"]:
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
    log("  phase 10 (b), the CLI, runs beside phase 13")

    log("[15] transactions from outside at 10,000 validators: the app over ABCI gRPC "
        "(abci_cli --abci grpc kvstore), a tm-bench firehose (loadgen) at the RPC, the "
        "BroadcastAPI on rpc.grpc_laddr")
    launch_counts(zero=True)
    t0 = time.perf_counter()
    out = phase_grpc(keys, card, dev)
    counts = launch_counts()
    log(f"  launches in phase 15 on the node: {counts}; {out['validate_blocks']} validate_block "
        f"calls on heights >= 2, {out['hits']} table hits, {out['declines']} declines, "
        f"{out['frames']} vote frames accepted, {out['flushes']} signed-tx flushes; phase 15 "
        f"took {time.perf_counter() - t0:.3f} s")
    if picked == "ed25519_tabulated" and counts["ed25519_window_tables"] != 1:
        raise AssertionError("kernel 2 (window tables) did not build the node's genesis table "
                             "exactly once in phase 15")
    if counts[picked] < out["hits"]:
        raise AssertionError(f"the auto-profile's pick ({picked}) did not serve every table hit "
                             "in phase 15")
    if counts["ed25519_ladder"] < out["frames"] + out["declines"] + out["flushes"]:
        raise AssertionError("the ladder did not serve every signed-tx flush, accepted vote frame "
                             "and the genesis set's declined check in phase 15")
    for name, c in counts.items():
        report[name]["launches"] += c


def join_kids(kids):
    """Joins every PhaseChild of `kids`: ({tag: result}, [failures])."""
    done, failed = {}, []
    for tag, kid in kids.items():
        try:
            done[tag] = kid.join()
        except AssertionError as e:
            failed.append(e)
    return done, failed


def run_staking(keys, card, dev, picked, report):
    """Phase 18 (a) with its launch checks, its launches added to `report`."""
    log("[18] (a) validator sets that change while the card verifies: one validator of the "
        "10,000-validator chain on the staking app (bank transfers, bonds, an edit, a leave, a "
        "key rotation, an epoch's power shift), a syncer and a restart")
    launch_counts(zero=True)
    t0 = time.perf_counter()
    out = phase_staking(keys, card, dev)
    counts = launch_counts()
    log(f"  launches in phase 18 (a): {counts}; the producer's {out['a']}, of which the "
        f"signed-tx flushes {out['flushes']}; the syncer's {out['b']}; table misses at "
        f"{out['misses']}; phase 18 (a) took {time.perf_counter() - t0:.3f} s ({card})")
    if out["flushes"]["ed25519_ladder"] == 0:
        raise AssertionError("the ladder was not launched by phase 18's signed-tx flushes")
    if any(counts[name] == 0 for name in ED_KERNELS):
        raise AssertionError(f"a kernel was not launched in phase 18 (a): {counts}")
    if counts["ed25519_window_tables"] != 2 or out["a"]["ed25519_window_tables"] != 2:
        raise AssertionError("kernel 2 (window tables) was not launched exactly for the genesis "
                             "set and the set with new pubkeys in phase 18 (a)")
    for part in ("a", "b"):
        if out[part][picked] == 0:
            raise AssertionError(f"the auto-profile's pick ({picked}) was not launched in phase "
                                 f"18 (a)'s {'producer' if part == 'a' else 'syncer'}")
    for name, c in counts.items():
        report[name]["launches"] += c


def run_chaos_rotation(card, dev, picked, report, after_17=None):
    """Phase 17 and, at the same time, phase 18 (b), with their launch
    checks (phase 17 launches nothing in this process), the launches added
    to `report`; after_17() is called once phase 17 has passed, while
    18 (b) runs on.  Returns the seconds of 17 (a), 17 (b) and 18 (b)."""
    import threading

    log("[17] the chaos rig on the card: two 4-validator localnets at once through the CLI "
        "(testnet --fast --chaos, the engine on at min_device_batch 1), (a) partition, crash "
        "and a double-signing twin, (b) block-store rot, ENOSPC, heal and restart; at the same "
        "time [18] (b), the JAX rotation rig on 7 in-process port nodes on the staking app")
    launch_counts(zero=True)
    t0 = time.perf_counter()
    rot = {}

    def rotation():
        try:
            rot["out"] = phase_rotation(card, dev)
        except BaseException as e:  # noqa: BLE001 — re-raised below, after phase 17
            rot["error"] = e

    rot_thread = threading.Thread(target=rotation, name="phase18b")
    rot_thread.start()
    try:
        out = phase_chaos(card, dev)
        if after_17 is not None:
            after_17()
    finally:
        rot_thread.join()
    counts = launch_counts()
    if "error" in rot:
        raise rot["error"]
    log(f"  launches in phase 17 and 18 (b) in this process: {counts}, all 18 (b)'s (each phase "
        f"17 node's, in its own process, are on its line above: (a) {out['a']['launches']}, (b) "
        f"{out['b']['launches']}, node3's refill window {out['b']['refill_launches']}); phase 17 "
        f"took {out['a']['s']:.3f} / {out['b']['s']:.3f} s ((a) / (b)), 18 (b) "
        f"{rot['out']['s']:.3f} s, both {time.perf_counter() - t0:.3f} s ({card})")
    log(f"  phase 18 (b): {rot['out']['table_rebuild_ok_events']} verify.table_rebuild events "
        f"beside {counts['ed25519_window_tables']} kernel-2 launches; "
        f"valset_update_latency_ms {rot['out']['valset_update_latency_ms']:.1f}, "
        f"lite2_skip_across_rotation_ok {rot['out']['lite2_skip_across_rotation_ok']}, the "
        f"joiner at {rot['out']['fastsync_joiner_height']} ({card})")
    if counts["ed25519_ladder"] == 0 or counts[picked] == 0:
        raise AssertionError(f"phase 18 (b)'s nodes did not verify on the card: {counts}")
    if picked == "ed25519_tabulated" and counts["ed25519_window_tables"] == 0:
        raise AssertionError("kernel 2 (window tables) was not launched for phase 18 (b)'s sets")
    for name, c in counts.items():
        report[name]["launches"] += c
    return {"17 a": out["a"]["s"], "17 b": out["b"]["s"], "18 b": rot["out"]["s"]}


KT_SR_VALIDATORS = 100  # phase 19 (a): BASELINE config #3's set, power 10 each
KT_SR_TXS = 100  # (a): plain kvstore txs per height (no signed envelope: the lane stays idle)
KT_INIT_TRIES = 64  # (a): homes `init` may write until its key's address suits (kt_init)
KT_MIX_SR = 100  # (b): sr25519 members of the mixed 10,000-validator set
KT_MIX_SECP = 4  # (b): secp256k1 members; the other members keep phase 3's ed25519 keys
KT_MIX_BLS = 100  # (b): bls12381 members
BLS_VALIDATORS = 100  # phase 20: the mixed set, power 10 each
BLS_MEMBERS = 50  # phase 20: of them bls12381 (ours included); the others ed25519
BLS_TXS = 100  # phase 20: plain kvstore txs per height
BN_VALIDATORS = 4  # phase 21: `testnet --key-type bls12381`'s validators
BN_HEIGHTS = 6  # phase 21: the height every validator reaches before the joiners start
BN_BUDGET_S = 120.0  # phase 21: a part's wait, at most


class KeyTimer:
    """Host verify calls and ms by key type while the block runs: class-level
    wrappers on the verify of sr25519, secp256k1, bls12381 and multisig keys
    (a multisig's time holds its sub-keys', which count on their own line
    too), and module-level ones on the BLS scheme's aggregate checks (one
    pairing each; a batch of k claims is one blinded pairing product)."""

    PAIRINGS = ("fast_aggregate_verify", "batch_verify_aggregates")

    def __init__(self):
        from tendermint_tpu_torch.crypto.bls import scheme
        from tendermint_tpu_torch.crypto.bls.keys import BlsPubKey
        from tendermint_tpu_torch.crypto.keys import Secp256k1PubKey
        from tendermint_tpu_torch.crypto.multisig import MultisigThresholdPubKey
        from tendermint_tpu_torch.crypto.sr25519 import Sr25519PubKey

        self.orig = {c: c.verify for c in (Sr25519PubKey, Secp256k1PubKey, BlsPubKey,
                                            MultisigThresholdPubKey)}
        self.scheme = scheme
        self.orig_fns = {name: getattr(scheme, name) for name in self.PAIRINGS}
        self.ms, self.n = collections.Counter(), collections.Counter()

    def __enter__(self):
        for cls, orig in self.orig.items():
            cls.verify = self._timed(cls.__name__, orig)
        for name, orig in self.orig_fns.items():
            setattr(self.scheme, name, self._timed(name, orig))
        return self

    def _timed(self, name, orig):
        def verify(pk, *a, **k):
            t = time.perf_counter()
            try:
                return orig(pk, *a, **k)
            finally:
                self.ms[name] += _ms(t)
                self.n[name] += 1
        return verify

    def __exit__(self, *exc):
        for cls, orig in self.orig.items():
            cls.verify = orig
        for name, orig in self.orig_fns.items():
            setattr(self.scheme, name, orig)

    def line(self) -> str:
        return ", ".join(f"{name} {self.n[name]} in {self.ms[name]:.3f} ms "
                         f"({self.ms[name] / self.n[name]:.3f} ms each)"
                         for name in sorted(self.n)) or "none"


def kt_init(root, key_type="sr25519"):
    """`init --key-type <key_type>` into fresh homes under `root` until its
    random key's address lies in [1/64, 1/2) of the address space, so that
    kt_sr_keys (kt_bls_keys) finds CS_OURS_AT - 1 keys below it and the
    rest above it in a few hundred derivations.  Returns the home, its key
    and the tries."""
    from tendermint_tpu_torch import cli
    from tendermint_tpu_torch.privval import FilePV

    want = {"sr25519": "tendermint/PrivKeySr25519",
            "bls12381": "tendermint/PrivKeyBLS12381"}[key_type]
    for t in range(1, KT_INIT_TRIES + 1):
        home = os.path.join(root, f"home{t}")
        with contextlib.redirect_stdout(io.StringIO()):
            rc = cli.main(["--home", home, "init", "--key-type", key_type, "--chain-id",
                           CHAIN_ID])
        if rc != 0:
            raise AssertionError(f"init --key-type {key_type} exited {rc}")
        key = FilePV.load(*pv_files(home)).key.priv_key
        if key.TYPE != want:
            raise AssertionError(f"init --key-type {key_type} wrote a {key.TYPE} key")
        if 1 << 154 <= int.from_bytes(key.pub_key().address(), "big") < 1 << 159:
            return home, key, t
    raise AssertionError(f"no key of {KT_INIT_TRIES} init runs had a usable address")


def kt_sr_keys(ours, n):
    """n sr25519 keys holding `ours` such that it is the round-0 proposer of
    CS_OURS_AT at power 10 each (the CS_OURS_AT-th lowest address): the
    first CS_OURS_AT - 1 seeded keys whose address sorts below ours, the
    first n - CS_OURS_AT above.  Returns them and the keys derived."""
    from tendermint_tpu_torch.crypto.sr25519 import Sr25519PrivKey

    below, above, i = [], [], 0
    addr = ours.pub_key().address()
    while len(below) < CS_OURS_AT - 1 or len(above) < n - CS_OURS_AT:
        k = Sr25519PrivKey.from_secret(b"sr-%d" % i)
        (below if k.pub_key().address() < addr else above).append(k)
        i += 1
    return [ours] + below[:CS_OURS_AT - 1] + above[:n - CS_OURS_AT], i


def kt_multisig(card):
    """BASELINE config #3's multisig on the host: a 2-of-3
    PubKeyMultisigThreshold over sr25519 sub-keys, valid, below threshold
    and at a wrong position; and its vote, which the 96-byte signature cap
    refuses."""
    from tendermint_tpu_torch.crypto.multisig import (MultisigThresholdPubKey,
                                                      build_multisig_signature)
    from tendermint_tpu_torch.crypto.sr25519 import Sr25519PrivKey
    from tendermint_tpu_torch.libs.bitarray import BitArray
    from tendermint_tpu_torch.types.block import BlockID, PartSetHeader
    from tendermint_tpu_torch.types.canonical import PRECOMMIT_TYPE
    from tendermint_tpu_torch.types.params import MAX_SIGNATURE_SIZE
    from tendermint_tpu_torch.types.vote import Vote

    subs = [Sr25519PrivKey.from_secret(b"ms-%d" % i) for i in range(3)]
    pub = MultisigThresholdPubKey(2, [k.pub_key() for k in subs])
    vote = Vote(PRECOMMIT_TYPE, 1, 0, BlockID(b"\x33" * 32, PartSetHeader(1, b"\x44" * 32)),
                LITE_T0, pub.address(), 0)
    msg = vote.sign_bytes(CHAIN_ID)
    s = [k.sign(msg) for k in subs]

    def sig(signed, sigs):
        bits = BitArray(3)
        for i in signed:
            bits.set_index(i, True)
        return build_multisig_signature(bits, sigs)

    t0 = time.perf_counter()
    got = {name: pub.verify(msg, sig(signed, sigs)) for name, signed, sigs in (
        ("valid", [0, 2], [s[0], s[2]]), ("below threshold", [1], [s[1]]),
        ("wrong position", [0, 1], [s[0], s[2]]))}
    ms = _ms(t0)
    if got != {"valid": True, "below threshold": False, "wrong position": False}:
        raise AssertionError(f"the 2-of-3 multisig gave {got}")
    vote.signature = sig([0, 2], [s[0], s[2]])
    try:
        vote.validate_basic()
        raise AssertionError("a 2-of-3 multisig vote passed the signature cap")
    except ValueError as e:
        refused = str(e)
    log(f"  (a) multisig: a 2-of-3 PubKeyMultisigThreshold over sr25519 sub-keys verifies {got} "
        f"on the host in {ms:.3f} ms; a multisig validator cannot sign in this chain: its "
        f"{len(vote.signature)}-byte signature is over MAX_SIGNATURE_SIZE {MAX_SIGNATURE_SIZE} "
        f"and Vote.validate_basic refuses it ('{refused}'), as in the JAX package ({card})")


def phase_sr_chain(card, dev):
    """Phase 19 (a) (see the module docstring, 19).  Returns the launches
    from the node's start on, the node's own, the part's seconds and its
    host verifies by key type."""
    import tempfile

    import numpy as np

    t_start = time.perf_counter()
    root = tempfile.TemporaryDirectory(prefix="chip-smoke-sr-")
    try:
        t0 = time.perf_counter()
        home, ours, tries = kt_init(root.name)
        init_ms = _ms(t0)
        t0 = time.perf_counter()
        keys, derived = kt_sr_keys(ours, KT_SR_VALIDATORS)
        log(f"  (a) init --key-type sr25519: {tries} home(s) in {init_ms:.3f} ms, our key "
            f"{ours.pub_key().address().hex()[:12]}; the other {KT_SR_VALIDATORS - 1} sr25519 "
            f"keys chosen of {derived} derived in {_ms(t0):.3f} ms ({card})")
        rng = np.random.default_rng(19)
        bursts = {h: [b"sr%d-%d=" % (h, i) + rng.bytes(16).hex().encode()
                      for i in range(KT_SR_TXS)] for h in range(1, CS_HEIGHTS + 1)}
        commits = {}

        def inspect(node):
            for h in range(1, CS_HEIGHTS + 1):
                commit = (node.block_store.load_block(h + 1).last_commit if h < CS_HEIGHTS
                          else node.block_store.load_seen_commit(h))
                commits[h] = (node.state_store.load_validators(h), commit)

        before = launch_counts()
        with KeyTimer() as kt:
            t0 = time.perf_counter()
            out = phase_consensus(keys, card, dev, traffic=(bursts, set()), home=home,
                                  inspect=inspect)
            log(f"  (a) heights 1-{CS_HEIGHTS} on sr25519 keys in {time.perf_counter() - t0:.3f} "
                f"s; host verifies: {kt.line()} ({card})")
            for h, (vals, commit) in commits.items():
                if {type(v.pub_key).__name__ for v in vals.validators} != {"Sr25519PubKey"}:
                    raise AssertionError(f"height {h}'s set is not all sr25519")
                n = sum(not cs.is_absent() for cs in commit.signatures)
                t0 = time.perf_counter()
                vals.verify_commit(CHAIN_ID, commit.block_id, h, commit)
                t1 = time.perf_counter()
                vals.verify_commit_trusting(CHAIN_ID, commit.block_id, h, commit, 1, 3)
                log(f"    (a) height {h}'s commit of {n} sr25519 signatures: verify_commit "
                    f"{(t1 - t0) * 1000:.3f} ms, verify_commit_trusting at 1/3 {_ms(t1):.3f} ms "
                    f"({card})")
        launches = {k: v - before[k] for k, v in launch_counts().items()}
        kt_multisig(card)
        return {"launches": launches, "node": out["launches"], "s": time.perf_counter() - t_start,
                "host_ms": dict(kt.ms), "verifies": dict(kt.n)}
    finally:
        root.cleanup()


def kt_mixed_set(keys, commit):
    """Phase 3's set with its first KT_MIX_SR + KT_MIX_SECP + KT_MIX_BLS
    keys replaced by sr25519, secp256k1 and bls12381 keys, and its full
    commit: phase 3's signature for every ed25519 member (its CommitSig,
    timestamp and all), a fresh one for each new member (a BLS member's
    over the timestamp-free layout).  Returns the set, the commit, the
    members' indices by key type and the BLS keys."""
    import hashlib

    from tendermint_tpu_torch.crypto.bls.keys import BlsPrivKey
    from tendermint_tpu_torch.crypto.keys import Secp256k1PrivKey
    from tendermint_tpu_torch.crypto.sr25519 import Sr25519PrivKey
    from tendermint_tpu_torch.types.block import Commit
    from tendermint_tpu_torch.types.canonical import PRECOMMIT_TYPE
    from tendermint_tpu_torch.types.validator import Validator, ValidatorSet
    from tendermint_tpu_torch.types.vote import Vote

    bls = [BlsPrivKey.from_secret(b"mix-bls-%d" % i) for i in range(KT_MIX_BLS)]
    new = ([Sr25519PrivKey.from_secret(b"mix-sr-%d" % i) for i in range(KT_MIX_SR)]
           + [Secp256k1PrivKey(hashlib.sha256(b"mix-secp-%d" % i).digest())
              for i in range(KT_MIX_SECP)] + bls)
    mset = ValidatorSet([Validator.new(k.pub_key(), 10) for k in keys[len(new):] + new])
    old = {cs.validator_address: cs for cs in commit.signatures}
    signer = {k.pub_key().address(): k for k in new}
    sigs, idx = [], collections.defaultdict(list)
    for i, v in enumerate(mset.validators):
        idx[type(v.pub_key).__name__].append(i)
        if v.address in old:
            sigs.append(old[v.address])
            continue
        vote = Vote(PRECOMMIT_TYPE, commit.height, 0, commit.block_id, LITE_T0 + i, v.address, i)
        vote.signature = signer[v.address].sign(vote.sign_bytes_for_key(CHAIN_ID, v.pub_key))
        sigs.append(vote.commit_sig())
    return mset, Commit(commit.height, 0, commit.block_id, sigs), idx, bls


def phase_mixed(keys, commit, card, dev):
    """Phase 19 (b) (see the module docstring, 19).  Returns each check's
    launches, dispatches, ms and host verify ms, the flat batch's size and
    the part's seconds."""
    import dataclasses

    from tendermint_tpu_torch.crypto import backend
    from tendermint_tpu_torch.crypto import batch as batch_hook
    from tendermint_tpu_torch.crypto import batch_verifier as bvm
    from tendermint_tpu_torch.libs.tracing import FlightRecorder
    from tendermint_tpu_torch.types.block import Commit, CommitSig

    from tendermint_tpu_torch.crypto.bls import scheme as bls_scheme

    t_start = time.perf_counter()
    mset, full, idx, bls = kt_mixed_set(keys, commit)
    n_ed = len(idx["Ed25519PubKey"])
    log(f"  (b) a mixed set of {mset.size()}: {n_ed} ed25519 (phase 3's keys and signatures), "
        f"{len(idx['Sr25519PubKey'])} sr25519, {len(idx['Secp256k1PubKey'])} secp256k1, "
        f"{len(idx['BlsPubKey'])} bls12381; keys and the new members' signatures in "
        f"{(time.perf_counter() - t_start) * 1000:.3f} ms ({card})")
    t0 = time.perf_counter()
    pops = [(k.pub_key().bytes(), k.pop()) for k in bls]
    t1 = time.perf_counter()
    if not bls_scheme.batch_pop_verify(pops):
        raise AssertionError("the mixed set's bls12381 proofs of possession failed their batch")
    log(f"    (b) the {len(pops)} bls12381 members' proofs of possession: made in "
        f"{(t1 - t0) * 1000:.3f} ms, one batch_pop_verify on the {bls_scheme.active_tier()} "
        f"tier {_ms(t1):.3f} ms ({card})")
    rec = FlightRecorder(size=1 << 12)
    bv = bvm.BatchVerifier(device=dev, recorder=rec).install()
    bvm.TableCache(bv, tabulated=None).install()
    # the process's kernel verdict was last timed at an earlier phase's set
    # size; drop it, as TableCache.rebuild does on a size change, so that
    # the mixed set's first indexed check profiles at its own size
    bvm.invalidate_tabulated_profile()
    bid, height = full.block_id, full.height
    out = {"checks": {}, "n_ed": n_ed}

    def check(name, fn, want_error=None):
        """One check: its launches, verify.dispatch events, ms and host
        verifies, logged and kept under `name`."""
        seq, before = next_seq(rec), launch_counts()
        with KeyTimer() as kt:
            t0 = time.perf_counter()
            try:
                fn()
                err = None
            except ValueError as e:
                err = str(e)
            ms = _ms(t0)
        if (err is None) != (want_error is None) or (err and not err.startswith(want_error)):
            raise AssertionError(f"(b) {name}: want {want_error!r}, got {err!r}")
        d = rec.events(since=seq, kinds=["verify.dispatch"])
        launches = {k: v - before[k] for k, v in launch_counts().items()}
        paths = [(e["path"], e["n"]) for e in d]
        log(f"    (b) {name}: {ms:.3f} ms{'; raised ' + repr(err[:32] + '...') if err else ''}; "
            f"dispatches {paths}, host_prep {sum(e['host_prep_ms'] for e in d):.3f} ms, device "
            f"{sum(e['device_ms'] for e in d):.3f} ms; host verifies: {kt.line()}; launches "
            f"{launches} ({card})")
        out["checks"][name] = {"launches": launches, "paths": paths, "ms": ms,
                               "host_ms": dict(kt.ms)}
        return paths

    def tampered(i, fix):
        sigs = list(full.signatures)
        sigs[i] = dataclasses.replace(sigs[i], signature=fix(sigs[i].signature))
        return Commit(height, 0, bid, sigs)

    def flip(sig):
        return bytes([sig[0] ^ 1]) + sig[1:]

    def flip_last(sig):
        return sig[:-1] + bytes([sig[-1] ^ 1])

    def high_s(sig):
        return sig[:32] + (backend.SECP_N - int.from_bytes(sig[32:], "big")).to_bytes(32, "big")

    try:
        paths = check("1 full commit, verify_commit",
                      lambda: mset.verify_commit(CHAIN_ID, bid, height, full))
        if paths != [("device", n_ed)]:
            raise AssertionError(f"the full mixed commit's dispatches were {paths}, not one flat "
                                 f"ladder batch of the {n_ed} ed25519 signatures")
        out["flat_n"] = paths[0][1]
        for kind, at, fix in (("ed25519", idx["Ed25519PubKey"][n_ed // 2], flip),
                              ("sr25519", idx["Sr25519PubKey"][-1], flip),
                              ("secp256k1", idx["Secp256k1PubKey"][0], flip),
                              ("secp256k1 high-S", idx["Secp256k1PubKey"][-1], high_s),
                              ("bls12381", idx["BlsPubKey"][len(bls) // 2], flip_last)):
            bad = tampered(at, fix)
            check(f"1 one {kind} signature bad at #{at}",
                  lambda: mset.verify_commit(CHAIN_ID, bid, height, bad),
                  want_error=f"wrong signature (#{at})")
        ed = set(idx["Ed25519PubKey"])
        ed_only = Commit(height, 0, bid, [cs if i in ed else CommitSig.absent()
                                         for i, cs in enumerate(full.signatures)])
        for run in ("cold", "warm"):
            paths = check(f"2 the ed25519 members' commit, verify_commit ({run} table)",
                          lambda: mset.verify_commit(CHAIN_ID, bid, height, ed_only))
            if len(paths) != 1 or paths[0][0] not in ("tabulated", "indexed", "chunked"):
                raise AssertionError(f"the ed25519 members' commit did not take the indexed "
                                     f"path alone: {paths}")
        prof = rec.events(kinds=["verify.tabulated_profile"])
        if dev.type == "cuda":
            if len(prof) != 1 or prof[0]["validators"] != mset.size():
                raise AssertionError(f"the mixed set was not profiled once at its size: {prof}")
            out["engaged"] = prof[0]["engaged"]
            if (paths[0][0] == "tabulated") != out["engaged"]:
                raise AssertionError(f"the profile engaged {out['engaged']}, the warm check took "
                                     f"{paths[0][0]}")
            log(f"    (b) the mixed set's profile: tabulated {prof[0]['tab_ms']} ms, ladder "
                f"{prof[0]['ladder_ms']} ms, engaged {out['engaged']}; its tables (kernel 2) "
                f"{prof[0]['table_build_ms']} ms ({card})")
        paths = check("3 verify_commit_trusting at 1/3 (lite2's call)",
                      lambda: mset.verify_commit_trusting(CHAIN_ID, bid, height, full, 1, 3))
        if paths != [("device", n_ed)]:
            raise AssertionError(f"verify_commit_trusting's dispatches were {paths}, not one "
                                 f"flat ladder batch of {n_ed}")
    finally:
        batch_hook.set_verifier(None)
        batch_hook.set_indexed_verifier(None)
    out["s"] = time.perf_counter() - t_start
    return out


def run_mixed(keys, commit, card, dev, report):
    """Phase 19 (b) with its launch checks, its launches added to `report`."""
    log("[19] (b) the other key types on the card: a mixed 10,000-validator set of ed25519, "
        "sr25519, secp256k1 and bls12381 keys (beside it, each in a process of its own: "
        "19 (a), 20 and 21)")
    launch_counts(zero=True)
    b = phase_mixed(keys, commit, card, dev)
    counts = launch_counts()
    checks = b["checks"]
    log(f"  launches in phase 19 (b): {counts}; (b) took {b['s']:.3f} s ({card})")
    full = checks["1 full commit, verify_commit"]["launches"]
    if full["ed25519_ladder"] != 1 or full["ed25519_tabulated"] or full["ed25519_window_tables"]:
        raise AssertionError(f"the full mixed commit did not launch the ladder alone, once: {full}")
    cold = checks["2 the ed25519 members' commit, verify_commit (cold table)"]["launches"]
    warm = checks["2 the ed25519 members' commit, verify_commit (warm table)"]["launches"]
    pick = "ed25519_tabulated" if b["engaged"] else "ed25519_ladder"
    other = "ed25519_ladder" if b["engaged"] else "ed25519_tabulated"
    if cold["ed25519_window_tables"] != 1 or warm[pick] == 0 or warm[other]:
        raise AssertionError(f"the ed25519 members' commit was not served by kernel 2's tables "
                             f"and the mixed set's pick ({pick}): cold {cold}, warm {warm}")
    for name, c in counts.items():
        report[name]["launches"] += c


def check_sr_chain(a, card):
    """Phase 19 (a)'s launch check, on child_phase's result."""
    log(f"  (a) launches from the node's start on, in its process: {a['launches']} (the node's "
        f"run alone: {a['node']}); kernel 2 builds nothing: verify_commit consults the "
        f"TableCache only for a commit whose signers are all ed25519, and no vote of this "
        f"chain reaches the engine's lane; (a) took {a['s']:.3f} s ({card})")
    if a["launches"]["ed25519_ladder"] or a["launches"]["ed25519_tabulated"]:
        raise AssertionError(f"phase 19 (a) launched a verify kernel: {a['launches']}")


def kt_bls_keys(ours, n, n_bls):
    """n keys holding `ours` (a bls12381 key), n_bls of them bls12381 and
    the rest ed25519, such that ours is the round-0 proposer of CS_OURS_AT
    at power 10 each (the CS_OURS_AT-th lowest address): seeded keys of
    each type, CS_OURS_AT - 1 of them below ours and the rest above (the
    last ed25519 slots wait for a key below while one is still missing).
    Returns them and the keys derived."""
    from tendermint_tpu_torch.crypto.bls.keys import BlsPrivKey
    from tendermint_tpu_torch.crypto.keys import Ed25519PrivKey

    addr = ours.pub_key().address()
    below, above, derived = [], [], 0
    need = {"bls": n_bls - 1, "ed": n - n_bls}
    make = {"bls": lambda i: BlsPrivKey.from_secret(b"p20-bls-%d" % i),
            "ed": lambda i: Ed25519PrivKey.from_secret(b"p20-ed-%d" % i)}
    for kind in ("bls", "ed"):
        i = 0
        while need[kind]:
            k = make[kind](i)
            i, derived = i + 1, derived + 1
            missing = CS_OURS_AT - 1 - len(below)
            if k.pub_key().address() < addr:
                if not missing:
                    continue
                below.append(k)
            elif kind == "ed" and need[kind] <= missing:
                continue
            else:
                above.append(k)
            need[kind] -= 1
    return [ours] + below + above, derived


def phase_bls_chain(card, dev):
    """Phase 20 (see the module docstring, 20).  Returns the launches from
    the node's start on, the node's own, the part's seconds, the host
    verifies by key type and the commit checks' flat batches."""
    import tempfile

    import numpy as np

    from tendermint_tpu_torch.crypto import batch as batch_hook
    from tendermint_tpu_torch.crypto import batch_verifier as bvm
    from tendermint_tpu_torch.crypto.bls import scheme as bls_scheme
    from tendermint_tpu_torch.libs.tracing import FlightRecorder
    from tendermint_tpu_torch.types.block import Commit
    from tendermint_tpu_torch.types.genesis import GenesisDoc

    t_start = time.perf_counter()
    root = tempfile.TemporaryDirectory(prefix="chip-smoke-bls-")
    try:
        t0 = time.perf_counter()
        home, ours, tries = kt_init(root.name, "bls12381")
        init_ms = _ms(t0)
        # init's genesis: its one validator, ours, carries its proof of possession
        init_gen = GenesisDoc.from_file(os.path.join(home, "config", "genesis.json"))
        entry = init_gen.validators[0]
        if (entry.pub_key != ours.pub_key() or entry.pop != ours.pop()
                or not bls_scheme.pop_verify(ours.pub_key().bytes(), entry.pop)):
            raise AssertionError("init --key-type bls12381 wrote no valid proof of possession "
                                 "for its key into genesis.json")
        t0 = time.perf_counter()
        keys, derived = kt_bls_keys(ours, BLS_VALIDATORS, BLS_MEMBERS)
        kinds = collections.Counter(type(k).__name__ for k in keys)
        log(f"  init --key-type bls12381: {tries} home(s) in {init_ms:.3f} ms, our key "
            f"{ours.pub_key().address().hex()[:12]} with its proof of possession in "
            f"genesis.json; the other {BLS_VALIDATORS - 1} keys chosen of {derived} derived in "
            f"{_ms(t0):.3f} ms: {dict(kinds)}; BLS tier {bls_scheme.active_tier()} ({card})")
        rng = np.random.default_rng(20)
        bursts = {h: [b"bls%d-%d=" % (h, i) + rng.bytes(16).hex().encode()
                      for i in range(BLS_TXS)] for h in range(1, CS_HEIGHTS + 1)}
        commits = {}

        def inspect(node):
            for h in range(1, CS_HEIGHTS + 1):
                commit = (node.block_store.load_block(h + 1).last_commit if h < CS_HEIGHTS
                          else node.block_store.load_seen_commit(h))
                commits[h] = (node.state_store.load_validators(h), commit,
                              node.block_store.load_block_commit(h),
                              node.block_store.load_seen_commit(h))

        before = launch_counts()
        with KeyTimer() as kt:
            t0 = time.perf_counter()
            out = phase_consensus(keys, card, dev, traffic=(bursts, set()), home=home,
                                  inspect=inspect)
            run_s = time.perf_counter() - t0
            node_line = kt.line()
        log(f"  heights 1-{CS_HEIGHTS} on the mixed set in {run_s:.3f} s, [consensus] "
            f"bls_aggregate_commits at its default (true); host verifies: {node_line} ({card})")
        rec = FlightRecorder(size=1 << 10)
        bvm.BatchVerifier(device=dev, recorder=rec).install()
        flat = []
        try:
            with KeyTimer() as kt2:
                for h, (vals, commit, block_commit, seen) in commits.items():
                    for c in (commit, block_commit, seen):
                        if c is not None and type(c) is not Commit:
                            raise AssertionError(f"height {h} stored a {type(c).__name__}, not "
                                                 "a per-vote Commit")
                    types = collections.Counter(type(v.pub_key).__name__ for v in vals.validators)
                    if types != {"BlsPubKey": BLS_MEMBERS,
                                 "Ed25519PubKey": BLS_VALIDATORS - BLS_MEMBERS}:
                        raise AssertionError(f"height {h}'s set is {dict(types)}")
                    signed = [i for i, cs in enumerate(commit.signatures) if not cs.is_absent()]
                    n_ed = sum(type(vals.validators[i].pub_key).__name__ == "Ed25519PubKey"
                               for i in signed)
                    seq = next_seq(rec)
                    t0 = time.perf_counter()
                    vals.verify_commit(CHAIN_ID, commit.block_id, h, commit)
                    t1 = time.perf_counter()
                    vals.verify_commit_trusting(CHAIN_ID, commit.block_id, h, commit, 1, 3)
                    t2 = time.perf_counter()
                    paths = [(e["path"], e["n"])
                             for e in rec.events(since=seq, kinds=["verify.dispatch"])]
                    if paths != [("device", n_ed)] * 2:
                        raise AssertionError(f"height {h}'s commit checks dispatched {paths}, not "
                                             f"one flat ladder batch of its {n_ed} ed25519 "
                                             "signatures each")
                    flat.append(n_ed)
                    log(f"    height {h}'s commit: {len(signed)} signatures ({n_ed} ed25519, "
                        f"{len(signed) - n_ed} bls12381); verify_commit {(t1 - t0) * 1000:.3f} "
                        f"ms, verify_commit_trusting at 1/3 {(t2 - t1) * 1000:.3f} ms, each one "
                        f"flat ladder batch of {n_ed} ({card})")
            log(f"  the commits' checks: host verifies {kt2.line()} ({card})")
        finally:
            batch_hook.set_verifier(None)
        launches = {k: v - before[k] for k, v in launch_counts().items()}
        return {"launches": launches, "node": out["launches"], "s": time.perf_counter() - t_start,
                "run_s": run_s, "host_ms": dict(kt.ms), "verifies": dict(kt.n), "flat": flat,
                "frames": out["frames"]}
    finally:
        root.cleanup()


def bn_check_commit(commit: dict, n_vals: int) -> None:
    """networks/local/bls_smoke.py's check_commit on a `/commit` answer's
    commit: the aggregate representation, a 96-byte `agg_sig` and a
    `signers` bitmap over the set holding more than 2/3 of it, and no
    per-vote `signatures`."""
    import base64

    if "signatures" in commit:
        raise AssertionError(f"commit at height {commit.get('height')} carries per-vote "
                             "signatures: aggregation did not engage")
    sig, signers = (base64.b64decode(commit.get(k, {}).get("@b", ""))
                    for k in ("agg_sig", "signers"))
    if len(sig) != 96:
        raise AssertionError(f"bad agg_sig in commit: {commit}")
    nbits = int.from_bytes(signers[:4], "big")  # BitArray: 4-byte bit count + the bits
    popcount = sum(bin(b).count("1") for b in signers[4:])
    if nbits != n_vals or popcount * 3 <= n_vals * 2:
        raise AssertionError(f"signer bitmap {popcount}/{nbits} below +2/3 of {n_vals}")


def bn_commit_bytes(node) -> tuple:
    """The stored bytes (the block store's codec) of one height's commit
    both ways: the seen AggregateCommit the node stored, and the per-vote
    Commit of the same precommits, made from the node's LastCommit vote
    set.  Returns (height, aggregate bytes, per-vote bytes)."""
    from tendermint_tpu_torch.encoding import codec
    from tendermint_tpu_torch.types.agg_commit import AggregateCommit

    last = node.consensus.rs.last_commit
    per_vote = last.make_commit()
    agg = node.block_store.load_seen_commit(last.height)
    if not isinstance(agg, AggregateCommit) or per_vote.height != agg.height:
        raise AssertionError(f"phase 21: no aggregate seen commit beside the LastCommit of "
                             f"height {last.height}: {agg!r}")
    return last.height, len(codec.dumps(agg)), len(codec.dumps(per_vote))


def bn_get(url) -> dict:
    import urllib.request

    with urllib.request.urlopen(url, timeout=10) as r:
        return json.load(r)


def phase_bls_net(card, dev):
    """Phase 21 (see the module docstring, 21); returns its numbers."""
    import asyncio

    return asyncio.run(bn_run(card, dev))


def bn_folded(node, below, n_vals):
    """Every stored block commit and seen commit of `node` below `below`
    is an AggregateCommit over n_vals signer slots holding more than 2/3."""
    from tendermint_tpu_torch.types.agg_commit import AggregateCommit

    for h in range(1, below):
        for c in (node.block_store.load_block_commit(h), node.block_store.load_seen_commit(h)):
            if not isinstance(c, AggregateCommit) or c.signers.bits != n_vals \
                    or c.signers.count() * 3 <= n_vals * 2:
                raise AssertionError(f"phase 21: height {h} stored {c!r}, not an aggregate "
                                     f"commit of more than 2/3 of {n_vals}")


async def bn_run(card, dev):
    import asyncio
    import tempfile

    from tendermint_tpu_torch import cli
    from tendermint_tpu_torch.config import load_config
    from tendermint_tpu_torch.crypto import batch as batch_hook
    from tendermint_tpu_torch.crypto.bls import scheme as bls_scheme
    from tendermint_tpu_torch.fastsync import reactor as fs_reactor
    from tendermint_tpu_torch.fastsync import verify_commit_run
    from tendermint_tpu_torch.node import Node, default_new_node
    from tendermint_tpu_torch.types.agg_commit import AggregateLastCommit
    from tendermint_tpu_torch.types.block import BlockID
    from tendermint_tpu_torch.types.params import BLOCK_PART_SIZE_BYTES
    from tendermint_tpu_torch.types.priv_validator import MockPV

    def say(msg):
        log(f"  [21] {msg}")

    def addr(node):
        return f"{node.node_key.id}@{node.switch.transport.listen_addr}"

    out, parts = {}, {}
    t_start = time.perf_counter()
    n = BN_VALIDATORS
    switch_interval = fs_reactor.SWITCH_TO_CONSENSUS_INTERVAL
    nodes, joiners = [], []
    with tempfile.TemporaryDirectory(prefix="phase21-") as tmp, KeyTimer() as kt:
        try:
            # the net: testnet's homes at their default config, on the card
            t = time.perf_counter()
            base = ch_base_port()
            with contextlib.redirect_stdout(io.StringIO()):
                rc = cli.main(["testnet", "--validators", str(n), "--output", tmp,
                               "--base-port", str(base), "--key-type", "bls12381",
                               "--chain-id", "bls-net"])
            if rc != 0:
                raise AssertionError(f"testnet --key-type bls12381 exited {rc}")
            cfgs = [load_config(os.path.join(tmp, f"node{i}", "config", "config.toml"),
                                home=os.path.join(tmp, f"node{i}")) for i in range(n)]
            if not all(c.consensus.bls_aggregate_commits and c.tpu.enabled for c in cfgs):
                raise AssertionError("testnet --key-type bls12381 turned aggregation or the "
                                     "engine off")
            nodes = [default_new_node(c, device=dev) for c in cfgs]
            gen = nodes[0].genesis_doc
            for node in nodes:
                await node.start()
            await rt_wait(lambda: all(x.block_store.height() >= BN_HEIGHTS for x in nodes),
                          BN_BUDGET_S, f"{n} validators at height {BN_HEIGHTS}", nodes=nodes,
                          phase="21")
            parts["net"] = time.perf_counter() - t
            # every stored commit below the tip folds, on every node and on /commit
            t = time.perf_counter()
            checked = 0
            for i, node in enumerate(nodes):
                tip = node.block_store.height()
                bn_folded(node, tip, n)
                for h in range(1, tip):
                    url = f"http://127.0.0.1:{base + 10 * i + 1}/commit?height={h}"
                    answer = await asyncio.to_thread(bn_get, url)  # the RPC runs on this loop
                    bn_check_commit(answer["result"]["signed_header"]["commit"], n)
                    checked += 1
            h_bytes, out["commit_bytes"], out["per_vote_bytes"] = bn_commit_bytes(nodes[0])
            parts["commits"] = time.perf_counter() - t
            say(f"{n} validators from testnet --key-type bls12381 at heights "
                f"{[x.block_store.height() for x in nodes]} in {parts['net']:.3f} s; "
                f"{checked} commits below the tips aggregate on every node and on /commit "
                f"(block and seen commits); height {h_bytes}'s commit stores in "
                f"{out['commit_bytes']} bytes against {out['per_vote_bytes']} per vote; "
                f"BLS tier {bls_scheme.active_tier()} ({card})")

            # the joiners: catch-up (fast sync off) and fast sync, both empty
            # non-validators; the fast-sync one stays behind the gate (as in
            # phase 18 (b)'s start) until it has the validators' heights
            t = time.perf_counter()
            fs_reactor.SWITCH_TO_CONSENSUS_INTERVAL = 3600.0
            for name, fast_sync in (("catchup", False), ("fastsync", True)):
                home = os.path.join(tmp, name)
                cfg = load_config(os.path.join(tmp, "node0", "config", "config.toml"), home=home)
                cfg.base.fast_sync = fast_sync
                cfg.base.db_backend = "memdb"
                cfg.p2p.laddr = "tcp://127.0.0.1:0"
                cfg.p2p.persistent_peers = ""
                cfg.p2p.pex = False
                cfg.rpc.laddr = ""
                cfg.ensure_dirs()
                joiners.append(Node(cfg, gen, priv_validator=MockPV(), db_backend="memdb",
                                    device=dev))
            for j in joiners:
                await j.start()
                await asyncio.gather(*(j.switch.dial_peer(addr(node)) for node in nodes))
            target = min(x.block_store.height() for x in nodes)
            await rt_wait(lambda: all(j.block_store.height() >= target for j in joiners),
                          BN_BUDGET_S, f"the joiners at height {target}", nodes=nodes + joiners,
                          phase="21")
            fs_reactor.SWITCH_TO_CONSENSUS_INTERVAL = switch_interval
            parts["joiners"] = time.perf_counter() - t
            catchup, fast = joiners
            for j in joiners:
                bn_folded(j, target - 1, n)
            lanes = sum(e["kind"] == "commit.agg_catchup" for e in catchup.flight_recorder.events())
            if not lanes:
                raise AssertionError("phase 21: the catch-up joiner took no agg_commit frame")
            synced = fast.blockchain_reactor.blocks_synced
            if synced != fast.block_store.height():
                raise AssertionError(f"phase 21: the fast-sync joiner synced {synced} of its "
                                     f"{fast.block_store.height()} blocks")
            # the fast-sync joiner's stored commits as one run: one pairing product
            t = time.perf_counter()
            vals = fast.state_store.load_validators(1)
            pairs = []
            for h in range(1, target - 1):
                block = fast.block_store.load_block(h)
                pairs.append((BlockID(block.hash(),
                                      block.make_part_set(BLOCK_PART_SIZE_BYTES).header()),
                              h, fast.block_store.load_block_commit(h)))
            runs = kt.n["batch_verify_aggregates"]
            bls_scheme._memo.clear()  # so that the run pays its pairing product
            verdicts = verify_commit_run(vals, gen.chain_id, pairs)
            if verdicts != [True] * len(pairs) or kt.n["batch_verify_aggregates"] != runs + 1:
                raise AssertionError(f"phase 21: verify_commit_run over the fast-sync joiner's "
                                     f"{len(pairs)} aggregate commits gave {verdicts}")
            out["run_ms"] = _ms(t)
            say(f"catch-up joiner (fast sync off) at {catchup.block_store.height()} through "
                f"{lanes} agg_commit catch-ups, fast-sync joiner at {fast.block_store.height()} "
                f"({synced} blocks synced) in {parts['joiners']:.3f} s; verify_commit_run over "
                f"its {len(pairs)} aggregate commits in one pairing product "
                f"{out['run_ms']:.3f} ms ({card})")

            # a validator restarts and rebuilds its AggregateLastCommit
            t = time.perf_counter()
            await nodes[-1].stop()
            stopped_at = nodes[-1].block_store.height()
            nodes[-1] = default_new_node(cfgs[-1], device=dev)
            await nodes[-1].start()
            if not isinstance(nodes[-1].consensus.rs.last_commit, AggregateLastCommit):
                raise AssertionError(f"phase 21: the restarted validator holds "
                                     f"{nodes[-1].consensus.rs.last_commit!r}")
            await rt_wait(lambda: nodes[-1].block_store.height() >= stopped_at + 2,
                          BN_BUDGET_S, "the restarted validator committing again", nodes=nodes,
                          phase="21")
            bn_folded(nodes[-1], stopped_at + 1, n)
            parts["restart"] = time.perf_counter() - t
            say(f"validator {n - 1} stopped at {stopped_at}, restarted with its "
                f"AggregateLastCommit and at {nodes[-1].block_store.height()} in "
                f"{parts['restart']:.3f} s ({card})")
        finally:
            fs_reactor.SWITCH_TO_CONSENSUS_INTERVAL = switch_interval
            stopping = [x for x in nodes + joiners if x.is_running]
            await asyncio.gather(*(x.stop() for x in stopping), return_exceptions=True)
            batch_hook.set_verifier(None)
            batch_hook.set_indexed_verifier(None)
    out.update(parts=parts, checked=checked, s=time.perf_counter() - t_start,
               host_ms=dict(kt.ms), verifies=dict(kt.n))
    say(f"host BLS work: {kt.line()}; parts {', '.join(f'{k} {v:.3f} s' for k, v in parts.items())}; "
        f"phase 21 took {out['s']:.3f} s ({card})")
    return out


CHILD_RESULT = "phase-child-result "  # the prefix of a PhaseChild's result line


class PhaseChild:
    """A phase run in a process of its own, beside what this process runs
    meanwhile: `python -c` imports this script and calls `fn_name(*args)`,
    which runs the phase on the card with that process's own launch
    counters and returns a JSON-able result.  Its output is logged here as
    it comes, each line tagged; join() waits, re-raises its failure and
    returns its result."""

    def __init__(self, tag, fn_name, *args):
        code = ("import json, sys; sys.path.insert(0, sys.argv[1]); import chip_smoke as cs; "
                f"print(cs.CHILD_RESULT + json.dumps(cs.{fn_name}(*json.loads(sys.argv[2]))), "
                "flush=True)")
        self.tag, self.result, self.tail = tag, None, collections.deque(maxlen=40)
        self.t0 = time.perf_counter()
        self.proc = subprocess.Popen([sys.executable, "-c", code, HERE, json.dumps(args)],
                                     stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                     text=True, env=child_env(), cwd=HERE)
        self.reader = threading.Thread(target=self._read, name=f"phase {tag} output",
                                       daemon=True)
        self.reader.start()

    def _read(self):
        for line in self.proc.stdout:
            line = line.rstrip("\n")
            if line.startswith(CHILD_RESULT):
                self.result = json.loads(line[len(CHILD_RESULT):])
            else:
                self.tail.append(line)
                log(f"[{self.tag}] {line}")
        self.s = time.perf_counter() - self.t0  # to the end of its output: its exit

    def join(self, timeout=900):
        try:
            rc = self.proc.wait(timeout)
        finally:
            if self.proc.poll() is None:
                self.proc.kill()
                self.proc.wait()
        self.reader.join()
        if rc != 0 or self.result is None:
            raise AssertionError(f"phase {self.tag} in its own process exited {rc}: "
                                 + "\n".join(self.tail))
        log(f"  phase {self.tag} took {self.s:.3f} s in its own process, beside")
        return self.result


def child_phase(name, card, picked=None, device="cuda", sizes=None, ms=None):
    """A PhaseChild's entry point: the kernel library (built by phase 1 of
    the parent run) loaded, then phases 6-8 (one after another), 14,
    18 (a), 19 (a), 20, 21 or 22 on `device` (the card; the CPU to
    rehearse, with `sizes` overriding this module's size constants).
    `picked` is the parent's auto-profile pick, for a process that has
    profiled nothing yet; `ms` phase 4's kernel times, for phase 6's saving
    line.  Returns the phase's launches (by phase for 6-8; and 19 (a)'s
    numbers; for 22 phase_fold's result)."""
    import torch

    from tendermint_tpu_torch.ops import _build

    globals().update(sizes or {})
    dev = torch.device(device)
    if dev.type == "cuda":
        _build.lib()
    report = {k: {"launches": 0, **({"ms": ms[k]} if k in (ms or {}) else {})}
              for k in launch_counts()}
    if name == "6 7 8":
        keys = make_keys(N_VALIDATORS)
        for run in (run_light, run_replay, run_abci):
            run(keys, card, dev, picked, report)
        return {k: {p: r[p] for p in ("6", "7", "8")} for k, r in report.items()}
    elif name == "14":
        run_boundary(make_keys(N_VALIDATORS), card, dev, picked, report)
    elif name == "18 a":
        run_staking(make_keys(N_VALIDATORS), card, dev, picked, report)
    elif name == "19 a":
        launch_counts(zero=True)
        a = phase_sr_chain(card, dev)
        return {k: a[k] for k in ("launches", "node", "s", "host_ms", "verifies")}
    elif name == "20":
        run_bls(card, dev, report)
    elif name == "21":
        run_bls_net(card, dev, report)
    elif name == "22":
        # its CPU bursts (10,000 keys signed on SIGN_THREADS threads, the
        # pure tier's decompressions) yield to 18 (b)'s nodes and the
        # other children beside it; its kernel times are CUDA events
        os.nice(10)
        return phase_fold(card, dev)
    else:
        raise ValueError(f"no phase {name!r} runs in a process of its own")
    return {k: r["launches"] for k, r in report.items()}


def run_bls(card, dev, report):
    """Phase 20 with its launch checks, its launches added to `report`."""
    log(f"[20] BLS12-381 keys on a mixed set: {BLS_VALIDATORS} validators ({BLS_MEMBERS} "
        f"bls12381, ours from init --key-type bls12381, the rest ed25519) through the consensus "
        f"core, per-vote commits (a mixed set does not fold)")
    launch_counts(zero=True)
    out = phase_bls_chain(card, dev)
    counts = launch_counts()
    log(f"  launches in phase 20: {counts} (the node's run: {out['node']}); {out['frames']} vote "
        f"frames accepted; phase 20 took {out['s']:.3f} s ({card})")
    if counts["ed25519_ladder"] == 0 or out["node"]["ed25519_ladder"] == 0:
        raise AssertionError(f"the ladder was not launched for phase 20's ed25519 members: "
                             f"{counts}, the node's {out['node']}")
    for name, c in counts.items():
        report[name]["launches"] += c


def run_bls_net(card, dev, report):
    """Phase 21, its launches (none expected: a uniformly BLS set verifies
    on the host) added to `report`."""
    log(f"[21] a uniformly BLS net: {BN_VALIDATORS} validators from testnet --key-type "
        f"bls12381 on the card, aggregate commits, a catch-up and a fast-sync joiner and a "
        f"restart")
    launch_counts(zero=True)
    out = phase_bls_net(card, dev)
    counts = launch_counts()
    log(f"  launches in phase 21: {counts}; phase 21 took {out['s']:.3f} s ({card})")
    for name, c in counts.items():
        report[name]["launches"] += c


def fold_data(n, tag, msg):
    """n BLS12-381 keys from seeds (sha256 of tag-0 .. tag-(n-1)), each
    signing msg, on SIGN_THREADS threads on the C tier: the pubkeys (G1)
    and signatures (G2) as Jacobian ints, decompressed by the C tier, and
    as its blobs; and the keys."""
    import hashlib
    from concurrent.futures import ThreadPoolExecutor

    from tendermint_tpu_torch.crypto.bls import ctier
    from tendermint_tpu_torch.crypto.bls.keys import BlsPrivKey

    ct = ctier.get()

    def one(i):
        key = BlsPrivKey(hashlib.sha256(f"{tag}-{i}".encode()).digest())
        return key, ct.g1_decompress(key.pub_key().bytes()), ct.g2_decompress(key.sign(msg))

    with ThreadPoolExecutor(SIGN_THREADS) as ex:
        made = list(ex.map(one, range(n), chunksize=64))
    g1b, g2b = [m[1] for m in made], [m[2] for m in made]
    return ([ct.g1_point(b) for b in g1b], [ct.g2_point(b) for b in g2b], g1b, g2b,
            [m[0] for m in made])


def fold_group(name):
    """(rows of points, kernel wrapper, output to Jacobian ints, pure add,
    identity, negation, compression) of a fold kernel's group."""
    from tendermint_tpu_torch.crypto.bls import cuda_tier, curve
    from tendermint_tpu_torch.ops import bls12_381_fold as bf

    if name == "bls12_381_fold_g1":
        return (cuda_tier.g1_rows, bf.fold_g1, cuda_tier.g1_point, curve.g1_add, curve.G1_INF,
                curve.g1_neg, curve.g1_compress)
    return (cuda_tier.g2_rows, bf.fold_g2, cuda_tier.g2_point, curve.g2_add, curve.G2_INF,
            curve.g2_neg, curve.g2_compress)


def fold_products(name, adds, doubles) -> int:
    """The partial products of `adds` additions and `doubles` doublings
    (FOLD_MUL_SQR)."""
    mul, sqr = FOLD_MUL_SQR[name]
    return adds * (12 * mul + 4 * sqr) + doubles * (8 * mul + 7 * sqr)


def fold_work(name, pts):
    """The pure tier's fold in the kernels' association (jax_tier._tree:
    the bucket's pairs level by level, the lower index on the left) and
    the work the data needs: (sum, additions, doublings), where an
    addition is a pair of two finite points that differ and a doubling a
    pair of equal finite points; a pair with the identity needs none."""
    from tendermint_tpu_torch.crypto.bls import cuda_tier, curve

    g = name[-2:]
    add, is_inf, eq = (getattr(curve, f"{g}_{f}") for f in ("add", "is_inf", "eq"))
    cur = list(pts) + [curve.G1_INF if g == "g1" else curve.G2_INF] * (
        cuda_tier._bucket(len(pts)) - len(pts))
    adds = doubles = 0
    while len(cur) > 1:
        pairs = list(zip(cur[0::2], cur[1::2]))
        for p, q in pairs:
            if not (is_inf(p) or is_inf(q)):
                same = eq(p, q)
                doubles, adds = doubles + same, adds + (not same)
        cur = [add(p, q) for p, q in pairs]
    return cur[0], adds, doubles


def fold_cases(name, pts):
    """Phase 2's folds of one group: the first n of `pts` (every other one
    replaced by a sum of two, so that Z != 1) for n in FOLD_SIZES; the edge
    rows [P, P, Q, -Q, R, inf, inf, S, ...] (at level 0 a doubling, P + (-P),
    R + inf and inf + S) cut to each n; 8 rows at infinity and one not; and
    the tiers' seams at L = LEAVES points a block: 2L copies of P
    (doublings in both tiers), a first half A (the points, then the
    identity) and its negation (S + (-S) in the last tier), and L rows at
    infinity before the points (every live row in the last block)."""
    from tendermint_tpu_torch.ops import bls12_381_fold as bf

    _, _, _, add, inf, neg, _ = fold_group(name)
    mixed = [add(p, q) if i % 2 else p for i, (p, q) in enumerate(zip(pts, pts[1:] + pts[:1]))]
    p, q, r, s = mixed[:4]
    edge = [p, p, q, neg(q), r, inf, inf, s] + mixed[4:]
    leaves = bf.LEAVES
    half = (mixed + [inf] * leaves)[:leaves]
    return ([(f"{n} points", mixed[:n]) for n in FOLD_SIZES]
            + [(f"{n} edge rows", edge[:n]) for n in FOLD_SIZES]
            + [("8 at infinity, 1 not", [inf] * 8 + [p]),
               (f"{2 * leaves} copies of one point", [p] * (2 * leaves)),
               ("halves summing to S and -S", half + [neg(x) for x in half]),
               (f"{leaves} at infinity, then {min(len(mixed), leaves)} points",
                [inf] * leaves + mixed[:leaves])])


def phase_fold_kernels(report, dev):
    """Both fold kernels against their plain versions on `dev` (tolerance 0,
    every output limb) and against the pure fold (compressed points), on
    fold_cases' inputs."""
    import torch

    from tendermint_tpu_torch.ops import bls12_381_fold as bf

    g1, g2 = fold_data(max(FOLD_SIZES), "fold-phase2", b"phase 2")[:2]
    for name, pts in zip(FOLD_KERNELS, (g1, g2)):
        rows_of, fold, point_of, _, _, _, compress = fold_group(name)
        for kind, case in fold_cases(name, pts):
            rows = torch.as_tensor(rows_of(case), device=dev)
            got = fold(rows)
            err = max_abs_diff((got,), (bf.fold_plain(rows),))
            same = compress(point_of(got)) == compress(fold_work(name, case)[0])
            log(f"  {name}: {kind} (bucket {rows.shape[0]}, plan {bf.plan(rows.shape[0])}) "
                f"max|kernel - plain|={err}, "
                f"{'equals' if same else 'DIFFERS FROM'} the pure fold")
            if err or not same:
                raise AssertionError(f"{name} disagrees with its plain version or the pure fold")
            report[name]["max_abs_err"] = float(max(report[name].get("max_abs_err", 0.0), err))


class FoldTimer:
    """Phase 22 (b)'s pure lane by part, each with its count and ms:
    wrappers on the pure tier's decompressions and pairing (host clock),
    cuda_tier's host prep (host clock) and the fold wrappers (CUDA events
    around each fold on the card); and the bucket of every fold."""

    def __init__(self):
        from tendermint_tpu_torch.crypto.bls import cuda_tier, curve, pairing
        from tendermint_tpu_torch.ops import bls12_381_fold

        self.parts = {"g1 decompress": (curve, "g1_decompress"),
                      "g2 decompress": (curve, "g2_decompress"),
                      "g1 host prep": (cuda_tier, "g1_rows"), "g2 host prep": (cuda_tier, "g2_rows"),
                      "g1 kernel": (bls12_381_fold, "fold_g1"),
                      "g2 kernel": (bls12_381_fold, "fold_g2"),
                      "pairing": (pairing, "pairing_check")}
        self.orig = {k: getattr(m, a) for k, (m, a) in self.parts.items()}
        self.ms, self.n, self.buckets = collections.Counter(), collections.Counter(), []

    def __enter__(self):
        for key, (mod, attr) in self.parts.items():
            setattr(mod, attr, self._timed(key, self.orig[key]))
        return self

    def _timed(self, key, orig):
        def fn(*a, **k):
            import torch

            if key.endswith("kernel"):
                self.buckets.append((key[:2], a[0].shape[0]))
            if key.endswith("kernel") and a[0].is_cuda:
                start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
                start.record()
                out = orig(*a, **k)
                end.record()
                end.synchronize()
                self.ms[key] += start.elapsed_time(end)
            else:
                t = time.perf_counter()
                out = orig(*a, **k)
                self.ms[key] += _ms(t)
            self.n[key] += 1
            return out
        return fn

    def __exit__(self, *exc):
        for key, (mod, attr) in self.parts.items():
            setattr(mod, attr, self.orig[key])

    def line(self) -> str:
        return ", ".join(f"{k} {self.n[k]} in {self.ms[k]:.3f} ms" for k in self.parts if self.n[k])


def fold_set(keys):
    """A uniformly BLS12-381 set of `keys`' validators at power 10 and the
    keys in set order."""
    from tendermint_tpu_torch.types.validator import Validator, ValidatorSet

    vset = ValidatorSet([Validator.new(k.pub_key(), 10) for k in keys])
    by_addr = {k.pub_key().address(): k for k in keys}
    return vset, [by_addr[v.address] for v in vset.validators]


def fold_precommits(vset, keys, height, bid):
    """Every validator's precommit for `bid` at `height` (one timestamp-free
    message, signed on SIGN_THREADS threads), made a Commit by a VoteSet."""
    from concurrent.futures import ThreadPoolExecutor

    from tendermint_tpu_torch.types.canonical import PRECOMMIT_TYPE
    from tendermint_tpu_torch.types.vote import Vote
    from tendermint_tpu_torch.types.vote_set import VoteSet

    votes = [Vote(type=PRECOMMIT_TYPE, height=height, round=0, block_id=bid,
                  timestamp_ns=LITE_T0 + height * SEC + i, validator_address=v.address,
                  validator_index=i) for i, v in enumerate(vset.validators)]
    msg = votes[0].bls_sign_bytes(CHAIN_ID)
    with ThreadPoolExecutor(SIGN_THREADS) as ex:
        sigs = list(ex.map(lambda k: k.sign(msg), keys, chunksize=64))
    vs = VoteSet(CHAIN_ID, height, 0, PRECOMMIT_TYPE, vset)
    for vote, sig in zip(votes, sigs):
        vote.signature = sig
        vs.add_vote(vote, verify=False)
    return vs.make_commit()


def fold_at_size(name, pts, blobs, dev, lib_info):
    """Phase 22 (a) for one kernel: its output against its plain version's
    (every limb), the pure fold's and the C tier's (compressed); its time
    (CUDA events, mean of 5 after one warm-up) beside the plain version's,
    the host prep's and the pure fold's (host clock); its bound."""
    import torch

    from tendermint_tpu_torch.crypto.bls import ctier
    from tendermint_tpu_torch.ops import _build
    from tendermint_tpu_torch.ops import bls12_381_fold as bf

    rows_of, fold, point_of, _, _, _, compress = fold_group(name)
    t = time.perf_counter()
    rows = rows_of(pts)
    prep_ms = _ms(t)
    rows_t = torch.as_tensor(rows, device=dev)
    on_card = dev.type == "cuda"
    k_ms = cuda_ms(lambda: fold(rows_t)) if on_card else None
    got = fold(rows_t)
    plain = []
    p_ms = (wall_ms if on_card else host_ms)(lambda: plain.append(bf.fold_plain(rows_t)))
    err = max_abs_diff((got,), tuple(plain))
    t = time.perf_counter()
    pure, adds, doubles = fold_work(name, pts)
    pure_ms = _ms(t)
    ct = ctier.get()
    t = time.perf_counter()
    c_sum = (ct.g1_sum if name.endswith("g1") else ct.g2_sum)(blobs)
    c_ms = _ms(t)
    c_pt = (ct.g1_point if name.endswith("g1") else ct.g2_point)(c_sum)
    mine = compress(point_of(got))
    n = len(pts)
    products = fold_products(name, adds, doubles)
    b_ms, b_by = bound(products / IMAD_PER_PRODUCT, n * rows[0].nbytes + got.numel() * 4)
    row = dict(ms=k_ms, plain_ms=p_ms, bound_ms=b_ms, bound_by=b_by, max_abs_err=float(err),
               prep_ms=prep_ms, pure_ms=pure_ms, c_ms=c_ms, products=products, additions=adds,
               doublings=doubles, bucket=rows.shape[0])
    if lib_info is not None:
        lib, log_text, sm_count = lib_info
        kernel = "fold_g1_kernel" if name.endswith("g1") else "fold_g2_kernel"
        group = 1 if name.endswith("g1") else 2
        leaves, blocks = bf.plan(rows.shape[0])[0]  # the first, widest tier
        row.update(_build.resources_of(kernel, log_text),
                   threads=lib.bls12_381_fold_threads(group, blocks),
                   resident_warps_per_sm=lib.bls12_381_fold_resident_warps(group, leaves))
        row["warps_per_sm"] = row["threads"] / 32 / sm_count
        row["bound_share"] = b_ms / k_ms
    log(f"  (a) {name}: B={n} (bucket {rows.shape[0]}) max|kernel - plain|={err}; kernel "
        f"{'not timed' if k_ms is None else f'{k_ms:.4f} ms'} (CUDA events, mean of 5), plain "
        f"{p_ms:.1f} ms, host prep {prep_ms:.1f} ms, pure fold {pure_ms:.1f} ms, C tier "
        f"{c_ms:.1f} ms (host clock); bound {b_ms:.4f} ms by {b_by} ({products:,} "
        f"products: {adds:,} additions, {doubles} doublings)"
        + ("" if lib_info is None else f"; {row['threads']} threads, {row['regs']} regs, "
           f"stack {row['stack_bytes']} B, spill {row['spill_bytes']} B"))
    if err or mine != compress(pure) or mine != compress(c_pt):
        raise AssertionError(f"{name} at B={n} disagrees with its plain version, the pure fold "
                             "or the C tier")
    return row, point_of(got)


def host_ms(fn) -> float:
    t0 = time.perf_counter()
    fn()
    return (time.perf_counter() - t0) * 1000


def phase_fold(card, dev):
    """Phase 22: (a) both fold kernels at FOLD_POINTS points, (b) the
    aggregate-commit paths' pure lanes through the fold on `dev`.  Returns
    the kernels' numbers for the kernels line, the launches of (a)'s
    entry-point folds and of (b), and the parts' times."""
    import torch

    from tendermint_tpu_torch.crypto.bls import ctier, cuda_tier, scheme
    from tendermint_tpu_torch.ops import _build
    from tendermint_tpu_torch.types.agg_commit import AggregateCommit, fold_commit
    from tendermint_tpu_torch.types.block import BlockID, PartSetHeader

    t_start = time.perf_counter()
    lib_info = None
    if dev.type == "cuda":
        with open(_build.ptxas_log_path()) as f:
            lib_info = (_build.lib(), f.read(),
                        torch.cuda.get_device_properties(0).multi_processor_count)
    log(f"[22] (a) the BLS12-381 fold kernels at {FOLD_POINTS:,} points: the pubkeys (G1) and "
        f"signatures (G2) of a uniformly BLS set, one message")
    t0 = time.perf_counter()
    g1, g2, g1b, g2b, fold_keys = fold_data(FOLD_POINTS, "fold", b"phase 22")
    log(f"  {FOLD_POINTS:,} keys and signatures made and decompressed on the C tier on "
        f"{SIGN_THREADS} threads in {time.perf_counter() - t0:.3f} s")
    launch_counts(zero=True)
    entry = {FOLD_KERNELS[0]: cuda_tier.aggregate_g1(g1, device=dev),
             FOLD_KERNELS[1]: cuda_tier.aggregate_g2(g2, device=dev)}
    launches = launch_counts(zero=True)  # of the two entry-point folds
    rows = {}
    for name, pts, blobs in zip(FOLD_KERNELS, (g1, g2), (g1b, g2b)):
        rows[name], point = fold_at_size(name, pts, blobs, dev, lib_info)
        if entry[name] != point:
            raise AssertionError(f"cuda_tier's fold differs from {name}'s output")
    launch_counts(zero=True)  # the comparisons' and timings' launches do not count
    a_s = time.perf_counter() - t_start

    log(f"[22] (b) the aggregate-commit paths on the pure tier with the fold on the card "
        f"(set_jax_aggregation(True)): a uniformly BLS set of {FOLD_SET:,} validators at power "
        f"10, fold_commit, verify_commit, batch_verify_aggregates over {FOLD_HEIGHTS} commits "
        f"(one wrong), against the same calls on the C tier with the fold off")
    t0 = time.perf_counter()
    vset, keys = fold_set(fold_keys[:FOLD_SET])  # (a)'s first keys
    bid = BlockID(hash=b"\x22" * 32, parts_header=PartSetHeader(total=1, hash=b"\x23" * 32))
    commits = [fold_precommits(vset, keys, h, bid) for h in range(1, FOLD_HEIGHTS + 1)]
    sign_s = time.perf_counter() - t0
    pks = [v.pub_key.bytes() for v in vset.validators]
    t0 = time.perf_counter()
    aggs = [fold_commit(c, vset, CHAIN_ID) for c in commits]
    vset.verify_commit(CHAIN_ID, bid, 1, aggs[0])
    # the second claim carries the third height's aggregate: a valid point,
    # so only the pairing refuses it
    items = [(pks, a.sign_message(CHAIN_ID), a.agg_sig) for a in aggs]
    items[1] = (pks, items[1][1], aggs[2].agg_sig)
    c_verdicts = scheme.batch_verify_aggregates(items)
    c_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    ctier.set_forced("pure")
    try:
        scheme.set_jax_aggregation(True, device=dev)
        with FoldTimer() as ft:
            launch_counts(zero=True)
            folded = fold_commit(commits[0], vset, CHAIN_ID)
            vset.verify_commit(CHAIN_ID, bid, 1, folded)
            verdicts = scheme.batch_verify_aggregates(items)
            counts = launch_counts()
    finally:
        scheme.set_jax_aggregation(False)
        ctier.set_forced(None)
    pure_s = time.perf_counter() - t0
    log(f"  (b) {FOLD_SET:,} validators' {FOLD_HEIGHTS} commits signed in {sign_s:.3f} s; C tier "
        f"with the fold off {c_s:.3f} s; the pure lane through the fold {pure_s:.3f} s: "
        f"{ft.line()} ({card})")
    log(f"  (b) folds (group, bucket): {collections.Counter(ft.buckets)}; launches {counts}; "
        f"verdicts {verdicts} (C tier {c_verdicts})")
    bucket = cuda_tier._bucket(FOLD_SET)
    groups = {g for g, _ in ft.buckets}
    if {b for _, b in ft.buckets} != {bucket} or groups != {"g1", "g2"}:
        raise AssertionError(f"phase 22 (b)'s folds were not each group's at bucket {bucket}: "
                             f"{ft.buckets}")
    if dev.type == "cuda" and (counts[FOLD_KERNELS[0]] != ft.n["g1 kernel"]
                               or counts[FOLD_KERNELS[1]] != ft.n["g2 kernel"]):
        raise AssertionError(f"phase 22 (b)'s folds did not launch the kernels once each: "
                             f"{counts}")
    if not isinstance(folded, AggregateCommit) or folded.encode() != aggs[0].encode():
        raise AssertionError("the pure tier's fold_commit through the kernel differs from the "
                             "C tier's")
    if verdicts != c_verdicts or verdicts != [True, False] + [True] * (FOLD_HEIGHTS - 2):
        raise AssertionError(f"batch_verify_aggregates gave {verdicts} through the fold, "
                             f"{c_verdicts} on the C tier")
    launches = {k: launches[k] + counts[k] for k in counts}
    s = time.perf_counter() - t_start
    log(f"  launches in phase 22: {launches}; (a) {a_s:.3f} s, phase 22 {s:.3f} s ({card})")
    return {"rows": rows, "launches": launches, "s": s, "a_s": a_s, "pure_s": pure_s,
            "parts": {k: [ft.n[k], ft.ms[k]] for k in ft.parts}}


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
    for name in ED_KERNELS:
        report[name]["bound_share"] = report[name]["bound_ms"] / report[name]["ms"]


def bls_tier_built(t0, card):
    """Build (or find) the BLS12-381 C tier from the checkout's
    tendermint_tpu_torch/csrc/bls12_381.c into tendermint_tpu_torch/_build/,
    named by the source's hash; fails unless scheme.active_tier() is "c"
    on that library."""
    import hashlib

    from tendermint_tpu_torch.crypto.bls import ctier, scheme

    lib = ctier._load_lib()
    tier = scheme.active_tier()
    src = os.path.join(ctier._csrc_path(), "bls12_381.c")
    with open(src, "rb") as f:
        src_hash = hashlib.sha256(f.read()).hexdigest()[:16]
    path = os.path.realpath(lib._name) if lib is not None else None
    build = os.path.realpath(os.path.join(HERE, "tendermint_tpu_torch", "_build"))
    if (tier != "c" or path is None or os.path.dirname(path) != build
            or not path.endswith(f"-{src_hash}.so")):
        raise AssertionError(f"BLS12-381 tier {tier}, library {path}: not the C tier built "
                             f"from {src} into {build}")
    log(f"  BLS12-381 C tier built from tendermint_tpu_torch/csrc/bls12_381.c in "
        f"{time.perf_counter() - t0:.3f} s ({path}); scheme.active_tier() = {tier!r} ({card})")


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

    from concurrent.futures import ThreadPoolExecutor

    import numpy as np

    from tendermint_tpu_torch.crypto import batch_verifier as bvm
    from tendermint_tpu_torch.crypto import hostprep
    from tendermint_tpu_torch.ops import _build

    t_start = time.perf_counter()
    card = card_line()
    log(f"card: {card}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda}; {torch.cuda.get_device_name(0)}")

    log("[1] setup")
    t0 = time.perf_counter()
    # the BLS12-381 C tier (host code: cc into tendermint_tpu_torch/_build/)
    # builds on a thread while nvcc builds the kernels
    with ThreadPoolExecutor(1) as ex:
        bls_build = ex.submit(bls_tier_built, t0, card)
        _build.lib()
        log(f"  CUDA kernels built in {time.perf_counter() - t0:.3f} s ({_build.library_path()})")
        bls_build.result()
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
            ("bls12_381_fold_g1", "tendermint_tpu_torch/csrc/bls12_381_fold.cu",
             "tendermint_tpu/crypto/bls/jax_tier.py:223"),
            ("bls12_381_fold_g2", "tendermint_tpu_torch/csrc/bls12_381_fold.cu",
             "tendermint_tpu/crypto/bls/jax_tier.py:223"),
        )
    }

    log("[2] kernels vs plain versions (tolerance 0)")
    dev = torch.device("cuda")
    phase_kernels(np.random.default_rng(2024), keys[:TABLE_VALIDATORS], report, dev)
    phase_fold_kernels(report, dev)

    log("[3] main path: 10k-validator commit through the hooks")
    launch_counts(zero=True)
    vset, commit, msgs, tab_cache = phase_main(keys, card, dev)
    counts = launch_counts()
    log(f"  launches on the main path: {counts}")
    for name, c in counts.items():
        if c == 0 and name in ED_KERNELS:  # the fold's path is phase 22's
            raise AssertionError(f"kernel {name} was not launched on the main path")
        report[name]["launches"] = c

    log("[4] kernels vs plain versions and timing at the main path's shapes")
    phase_timing(vset, commit, msgs, tab_cache, report)
    add_resources(report, ptxas_log, torch.cuda.get_device_properties(0).multi_processor_count)
    for r in (report[name] for name in ED_KERNELS):
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
    launch_counts(zero=True)
    t0 = time.perf_counter()
    phase_ingress(keys, vset, commit, msgs, card, dev)
    counts = launch_counts()
    log(f"  launches in phase 5: {counts}; phase 5 took {time.perf_counter() - t0:.3f} s")
    if counts["ed25519_ladder"] == 0:
        raise AssertionError("the ladder was not launched during vote ingress")
    for name, c in counts.items():
        report[name]["launches"] += c

    # phases 6-8 (one after another), 14 and 18 (a), each in a process of
    # its own (its own launch counters, read there and added), beside
    # phases 9, 10 (a) and 15 in this one
    picked = process_pick()
    ms = {k: report[k]["ms"] for k in ("ed25519_ladder", "ed25519_tabulated")}
    t0 = time.perf_counter()
    kids = {tag: PhaseChild(tag, "child_phase", tag, card, picked, "cuda", None, ms)
            for tag in ("6 7 8", "14", "18 a")}
    try:
        run_side(keys, card, dev, picked, report)
    finally:
        done, failed = join_kids(kids)
    if failed:
        raise failed[0]
    for name, by_phase in done["6 7 8"].items():
        report[name]["launches"] += sum(by_phase.values())
    for tag in ("14", "18 a"):
        for name, c in done[tag].items():
            report[name]["launches"] += c
    by = {p: {n: c[p] for n, c in done["6 7 8"].items()} for p in ("6", "7", "8")}
    log(f"  launches in phases 6, 7, 8, 14 and 18 (a), each in a process of its own: {by['6']}, "
        f"{by['7']}, {by['8']}, {done['14']}, {done['18 a']}; phases 6-10 (a), 14, 15 and "
        f"18 (a) took {time.perf_counter() - t0:.3f} s together ({card})")

    log("[11] two port nodes of the 10,000-validator chain over TCP: four relays, node B "
        "through the CLI fast-syncing from A and following it")
    launch_counts(zero=True)
    t0 = time.perf_counter()
    out = phase_net(keys, card, dev, keep_homes=True)
    net = out["net"]  # A's and B's homes, for phase 12
    counts = launch_counts()
    try:
        log(f"  launches in phase 11 on A (node B's, in its own process, are not counted): {counts}; "
            f"{out['validate_blocks']} validate_block calls of A on heights >= 2, {out['hits']} table "
            f"hits, {out['declines']} declines, tables built {out['tables']}, {out['frames']} "
            f"vote_batch frames of >= 16 entries received; phase 11 took "
            f"{time.perf_counter() - t0:.3f} s")
        if picked == "ed25519_tabulated" and counts["ed25519_window_tables"] < 1:
            raise AssertionError("kernel 2 (window tables) did not build the genesis set's table on A")
        if counts[picked] < out["hits"]:
            raise AssertionError(f"the auto-profile's pick ({picked}) did not serve every table hit "
                                 "of A in phase 11")
        if counts["ed25519_ladder"] < out["frames"] + out["declines"]:
            raise AssertionError("the ladder did not serve every vote_batch frame of >= 16 entries and "
                                 "declined check of A in phase 11")
        log(f"  launches in phase 16 on A (inside phase 11, and in its counts above): "
            f"{out['fx']['launches']}; phase 16 took {out['fx']['s']:.3f} s ({card})")
        for name, c in counts.items():
            report[name]["launches"] += c
    except BaseException:  # phase 12 does not run: remove A's and B's homes
        net["tmp"].cleanup()
        raise

    log("[12] a third node joins the 10,000-validator chain by state sync: A and B serve it "
        "through the CLI with RPC and PEX on; C restores a snapshot, fast-syncs the tail and "
        "follows")
    launch_counts(zero=True)
    t0 = time.perf_counter()
    ss = phase_statesync(keys, card, dev, net, keep_running=True)
    counts = launch_counts()
    stages = ss["stages"]
    try:
        log(f"  launches in phase 12 on C (A's and B's, in their own processes, are not counted): "
            f"{counts}; snapshot at {ss['snapshot']}; phase 12 took {time.perf_counter() - t0:.3f} s "
            f"to C's catch-up (A, B and C stay up for phase 13, whose end runs phase 12's "
            f"remaining checks)")
        if stages["trust_root"]["ed25519_ladder"] == 0:
            raise AssertionError("the ladder was not launched for C's trust root")
        if picked == "ed25519_tabulated" and counts["ed25519_window_tables"] != 1:
            raise AssertionError("kernel 2 (window tables) was not launched exactly once, for the "
                                 "restored set, on C")
        if stages["tail"][picked] == 0:
            raise AssertionError(f"the auto-profile's pick ({picked}) was not launched in C's tail")
        for name, c in counts.items():
            report[name]["launches"] += c
    except BaseException:  # phase 13 does not run: stop A, B and C
        ss["live"]["loop"].run_until_complete(ss_cleanup(ss["live"]))
        ss["live"]["loop"].close()
        raise

    log("[13] a node from a stock home: D knows only seed A, meshes by PEX, fast-syncs the "
        "10,000-validator chain, streams NewBlock over /websocket and serves 4 light-client "
        "tenants from its gateway")
    launch_counts(zero=True)
    t0 = time.perf_counter()
    log("[10] (b) the CLI in a subprocess on the card, beside phase 13")
    cli = Beside("10 (b)", lambda: phase_cli(card))
    try:
        out = phase_stockhome(keys, card, dev, ss)
    finally:
        cli.join()
    counts = launch_counts()
    stages = out["stages"]
    log(f"  launches in phase 13 on D (A's and B's, in their own processes, are not counted): "
        f"{counts}; phase 12's checks passed (snapshot at {out['ss']['snapshot']}); phase 13 "
        f"took {time.perf_counter() - t0:.3f} s")
    if picked == "ed25519_tabulated" and stages["sync"]["ed25519_window_tables"] != 1:
        raise AssertionError("kernel 2 (window tables) did not build D's genesis table exactly once")
    if out["declines"] < 1 or stages["sync"]["ed25519_ladder"] < out["declines"]:
        raise AssertionError("the ladder did not serve D's declined first check")
    if stages["sync"][picked] < out["hits"]:
        raise AssertionError(f"the auto-profile's pick ({picked}) did not serve every table hit "
                             "of D's fast sync")
    if stages["gateway"]["ed25519_ladder"] == 0:
        raise AssertionError("the ladder was not launched for the gateway's forward step")
    if any(stages["tenants"].values()):
        raise AssertionError(f"a kernel launched for answers served from the gateway's store: "
                             f"{stages['tenants']}")
    for name, c in counts.items():
        report[name]["launches"] += c

    # phases 19 (a), 20, 21 and 22, each in a process of its own, from the
    # end of phase 17 on, beside 18 (b) and then phase 19 (b) in this one
    t0 = time.perf_counter()
    kids = {}

    def start_kids():
        kids.update((tag, PhaseChild(tag, "child_phase", tag, card))
                    for tag in ("19 a", "20", "21", "22"))

    try:
        run_chaos_rotation(card, dev, picked, report, after_17=start_kids)
        run_mixed(keys, commit, card, dev, report)
    finally:
        done, failed = join_kids(kids)
    if failed:
        raise failed[0]
    check_sr_chain(done["19 a"], card)
    fold = done["22"]
    for counts in (done["20"], done["21"], fold["launches"]):
        for name, c in counts.items():
            report[name]["launches"] += c
    for name in FOLD_KERNELS:  # phase 22 (a)'s numbers; max_abs_err also phase 2's
        row = fold["rows"][name]
        row["max_abs_err"] = max(row["max_abs_err"], report[name]["max_abs_err"])
        report[name].update(row)
        if report[name]["launches"] == 0:
            raise AssertionError(f"kernel {name} was not launched on the fold's paths")
    log(f"  launches in phases 20, 21 and 22, each in its process: {done['20']}, {done['21']}, "
        f"{fold['launches']}; phase 22 took {fold['s']:.3f} s; phases 17-22 but 18 (a) took "
        f"{time.perf_counter() - t0:.3f} s together ({card})")
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

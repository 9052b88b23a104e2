#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``cpzk_tpu_torch``) on one NVIDIA GPU.

Run from the repository root with no arguments: ``python3 chip_smoke.py``.
It builds the CUDA kernels from ``cpzk_tpu_torch/csrc`` and the C++ host
core from ``cpzk_tpu_torch/native`` (both into the ignored
``cpzk_tpu_torch/_build``), and prints one JSON line per phase (each also
appended to ``chiprun_out/chip_smoke.jsonl``, with ``elapsed_s``, the
seconds since the script started):

1. ``device``  — the card (torch, and ``nvidia-smi`` name / power limit /
   max SM clock);
2. ``build``   — seconds to build the kernel library (one ``nvcc`` per
   source, all started together, then one link), and per kernel (the two
   point kernels, the three ladder kernels, the three scalar kernels, the
   two MSM kernels, the Keccak chain, the prover's two kernels and DECODE)
   the compiler's registers and spills (``-Xptxas -v``), and for the point
   kernels and the lane-a-thread ladder kernels the block size they are
   launched with at each lane count of phase 3;
   ``host_core`` — seconds to build and load the host core (g++), its
   library name and the threads its pools use; the 256-proof corpus made
   by the port's prover on the core's constant-time comb;
   ``derive_challenges_batch`` on 4096 rows (µs per row; equal to the
   pure-Python twin on a 256-row sample, exact); ``Proof.from_bytes_batch``
   of 4096 wires, eager and deferred (µs per proof); ``wires_to_device`` of
   4 x 4097 wires to the card (limbs equal to ``points_soa`` of the
   Python-decoded points on a sample, exact);
3. ``kernels_vs_plain`` — each kernel against its plain PyTorch version on
   the card at n in {1, 127, 4096, 6144, 16384, 18432} lanes (random valid
   points plus the +-9500 adversarial limb patterns): the kernels compute
   in their own radix, so values must be equal after canonicalization
   (tolerance: exact) and output limbs within |9500|; device time per call
   of kernel and plain version (torch.profiler), beside the kernel's bound;
   then the scalar kernels (``rlc_scalars``, ``scalar_recode``) at n in
   {1, 127, 4096, 16384} rows of random scalars with 0, 1 and l - 1, at the
   per-row path's width (windows, corrections at lane n) and the Pippenger
   path's (digits at c in {4, 11, 13}), and ``rlc_scalars`` at 77 rows, at
   130 rows of every scalar l - 1 and at 1,500 rows whose a s sum past
   2^256: exact (``torch.equal``); ``rlc_scalars`` and ``scalar_recode``
   (digits and windows) timed by CUDA events and by the profiler, beside
   their one-row chain floors and an empty kernel's launch floor; and the
   MSM kernels (``msm_bucket``, ``msm_window_reduce``) against the plain
   MSM at m in {2048, 18432} terms (18,432: the 4096-row check's terms,
   two chunks at c = 11), with the digits of random scalars, the same with
   window 1 all +-2^(c-1) (the top bucket), and digits that put every term
   of a window in one bucket, and the random and top-bucket digits at c = 4
   and c = 16 on one 2,048-term chunk: equal as group elements (the
   encodings; the order of the adds differs, so the limbs may).  Device
   times beside the bounds at the 4096- and 16,384-row shapes (the MSM
   pair per wrapper call, its two ``__global__`` launches, by CUDA events
   on the random and the one-bucket digits, and once by the profiler,
   with the chain floor of ``msm_window_reduce``'s quad schedule, checked
   and timed on its own); and the batch prover's and
   the device challenges' kernels: ``comb_tables`` for G and H (tables equal to
   ``table_words`` of the plain ones, the kernel's layout; its chain floor,
   252 doublings on one quad), ``commitments`` at n in {1, 127, 4096,
   16,384} lanes (bytes identical, and equal to the host core's comb on a
   sample; its chain floor, one lane), ``keccak_chain`` with 3 masks (a
   state per row and one shared) and ``reduce_wide`` of 64-byte values
   led by its edge values (0, 1, l - 1, l, 2 l, 2^252, 2^256 - 1, 2^512 -
   1): exact; device times at 4096 and 16,384; and the per-row ladder kernels
   (``ladder_combined``, ``ladder_partials_identity``, ``ladder_each``)
   against their plain versions, the step-by-step composition over the
   point kernels, on rows tiling the corpus: the combined check at 127,
   6,144 (4096 rows) and 16,384 lanes, valid and tampered (chunk totals
   equal as group elements, verdicts exact), the per-row check at 127,
   4096 and 16,384 lanes with three tampered rows and g, h shared and per
   lane (bits exact), the partials of the 16,384-row check's two chunks
   and of k in {1, 2, 3, 8, 92} random totals, valid and tampered;
   times by ``kernel_ms`` beside the bounds and each ladder's chain floor
   (the kernel at one lane; the partials' at k = 2) and the launch floor;
   ``vectors`` — the pinned vectors of ``tests/vectors`` on the card:
   ``commitments`` (with ``comb_tables`` of G and H) gives the 8
   ``scalarmult_base`` points of ``sodium_vectors.json`` (libsodium's),
   ``derive_challenges_device`` then ``reduce_wide`` the 4 protocol-layer
   challenges of ``transcript_vectors.json``, and ``TorchBackend`` accepts
   the 4 accepted rows of ``proof_vectors.json`` and rejects
   ``vector-wrong-context``: exact;
4. ``serving_parse`` and ``serving_batch`` — 4096 entries tiling the
   corpus, each parsed fresh from wire bytes as a server parses them
   (``Proof.from_bytes_batch``, eager and deferred; statements with
   ``element_from_bytes``; parse times on the ``serving_parse`` line), then
   ``BatchVerifier(backend=TorchBackend(), max_size=4096)``: all-valid must
   accept every entry (eager and deferred); about 1% tampered rows (wrong
   s, wrong context, swapped r1) must be rejected at exactly those indices
   with the exact error, and 2 rows whose commitment wire does not decode
   must fail the eager parse and come back from the deferred batch as
   ``InvalidProofEncoding`` without reaching the card; a 64-entry
   sub-batch must agree with the port's ``CpuBackend`` and with the
   pure-Python ``Verifier.verify_pure``; the kernel launches of one
   all-valid 4096-entry verify are reported on their own;
5. ``north_star`` — ``TorchBackend.verify_combined`` on 16,384 rows (16,385
   lanes with the correction row, two lane chunks) with fresh alphas: True,
   and False with one tampered row; the launches of the valid check are
   reported on their own;
   ``pippenger`` — this slice's path: ``BatchVerifier(backend=
   TorchBackend(pippenger_min=2))`` on phase 4's 4096 wire-parsed entries,
   with ``CPZK_DEVICE_RLC`` off and on: every valid entry accepted, and the
   mixed batch's results (tampered rows at exactly their indices, exact
   errors) equal to the per-row backend's; ``verify_combined`` on the
   16,384 rows (65,538 terms, 5 chunks at c = 11) True and False with one
   tampered row, with the host and the device scalar plane, and the
   per-row check with the device scalar plane the same.  The per-row
   reference runs first; every kernel's launch count is set to 0 just
   before the Pippenger batches and read just after them, each of the six
   at least once; each 16,384-row check is counted on its own;
   ``batch_prove`` — the bulk prover on the card (``BatchProver()``, 16,384
   lanes a launch): two ``comb_tables`` launches build the tables (equal to
   ``table_words`` of the plain prover's); ``statements()`` of 65,536
   witnesses (4 chunks), every (y1, y2) byte-equal to the host core's
   comb; ``prove()`` of 20,480 witnesses with their own 32-byte contexts
   (a full chunk and 4096); ``BatchVerifier(TorchBackend())`` accepts
   them all in one combined check on the card, and rejects a copy with
   one bit of s flipped in every 100th proof at exactly those rows; the
   host ``Verifier`` checks a sample of 64; the plain prover
   (``device="cpu"``) gives the card's bytes for the same nonces on 64
   witnesses.  Counts set to 0 just before the prover is built and read
   after ``prove()``.  Printed: statements/s, proofs/s, ``prove()``'s steps
   one by one (nonces, windows, digits upload, the commitments with their
   device ms from CUDA events, download, challenges, responses, framing),
   the card's interval and idle share in one ``prove()`` (CUDA events
   around the prover's work on the card, which it reports as the serving
   plane's batches do), and the ladder kernels' launches in the
   verification (its one combined check spans two lane chunks);
   ``device_challenges`` — the 20,480 proofs' columns through
   ``derive_challenges_device`` on the card (every row's 64 bytes equal to
   the host core's) and ``sclimbs.reduce_wide`` on the card (equal to the
   plain version and to the host's scalars), counted on their own; then
   ``keccak_chain`` on those rows' masks against its plain version
   (exact), and both kernels timed at these shapes, which the kernels line
   reports for them, beside their chain floors (the first row alone,
   checked first); then at
   4096 and 16,384 rows, 3 turns after a warm one, the whole call and its
   parts (host mask placement, upload, the kernel by CUDA events,
   download) against the host core's ``derive_challenges_batch``;
   ``serving_plane`` — ``build_backend`` of the ``[tpu]`` settings on
   cuda:0, which with no fallback must serve ``TorchBackend`` bare; then
   with a counting ``CpuBackend`` passed as the fallback
   (``FailoverBackend(TorchBackend, CpuBackend)`` behind a
   ``DynamicBatcher`` of 4096-entry batches, prewarmed at 4096), driven in
   one event loop: a burst of 4096 single-entry ``submit`` calls, which must
   dispatch as one batch of 4096, then a closed loop of 64 clients
   awaiting ``submit_many`` of 64-entry groups until 16,384 entries are
   answered; then the closed loop again with ``pipeline_depth=1``.  The
   entries are phase 4's (about 1% tampered).  Every result must equal its
   expectation (``None``, or ``InvalidParams("Proof verification
   failed")``); it fails if the breaker left CLOSED, if
   ``tpu.backend.failover`` or ``degraded_seconds`` is above 0, if the
   host fallback was called at all, or if ``ladder_combined`` or
   ``ladder_each`` was not launched by the served traffic.  Printed:
   entries/s, request latency p50/p99, batch count and sizes, the stage histograms from the port's metrics,
   the dispatch gap and the card's work intervals (first launch to last,
   CUDA events, idle stretches included) from the flight recorder,
   and the kernel launches;
   ``login_state`` — the state and wire half of the gRPC service, with no
   gRPC and no protobuf runtime, in the stage order of the service's
   ``verify_proof_batch``: a ``ServerState`` and ``build_backend`` at
   ``batch_max`` 4096 on cuda:0 (prewarmed, with a counting host fallback);
   4096 users registered from the corpus statements and one challenge
   each; 4096 logins in five hand-encoded ``BatchVerificationRequest``
   messages (4 x 1000 entries and 96, about 1% tampered and 2 with a
   commitment that does not decode), each parsed by the native wire parse
   (a punt fails the phase), its challenges consumed and users looked up in
   bulk, its proofs parsed deferred from the packed buffer, the five
   submitted to the batcher at once (one batch of 4096), and sessions
   minted for the entries that pass.  Every verdict must equal its
   expectation, every session validate to its user, a replay of the first
   message fail at the consume for all 1000 entries with no row reaching
   the card, ``ladder_combined`` and ``ladder_each`` be launched by the
   login traffic, and the breaker
   stay CLOSED with no fallback call.  Printed: registrations/s,
   challenges/s, native parse µs per entry, the state seconds of consume
   and lookup and of sessions, logins/s from parse to session, GC pauses
   and the launches;
   ``daemon`` — the port's entry point, ``python -m cpzk_tpu_torch.server
   --no-repl``, as a subprocess on a TOML of its own (``[tpu] backend =
   "tpu"``, ``batch_max`` and ``prewarm_quanta`` 4096, a rate limit above
   the traffic, the ops plane on an ephemeral port, a state file, and
   ``CPZK_CLEANUP_INTERVAL_S=1`` so a sweep, checkpoint and ``gc.freeze()``
   run), driven over loopback gRPC by a client hand-wired on the port's
   ``auth_pb2`` over 8 connections: 4096 users registered with
   ``RegisterBatch``, 4096 concurrent ``CreateChallenge`` calls, and 4096
   logins in five concurrent ``VerifyProofBatch`` RPCs (4 x 1000 + 96,
   tampered as in ``login_state``); every verdict must equal its
   expectation with one session per valid entry, a replay of the first RPC
   be refused for all 1000 entries, the flight records (``/flightrec``)
   cover the 4096 entries with a device interval above 0, ``/metrics``
   show no failover and ``ladder_combined`` and ``ladder_each`` launched by
   the logins, and the
   daemon (not the shards) hold a CUDA context (``libcuda`` in the
   processes' maps; one ``nvidia-smi --query-compute-apps`` row more than
   before the daemon, and the daemon's PID among them where ``nvidia-smi``
   shows this namespace's PIDs).  SIGTERM must exit 0 within the drain plus 30 s with a snapshot;
   a second boot must restore the 4096 users and the sessions and log one
   user in; a third, with ``[server] ingest_shards = 4``, must answer the
   same logins again through the shards; a fourth, with
   ``CPZK_PIPPENGER_MIN=2 CPZK_DEVICE_RLC=1`` in the daemon's environment,
   must answer them with every verdict and the sessions equal to the first
   boot's and ``/metrics`` showing the four scalar and MSM kernels and
   ``ladder_each`` launched by the logins; every batch of that wave holds
   tampered entries, so its combined check fails and the per-row ladders
   decide, and the boot then logs in the last 1000 users in one all-valid
   ``VerifyProofBatch``, which must give every entry a session with the
   four scalar and MSM kernels launched and no ladder kernel: the
   Pippenger check itself passed.  Printed: boot and shutdown
   seconds, registrations/s, challenges/s, logins/s from the first
   ``VerifyProofBatch`` sent to the last answer, RPC latency p50/p99, the
   flight records' batch sizes and device intervals, the restored counts,
   each shard's boot seconds, and the launches; the daemons' output goes
   to ``chiprun_out/daemon_*.log``.  Admission runs at its default (on):
   the client sends an RPC that was shed again once its
   ``cpzk-retry-after-ms`` has passed, and the phase prints the sheds by
   RPC and by tier (a shed ``VerifyProofBatch``, tier 0, fails it), with
   the ``/statusz`` admission block and the shed counters;
   ``durable_daemon`` — the daemon again, on a TOML that adds
   ``[durability] enabled = true``, ``fsync = "always"`` and ``[server]
   max_users = 65536``: boot A registers 65,536 users with
   ``RegisterBatch`` (the WAL outgrows ``compact_bytes``, so the 1 s sweep
   snapshots and compacts), acknowledges 512 challenges that it holds live
   (unanswered), logs 4096 users in as the ``daemon`` phase does, waits for
   a sweep whose compaction is held at the oldest live challenge (it does
   not wait for a compaction to pass them), starts 1024 further
   ``CreateChallenge`` calls and SIGKILLs the daemon once 512 are
   acknowledged (reaped before the next boot); boot B must recover 65,536
   users and every acknowledged session (``/statusz``) with nothing
   quarantined, log in every acknowledged challenge, the 512 held and the
   512 killed ones by id, in concurrent ``VerifyProofBatch`` RPCs on the
   card (``ladder_combined`` launched: every one is valid), refuse a valid
   proof over a
   challenge consumed before the kill without a batch, and exit 0 on
   SIGTERM with the WAL at 0 bytes.  Printed:
   registrations/s, logins/s and ``VerifyProofBatch`` p50/p99 beside the
   ``daemon`` phase's, the WAL's appends, bytes and fsyncs from
   ``/metrics``, the recovery's seconds and counts, the admission blocks
   and sheds by tier, the compute apps after the kill, the workdir's
   filesystem type, and the launches of each wave;
   ``audit`` — the audit trail end to end: the daemon with
   ``SERVER_AUDIT_ENABLED=1`` (its proof log sealing a segment every 2 MiB)
   driven only by the port's client — ``python -m cpzk_tpu_torch.client
   stream --users 64 --proofs 8192`` (0 rejected), ``verify_proof_batch``
   over 4096 logins tampered as in ``daemon``, and 4 unary ``verify_proof``
   calls (one tampered); SIGTERM must log "audit trail closed at seq N"
   with N the verdicts received; the trail directory replays in process
   through ``run_audit(..., backend="tpu")`` on the card to N records,
   none mismatched, the planted tampers rejected, ``ladder_combined`` and
   ``ladder_each`` launched (counts set to 0 just before, read just
   after).  Then ``python
   -m cpzk_tpu_torch.audit generate`` writes 16,384 records (1% rejects,
   0.5% lying verdicts), replayed at quantum 4096: A on the card in
   process (the liars mismatched); B by the CLI on the card, SIGKILLed
   once its cursor exists and resumed from it, byte-identical to A; C on
   the host (``--backend cpu``), equal to A in totals and digest; D on the
   card with ``CPZK_PIPPENGER_MIN=2 CPZK_DEVICE_RLC=1``, byte-identical to
   A; ``verify-report`` answers 0 on every report and 1 on A with one
   byte flipped.  Printed: records/s of the generation, of A and of C,
   the trail's bytes and segments, the replays' card interval and idle
   share, and the phase's seconds;
   ``replication`` — a two-partition fleet of four daemons on the card,
   each on a TOML of its own (``[tpu] backend = "tpu"`` at ``batch_max``
   and ``prewarm_quanta`` 4096, ``fsync = "always"``, ``[replication] mode
   = "sync"`` with ``lease_ms`` 3000 and ``renew_interval_ms`` 500,
   ``[audit]``, ``[fleet]`` on a map from ``python -m cpzk_tpu_torch.fleet
   init`` and ``set-standby``): partition 0 is the pair A→B, partition 1
   C→D.  The port's ``AuthClient`` with the map registers 65,536 users and
   logs 2048 in (about 1% tampered): every verdict exact, a client holding
   a one-partition map converges in one redirect, B and D refuse auth RPCs
   ("standby replica: not promoted"), each standby's ``applied_seq`` equal
   to its primary's WAL seq.  SIGTERM to A hands partition 0 over (B at
   epoch 2, A exits 0, every user and session A acknowledged at B, A's
   sealed proof-log segments at B byte for byte); 1024 ``CreateChallenge``
   calls at C with a SIGKILL once 512 are acknowledged, D promoting after
   the lease and logging every acknowledged challenge in; then B and D
   answer a 2048-login wave each with exact verdicts, ``ladder_combined``
   and ``ladder_each`` launched by those logins (their ``/metrics``) and no
   failover; each of
   the four daemons holds a CUDA context of its own.  Printed: boot
   seconds, registrations/s, logins/s at the primaries and at the promoted
   standbys, the handover's milliseconds and SIGTERM to the first write at
   B, the kill to the promotion and to the first session at D, the card
   memory in use (``nvidia-smi``) before the boot, after it and at the end,
   each daemon's allocator share of it (its ``/metrics``), and the
   launches; the daemons'
   output goes to ``chiprun_out/daemon_repl_*.log``;
6. ``profile`` — one 4096-row combined check: wall time unprofiled, then
   device time by kernel under torch.profiler (the table goes to the
   output directory's ``profile_4096.txt``): the ladder kernels by name,
   every kernel launched, the busy time and the device's idle share, and
   the card's interval by CUDA events, beside the step-by-step
   composition's 8,533 launches and 24.3-24.6 ms busy (PERF.md, section 5);
   ``pippenger_ab`` — the combined check at 4096 and 16,384 rows as per-row
   ladders, as a Pippenger MSM, and as one with the device scalar plane,
   in turns (3 reps after a warm turn): wall time and kernel launches per
   check; then one 4096-row Pippenger check's device time by kernel and
   idle share (``chiprun_out/profile_pippenger_4096.txt``).

Then the ``kernels`` line (``launches`` counted over phases 4-5 only:
the ladder kernels carry them, and the point kernels, which run on no
per-row route any more, show 0 there and their launches on the Pippenger,
lanes, mesh and multihost paths; for the ladder kernels
``launches_in_serving_plane`` over the served traffic of phase 5b,
``launches_in_login_state`` over the login traffic of phase 5c,
``launches_in_daemon`` and ``launches_in_daemon_sharded`` over the
daemon's first and third waves of logins, ``launches_in_durable_daemon``
and ``launches_in_durable_recovery`` over the durable daemon's waves before
the kill and after the recovery; for the scalar and MSM kernels
``launches`` over the ``pippenger`` phase's Pippenger batches, and for
all six ``launches_in_pippenger`` (the same count) and
``launches_in_daemon_pippenger``, the daemon's fourth wave, and
``launches_in_daemon_all_valid_batch``, its all-valid batch; for the
prover's kernels ``launches`` over ``batch_prove``'s path and for
``keccak_chain`` and ``reduce_wide`` over ``device_challenges``', both
also as ``launches_in_batch_prove`` and ``launches_in_device_challenges``,
and for the ladder kernels ``launches_in_batch_prove_verify`` and
``launches_in_audit_trail_replay`` / ``launches_in_audit_synthetic_replay``,
the audit phase's replays of the daemon's trail and of A, and
``launches_in_replication_primaries`` / ``launches_in_replication_promoted_b``
/ ``_d``, the replication phase's first wave at A and C and the promoted
standbys' waves), the
``nvidia-smi`` name and power limit, and last
``{"ok": true, "device": {...}}``.  Any failure raises, so the script exits
non-zero and prints no last line; it also exits non-zero when CUDA is
unavailable or the package is missing.
"""

from __future__ import annotations

import asyncio
import contextlib
import gc
import json
import os
import re
import shutil
import signal
import socket
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request

SEED = 20261017
CORPUS = 256
SERVING_N = 4096
SUB_BATCH_N = 64
#: the serving_plane phase's closed loop: entries answered, client tasks,
#: entries per submit_many (a batch RPC's shape)
CLOSED_LOOP_N = 16384
CLIENTS = 64
GROUP_N = 64
#: rows of the host-core checks held against the pure-Python twins
SAMPLE_N = 256
#: entries per BatchVerificationRequest in the login_state phase (the
#: service's MAX_BATCH)
LOGIN_RPC_MAX = 1000
#: the daemon phase: its boot limit, the ingest shards of its third boot,
#: and the gRPC connections its client opens
DAEMON_BOOT_TIMEOUT_S = 120.0
DAEMON_SHARDS = 4
DAEMON_CHANNELS = 8
#: sheds of one RPC after which the phases' client gives up retrying
PUSHBACK_TRIES = 200
#: the durable_daemon phase: users registered (a state a deployment holds,
#: whose WAL outgrows compact_bytes), the challenges acknowledged before
#: the login wave and held live across the compactions after it, the
#: challenges started before the SIGKILL, and how many of them must be
#: acknowledged first
DURABLE_USERS = 65536
DURABLE_HELD = 512
DURABLE_FURTHER = 1024
DURABLE_KILL_AFTER = 512
BAD_POINT = "Invalid proof: Bytes do not represent a valid Ristretto point"
NORTH_STAR_N = 16384
KERNEL_NS = (1, 127, 4096, 6144, 16384, 18432)
#: lane width at which the kernels line reports times: one full lane chunk,
#: the shape most main-path launches of the 16,384-row check take
MAIN_N = 16384
#: the lane width of one 4096-row combined check (4097 lanes, padded)
CHUNK_4096_N = 6144
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
INT32_OPS_PER_SM_CLOCK = 64
#: the Pallas kernels' ports, then the per-row route's ladder kernels, then
#: those of the device scalar plane and of the Pippenger MSM; together, and
#: in ``REPLACES`` and ``SOURCES``, they must be the library's kernels
#: (``point_kernels.kernel_names()``), which ``main`` checks first.  The
#: point kernels run on no serving path's per-row route any more (the
#: Pippenger route's chunk partials and a mesh's slice partials still sum
#: through ``point_add``)
POINT_KERNELS = ("point_add", "point_double_k")
#: the per-row route: a combined check launches ``ladder_combined`` a lane
#: chunk (and ``ladder_partials_identity`` past one chunk), a batch whose
#: combined check fails ``ladder_each``
LADDER_KERNELS = ("ladder_combined", "ladder_partials_identity", "ladder_each")
#: what a wave of 4096 logins (or a served stream) with tampered entries
#: launches: one lane chunk a batch, so no partials kernel; the kernels each
#: serving path's launch check names
SERVED_KERNELS = ("ladder_combined", "ladder_each")
PIPPENGER_KERNELS = ("rlc_scalars", "scalar_recode", "msm_bucket", "msm_window_reduce")
#: the batch prover's kernels, then the device challenges'
PROVER_KERNELS = ("comb_tables", "commitments")
CHALLENGE_KERNELS = ("keccak_chain", "reduce_wide")
#: ristretto DECODE (an XLA program of the JAX package; on no serving path)
DECODE_KERNELS = ("ristretto_decode",)
REPLACES = {"point_add": "cpzk_tpu/ops/pallas_kernels.py:51",
            "point_double_k": "cpzk_tpu/ops/pallas_kernels.py:87",
            "ladder_combined": "cpzk_tpu/ops/verify.py:85",
            "ladder_partials_identity": "cpzk_tpu/ops/backend.py:619",
            "ladder_each": "cpzk_tpu/ops/verify.py:58",
            "rlc_scalars": "cpzk_tpu/ops/backend.py:468",
            "scalar_recode": "cpzk_tpu/ops/backend.py:481",
            "msm_bucket": "cpzk_tpu/ops/msm.py:103",
            "msm_window_reduce": "cpzk_tpu/ops/msm.py:135",
            "comb_tables": "cpzk_tpu/ops/prove.py:38",
            "commitments": "cpzk_tpu/ops/prove.py:63",
            "keccak_chain": "cpzk_tpu/ops/challenge.py:159",
            "reduce_wide": "cpzk_tpu/ops/sclimbs.py:136",
            "ristretto_decode": "cpzk_tpu/ops/curve.py:351"}
_CSRC = "cpzk_tpu_torch/csrc/"
_LADDER_SOURCES = [_CSRC + "ladder_ops.cu", _CSRC + "ladder_w32.cuh", _CSRC + "msm_w32.cuh",
                   _CSRC + "ristretto_w32.cuh", _CSRC + "fe25519_w32.cuh"]
#: the prover's kernels share their sources: the bodies in prove_w32.cuh,
#: the quad doubling of msm_w32.cuh (the table's chain) and ENCODE
_PROVE_SOURCES = [_CSRC + "prove_ops.cu", _CSRC + "prove_w32.cuh", _CSRC + "msm_w32.cuh",
                  _CSRC + "ristretto_w32.cuh", _CSRC + "fe25519_w32.cuh"]
SOURCES = {
    "point_add": [_CSRC + "point_ops.cu", _CSRC + "fe25519_w32.cuh"],
    "point_double_k": [_CSRC + "point_ops.cu", _CSRC + "fe25519_w32.cuh"],
    "ladder_combined": _LADDER_SOURCES,
    "ladder_partials_identity": _LADDER_SOURCES,
    "ladder_each": _LADDER_SOURCES,
    "rlc_scalars": [_CSRC + "scalar_ops.cu", _CSRC + "sc25519_w32.cuh"],
    "scalar_recode": [_CSRC + "scalar_ops.cu", _CSRC + "recode_w32.cuh",
                      _CSRC + "sc25519_w32.cuh"],
    "msm_bucket": [_CSRC + "msm_ops.cu", _CSRC + "msm_w32.cuh", _CSRC + "fe25519_w32.cuh"],
    "msm_window_reduce": [_CSRC + "msm_ops.cu", _CSRC + "msm_w32.cuh",
                          _CSRC + "fe25519_w32.cuh"],
    "comb_tables": _PROVE_SOURCES,
    "commitments": _PROVE_SOURCES,
    "keccak_chain": [_CSRC + "keccak_ops.cu", _CSRC + "keccak_u64.cuh"],
    "reduce_wide": [_CSRC + "scalar_ops.cu", _CSRC + "sc25519_w32.cuh"],
    "ristretto_decode": [_CSRC + "decode_ops.cu", _CSRC + "decode_w32.cuh",
                         _CSRC + "ristretto_w32.cuh", _CSRC + "fe25519_w32.cuh"],
}
#: the ladder kernels' checks: the combined check's lane widths (ragged, a
#: 4096-row check's 4097 lanes padded, one full lane chunk), the per-row
#: check's (ragged, 4096 rows, a full chunk), and the launches a timed run
#: makes (the chain floors: one lane)
LADDER_COMBINED_NS = (127, CHUNK_4096_N, MAIN_N)
LADDER_EACH_NS = (127, SERVING_N, MAIN_N)
LADDER_REPS = 10
#: ``ladder_partials_identity``'s checks on random totals (pairs P, -P; k =
#: 92 is about a million rows' lane chunks), and the k timed besides the
#: 16,384-row check's two chunk totals
PARTIALS_KS = (1, 2, 3, 8, 92)
PARTIALS_TIMED_KS = (92,)
#: the scalar kernels' checks: row counts, window sizes of the digit recode,
#: and the row counts timed (the 4096- and 16,384-row checks); then
#: ``rlc_scalars``' edge cases: a row count no block size divides, every
#: scalar l - 1, and rows whose a s sum past 2^256 (the sum's ninth word)
SCALAR_NS = (1, 127, 4096, 16384)
SCALAR_CS = (4, 11, 13)
SCALAR_TIMED_NS = (4096, 16384)
RLC_EDGE_CASES = (("random", 77), ("l_minus_1", 130), ("ninth_word", 1500))
#: launches of each timed run of the small kernels (``kernel_ms``)
SMALL_REPS = 20
#: the MSM kernels' checks: term counts (18,432 is the 4096-row check's
#: 4 x 4096 + 2 terms padded, two chunks), window size, lane chunk
MSM_MS = (2048, 18432)
MSM_C = 11
MSM_CHUNK = 16384
#: the window sizes checked besides MSM_C (the smallest and largest
#: histograms), and the calls each timed run of an MSM kernel makes
MSM_OTHER_CS = (4, 16)
MSM_TIMED_REPS = 10
#: rows of the pippenger phase's A/B, and its reps (turns per config)
AB_NS = (4096, 16384)
AB_REPS = 3
#: the prover's and the challenges' kernels against their plain versions:
#: lane counts, those timed, and the masks of one transcript (a 32-byte
#: context and six points absorb into three permutations)
PROVE_KERNEL_NS = (1, 127, 4096, 16384)
PROVE_TIMED_NS = (4096, 16384)
CHALLENGE_MASKS = 3
#: the batch_prove phase: statements (the durable daemon's users, 4
#: chunks), proofs (one full chunk and 4096), tampered share, the sample
#: the host Verifier checks, the width where the plain prover on the CPU
#: and the card must give the same bytes
PROVE_STATEMENTS = 65536
PROVE_PROOFS = 20480
PROVE_TAMPER_EVERY = 100
PROVE_HOST_SAMPLE = 64
PROVE_PLAIN_N = 64
#: the device_challenges phase's timed row counts and turns
CHALLENGE_NS = (4096, 16384)
CHALLENGE_REPS = 3
#: the audit phase: the client's stream subcommand (users, proofs), the
#: unary logins after the batch wave (the last one tampered), the size at
#: which the daemon's proof log seals a segment (a record is ~520 bytes, so
#: the ~8,200-record trail seals several), the synthetic log (records,
#: users, reject and lying-verdict shares) and the replay quantum.  The
#: stream and the synthetic log were 8192 and 16,384 before the
#: multi-device phases were added, and the segments twice as large: halved
#: to keep the whole script inside its time limit
AUDIT_STREAM_USERS = 64
AUDIT_STREAM_PROOFS = 4096
AUDIT_UNARY = 4
AUDIT_SEGMENT_BYTES = 1 << 20
AUDIT_SYNTH_N = 8192
AUDIT_SYNTH_USERS = 64
AUDIT_REJECT_FRAC = 0.01
AUDIT_MISMATCH_FRAC = 0.005
AUDIT_QUANTUM = 4096
#: the replication phase: users registered across the two-partition fleet,
#: the CreateChallenge calls started at partition 1's primary before its
#: SIGKILL and how many of them must be acknowledged first, the lease and
#: renewal of ``[replication]`` (the reference's defaults), the size at
#: which each primary's proof log seals a segment (its ~1,000 login records
#: seal two, which ship to its standby), and the logins of each wave (4096
#: before the per-row ladders became kernels: halved, with the controller
#: phase's, to keep the whole script inside its time limit)
REPL_USERS = 65536
REPL_LOGINS = 2048
REPL_FURTHER = 1024
REPL_KILL_AFTER = 512
REPL_LEASE_MS = 3000.0
REPL_RENEW_MS = 500.0
REPL_AUDIT_SEGMENT_BYTES = 1 << 18
#: the registration calls in flight at once.  Each call's acknowledgement
#: waits for its standby within the 1 s ``sync_timeout_ms``, so a wider
#: window can time out; the width at which ``RegisterBatch`` starts to
#: fail is not measured, and 4 stands for no user's traffic
REPL_REGISTER_IN_FLIGHT = 4


#: every emitted line is also appended here, so the whole record survives
#: where only the end of the output is kept
JSONL_OUT = os.path.join("chiprun_out", "chip_smoke.jsonl")


#: the script's start, for each phase line's ``elapsed_s``
T_START = time.perf_counter()


def emit(obj: dict) -> None:
    if "phase" in obj:
        obj = {**obj, "elapsed_s": time.perf_counter() - T_START}
    line = json.dumps(obj)
    print(line, flush=True)
    with open(JSONL_OUT, "a") as f:
        f.write(line + "\n")


class SeededRng:
    """``fill_bytes`` from a seeded generator: reproducible witnesses and
    nonces for the corpus (verification itself draws from SecureRng)."""

    def __init__(self, seed: int):
        import numpy as np

        self._g = np.random.default_rng(seed)

    def fill_bytes(self, n: int) -> bytes:
        return self._g.bytes(n)


def nvidia_smi(fields: str) -> str:
    res = subprocess.run(
        ["nvidia-smi", f"--query-gpu={fields}", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return res.stdout.strip().splitlines()[0]


def synchronize() -> None:
    import torch

    torch.cuda.synchronize()


def launches_of(fn, names=LADDER_KERNELS):
    """(fn(), kernel launches per wrapper of ``names`` during it)."""
    from cpzk_tpu_torch.ops.point_kernels import all_launches

    before = all_launches()
    out = fn()
    after = all_launches()
    return out, {k: after[k] - before[k] for k in names}


def profiled(work):
    """(name, device us, count) of every device event of one ``work()``
    call under torch.profiler, after one warm-up call that is traced and
    discarded (tracing can drop events while it starts up)."""
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule

    traces = []
    synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1),
                 on_trace_ready=lambda p: traces.append(p.key_averages())) as prof:
        for _ in range(2):
            work()
            synchronize()
            prof.step()
    events = traces[-1]
    field = ("self_device_time_total"
             if events and hasattr(events[0], "self_device_time_total")
             else "self_cuda_time_total")
    # the step's own range appears as a device event spanning the whole
    # step; it is not a kernel
    return [(evt.key, getattr(evt, field), evt.count) for evt in events
            if getattr(evt, "device_type", None) == torch.autograd.DeviceType.CUDA
            and not evt.key.startswith("ProfilerStep")]


def device_ms(name: str, kernel, plain, reps: int, plain_reps: int,
              kernels: tuple[str, ...] | None = None) -> dict:
    """Device time per call of a kernel and of its plain version: the
    kernel's own events (by name: ``kernels``, the ``__global__`` functions
    one call launches, by default ``<name>_kernel``) over ``reps`` calls,
    and every device event of ``plain_reps`` calls of the plain version
    (``plain=None``: the kernel alone)."""
    kernels = kernels or (f"{name}_kernel",)

    def work():
        for _ in range(reps):
            kernel()
        for _ in range(plain_reps if plain is not None else 0):
            plain()

    # the profiler can miss a step's launches altogether; such a step is
    # traced again, up to three times in all
    for _ in range(3):
        ours_us = other_us = 0.0
        ours_count = other_count = 0
        for key, us, count in profiled(work):
            if any(f"::{k}(" in key for k in kernels):
                ours_us += us
                ours_count += count
            else:
                other_us += us
                other_count += count
        if ours_count >= 1 and (other_us > 0 or plain is None):
            break
    else:
        raise AssertionError(f"{name}: the profiler saw no device time")
    return {"ms": ours_us / 1e3 / (ours_count / len(kernels)),
            "plain_ms": other_us / 1e3 / plain_reps if plain is not None else None,
            "profiled_launches": ours_count, "expected_launches": reps * len(kernels),
            "plain_kernel_launches_per_call":
                other_count / plain_reps if plain is not None else None}


def kernel_ms(kernel, plain, reps: int, turns: int = 3) -> dict:
    """Time per launch of a kernel on the card's timeline, and of one call
    of its plain version, by ``bench_kernels.event_ms``.  The kernel:
    ``reps`` launches held behind a spin kernel until the host has enqueued
    them all, so they run back to back, between two CUDA events; the median
    of ``turns`` such runs.  The plain version: CUDA events around one call
    after a warm one (its launches are host-bound, so the idle stretches
    between them are in it); ``plain`` may instead be the milliseconds of a
    call already timed so.  (torch.profiler takes minutes over a plain
    version of hundreds of thousands of launches, and on the H100 it saw
    none of a few short launches traced alone.)"""
    import statistics

    from cpzk_tpu_torch.bench_kernels import event_ms

    kernel()
    runs = [event_ms(kernel, reps, hold=True) for _ in range(turns)]
    if callable(plain):
        plain()
        plain = event_ms(plain)
    return {"ms": statistics.median(runs), "ms_runs": runs, "reps": reps,
            "timed_by": "CUDA events around launches held behind a spin kernel",
            "plain_ms": plain, "plain_timed_by": "CUDA events around one call"}


def launch_floor(dev) -> dict:
    """An empty kernel (``cpzk_launch_floor``, no wrapper, no counter) timed
    by ``kernel_ms``: what a launch costs under that timer, the floor of the
    small kernels beside their bounds."""
    import torch

    from cpzk_tpu_torch.ops import point_kernels as pk

    lib = pk.library()
    stream = torch.cuda.current_stream(dev).cuda_stream

    def launch() -> None:
        rc = lib.cpzk_launch_floor(stream)
        if rc:
            raise RuntimeError(f"cpzk_launch_floor failed: CUDA error {rc}")

    lat = kernel_ms(launch, None, SMALL_REPS)
    return {"launch_floor_ms": lat["ms"], "launch_floor_runs": lat["ms_runs"]}


def kernels_vs_plain(dev, ns, int32_ops_per_s: float, gen) -> dict:
    """Phase 3: every kernel against its plain version at each lane count."""
    import numpy as np
    import torch

    from cpzk_tpu_torch.core import edwards
    from cpzk_tpu_torch.ops import curve, limbs, point_kernels as pk

    host_pts = [
        edwards.pt_scalar_mul(edwards.BASEPOINT,
                              int.from_bytes(gen.fill_bytes(32), "little"))
        for _ in range(256)
    ]
    base = curve.points_to_device(host_pts, dev)
    np_rng = np.random.default_rng(SEED)
    b = limbs.BOUND
    adversarial = np.stack([
        np.full(limbs.NLIMBS, b, dtype=np.int32),
        np.full(limbs.NLIMBS, -b, dtype=np.int32),
        np.asarray([b if i % 2 else -b for i in range(limbs.NLIMBS)], dtype=np.int32),
        np.asarray([-b] + [b] * (limbs.NLIMBS - 1), dtype=np.int32),
    ], axis=-1)
    adv = torch.from_numpy(adversarial).to(dev)  # [20, 4]

    def random_points(n: int):
        """n valid points (sums of two random basis points, loose limbs);
        from 4 lanes up, the first 4 lanes' coordinates are the adversarial
        patterns."""
        i1 = torch.from_numpy(np_rng.integers(0, 256, n)).to(dev)
        i2 = torch.from_numpy(np_rng.integers(0, 256, n)).to(dev)
        p = pk.point_add_plain(tuple(c[:, i1] for c in base),
                               tuple(c[:, i2] for c in base))
        if n >= 4:
            k = int(np_rng.integers(0, 4))
            p = tuple(torch.cat([torch.roll(adv, k + c, dims=1), p[c][:, 4:]], dim=1)
                      for c in range(4))
        return p

    def bound_ms(name: str, n: int) -> tuple[float, str]:
        if name == "point_add":
            nbytes, ops = 12 * 80 * n, pk.ADD_OPS_PER_LANE * n
        else:
            nbytes, ops = 7 * 80 * n, pk.double_k_ops_per_lane(4) * n
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = ops / int32_ops_per_s * 1e3
        return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")

    rows = {"point_add": [], "point_double_k": []}
    for n in ns:
        p = random_points(n)
        q = random_points(n)
        cases = {
            "point_add": (lambda p=p, q=q: pk.point_add(p, q),
                          lambda p=p, q=q: pk.point_add_plain(p, q)),
            "point_double_k": (lambda p=p: pk.point_double_k(p, 4),
                               lambda p=p: pk.point_double_k_plain(p, 4)),
        }
        for name, (kernel, plain) in cases.items():
            out = kernel()
            synchronize()
            ref = plain()
            err = max(int((limbs.canonical(a) - limbs.canonical(r)).abs().max())
                      for a, r in zip(out, ref))
            limb_max = max(int(a.abs().max()) for a in out)
            if err != 0 or limb_max > limbs.BOUND:
                raise AssertionError(
                    f"{name} n={n}: canonical error {err}, max limb {limb_max}")
            b_ms, b_by = bound_ms(name, n)
            rows[name].append({
                "n": n, "max_abs_err": err, "max_limb": limb_max,
                "limbs_identical": all(torch.equal(a, r) for a, r in zip(out, ref)),
                "bound_ms": b_ms, "bound_by": b_by,
            })
            rows[name][-1].update(device_ms(name, kernel, plain, 20, 3))
    return rows


def make_corpus(n: int, gen):
    """n distinct context-bound proofs from the port's host prover, and the
    provers (the login_state phase proves fresh challenges with them)."""
    from cpzk_tpu_torch import Parameters, Prover, Ristretto255, Transcript, Witness

    params = Parameters.new()
    corpus, provers = [], []
    for i in range(n):
        prover = Prover(params, Witness(Ristretto255.random_scalar(gen)))
        ctx = b"chip-smoke-%d" % i
        t = Transcript()
        t.append_context(ctx)
        corpus.append((prover.statement, prover.prove_with_transcript(gen, t), ctx))
        provers.append(prover)
    return params, corpus, provers


def host_core(dev, gen, n: int, sample: int) -> tuple[dict, object, list, list]:
    """Phase 2b: build and load the host core, make the corpus on its comb,
    and time the host-prep pieces of the main path at the serving width."""
    import torch

    from cpzk_tpu_torch import BatchVerifier, CpuBackend
    from cpzk_tpu_torch.core import _native, edwards
    from cpzk_tpu_torch.core.transcript import (
        derive_challenges_batch, derive_challenges_batch_pure)
    from cpzk_tpu_torch.ops import curve
    from cpzk_tpu_torch.ops.backend import _pad_lanes
    from cpzk_tpu_torch.protocol.gadgets import Proof

    t0 = time.perf_counter()
    lib_path = _native.build()
    build_s = time.perf_counter() - t0
    _native.load()
    load_s = time.perf_counter() - t0 - build_s

    t0 = time.perf_counter()
    params, corpus, provers = make_corpus(CORPUS, gen)
    corpus_s = time.perf_counter() - t0

    m = len(corpus)
    gw, hw = params.generator_g.wire(), params.generator_h.wire()
    cols = ([b"host-core-%d" % i for i in range(n)], [gw] * n, [hw] * n,
            [corpus[i % m][0].y1.wire() for i in range(n)],
            [corpus[i % m][0].y2.wire() for i in range(n)],
            [corpus[i % m][1].commitment.r1.wire() for i in range(n)],
            [corpus[i % m][1].commitment.r2.wire() for i in range(n)])
    t0 = time.perf_counter()
    challenges = derive_challenges_batch(*cols)
    challenge_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    pure = derive_challenges_batch_pure(*(c[:sample] for c in cols))
    pure_s = time.perf_counter() - t0
    if [c.value for c in challenges[:sample]] != [c.value for c in pure]:
        raise AssertionError("native challenges differ from the pure-Python twin")

    wires = [corpus[i % m][1].to_bytes() for i in range(n)]
    parse_us = {}
    for mode, deferred in (("eager", False), ("deferred", True)):
        t0 = time.perf_counter()
        parsed = Proof.from_bytes_batch(wires, defer_point_validation=deferred)
        parse_us[mode] = (time.perf_counter() - t0) / n * 1e6
        if any(not isinstance(p, Proof) or p.deferred != deferred
               or p.to_bytes() != w for p, w in zip(parsed, wires)):
            raise AssertionError(f"{mode} parse of {n} valid wires failed")
    # the deferred proofs' screening (one native deep parse), as
    # BatchVerifier.prepare_batch runs it for a backend that prefers the
    # combined check
    bv = BatchVerifier(backend=CpuBackend(), max_size=n)
    for i, p in enumerate(parsed):
        bv.add_with_context(params, corpus[i % m][0], p, None)
    t0 = time.perf_counter()
    if bv._screen_deferred() or any(p.deferred for p in parsed):
        raise AssertionError("screening rejected or left a valid deferred proof")
    parse_us["deferred_screen"] = (time.perf_counter() - t0) / n * 1e6

    # four columns of one combined check (n rows + the correction row)
    lanes = n + 1
    pad = _pad_lanes(lanes)
    point_wires = [b"".join(c[i % n] for i in range(lanes)) for c in cols[3:7]]
    curve.wires_to_device(point_wires[0], pad, dev)  # warm: first allocations
    decode_ms = []
    for blob in point_wires:
        synchronize()
        t0 = time.perf_counter()
        soa = curve.wires_to_device(blob, pad, dev)
        synchronize()
        decode_ms.append((time.perf_counter() - t0) * 1e3)
    picks = list(range(0, lanes, max(1, lanes // sample)))[:sample]
    last = point_wires[-1]
    ref = curve.points_soa(
        [edwards.ristretto_decode(last[32 * i:32 * i + 32]) for i in picks], len(picks), dev)
    idx = torch.tensor(picks, device=dev)
    if not all(torch.equal(c.index_select(1, idx), r) for c, r in zip(soa, ref)):
        raise AssertionError("wires_to_device limbs differ from points_soa")
    return {
        "library": lib_path.name, "build_s": build_s, "load_s": load_s,
        "threads": _native.default_threads(), "cpu_count": os.cpu_count(),
        "affinity_cpus": len(os.sched_getaffinity(0)),
        "corpus_proofs": m, "corpus_s": corpus_s,
        "challenge_rows": n, "challenge_us_per_row": challenge_s / n * 1e6,
        "challenge_pure_us_per_row": pure_s / sample * 1e6,
        "challenge_sample_equal": sample,
        "parse_us_per_proof": parse_us,
        "wires_to_device_ms": decode_ms, "wires_to_device_lanes": lanes,
        "wires_to_device_pad": pad,
        "wires_to_device_us_per_point": sum(decode_ms) * 1e3 / (4 * lanes),
        "limbs_sample_equal": len(picks),
    }, params, corpus, provers


class GcPauses:
    """Seconds the interpreter has spent in garbage collections since
    :meth:`start` (``gc.callbacks``), to tell a collection's pause from the
    work it lands in."""

    def __init__(self):
        self.seconds = 0.0
        self._t0 = 0.0

    def _callback(self, phase, info) -> None:
        if phase == "start":
            self._t0 = time.perf_counter()
        else:
            self.seconds += time.perf_counter() - self._t0

    def start(self) -> None:
        gc.callbacks.append(self._callback)

    def stop(self) -> None:
        gc.callbacks.remove(self._callback)


def counting_fallback(calls: list):
    """The host fallback handed to ``build_backend``: the port's
    ``CpuBackend``, adding one to ``calls[0]`` for every call the breaker
    routes to it (the phases that pass it require none)."""
    from cpzk_tpu_torch import CpuBackend

    class CountingCpuBackend(CpuBackend):
        def verify_combined(self, rows, beta):
            calls[0] += 1
            return super().verify_combined(rows, beta)

        def verify_each(self, rows):
            calls[0] += 1
            return super().verify_each(rows)

    return CountingCpuBackend()


class RecordingBackend:
    """The GPU backend, recording the rows it is handed (their count per
    call, and their r1 wires) to show which rows reached the card."""

    def __init__(self, backend):
        self.backend = backend
        self.prefers_combined = backend.prefers_combined
        self.supports_deferred_decode = backend.supports_deferred_decode
        self.calls: list[int] = []
        self.seen: set[bytes] = set()

    def _record(self, rows) -> None:
        self.calls.append(len(rows))
        self.seen.update(r.r1.wire() for r in rows)

    def verify_combined(self, rows, beta):
        self._record(rows)
        return self.backend.verify_combined(rows, beta)

    def verify_each(self, rows):
        self._record(rows)
        return self.backend.verify_each(rows)


def serving_wires(params, corpus, n: int):
    """The n entries of phase 4 as wire bytes (proof wire, statement wires,
    context), tiling the corpus; the about 1% tampered rows, and the 2 rows
    whose commitment wire does not decode."""
    from cpzk_tpu_torch.core.scalars import L

    m = len(corpus)
    valid = []
    for i in range(n):
        st, pr, ctx = corpus[i % m]
        valid.append((pr.to_bytes(), st.y1.wire(), st.y2.wire(), ctx))
    mixed = list(valid)
    bad = {}
    step = max(2, n // 42)
    for k, idx in enumerate(range(37 % n, n, step)):
        wire, y1, y2, ctx = valid[idx]
        how = ("wrong_s", "wrong_context", "swapped_r1")[k % 3]
        if how == "wrong_s":
            s = int.from_bytes(wire[77:], "little") + 1
            if s % L == 0:
                s += 1
            wire = wire[:77] + (s % L).to_bytes(32, "little")
        elif how == "wrong_context":
            ctx = ctx + b"-replayed"
        else:
            other = valid[(idx + 1) % n][0]
            wire = wire[:5] + other[5:37] + wire[37:]
        mixed[idx] = (wire, y1, y2, ctx)
        bad[idx] = how
    undecodable = [i for i in (1, n - 2) if i not in bad]
    for i in undecodable:
        wire, y1, y2, ctx = valid[i]
        mixed[i] = (wire[:5] + b"\xff" * 32 + wire[37:], y1, y2, ctx)
    return valid, mixed, bad, undecodable


def parse_entries(entries, deferred: bool):
    """Proofs and statements parsed from wire bytes as a server parses them."""
    from cpzk_tpu_torch import Ristretto255, Statement
    from cpzk_tpu_torch.protocol.gadgets import Proof

    t0 = time.perf_counter()
    proofs = Proof.from_bytes_batch([e[0] for e in entries],
                                    defer_point_validation=deferred)
    t1 = time.perf_counter()
    statements = [Statement(Ristretto255.element_from_bytes(e[1]),
                            Ristretto255.element_from_bytes(e[2])) for e in entries]
    t2 = time.perf_counter()
    return proofs, statements, t1 - t0, t2 - t1


def serving_batch(backend, params, corpus, n: int, sub_n: int) -> tuple[dict, dict]:
    """Phase 4: 4096 entries parsed from wire bytes, all-valid (eager and
    deferred) and mixed (deferred), through ``BatchVerifier``; a sub-batch
    against the port's CpuBackend and the pure-Python verifier."""
    from cpzk_tpu_torch import (
        BatchVerifier, CpuBackend, Error, InvalidGroupElement, InvalidParams,
        InvalidProofEncoding, SecureRng, Verifier)
    from cpzk_tpu_torch.protocol.gadgets import Proof

    bad_point = "Bytes do not represent a valid Ristretto point"
    valid, mixed, bad, undecodable = serving_wires(params, corpus, n)

    def batch(entries, proofs, statements, verifier_backend) -> BatchVerifier:
        bv = BatchVerifier(backend=verifier_backend, max_size=n)
        for (_, _, _, ctx), pr, st in zip(entries, proofs, statements):
            bv.add_with_context(params, st, pr, ctx)
        return bv

    def run(bv: BatchVerifier):
        """(results, host s, backend s, host CPU s of all threads)."""
        c0, t0 = time.process_time(), time.perf_counter()
        prepared = bv.prepare_batch(SecureRng())
        c1, t1 = time.process_time(), time.perf_counter()
        results = bv.run_prepared(prepared)
        synchronize()
        return results, t1 - t0, time.perf_counter() - t1, c1 - c0

    def as_text(results):
        return [None if r is None else (type(r).__name__, str(r)) for r in results]

    timings = {}
    valid_launches = None
    pauses = GcPauses()
    for mode, deferred in (("eager", False), ("deferred", True)):
        pauses.start()
        try:
            proofs, statements, proof_s, stmt_s = parse_entries(valid, deferred)
            parse_gc_s = pauses.seconds
            if not all(isinstance(p, Proof) and p.deferred == deferred for p in proofs):
                raise AssertionError(f"{mode} parse of the valid wires failed")
            (results, host_s, backend_s, host_cpu_s), launches = launches_of(
                lambda: run(batch(valid, proofs, statements, backend)))
        finally:
            pauses.stop()
        gc_s, pauses.seconds = pauses.seconds, 0.0
        if results != [None] * n:
            raise AssertionError(f"all-valid {n}-entry batch ({mode}) was not fully accepted")
        if valid_launches is None:
            valid_launches = launches
        timings[mode] = {
            "parse_proofs_s": proof_s, "parse_statements_s": stmt_s,
            "host_s": host_s, "host_cpu_s": host_cpu_s, "backend_s": backend_s,
            "gc_pause_s": gc_s, "gc_pause_in_parse_s": parse_gc_s,
            "backend_rows_per_s": n / backend_s,
            "verify_rows_per_s": n / (host_s + backend_s),
            "end_to_end_rows_per_s": n / (proof_s + stmt_s + host_s + backend_s),
        }

    eager, _, _, _ = parse_entries(mixed, False)
    for i in undecodable:
        if type(eager[i]) is not InvalidGroupElement or str(eager[i]) != bad_point:
            raise AssertionError(f"row {i}: eager parse gave {eager[i]!r}")
    if any(isinstance(p, Error) for i, p in enumerate(eager) if i not in undecodable):
        raise AssertionError("eager parse rejected a decodable row")

    proofs, statements, proof_s, stmt_s = parse_entries(mixed, True)
    recording = RecordingBackend(backend)
    pauses.start()
    try:
        results, m_host_s, m_backend_s, _ = run(batch(mixed, proofs, statements, recording))
    finally:
        pauses.stop()
    m_gc_s, pauses.seconds = pauses.seconds, 0.0
    flagged = [i for i, r in enumerate(results) if r is not None]
    if flagged != sorted([*bad, *undecodable]):
        raise AssertionError(f"flagged rows {flagged} != tampered + undecodable rows")
    for i in flagged:
        r = results[i]
        want = ((InvalidProofEncoding, bad_point) if i in undecodable
                else (InvalidParams, "Proof verification failed"))
        if (type(r), str(r)) != want:
            raise AssertionError(f"row {i}: unexpected result {r!r}")
    if any(mixed[i][0][5:37] in recording.seen for i in undecodable):
        raise AssertionError("an undecodable row reached the card")

    sub = mixed[:sub_n]
    proofs, statements, _, _ = parse_entries(sub, True)
    sub_dev, _, _, _ = run(batch(sub, proofs, statements, backend))
    proofs, statements, _, _ = parse_entries(sub, True)
    sub_cpu = batch(sub, proofs, statements, CpuBackend()).verify(SecureRng())
    proofs, statements, _, _ = parse_entries(sub, True)
    sub_pure = []
    for (_, _, _, ctx), pr, st in zip(sub, proofs, statements):
        try:
            Verifier(params, st).verify_pure(pr, ctx)
            sub_pure.append(None)
        except Error as exc:
            sub_pure.append(exc)
    if as_text(sub_dev) != as_text(sub_cpu):
        raise AssertionError(f"{sub_n}-entry sub-batch disagrees with CpuBackend")
    if as_text(sub_dev) != as_text(sub_pure):
        raise AssertionError(f"{sub_n}-entry sub-batch disagrees with the pure verifier")

    parse = {
        "n": n, "tolerance": "exact",
        "eager_us_per_proof": timings["eager"]["parse_proofs_s"] / n * 1e6,
        "deferred_us_per_proof": timings["deferred"]["parse_proofs_s"] / n * 1e6,
        "statements_us_per_entry": timings["eager"]["parse_statements_s"] / n * 1e6,
        "undecodable_rows": undecodable,
        "eager_parse_error": bad_point,
    }
    valid_t = timings["eager"]
    return parse, {
        "n": n, "tampered": len(bad), "undecodable": len(undecodable),
        "valid_host_s": valid_t["host_s"], "valid_backend_s": valid_t["backend_s"],
        "valid_backend_rows_per_s": valid_t["backend_rows_per_s"],
        "valid_verify_rows_per_s": valid_t["verify_rows_per_s"],
        "valid_end_to_end_rows_per_s": valid_t["end_to_end_rows_per_s"],
        "valid_launches": valid_launches,
        "valid": timings,
        "mixed_host_s": m_host_s, "mixed_backend_s": m_backend_s, "mixed_gc_pause_s": m_gc_s,
        "mixed_backend_rows_per_s": n / m_backend_s,
        "mixed_verify_rows_per_s": n / (m_host_s + m_backend_s),
        "mixed_rows_per_backend_call": recording.calls,
        "sub_batch": sub_n, "sub_batch_rejected": sum(r is not None for r in sub_dev),
        "sub_batch_matches": ["CpuBackend", "Verifier.verify_pure"],
    }


def north_star_rows(params, corpus, n: int, rng):
    """n backend rows tiling the corpus, each with a fresh alpha (as
    bench.py builds its rows), and beta."""
    from cpzk_tpu_torch import Ristretto255
    from cpzk_tpu_torch.core.transcript import derive_challenges_batch
    from cpzk_tpu_torch.protocol.batch import BatchRow

    eb = Ristretto255.element_to_bytes
    m = len(corpus)
    challenges = derive_challenges_batch(
        [ctx for _, _, ctx in corpus],
        [eb(params.generator_g)] * m, [eb(params.generator_h)] * m,
        [eb(st.y1) for st, _, _ in corpus], [eb(st.y2) for st, _, _ in corpus],
        [eb(pr.commitment.r1) for _, pr, _ in corpus],
        [eb(pr.commitment.r2) for _, pr, _ in corpus],
    )
    alphas = Ristretto255.random_scalars(rng, n)
    rows = []
    for i in range(n):
        st, pr, _ = corpus[i % m]
        rows.append(BatchRow(
            g=params.generator_g, h=params.generator_h, y1=st.y1, y2=st.y2,
            r1=pr.commitment.r1, r2=pr.commitment.r2, s=pr.response.s,
            c=challenges[i % m], alpha=alphas[i]))
    return rows, Ristretto255.random_scalar(rng)


def north_star(backend, rows, beta) -> dict:
    """Phase 5: the combined check on all rows, valid then one tampered."""
    from cpzk_tpu_torch.core.ristretto import Scalar
    from cpzk_tpu_torch.protocol.batch import BatchRow

    n = len(rows)
    t0 = time.perf_counter()
    ok, valid_launches = launches_of(lambda: backend.verify_combined(rows, beta))
    synchronize()
    valid_s = time.perf_counter() - t0
    if ok is not True:
        raise AssertionError(f"{n}-row combined check rejected a valid batch")
    bad = list(rows)
    k = (7 * n) // 15
    r = bad[k]
    bad[k] = BatchRow(r.g, r.h, r.y1, r.y2, r.r1, r.r2,
                      Scalar(r.s.value + 1), r.c, r.alpha)
    t0 = time.perf_counter()
    ok_bad = backend.verify_combined(bad, beta)
    synchronize()
    tampered_s = time.perf_counter() - t0
    if ok_bad is not False:
        raise AssertionError(f"{n}-row combined check accepted a tampered row")
    return {"rows": n, "lanes": n + 1, "valid_s": valid_s, "tampered_s": tampered_s,
            "backend_rows_per_s": n / valid_s, "valid_launches": valid_launches}


class LogCapture:
    """Records of the port's loggers during the serving phase (the
    prewarm report of ``build_backend``, and any breaker warning)."""

    def __init__(self):
        import logging

        self.records: list = []
        self._handler = logging.Handler(logging.INFO)
        self._handler.emit = self.records.append
        self._logger = logging.getLogger("cpzk_tpu_torch")

    def __enter__(self):
        import logging

        self._level = self._logger.level
        self._logger.setLevel(logging.INFO)
        self._logger.addHandler(self._handler)
        return self

    def __exit__(self, *exc):
        self._logger.removeHandler(self._handler)
        self._logger.setLevel(self._level)


def percentile(values, q: float) -> float:
    ordered = sorted(values)
    return ordered[min(len(ordered) - 1, max(0, -(-int(q * len(ordered)) // 100) - 1))]


def serving_plane(params, corpus, n: int, closed_total: int, clients: int,
                  group: int) -> dict:
    """Phase 5b: the single-card serving plane, as a server drives it.
    ``build_backend`` on cuda:0 (prewarm at ``n``), then in one event loop
    a burst of ``n`` single-entry ``submit`` calls, which must dispatch as
    one batch of ``n``, and a closed loop of ``clients`` tasks each
    awaiting ``submit_many`` of ``group``-entry groups until
    ``closed_total`` entries are answered; then the closed loop again on a
    ``pipeline_depth=1`` plane.  Every result is held against its
    expectation, and the breaker must stay closed on the card."""
    import asyncio

    import torch

    from cpzk_tpu_torch import InvalidParams, Ristretto255, Statement
    from cpzk_tpu_torch.observability import get_flight_recorder
    from cpzk_tpu_torch.ops import ladder_kernels as lk
    from cpzk_tpu_torch.ops.backend import TorchBackend
    from cpzk_tpu_torch.protocol.batch import BatchEntry
    from cpzk_tpu_torch.protocol.gadgets import Proof
    from cpzk_tpu_torch.resilience import BreakerState
    from cpzk_tpu_torch.server import TpuSettings, build_backend, metrics

    fallback_calls = [0]
    valid, mixed, bad, _ = serving_wires(params, corpus, n)
    wires = [mixed[i] if i in bad else valid[i] for i in range(n)]
    proofs = Proof.from_bytes_batch([w[0] for w in wires])
    statements = [Statement(Ristretto255.element_from_bytes(w[1]),
                            Ristretto255.element_from_bytes(w[2])) for w in wires]
    contexts = [w[3] for w in wires]
    expected = [("InvalidParams", "Proof verification failed") if i in bad else None
                for i in range(n)]

    def entry(i: int) -> BatchEntry:
        return BatchEntry(params, statements[i], proofs[i], contexts[i])

    def check(indices, results, part: str) -> None:
        got = [None if r is None else (type(r).__name__, str(r)) for r in results]
        want = [expected[i] for i in indices]
        if got != want:
            wrong = [i for i, g, w in zip(indices, got, want) if g != w][:5]
            raise AssertionError(f"serving_plane {part}: wrong results at rows {wrong}")
        if any(r is not None and type(r) is not InvalidParams for r in results):
            raise AssertionError(f"serving_plane {part}: unexpected error type")

    hist_names = (("queue_wait", "tpu.batch.queue_wait", None),
                  ("host_time", "tpu.batch.host_time", None),
                  ("device_time", "tpu.batch.device_time", {"backend": "primary"}))

    def hists() -> dict:
        return {k: metrics.read_histogram(name, labels=labels)
                for k, name, labels in hist_names}

    def part_report(entries: int, wall_s: float, latencies, h0, records, gc_s: float):
        h1 = hists()
        gaps = [r.dispatch_gap_s for r in records[1:]]
        return {
            "entries": entries, "wall_s": wall_s, "entries_per_s": entries / wall_s,
            "gc_pause_s": gc_s,
            "batch_wall_ms": [r.wall_s * 1e3 for r in records],
            "queue_wait_mean_ms": [r.queue_wait_s * 1e3 for r in records],
            "latency_p50_ms": percentile(latencies, 50) * 1e3,
            "latency_p99_ms": percentile(latencies, 99) * 1e3,
            "requests": len(latencies),
            "batches": len(records), "batch_sizes": [r.batch for r in records],
            "dispatch_gap_ms": [r.dispatch_gap_s * 1e3 for r in records],
            "dispatch_gap_mean_ms": (sum(gaps) / len(gaps) * 1e3) if gaps else None,
            "device_interval_s": [r.device_interval_s for r in records],
            "device_interval_share": sum(r.device_interval_s for r in records) / wall_s,
            "stages_ms": {k: sum(r.stages_s.get(k, 0.0) for r in records) * 1e3
                          for k in ("thread_hop", "pad_and_pack", "device_wait",
                                    "marshal", "execute", "unpack")},
            "histograms": {k: {"count": h1[k][0] - h0[k][0], "sum_s": h1[k][1] - h0[k][1]}
                           for k in h1},
        }

    async def burst(batcher) -> dict:
        recorder = get_flight_recorder()
        recorder.clear()
        h0 = hists()
        pauses = GcPauses()
        pauses.start()
        t0 = time.perf_counter()
        done_at = [0.0] * n

        async def one(i):
            r = await batcher.submit(params, statements[i], proofs[i], contexts[i])
            done_at[i] = time.perf_counter()
            return r

        try:
            results = await asyncio.gather(*[one(i) for i in range(n)])
            wall = time.perf_counter() - t0
        finally:
            pauses.stop()
        check(range(n), results, "burst")
        records = recorder.snapshot()
        if [r.batch for r in records] != [n]:
            raise AssertionError(f"burst dispatched as {[r.batch for r in records]}, "
                                 f"not one batch of {n}")
        return part_report(n, wall, [d - t0 for d in done_at], h0, records,
                           pauses.seconds)

    async def closed_loop(batcher) -> dict:
        recorder = get_flight_recorder()
        recorder.clear()
        h0 = hists()
        groups = closed_total // group
        issued = [0]
        latencies: list[float] = []

        async def client():
            while issued[0] < groups:
                g = issued[0]
                issued[0] += 1
                lo = (g * group) % n
                idx = range(lo, lo + group)
                t = time.perf_counter()
                results = await batcher.submit_many([entry(i) for i in idx])
                latencies.append(time.perf_counter() - t)
                check(idx, results, f"closed loop group {g}")

        pauses = GcPauses()
        pauses.start()
        t0 = time.perf_counter()
        try:
            await asyncio.gather(*[client() for _ in range(clients)])
            wall = time.perf_counter() - t0
        finally:
            pauses.stop()
        records = recorder.snapshot()
        if sum(r.batch for r in records) != closed_total:
            raise AssertionError("closed loop: dispatched entries != answered entries")
        return part_report(closed_total, wall, latencies, h0, records,
                           pauses.seconds)

    def settings(depth: int) -> TpuSettings:
        return TpuSettings(backend="tpu", batch_max=n, batch_window_ms=5.0,
                           pipeline_depth=depth, prewarm_quanta=str(n))

    out = {"n": n, "tampered": len(bad), "closed_total": closed_total,
           "clients": clients, "group": group, "tolerance": "exact"}
    failover0 = metrics.read("tpu.backend.failover")
    before = dict(lk.LAUNCHES)
    bare, _ = build_backend(TpuSettings(backend="tpu", prewarm_quanta=""))
    if type(bare) is not TorchBackend:
        raise AssertionError(f"build_backend with no fallback served {type(bare).__name__}")
    out["default_backend"] = type(bare).__name__
    with LogCapture() as logs:
        t0 = time.perf_counter()
        backend, batcher = build_backend(settings(2), fallback=counting_fallback(fallback_calls))
        out["build_backend_s"] = time.perf_counter() - t0
        out["prewarm_launches"] = {k: lk.LAUNCHES[k] - before[k] for k in before}
        backend1, batcher1 = build_backend(settings(1), fallback=counting_fallback(fallback_calls))

        # the served traffic, with the launch counts set to 0 just before it
        lk.reset_launches()

        async def depth2():
            batcher.start()
            try:
                return await burst(batcher), await closed_loop(batcher)
            finally:
                await batcher.stop()

        async def depth1():
            batcher1.start()
            try:
                return await closed_loop(batcher1)
            finally:
                await batcher1.stop()

        out["burst"], out["closed_loop_depth2"] = asyncio.run(depth2())
        out["closed_loop_depth1"] = asyncio.run(depth1())
        torch.cuda.synchronize()
        out["launches_in_serving_plane"] = dict(lk.LAUNCHES)
    out["prewarm_s"] = [r.prewarm_s for r in logs.records
                        if hasattr(r, "prewarm_s")]
    out["warnings"] = [r.getMessage() for r in logs.records if r.levelno >= 30]
    out["breaker"] = [backend.state.value, backend1.state.value]
    out["failover"] = metrics.read("tpu.backend.failover") - failover0
    out["degraded_seconds"] = [backend.breaker.degraded_seconds,
                               backend1.breaker.degraded_seconds]
    out["fallback_calls"] = fallback_calls[0]
    if (backend.state is not BreakerState.CLOSED or backend1.state is not BreakerState.CLOSED
            or out["failover"] > 0 or max(out["degraded_seconds"]) > 0
            or metrics.read("tpu.backend.degraded_seconds", kind="g") > 0):
        raise AssertionError(f"serving_plane left the card: breaker {out['breaker']}, "
                             f"failover {out['failover']}, warnings {out['warnings']}")
    if fallback_calls[0]:
        raise AssertionError(f"the host fallback was called {fallback_calls[0]} times")
    for name in SERVED_KERNELS:
        if out["launches_in_serving_plane"][name] < 1:
            raise AssertionError(f"{name} was never launched by the served traffic")
    return out


def encode_batch_request(user_ids, challenge_ids, proofs) -> bytes:
    """An ``auth.BatchVerificationRequest`` in protobuf wire encoding, by
    hand (this phase runs with no protobuf runtime): fields 1, 2 and 3 are
    repeated length-delimited (tags 0x0a, 0x12, 0x1a), each item a varint
    length and its bytes."""

    def varint(n: int) -> bytes:
        out = bytearray()
        while True:
            byte, n = n & 0x7F, n >> 7
            out.append(byte | (0x80 if n else 0))
            if not n:
                return bytes(out)

    out = bytearray()
    for tag, items in ((0x0A, [u.encode() for u in user_ids]), (0x12, challenge_ids),
                       (0x1A, proofs)):
        for item in items:
            out += bytes([tag]) + varint(len(item)) + item
    return bytes(out)


def login_state(params, corpus, provers, n: int, max_batch_rpc: int, device=None) -> dict:
    """The ``login_state`` phase: the state and wire half of the gRPC
    service on the card, in the stage order of the service's
    ``verify_proof_batch``, with no gRPC and no protobuf runtime.

    A ``ServerState`` and ``build_backend`` at ``batch_max`` ``n`` on
    cuda:0 (prewarmed, with a counting host fallback that must never be
    called); ``n`` users registered from the corpus statements (as the
    Register RPC parses them) and one challenge each; ``n`` logins in
    hand-encoded ``BatchVerificationRequest`` messages of at most
    ``max_batch_rpc`` entries (about 1% tampered, 2 with a commitment that
    does not decode), each parsed by the native wire parse, its challenges
    consumed and users looked up in bulk, its proofs parsed deferred from
    the packed buffer, all messages submitted concurrently to the batcher
    (one batch of ``n``), and sessions minted for the entries that pass.
    Then the first message again: every entry must fail at the consume and
    none may reach the card.  ``device=None`` means cuda:0."""
    import asyncio

    import torch

    from cpzk_tpu_torch import Error, Ristretto255, SecureRng, Statement, Transcript
    from cpzk_tpu_torch.core.scalars import L
    from cpzk_tpu_torch.errors import InvalidProofEncoding
    from cpzk_tpu_torch.observability import get_flight_recorder
    from cpzk_tpu_torch.ops import ladder_kernels as lk
    from cpzk_tpu_torch.protocol.batch import BatchEntry
    from cpzk_tpu_torch.protocol.gadgets import Proof
    from cpzk_tpu_torch.resilience import BreakerState
    from cpzk_tpu_torch.server import ServerState, TpuSettings, UserData, build_backend, metrics
    from cpzk_tpu_torch.server import wire as wire_mod
    from cpzk_tpu_torch.server.state import user_id_error

    bad_point = "Invalid proof: Bytes do not represent a valid Ristretto point"
    fallback_calls = [0]

    class NoProtobuf:
        @staticmethod
        def FromString(data):
            raise AssertionError("the native wire parse punted a well-formed request")

    out = {"n": n, "rpc_entries": max_batch_rpc, "tolerance": "exact"}
    t0 = time.perf_counter()
    backend, batcher = build_backend(
        TpuSettings(backend="tpu", batch_max=n, batch_window_ms=2000.0,
                    prewarm_quanta=str(n)),
        device=device, fallback=counting_fallback(fallback_calls))
    out["build_backend_s"] = time.perf_counter() - t0
    counter = RecordingBackend(backend)
    batcher.backend = counter  # before start(): the lane takes it from here
    state = ServerState()
    rng = SecureRng()
    deser = wire_mod.make_deserializer("VerifyProofBatch", NoProtobuf)
    m = len(corpus)
    user_ids = [f"user-{i:05d}" for i in range(n)]

    async def register_all() -> None:
        for i, uid in enumerate(user_ids):
            st = corpus[i % m][0]
            # as the Register RPC parses a statement: decode, validate,
            # no identity element
            statement = Statement(Ristretto255.element_from_bytes(st.y1.wire()),
                                  Ristretto255.element_from_bytes(st.y2.wire()))
            statement.validate()
            if Ristretto255.is_identity(statement.y1) or Ristretto255.is_identity(statement.y2):
                raise AssertionError("identity statement in the corpus")
            await state.register_user(UserData(uid, statement, int(time.time())))

    async def challenge_all() -> list[bytes]:
        cids = []
        for uid in user_ids:
            cid = state.tag_challenge_id(uid, rng.fill_bytes(32))
            await state.create_challenge(uid, cid)
            cids.append(cid)
        return cids

    t0 = time.perf_counter()
    asyncio.run(register_all())
    out["register_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    cids = asyncio.run(challenge_all())
    out["challenge_s"] = time.perf_counter() - t0
    out["registrations_per_s"] = n / out["register_s"]
    out["challenges_per_s"] = n / out["challenge_s"]

    # proofs of the issued challenges; about 1% tampered, 2 undecodable
    gen = SeededRng(SEED + 6)
    t0 = time.perf_counter()
    wires = []
    for i, cid in enumerate(cids):
        t = Transcript()
        t.append_context(cid)
        wires.append(provers[i % m].prove_with_transcript(gen, t).to_bytes())
    out["prove_s"] = time.perf_counter() - t0
    expected = ["ok"] * n
    step = max(2, n // 42)
    for k, idx in enumerate(range(41 % n, n, step)):
        wire = wires[idx]
        how = ("wrong_s", "wrong_context", "swapped_r1")[k % 3]
        if how == "wrong_s":
            sc = int.from_bytes(wire[77:], "little") + 1
            wire = wire[:77] + ((sc % L) or 1).to_bytes(32, "little")
        elif how == "wrong_context":
            t = Transcript()
            t.append_context(cids[idx] + b"-elsewhere")
            wire = provers[idx % m].prove_with_transcript(gen, t).to_bytes()
        else:
            wire = wire[:5] + wires[(idx + 1) % n][5:37] + wire[37:]
        wires[idx] = wire
        expected[idx] = "Authentication failed"
    for idx in (3, n - 3):
        if expected[idx] == "ok":
            wires[idx] = wires[idx][:5] + b"\xff" * 32 + wires[idx][37:]
            expected[idx] = bad_point
    out["tampered"] = sum(e == "Authentication failed" for e in expected)
    out["undecodable"] = sum(e == bad_point for e in expected)

    bounds = [(lo, min(lo + max_batch_rpc, n)) for lo in range(0, n, max_batch_rpc)]
    messages = [encode_batch_request(user_ids[lo:hi], cids[lo:hi], wires[lo:hi])
                for lo, hi in bounds]
    out["rpc_sizes"] = [hi - lo for lo, hi in bounds]
    out["request_bytes"] = [len(msg) for msg in messages]
    timing = {"parse_s": 0.0, "consume_lookup_s": 0.0, "proof_parse_s": 0.0,
              "sessions_s": 0.0}
    token_rng = SecureRng()

    async def login(data: bytes):
        """One BatchVerificationRequest, in the service's stage order."""
        t0 = time.perf_counter()
        request = deser(data)
        timing["parse_s"] += time.perf_counter() - t0
        if not isinstance(request, wire_mod.NativeBatchVerificationRequest):
            raise AssertionError(f"the native wire parse returned {type(request).__name__}")
        k = len(request.user_ids)
        if not (k == len(request.challenge_ids) == len(request.proofs) <= max_batch_rpc):
            raise AssertionError("the parsed request lost entries")
        messages_ = [""] * k
        staged = []
        for i in range(k):  # stage 1: argument validation
            msg = user_id_error(request.user_ids[i])
            if msg is None and not (0 < len(request.challenge_ids[i]) <= 64
                                    and 0 < len(request.proofs[i]) <= 8192):
                msg = "malformed entry"
            if msg is None:
                staged.append(i)
            messages_[i] = msg or ""
        t0 = time.perf_counter()  # stage 2: consume BEFORE verification
        challenges = await state.consume_challenges([request.challenge_ids[i] for i in staged])
        users = await state.get_users([request.user_ids[i] for i in staged])
        timing["consume_lookup_s"] += time.perf_counter() - t0
        live = []
        for i, ch, user in zip(staged, challenges, users, strict=True):
            if ch is None or ch.user_id != request.user_ids[i] or user is None:
                messages_[i] = "Authentication failed"
                continue
            live.append((i, user))
        t0 = time.perf_counter()  # stage 3: the deferred parse, packed
        packed = request.packed_proofs(k) if len(live) == k else None
        parsed = Proof.from_bytes_batch([request.proofs[i] for i, _ in live],
                                        defer_point_validation=True, packed=packed)
        timing["proof_parse_s"] += time.perf_counter() - t0
        entries, queued = [], []
        for (i, user), proof in zip(live, parsed, strict=True):
            if isinstance(proof, Error):
                messages_[i] = f"Invalid proof: {proof}"
                continue
            entries.append(BatchEntry(params, user.statement, proof,
                                      bytes(request.challenge_ids[i])))
            queued.append(i)
        results = await batcher.submit_many(entries) if entries else []  # stage 4
        verified = []
        for i, res in zip(queued, results, strict=True):
            if res is None:
                verified.append(i)
            elif isinstance(res, InvalidProofEncoding):
                messages_[i] = f"Invalid proof: {res}"
            else:
                messages_[i] = "Authentication failed"
        t0 = time.perf_counter()  # stage 5: one bulk session mint
        pool = token_rng.fill_bytes(32 * len(verified)).hex()
        tokens = {i: state.tag_session_token(request.user_ids[i], pool[64 * j:64 * (j + 1)])
                  for j, i in enumerate(verified)}
        errs = await state.create_sessions([(tokens[i], request.user_ids[i]) for i in verified])
        timing["sessions_s"] += time.perf_counter() - t0
        for i, err in zip(verified, errs, strict=True):
            if err is not None:
                raise AssertionError(f"session mint failed: {err}")
        return request, [(tokens.get(i), messages_[i]) for i in range(k)]

    async def serve_logins():
        batcher.start()
        try:
            recorder = get_flight_recorder()
            recorder.clear()
            # the login traffic, with the launch counts set to 0 just before it
            torch.cuda.synchronize()
            lk.reset_launches()
            pauses = GcPauses()
            pauses.start()
            t0 = time.perf_counter()
            try:
                answers = await asyncio.gather(*[login(msg) for msg in messages])
                wall = time.perf_counter() - t0
            finally:
                pauses.stop()
            torch.cuda.synchronize()
            launches = dict(lk.LAUNCHES)
            batches = [r.batch for r in recorder.snapshot()]
            # the replay: the first message again
            rows0 = sum(counter.calls)
            _, replay = await login(messages[0])
            torch.cuda.synchronize()
            replay_launches = {k: lk.LAUNCHES[k] - launches[k] for k in launches}
            return (answers, wall, pauses.seconds, launches, batches, replay,
                    sum(counter.calls) - rows0, replay_launches)
        finally:
            await batcher.stop()

    (answers, wall, gc_s, launches, batches, replay, replay_rows,
     replay_launches) = asyncio.run(serve_logins())
    tokens, got = [], []
    for (lo, hi), (request, res) in zip(bounds, answers):
        for tok, msg in res:
            tokens.append(tok)
            got.append("ok" if tok is not None else msg)
    parse_s = sum(req._parse_s for req, _ in answers)
    wrong = [i for i, (g, e) in enumerate(zip(got, expected)) if g != e]
    if wrong:
        raise AssertionError(f"login_state: wrong verdicts at {wrong[:5]} "
                             f"({[(got[i], expected[i]) for i in wrong[:5]]})")

    async def sessions_valid() -> int:
        count = 0
        for i, tok in enumerate(tokens):
            if tok is not None:
                if await state.validate_session(tok) != user_ids[i]:
                    raise AssertionError(f"session of {user_ids[i]} validates to another user")
                count += 1
        return count

    n_sessions = asyncio.run(sessions_valid())
    if n_sessions != expected.count("ok") or asyncio.run(state.session_count()) != n_sessions:
        raise AssertionError("login_state: not one session per valid entry")
    if [msg for _, msg in replay] != ["Authentication failed"] * len(replay):
        raise AssertionError("login_state: the replay was not refused entry for entry")
    if replay_rows or any(replay_launches.values()):
        raise AssertionError(f"login_state: the replay reached the card ({replay_rows} rows, "
                             f"launches {replay_launches})")
    if batches != [n]:
        raise AssertionError(f"login_state: dispatched as {batches}, not one batch of {n}")
    for name in SERVED_KERNELS:
        if launches[name] < 1:
            raise AssertionError(f"{name} was never launched by the login traffic")
    if backend.state is not BreakerState.CLOSED or fallback_calls[0]:
        raise AssertionError(f"login_state left the card: breaker {backend.state.value}, "
                             f"fallback calls {fallback_calls[0]}")
    out.update({
        "valid": expected.count("ok"), "sessions": n_sessions,
        "batches": batches, "rows_on_card": sum(counter.calls),
        "native_parse_us_per_entry": parse_s / n * 1e6,
        "native_parse_s": parse_s,
        "consume_lookup_s": timing["consume_lookup_s"],
        "proof_parse_s": timing["proof_parse_s"],
        "sessions_s": timing["sessions_s"],
        "login_wall_s": wall, "logins_per_s": n / wall, "gc_pause_s": gc_s,
        "replay_entries": len(replay), "replay_rows_on_card": replay_rows,
        "launches_in_login_state": launches,
        "breaker": backend.state.value, "fallback_calls": fallback_calls[0],
        "parse_native": metrics.read("transport.parse.native",
                                     labels={"rpc": "VerifyProofBatch"}),
    })
    return out


class DaemonProcess:
    """One ``python -m cpzk_tpu_torch.server`` subprocess of the daemon
    phase: its output lines kept (and written to ``chiprun_out/``), its
    gRPC and ops-plane ports read from them, stopped with SIGTERM."""

    LISTENING = re.compile(r"AuthService listening on [^:\s]+:(\d+)")
    OPSPLANE = re.compile(r"ops plane on http://[^:\s]+:(\d+)")

    def __init__(self, name: str, argv: list, cwd: str, env: dict):
        self.name = name
        self.t0 = time.perf_counter()
        self.proc = subprocess.Popen(argv, cwd=cwd, env=env, text=True,
                                     stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                     start_new_session=True)
        self.lines: list[str] = []
        self.stamps: list[float] = []  # seconds from spawn to each line
        self.readers = [threading.Thread(target=self._drain, args=(s,), daemon=True)
                        for s in (self.proc.stdout, self.proc.stderr)]
        for t in self.readers:
            t.start()
        self.port = self.ops_port = None
        self.boot_s = None

    def _drain(self, stream) -> None:
        for line in stream:
            self.stamps.append(time.perf_counter() - self.t0)
            self.lines.append(line)

    def seconds_to(self, text: str) -> float | None:
        """Seconds from spawn to the first output line holding ``text``."""
        for t, line in zip(list(self.stamps), list(self.lines)):
            if text in line:
                return t
        return None

    def text(self) -> str:
        return "".join(self.lines)

    def wait_listening(self, timeout: float) -> "DaemonProcess":
        deadline = time.perf_counter() + timeout
        while time.perf_counter() < deadline:
            for line in list(self.lines):
                if (m := self.LISTENING.search(line)) and self.port is None:
                    self.port = int(m.group(1))
                    self.boot_s = time.perf_counter() - self.t0
                if m := self.OPSPLANE.search(line):
                    self.ops_port = int(m.group(1))
            if self.port is not None and self.ops_port is not None:
                return self
            if self.proc.poll() is not None:
                raise AssertionError(f"daemon {self.name} exited {self.proc.returncode} "
                                     f"before listening:\n{self.text()[-3000:]}")
            time.sleep(0.02)
        raise AssertionError(f"daemon {self.name} did not listen within {timeout} s:\n"
                             f"{self.text()[-3000:]}")

    def terminate(self, timeout: float) -> tuple[int, float]:
        """SIGTERM; (exit code, seconds to exit)."""
        t0 = time.perf_counter()
        self.proc.send_signal(signal.SIGTERM)
        rc = self.proc.wait(timeout=timeout)
        for t in self.readers:
            t.join(timeout=5)
        return rc, time.perf_counter() - t0

    def kill(self) -> None:
        """Kill the daemon and everything it started (its ingest shards)."""
        if self.proc.poll() is None:
            with contextlib.suppress(ProcessLookupError):
                os.killpg(self.proc.pid, signal.SIGKILL)
            self.proc.wait(timeout=30)

    def save_log(self) -> None:
        os.makedirs("chiprun_out", exist_ok=True)
        with open(os.path.join("chiprun_out", f"daemon_{self.name}.log"), "w") as f:
            f.write(self.text())


def http_get(port: int, path: str) -> str:
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=30) as resp:
        return resp.read().decode()


def scraped(text: str, name: str, labels: str = "") -> float:
    """One sample of a Prometheus text exposition (0.0 when absent)."""
    m = re.search(rf"^{re.escape(name + labels)} (\S+)$", text, re.M)
    return float(m.group(1)) if m else 0.0


def kernel_launches(ops_port: int, names=LADDER_KERNELS) -> dict:
    text = http_get(ops_port, "/metrics")
    return {k: int(scraped(text, "tpu_kernel_launches", f'{{kernel="{k}"}}'))
            for k in names}


def flight_records(ops_port: int, after_seq: int) -> list[dict]:
    payload = json.loads(http_get(ops_port, "/flightrec"))
    return [r for r in payload["records"] if r["seq"] > after_seq]


def last_flight_seq(ops_port: int) -> int:
    return max([r["seq"] for r in flight_records(ops_port, 0)], default=0)


def admission_view(ops_port: int, metrics_text: str) -> dict:
    """The daemon's ``/statusz`` admission block (level, admitted tiers)
    and its shed counters from ``/metrics``."""
    block = json.loads(http_get(ops_port, "/statusz"))["admission"]
    if block is None:
        raise AssertionError("the daemon runs without admission control")
    return {**block, "admitted": scraped(metrics_text, "admission_admitted_total"),
            "shed": {kind: scraped(metrics_text, f"admission_shed_{kind}_total")
                     for kind in ("priority", "per_client", "global")}}


def card_apps() -> list[int]:
    """The PIDs of the card's compute apps per ``nvidia-smi`` (in a PID
    namespace it cannot map, each shows as some other number, but there
    is one row per process holding a CUDA context)."""
    out = subprocess.run(["nvidia-smi", "--query-compute-apps=pid", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout
    return [int(x) for x in out.split() if x.strip().isdigit()]


def maps_libcuda(pid: int) -> bool:
    """Whether process ``pid`` has the CUDA driver library mapped: a
    process that created a CUDA context has."""
    with open(f"/proc/{pid}/maps") as f:
        return "libcuda.so" in f.read()


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def tamper_logins(wires, cids, provers, m: int, gen) -> list[str]:
    """About 1% of the login proofs made to fail (wrong s, wrong context,
    swapped r1) and 2 given a commitment that does not decode, as in the
    login_state phase; returns the expected verdict of each entry."""
    from cpzk_tpu_torch import Transcript
    from cpzk_tpu_torch.core.scalars import L

    n = len(wires)
    expected = ["ok"] * n
    step = max(2, n // 42)
    for k, idx in enumerate(range(41 % n, n, step)):
        wire = wires[idx]
        how = ("wrong_s", "wrong_context", "swapped_r1")[k % 3]
        if how == "wrong_s":
            sc = int.from_bytes(wire[77:], "little") + 1
            wire = wire[:77] + ((sc % L) or 1).to_bytes(32, "little")
        elif how == "wrong_context":
            t = Transcript()
            t.append_context(cids[idx] + b"-elsewhere")
            wire = provers[idx % m].prove_with_transcript(gen, t).to_bytes()
        else:
            wire = wire[:5] + wires[(idx + 1) % n][5:37] + wire[37:]
        wires[idx] = wire
        expected[idx] = "Authentication failed"
    for idx in (3, n - 3):
        if expected[idx] == "ok":
            wires[idx] = wires[idx][:5] + b"\xff" * 32 + wires[idx][37:]
            expected[idx] = BAD_POINT
    return expected


async def pushback_call(stub, request, rpc: str, sheds: dict):
    """One unary RPC, sent again after each ``RESOURCE_EXHAUSTED`` once the
    server's ``cpzk-retry-after-ms`` has passed (the reference client's
    policy: the pushback verbatim, at most ``MAX_PUSHBACK_S``; a negative
    one means do not retry).  Each shed is counted in ``sheds[rpc]``."""
    import grpc

    from cpzk_tpu_torch.resilience.retry import MAX_PUSHBACK_S, RETRY_PUSHBACK_KEY

    tries = 0
    while True:
        try:
            return await stub(request)
        except grpc.aio.AioRpcError as err:
            if err.code() != grpc.StatusCode.RESOURCE_EXHAUSTED:
                raise
            sheds[rpc] = sheds.get(rpc, 0) + 1
            tries += 1
            pushback = float(dict(err.trailing_metadata() or ()).get(RETRY_PUSHBACK_KEY, -1))
            if pushback < 0 or tries > PUSHBACK_TRIES:
                raise
            await asyncio.sleep(min(MAX_PUSHBACK_S, pushback / 1000.0))


def tier_sheds(sheds: dict) -> dict:
    """The client's shed counts by admission tier (verify, challenge,
    register)."""
    from cpzk_tpu_torch.admission import TIER_NAMES, classify

    out = {name: 0 for name in TIER_NAMES.values()}
    for rpc, count in sheds.items():
        out[TIER_NAMES[classify(rpc)]] += count
    return out


async def daemon_logins(port: int, user_ids, corpus, provers, rpc_max: int, gen,
                        register: bool, channels: int = DAEMON_CHANNELS,
                        sheds: dict | None = None) -> dict:
    """One wave of logins over loopback gRPC, hand-wired on the port's
    ``auth_pb2``: (registration,) one challenge per user, proofs of them,
    the logins in concurrent ``VerifyProofBatch`` RPCs of ``rpc_max``
    entries, then the first RPC again (the replay).  Admission sheds are
    retried after their pushback and counted in ``sheds`` by RPC; the
    challenge ids and session tokens the wave saw acknowledged come back
    under ``acked``."""
    from cpzk_tpu_torch import Transcript
    from cpzk_tpu_torch._gen import auth_pb2 as pb

    n, m = len(user_ids), len(corpus)
    sheds = {} if sheds is None else sheds
    bounds = [(lo, min(lo + rpc_max, n)) for lo in range(0, n, rpc_max)]
    out = {"rpc_sizes": [hi - lo for lo, hi in bounds]}

    # several connections, as several clients open: through SO_REUSEPORT
    # the kernel spreads connections (not RPCs) over the ingest shards
    chans = grpc_channels(port, channels)
    try:
        for ch in chans:
            await asyncio.wait_for(ch.channel_ready(), DAEMON_BOOT_TIMEOUT_S)

        def rpc(i: int, name: str, req_cls, resp_cls):
            return unary_stub(chans[i % channels], name, req_cls, resp_cls)

        if register:
            t0 = time.perf_counter()
            resps = await asyncio.gather(*[pushback_call(
                rpc(k, "RegisterBatch", pb.BatchRegistrationRequest,
                    pb.BatchRegistrationResponse),
                pb.BatchRegistrationRequest(
                    user_ids=user_ids[lo:hi],
                    y1_values=[corpus[i % m][0].y1.wire() for i in range(lo, hi)],
                    y2_values=[corpus[i % m][0].y2.wire() for i in range(lo, hi)]),
                "RegisterBatch", sheds)
                for k, (lo, hi) in enumerate(bounds)])
            out["register_s"] = time.perf_counter() - t0
            bad = [r.message for resp in resps for r in resp.results if not r.success]
            if bad:
                raise AssertionError(f"daemon: registration failed: {bad[:3]}")
            out["registrations_per_s"] = n / out["register_s"]

        chals = [rpc(k, "CreateChallenge", pb.ChallengeRequest, pb.ChallengeResponse)
                 for k in range(channels)]
        lat: list[float] = []

        async def challenge(k: int, uid: str) -> bytes:
            t = time.perf_counter()
            resp = await pushback_call(chals[k % channels], pb.ChallengeRequest(user_id=uid),
                                       "CreateChallenge", sheds)
            lat.append(time.perf_counter() - t)
            return bytes(resp.challenge_id)

        t0 = time.perf_counter()
        cids = await asyncio.gather(*[challenge(k, uid) for k, uid in enumerate(user_ids)])
        out["challenge_s"] = time.perf_counter() - t0
        out["challenges_per_s"] = n / out["challenge_s"]
        out["challenge_latency_ms"] = {"p50": percentile(lat, 50) * 1e3,
                                       "p99": percentile(lat, 99) * 1e3}

        wires = []
        for i, cid in enumerate(cids):
            t = Transcript()
            t.append_context(cid)
            wires.append(provers[i % m].prove_with_transcript(gen, t).to_bytes())
        expected = tamper_logins(wires, cids, provers, m, gen)
        requests = [pb.BatchVerificationRequest(user_ids=user_ids[lo:hi],
                                                challenge_ids=cids[lo:hi],
                                                proofs=wires[lo:hi]) for lo, hi in bounds]
        verifies = [rpc(k, "VerifyProofBatch", pb.BatchVerificationRequest,
                        pb.BatchVerificationResponse) for k in range(channels)]
        rpc_lat: list[float] = []

        async def login(k: int, req):
            t = time.perf_counter()
            resp = await pushback_call(verifies[k % channels], req, "VerifyProofBatch", sheds)
            rpc_lat.append(time.perf_counter() - t)
            return resp

        t0 = time.perf_counter()
        resps = await asyncio.gather(*[login(k, req) for k, req in enumerate(requests)])
        out["login_wall_s"] = time.perf_counter() - t0
        out["logins_per_s"] = n / out["login_wall_s"]
        out["login_rpc_latency_ms"] = {"p50": percentile(rpc_lat, 50) * 1e3,
                                       "p99": percentile(rpc_lat, 99) * 1e3}
        results = [r for resp in resps for r in resp.results]
        replay = (await pushback_call(verifies[0], requests[0], "VerifyProofBatch",
                                      sheds)).results
    finally:
        for ch in chans:
            await ch.close()
    got = ["ok" if r.success else r.message for r in results]
    wrong = [i for i, (g, e) in enumerate(zip(got, expected)) if g != e]
    if len(results) != n or wrong:
        raise AssertionError(f"daemon: {len(results)} verdicts, wrong at {wrong[:5]}: "
                             f"{[(got[i], expected[i]) for i in wrong[:5]]}")
    for uid, r in zip(user_ids, results):
        if r.success != bool(r.session_token) or (
                r.success and r.message != f"User '{uid}' authenticated successfully"):
            raise AssertionError(f"daemon: not one session per valid entry ({uid}: {r})")
    if [(r.success, r.message) for r in replay] != [(False, "Authentication failed")] * len(
            requests[0].user_ids):
        raise AssertionError("daemon: the replay was not refused entry for entry")
    out.update(verdicts=got, valid=expected.count("ok"),
               sessions=sum(bool(r.session_token) for r in results),
               tampered=expected.count("Authentication failed"),
               undecodable=expected.count(BAD_POINT), replay_refused=len(replay),
               sheds_by_rpc=dict(sheds), sheds_by_tier=tier_sheds(sheds),
               acked={"challenge_ids": list(cids),
                      "session_tokens": [r.session_token for r in results if r.session_token]})
    if out["sheds_by_tier"]["verify"]:
        raise AssertionError(f"daemon: tier-0 (verify) RPCs were shed: {sheds}")
    return out


async def daemon_single_login(port: int, uid: str, prover, gen) -> str:
    """One fresh challenge and ``VerifyProof`` for ``uid``: its message."""
    import grpc

    from cpzk_tpu_torch import Transcript
    from cpzk_tpu_torch._gen import auth_pb2 as pb

    async with grpc.aio.insecure_channel(f"127.0.0.1:{port}") as ch:
        chal = unary_stub(ch, "CreateChallenge", pb.ChallengeRequest, pb.ChallengeResponse)
        cid = bytes((await chal(pb.ChallengeRequest(user_id=uid))).challenge_id)
        t = Transcript()
        t.append_context(cid)
        proof = prover.prove_with_transcript(gen, t).to_bytes()
        verify = unary_stub(ch, "VerifyProof", pb.VerificationRequest,
                            pb.VerificationResponse)
        resp = await verify(pb.VerificationRequest(user_id=uid, challenge_id=cid, proof=proof))
    if not (resp.success and resp.session_token):
        raise AssertionError(f"daemon: the login after the restore failed: {resp.message}")
    return resp.message


async def daemon_valid_batch(port: int, user_ids, first: int, provers, gen,
                             sheds: dict) -> list:
    """One ``VerifyProofBatch`` of ``user_ids[first:]``, each over a fresh
    challenge with a valid proof: the results (sheds retried and counted
    in ``sheds`` by RPC)."""
    import grpc

    from cpzk_tpu_torch import Transcript
    from cpzk_tpu_torch._gen import auth_pb2 as pb

    uids = user_ids[first:]
    async with grpc.aio.insecure_channel(f"127.0.0.1:{port}") as ch:
        chal = unary_stub(ch, "CreateChallenge", pb.ChallengeRequest, pb.ChallengeResponse)
        cids = [bytes(r.challenge_id) for r in await asyncio.gather(
            *[pushback_call(chal, pb.ChallengeRequest(user_id=uid), "CreateChallenge", sheds)
              for uid in uids])]
        wires = []
        for i, cid in enumerate(cids, start=first):
            t = Transcript()
            t.append_context(cid)
            wires.append(provers[i % len(provers)].prove_with_transcript(gen, t).to_bytes())
        verify = unary_stub(ch, "VerifyProofBatch", pb.BatchVerificationRequest,
                            pb.BatchVerificationResponse)
        resp = await pushback_call(
            verify, pb.BatchVerificationRequest(user_ids=uids, challenge_ids=cids,
                                                proofs=wires), "VerifyProofBatch", sheds)
    return list(resp.results)


def daemon_phase(corpus, provers, n: int, rpc_max: int, shards: int,
                 launcher: list | None = None, on_card: bool = True) -> dict:
    """The ``daemon`` phase: the port's entry point, ``python -m
    cpzk_tpu_torch.server --no-repl``, as a subprocess on a TOML of its
    own, serving logins over loopback gRPC three times: a boot that
    registers ``n`` users and logs them in (five concurrent
    ``VerifyProofBatch`` RPCs at ``rpc_max`` entries, about 1% tampered),
    then SIGTERM; a second boot that restores the snapshot and logs one
    user in; a third with ``[server] ingest_shards = shards`` that logs all
    ``n`` in again through the shards.  ``launcher`` replaces ``python -m
    cpzk_tpu_torch.server`` (a rehearsal on the CPU passes one that gives
    ``amain`` ``device="cpu"``, with ``on_card=False``)."""
    from cpzk_tpu_torch.server.__main__ import DRAIN_SECONDS

    root = os.path.dirname(os.path.abspath(__file__))
    workdir = tempfile.mkdtemp(prefix="cpzk-daemon-")
    state_file = os.path.join(workdir, "state.json")
    config = os.path.join(workdir, "server.toml")
    with open(config, "w") as f:
        f.write(f'state_file = "{state_file}"\n'
                f'[tpu]\nbackend = "tpu"\nbatch_max = {n}\nprewarm_quanta = "{n}"\n'
                "[rate_limit]\nrequests_per_minute = 100000000\nburst = 1000000\n"
                "[opsplane]\nenabled = true\nport = 0\n")
    env = {k: v for k, v in os.environ.items() if not k.startswith("SERVER_")}
    env.update(SERVER_CONFIG_PATH=config, CPZK_CLEANUP_INTERVAL_S="1",
               PYTHONPATH=root + os.pathsep + env.get("PYTHONPATH", ""))
    argv = (launcher or [sys.executable, "-m", "cpzk_tpu_torch.server"]) + ["--no-repl"]
    user_ids = [f"user-{i:05d}" for i in range(n)]
    gen = SeededRng(SEED + 7)
    out = {"n": n, "rpc_entries": rpc_max, "tolerance": "exact", "config": open(config).read()}
    procs = []

    def boot(name: str, extra: list, extra_env: dict | None = None) -> DaemonProcess:
        proc = DaemonProcess(name, argv + extra, workdir, {**env, **(extra_env or {})})
        procs.append(proc)
        return proc.wait_listening(DAEMON_BOOT_TIMEOUT_S)

    def served(proc: DaemonProcess, register: bool, kernels=LADDER_KERNELS,
               required=SERVED_KERNELS) -> dict:
        """A wave of logins with the launch counts of ``kernels`` and the
        flight records read just before and just after it; each of
        ``required`` must have been launched."""
        seq0 = last_flight_seq(proc.ops_port)
        launches0 = kernel_launches(proc.ops_port, kernels)
        wave = asyncio.run(daemon_logins(proc.port, user_ids, corpus, provers, rpc_max, gen,
                                         register))
        launches = {k: v - launches0[k]
                    for k, v in kernel_launches(proc.ops_port, kernels).items()}
        records = flight_records(proc.ops_port, seq0)
        batched = sum(r["batch"] for r in records)
        # the replay's entries fail at the consume, before any batch
        if batched != n or any(r["device_interval_s"] <= 0 for r in records):
            raise AssertionError(f"daemon {proc.name}: flight records "
                                 f"{[(r['batch'], r['device_interval_s']) for r in records]}")
        if on_card:
            for name in required:
                if launches[name] < 1:
                    raise AssertionError(f"{name} was never launched by the daemon's logins")
        metrics_text = http_get(proc.ops_port, "/metrics")
        failover = scraped(metrics_text, "tpu_backend_failover_total")
        if failover:
            raise AssertionError(f"daemon {proc.name}: {failover} failovers")
        wave.pop("acked")
        verdicts[proc.name] = wave.pop("verdicts")
        wave.update(batches=[r["batch"] for r in records],
                    device_interval_s=[r["device_interval_s"] for r in records],
                    batch_wall_s=[r["wall_s"] for r in records],
                    launches=launches, failover=failover,
                    admission=admission_view(proc.ops_port, metrics_text))
        return wave

    def on_card_pids(daemon: DaemonProcess, others: list[int]) -> dict:
        """The daemon holds a CUDA context and none of ``others`` does:
        ``libcuda`` in each process's maps, one more compute app on the
        card than before the daemon (this script's own), and, where
        ``nvidia-smi`` shows this namespace's PIDs, the daemon's among
        them and none of the others'."""
        if not maps_libcuda(daemon.proc.pid):
            raise AssertionError("the daemon has no CUDA context")
        holding = [pid for pid in others if maps_libcuda(pid)]
        if holding:
            raise AssertionError(f"processes {holding} hold a CUDA context")
        apps = card_apps()
        if len(apps) != len(apps_before) + 1:
            raise AssertionError(f"compute apps {apps} with the daemon up, "
                                 f"{apps_before} before it")
        row = {"nvidia_smi_apps": apps, "apps_before": apps_before,
               "daemon_pid": daemon.proc.pid, "others": others,
               "nvidia_smi_pids_checked": os.getpid() in apps}
        if row["nvidia_smi_pids_checked"]:
            if daemon.proc.pid not in apps or set(others) & set(apps):
                raise AssertionError(f"nvidia-smi lists {apps}: daemon {daemon.proc.pid}, "
                                     f"others {others}")
        return row

    apps_before = card_apps() if on_card else []
    verdicts: dict = {}
    try:
        # 1. boot, register, log in, replay; SIGTERM with a final snapshot
        first = boot("first", ["--port", "0"])
        out["boot_s"] = first.boot_s
        # the boot's parts: the imports, the CUDA context and the state up
        # to build_backend, then its prewarm (the first combined check)
        out["boot_to_prewarmed_s"] = first.seconds_to("prewarmed the verify kernels")
        m = re.search(r"prewarmed the verify kernels .* in ([0-9.]+)s", first.text())
        out["prewarm_s"] = float(m.group(1)) if m else None
        out["first"] = served(first, register=True)
        if on_card:
            out["first"]["card"] = on_card_pids(first, [])
        time.sleep(1.2)  # one sweep at CPZK_CLEANUP_INTERVAL_S: checkpoint + gc.freeze
        rc, out["shutdown_s"] = first.terminate(DRAIN_SECONDS + 30)
        if rc != 0 or not os.path.exists(state_file):
            raise AssertionError(f"daemon first: exit {rc}, snapshot "
                                 f"{os.path.exists(state_file)}:\n{first.text()[-3000:]}")

        # 2. restore on the same state file, one fresh login
        second = boot("restored", ["--port", "0"])
        m = re.search(r"restored state snapshot: (\d+) users, (\d+) sessions", second.text())
        restored = tuple(int(x) for x in m.groups()) if m else None
        if restored != (n, out["first"]["sessions"]):
            raise AssertionError(f"daemon restored {restored}, wrote ({n}, "
                                 f"{out['first']['sessions']})")
        out["restored"] = {"boot_s": second.boot_s, "users": restored[0],
                           "sessions": restored[1],
                           "login": asyncio.run(daemon_single_login(second.port, user_ids[0],
                                                                    provers[0], gen))}
        rc, out["restored"]["shutdown_s"] = second.terminate(DRAIN_SECONDS + 30)
        if rc != 0:
            raise AssertionError(f"daemon restored: exit {rc}")

        # 3. the same logins through SO_REUSEPORT ingest shards
        sharded = boot("sharded", ["--port", str(free_port())],
                       {"SERVER_INGEST_SHARDS": str(shards)})
        deadline = time.perf_counter() + DAEMON_BOOT_TIMEOUT_S
        while True:
            ingest = json.loads(http_get(sharded.ops_port, "/statusz"))["ingest"]
            if all(row["connected"] for row in ingest["per_shard"]):
                break
            if time.perf_counter() > deadline:
                raise AssertionError(f"daemon sharded: shards never connected: {ingest}")
            time.sleep(0.05)
        ready_s = time.perf_counter() - sharded.t0
        time.sleep(0.5)  # each shard binds its listener right after its hello
        shard_pids = [row["pid"] for row in ingest["per_shard"]]
        wave = served(sharded, register=False)
        ingest = json.loads(http_get(sharded.ops_port, "/statusz"))["ingest"]
        wave.update(boot_s=sharded.boot_s, shards_ready_s=ready_s,
                    shard_boot_s=[row["boot_s"] for row in ingest["per_shard"]],
                    shard_rpcs=[row["rpcs"] for row in ingest["per_shard"]],
                    shard_parses=[row["parses"] for row in ingest["per_shard"]])
        if on_card:
            wave["card"] = on_card_pids(sharded, shard_pids)
        rc, wave["shutdown_s"] = sharded.terminate(DRAIN_SECONDS + 30)
        if rc != 0:
            raise AssertionError(f"daemon sharded: exit {rc}")
        out["sharded"] = wave

        # 4. the same logins with the combined check as a Pippenger MSM and
        # the device scalar plane, from the daemon's environment
        pip = boot("pippenger", ["--port", "0"],
                   {"CPZK_PIPPENGER_MIN": "2", "CPZK_DEVICE_RLC": "1"})
        # the Pippenger check of a batch past one chunk of terms sums its
        # chunk partials with point_add; the per-row checks run ladder_each
        kernels = POINT_KERNELS + LADDER_KERNELS + PIPPENGER_KERNELS
        wave = served(pip, register=False, kernels=kernels,
                      required=("ladder_each",) + PIPPENGER_KERNELS)
        if verdicts["pippenger"] != verdicts["first"] or wave["sessions"] != out["first"][
                "sessions"]:
            raise AssertionError("daemon pippenger: verdicts or sessions differ from the "
                                 "first boot's")
        # every batch of the wave holds tampered entries, so its combined
        # check fails and the per-row ladders decide; one all-valid batch
        # must pass the Pippenger check itself: its MSM kernels launched and
        # no ladder kernel run, every entry given a session.  The last
        # rpc_max users: the first has the most sessions already
        seq0 = last_flight_seq(pip.ops_port)
        launches0 = kernel_launches(pip.ops_port, kernels)
        sheds: dict = {}
        results = asyncio.run(daemon_valid_batch(pip.port, user_ids, n - rpc_max, provers,
                                                 gen, sheds))
        launches = {k: v - launches0[k]
                    for k, v in kernel_launches(pip.ops_port, kernels).items()}
        records = flight_records(pip.ops_port, seq0)
        sessions = sum(bool(r.success and r.session_token) for r in results)
        if len(results) != rpc_max or sessions != rpc_max:
            raise AssertionError(f"daemon pippenger: the all-valid batch gave {sessions} "
                                 f"sessions of {rpc_max}: "
                                 f"{[r.message for r in results if not r.success][:3]}")
        if on_card and (any(launches[k] != 0 for k in LADDER_KERNELS)
                        or any(launches[k] < 1 for k in PIPPENGER_KERNELS)):
            raise AssertionError("daemon pippenger: the all-valid batch did not pass the "
                                 f"Pippenger check alone: launches {launches}")
        wave["all_valid_batch"] = {"entries": len(results), "sessions": sessions,
                                   "sheds_by_rpc": sheds,
                                   "batches": [r["batch"] for r in records],
                                   "device_interval_s": [r["device_interval_s"]
                                                         for r in records],
                                   "launches": launches}
        wave["boot_s"] = pip.boot_s
        rc, wave["shutdown_s"] = pip.terminate(DRAIN_SECONDS + 30)
        if rc != 0:
            raise AssertionError(f"daemon pippenger: exit {rc}")
        out["pippenger"] = wave
    finally:
        for proc in procs:
            proc.kill()
            proc.save_log()
        shutil.rmtree(workdir, ignore_errors=True)
    return out


def fs_type(path: str) -> str:
    """The filesystem type under ``path`` (``stat -f -c %T``): an fsync on
    tmpfs costs nothing, so the WAL numbers say which one they are."""
    return subprocess.run(["stat", "-f", "-c", "%T", path], capture_output=True,
                          text=True, timeout=30, check=True).stdout.strip()


def wal_counters(metrics_text: str) -> dict:
    return {kind: scraped(metrics_text, f"state_wal_{kind}_total")
            for kind in ("appends", "bytes", "fsyncs")}


def fsync_cost(workdir: str, records: int = 256, size: int = 256) -> dict:
    """What one WAL-sized append and its fsync cost in ``workdir``:
    ``records`` appends of ``size`` bytes, each followed by an fsync."""
    path = os.path.join(workdir, "fsync-probe")
    fd = os.open(path, os.O_WRONLY | os.O_CREAT | os.O_APPEND, 0o600)
    times = []
    try:
        for _ in range(records):
            t = time.perf_counter()
            os.write(fd, b"x" * size)
            os.fsync(fd)
            times.append(time.perf_counter() - t)
    finally:
        os.close(fd)
        os.unlink(path)
    return {"records": records, "bytes": size, "mean_us": sum(times) / records * 1e6,
            "p50_us": percentile(times, 50) * 1e6, "p99_us": percentile(times, 99) * 1e6}


def grpc_channels(port: int, channels: int) -> list:
    import grpc

    # a local subchannel pool each: channels to one target otherwise share
    # one connection
    return [grpc.aio.insecure_channel(f"127.0.0.1:{port}",
                                      options=[("grpc.use_local_subchannel_pool", 1)])
            for _ in range(channels)]


def unary_stub(channel, name: str, req_cls, resp_cls):
    return channel.unary_unary(f"/auth.AuthService/{name}",
                               request_serializer=req_cls.SerializeToString,
                               response_deserializer=resp_cls.FromString)


async def register_users(port: int, user_ids, corpus, rpc_max: int, sheds: dict,
                         channels: int = DAEMON_CHANNELS) -> dict:
    """Register ``user_ids`` (user i with corpus statement i) in concurrent
    ``RegisterBatch`` RPCs of ``rpc_max`` entries; every entry must be
    acknowledged."""
    from cpzk_tpu_torch._gen import auth_pb2 as pb

    n, m = len(user_ids), len(corpus)
    wires = [(st.y1.wire(), st.y2.wire()) for st, _, _ in corpus]
    bounds = [(lo, min(lo + rpc_max, n)) for lo in range(0, n, rpc_max)]
    requests = [pb.BatchRegistrationRequest(
        user_ids=user_ids[lo:hi], y1_values=[wires[i % m][0] for i in range(lo, hi)],
        y2_values=[wires[i % m][1] for i in range(lo, hi)]) for lo, hi in bounds]
    chans = grpc_channels(port, channels)
    try:
        for ch in chans:
            await asyncio.wait_for(ch.channel_ready(), DAEMON_BOOT_TIMEOUT_S)
        stubs = [unary_stub(ch, "RegisterBatch", pb.BatchRegistrationRequest,
                            pb.BatchRegistrationResponse) for ch in chans]
        t0 = time.perf_counter()
        resps = await asyncio.gather(*[pushback_call(stubs[k % channels], req,
                                                     "RegisterBatch", sheds)
                                       for k, req in enumerate(requests)])
        wall = time.perf_counter() - t0
    finally:
        for ch in chans:
            await ch.close()
    acked = sum(r.success for resp in resps for r in resp.results)
    if acked != n:
        bad = [r.message for resp in resps for r in resp.results if not r.success]
        raise AssertionError(f"durable_daemon: {n - acked} registrations failed: {bad[:3]}")
    return {"users": n, "rpcs": len(bounds), "register_s": wall,
            "registrations_per_s": n / wall}


async def create_challenges(port: int, user_ids, sheds: dict,
                            channels: int = DAEMON_CHANNELS) -> list[tuple[str, bytes]]:
    """``CreateChallenge`` for every user of ``user_ids``; every call must be
    acknowledged.  Returns the (user, challenge id) pairs."""
    from cpzk_tpu_torch._gen import auth_pb2 as pb

    chans = grpc_channels(port, channels)
    try:
        for ch in chans:
            await asyncio.wait_for(ch.channel_ready(), DAEMON_BOOT_TIMEOUT_S)
        stubs = [unary_stub(ch, "CreateChallenge", pb.ChallengeRequest,
                            pb.ChallengeResponse) for ch in chans]
        resps = await asyncio.gather(*[
            pushback_call(stubs[k % channels], pb.ChallengeRequest(user_id=uid),
                          "CreateChallenge", sheds) for k, uid in enumerate(user_ids)])
    finally:
        for ch in chans:
            await ch.close()
    return [(uid, bytes(r.challenge_id)) for uid, r in zip(user_ids, resps)]


async def challenges_until_kill(port: int, user_ids, kill_after: int, kill, sheds: dict,
                                channels: int = DAEMON_CHANNELS) -> dict:
    """``CreateChallenge`` for every user of ``user_ids`` at once; ``kill()``
    runs as soon as ``kill_after`` of them are acknowledged.  Returns the
    (user, challenge id) pairs the client saw acknowledged, and how many
    calls got no answer."""
    import grpc

    from cpzk_tpu_torch._gen import auth_pb2 as pb

    acked: list[tuple[str, bytes]] = []
    unanswered = []
    killed_at: list[int] = []
    chans = grpc_channels(port, channels)
    try:
        for ch in chans:
            await asyncio.wait_for(ch.channel_ready(), DAEMON_BOOT_TIMEOUT_S)
        stubs = [unary_stub(ch, "CreateChallenge", pb.ChallengeRequest,
                            pb.ChallengeResponse) for ch in chans]

        async def one(k: int, uid: str) -> None:
            try:
                resp = await pushback_call(stubs[k % channels], pb.ChallengeRequest(user_id=uid),
                                           "CreateChallenge", sheds)
            except grpc.aio.AioRpcError as err:
                unanswered.append(err.code().name)
                return
            acked.append((uid, bytes(resp.challenge_id)))
            if len(acked) >= kill_after and not killed_at:
                killed_at.append(len(acked))
                kill()

        await asyncio.gather(*[one(k, uid) for k, uid in enumerate(user_ids)])
    finally:
        for ch in chans:
            await ch.close()
    if not killed_at:
        raise AssertionError(f"durable_daemon: only {len(acked)} challenges acknowledged")
    return {"acked": acked, "acked_at_kill": killed_at[0], "unanswered": len(unanswered),
            "unanswered_codes": sorted(set(unanswered))}


async def recovered_logins(port: int, pairs, user_index: dict, provers, rpc_max: int, gen,
                           sheds: dict, channels: int = DAEMON_CHANNELS) -> dict:
    """Log in every (user, challenge id) of ``pairs`` in one wave of
    concurrent ``VerifyProofBatch`` RPCs, each with a valid proof: a
    challenge the daemon lost answers "Authentication failed", so every
    entry must succeed and get a session."""
    from cpzk_tpu_torch import Transcript
    from cpzk_tpu_torch._gen import auth_pb2 as pb

    n, m = len(pairs), len(provers)
    mine = [provers[user_index[uid] % m] for uid, _ in pairs]
    wires = []
    for (uid, cid), prover in zip(pairs, mine):
        t = Transcript()
        t.append_context(cid)
        wires.append(prover.prove_with_transcript(gen, t).to_bytes())
    cids = [cid for _, cid in pairs]
    bounds = [(lo, min(lo + rpc_max, n)) for lo in range(0, n, rpc_max)]
    requests = [pb.BatchVerificationRequest(
        user_ids=[uid for uid, _ in pairs[lo:hi]], challenge_ids=cids[lo:hi],
        proofs=wires[lo:hi]) for lo, hi in bounds]
    chans = grpc_channels(port, channels)
    lat: list[float] = []
    try:
        for ch in chans:
            await asyncio.wait_for(ch.channel_ready(), DAEMON_BOOT_TIMEOUT_S)
        stubs = [unary_stub(ch, "VerifyProofBatch", pb.BatchVerificationRequest,
                            pb.BatchVerificationResponse) for ch in chans]

        async def login(k: int, req):
            t = time.perf_counter()
            resp = await pushback_call(stubs[k % channels], req, "VerifyProofBatch", sheds)
            lat.append(time.perf_counter() - t)
            return resp

        t0 = time.perf_counter()
        resps = await asyncio.gather(*[login(k, req) for k, req in enumerate(requests)])
        wall = time.perf_counter() - t0
    finally:
        for ch in chans:
            await ch.close()
    results = [r for resp in resps for r in resp.results]
    lost = [(pairs[i][0], r.message) for i, r in enumerate(results)
            if not (r.success and r.session_token)]
    if len(results) != n or lost:
        raise AssertionError(f"durable_daemon: {len(lost)} acknowledged challenges did not "
                             f"log in after recovery: {lost[:5]}")
    return {"entries": n, "rpc_sizes": [hi - lo for lo, hi in bounds],
            "sessions": len(results), "login_wall_s": wall,
            "logins_per_s": n / wall,
            "login_rpc_latency_ms": {"p50": percentile(lat, 50) * 1e3,
                                     "p99": percentile(lat, 99) * 1e3}}


async def replay_consumed(port: int, uid: str, cid: bytes, prover, gen) -> tuple[str, str]:
    """``VerifyProof`` of a valid proof over an already consumed challenge:
    (status code, message)."""
    import grpc

    from cpzk_tpu_torch import Transcript
    from cpzk_tpu_torch._gen import auth_pb2 as pb

    t = Transcript()
    t.append_context(cid)
    proof = prover.prove_with_transcript(gen, t).to_bytes()
    chans = grpc_channels(port, 1)
    try:
        verify = unary_stub(chans[0], "VerifyProof", pb.VerificationRequest,
                            pb.VerificationResponse)
        try:
            resp = await verify(pb.VerificationRequest(user_id=uid, challenge_id=cid,
                                                       proof=proof))
        except grpc.aio.AioRpcError as err:
            return err.code().name, err.details()
    finally:
        await chans[0].close()
    return "OK", resp.message


RECOVERY_LINE = re.compile(
    r"durability: (\d+) users / (\d+) sessions from snapshot, (\d+) WAL records replayed "
    r"\((\d+) skipped\) up to seq (\d+) in ([0-9.]+)s")
HELD_LINE = re.compile(r"WAL compaction held at the oldest live challenge: (\d+) covered "
                       r"bytes kept, (\d+) bytes remain")


def durable_daemon_phase(corpus, provers, users: int, n: int, rpc_max: int, held: int,
                         further: int, kill_after: int, launcher: list | None = None,
                         on_card: bool = True, compact_bytes: int | None = None) -> dict:
    """The ``durable_daemon`` phase: the port's daemon with ``[durability]
    enabled = true`` and ``fsync = "always"`` (admission at its default,
    on), SIGKILLed mid-traffic and recovered.  Boot A registers ``users``
    users, takes ``held`` challenges, logs ``n`` other users in on the card
    (five concurrent ``VerifyProofBatch`` RPCs at ``rpc_max``, about 1%
    tampered), and waits until a sweep has snapshotted past the held
    challenges' records with the WAL over ``compact_bytes``: the
    compaction the daemon then holds back would have dropped them.  It then
    starts ``further`` concurrent ``CreateChallenge`` calls and SIGKILLs the
    daemon once ``kill_after`` are acknowledged.  Boot B, on the same
    config, must recover every acknowledged registration and session and
    the challenges acknowledged before the kill with nothing quarantined,
    log each of those challenges in on the card, refuse a consumed
    challenge before the card, and exit 0 on SIGTERM with the WAL truncated
    to 0 bytes.  ``launcher`` and ``on_card`` are the daemon phase's;
    ``compact_bytes`` replaces the reference default."""
    from cpzk_tpu_torch.server.__main__ import DRAIN_SECONDS
    from cpzk_tpu_torch.server.config import DurabilitySettings

    root = os.path.dirname(os.path.abspath(__file__))
    workdir = tempfile.mkdtemp(prefix="cpzk-durable-")
    state_file = os.path.join(workdir, "state.json")
    wal_file = state_file + ".wal"
    config = os.path.join(workdir, "server.toml")
    with open(config, "w") as f:
        f.write(f'state_file = "{state_file}"\n'
                f"[server]\nmax_users = {users}\n"
                f'[tpu]\nbackend = "tpu"\nbatch_max = {n}\nprewarm_quanta = "{n}"\n'
                "[rate_limit]\nrequests_per_minute = 100000000\nburst = 1000000\n"
                "[opsplane]\nenabled = true\nport = 0\n"
                '[durability]\nenabled = true\nfsync = "always"\n'
                + (f"compact_bytes = {compact_bytes}\n" if compact_bytes is not None else ""))
    env = {k: v for k, v in os.environ.items() if not k.startswith("SERVER_")}
    env.update(SERVER_CONFIG_PATH=config, CPZK_CLEANUP_INTERVAL_S="1",
               PYTHONPATH=root + os.pathsep + env.get("PYTHONPATH", ""))
    argv = (launcher or [sys.executable, "-m", "cpzk_tpu_torch.server"]) + ["--no-repl"]
    user_ids = [f"user-{i:05d}" for i in range(users)]
    user_index = {uid: i for i, uid in enumerate(user_ids)}
    gen = SeededRng(SEED + 11)
    if compact_bytes is None:
        compact_bytes = DurabilitySettings().compact_bytes
    out = {"users": users, "n": n, "rpc_entries": rpc_max, "held": held, "further": further,
           "kill_after": kill_after, "tolerance": "exact", "workdir_fs": fs_type(workdir),
           "fsync_probe": fsync_cost(workdir), "compact_bytes": compact_bytes,
           "config": open(config).read()}
    procs = []
    sheds: dict = {}

    def boot(name: str) -> DaemonProcess:
        proc = DaemonProcess(name, argv + ["--port", "0"], workdir, env)
        procs.append(proc)
        return proc.wait_listening(DAEMON_BOOT_TIMEOUT_S)

    def statusz(proc: DaemonProcess) -> dict:
        return json.loads(http_get(proc.ops_port, "/statusz"))

    try:
        # 1. boot A: registrations, then logins on the card
        first = boot("durable_a")
        out["boot_s"] = first.boot_s
        wal0 = wal_counters(http_get(first.ops_port, "/metrics"))
        reg = asyncio.run(register_users(first.port, user_ids, corpus, rpc_max, sheds))
        reg["register_wal"] = {k: v - wal0[k] for k, v in
                      wal_counters(http_get(first.ops_port, "/metrics")).items()}
        held_ids = user_ids[n + further:n + further + held]
        acked_h = asyncio.run(create_challenges(first.port, held_ids, sheds))
        seq0, launches0 = last_flight_seq(first.ops_port), kernel_launches(first.ops_port)
        wave = asyncio.run(daemon_logins(first.port, user_ids[:n], corpus, provers, rpc_max,
                                         gen, register=False, sheds=sheds))
        launches = {k: v - launches0[k] for k, v in kernel_launches(first.ops_port).items()}
        records = flight_records(first.ops_port, seq0)
        if sum(r["batch"] for r in records) != n:
            raise AssertionError(f"durable_daemon: flight records {[r['batch'] for r in records]}")
        if on_card and min(launches[k] for k in SERVED_KERNELS) < 1:
            raise AssertionError(f"a kernel was never launched by boot A's logins: {launches}")
        acked_a = wave.pop("acked")
        wave.pop("verdicts")
        wave.update(launches=launches, batches=[r["batch"] for r in records],
                    device_interval_s=[r["device_interval_s"] for r in records])
        # snapshots hold no challenges: a sweep whose snapshot covers the
        # held challenges' records, with the WAL over compact_bytes, would
        # drop them in the reference and holds its compaction back here
        t0 = time.perf_counter()
        while not (holds := HELD_LINE.findall(first.text())):
            if time.perf_counter() - t0 > 30:
                raise AssertionError(f"durable_daemon: no sweep covered the held challenges: "
                                     f"{statusz(first)['durability']}")
            time.sleep(0.05)
        doc = statusz(first)
        metrics_a = http_get(first.ops_port, "/metrics")
        out["boot_a"] = {**reg, "logins": wave, "wal": wal_counters(metrics_a),
                         "admission": admission_view(first.ops_port, metrics_a),
                         "durability_before_kill": doc["durability"],
                         "held_challenges": len(acked_h),
                         "compactions_held": [{"kept_bytes": int(k), "wal_bytes": int(w)}
                                              for k, w in holds],
                         "state": {k: doc["shards"][k] for k in ("users", "sessions",
                                                                 "challenges")}}

        # 2. SIGKILL with challenges in flight (no final snapshot); the
        # daemon is reaped before boot B starts
        kill_t: list[float] = []

        def kill() -> None:
            kill_t.append(time.perf_counter())
            first.kill()

        further_ids = user_ids[n:n + further]
        kill_wave = asyncio.run(challenges_until_kill(first.port, further_ids, kill_after,
                                                      kill, sheds))
        acked_c = acked_h + kill_wave.pop("acked")
        out["kill"] = {**kill_wave, "acked": len(acked_c) - len(acked_h),
                       "exit_code": first.proc.returncode,
                       "card_apps_after_reap": card_apps() if on_card else None}
        if first.proc.returncode != -signal.SIGKILL:
            raise AssertionError(f"durable_daemon: boot A ended {first.proc.returncode}")

        # 3. boot B: recover, check the counts, log the recovered challenges in
        second = boot("durable_b")
        m = RECOVERY_LINE.search(second.text())
        if m is None:
            raise AssertionError(f"durable_daemon: no recovery line:\n{second.text()[-3000:]}")
        snap_users, snap_sessions, replayed, skipped, next_seq = map(int, m.groups()[:5])
        quarantined = [f for f in os.listdir(workdir) if ".corrupt-" in f]
        doc = statusz(second)
        recovered = {"recovery_s": float(m.group(6)), "boot_s": second.boot_s,
                     "snapshot_users": snap_users, "snapshot_sessions": snap_sessions,
                     "wal_replayed": replayed, "wal_skipped": skipped, "next_seq": next_seq,
                     "quarantined": len(quarantined),
                     "state": {k: doc["shards"][k] for k in ("users", "sessions",
                                                             "challenges")}}
        out["boot_b"] = recovered
        want_sessions = len(acked_a["session_tokens"])
        if quarantined or recovered["state"]["users"] != users or (
                recovered["state"]["sessions"] != want_sessions) or (
                recovered["state"]["challenges"] < len(acked_c)):
            raise AssertionError(f"durable_daemon: recovered {recovered}, quarantined "
                                 f"{quarantined}; acknowledged {users} users, {want_sessions} "
                                 f"sessions, {len(acked_c)} challenges")
        # each acknowledged challenge, by its id: a valid proof must log in
        seq0, launches0 = last_flight_seq(second.ops_port), kernel_launches(second.ops_port)
        logins = asyncio.run(recovered_logins(second.port, acked_c, user_index, provers,
                                              rpc_max, gen, sheds))
        launches = {k: v - launches0[k] for k, v in kernel_launches(second.ops_port).items()}
        records = flight_records(second.ops_port, seq0)
        if sum(r["batch"] for r in records) != len(acked_c):
            raise AssertionError(f"durable_daemon: flight records {[r['batch'] for r in records]}")
        # every recovered login is valid: the combined check passes alone
        if on_card and launches["ladder_combined"] < 1:
            raise AssertionError(f"ladder_combined was never launched by the recovered "
                                 f"logins: {launches}")
        logins.update(launches=launches, batches=[r["batch"] for r in records],
                      device_interval_s=[r["device_interval_s"] for r in records])
        recovered["logins"] = logins

        # 4. a challenge consumed before the kill: refused before the card
        seq0, launches0 = last_flight_seq(second.ops_port), kernel_launches(second.ops_port)
        replay = asyncio.run(replay_consumed(second.port, user_ids[0],
                                             acked_a["challenge_ids"][0],
                                             provers[0], gen))
        if replay != ("PERMISSION_DENIED", "Authentication failed") or flight_records(
                second.ops_port, seq0) or kernel_launches(second.ops_port) != launches0:
            raise AssertionError(f"durable_daemon: the consumed challenge answered {replay}")
        recovered["replay"] = {"code": replay[0], "message": replay[1],
                               "reached_card": False}
        metrics_b = http_get(second.ops_port, "/metrics")
        recovered.update(wal=wal_counters(metrics_b),
                         admission=admission_view(second.ops_port, metrics_b))

        # 5. SIGTERM: exit 0, a final snapshot, the covered WAL truncated
        rc, recovered["shutdown_s"] = second.terminate(DRAIN_SECONDS + 30)
        wal_size = os.path.getsize(wal_file)
        if rc != 0 or wal_size != 0 or "final snapshot written" not in second.text():
            raise AssertionError(f"durable_daemon: exit {rc}, WAL {wal_size} bytes:\n"
                                 f"{second.text()[-3000:]}")
        recovered.update(exit_code=rc, wal_bytes_after_exit=wal_size)
        out["sheds_by_rpc"], out["sheds_by_tier"] = dict(sheds), tier_sheds(sheds)
        if out["sheds_by_tier"]["verify"]:
            raise AssertionError(f"durable_daemon: tier-0 (verify) RPCs were shed: {sheds}")
    finally:
        for proc in procs:
            proc.kill()
            proc.save_log()
        shutil.rmtree(workdir, ignore_errors=True)
    return out


def bound_of(nbytes: int, ops: int, int32_ops_per_s: float) -> dict:
    """The least time the card could take: the larger of the bytes over
    the memory rate and the int32 operations over the int32 rate."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / int32_ops_per_s * 1e3
    return {"bytes": nbytes, "int32_ops": ops, "bound_ms": max(t_bytes, t_ops),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes"}


def scalar_kernels_vs_plain(dev, ns, cs, timed_ns, int32_ops_per_s: float) -> dict:
    """Phase 3b: the scalar kernels against their plain versions (exact,
    ``torch.equal``) at each row count: ``rlc_scalars`` and the window
    recode at the per-row path's width (pad_lanes(n + 1), corrections at
    lane n), ``rlc_scalars`` and the digit recode at each c at the
    Pippenger path's (pow2(n) rows, 4 pow2(n) + 2 terms); random scalars
    with 0, 1 and l - 1 among them; then ``rlc_scalars`` at
    :data:`RLC_EDGE_CASES`.  Device times at ``timed_ns``: ``rlc_scalars``
    by ``kernel_ms`` (a call: its ticket's zeroing and its launch) and by
    the profiler (its kernel alone), beside its chain floor (one row, by
    ``kernel_ms``) and the launch floor; ``scalar_recode`` in both modes
    (the Pippenger path's digits, the per-row path's windows) the same way,
    beside its chain floor (the digits of one row)."""
    import random

    import numpy as np
    import torch

    from cpzk_tpu_torch.bench_kernels import rlc_case
    from cpzk_tpu_torch.core.scalars import L
    from cpzk_tpu_torch.ops import msm, scalar_kernels as sk, sclimbs as sc
    from cpzk_tpu_torch.ops.backend import _pad_lanes, _pad_pow2

    rng = random.Random(SEED + 3)
    rows = {"rlc_scalars": [], "scalar_recode": []}
    floor = launch_floor(dev)

    def exact(label: str, got, ref) -> None:
        if not all(torch.equal(g, r) for g, r in zip(got, ref)):
            raise AssertionError(f"{label}: kernel and plain version differ")

    for n in ns:
        pad, pw = _pad_lanes(n + 1), _pad_pow2(n)
        vals = [[rng.randrange(L) for _ in range(n)] for _ in range(3)]
        for v in vals:
            v[:min(n, 3)] = [0, 1, L - 1][:min(n, 3)]
        al, cl, sl = (torch.from_numpy(sc.ints_to_limbs(v + [0] * (pad - n))).to(dev)
                      for v in vals)
        bl = torch.from_numpy(sc.ints_to_limbs([rng.randrange(L)])).to(dev)
        wide = sk.rlc_scalars(al, cl, sl, bl)
        synchronize()
        ref = sk.rlc_scalars_plain(al, cl, sl, bl)
        exact(f"rlc_scalars n={n} lanes={pad}", wide, ref)
        groups, corr = (al, *ref[:3]), ref[3:]
        exact(f"scalar_recode windows n={n}", [sk.rlc_windows(groups, *corr, n)],
              [sk.rlc_windows_plain(groups, *corr, n)])
        narrow = tuple(t[:, :pw].contiguous() for t in (al, cl, sl))
        got = sk.rlc_scalars(*narrow, bl)
        ref = sk.rlc_scalars_plain(*narrow, bl)
        exact(f"rlc_scalars n={n} lanes={pw}", got, ref)
        groups, corr, m = (narrow[0], *ref[:3]), ref[3:], 4 * pw + 2
        m_pad = m if m <= MSM_CHUNK else _pad_lanes(m)
        for c in cs:
            exact(f"scalar_recode digits n={n} c={c}",
                  [sk.rlc_digits(groups, *corr, n, m_pad, c)],
                  [sk.rlc_digits_plain(groups, *corr, n, m_pad, c)])
        if n == 1:
            one_row = kernel_ms(lambda: sk.rlc_scalars(*narrow, bl), None, SMALL_REPS)
            one_recode = kernel_ms(lambda: sk.rlc_digits(groups, *corr, 1, m, MSM_C), None,
                                   SMALL_REPS)
        if n not in timed_ns:
            continue
        row = {"n": n, "lanes": pw, "max_abs_err": 0, "exact_at_c": list(cs),
               **bound_of(*sk.rlc_scalars_work(pw), int32_ops_per_s)}
        row.update(kernel_ms(lambda: sk.rlc_scalars(*narrow, bl),
                             lambda: sk.rlc_scalars_plain(*narrow, bl), SMALL_REPS))
        prof = device_ms("rlc_scalars", lambda: sk.rlc_scalars(*narrow, bl),
                         lambda: sk.rlc_scalars_plain(*narrow, bl), 20, 2)
        row.update({"profiler_ms": prof["ms"], "profiler_plain_ms": prof["plain_ms"],
                    "profiled_launches": prof["profiled_launches"],
                    "chain_floor_ms": one_row["ms"], "chain_floor_runs": one_row["ms_runs"],
                    **floor})
        rows["rlc_scalars"].append(row)
        nwin = msm.num_windows(MSM_C)
        row = {"n": n, "terms": m_pad, "c": MSM_C, "max_abs_err": 0,
               **bound_of(*sk.scalar_recode_work(m_pad, nwin, 4 * n + 2), int32_ops_per_s)}

        def digits(groups=groups, corr=corr, n=n, m_pad=m_pad):
            return sk.rlc_digits(groups, *corr, n, m_pad, MSM_C)

        row.update(kernel_ms(digits, lambda: sk.rlc_digits_plain(groups, *corr, n, m_pad, MSM_C),
                             SMALL_REPS))
        prof = device_ms("scalar_recode", digits, None, 20, 0)
        row.update({"profiler_ms": prof["ms"], "profiled_launches": prof["profiled_launches"],
                    "chain_floor_ms": one_recode["ms"], "chain_floor_runs": one_recode["ms_runs"],
                    "chain_floor_shape": {"n": 1, "terms": 6, "c": MSM_C}, **floor})
        wgroups, wcorr = (al, *wide[:3]), wide[3:]

        def windows(wgroups=wgroups, wcorr=wcorr, n=n):
            return sk.rlc_windows(wgroups, *wcorr, n)

        timed = kernel_ms(windows, lambda: sk.rlc_windows_plain(wgroups, *wcorr, n), SMALL_REPS)
        prof = device_ms("scalar_recode", windows, None, 20, 0)
        row["windows"] = {"lanes": pad, **timed, "profiler_ms": prof["ms"],
                          "profiled_launches": prof["profiled_launches"],
                          **bound_of(*sk.scalar_recode_work(4 * pad, 64, 4 * pad),
                                     int32_ops_per_s)}
        rows["scalar_recode"].append(row)
    np_rng = np.random.default_rng(SEED + 5)
    for case, n in RLC_EDGE_CASES:
        al, cl, sl, bl = (torch.from_numpy(sc.ints_to_limbs(v)).to(dev)
                          for v in rlc_case(np_rng, case, n))
        exact(f"rlc_scalars {case} n={n}", sk.rlc_scalars(al, cl, sl, bl),
              sk.rlc_scalars_plain(al, cl, sl, bl))
        rows["rlc_scalars"].append({"n": n, "case": case, "max_abs_err": 0})
    return rows


def quad_chain_floor(dev, point, doublings: int) -> dict:
    """A chain of ``doublings`` dependent doublings of a ``[20, 1]`` point on
    one quad (``cpzk_msm_quad_chain``, one warp, a quad a doubling, the
    schedule of the MSM scale kernel and of ``comb_tables``' bases),
    checked against ``point_double_k_plain`` (canonical coordinates equal)
    and timed by ``kernel_ms``: the chain floor of a kernel that runs it."""
    import torch

    from cpzk_tpu_torch.ops import limbs, point_kernels as pk

    words = pk.words_of_limbs(torch.stack([limbs.canonical(x)[:, 0] for x in point]))
    words = words.reshape(-1).contiguous()
    got = torch.empty_like(words)
    lib = pk.library()
    stream = torch.cuda.current_stream(dev).cuda_stream

    def chain() -> None:
        rc = lib.cpzk_msm_quad_chain(words.data_ptr(), got.data_ptr(), doublings, stream)
        if rc:
            raise RuntimeError(f"cpzk_msm_quad_chain failed: CUDA error {rc}")

    chain()
    synchronize()
    lim = pk.limbs_of_words(got.reshape(4, 8))
    want = pk.point_double_k_plain(point, doublings)
    if not all(torch.equal(limbs.canonical(lim[i][:, None]), limbs.canonical(want[i]))
               for i in range(4)):
        raise AssertionError(f"cpzk_msm_quad_chain: {doublings} doublings differ from "
                             "point_double_k_plain")
    lat = kernel_ms(chain, None, 10)
    return {"doublings": doublings, "chain_floor_ms": lat["ms"], "ms_runs": lat["ms_runs"],
            "double_us": lat["ms"] * 1e3 / doublings}


def msm_kernels_vs_plain(dev, ms, c: int, chunk: int, int32_ops_per_s: float,
                         other_cs=MSM_OTHER_CS) -> dict:
    """Phase 3c: the MSM kernels against the plain MSM on every lane chunk
    of m terms: random valid points; digits of random scalars (0, 1, l - 1
    among them), as the main path makes them; the same with window 1 all
    +-2^(c-1), the top bucket; and a full-width case where every digit is
    5, so each window's terms share one bucket.  Then the random and
    top-bucket digits at each window size of ``other_cs`` on one chunk of
    ``ms[0]`` terms (the smallest and largest histograms).  ``msm_bucket``
    against the plain bucket sums, and ``msm_window_reduce`` (on the
    kernel's buckets and on the plain ones) against the plain reduction, as
    group elements: the encodings must be equal.  Times on the first, full
    chunk of the random and the one-bucket digits: each wrapper call (its
    two ``__global__`` launches) by ``kernel_ms``, and the random case once
    by the profiler (``device_ms``); and the chain floor of
    ``msm_window_reduce``'s schedule: c (K - 1) quad doublings on one warp
    (``cpzk_msm_quad_chain``), checked against the plain doublings."""
    import random

    import numpy as np
    import torch

    from cpzk_tpu_torch.core import edwards
    from cpzk_tpu_torch.core.scalars import L
    from cpzk_tpu_torch.ops import curve, msm, msm_kernels as mk, point_kernels as pk
    from cpzk_tpu_torch.ops.backend import _chunk_bounds, _chunk_point

    t_start = time.perf_counter()
    rng = random.Random(SEED + 5)
    np_rng = np.random.default_rng(SEED + 5)
    base = curve.points_to_device(
        [edwards.pt_scalar_mul(edwards.BASEPOINT, rng.randrange(L)) for _ in range(256)], dev)
    rows = {"msm_bucket": [], "msm_window_reduce": []}

    def err(a, b) -> int:
        return int((curve.encode(a) - curve.encode(b)).abs().max())

    def timed_row(name, case, p, dd, cc, buckets) -> dict:
        if name == "msm_bucket":
            row = {**bound_of(*mk.msm_bucket_work(dd, cc), int32_ops_per_s),
                   "nonzero_digits": int((dd != 0).sum())}
            kernel = lambda: mk.msm_bucket(p, dd, cc)  # noqa: E731
            plain = lambda: msm.bucket_sums_plain(p, dd, cc)  # noqa: E731
        else:
            row = bound_of(*mk.msm_window_reduce_work(dd.shape[0], cc), int32_ops_per_s)
            kernel = lambda: mk.msm_window_reduce(buckets, cc)  # noqa: E731
            plain = lambda: msm.window_reduce_plain(buckets, cc)  # noqa: E731
        row.update(kernel_ms(kernel, plain, MSM_TIMED_REPS))
        row["global_launches_per_call"] = len(mk.GLOBALS[name])
        if case == "random":
            # the kernel alone: tracing the plain version's many small
            # launches takes minutes, and kernel_ms timed it already
            prof = device_ms(name, kernel, None, 5, 0, kernels=mk.GLOBALS[name])
            row["profiler"] = {"ms": prof["ms"],
                               "profiled_launches": prof["profiled_launches"],
                               "expected_launches": prof["expected_launches"],
                               "timed_by": "torch.profiler device events (device_ms)"}
        return row

    def check(m, cc, case, dg, pts, chunk_of, timed):
        d = torch.from_numpy(dg).to(dev)
        for lo, hi in _chunk_bounds(m, chunk_of):
            p, dd = _chunk_point(pts, lo, hi), d[:, lo:hi].contiguous()
            buckets = mk.msm_bucket(p, dd, cc)
            out = mk.msm_window_reduce(buckets, cc)
            synchronize()
            ref_buckets = msm.bucket_sums_plain(p, dd, cc)
            ref = msm.window_reduce_plain(ref_buckets, cc)
            errs = {"msm_bucket": err(buckets, ref_buckets),
                    "msm_window_reduce": max(err(out, ref),
                                             err(mk.msm_window_reduce(ref_buckets, cc), ref))}
            if any(errs.values()):
                raise AssertionError(f"MSM kernels m={m} c={cc} {case} chunk {lo}:{hi}: "
                                     f"encodings differ by {errs}")
            for name, e in errs.items():
                row = {"m": m, "case": case, "chunk": [lo, hi], "c": cc, "max_abs_err": e}
                if timed and lo == 0 and hi - lo == chunk_of:
                    row.update(timed_row(name, case, p, dd, cc, buckets))
                rows[name].append(row)

    def inputs(m, cc):
        i1 = torch.from_numpy(np_rng.integers(0, 256, m)).to(dev)
        i2 = torch.from_numpy(np_rng.integers(0, 256, m)).to(dev)
        pts = pk.point_add_plain(tuple(x[:, i1] for x in base), tuple(x[:, i2] for x in base))
        vals = [rng.randrange(L) for _ in range(m - 3)] + [0, 1, L - 1]
        digits = msm.scalars_to_signed_digits(vals, cc)
        top = digits.copy()
        half = 1 << (cc - 1)
        top[1] = np.where(np.arange(m) % 3 == 0, -half, half)
        return pts, digits, top

    for m in ms:
        pts, digits, top = inputs(m, c)
        for case, dg in (("random", digits), ("top_bucket", top),
                         ("one_bucket", np.full_like(digits, 5))):
            check(m, c, case, dg, pts, chunk, case != "top_bucket")
    for cc in other_cs:
        pts, digits, top = inputs(ms[0], cc)
        for case, dg in (("random", digits), ("top_bucket", top)):
            check(ms[0], cc, case, dg, pts, ms[0], False)

    # the chain floor of msm_window_reduce's schedule: c (K - 1) doublings
    # of the top window, one after another, each shared by a quad of lanes
    # as the scale kernel shares them (cpzk_msm_quad_chain, one warp)
    k = msm.num_windows(c)
    doublings = c * (k - 1)
    lat = quad_chain_floor(dev, tuple(x[:, :1].contiguous() for x in base), doublings)
    floor = {"c": c, "windows": k, **lat, "adds_after": (k - 1).bit_length(),
             "timed_by": "cpzk_msm_quad_chain (one warp, a quad a doubling, the scale "
                         "kernel's schedule), c (K - 1) rounds, by kernel_ms",
             "floor_of": "msm_window_reduce's quad schedule, not of every design"}
    for row in rows["msm_window_reduce"]:
        if "ms" in row:
            row["chain_floor"] = floor
    return {**rows, "seconds": time.perf_counter() - t_start}


def ladder_kernels_vs_plain(dev, params, corpus, int32_ops_per_s: float, gen) -> dict:
    """Phase 3f: the per-row ladder kernels against their plain versions on
    the same card tensors.  The plain versions (``verify.*_plain``) are the
    step-by-step composition the main path ran before these kernels: a
    ``point_double_k`` and a ``point_add`` launch a ladder step and term,
    torch table gathers, ``tree_sum`` (the point kernels themselves held
    against their plain PyTorch versions above).  Rows tile the corpus
    (fresh alphas, beta) and are marshalled as the backend marshals them.

    ``ladder_combined`` at each of :data:`LADDER_COMBINED_NS` lanes (the
    correction row at lane n - 1, or after the 4096 rows with identity
    padding to 6,144), valid and with one response off by one: the chunk
    total equal to the plain one as a group element (its canonical encoding
    the same bytes), the identity test equal to the plain one and to the
    expectation.  ``ladder_each`` at each of :data:`LADDER_EACH_NS` lanes,
    three rows tampered (a response, a commitment of each equation), with
    g and h shared ([20, 1]) and per lane (every row's six points scaled by
    a random u (G's side) and v (H's side) per lane on the card, which keeps
    each equation's truth): bits equal to the plain ones and to the
    expectation.  ``ladder_partials_identity`` on the 16,384-row check's two
    chunk totals (its 16,385 lanes padded to 18,432), written by
    ``ladder_combined`` into their columns, and on k random totals for k in
    :data:`PARTIALS_KS` (pairs P, -P), valid and tampered: equal to the
    plain tree-sum and identity test.  Times by ``kernel_ms`` at the paths'
    widths beside the bounds (:mod:`.ladder_kernels`' ``*_work``), and each
    lane ladder's chain floor: the kernel at one lane (one quad of threads,
    two for a per-row lane), its result checked against the plain one; the
    partials' chain floor is k = 2 (one quad add), and the launch floor an
    empty kernel's."""
    import numpy as np
    import torch

    from cpzk_tpu_torch.bench_kernels import random_totals

    from cpzk_tpu_torch.core.ristretto import Scalar
    from cpzk_tpu_torch.core.scalars import L
    from cpzk_tpu_torch.ops import backend as bk, curve, ladder_kernels as lk, limbs, verify
    from cpzk_tpu_torch.protocol.batch import BatchRow

    t_start = time.perf_counter()
    pool, beta = north_star_rows(params, corpus, max(LADDER_COMBINED_NS + LADDER_EACH_NS), gen)
    g = curve.points_to_device([params.generator_g.point], dev)
    h = curve.points_to_device([params.generator_h.point], dev)

    def tampered(rows, marks: dict):
        """Row k off by one in its response ("s"), or its r1 (r2) replaced
        by its r2 (r1)."""
        out = list(rows)
        for k, kind in marks.items():
            r = out[k]
            s, r1, r2 = r.s, r.r1, r.r2
            if kind == "s":
                s = Scalar(r.s.value + 1)
            elif kind == "r1":
                r1 = r.r2
            else:
                r2 = r.r1
            out[k] = BatchRow(r.g, r.h, r.y1, r.y2, r1, r2, s, r.c, r.alpha)
        return out

    def windows(values, lanes):
        return curve.scalar_windows(values, lanes, dev)

    def combined_args(rows, lanes):
        a, ac, ba, bac, corr0, corr1 = bk._host_rlc_scalars(rows, beta)
        return (bk._elems_soa([r.r1 for r in rows] + [rows[0].g], lanes, dev),
                bk._elems_soa([r.y1 for r in rows] + [rows[0].h], lanes, dev),
                bk._elems_soa([r.r2 for r in rows], lanes, dev),
                bk._elems_soa([r.y2 for r in rows], lanes, dev),
                windows(a + [corr0], lanes), windows(ac + [corr1], lanes),
                windows(ba, lanes), windows(bac, lanes))

    def each_args(rows, lanes):
        return ((g, h) + tuple(bk._elems_soa([getattr(r, k) for r in rows], lanes, dev)
                               for k in ("y1", "y2", "r1", "r2"))
                + (windows([r.s.value for r in rows], lanes),
                   windows([r.c.value for r in rows], lanes)))

    def per_lane(args, lanes):
        u, v = (windows([int.from_bytes(gen.fill_bytes(32), "little") % (L - 1) + 1
                         for _ in range(lanes)], lanes) for _ in range(2))
        gg, hh, y1, y2, r1, r2, ws, wc = args
        wide = [tuple(c.expand(limbs.NLIMBS, lanes).contiguous() for c in p) for p in (gg, hh)]
        return (curve.scalar_mul(wide[0], u), curve.scalar_mul(wide[1], v),
                curve.scalar_mul(y1, u), curve.scalar_mul(y2, v),
                curve.scalar_mul(r1, u), curve.scalar_mul(r2, v), ws, wc)

    def encoding_err(p, q) -> int:
        return int((curve.encode(p) - curve.encode(q)).abs().max())

    def timed(kernel, plain, work) -> dict:
        return {**bound_of(*work, int32_ops_per_s), **kernel_ms(kernel, plain, LADDER_REPS)}

    out = {name: [] for name in LADDER_KERNELS}
    for n in LADDER_COMBINED_NS:
        rows = pool[:SERVING_N if n == CHUNK_4096_N else n - 1]
        for case, marks in (("valid", {}), ("tampered", {len(rows) // 3: "s"})):
            args = combined_args(tampered(rows, marks), n)
            total, ok = lk.ladder_combined(*args)
            synchronize()
            ref = verify.combined_partial_kernel_plain(*args)
            ref_ok = bool(curve.is_identity(tuple(c[:, 0] for c in ref)))
            err = encoding_err(total, ref)
            if err or bool(ok) is not ref_ok or ref_ok is not (case == "valid"):
                raise AssertionError(f"ladder_combined n={n} {case}: encoding error {err}, "
                                     f"verdict {bool(ok)}, plain {ref_ok}")
            row = {"n": n, "rows": len(rows), "case": case, "max_abs_err": err,
                   "verdict": bool(ok)}
            if case == "valid" and n != LADDER_COMBINED_NS[0]:
                row.update(timed(lambda a=args: lk.ladder_combined(*a),
                                 lambda a=args: verify.combined_partial_kernel_plain(*a),
                                 lk.combined_work(n)))
            out["ladder_combined"].append(row)
    for n in LADDER_EACH_NS:
        marks = {1: "s", n // 2: "r1", n - 2: "r2"}
        want = [i not in marks for i in range(n)]
        shared = each_args(tampered(pool[:n], marks), n)
        for case, args in (("shared_generators", shared),
                           ("per_lane_generators", per_lane(shared, n))):
            bits = lk.ladder_each(*args)
            synchronize()
            ref = verify.verify_each_kernel_plain(*args)
            err = int((bits.int() - ref.int()).abs().max())
            if err or bits.tolist() != want:
                raise AssertionError(f"ladder_each n={n} {case}: {err} bits differ from the "
                                     "plain version, or from the expectation")
            row = {"n": n, "case": case, "tampered_rows": sorted(marks), "max_abs_err": err}
            if n != LADDER_EACH_NS[0]:
                row.update(timed(lambda a=args: lk.ladder_each(*a),
                                 lambda a=args: verify.verify_each_kernel_plain(*a),
                                 lk.each_work(n, case == "shared_generators")))
            out["ladder_each"].append(row)
    # the 16,384-row check's two chunk totals
    pad = bk._pad_lanes(NORTH_STAR_N + 1)
    bounds = list(bk._chunk_bounds(pad))
    for case, marks in (("valid", {}), ("tampered", {NORTH_STAR_N // 2: "s"})):
        args = combined_args(tampered(pool[:NORTH_STAR_N], marks), pad)
        parts = tuple(torch.empty((limbs.NLIMBS, len(bounds)), dtype=torch.int32, device=dev)
                      for _ in range(4))
        for i, (lo, hi) in enumerate(bounds):
            lk.ladder_combined(*(bk._chunk_point(p, lo, hi) for p in args[:4]),
                               *(w[:, lo:hi] for w in args[4:]),
                               out=bk._chunk_point(parts, i, i + 1))
        ok = bool(lk.ladder_partials_identity(parts))
        ref = bool(verify.partials_identity_plain(parts))
        if ok is not ref or ref is not (case == "valid"):
            raise AssertionError(f"ladder_partials_identity {case}: {ok}, plain {ref}")
        row = {"k": len(bounds), "lanes": pad, "case": case, "max_abs_err": 0, "verdict": ok}
        if case == "valid":
            row.update(timed(lambda: lk.ladder_partials_identity(parts),
                             lambda: verify.partials_identity_plain(parts),
                             lk.partials_work(len(bounds))))
        out["ladder_partials_identity"].append(row)
    # k random totals, valid and with one replaced, from k = 1 (the identity
    # test alone) to 92 (past the kernel's 32 quads)
    np_rng = np.random.default_rng(SEED + 19)
    for k in PARTIALS_KS:
        for case in ("valid", "tampered"):
            parts = curve.points_to_device(random_totals(np_rng, k, case == "valid"), dev)
            ok = bool(lk.ladder_partials_identity(parts))
            ref = bool(verify.partials_identity_plain(parts))
            if ok is not ref or ref is not (case == "valid"):
                raise AssertionError(f"ladder_partials_identity k={k} {case}: {ok}, plain {ref}")
            row = {"k": k, "case": f"random totals, {case}", "max_abs_err": 0, "verdict": ok}
            if case == "valid" and k in PARTIALS_TIMED_KS:
                row.update(timed(lambda p=parts: lk.ladder_partials_identity(p),
                                 lambda p=parts: verify.partials_identity_plain(p),
                                 lk.partials_work(k)))
            out["ladder_partials_identity"].append(row)
    floor = launch_floor(dev)
    for row in out["ladder_partials_identity"]:
        if "ms" in row:
            # its chain floor: the 16,384-row check's k = 2, one quad add
            row["chain_floor_ms"] = out["ladder_partials_identity"][0]["ms"]
            row.update(floor)
    # the chain floors: one lane (one quad; two for a per-row lane), each
    # checked first: the one-lane total against the plain one, the per-row
    # bit valid and with the response off by one
    two = combined_args(pool[:1], 2)
    one_c = (tuple(bk._chunk_point(p, 0, 1) for p in two[:4])
             + tuple(w[:, :1] for w in two[4:]))
    one_e = each_args(pool[:1], 1)
    total, _ = lk.ladder_combined(*one_c)
    err = encoding_err(total, verify.combined_partial_kernel_plain(*one_c))
    for rows, want in ((pool[:1], True), (tampered(pool[:1], {0: "s"}), False)):
        args = each_args(rows, 1)
        bits = lk.ladder_each(*args)
        if bits.tolist() != [want] or not torch.equal(bits, verify.verify_each_kernel_plain(*args)):
            err = max(err, 1)
    if err:
        raise AssertionError(f"one lane: the kernels differ from the plain versions ({err})")
    floors = {"ladder_combined": kernel_ms(lambda: lk.ladder_combined(*one_c), None, 5),
              "ladder_each": kernel_ms(lambda: lk.ladder_each(*one_e), None, 5)}
    for name, lat in floors.items():
        out[name].append({"n": 1, "case": "one lane (the chain floor)", "max_abs_err": 0})
        for row in out[name]:
            if "ms" in row:
                row["chain_floor_ms"] = lat["ms"]
                row["chain_floor_runs"] = lat["ms_runs"]
    out["seconds"] = time.perf_counter() - t_start
    return out


def batch_verdicts(backend, params, corpus, n: int) -> dict:
    """Phase 4's n entries through ``BatchVerifier`` on ``backend``: the
    all-valid batch (eager parse) and the mixed one (deferred), each as
    (per-entry result text, seconds of ``verify``)."""
    from cpzk_tpu_torch import BatchVerifier, SecureRng

    valid, mixed, _, _ = serving_wires(params, corpus, n)
    out = {}
    for label, entries, deferred in (("valid", valid, False), ("mixed", mixed, True)):
        proofs, statements, _, _ = parse_entries(entries, deferred)
        bv = BatchVerifier(backend=backend, max_size=n)
        for (_, _, _, ctx), pr, st in zip(entries, proofs, statements):
            bv.add_with_context(params, st, pr, ctx)
        t0 = time.perf_counter()
        results = bv.verify(SecureRng())
        synchronize()
        out[label] = ([None if r is None else (type(r).__name__, str(r)) for r in results],
                      time.perf_counter() - t0)
    return out


@contextlib.contextmanager
def device_rlc(on: bool):
    """``CPZK_DEVICE_RLC`` set to 1 (or unset) for the block."""
    saved = os.environ.pop("CPZK_DEVICE_RLC", None)
    if on:
        os.environ["CPZK_DEVICE_RLC"] = "1"
    try:
        yield
    finally:
        os.environ.pop("CPZK_DEVICE_RLC", None)
        if saved is not None:
            os.environ["CPZK_DEVICE_RLC"] = saved


def pippenger_phase(params, corpus, rows, beta, n: int, chunk: int,
                    on_card: bool = True) -> dict:
    """The ``pippenger`` phase, this slice's main path: the combined check
    as one Pippenger MSM (``TorchBackend(pippenger_min=2)``) through
    ``BatchVerifier`` on phase 4's n wire-parsed entries, with the host and
    the device scalar plane (``CPZK_DEVICE_RLC``): every valid entry
    accepted, the mixed batch's results equal to the per-row backend's
    (exact rows, exact errors); ``verify_combined`` on all rows (16,384:
    5 chunks of terms) True, and False with one tampered row; the per-row
    check with the device scalar plane the same.  The per-row reference
    runs first; every kernel's launch count is set to 0 just before the
    Pippenger batches and read just after them (``launches``, each of the
    six at least once); each check on all rows is counted on its own (a
    rehearsal on the CPU passes ``on_card=False``: the plain versions
    launch nothing)."""
    from cpzk_tpu_torch.core.ristretto import Scalar
    from cpzk_tpu_torch.ops import msm
    from cpzk_tpu_torch.ops.backend import TorchBackend, _pad_lanes, _pad_pow2
    from cpzk_tpu_torch.ops.point_kernels import all_launches, reset_all_launches
    from cpzk_tpu_torch.protocol.batch import BatchRow

    per_row = TorchBackend(lane_chunk=chunk)
    pip = TorchBackend(lane_chunk=chunk, pippenger_min=2)
    # the reference verdicts, on the per-row route, outside the count
    ref = batch_verdicts(per_row, params, corpus, n)
    _, _, bad, undecodable = serving_wires(params, corpus, n)
    flagged = [i for i, r in enumerate(ref["mixed"][0]) if r is not None]
    if flagged != sorted([*bad, *undecodable]):
        raise AssertionError(f"per-row backend flagged {flagged}")
    out = {"n": n, "tampered": len(bad), "undecodable": len(undecodable),
           "tolerance": "exact", "per_row_s": {k: v[1] for k, v in ref.items()},
           "launches_by_scalar_plane": {}}
    reset_all_launches()
    for label, on in (("host_rlc", False), ("device_rlc", True)):
        with device_rlc(on):
            got, out["launches_by_scalar_plane"][label] = launches_of(
                lambda: batch_verdicts(pip, params, corpus, n),
                POINT_KERNELS + LADDER_KERNELS + PIPPENGER_KERNELS)
        if got["valid"][0] != [None] * n:
            raise AssertionError(f"pippenger ({label}): a valid entry was rejected")
        if got["mixed"][0] != ref["mixed"][0]:
            raise AssertionError(f"pippenger ({label}): mixed results differ from per-row")
        out[f"pippenger_{label}_s"] = {k: v[1] for k, v in got.items()}
    out["launches"] = all_launches()
    # a 4096-row check is two chunks of terms, whose partials point_add
    # sums; the mixed batches' per-row checks run ladder_each
    for name in PIPPENGER_KERNELS + ("point_add", "ladder_each"):
        if on_card and out["launches"][name] < 1:
            raise AssertionError(f"{name} was never launched on the pippenger path")

    big = len(rows)
    m = 4 * _pad_pow2(big) + 2
    m_pad = m if m <= chunk else _pad_lanes(m, chunk)
    bad_rows = list(rows)
    k = (7 * big) // 15
    r = bad_rows[k]
    bad_rows[k] = BatchRow(r.g, r.h, r.y1, r.y2, r.r1, r.r2, Scalar(r.s.value + 1), r.c,
                           r.alpha)
    checks = {}
    for label, backend, on in (("pippenger_host_rlc", pip, False),
                               ("pippenger_device_rlc", pip, True),
                               ("per_row_device_rlc", per_row, True)):
        with device_rlc(on):
            ok, launches = launches_of(lambda b=backend: b.verify_combined(rows, beta),
                                       POINT_KERNELS + LADDER_KERNELS + PIPPENGER_KERNELS)
            ok_bad = backend.verify_combined(bad_rows, beta)
        if ok is not True or ok_bad is not False:
            raise AssertionError(f"{label}: {big}-row check gave {ok}, tampered {ok_bad}")
        checks[label] = launches
    chunks = checks["pippenger_host_rlc"]["msm_bucket"]
    if on_card and chunks != -(-m_pad // chunk):
        raise AssertionError(f"{big}-row Pippenger check ran {chunks} chunks")
    out["big_check"] = {"rows": big, "terms": m_pad, "c": msm.pick_window(min(m, chunk)),
                        "chunks": chunks, "launches": checks}
    return out


def pippenger_ab(rows, beta, ns, reps: int) -> dict:
    """The A/B of the combined check at each row count, in turns on one
    card: per-row ladders, Pippenger, Pippenger with the device scalar
    plane; wall time (host clock to a synchronise) and kernel launches per
    check.  Then one 4096-row Pippenger check under torch.profiler: device
    time by kernel and the idle share (table in
    ``chiprun_out/profile_pippenger_4096.txt``)."""
    from cpzk_tpu_torch.ops.backend import TorchBackend

    configs = {"per_row": (TorchBackend(), False),
               "pippenger": (TorchBackend(pippenger_min=2), False),
               "pippenger_device_rlc": (TorchBackend(pippenger_min=2), True)}
    out = {}
    for n in ns:
        sub = rows[:n]
        res = {name: {"wall_ms": [], "launches": None} for name in configs}
        order = list(configs)
        for rep in range(reps + 1):  # the first turn warms each config
            for name in (order if rep % 2 == 0 else order[::-1]):
                backend, on = configs[name]
                with device_rlc(on):
                    synchronize()
                    t0 = time.perf_counter()
                    ok, launches = launches_of(
                        lambda: backend.verify_combined(sub, beta),
                        POINT_KERNELS + LADDER_KERNELS + PIPPENGER_KERNELS)
                    synchronize()
                    wall = (time.perf_counter() - t0) * 1e3
                if ok is not True:
                    raise AssertionError(f"A/B {name} n={n}: the check rejected")
                if rep:
                    res[name]["wall_ms"].append(wall)
                res[name]["launches"] = sum(launches.values())
        out[n] = res
    pip = configs["pippenger"][0]
    sub = rows[:4096]
    pip.verify_combined(sub, beta)
    synchronize()
    t0 = time.perf_counter()
    pip.verify_combined(sub, beta)
    synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    by_kernel = {key: (us / 1e3, count) for key, us, count in
                 profiled(lambda: pip.verify_combined(sub, beta))}
    busy_ms = sum(v[0] for v in by_kernel.values())
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", "profile_pippenger_4096.txt"), "w") as f:
        for key, (ms, count) in sorted(by_kernel.items(), key=lambda kv: -kv[1][0]):
            f.write(f"{ms:10.3f} ms {count:6d}  {key}\n")
    from cpzk_tpu_torch.ops.msm_kernels import GLOBALS as MSM_GLOBALS

    # by wrapper: the MSM pair's calls launch two __global__ functions each
    ours = {}
    for k, (ms, count) in by_kernel.items():
        for name in POINT_KERNELS + LADDER_KERNELS + PIPPENGER_KERNELS:
            if any(f"::{g}(" in k for g in MSM_GLOBALS.get(name, (f"{name}_kernel",))):
                prev = ours.get(name, (0.0, 0))
                ours[name] = (prev[0] + ms, prev[1] + count)
    out["profile_4096"] = {
        "wall_ms": wall_ms, "device_busy_ms": busy_ms,
        "device_idle_share": 1 - busy_ms / wall_ms,
        "kernels_ms": {k: v[0] for k, v in ours.items()},
        "kernel_launches": {k: v[1] for k, v in ours.items()},
        "other_device_ms": busy_ms - sum(v[0] for v in ours.values()),
        "other_launches": sum(v[1] for v in by_kernel.values()) - sum(
            v[1] for v in ours.values()),
        "top": [[k[:100], v[0], v[1]] for k, v in
                sorted(by_kernel.items(), key=lambda kv: -kv[1][0])[:8]],
    }
    return out


#: combined checks in phase 6's traced step (its figures are per check)
PROFILED_CHECKS = 3


def profile_combined(backend, rows, beta) -> dict:
    """Phase 6: wall time of one combined check, its kernel launches (the
    wrappers' counts) and the card's interval in it (CUDA events around the
    backend's device work, the flight recorder's device sink) with the idle
    share they give, then its device time by kernel under the profiler
    over a step of :data:`PROFILED_CHECKS` checks (traced again, up to three
    times in all, until it sees the ladder kernel; its figures are null
    where it never did), per check: the ladder kernels by name, every
    kernel launched (device events other than copies and memsets), the
    busy time and the idle share, beside the step-by-step composition's
    8,533 launches and 24.3-24.6 ms busy (PERF.md section 5)."""
    from cpzk_tpu_torch.observability import flightrec

    backend.verify_combined(rows, beta)  # warm
    synchronize()
    sink, token = flightrec.install_sink()
    try:
        t0 = time.perf_counter()
        _, launches = launches_of(lambda: backend.verify_combined(rows, beta),
                                  POINT_KERNELS + LADDER_KERNELS)
        synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    finally:
        flightrec.uninstall_sink(token)
    # a traced step of PROFILED_CHECKS checks: the profiler has dropped a
    # step of a few launches whole
    for attempt in range(3):
        by_kernel = {key: (us / 1e3 / PROFILED_CHECKS, count / PROFILED_CHECKS)
                     for key, us, count in profiled(lambda: [
                         backend.verify_combined(rows, beta) for _ in range(PROFILED_CHECKS)])}
        if any("::ladder_combined_kernel(" in k for k in by_kernel):
            break
    busy_ms = sum(v[0] for v in by_kernel.values())
    ours = {name: v for k, v in by_kernel.items()
            for name in POINT_KERNELS + LADDER_KERNELS if f"::{name}_kernel(" in k}
    kernels = {k: v for k, v in by_kernel.items()
               if not k.startswith(("Memcpy", "Memset"))}
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", "profile_4096.txt"), "w") as f:
        for key, (ms, count) in sorted(by_kernel.items(), key=lambda kv: -kv[1][0]):
            f.write(f"{ms:10.3f} ms {count:8.2f}  {key}\n")
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1][0])[:8]
    seen = bool(ours)
    return {
        "rows": len(rows), "wall_ms": wall_ms, "launches": launches,
        "device_interval_ms": sink.device_interval_s * 1e3,
        "device_idle_share_by_events": 1 - sink.device_interval_s * 1e3 / wall_ms,
        "profiler_traces": attempt + 1, "profiler_saw_the_ladder_kernel": seen,
        "device_busy_ms": busy_ms if seen else None,
        "device_idle_share": 1 - busy_ms / wall_ms if seen else None,
        "ladder_kernels_ms": {k: v[0] for k, v in ours.items()},
        "ladder_kernel_launches": {k: v[1] for k, v in ours.items()},
        "kernel_launches": sum(v[1] for v in kernels.values()) if seen else None,
        "kernel_ms": sum(v[0] for v in kernels.values()) if seen else None,
        "copies_and_memsets": {k: v for k, v in by_kernel.items() if k not in kernels},
        "step_by_step": {"kernel_launches": 8533, "device_busy_ms": [24.3, 24.6],
                         "source": "PERF.md section 5"},
        "top": [[k[:100], v[0], v[1]] for k, v in top],
    }


def prover_kernels_vs_plain(dev, ns, timed_ns, k: int, int32_ops_per_s: float) -> dict:
    """Phase 3d: the batch prover's and the device challenges' kernels
    against their plain versions on the card.  ``comb_tables`` for G and H:
    tables equal to ``table_words`` of the plain tables (exact, the kernel's
    layout), with its chain floor (the 252 doublings of its bases on one
    quad); ``commitments`` at each lane count (digits of random scalars with
    0, 1 and l - 1, both tables): bytes identical, and equal to the host
    core's comb on a sample, with its chain floor (one lane);
    ``keccak_chain`` (random states, one a row and one shared, k random
    masks) and ``reduce_wide`` (64-byte values led by 0, 1, l - 1, l, 2 l,
    2^252, 2^256 - 1 and 2^512 - 1, then random): exact (``torch.equal``).  Device times at ``timed_ns``."""
    import random

    import numpy as np
    import torch

    from cpzk_tpu_torch import Parameters, Ristretto255, Scalar
    from cpzk_tpu_torch.bench_kernels import event_ms, wide_case
    from cpzk_tpu_torch.core.scalars import L
    from cpzk_tpu_torch.ops import curve, keccak_kernels as kk
    from cpzk_tpu_torch.ops import prove_kernels as pvk, scalar_kernels as sk, sclimbs as sc
    from cpzk_tpu_torch.ops.prove import _windows_lsb

    rng = random.Random(SEED + 7)
    np_rng = np.random.default_rng(SEED + 7)
    rows = {name: [] for name in PROVER_KERNELS + CHALLENGE_KERNELS}
    params = Parameters.new()
    tables, plain_tables = {}, {}
    for gen_name, elem in (("H", params.generator_h), ("G", params.generator_g)):
        p = curve.points_to_device([elem.point], dev)
        got = pvk.comb_tables(p)
        synchronize()
        # the plain tables take ~700k launches: this one call is also the
        # plain version's time (H's call warms the allocator for G's)
        box = []
        plain_ms = event_ms(lambda p=p: box.append(pvk.comb_tables_plain(p)))
        ref = box[0]
        err = int((pvk.table_words(got).to(torch.int64)
                   - pvk.table_words(ref).to(torch.int64)).abs().max())
        if err:
            raise AssertionError(f"comb_tables {gen_name}: words differ by {err}")
        row = {"generator": gen_name, "max_abs_err": err}
        if gen_name == "G":
            row.update(bound_of(*pvk.comb_tables_work(), int32_ops_per_s))
            row.update(kernel_ms(lambda: pvk.comb_tables(p), plain_ms, 3))
            if dev.type == "cuda":  # the quad chain runs on the card only
                row["chain_floor"] = {
                    **quad_chain_floor(dev, p, 4 * 63),
                    "timed_by": "cpzk_msm_quad_chain (one warp, a quad a doubling), the "
                                "252 doublings of the window bases, by kernel_ms"}
                row["chain_floor_ms"] = row["chain_floor"]["chain_floor_ms"]
        rows["comb_tables"].append(row)
        tables[gen_name], plain_tables[gen_name] = got, ref
    tg, th = tables["G"], tables["H"]
    plain_tables = plain_tables["G"], plain_tables["H"]

    def ints(shape):
        return torch.from_numpy(np_rng.integers(-2**31, 2**31, shape, dtype=np.int64)
                                .astype(np.int32)).to(dev)

    for n in ns:
        # 2^256 - 1: every nibble 15, the top window's digit 16 (two steps)
        vals = [rng.randrange(L) for _ in range(n)]
        vals[:min(n, 4)] = [0, 1, L - 1, 2**256 - 1][:min(n, 4)]
        digits = torch.from_numpy(_windows_lsb(vals)).to(dev)
        got = pvk.commitments(tg, th, digits)
        synchronize()
        ref = pvk.commitments_plain(*plain_tables, digits)
        err = max(int((a.to(torch.int32) - b.to(torch.int32)).abs().max())
                  for a, b in zip(got, ref))
        if err:
            raise AssertionError(f"commitments n={n}: bytes differ by {err}")
        cols = [np.ascontiguousarray(g.cpu().numpy().T) for g in got]
        for j in range(0, n, max(1, n // 16)):
            y1, y2 = Ristretto255.double_base_mul(params.generator_g, params.generator_h,
                                                  Scalar(vals[j] % L))
            if (cols[0][j].tobytes(), cols[1][j].tobytes()) != (y1.wire(), y2.wire()):
                raise AssertionError(f"commitments n={n} lane {j}: not the host core's comb")
        row = {"n": n, "max_abs_err": err, "host_comb_sample": len(range(0, n, max(1, n // 16)))}
        if n in timed_ns:
            row.update(bound_of(*pvk.commitments_work(n), int32_ops_per_s))
            row.update(kernel_ms(lambda: pvk.commitments(tg, th, digits),
                                 lambda: pvk.commitments_plain(*plain_tables, digits), 5))
        rows["commitments"].append(row)

        for shared in (False, True):
            width = 1 if shared else n
            s_hi, s_lo, m_hi, m_lo = ints((25, width)), ints((25, width)), \
                ints((k, 25, n)), ints((k, 25, n))
            got = kk.keccak_chain(s_hi, s_lo, m_hi, m_lo)
            synchronize()
            ref = kk.keccak_chain_plain(s_hi, s_lo, m_hi, m_lo)
            if not (torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])):
                raise AssertionError(f"keccak_chain n={n} shared={shared}: words differ")
            row = {"n": n, "k": k, "shared_state": shared, "max_abs_err": 0}
            if n in timed_ns and shared:
                row.update(bound_of(*kk.keccak_chain_work(n, k, shared), int32_ops_per_s))
                row.update(kernel_ms(
                    lambda: kk.keccak_chain(s_hi, s_lo, m_hi, m_lo),
                    lambda: kk.keccak_chain_plain(s_hi, s_lo, m_hi, m_lo), 20))
            rows["keccak_chain"].append(row)

        blobs = wide_case(np_rng, n)
        wide = torch.from_numpy(sc.bytes_wide_to_limbs(blobs)).to(dev)
        got = sc.reduce_wide(wide)
        synchronize()
        if not torch.equal(got, sc.reduce_wide_plain(wide)):
            raise AssertionError(f"reduce_wide n={n}: limbs differ")
        sample = list(range(0, n, max(1, n // 64)))
        want = [int.from_bytes(blobs[j].tobytes(), "little") % L for j in sample]
        if [sc.limbs_to_ints(got[:, j:j + 1])[0] for j in sample] != want:
            raise AssertionError(f"reduce_wide n={n}: not the host's value mod l")
        row = {"n": n, "rows": 40, "max_abs_err": 0}
        if n in timed_ns:
            row.update(bound_of(*sk.reduce_wide_work(40, n), int32_ops_per_s))
            row.update(kernel_ms(lambda: sc.reduce_wide(wide),
                                 lambda: sc.reduce_wide_plain(wide), 20))
        rows["reduce_wide"].append(row)
    # commitments' chain floor: one lane (a thread a point, G and H on two
    # blocks), after checking it
    one = torch.from_numpy(_windows_lsb([L - 1])).to(dev)
    got = pvk.commitments(tg, th, one)
    ref = pvk.commitments_plain(*plain_tables, one)
    if not (torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])):
        raise AssertionError("commitments at one lane: bytes differ from the plain version")
    floor = kernel_ms(lambda: pvk.commitments(tg, th, one), None, 10)
    for row in rows["commitments"]:
        if "ms" in row:
            row["chain_floor_ms"] = floor["ms"]
            row["chain_floor_runs"] = floor["ms_runs"]
    return rows


def commitment_columns(wires: list[bytes]):
    """(r1, r2) [n, 32] uint8 columns of n 109-byte proof wires."""
    import numpy as np

    raw = np.frombuffer(b"".join(wires), dtype=np.uint8).reshape(len(wires), 109)
    return np.ascontiguousarray(raw[:, 5:37]), np.ascontiguousarray(raw[:, 41:73])


def batch_prove_phase(params, n_statements: int, n_proofs: int, plain_n: int,
                      tamper_every: int, host_sample: int, on_card: bool = True) -> dict:
    """The ``batch_prove`` phase: ``BatchProver()`` on cuda:0 (two
    ``comb_tables`` launches; its tables equal ``table_words`` of the plain
    prover's), ``statements()`` of ``n_statements`` witnesses
    (byte-equal to the host core's comb), ``prove()`` of ``n_proofs``
    witnesses with their own 32-byte contexts (accepted by
    ``BatchVerifier(TorchBackend())`` in one combined check on the card; a
    copy with one byte of s changed in every ``tamper_every``-th proof
    rejected at exactly those rows; a sample checked by the host
    ``Verifier``), and the plain prover (``device="cpu"``) giving the card's
    bytes for the same nonces on ``plain_n`` witnesses.  Every count is set
    to 0 just before the prover is built and read just after ``prove()``;
    the verification is counted on its own.  Then the time of ``prove()``
    split by stage, and the card's interval and idle share in one
    ``prove()``, as the prover reports them (a rehearsal on the CPU passes
    ``on_card=False``).  Returns the report
    and (statements, proof wires, contexts) of the proofs."""
    import numpy as np
    import torch

    from cpzk_tpu_torch import (
        BatchVerifier, InvalidParams, Proof, Ristretto255, SecureRng, Statement, Transcript,
        Verifier)
    from cpzk_tpu_torch.core.scalars import L
    from cpzk_tpu_torch.core.transcript import derive_challenges_batch
    from cpzk_tpu_torch.observability import flightrec
    from cpzk_tpu_torch.ops import backend as backend_mod, prove_kernels as pvk
    from cpzk_tpu_torch.ops.backend import TorchBackend
    from cpzk_tpu_torch.ops.point_kernels import all_launches, reset_all_launches
    from cpzk_tpu_torch.ops.prove import BatchProver, _columns, _windows_lsb
    from cpzk_tpu_torch.protocol.gadgets import PROTOCOL_VERSION, frame_fields

    gen = SeededRng(SEED + 11)
    out = {"statements": n_statements, "proofs": n_proofs, "lane_chunk": backend_mod.LANE_CHUNK,
           "tolerance": "exact (bytes)"}
    witnesses = Ristretto255.random_scalars(gen, n_statements)
    contexts = [gen.fill_bytes(32) for _ in range(n_proofs)]

    # the main path: every count set to 0 just before, read just after
    reset_all_launches()
    synchronize()
    t0 = time.perf_counter()
    bp = BatchProver(params)
    synchronize()
    out["init_s"] = time.perf_counter() - t0
    out["launches_init"] = all_launches()
    t0 = time.perf_counter()
    statements = bp.statements(witnesses)
    out["statements_s"] = time.perf_counter() - t0
    out["statements_per_s"] = n_statements / out["statements_s"]
    ws = witnesses[:n_proofs]
    t0 = time.perf_counter()
    st_p, proofs = bp.prove(ws, contexts, SeededRng(SEED + 12))
    out["prove_s"] = time.perf_counter() - t0
    out["proofs_per_s"] = n_proofs / out["prove_s"]
    out["launches"] = all_launches()
    for name in PROVER_KERNELS:
        if on_card and out["launches"][name] < 1:
            raise AssertionError(f"{name} was never launched on the batch_prove path")

    # tables against the plain prover's; its bytes against the card's
    t0 = time.perf_counter()
    plain = BatchProver(params, device="cpu")
    out["plain_init_s"] = time.perf_counter() - t0
    for mine, ref in ((bp._tg, plain._tg), (bp._th, plain._th)):
        if not torch.equal(pvk.table_words(mine).cpu(), pvk.table_words(ref)):
            raise AssertionError("comb tables differ from the plain prover's")
    small = witnesses[:plain_n]
    small_ctx = contexts[:plain_n]
    if plain.prove(small, small_ctx, SeededRng(SEED + 13)) != bp.prove(
            small, small_ctx, SeededRng(SEED + 13)):
        raise AssertionError("the plain prover and the card give different bytes")
    out["plain_equal_n"] = plain_n

    # statements: the host core's comb, every one
    t0 = time.perf_counter()
    for w, (y1b, y2b) in zip(witnesses, statements):
        y1, y2 = Ristretto255.double_base_mul(params.generator_g, params.generator_h, w)
        if (y1b, y2b) != (y1.wire(), y2.wire()):
            raise AssertionError("a statement differs from the host core's comb")
    out["host_comb_check_s"] = time.perf_counter() - t0
    if st_p != statements[:n_proofs]:
        raise AssertionError("prove() recomputed different statements")

    # proofs: the card's BatchVerifier, all valid then 1% tampered
    parsed = [Statement(Ristretto255.element_from_bytes(a), Ristretto255.element_from_bytes(b))
              for a, b in statements[:n_proofs]]
    tampered = list(range(tamper_every // 2, n_proofs, tamper_every))
    bad = list(proofs)
    for i in tampered:
        s = int.from_bytes(bad[i][77:], "little") ^ 1
        if s % L == 0 or s >= L:
            raise AssertionError(f"tampering proof {i} left no valid scalar")
        bad[i] = bad[i][:77] + s.to_bytes(32, "little")
    verdicts = {}
    for label, wires in (("valid", proofs), ("tampered", bad)):
        recorder = RecordingBackend(TorchBackend())
        bv = BatchVerifier(backend=recorder, max_size=n_proofs)
        for st, wire, ctx in zip(parsed, wires, contexts):
            bv.add_with_context(params, st, Proof.from_bytes(wire), ctx)
        synchronize()
        t0 = time.perf_counter()
        results, launches = launches_of(lambda: bv.verify(SecureRng()))
        synchronize()
        verdicts[label] = {"s": time.perf_counter() - t0, "backend_calls": recorder.calls,
                           "launches": launches}
        rejected = [i for i, r in enumerate(results) if r is not None]
        want = [] if label == "valid" else tampered
        if rejected != want:
            raise AssertionError(f"{label} proofs: rejected {rejected[:8]}..., "
                                 f"expected {want[:8]}...")
        if any(not isinstance(results[i], InvalidParams) for i in rejected):
            raise AssertionError(f"{label} proofs: a rejection is not InvalidParams")
    if verdicts["valid"]["backend_calls"] != [n_proofs]:
        raise AssertionError(f"valid proofs: not one combined check "
                             f"({verdicts['valid']['backend_calls']})")
    # the valid proofs' one combined check spans two lane chunks
    if on_card and min(verdicts["valid"]["launches"][k] for k in
                       ("ladder_combined", "ladder_partials_identity")) < 1:
        raise AssertionError("the verification launched no ladder kernel: "
                             f"{verdicts['valid']['launches']}")
    out["verify"] = verdicts
    out["tampered"] = len(tampered)
    for i in range(0, n_proofs, max(1, n_proofs // host_sample)):
        t = Transcript()
        t.append_context(contexts[i])
        Verifier(params, parsed[i]).verify_with_transcript(Proof.from_bytes(proofs[i]), t)
    out["host_verifier_sample"] = len(range(0, n_proofs, max(1, n_proofs // host_sample)))

    # where prove()'s time goes: its steps one by one, on the same nonces
    stages = {}
    synchronize()
    t0 = time.perf_counter()
    rng = SeededRng(SEED + 12)
    ks = [Ristretto255.random_scalar(rng).value for _ in range(n_proofs)]
    stages["nonces_s"] = time.perf_counter() - t0
    chunk = backend_mod.LANE_CHUNK
    pad = backend_mod._pad_lanes(n_proofs, chunk)
    t0 = time.perf_counter()
    win = _windows_lsb(ks + [0] * (pad - n_proofs))
    stages["windows_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    digits = torch.from_numpy(win).to(bp.device)
    synchronize()
    stages["digits_upload_s"] = time.perf_counter() - t0
    events = [torch.cuda.Event(enable_timing=True) for _ in range(2)] if on_card else None
    t0 = time.perf_counter()
    if events:
        events[0].record()
    parts = [pvk.commitments(bp._tg, bp._th, digits[:, lo:hi])
             for lo, hi in backend_mod._chunk_bounds(pad, chunk)]
    if events:
        events[1].record()
    b1 = torch.cat([q[0] for q in parts], dim=-1)
    b2 = torch.cat([q[1] for q in parts], dim=-1)
    synchronize()
    stages["commitments_s"] = time.perf_counter() - t0
    if events:
        stages["commitments_device_ms"] = events[0].elapsed_time(events[1])
    t0 = time.perf_counter()
    r1s, r2s = _columns(b1, n_proofs), _columns(b2, n_proofs)
    stages["download_columns_s"] = time.perf_counter() - t0
    gb, hb = params.generator_g.wire(), params.generator_h.wire()
    t0 = time.perf_counter()
    challenges = derive_challenges_batch(contexts, [gb] * n_proofs, [hb] * n_proofs,
                                         [st[0] for st in st_p], [st[1] for st in st_p],
                                         r1s, r2s)
    stages["challenges_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    xs = [w.value for w in ws]
    responses = [((k + c.value * x) % L).to_bytes(32, "little")
                 for k, c, x in zip(ks, challenges, xs)]
    stages["responses_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    framed = [frame_fields(PROTOCOL_VERSION, a, b, r) for a, b, r in zip(r1s, r2s, responses)]
    stages["framing_s"] = time.perf_counter() - t0
    if framed != proofs:
        raise AssertionError("prove()'s stages, run one by one, give other bytes")
    out["prove_stages_without_statements"] = stages
    if events:
        # the card's time in statements(): its chunks' commitments launches
        # between two events, on the witnesses' digits
        pad_s = backend_mod._pad_lanes(n_statements, chunk)
        wd = torch.from_numpy(_windows_lsb([w.value for w in witnesses]
                                           + [0] * (pad_s - n_statements))).to(bp.device)
        synchronize()
        events[0].record()
        for lo, hi in backend_mod._chunk_bounds(pad_s, chunk):
            pvk.commitments(bp._tg, bp._th, wd[:, lo:hi])
        events[1].record()
        synchronize()
        out["statements_commitments_device_ms"] = events[0].elapsed_time(events[1])

    # the card's interval and idle share in one prove() (statements given, as
    # a caller holding registered statements runs it): the prover reports the
    # interval of its work on the card (CUDA events around the digits'
    # upload, the launches and the download), as the serving plane's batches
    # report theirs
    sink, token = flightrec.install_sink()
    try:
        synchronize()
        t0 = time.perf_counter()
        bp.prove(ws, contexts, SeededRng(SEED + 14), statements=st_p)
        wall_ms = (time.perf_counter() - t0) * 1e3
    finally:
        flightrec.uninstall_sink(token)
    interval_ms = sink.device_interval_s * 1e3
    if not 0 < interval_ms < wall_ms:
        raise AssertionError(f"prove(): device interval {interval_ms} ms of {wall_ms} ms")
    out["prove_device_interval"] = {
        "wall_ms": wall_ms, "device_interval_ms": interval_ms,
        "device_interval_share": interval_ms / wall_ms,
        "device_idle_share": 1 - interval_ms / wall_ms,
        "timed_by": "CUDA events around the prover's upload, launches and download",
        # the commitments' own time (CUDA events around the launches of the
        # stage run above): the idle share cannot be larger than this leaves
        "idle_share_at_most": 1 - stages.get("commitments_device_ms", 0.0) / wall_ms}
    return out, (st_p, proofs, contexts)


def device_challenges_phase(params, proofs_out, ns, reps: int, int32_ops_per_s: float,
                            on_card: bool = True) -> dict:
    """The ``device_challenges`` phase: the batch_prove phase's proofs'
    columns through ``derive_challenges_device`` on the card (every row's 64
    bytes equal to the host core's ``challenge_batch``), and those bytes
    reduced mod l by ``sclimbs.reduce_wide`` on the card (equal to the plain
    version and to the host's scalars); counts set to 0 just before and read
    just after.  Then ``keccak_chain`` on the same rows' masks against its
    plain version (exact), and both kernels timed at these shapes beside
    their bounds and their chain floors (the first row alone, checked
    first).  Then, at each of ``ns`` rows, in turns: the whole call
    and its parts (host mask placement, upload, the kernel by CUDA events,
    download) against the host core's ``derive_challenges_batch``."""
    import numpy as np
    import torch

    from cpzk_tpu_torch.core import _native
    from cpzk_tpu_torch.core.transcript import derive_challenges_batch
    from cpzk_tpu_torch.ops import challenge, keccak, keccak_kernels as kk
    from cpzk_tpu_torch.ops import scalar_kernels as sk, sclimbs as sc
    from cpzk_tpu_torch.ops.point_kernels import all_launches, reset_all_launches

    statements, proofs, contexts = proofs_out
    n = len(proofs)
    dev = torch.device("cuda", 0) if on_card else torch.device("cpu")
    r1, r2 = commitment_columns(proofs)
    as_cols = lambda xs: np.frombuffer(b"".join(xs), dtype=np.uint8).reshape(len(xs), -1)  # noqa: E731
    gw, hw = params.generator_g.wire(), params.generator_h.wire()
    cols = (as_cols(contexts), as_cols([gw] * n), as_cols([hw] * n),
            as_cols([s[0] for s in statements]), as_cols([s[1] for s in statements]), r1, r2)
    host_lists = (contexts, [gw] * n, [hw] * n, [s[0] for s in statements],
                  [s[1] for s in statements], [bytes(x) for x in r1], [bytes(x) for x in r2])

    reset_all_launches()
    chal = challenge.derive_challenges_device(*cols, device=None if on_card else "cpu")
    wide = torch.from_numpy(sc.bytes_wide_to_limbs(chal)).to(dev)
    scalars = sc.reduce_wide(wide)
    synchronize()
    launches = all_launches()
    for name in CHALLENGE_KERNELS:
        if on_card and launches[name] < 1:
            raise AssertionError(f"{name} was never launched on the device_challenges path")
    def host_raw(lists) -> bytes:
        return _native.challenge_batch(lists[0], *(b"".join(c) for c in lists[1:]))

    if chal.tobytes() != host_raw(host_lists):
        raise AssertionError("device challenges differ from the host core's")
    if not torch.equal(scalars, sc.reduce_wide_plain(wide)):
        raise AssertionError("reduce_wide differs from its plain version")
    want = [c.value for c in derive_challenges_batch(*host_lists)]
    if sc.limbs_to_ints(scalars) != want:
        raise AssertionError("reduced challenges differ from the host's scalars")

    # both kernels at the main path's shapes (these rows' shared state and
    # masks; their wide values) against their plain versions on the same
    # tensors, and timed there (these launches are not counted above)
    (s_hi, s_lo), (m_hi, m_lo) = challenge.challenge_masks(*cols)
    tensors = [torch.from_numpy(a).to(dev) for a in (s_hi, s_lo, m_hi, m_lo)]
    got = kk.keccak_chain(*tensors)
    synchronize()
    ref = kk.keccak_chain_plain(*tensors)
    if not (torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])):
        raise AssertionError("keccak_chain differs from its plain version on the path's masks")
    k, shared = m_hi.shape[0], s_hi.shape[-1] == 1
    main_rows = {"keccak_chain": {"n": n, "k": k, "shared_state": shared, "max_abs_err": 0},
                 "reduce_wide": {"n": n, "rows": wide.shape[0], "max_abs_err": 0}}
    # each kernel's chain floor: the path's first row alone (one pair of
    # threads; one lane), checked first
    one_chain = tensors[:2] + [m[:, :, :1].contiguous() for m in tensors[2:]]
    one_wide = wide[:, :1].contiguous()
    got = kk.keccak_chain(*one_chain)
    synchronize()
    ref = kk.keccak_chain_plain(*one_chain)
    if not (torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])):
        raise AssertionError("keccak_chain differs from its plain version on one row")
    if not torch.equal(sc.reduce_wide(one_wide), sc.reduce_wide_plain(one_wide)):
        raise AssertionError("reduce_wide differs from its plain version on one lane")
    if on_card:
        main_rows["keccak_chain"].update(bound_of(*kk.keccak_chain_work(n, k, shared),
                                                  int32_ops_per_s))
        main_rows["keccak_chain"].update(kernel_ms(lambda: kk.keccak_chain(*tensors),
                                                   lambda: kk.keccak_chain_plain(*tensors), 20))
        main_rows["reduce_wide"].update(bound_of(*sk.reduce_wide_work(wide.shape[0], n),
                                                 int32_ops_per_s))
        main_rows["reduce_wide"].update(kernel_ms(lambda: sc.reduce_wide(wide),
                                                  lambda: sc.reduce_wide_plain(wide), 20))
        for name, call in (("keccak_chain", lambda: kk.keccak_chain(*one_chain)),
                           ("reduce_wide", lambda: sc.reduce_wide(one_wide))):
            floor = kernel_ms(call, None, 20)
            main_rows[name]["chain_floor_ms"] = floor["ms"]
            main_rows[name]["chain_floor_runs"] = floor["ms_runs"]
    out = {"rows": n, "tolerance": "exact (bytes, words, limbs)", "launches": launches,
           "masks": k, "kernels_at_path_shape": main_rows}

    timed = {}
    for m in ns:
        sub = tuple(c[:m] for c in cols)
        lists = tuple(x[:m] for x in host_lists)
        res = {k: [] for k in ("device_call_ms", "masks_ms", "upload_ms", "kernel_ms",
                               "download_ms", "host_batch_ms", "host_raw_ms")}
        for rep in range(reps + 1):  # the first turn warms both
            turn = {}
            synchronize()
            t0 = time.perf_counter()
            challenge.derive_challenges_device(*sub, device=None if on_card else "cpu")
            turn["device_call_ms"] = (time.perf_counter() - t0) * 1e3
            t0 = time.perf_counter()
            derive_challenges_batch(*lists)
            turn["host_batch_ms"] = (time.perf_counter() - t0) * 1e3
            t0 = time.perf_counter()
            host_raw(lists)
            turn["host_raw_ms"] = (time.perf_counter() - t0) * 1e3
            t0 = time.perf_counter()
            (s_hi, s_lo), (m_hi, m_lo) = challenge.challenge_masks(*sub)
            turn["masks_ms"] = (time.perf_counter() - t0) * 1e3
            t0 = time.perf_counter()
            tensors = [torch.from_numpy(a).to(dev) for a in (s_hi, s_lo, m_hi, m_lo)]
            synchronize()
            turn["upload_ms"] = (time.perf_counter() - t0) * 1e3
            if on_card:
                ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
                ev[0].record()
                state = kk.keccak_chain(*tensors)
                ev[1].record()
                ev[1].synchronize()
                turn["kernel_ms"] = ev[0].elapsed_time(ev[1])
            else:
                state = kk.keccak_chain(*tensors)
                turn["kernel_ms"] = 0.0
            t0 = time.perf_counter()
            keccak.state_to_lanes(state)
            turn["download_ms"] = (time.perf_counter() - t0) * 1e3
            if rep:
                for k2, v in turn.items():
                    res[k2].append(v)
        res["device_kchal_per_s"] = [m / v for v in res["device_call_ms"]]
        res["host_kchal_per_s"] = [m / v for v in res["host_batch_ms"]]
        timed[m] = res
    out["timed"] = timed
    out["host_threads"] = _native.default_threads()
    return out


# -- ristretto DECODE on the card, and the matmulfold multiply --------------

#: the decode phase's lane counts (its path decodes each once), the lanes
#: of the limbs.mul variants' comparison, and the timed reps
DECODE_NS = (16384, 4096)
MUL_VARIANT_N = 16384
DECODE_REPS = 20


def decode_wires(n: int, corpus, gen):
    """``[n, 32]`` uint8 wires (numpy) for the decode phase, and each row's
    kind: first the cases the reference's tests reject (``p + 2``, the odd
    3, 32 bytes of 0xff) beside ``p`` itself, ``p - 1``, a valid encoding
    with bit 255 set and the all-zero identity; then, in turns, the
    corpus's valid encodings (Y1, Y2, R1, R2 of each proof) and random 32
    bytes from ``gen``."""
    import numpy as np

    from cpzk_tpu_torch.core import edwards

    valid = [e.wire() for statement, proof, _ in corpus
             for e in (statement.y1, statement.y2, proof.commitment.r1, proof.commitment.r2)]
    high = bytearray(valid[0])
    high[31] |= 0x80
    special = [((edwards.P + 2).to_bytes(32, "little"), "p+2"),
               ((3).to_bytes(32, "little"), "odd"), (b"\xff" * 32, "all-ones"),
               (edwards.P.to_bytes(32, "little"), "p"),
               ((edwards.P - 1).to_bytes(32, "little"), "p-1"),
               (bytes(high), "bit-255"), (bytes(32), "identity")]
    rows, kinds = [], []
    for wire, kind in special[:n]:
        rows.append(wire)
        kinds.append(kind)
    for i in range(n - len(rows)):
        if i % 2:
            rows.append(gen.fill_bytes(32))
            kinds.append("random")
        else:
            rows.append(valid[(i // 2) % len(valid)])
            kinds.append("corpus")
    return np.frombuffer(b"".join(rows), dtype=np.uint8).reshape(n, 32).copy(), kinds


def host_decode_words(wires):
    """The host core's ``batch_decode`` of ``[n, 32]`` wires: ``[4, 8, n]``
    int32 words of the canonical coordinates and ``[n]`` uint8 validity."""
    import numpy as np
    import torch

    from cpzk_tpu_torch.core import _native

    coords, ok = _native.batch_decode(wires.tobytes())
    words = np.frombuffer(coords, dtype="<u4").reshape(-1, 4, 8).transpose(1, 2, 0)
    return (torch.from_numpy(words.astype(np.int64)).to(torch.int32),
            torch.frombuffer(bytearray(ok), dtype=torch.uint8))


def decode_phase(dev, corpus, ns, mul_n: int, reps: int, int32_ops_per_s: float,
                 gen, on_card: bool = True) -> dict:
    """The ``decode`` phase: ``ristretto_decode`` on the card at each of
    ``ns`` lanes (the phase's path, counts set to 0 just before and read
    just after), its words and validity equal (exact, the words canonical)
    to the plain ``curve.decode`` on the card and to the host core's
    ``batch_decode`` (the points of valid lanes; invalid lanes the identity)
    and every listed case decided as the reference decides it; the kernel
    timed beside its bound and its plain version.  Then ``limbs.mul`` under
    ``CPZK_MUL``'s two variants on the card at ``mul_n`` loose lanes
    (|limb| <= 9500, both signs), bit for bit equal, both timed.  With
    ``on_card`` false (a rehearsal on the CPU: ``dev`` is the CPU, the
    kernel's plain version runs) nothing is timed or counted."""
    import numpy as np
    import torch

    from cpzk_tpu_torch.core import edwards
    from cpzk_tpu_torch.ops import decode_kernels as dk, limbs
    from cpzk_tpu_torch.ops.point_kernels import all_launches, reset_all_launches

    inputs = {n: decode_wires(n, corpus, gen) for n in ns}
    on_dev = {n: torch.from_numpy(w).to(dev) for n, (w, _) in inputs.items()}
    if on_card:
        synchronize()
    reset_all_launches()
    got = {n: dk.ristretto_decode(on_dev[n], device=dev) for n in ns}
    if on_card:
        synchronize()
    launches = all_launches()
    if on_card and (launches["ristretto_decode"] != len(ns)
                    or sum(launches.values()) != len(ns)):
        raise AssertionError(f"decode: launches {launches}")
    identity = dk.limbs_to_words(tuple(
        torch.from_numpy(limbs.int_to_limbs(v)[:, None]) for v in (0, 1, 1, 0)))
    out = {"launches": {"ristretto_decode": launches["ristretto_decode"]},
           "tolerance": "exact (canonical words, validity bytes)", "results": []}
    for n in ns:
        wires, kinds = inputs[n]
        words, valid = (t.cpu() for t in got[n])
        plain_words, plain_valid = (t.cpu() for t in dk.ristretto_decode_plain(on_dev[n]))
        host_words, host_valid = host_decode_words(wires)
        ok = valid.bool()
        err = int((words.to(torch.int64) - plain_words.to(torch.int64)).abs().max())
        host_err = int((words[..., ok].to(torch.int64)
                        - host_words[..., ok].to(torch.int64)).abs().max())
        expect = {k: (k in ("corpus", "identity")) for k in set(kinds)}
        wrong = [i for i, k in enumerate(kinds)
                 if k != "random" and bool(ok[i]) != expect[k]]
        # each random row as the reference's pure decode decides it
        randoms = [i for i, k in enumerate(kinds) if k == "random"][:256]
        pure_wrong = [i for i in randoms
                      if (edwards.ristretto_decode(wires[i].tobytes()) is not None) != bool(ok[i])]
        if (err or host_err or not torch.equal(valid, plain_valid)
                or not torch.equal(valid, host_valid)
                or not torch.equal(words[..., ~ok], identity.expand(4, 8, int((~ok).sum())))
                or wrong or pure_wrong):
            raise AssertionError(f"decode at {n}: error {err}, host error {host_err}, "
                                 f"validity equal {torch.equal(valid, plain_valid)} / "
                                 f"{torch.equal(valid, host_valid)}, wrong cases "
                                 f"{[(i, kinds[i]) for i in wrong[:5]]}, pure {pure_wrong[:5]}")
        timed = kernel_ms(lambda n=n: dk.ristretto_decode(on_dev[n], device=dev),
                          lambda n=n: dk.ristretto_decode_plain(on_dev[n]),
                          reps) if on_card else {}
        out["results"].append({
            "n": n,
            "max_abs_err": err, "host_max_abs_err": host_err,
            "valid_lanes": int(ok.sum()), "random_valid": int(sum(
                bool(ok[i]) for i, k in enumerate(kinds) if k == "random")),
            "cases": {k: int(ok[kinds.index(k)]) for k in kinds[:7]},
            **timed, **bound_of(*dk.decode_work(n), int32_ops_per_s)})
    # the chain floor: one lane (the first wire, a rejected case), exact
    # against the plain version, timed by kernel_ms
    one = on_dev[ns[0]][:1].contiguous()
    words, valid = dk.ristretto_decode(one, device=dev)
    plain_words, plain_valid = dk.ristretto_decode_plain(one)
    if not (torch.equal(words.cpu(), plain_words.cpu())
            and torch.equal(valid.cpu(), plain_valid.cpu())):
        raise AssertionError("decode: one lane differs from the plain version")
    out["chain_floor"] = {"n": 1, "max_abs_err": 0,
                          **(kernel_ms(lambda: dk.ristretto_decode(one, device=dev), None, reps)
                             if on_card else {"ms": None})}

    rng = np.random.default_rng(SEED + 29)
    a, b = (torch.from_numpy(rng.integers(-limbs.BOUND, limbs.BOUND + 1, (20, mul_n),
                                          dtype=np.int32)).to(dev) for _ in range(2))
    a[:, 0], b[:, 0] = limbs.BOUND, -limbs.BOUND  # the loose extremes, both signs
    a[10:, 1], b[:10, 1] = -limbs.BOUND, -limbs.BOUND
    variant = limbs.MUL_VARIANT
    products, times = {}, {}
    try:
        for name in ("schoolbook", "matmulfold"):
            limbs.MUL_VARIANT = name
            products[name] = limbs.mul(a, b)
            if on_card:
                synchronize()
                times[name] = kernel_ms(lambda: limbs.mul(a, b), None, reps)["ms"]
    finally:
        limbs.MUL_VARIANT = variant
    if not torch.equal(products["schoolbook"], products["matmulfold"]):
        raise AssertionError("limbs.mul: matmulfold differs from schoolbook on the card")
    out["mul_variants"] = {"n": mul_n, "bit_equal": True, "ms": times,
                           "timed_by": "CUDA events around reps calls held behind a spin "
                                       "kernel (each call many launches)"}
    return out


def vectors_check(dev) -> dict:
    """The ``vectors`` check: the pinned vectors of ``tests/vectors`` on
    the card.  ``commitments`` (with ``comb_tables`` of G and H) gives
    k·G equal to the 8 ``scalarmult_base`` entries of libsodium's
    ``sodium_vectors.json``; ``derive_challenges_device`` then
    ``reduce_wide`` give the 4 protocol-layer challenges of
    ``transcript_vectors.json``; ``TorchBackend`` accepts the 4 accepted
    rows of ``proof_vectors.json`` and rejects ``vector-wrong-context``.
    Exact, every one."""
    import numpy as np
    import torch

    from cpzk_tpu_torch import BatchVerifier, Parameters, Proof, Ristretto255, Statement
    from cpzk_tpu_torch.ops import challenge, curve, prove_kernels as pvk, sclimbs as sc
    from cpzk_tpu_torch.ops.backend import TorchBackend
    from cpzk_tpu_torch.ops.prove import _windows_lsb

    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests", "vectors")

    def load(name: str) -> dict:
        with open(os.path.join(root, name), encoding="utf-8") as f:
            return json.load(f)

    params = Parameters.new()
    out = {"tolerance": "exact"}
    device = dev if dev.type == "cuda" else "cpu"

    sodium = load("sodium_vectors.json")["scalarmult_base"]
    tg, th = (pvk.comb_tables(curve.points_to_device([e.point], dev))
              for e in (params.generator_g, params.generator_h))
    ks = [int.from_bytes(bytes.fromhex(v["scalar_le_hex"]), "little") for v in sodium]
    digits = torch.from_numpy(_windows_lsb(ks)).to(dev)
    kg, _ = pvk.commitments(tg, th, digits)
    got = [bytes(col) for col in np.ascontiguousarray(kg.cpu().numpy().T)]
    want = [bytes.fromhex(v["point_hex"]) for v in sodium]
    if got != want:
        raise AssertionError(f"vectors: commitments k*G differ at "
                             f"{[i for i, (a, b) in enumerate(zip(got, want)) if a != b]}")
    out["scalarmult_base"] = len(want)

    g, h = params.generator_g.wire(), params.generator_h.wire()
    one = lambda b: np.frombuffer(b, dtype=np.uint8).reshape(1, -1)  # noqa: E731
    protocol = [v for v in load("transcript_vectors.json")["vectors"]
                if v["kind"] == "protocol"]
    for v in protocol:
        ctx = None if v["context"] is None else one(bytes.fromhex(v["context"]))
        wide_bytes = challenge.derive_challenges_device(
            ctx, one(g), one(h), one(g), one(h), one(h), one(g), device=device)
        scalar = sc.reduce_wide(torch.from_numpy(sc.bytes_wide_to_limbs(wide_bytes)).to(dev))
        if "%064x" % sc.limbs_to_ints(scalar)[0] != v["challenge_scalar"]:
            raise AssertionError(f"vectors: device challenge {v['name']} differs")
    out["protocol_challenges"] = [v["name"] for v in protocol]

    proofs = load("proof_vectors.json")["vectors"]
    bv = BatchVerifier(backend=TorchBackend(device=dev), max_size=len(proofs))
    for v in proofs:
        statement = Statement(Ristretto255.element_from_bytes(bytes.fromhex(v["y1"])),
                              Ristretto255.element_from_bytes(bytes.fromhex(v["y2"])))
        proof = Proof.from_bytes(bytes.fromhex(v["proof"]))
        if v["context"]:
            bv.add_with_context(params, statement, proof, bytes.fromhex(v["context"]))
        else:
            bv.add(params, statement, proof)
    verdicts = [r is None for r in bv.verify(SeededRng(SEED + 11))]
    if verdicts != [bool(v["accept"]) for v in proofs]:
        raise AssertionError(f"vectors: TorchBackend verdicts {verdicts}")
    out["proof_vectors"] = {v["name"]: ok for v, ok in zip(proofs, verdicts)}
    if out["proof_vectors"].get("vector-wrong-context") is not False:
        raise AssertionError("vectors: vector-wrong-context was not rejected")
    return out


async def audit_client_logins(port: int, user_ids, corpus, provers, rpc_max: int, gen,
                              unary: int) -> dict:
    """The audit phase's logins through the port's ``AuthClient``:
    ``RegisterBatch``, one challenge per user, the logins in concurrent
    ``VerifyProofBatch`` RPCs of ``rpc_max`` entries (about 1% tampered and
    2 undecodable, ``tamper_logins``), then ``unary`` ``VerifyProof``
    logins of the first users, the last one with a wrong s.  Sheds of the
    retry-safe RPCs are retried after their pushback by the client's
    policy.  Every verdict must equal its expectation."""
    import grpc

    from cpzk_tpu_torch import Transcript
    from cpzk_tpu_torch.client import AuthClient
    from cpzk_tpu_torch.core.scalars import L
    from cpzk_tpu_torch.resilience.retry import RetryBudget, RetryPolicy

    n, m = len(user_ids), len(corpus)
    bounds = [(lo, min(lo + rpc_max, n)) for lo in range(0, n, rpc_max)]
    policy = RetryPolicy(max_attempts=PUSHBACK_TRIES, budget=RetryBudget(tokens=1e9))
    out = {}
    async with AuthClient(f"127.0.0.1:{port}", retry=policy) as client:
        regs = await asyncio.gather(*[client.register_batch(
            user_ids[lo:hi], [corpus[i % m][0].y1.wire() for i in range(lo, hi)],
            [corpus[i % m][0].y2.wire() for i in range(lo, hi)]) for lo, hi in bounds])
        bad = [r.message for resp in regs for r in resp.results if not r.success]
        if bad:
            raise AssertionError(f"audit: registration failed: {bad[:3]}")
        cids = [bytes(r.challenge_id) for r in await asyncio.gather(
            *[client.create_challenge(uid) for uid in user_ids])]
        wires = []
        for i, cid in enumerate(cids):
            t = Transcript()
            t.append_context(cid)
            wires.append(provers[i % m].prove_with_transcript(gen, t).to_bytes())
        expected = tamper_logins(wires, cids, provers, m, gen)
        t0 = time.perf_counter()
        resps = await asyncio.gather(*[client.verify_proof_batch(
            user_ids[lo:hi], cids[lo:hi], wires[lo:hi]) for lo, hi in bounds])
        out["batch_logins_s"] = time.perf_counter() - t0
        got = ["ok" if r.success else r.message for resp in resps for r in resp.results]
        wrong = [i for i, (a, b) in enumerate(zip(got, expected)) if a != b]
        if len(got) != n or wrong:
            raise AssertionError(f"audit: {len(got)} batch verdicts, wrong at {wrong[:5]}")
        unary_got = []
        for k in range(unary):
            cid = bytes((await client.create_challenge(user_ids[k])).challenge_id)
            t = Transcript()
            t.append_context(cid)
            wire = provers[k % m].prove_with_transcript(gen, t).to_bytes()
            if k == unary - 1:
                sc = int.from_bytes(wire[77:], "little") + 1
                wire = wire[:77] + ((sc % L) or 1).to_bytes(32, "little")
            try:
                unary_got.append((await client.verify_proof(user_ids[k], cid, wire)).success)
            except grpc.aio.AioRpcError as err:
                if err.code() != grpc.StatusCode.PERMISSION_DENIED:
                    raise
                unary_got.append(False)
        if unary_got != [True] * (unary - 1) + [False]:
            raise AssertionError(f"audit: unary verdicts {unary_got}")
    out.update(batch_verdicts=n, unary_verdicts=unary, valid=expected.count("ok"),
               tampered=expected.count("Authentication failed"),
               undecodable=expected.count(BAD_POINT),
               planted=n - expected.count("ok") + 1)
    return out


def audit_phase(corpus, provers, n: int, rpc_max: int, stream_users: int = AUDIT_STREAM_USERS,
                stream_proofs: int = AUDIT_STREAM_PROOFS, unary: int = AUDIT_UNARY,
                segment_bytes: int = AUDIT_SEGMENT_BYTES, synth_n: int = AUDIT_SYNTH_N,
                quantum: int = AUDIT_QUANTUM, launcher: list | None = None,
                on_card: bool = True) -> dict:
    """The ``audit`` phase: the proof-log audit trail from the daemon to a
    signed replay on the card.

    The port's daemon (``python -m cpzk_tpu_torch.server`` on cuda:0, or
    ``launcher``) boots with ``SERVER_AUDIT_ENABLED=1``, its proof log in a
    scratch directory sealing a segment every ``segment_bytes``.  Only the
    port's client drives it: ``python -m cpzk_tpu_torch.client stream``
    (``stream_users`` ephemeral users, ``stream_proofs`` proofs; its JSON
    line must show 0 rejected), ``AuthClient.verify_proof_batch`` over
    ``n`` logins (about 1% tampered) and ``unary`` ``verify_proof`` calls:
    the three verify paths.  SIGTERM must log "audit trail closed at seq N"
    with N the verdicts the clients received.  The trail directory (sealed
    segments and the active tail) replays in process through
    ``run_audit(..., backend="tpu")``: N records, none mismatched, the
    planted tampers rejected, both served ladder kernels launched (counts
    set to 0 just before, read just after), records/s and the card's interval and
    idle share from a flight-recorder device sink.

    Then a synthetic log of ``synth_n`` records (``python -m
    cpzk_tpu_torch.audit generate``, 1% rejects, 0.5% lying verdicts) is
    replayed four times at ``quantum``: A on the card in process (the
    liars mismatched, the rejects rejected); B by ``python -m
    cpzk_tpu_torch.audit run`` on the card, SIGKILLed once its cursor file
    exists and run again from that cursor (offset above 0), its report
    byte-identical to A's; C with ``--backend cpu`` in process, equal to A
    in totals and digest (``engine.backend`` differs); D on the card with
    ``CPZK_PIPPENGER_MIN=2 CPZK_DEVICE_RLC=1`` in the subprocess's
    environment, byte-identical to A.  ``verify-report`` must answer 0 on
    every report and 1 on A with one byte flipped.  ``on_card=False`` (a
    rehearsal on the CPU with a ``launcher`` giving ``amain``
    ``device="cpu"``) runs A on the plain versions, and B and D with
    ``--backend cpu``, held against C."""
    import io
    from contextlib import redirect_stdout

    from cpzk_tpu_torch.audit import run_audit
    from cpzk_tpu_torch.audit.__main__ import main as audit_main
    from cpzk_tpu_torch.observability import flightrec
    from cpzk_tpu_torch.ops.point_kernels import all_launches, reset_all_launches
    from cpzk_tpu_torch.server.__main__ import DRAIN_SECONDS

    t_phase = time.perf_counter()
    root = os.path.dirname(os.path.abspath(__file__))
    workdir = tempfile.mkdtemp(prefix="cpzk-audit-")
    trail = os.path.join(workdir, "trail")
    os.makedirs(trail)
    config = os.path.join(workdir, "server.toml")
    with open(config, "w") as f:
        f.write(f'[tpu]\nbackend = "tpu"\nbatch_max = {n}\nprewarm_quanta = "{n}"\n'
                "[rate_limit]\nrequests_per_minute = 100000000\nburst = 1000000\n"
                "[opsplane]\nenabled = true\nport = 0\n")
    env = {k: v for k, v in os.environ.items() if not k.startswith("SERVER_")}
    env["PYTHONPATH"] = root + os.pathsep + env.get("PYTHONPATH", "")
    daemon_env = dict(env, SERVER_CONFIG_PATH=config, SERVER_AUDIT_ENABLED="1",
                      SERVER_AUDIT_LOG_PATH=os.path.join(trail, "proofs.log"),
                      SERVER_AUDIT_SEGMENT_BYTES=str(segment_bytes))
    # the client's retry policy from [retry]: sheds of CreateChallenge after
    # a verify wave are retried after their pushback, as the other phases'
    # client does
    client_env = dict(env, SERVER_RETRY_MAX_ATTEMPTS=str(PUSHBACK_TRIES),
                      SERVER_RETRY_BUDGET="1000000000")
    argv = (launcher or [sys.executable, "-m", "cpzk_tpu_torch.server"]) + ["--no-repl",
                                                                          "--port", "0"]
    device = None if on_card else "cpu"
    cli_backend = [] if on_card else ["--backend", "cpu"]
    user_ids = [f"audit-{i:05d}" for i in range(n)]
    gen = SeededRng(SEED + 13)
    out = {"n": n, "stream_proofs": stream_proofs, "unary": unary, "quantum": quantum,
           "segment_bytes": segment_bytes, "tolerance": "exact"}
    daemon = None

    def audit_cli(*args, extra_env=None, **kw):
        return subprocess.run([sys.executable, "-m", "cpzk_tpu_torch.audit", *args],
                              cwd=workdir, env=dict(env, **(extra_env or {})),
                              capture_output=True, text=True, **kw)

    def replay(log: str, name: str, backend: str = "tpu") -> tuple[dict, dict]:
        """One in-process replay with the kernel counts set to 0 just
        before and read just after, and the card's interval in it."""
        report_path = os.path.join(workdir, f"{name}.json")
        sink, token = flightrec.install_sink()
        reset_all_launches()
        t0 = time.perf_counter()
        try:
            report = run_audit(log, report_path, key_path=key, quantum=quantum,
                               backend=backend, device=device if backend == "tpu" else None)
            if on_card:
                synchronize()
        finally:
            flightrec.uninstall_sink(token)
        wall = time.perf_counter() - t0
        launches = {k: all_launches()[k] for k in LADDER_KERNELS}
        row = {"records": report["totals"]["records"], "seconds": wall,
               "records_per_s": report["totals"]["records"] / wall,
               "launches": launches, "totals": report["totals"], "digest": report["digest"]}
        if backend == "tpu":
            row.update(device_interval_s=sink.device_interval_s,
                       device_idle_share=1 - sink.device_interval_s / wall)
            if on_card and any(launches[k] < 1 for k in SERVED_KERNELS):
                raise AssertionError(f"audit {name}: ladder kernels not launched: {launches}")
        return report, row

    key = os.path.join(workdir, "audit.key")
    try:
        # 1. the daemon with [audit], driven by the port's client only
        daemon = DaemonProcess("audit", argv, workdir, daemon_env)
        daemon.wait_listening(DAEMON_BOOT_TIMEOUT_S)
        out["boot_s"] = daemon.boot_s
        addr = f"127.0.0.1:{daemon.port}"
        t0 = time.perf_counter()
        stream = subprocess.run(
            [sys.executable, "-m", "cpzk_tpu_torch.client", "-s", addr, "stream",
             "--users", str(stream_users), "--proofs", str(stream_proofs)],
            cwd=workdir, env=client_env, capture_output=True, text=True, timeout=900)
        if stream.returncode != 0:
            raise AssertionError(f"audit: client stream exited {stream.returncode}:\n"
                                 f"{stream.stdout[-2000:]}{stream.stderr[-2000:]}")
        streamed = json.loads(stream.stdout.strip().splitlines()[-1])
        streamed["wall_s"] = time.perf_counter() - t0
        if streamed["rejected"] != 0 or streamed["verified"] + streamed["shed"] != stream_proofs:
            raise AssertionError(f"audit: client stream {streamed}")
        out["stream"] = streamed
        out["logins"] = asyncio.run(audit_client_logins(daemon.port, user_ids, corpus, provers,
                                                        rpc_max, gen, unary))
        received = streamed["verified"] + streamed["rejected"] + n + unary
        rc, out["shutdown_s"] = daemon.terminate(DRAIN_SECONDS + 30)
        m = re.search(r"audit trail closed at seq (\d+)", daemon.text())
        if rc != 0 or not m or int(m.group(1)) != received:
            raise AssertionError(f"audit: daemon exit {rc}, closing seq "
                                 f"{m and m.group(1)}, verdicts received {received}:\n"
                                 f"{daemon.text()[-3000:]}")
        files = sorted(os.listdir(trail))
        segments = [f for f in files if f.endswith(".seg")]
        out["trail"] = {"records": received, "files": files, "segments": len(segments),
                        "bytes": sum(os.path.getsize(os.path.join(trail, f)) for f in files)}
        if len(segments) < 2:
            raise AssertionError(f"audit: the trail sealed {len(segments)} segments: {files}")

        # 2. the trail replayed on the card
        report, row = replay(trail, "trail")
        planted = out["logins"]["planted"]
        t = report["totals"]
        if (t["records"] != received or t["mismatched"] != 0 or t["rejected"] != planted
                or t["skipped"] != 0):
            raise AssertionError(f"audit trail replay: totals {t}, {received} received, "
                                 f"{planted} planted tampers")
        out["trail_replay"] = row

        # 3. the synthetic log, four replays
        synth = os.path.join(workdir, "synth.log")
        done = audit_cli("generate", "--n", str(synth_n), "--users", str(AUDIT_SYNTH_USERS),
                         "--reject-frac", str(AUDIT_REJECT_FRAC), "--mismatch-frac",
                         str(AUDIT_MISMATCH_FRAC), "--out", synth, timeout=600)
        if done.returncode != 0:
            raise AssertionError(f"audit generate exited {done.returncode}: {done.stderr}")
        out["generate"] = json.loads(done.stdout.strip().splitlines()[-1])
        liars, rejects = out["generate"]["mismatches"], out["generate"]["rejects"]

        a_report, out["A"] = replay(synth, "A")
        if (a_report["totals"]["mismatched"] != liars
                or a_report["totals"]["rejected"] != rejects
                or a_report["totals"]["records"] != synth_n):
            raise AssertionError(f"audit A: totals {a_report['totals']}, planted {liars} "
                                 f"liars and {rejects} rejects")
        c_report, out["C"] = replay(synth, "C", backend="cpu")
        if (c_report["totals"], c_report["digest"]) != (a_report["totals"],
                                                        a_report["digest"]):
            raise AssertionError("audit C: totals or digest differ from A's")
        # B and D are held against the in-process report of their backend
        same = os.path.join(workdir, "A.json" if on_card else "C.json")
        with open(same, "rb") as f:
            same_bytes = f.read()

        b_path = os.path.join(workdir, "B.json")
        run_argv = ["run", "--log", synth, "--report", b_path, "--key", key, "--quantum",
                    str(quantum), "--quiet", *cli_backend]
        proc = subprocess.Popen([sys.executable, "-m", "cpzk_tpu_torch.audit", *run_argv],
                                cwd=workdir, env=env, stdout=subprocess.DEVNULL,
                                stderr=subprocess.PIPE, text=True, start_new_session=True)
        cursor = b_path + ".cursor"
        deadline = time.perf_counter() + 600
        while not os.path.exists(cursor):
            if proc.poll() is not None or time.perf_counter() > deadline:
                proc.kill()
                raise AssertionError(f"audit B: no cursor before exit {proc.poll()}: "
                                     f"{proc.stderr.read()[-2000:]}")
            time.sleep(0.002)
        os.killpg(proc.pid, signal.SIGKILL)
        proc.wait(timeout=60)
        proc.stderr.close()
        if os.path.exists(b_path):
            raise AssertionError("audit B: the run finished before it was killed")
        with open(cursor) as f:
            resumed_from = json.load(f)
        if resumed_from["offset"] <= 0:
            raise AssertionError(f"audit B: cursor at offset {resumed_from['offset']}")
        t0 = time.perf_counter()
        done = audit_cli(*run_argv, timeout=900)
        out["B"] = {"killed_exit": proc.returncode, "cursor_offset": resumed_from["offset"],
                    "cursor_records": resumed_from["records"], "exit": done.returncode,
                    "resumed_s": time.perf_counter() - t0}
        with open(b_path, "rb") as f:
            b_bytes = f.read()
        if done.returncode != 3 or b_bytes != same_bytes:
            raise AssertionError(f"audit B: exit {done.returncode}, bytes equal "
                                 f"{b_bytes == same_bytes}: {done.stderr[-2000:]}")

        d_path = os.path.join(workdir, "D.json")
        t0 = time.perf_counter()
        done = audit_cli("run", "--log", synth, "--report", d_path, "--key", key,
                         "--quantum", str(quantum), "--quiet", *cli_backend,
                         extra_env={"CPZK_PIPPENGER_MIN": "2", "CPZK_DEVICE_RLC": "1"},
                         timeout=900)
        out["D"] = {"exit": done.returncode, "seconds": time.perf_counter() - t0}
        with open(d_path, "rb") as f:
            d_bytes = f.read()
        if done.returncode != 3 or d_bytes != same_bytes:
            raise AssertionError(f"audit D: exit {done.returncode}, bytes equal "
                                 f"{d_bytes == same_bytes}: {done.stderr[-2000:]}")

        # 4. every report checks offline; a flipped byte does not
        def verify_report(path: str) -> int:
            with redirect_stdout(io.StringIO()):
                return audit_main(["verify-report", "--report", path])

        flipped = os.path.join(workdir, "A-flipped.json")
        with open(os.path.join(workdir, "A.json"), "rb") as f:
            blob = bytearray(f.read())
        pos = blob.find(b'"digest"') + 12
        blob[pos] ^= 0x01
        with open(flipped, "wb") as f:
            f.write(bytes(blob))
        codes = {name: verify_report(os.path.join(workdir, f"{name}.json"))
                 for name in ("trail", "A", "B", "C", "D")}
        codes["A-flipped"] = verify_report(flipped)
        if codes != {"trail": 0, "A": 0, "B": 0, "C": 0, "D": 0, "A-flipped": 1}:
            raise AssertionError(f"audit verify-report: {codes}")
        out["verify_report"] = codes
        out["engine"] = {"A": a_report["engine"], "C": c_report["engine"]}
        out["phase_s"] = time.perf_counter() - t_phase
    finally:
        if daemon is not None:
            daemon.kill()
            daemon.save_log()
        shutil.rmtree(workdir, ignore_errors=True)
    return out


def card_memory_mib() -> float:
    """The memory in use on the card, all processes (``nvidia-smi
    --query-gpu=memory.used``; its per-app rows name no process in a PID
    namespace it cannot map)."""
    return float(nvidia_smi("memory.used").split()[0])


def daemon_card_memory(ops_port: int) -> float:
    """The card memory a daemon's PyTorch allocator holds, from its
    ``/metrics`` (``tpu.device.memory_reserved_bytes``), in MiB."""
    text = http_get(ops_port, "/metrics")
    return scraped(text, "tpu_device_memory_reserved_bytes") / (1 << 20)


def fleet_client(pmap, **kw):
    """The port's ``AuthClient`` routing by ``pmap``, retrying sheds of the
    retry-safe RPCs after their pushback."""
    from cpzk_tpu_torch.client import AuthClient
    from cpzk_tpu_torch.resilience.retry import RetryBudget, RetryPolicy

    policy = RetryPolicy(max_attempts=PUSHBACK_TRIES, budget=RetryBudget(tokens=1e9))
    return AuthClient(partition_map=pmap, retry=policy, **kw)


async def fleet_register(pmap, user_ids, index: dict, corpus, rpc_max: int) -> dict:
    """``RegisterBatch`` of ``user_ids`` through the port's ``AuthClient``
    holding the partition map (it splits each call by partition), in calls
    of ``rpc_max`` entries, ``REPL_REGISTER_IN_FLIGHT`` at a time; user
    ``u`` registers corpus statement ``index[u]``.  Every entry must be
    acknowledged."""
    n, m = len(user_ids), len(corpus)
    bounds = [(lo, min(lo + rpc_max, n)) for lo in range(0, n, rpc_max)]
    window = asyncio.Semaphore(REPL_REGISTER_IN_FLIGHT)
    async with fleet_client(pmap) as client:
        async def call(lo: int, hi: int):
            async with window:
                uids = user_ids[lo:hi]
                return await client.register_batch(
                    uids, [corpus[index[u] % m][0].y1.wire() for u in uids],
                    [corpus[index[u] % m][0].y2.wire() for u in uids])

        t0 = time.perf_counter()
        resps = await asyncio.gather(*[call(lo, hi) for lo, hi in bounds])
        wall = time.perf_counter() - t0
        redirects = client.redirects
    bad = [r.message for resp in resps for r in resp.results if not r.success]
    if bad or sum(len(resp.results) for resp in resps) != n:
        raise AssertionError(f"replication: {len(bad)} registrations failed: {bad[:3]}")
    return {"users": n, "calls": len(bounds), "in_flight": REPL_REGISTER_IN_FLIGHT,
            "register_s": wall,
            "registrations_per_s": n / wall, "redirects": redirects}


async def fleet_logins(pmap, user_ids, index: dict, provers, rpc_max: int, gen,
                       **client_kw) -> dict:
    """One login wave through the port's ``AuthClient`` holding the map
    (``client_kw`` goes to the client, a ``map_refresh`` for instance):
    one ``CreateChallenge`` per user, proofs by prover ``index[u]``, about
    1% tampered and 2 undecodable (``tamper_logins``), then the logins in
    concurrent ``VerifyProofBatch`` calls of ``rpc_max`` entries, which the
    client splits by partition.  Every verdict must equal its expectation,
    with one session per valid entry."""
    from cpzk_tpu_torch import Transcript

    n, m = len(user_ids), len(provers)
    bounds = [(lo, min(lo + rpc_max, n)) for lo in range(0, n, rpc_max)]
    async with fleet_client(pmap, **client_kw) as client:
        t0 = time.perf_counter()
        cids = [bytes(r.challenge_id) for r in await asyncio.gather(
            *[client.create_challenge(uid) for uid in user_ids])]
        challenge_s = time.perf_counter() - t0
        wires = []
        for uid, cid in zip(user_ids, cids):
            t = Transcript()
            t.append_context(cid)
            wires.append(provers[index[uid] % m].prove_with_transcript(gen, t).to_bytes())
        expected = tamper_logins(wires, cids, provers, m, gen)
        t0 = time.perf_counter()
        resps = await asyncio.gather(*[client.verify_proof_batch(
            user_ids[lo:hi], cids[lo:hi], wires[lo:hi]) for lo, hi in bounds])
        wall = time.perf_counter() - t0
        redirects = client.redirects
    results = [r for resp in resps for r in resp.results]
    got = ["ok" if r.success else r.message for r in results]
    wrong = [i for i, (g, e) in enumerate(zip(got, expected)) if g != e]
    if len(results) != n or wrong:
        raise AssertionError(f"replication: {len(results)} verdicts, wrong at {wrong[:5]}: "
                             f"{[(got[i], expected[i]) for i in wrong[:5]]}")
    if any(r.success != bool(r.session_token) for r in results):
        raise AssertionError("replication: not one session per valid entry")
    return {"entries": n, "rpc_calls": len(bounds), "challenge_s": challenge_s,
            "challenges_per_s": n / challenge_s, "login_wall_s": wall,
            "logins_per_s": n / wall, "valid": expected.count("ok"),
            "sessions": sum(bool(r.session_token) for r in results),
            "tampered": expected.count("Authentication failed"),
            "undecodable": expected.count(BAD_POINT), "redirects": redirects}


async def stale_map_login(pmap, stale_address: str, uid: str, prover, gen) -> dict:
    """A login of ``uid`` by a client holding a one-partition map (every
    user at ``stale_address``) that refreshes to ``pmap`` on a redirect."""
    from cpzk_tpu_torch import Transcript
    from cpzk_tpu_torch.fleet import PartitionMap

    stale = PartitionMap.uniform([stale_address])
    async with fleet_client(stale, map_refresh=lambda: pmap) as client:
        cid = bytes((await client.create_challenge(uid)).challenge_id)
        t = Transcript()
        t.append_context(cid)
        resp = await client.verify_proof(uid, cid, prover.prove_with_transcript(gen, t).to_bytes())
        return {"success": resp.success and bool(resp.session_token),
                "redirects": client.redirects, "map_version": client.partition_map.version}


async def standby_refusal(port: int) -> tuple[str, str]:
    """What a ``CreateChallenge`` at ``port`` is answered: (code, details)."""
    import grpc

    from cpzk_tpu_torch.client import AuthClient

    async with AuthClient(f"127.0.0.1:{port}") as client:
        try:
            await client.create_challenge("anyone")
        except grpc.aio.AioRpcError as err:
            return err.code().name, err.details()
    return "OK", ""


async def until_promoted(port: int, call, t0: float, timeout: float):
    """(seconds from ``t0``, answer) of the first ``call(channel)`` at
    ``port`` that is not refused UNAVAILABLE, the answer of a standby not
    yet promoted (its state untouched); it is asked again every 5 ms."""
    import grpc

    async with grpc.aio.insecure_channel(f"127.0.0.1:{port}") as ch:
        while time.perf_counter() - t0 < timeout:
            try:
                resp = await call(ch)
                return time.perf_counter() - t0, resp
            except grpc.aio.AioRpcError as err:
                if err.code() != grpc.StatusCode.UNAVAILABLE:
                    raise
            await asyncio.sleep(0.005)
    raise AssertionError(f"replication: :{port} still unavailable after {timeout} s")


def create_challenge_call(uid: str):
    """A ``CreateChallenge`` of ``uid`` for :func:`until_promoted`."""
    from cpzk_tpu_torch._gen import auth_pb2 as pb

    return lambda ch: unary_stub(ch, "CreateChallenge", pb.ChallengeRequest,
                                 pb.ChallengeResponse)(pb.ChallengeRequest(user_id=uid))


def verify_proof_call(uid: str, cid: bytes, prover, gen):
    """A ``VerifyProof`` of a valid proof over the challenge ``cid`` for
    :func:`until_promoted`."""
    from cpzk_tpu_torch import Transcript
    from cpzk_tpu_torch._gen import auth_pb2 as pb

    t = Transcript()
    t.append_context(cid)
    request = pb.VerificationRequest(user_id=uid, challenge_id=cid,
                                     proof=prover.prove_with_transcript(gen, t).to_bytes())
    return lambda ch: unary_stub(ch, "VerifyProof", pb.VerificationRequest,
                                 pb.VerificationResponse)(request)


PROMOTED_AUDIT_LINE = re.compile(r"PROMOTED to primary .*audit_seq=(\d+)")
HANDOVER_LINE = re.compile(r"handover complete: standby promoted at epoch (\d+) in (\d+)ms")


def replication_phase(corpus, provers, users: int, n: int, rpc_max: int, further: int,
                      kill_after: int, lease_ms: float = REPL_LEASE_MS,
                      renew_ms: float = REPL_RENEW_MS,
                      audit_segment_bytes: int = REPL_AUDIT_SEGMENT_BYTES,
                      sync_timeout_ms: float | None = None,
                      launcher: list | None = None, on_card: bool = True) -> dict:
    """The ``replication`` phase: a two-partition fleet of four port
    daemons on the card, failing over and handing over.

    Each daemon is ``python -m cpzk_tpu_torch.server`` (or ``launcher``) on
    a TOML of its own: ``[tpu] backend = "tpu"`` with ``batch_max`` and
    ``prewarm_quanta`` ``n``, ``[durability]`` with ``fsync = "always"``,
    ``[replication] mode = "sync"`` with ``lease_ms`` and
    ``renew_interval_ms``, ``[audit]`` (each proof log sealing a segment
    every ``audit_segment_bytes``; a standby stores the ones its primary
    ships) and ``[fleet]`` on a map from ``python -m cpzk_tpu_torch.fleet
    init`` and ``set-standby``: partition 0 is the pair A→B, partition 1
    C→D.  Steps:

    1. the port's ``AuthClient`` with the map registers ``users`` users
       (``RegisterBatch``) and logs ``n`` in (``VerifyProofBatch``, about
       1% tampered): every verdict exact; a client holding a one-partition
       map converges in one redirect; B and D refuse auth RPCs; each
       standby's ``applied_seq`` equals its primary's WAL seq;
    2. SIGTERM to A (``handover_on_term``): B promoted at epoch 2, A exits
       0, every user and session A acknowledged at B; A's sealed proof-log
       segments at B byte for byte;
    3. ``further`` ``CreateChallenge`` calls at C, SIGKILLed once
       ``kill_after`` are acknowledged: D promotes after the lease and
       every acknowledged challenge logs in at D;
    4. B and D answer an ``n``-login wave each (exact verdicts), their
       ``/metrics`` showing both served ladder kernels launched by those
       logins and no failover; each of the four daemons held a CUDA
       context;
    5. each promoted standby's proof-log directory replays on the card
       (``run_audit``) as one whole log from seq 1: its primary's shipped
       segments, then every verdict it served itself, none mismatched.

    ``launcher`` and ``on_card`` are the daemon phase's; ``sync_timeout_ms``
    replaces the reference default (a rehearsal on shared CPU cores)."""
    from cpzk_tpu_torch.audit import run_audit
    from cpzk_tpu_torch.fleet import PartitionMap
    from cpzk_tpu_torch.server.__main__ import DRAIN_SECONDS

    t_phase = time.perf_counter()
    root = os.path.dirname(os.path.abspath(__file__))
    workdir = tempfile.mkdtemp(prefix="cpzk-repl-")
    names = ("a", "b", "c", "d")
    ports = {k: free_port() for k in names}
    addr = {k: f"127.0.0.1:{ports[k]}" for k in names}
    dirs = {k: os.path.join(workdir, k) for k in names}
    for d in dirs.values():
        os.makedirs(d)
    map_path = os.path.join(workdir, "map.json")
    env = {k: v for k, v in os.environ.items() if not k.startswith("SERVER_")}
    env["PYTHONPATH"] = root + os.pathsep + env.get("PYTHONPATH", "")
    argv = (launcher or [sys.executable, "-m", "cpzk_tpu_torch.server"]) + ["--no-repl"]
    gen = SeededRng(SEED + 17)
    out = {"users": users, "n": n, "rpc_entries": rpc_max, "further": further,
           "kill_after": kill_after, "lease_ms": lease_ms, "renew_interval_ms": renew_ms,
           "audit_segment_bytes": audit_segment_bytes, "tolerance": "exact"}
    procs: dict = {}
    sheds: dict = {}

    def fleet_cli(*args) -> str:
        done = subprocess.run([sys.executable, "-m", "cpzk_tpu_torch.fleet", *args],
                              cwd=workdir, env=env, capture_output=True, text=True, timeout=120)
        if done.returncode != 0:
            raise AssertionError(f"fleet {args[0]} exited {done.returncode}: {done.stderr}")
        return done.stdout

    def config(name: str, role: str, peer: str, partition: int) -> str:
        d = dirs[name]
        audit = (f'[audit]\nenabled = true\nlog_path = "{d}/proofs.log"\n'
                 f"segment_bytes = {audit_segment_bytes}\n")
        path = os.path.join(d, "server.toml")
        with open(path, "w") as f:
            f.write(f'state_file = "{d}/state.json"\n[server]\nmax_users = {users}\n'
                    f'[tpu]\nbackend = "tpu"\nbatch_max = {n}\nprewarm_quanta = "{n}"\n'
                    "[rate_limit]\nrequests_per_minute = 100000000\nburst = 1000000\n"
                    "[opsplane]\nenabled = true\nport = 0\n"
                    '[durability]\nenabled = true\nfsync = "always"\n'
                    f'[replication]\nenabled = true\nrole = "{role}"\npeer = "{peer}"\n'
                    f'mode = "sync"\nlease_ms = {lease_ms}\nrenew_interval_ms = {renew_ms}\n'
                    + (f"sync_timeout_ms = {sync_timeout_ms}\n" if sync_timeout_ms else "")
                    + audit
                    + f'[fleet]\nenabled = true\nmap_path = "{map_path}"\n'
                      f"partition = {partition}\n")
        return path

    def statusz(name: str) -> dict:
        return json.loads(http_get(procs[name].ops_port, "/statusz"))

    def wait_until(what: str, check, timeout: float = 30.0) -> float:
        t0 = time.perf_counter()
        while not check():
            if time.perf_counter() - t0 > timeout:
                raise AssertionError(f"replication: {what} not reached in {timeout} s")
            time.sleep(0.02)
        return time.perf_counter() - t0

    try:
        # the map: partition 0 is A (standby B), partition 1 is C (standby D)
        fleet_cli("init", "--addresses", f"{addr['a']},{addr['c']}", "--out", map_path)
        fleet_cli("set-standby", "--map", map_path, "--partition", "0", "--standby", addr["b"])
        fleet_cli("set-standby", "--map", map_path, "--partition", "1", "--standby", addr["d"])
        pmap = PartitionMap.load(map_path)
        out["map"] = {"version": pmap.version, "digest": pmap.short_digest()}
        roles = {"a": ("primary", addr["b"], 0), "b": ("standby", "", 0),
                 "c": ("primary", addr["d"], 1), "d": ("standby", "", 1)}
        apps_before = card_apps() if on_card else []
        memory_before = card_memory_mib() if on_card else None
        for name in ("b", "d", "a", "c"):
            role, peer, partition = roles[name]
            procs[name] = DaemonProcess(
                f"repl_{name}", argv + ["--port", str(ports[name])], dirs[name],
                dict(env, SERVER_CONFIG_PATH=config(name, role, peer, partition)))
        for proc in procs.values():
            proc.wait_listening(DAEMON_BOOT_TIMEOUT_S)
        out["boot_s"] = {k: procs[k].boot_s for k in names}
        # each primary's shipper has reached its standby (the lease is armed
        # at the first contact) before the first acknowledged write
        out["pairs_connected_s"] = {k: wait_until(
            f"{k}'s first contact", lambda k=k: statusz(k)["replication"]["lease_remaining_s"]
            is not None) for k in ("b", "d")}
        if on_card:
            # each daemon holds a CUDA context of its own on the one card
            holding = {k: maps_libcuda(procs[k].proc.pid) for k in names}
            apps = card_apps()
            out["cuda_contexts"] = {"libcuda_mapped": holding, "apps_before": apps_before,
                                    "apps": apps}
            out["card_memory_mib"] = {
                "card_before_boot": memory_before, "card_booted": card_memory_mib(),
                "allocator_booted": {k: daemon_card_memory(procs[k].ops_port)
                                     for k in names}}
            if not all(holding.values()) or len(apps) != len(apps_before) + 4:
                raise AssertionError(f"replication: CUDA contexts {out['cuda_contexts']}")

        # 1. the wave through the map
        user_ids = [f"repl-{i:05d}" for i in range(users)]
        part: dict = {0: [], 1: []}
        for uid in user_ids:
            part[pmap.partition_for(uid).index].append(uid)
        index = {uid: j for members in part.values() for j, uid in enumerate(members)}
        out["partition_users"] = {k: len(v) for k, v in part.items()}
        launches0 = {k: kernel_launches(procs[k].ops_port) for k in ("a", "c")}
        out["register"] = asyncio.run(fleet_register(pmap, user_ids, index, corpus, rpc_max))
        wave_users = user_ids[:n]
        wave = asyncio.run(fleet_logins(pmap, wave_users, index, provers, rpc_max, gen))
        wave["launches"] = {k: {name: v - launches0[k][name] for name, v in
                                kernel_launches(procs[k].ops_port).items()} for k in ("a", "c")}
        if on_card and min(v[k] for v in wave["launches"].values() for k in SERVED_KERNELS) < 1:
            raise AssertionError(f"replication: a kernel was not launched by the primaries' "
                                 f"logins: {wave['launches']}")
        out["wave"] = wave
        stale_uid = part[1][-1]
        stale = asyncio.run(stale_map_login(pmap, addr["a"], stale_uid,
                                            provers[index[stale_uid] % len(provers)], gen))
        if not stale["success"] or stale["redirects"] != 1 or stale["map_version"] != pmap.version:
            raise AssertionError(f"replication: the one-partition client {stale}")
        out["stale_map_client"] = stale
        refusals = {k: asyncio.run(standby_refusal(ports[k])) for k in ("b", "d")}
        want = ("UNAVAILABLE", "standby replica: not promoted (writes go to the primary)")
        if any(r != want for r in refusals.values()):
            raise AssertionError(f"replication: the standbys answered {refusals}")
        out["standby_refusals"] = {k: list(v) for k, v in refusals.items()}
        applied = {}
        for primary, standby in (("a", "b"), ("c", "d")):
            wait_until(f"{standby} applied {primary}'s log", lambda p=primary, s=standby: (
                statusz(s)["replication"]["applied_seq"]
                == statusz(p)["replication"]["wal_seq"]), timeout=30.0)
            p_doc, s_doc = statusz(primary), statusz(standby)
            applied[primary + standby] = {
                "wal_seq": p_doc["replication"]["wal_seq"],
                "acked_seq": p_doc["replication"]["acked_seq"],
                "applied_seq": s_doc["replication"]["applied_seq"],
                "segments_shipped": p_doc["replication"]["segments_shipped"],
                "primary_users": p_doc["shards"]["users"],
                "standby_users": s_doc["shards"]["users"]}
        out["applied"] = applied
        if (applied["ab"]["primary_users"], applied["cd"]["primary_users"]) != (
                len(part[0]), len(part[1])):
            raise AssertionError(f"replication: partitions hold {applied}, the map "
                                 f"{out['partition_users']}")

        # 2. planned: SIGTERM to A hands partition 0 over to B
        a_segments = sorted(f for f in os.listdir(dirs["a"]) if f.endswith(".seg"))
        wait_until("A's sealed proof-log segments shipped",
                   lambda: statusz("a")["replication"]["audit_segments_shipped"]
                   >= len(a_segments))
        a_doc = statusz("a")
        t0 = time.perf_counter()
        procs["a"].proc.send_signal(signal.SIGTERM)
        first_write, _ = asyncio.run(until_promoted(
            ports["b"], create_challenge_call(part[0][0]), t0, 60.0))
        rc = procs["a"].proc.wait(timeout=DRAIN_SECONDS + 60)
        for t in procs["a"].readers:
            t.join(timeout=5)
        m = HANDOVER_LINE.search(procs["a"].text())
        b_doc = statusz("b")
        planned = {"exit_code": rc, "shutdown_s": time.perf_counter() - t0,
                   "handover_ms": int(m.group(2)) if m else None,
                   "sigterm_to_first_write_at_b_s": first_write,
                   "b_role": b_doc["replication"]["role"], "b_epoch": b_doc["replication"]["epoch"],
                   "a_acknowledged": {k: a_doc["shards"][k] for k in ("users", "sessions")},
                   "b_holds": {k: b_doc["shards"][k] for k in ("users", "sessions")}}
        b_segments = sorted(f for f in os.listdir(dirs["b"]) if f.endswith(".seg"))
        equal = [f for f in a_segments if f in b_segments and open(
            os.path.join(dirs["a"], f), "rb").read() == open(os.path.join(dirs["b"], f),
                                                             "rb").read()]
        planned["audit_segments"] = {"a": len(a_segments), "b": len(b_segments),
                                     "byte_equal": len(equal)}
        out["planned"] = planned
        if (rc != 0 or m is None or int(m.group(1)) != 2 or planned["b_role"] != "primary"
                or planned["b_epoch"] != 2
                or planned["b_holds"] != planned["a_acknowledged"]
                or planned["a_acknowledged"]["users"] != len(part[0])):
            raise AssertionError(f"replication: the handover {planned}:\n"
                                 f"{procs['a'].text()[-3000:]}")
        if not a_segments or b_segments != a_segments or len(equal) != len(a_segments):
            raise AssertionError(f"replication: A's sealed segments {a_segments}, at B "
                                 f"{b_segments}, byte-equal {len(equal)}")

        # 3. unplanned: SIGKILL C with CreateChallenge calls in flight
        wave_set = set(wave_users)
        kill_users = [u for u in part[1] if u not in wave_set][:further]
        c_doc = statusz("c")
        kill_t: list = []

        def kill() -> None:
            kill_t.append(time.perf_counter())
            procs["c"].kill()

        kw = asyncio.run(challenges_until_kill(ports["c"], kill_users, kill_after, kill, sheds))
        acked = kw.pop("acked")
        if procs["c"].proc.returncode != -signal.SIGKILL:
            raise AssertionError(f"replication: C ended {procs['c'].proc.returncode}")
        uid0, cid0 = acked[0]
        first_s, first = asyncio.run(until_promoted(
            ports["d"], verify_proof_call(uid0, cid0, provers[index[uid0] % len(provers)], gen),
            kill_t[0], lease_ms / 1000.0 + 60.0))
        if not (first.success and first.session_token):
            raise AssertionError(f"replication: the first login at D failed: {first.message}")
        promoted_at = procs["d"].seconds_to("PROMOTED to primary")
        logins = asyncio.run(recovered_logins(ports["d"], acked[1:], index, provers, rpc_max,
                                              gen, sheds))
        d_doc = statusz("d")
        unplanned = {**kw, "acked": len(acked), "exit_code": procs["c"].proc.returncode,
                     "kill_to_promotion_s": (promoted_at - (kill_t[0] - procs["d"].t0)
                                             if promoted_at is not None else None),
                     "kill_to_first_session_s": first_s,
                     "promotion_to_first_session_s": (
                         first_s - (promoted_at - (kill_t[0] - procs["d"].t0))
                         if promoted_at is not None else None),
                     "logins": logins,
                     "d_role": d_doc["replication"]["role"],
                     "d_epoch": d_doc["replication"]["epoch"],
                     "c_users_before_kill": c_doc["shards"]["users"],
                     "d_users": d_doc["shards"]["users"]}
        out["unplanned"] = unplanned
        if (unplanned["d_role"] != "primary" or unplanned["d_epoch"] != 2
                or unplanned["d_users"] != len(part[1]) or promoted_at is None
                or logins["sessions"] != len(acked) - 1):
            raise AssertionError(f"replication: the failover {unplanned}")

        # 4. the promoted standbys serve logins on the card
        promoted = {}
        for name, members in (("b", part[0]), ("d", part[1])):
            proc = procs[name]
            seq0, launches0 = last_flight_seq(proc.ops_port), kernel_launches(proc.ops_port)
            login_wave = asyncio.run(daemon_logins(proc.port, members[:n], corpus, provers,
                                                   rpc_max, gen, register=False, sheds=sheds))
            launches = {k: v - launches0[k] for k, v in kernel_launches(proc.ops_port).items()}
            records = flight_records(proc.ops_port, seq0)
            metrics_text = http_get(proc.ops_port, "/metrics")
            failover = scraped(metrics_text, "tpu_backend_failover_total")
            if on_card and min(launches[k] for k in SERVED_KERNELS) < 1:
                raise AssertionError(f"replication: a kernel was not launched by {name}'s "
                                     f"logins: {launches}")
            if failover:
                raise AssertionError(f"replication: {name} failed over {failover} times")
            for key in ("verdicts", "acked"):
                login_wave.pop(key)
            promoted[name] = {**login_wave, "launches": launches, "failover": failover,
                              "batches": [r["batch"] for r in records],
                              "device_interval_s": [r["device_interval_s"] for r in records],
                              "audit": statusz(name)["audit"]}
        out["promoted"] = promoted
        if on_card:
            out["card_memory_mib"].update(
                card_end=card_memory_mib(),
                allocator_end={k: daemon_card_memory(procs[k].ops_port) for k in ("b", "d")})
        for name in ("b", "d"):
            rc, _ = procs[name].terminate(DRAIN_SECONDS + 60)
            if rc != 0:
                raise AssertionError(f"replication: {name} exited {rc}:\n"
                                     f"{procs[name].text()[-3000:]}")
        out["sheds_by_rpc"], out["sheds_by_tier"] = dict(sheds), tier_sheds(sheds)
        if out["sheds_by_tier"]["verify"]:
            raise AssertionError(f"replication: tier-0 (verify) RPCs were shed: {sheds}")

        # 5. each promoted standby's proof log continues its primary's
        # shipped segments: its directory replays as one whole log
        trails = {}
        a_last = int(a_segments[-1].rsplit("-", 1)[1].split(".")[0])
        for name in ("b", "d"):
            m = PROMOTED_AUDIT_LINE.search(procs[name].text())
            shipped_last = int(m.group(1)) if m else None
            status = promoted[name]["audit"]
            t0 = time.perf_counter()
            report = run_audit(dirs[name], os.path.join(workdir, f"trail_{name}.json"),
                               backend="tpu", device=None if on_card else "cpu")
            replay_s = time.perf_counter() - t0
            log_doc, totals = report["log"], report["totals"]
            trails[name] = {"shipped_last_seq": shipped_last, "own_records":
                            status["records_this_boot"], "seq": status["seq"],
                            "first_seq": log_doc["first_seq"], "last_seq": log_doc["last_seq"],
                            "whole": log_doc["valid_bytes"] == log_doc["file_bytes"],
                            "totals": totals, "replay_s": replay_s}
            own_verdicts = promoted[name]["valid"] + promoted[name]["tampered"]
            if (shipped_last is None or shipped_last < 1
                    or (name == "b" and shipped_last != a_last)
                    or not trails[name]["whole"]
                    or (log_doc["first_seq"], log_doc["last_seq"]) != (1, status["seq"])
                    or status["seq"] != shipped_last + status["records_this_boot"]
                    or status["records_this_boot"] < own_verdicts
                    or totals["records"] != totals["audited"] or totals["records"] != status["seq"]
                    or totals["mismatched"] or totals["skipped"]):
                raise AssertionError(f"replication: {name}'s audit trail {trails[name]}")
        out["promoted_trails"] = trails
        out["phase_s"] = time.perf_counter() - t_phase
    finally:
        for proc in procs.values():
            proc.kill()
            proc.save_log()
        shutil.rmtree(workdir, ignore_errors=True)
    return out



# -- multi-device serving, the sharded mesh, the two-rank job, the controller --

#: lanes and mesh slices on the one card: two of each (routing, breakers,
#: sharding and gathers; nothing about scale-out)
MULTI_DEVICES = 2
#: entries at or above which a batch takes the mesh lane
LANES_MESH_THRESHOLD = 8192
#: the lane breakers' cooldown before a HALF_OPEN probe; longer than the
#: fault lasts, so no probe meets the sick lane
LANES_RECOVERY_S = 3.0
#: the controller beside the lanes: its tick, how long a breaker stays
#: OPEN before the drain, the drained lane's least time out, and the
#: CLOSED ticks before the readmission
LANES_TICK_MS = 100.0
LANES_OPEN_AFTER_S = 1.0
LANES_COOLDOWN_S = 1.0
LANES_CLEAR_TICKS = 2
#: seconds of traffic after the fault clears and after the readmission
LANES_SETTLE_S = 1.0
#: the mesh phase: rows of the verify paths; statements of the prover
MESH_ROWS = 16384
MESH_STATEMENTS = (16384, 65536)
#: the two-rank job: rows of its batches
MULTIHOST_ROWS = 16384
MULTIHOST_TIMEOUT_S = 300.0
#: what each rank of the job launches: its slices of the mesh's Pippenger
#: MSM, and of the mixed batch's per-row checks
MULTIHOST_KERNELS = ("ladder_each", "msm_bucket", "msm_window_reduce")
#: what the mesh phase launches: the per-row route's sharded checks and
#: the Pippenger MSM, whose slice partials point_add sums
MESH_KERNELS = ("ladder_combined", "ladder_each", "point_add", "msm_bucket",
                "msm_window_reduce")
#: the controller phase: users registered at A, the user count at which
#: its controller splits the partition (a choice of this phase, not a
#: measured capacity), the controller's tick, and the login wave per
#: partition
CTL_USERS = 65536
CTL_SPLIT_THRESHOLD = 32768
CTL_TICK_MS = 100.0
CTL_LOGINS_PER_PARTITION = 1024


def lanes_phase(params, corpus, n: int, closed_total: int, clients: int, group: int,
                mesh_n: int, devices=None, mesh_threshold: int = LANES_MESH_THRESHOLD) -> dict:
    """The ``lanes`` phase: the multi-device serving plane in process.

    A ``LaneRouter`` over ``devices`` (by default ``cuda:0`` twice: two
    lanes on the one card) plus a mesh lane over the same list at
    ``mesh_threshold`` entries, behind ``DynamicBatcher(router=...)`` at
    ``batch_max = n``; ``mesh_n`` entries tile the corpus, about 1%
    tampered.  Steps: a closed loop of ``closed_total`` entries (every
    verdict and message exact; both lanes take batches, from the
    ``/statusz`` lane rows); one ``mesh_n``-entry batch on the mesh lane
    (exact); then, while the closed loop runs and a live
    ``FleetController`` ticks beside it, a fault strikes the lane that
    placement sends the next batch to (its backend raises, from a wrapper
    here): only that lane's breaker opens, the other lane serves every
    later batch, every entry of a failed batch is answered when its caller
    retries, the controller drains the sick lane after
    ``LANES_OPEN_AFTER_S`` and, once the fault is cleared and the probe has
    closed the breaker, readmits it."""
    import asyncio
    import threading

    import torch

    from cpzk_tpu_torch.fleet.controller import FleetController
    from cpzk_tpu_torch.observability.opsplane import OpsSources
    from cpzk_tpu_torch.ops import point_kernels as pk
    from cpzk_tpu_torch.ops.backend import TorchBackend, prewarm
    from cpzk_tpu_torch.protocol.batch import BatchEntry, VerifierBackend
    from cpzk_tpu_torch.protocol.gadgets import Proof
    from cpzk_tpu_torch.server.batching import DynamicBatcher
    from cpzk_tpu_torch.server.config import ControllerSettings
    from cpzk_tpu_torch.server.router import LaneRouter

    devices = devices or [torch.device("cuda", 0)] * MULTI_DEVICES
    m = len(corpus)
    valid, mixed, bad, _ = serving_wires(params, corpus, mesh_n)
    proofs = Proof.from_bytes_batch([(mixed[i] if i in bad else valid[i])[0]
                                     for i in range(mesh_n)])
    entries = [BatchEntry(params, corpus[i % m][0], proofs[i],
                          (mixed[i] if i in bad else valid[i])[3]) for i in range(mesh_n)]
    expected = [("InvalidParams", "Proof verification failed") if i in bad else None
                for i in range(mesh_n)]

    def check(lo: int, results, part: str) -> None:
        got = [None if r is None else (type(r).__name__, str(r)) for r in results]
        if got != expected[lo:lo + len(results)]:
            raise AssertionError(f"lanes {part}: wrong verdicts at {lo}")

    # while ``armed``, the first lane to draw a batch falls sick and raises
    # on every call until the fault is cleared
    fault = {"armed": False, "lane": None}
    fault_lock = threading.Lock()

    class Lane(VerifierBackend):
        """A lane's card backend, counting its batches and the kernels its
        device thread launches, and raising while it is the sick lane."""

        prefers_combined = True

        def __init__(self, inner, index: int):
            self.inner = inner
            self.index = index
            self.batches = self.entries = self.failed = 0
            self.launches: dict = {}

        def _call(self, fn, rows, *args):
            with fault_lock:
                if fault["armed"] and fault["lane"] is None:
                    fault["lane"] = self.index
                sick = fault["armed"] and fault["lane"] == self.index
            if sick:
                self.failed += 1
                raise RuntimeError("injected device fault")
            with pk.thread_launches() as tally:
                out = fn(rows, *args)
            for k, v in tally.items():
                self.launches[k] = self.launches.get(k, 0) + v
            return out

        def verify_combined(self, rows, beta):
            out = self._call(self.inner.verify_combined, rows, beta)
            self.batches += 1
            self.entries += len(rows)
            return out

        def verify_each(self, rows):
            return self._call(self.inner.verify_each, rows)

    out = {"devices": [str(d) for d in devices], "batch_max": n, "closed_total": closed_total,
           "mesh_n": mesh_n, "mesh_threshold": mesh_threshold,
           "tampered": len(bad), "tolerance": "exact"}
    t0 = time.perf_counter()
    for d in dict.fromkeys(devices):
        prewarm([n], d)
    out["prewarm_s"] = time.perf_counter() - t0
    lanes = [Lane(TorchBackend(device=d), i) for i, d in enumerate(devices)]
    mesh_backend = TorchBackend(mesh_devices=len(devices), devices=devices)
    router = LaneRouter(lanes, devices=devices, recovery_after_s=LANES_RECOVERY_S,
                        mesh_backend=mesh_backend, mesh_threshold=mesh_threshold)
    batcher = DynamicBatcher(lanes[0], max_batch=n, window_ms=5.0, router=router)
    settings = ControllerSettings(
        enabled=True, dry_run=False, tick_interval_ms=LANES_TICK_MS, act_ticks=1,
        clear_ticks=LANES_CLEAR_TICKS, lane_open_after_s=LANES_OPEN_AFTER_S,
        lane_cooldown_s=LANES_COOLDOWN_S)
    controller = FleetController(settings, router=router)
    timeline: list = []
    retried = [0]

    def lane_rows() -> list:
        return OpsSources(batcher=batcher).statusz()["lanes"]["lanes"]

    async def traffic(stop, total: int | None = None) -> dict:
        issued = [0]
        answered = [0]
        t_start = time.perf_counter()

        async def client():
            while (total is None and not stop.is_set()) or (
                    total is not None and issued[0] * group < total):
                g = issued[0]
                issued[0] += 1
                lo = (g * group) % mesh_n
                while True:
                    try:
                        results = await batcher.submit_many(entries[lo:lo + group])
                        break
                    except RuntimeError:
                        retried[0] += 1  # the batch failed on the sick lane
                check(lo, results, f"group {g}")
                answered[0] += group

        await asyncio.gather(*[client() for _ in range(clients)])
        wall = time.perf_counter() - t_start
        return {"entries": answered[0], "wall_s": wall, "entries_per_s": answered[0] / wall}

    async def ticker(stop) -> None:
        while not stop.is_set():
            await asyncio.sleep(LANES_TICK_MS / 1000.0)
            await controller.tick()
            timeline.append((time.perf_counter(), [
                (r["lane"], r["breaker"], r["drained"]) for r in router.lane_states()]))

    async def until(what: str, cond, timeout: float = 30.0) -> float:
        t = time.perf_counter()
        while not cond():
            if time.perf_counter() - t > timeout:
                raise AssertionError(f"lanes: {what} not reached in {timeout} s")
            await asyncio.sleep(0.01)
        return time.perf_counter()

    async def drive() -> None:
        batcher.start()
        try:
            # 1. the closed loop over both lanes
            pk.reset_all_launches()
            out["closed_loop"] = await traffic(None, closed_total)
            rows = lane_rows()
            out["closed_loop"]["lane_rows"] = rows
            out["closed_loop"]["launches_per_lane"] = [dict(lane.launches) for lane in lanes]
            if min(r["dispatches"] for r in rows) < 1:
                raise AssertionError(f"lanes: a lane took no batch: {rows}")
            # 2. one big batch on the mesh lane
            before = pk.all_launches()
            t = time.perf_counter()
            results = await router.submit(entries, None)
            out["mesh_batch"] = {"wall_s": time.perf_counter() - t,
                                 "launches": {k: v - before[k]
                                              for k, v in pk.all_launches().items()}}
            check(0, results, "mesh batch")
            mesh_row = router.status()["mesh"]
            if mesh_row["dispatches"] != 1 or mesh_row["breaker"] != "closed":
                raise AssertionError(f"lanes: the mesh lane {mesh_row}")
            # 3. the lane that draws the next batch falls sick under
            # traffic, beside a live controller
            served0 = [lane.entries for lane in lanes]
            stop, stop_ticks = asyncio.Event(), asyncio.Event()
            ticks = asyncio.ensure_future(ticker(stop_ticks))
            load = asyncio.ensure_future(traffic(stop))
            t_fault = time.perf_counter()
            with fault_lock:
                fault["armed"] = True
            await until("a lane fell sick", lambda: fault["lane"] is not None)
            sick = fault["lane"]
            well = 1 - sick
            t_open = await until("the sick lane OPEN", lambda: router.lane_states()[sick][
                "breaker"] == "open")
            t_drain = await until("the sick lane drained",
                                  lambda: router.lane_states()[sick]["drained"])
            await until("the other lane serving", lambda: lanes[well].entries > served0[well],
                        timeout=60.0)
            served_sick = [lane.entries for lane in lanes]
            with fault_lock:
                fault["armed"] = False
            t_clear = time.perf_counter()
            t_readmit = await until("the sick lane readmitted", lambda: (
                not router.lane_states()[sick]["drained"]), timeout=LANES_RECOVERY_S + 30.0)
            await asyncio.sleep(LANES_SETTLE_S)
            stop.set()
            out["fault_traffic"] = await load
            stop_ticks.set()
            await ticks
            out["fault"] = {
                "sick_lane": sick, "fault_to_open_s": t_open - t_fault,
                "open_to_drain_s": t_drain - t_open,
                "fault_s": t_clear - t_fault, "clear_to_readmit_s": t_readmit - t_clear,
                "failed_batches_on_sick_lane": lanes[sick].failed,
                "retried_groups": retried[0],
                "entries_while_sick": [b - a for a, b in zip(served0, served_sick)],
                "entries_after_readmit": [lane.entries - s for lane, s in
                                          zip(lanes, served_sick)]}
        finally:
            await batcher.stop()

    t_phase = time.perf_counter()
    asyncio.run(drive())
    wall = time.perf_counter() - t_phase
    synchronize()
    t_first = timeline[0][0] if timeline else 0.0
    changes = []
    for t, row in timeline:
        if not changes or changes[-1][1] != row:
            changes.append((round(t - t_first, 3), row))
    out["lane_state_timeline"] = changes
    out["decisions"] = [d.row() for d in controller.decisions if d.fired or d.veto is None]
    out["lane_rows"] = lane_rows()
    out["entries_per_lane"] = [lane.entries for lane in lanes]
    out["entries_per_s_per_lane"] = [lane.entries / wall for lane in lanes]
    out["launches_per_lane"] = [dict(lane.launches) for lane in lanes]
    out["phase_s"] = wall
    fired = [(d["action"], d["target"]) for d in out["decisions"] if d["fired"]]
    fault = out["fault"]
    sick, well = fault["sick_lane"], 1 - fault["sick_lane"]
    if any(row[well][1] != "closed" for _, row in timeline):
        raise AssertionError(f"lanes: lane {well}'s breaker left CLOSED: {changes}")
    if router.status()["mesh"]["breaker"] != "closed":
        raise AssertionError("lanes: the mesh lane's breaker opened")
    if fired != [("lane_drain", str(sick)), ("lane_readmit", str(sick))]:
        raise AssertionError(f"lanes: the controller fired {fired}")
    if fault["open_to_drain_s"] < LANES_OPEN_AFTER_S:
        raise AssertionError(f"lanes: drained {fault['open_to_drain_s']} s after OPEN")
    if (fault["failed_batches_on_sick_lane"] < 1 or fault["entries_while_sick"][sick] != 0
            or fault["entries_while_sick"][well] < 1
            or fault["entries_after_readmit"][sick] < 1):
        raise AssertionError(f"lanes: the fault {fault}")
    if (router.lane_states()[sick]["breaker"] != "closed"
            or out["lane_rows"][sick]["probes"] < 1):
        raise AssertionError(f"lanes: lane {sick} after the fault {out['lane_rows'][sick]}")
    on_card = torch.device(devices[0]).type == "cuda"
    # every lane runs combined checks; the batches that hold tampered
    # entries run the per-row ladders on whichever lane drew them
    if on_card and (min(lane.launches.get("ladder_combined", 0) for lane in lanes) < 1
                    or sum(lane.launches.get("ladder_each", 0) for lane in lanes) < 1):
        raise AssertionError(f"lanes: a lane launched no ladder kernel: "
                             f"{out['launches_per_lane']}")
    return out


def _rlc_terms(rows, beta):
    """The combined check's inputs on the host, as ``TorchBackend`` builds
    them: the per-row route's points and windows (correction row last) and
    the Pippenger route's points, digits and window size."""
    import torch

    from cpzk_tpu_torch.ops import backend as ob
    from cpzk_tpu_torch.ops import curve, msm

    cpu = "cpu"
    n = len(rows)
    a, ac, ba, bac, corr0, corr1 = ob._host_rlc_scalars(rows, beta)
    pad = ob._pad_lanes(n + 1)
    per_row = (ob._elems_soa([r.r1 for r in rows] + [rows[0].g], pad, cpu),
               ob._elems_soa([r.y1 for r in rows] + [rows[0].h], pad, cpu),
               ob._elems_soa([r.r2 for r in rows], pad, cpu),
               ob._elems_soa([r.y2 for r in rows], pad, cpu),
               curve.scalar_windows(a + [corr0], pad, cpu),
               curve.scalar_windows(ac + [corr1], pad, cpu),
               curve.scalar_windows(ba, pad, cpu), curve.scalar_windows(bac, pad, cpu))
    m = 4 * ob._pad_pow2(n) + 2
    c = msm.pick_window(min(m, ob.LANE_CHUNK))
    m_pad = m if m <= ob.LANE_CHUNK else ob._pad_lanes(m)
    elems = ([r.r1 for r in rows] + [r.y1 for r in rows] + [r.r2 for r in rows]
             + [r.y2 for r in rows] + [rows[0].g, rows[0].h])
    terms = a + ac + ba + bac + [corr0, corr1]
    digits = torch.from_numpy(msm.scalars_to_signed_digits(terms + [0] * (m_pad - len(terms)), c))
    return pad, per_row, (ob._elems_soa(elems, m_pad, cpu), digits, c)


def mesh_phase(params, rows, beta, statements_ns, gen, devices=None) -> dict:
    """The ``mesh`` phase: the sharded paths on ``devices`` (by default
    ``cuda:0`` twice) against the same calls on one device, at
    ``len(rows)`` rows with about 1% tampered and at ``statements_ns``
    statements: ``verify_each`` (row bits), the combined check through
    the Pippenger MSM (verdicts, with the host's scalars and with
    ``CPZK_DEVICE_RLC=1``; and the MSM's total as a canonical encoding),
    the per-row combined check (``sharded_combined_check``), and the
    prover's statements (bytes; the mesh prover's first call made straight
    after its construction).  Wall ms of each beside the one-device call."""
    import dataclasses

    import torch

    from cpzk_tpu_torch.core.ristretto import Ristretto255, Scalar
    from cpzk_tpu_torch.core.scalars import L
    from cpzk_tpu_torch.ops import backend as ob
    from cpzk_tpu_torch.ops import curve, msm
    from cpzk_tpu_torch.ops import point_kernels as pk
    from cpzk_tpu_torch.ops.backend import TorchBackend
    from cpzk_tpu_torch.ops.prove import BatchProver
    from cpzk_tpu_torch.parallel import mesh as pm

    devices = devices or [torch.device("cuda", 0)] * MULTI_DEVICES
    dev = torch.device(devices[0])
    n = len(rows)
    bad = set(range(37 % n, n, max(2, n // 42)))
    tampered = [dataclasses.replace(r, s=Scalar((r.s.value + 1) % L)) if i in bad else r
                for i, r in enumerate(rows)]
    single = TorchBackend(device=dev, pippenger_min=2)
    meshed = TorchBackend(mesh_devices=len(devices), devices=devices)
    mesh = meshed.mesh
    out = {"devices": [str(d) for d in devices], "rows": n, "tampered": len(bad),
           "tolerance": "exact (bits, canonical encodings, bytes)"}

    def both(name: str, one, sharded) -> tuple:
        times = {}
        for side, fn in (("one_device", one), ("mesh", sharded), ("one_device_2", one),
                         ("mesh_2", sharded)):
            synchronize()
            t = time.perf_counter()
            got = fn()
            synchronize()
            times[side] = (time.perf_counter() - t) * 1e3
            if side.endswith("_2"):
                continue
            if side == "one_device":
                want = got
            elif got != want:
                raise AssertionError(f"mesh {name}: the mesh gave {got!r:.200}, one device "
                                     f"{want!r:.200}")
        out.setdefault("wall_ms", {})[name] = {
            "one_device": [times["one_device"], times["one_device_2"]],
            "mesh": [times["mesh"], times["mesh_2"]]}
        return want

    launches0 = pk.all_launches()
    bits = both("verify_each", lambda: single.verify_each(tampered),
                lambda: meshed.verify_each(tampered))
    if [not b for b in bits] != [i in bad for i in range(n)]:
        raise AssertionError("mesh verify_each: wrong row bits")
    verdicts = both("combined_pippenger",
                    lambda: (single.verify_combined(rows, beta),
                             single.verify_combined(tampered, beta)),
                    lambda: (meshed.verify_combined(rows, beta),
                             meshed.verify_combined(tampered, beta)))
    if verdicts != (True, False):
        raise AssertionError(f"mesh combined (Pippenger): {verdicts}")
    # the same with the scalar plane on the card: the digits are made on
    # the mesh's first device, on the caller's stream, and the slices read
    # them there in place
    prev_rlc = os.environ.get("CPZK_DEVICE_RLC")
    os.environ["CPZK_DEVICE_RLC"] = "1"
    try:
        rlc0 = pk.all_launches()
        verdicts = both("combined_pippenger_device_rlc",
                        lambda: (single.verify_combined(rows, beta),
                                 single.verify_combined(tampered, beta)),
                        lambda: (meshed.verify_combined(rows, beta),
                                 meshed.verify_combined(tampered, beta)))
        rlc1 = pk.all_launches()
    finally:
        if prev_rlc is None:
            os.environ.pop("CPZK_DEVICE_RLC", None)
        else:
            os.environ["CPZK_DEVICE_RLC"] = prev_rlc
    out["device_rlc_launches"] = {k: rlc1[k] - rlc0[k] for k in PIPPENGER_KERNELS}
    if verdicts != (True, False):
        raise AssertionError(f"mesh combined (Pippenger, CPZK_DEVICE_RLC=1): {verdicts}")
    if dev.type == "cuda" and min(out["device_rlc_launches"].values()) < 1:
        raise AssertionError(f"mesh device RLC: {out['device_rlc_launches']}")
    encodings = []
    for name, rs in (("msm_total_valid", rows), ("msm_total_tampered", tampered)):
        pad, per_row, (pts, digits, c) = _rlc_terms(rs, beta)

        def one_total(pts=pts, digits=digits, c=c):
            parts = [msm.msm_kernel(tuple(x[..., lo:hi].to(dev) for x in pts),
                                    digits[:, lo:hi].to(dev), c)
                     for lo, hi in ob._chunk_bounds(digits.shape[-1], ob.LANE_CHUNK)]
            total = curve.tree_sum(tuple(torch.cat([p[k] for p in parts], -1)
                                         for k in range(4)))
            return bytes(curve.encode(tuple(x.cpu()[:, None] for x in total))
                         .to(torch.uint8)[:, 0].tolist())

        def mesh_total(pts=pts, digits=digits, c=c):
            total = pm.make_sharded_msm(mesh)(pts, digits, c)
            return bytes(curve.encode(tuple(x.cpu()[:, None] for x in total))
                         .to(torch.uint8)[:, 0].tolist())

        encodings.append(both(name, one_total, mesh_total))
        ok = both(f"combined_per_row_{name[10:]}",
                  lambda per_row=per_row, pad=pad: ob.chunked_combined_identity(
                      pad, ob.LANE_CHUNK, *(tuple(x.to(dev) for x in p) if isinstance(p, tuple)
                                            else p.to(dev) for p in per_row)),
                  lambda per_row=per_row: pm.make_sharded_combined_check(mesh)(*per_row))
        if ok != (rs is rows):
            raise AssertionError(f"mesh per-row combined check on {name}: {ok}")
    identity = Ristretto255.element_to_bytes(Ristretto255.identity())
    if encodings[0] != identity or encodings[1] == identity:
        raise AssertionError("mesh: the MSM totals are not (identity, not identity)")
    out["msm_totals"] = [e.hex() for e in encodings]
    one_prover = BatchProver(params, device=dev)
    ws = [Ristretto255.random_scalar(gen) for _ in range(statements_ns[0])]
    want = one_prover.statements(ws)
    mesh_prover = BatchProver(params, mesh_devices=len(devices), devices=devices)
    if mesh_prover.statements(ws) != want:  # straight after the tables' build
        raise AssertionError("mesh prover: the first call after construction differs")
    for k in statements_ns:
        ws = [Ristretto255.random_scalar(gen) for _ in range(k)]
        both(f"statements_{k}", lambda ws=ws: one_prover.statements(ws),
             lambda ws=ws: mesh_prover.statements(ws))
    after = pk.all_launches()
    out["launches"] = {k: after[k] - launches0[k] for k in after}
    return out


MULTIHOST_WORKER = r"""
import json, os, sys, time
sys.path.insert(0, os.getcwd())
import torch
t0 = time.perf_counter()
from cpzk_tpu_torch.parallel import multihost
multihost.initialize()
local = os.environ.get("CPZK_SMOKE_LOCAL")
mesh = multihost.global_batch_mesh(local.split(",") if local else None)
on_card = torch.cuda.is_available() and not local
if not on_card:
    torch.set_num_threads(1)
setup_s = time.perf_counter() - t0
import chip_smoke as cs
from cpzk_tpu_torch import BatchVerifier
from cpzk_tpu_torch.ops import point_kernels as pk
from cpzk_tpu_torch.ops.backend import TorchBackend
rank, world = multihost.process_info()
n = int(os.environ["CPZK_SMOKE_ROWS"])
params, corpus, _ = cs.make_corpus(int(os.environ["CPZK_SMOKE_CORPUS"]),
                                   cs.SeededRng(int(os.environ["CPZK_SMOKE_SEED"])))
backend = TorchBackend(mesh_devices=0, devices=mesh)


def verify(mismatched):
    bv = BatchVerifier(backend=backend, max_size=n + 1)
    for i in range(n):
        st, pr, ctx = corpus[i % len(corpus)]
        bv.add_with_context(params, st, pr, ctx)
    if mismatched:
        bv.add_with_context(params, corpus[0][0], corpus[1][1], corpus[1][2])
    pk.reset_all_launches()
    t = time.perf_counter()
    res = bv.verify(cs.SeededRng(7))
    if on_card:
        torch.cuda.synchronize()
    return ([None if r is None else str(r) for r in res], time.perf_counter() - t,
            pk.all_launches())


valid, valid_s, valid_launches = verify(False)
mixed, mixed_s, mixed_launches = verify(True)
print("MULTIHOST " + json.dumps({
    "rank": rank, "world": world, "mesh": [str(d) for d in mesh], "owners": list(mesh.owners),
    "setup_s": setup_s, "valid": valid, "mixed": mixed, "valid_s": valid_s,
    "mixed_s": mixed_s, "valid_launches": valid_launches, "mixed_launches": mixed_launches,
    "memory_reserved_mib": torch.cuda.memory_reserved(0) / 2**20 if on_card else None,
    "max_memory_allocated_mib": (torch.cuda.max_memory_allocated(0) / 2**20
                                 if on_card else None)}), flush=True)
multihost.shutdown()
"""


def multihost_phase(n: int, world: int = MULTI_DEVICES, corpus_n: int = CORPUS,
                    timeout: float = MULTIHOST_TIMEOUT_S, local: str | None = None) -> dict:
    """The ``multihost`` phase: ``world`` ranks spawned on the one card,
    each through ``multihost.initialize()`` (gloo at ``127.0.0.1``) with a
    global mesh of ``world`` (one ``cuda:0`` slice per rank), verify the
    same ``n`` rows SPMD: the all-valid batch is accepted by the combined
    check (the partial points all-gathered over gloo), and with one
    mismatched row appended the per-row route isolates it (the row bits
    gathered).  Both ranks must exit 0 with the same verdicts.  ``local``
    names each rank's devices instead of its CUDA cards (``"cpu"`` for a
    rehearsal)."""
    root = os.path.dirname(os.path.abspath(__file__))
    env = {k: v for k, v in os.environ.items() if not k.startswith("CPZK_")}
    env.update(PYTHONPATH=root + os.pathsep + env.get("PYTHONPATH", ""),
               CPZK_COORDINATOR=f"127.0.0.1:{free_port()}", CPZK_NUM_PROCESSES=str(world),
               CPZK_SMOKE_ROWS=str(n), CPZK_SMOKE_CORPUS=str(corpus_n),
               CPZK_SMOKE_SEED=str(SEED + 29), **({"CPZK_SMOKE_LOCAL": local} if local else {}))
    t0 = time.perf_counter()
    procs = [subprocess.Popen([sys.executable, "-c", MULTIHOST_WORKER], cwd=root,
                              env=dict(env, CPZK_PROCESS_ID=str(r)), text=True,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE)
             for r in range(world)]
    results = []
    try:
        for p in procs:
            stdout, stderr = p.communicate(timeout=timeout)
            results.append((p.returncode, stdout, stderr))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=30)
    docs = []
    for r, (rc, stdout, stderr) in enumerate(results):
        line = next((ln for ln in stdout.splitlines() if ln.startswith("MULTIHOST ")), None)
        if rc != 0 or line is None:
            raise AssertionError(f"multihost: rank {r} exited {rc}:\n{stderr[-3000:]}")
        docs.append(json.loads(line[len("MULTIHOST "):]))
    want_valid = [None] * n
    want_mixed = [None] * n + ["Proof verification failed"]
    for doc in docs:
        if doc["valid"] != want_valid or doc["mixed"] != want_mixed:
            raise AssertionError(f"multihost: rank {doc['rank']}'s verdicts are wrong")
        if doc["world"] != world or len(doc["mesh"]) != world:
            raise AssertionError(f"multihost: rank {doc['rank']} saw {doc['mesh']}")
        if local is None and min(doc["valid_launches"][k] + doc["mixed_launches"][k]
                                 for k in MULTIHOST_KERNELS) < 1:
            raise AssertionError(f"multihost: rank {doc['rank']} launched "
                                 f"{doc['valid_launches']}")
    return {"world": world, "rows": n, "exit_codes": [r[0] for r in results],
            "phase_s": time.perf_counter() - t0,
            "ranks": [{k: v for k, v in doc.items() if k not in ("valid", "mixed")}
                      for doc in docs],
            "verdicts_equal_across_ranks": all(d["mixed"] == docs[0]["mixed"] for d in docs),
            "tolerance": "exact"}


def controller_phase(corpus, provers, users: int, threshold: int, logins: int, rpc_max: int,
                     launcher: list | None = None, on_card: bool = True) -> dict:
    """The ``controller`` phase: a live split fired by the fleet controller
    of a serving daemon.

    Daemon A serves a one-partition fleet (``[fleet]`` on a map from
    ``python -m cpzk_tpu_torch.fleet init``), ``[durability]`` with
    ``fsync = "always"``, ``[admission]`` off (the phase measures the
    split, not the sheds after a login wave), and ``[controller] enabled =
    true``, ``dry_run = false``, ``split_user_threshold = threshold``, ``split_target_address``
    B's.  ``users`` registrations go to A in ``RegisterBatch`` calls of
    ``rpc_max``, ``REPL_REGISTER_IN_FLIGHT`` at a time, from a client
    holding the one-partition map; the controller splits while A serves.
    Entries answered with a redirect after the flip are registered again,
    through the new map, once daemon B has booted at the target address
    from the ``partition-1.state.json``, WAL and epoch file the split wrote
    beside the map.  Then ``logins`` users of each partition log in through
    a client holding the old map (following the redirects): every verdict
    exact, both served ladder kernels launched on both daemons.  After both
    stop, their final snapshots hold every acknowledged registration at its
    owner and no user at both."""
    from cpzk_tpu_torch.fleet import PartitionMap
    from cpzk_tpu_torch.server.__main__ import DRAIN_SECONDS

    t_phase = time.perf_counter()
    steps: dict = {}  # seconds from the phase's start to the end of each step
    root = os.path.dirname(os.path.abspath(__file__))
    workdir = tempfile.mkdtemp(prefix="cpzk-ctl-")
    ports = {k: free_port() for k in ("a", "b")}
    addr = {k: f"127.0.0.1:{ports[k]}" for k in ports}
    dirs = {k: os.path.join(workdir, k) for k in ports}
    for d in dirs.values():
        os.makedirs(d)
    map_path = os.path.join(workdir, "map.json")
    env = {k: v for k, v in os.environ.items() if not k.startswith("SERVER_")}
    env["PYTHONPATH"] = root + os.pathsep + env.get("PYTHONPATH", "")
    argv = (launcher or [sys.executable, "-m", "cpzk_tpu_torch.server"]) + ["--no-repl"]
    gen = SeededRng(SEED + 31)
    out = {"users": users, "split_user_threshold": threshold, "logins_per_partition": logins,
           "rpc_entries": rpc_max, "in_flight": REPL_REGISTER_IN_FLIGHT,
           "tick_ms": CTL_TICK_MS, "tolerance": "exact"}
    procs: dict = {}

    def config(name: str, state_file: str, partition: int, controller: str) -> str:
        path = os.path.join(dirs[name], "server.toml")
        with open(path, "w") as f:
            f.write(f'state_file = "{state_file}"\n[server]\nmax_users = {users}\n'
                    f'[tpu]\nbackend = "tpu"\nbatch_max = {rpc_max}\n'
                    f'prewarm_quanta = "{rpc_max}"\n'
                    "[rate_limit]\nrequests_per_minute = 100000000\nburst = 1000000\n"
                    "[admission]\nenabled = false\n"
                    "[opsplane]\nenabled = true\nport = 0\n"
                    '[durability]\nenabled = true\nfsync = "always"\n'
                    f'[fleet]\nenabled = true\nmap_path = "{map_path}"\n'
                    f"partition = {partition}\n" + controller)
        return path

    def boot(name: str, path: str) -> "DaemonProcess":
        procs[name] = DaemonProcess(f"ctl_{name}", argv + ["--port", str(ports[name])],
                                    dirs[name], dict(env, SERVER_CONFIG_PATH=path))
        return procs[name].wait_listening(DAEMON_BOOT_TIMEOUT_S)

    def statusz(name: str) -> dict:
        return json.loads(http_get(procs[name].ops_port, "/statusz"))

    try:
        done = subprocess.run([sys.executable, "-m", "cpzk_tpu_torch.fleet", "init",
                               "--addresses", addr["a"], "--out", map_path], cwd=workdir,
                              env=env, capture_output=True, text=True, timeout=120)
        if done.returncode != 0:
            raise AssertionError(f"controller: fleet init: {done.stderr}")
        old_map = PartitionMap.load(map_path)
        boot("a", config("a", os.path.join(dirs["a"], "state.json"), 0,
                         "[controller]\nenabled = true\ndry_run = false\n"
                         f"tick_interval_ms = {CTL_TICK_MS}\nact_ticks = 1\n"
                         f"split_user_threshold = {threshold}\n"
                         f'split_target_address = "{addr["b"]}"\n'))
        out["boot_a_s"] = procs["a"].boot_s
        steps["a_listening"] = time.perf_counter() - t_phase
        user_ids = [f"ctl-{i:05d}" for i in range(users)]
        index = {uid: i for i, uid in enumerate(user_ids)}
        reg = asyncio.run(register_through_split(old_map, user_ids, index, corpus, rpc_max))
        acked, redirected = reg.pop("acked"), reg.pop("redirected")
        out["register"] = reg
        steps["registered"] = time.perf_counter() - t_phase
        doc = statusz("a")["controller"]
        splits = [d for d in doc["decisions"] if d["action"] == "split" and d["fired"]]
        if len(splits) != 1 or not redirected:
            raise AssertionError(f"controller: split decisions {splits}, "
                                 f"{len(redirected)} redirected registrations")
        report = splits[0]["detail"]["report"]
        out["split"] = {"reason": splits[0]["reason"], **report}
        out["decisions"] = summarize_decisions(doc["decisions"])
        new_map = PartitionMap.load(map_path)
        target = report["target_state_file"]
        for suffix in ("", ".wal", ".epoch"):
            if not os.path.exists(target + suffix):
                raise AssertionError(f"controller: the split wrote no {target + suffix}")
        boot("b", config("b", target, 1, ""))
        out["boot_b_s"] = procs["b"].boot_s
        out["b_restored_users"] = statusz("b")["shards"]["users"]
        steps["b_listening"] = time.perf_counter() - t_phase
        out["reregister"] = asyncio.run(fleet_register(new_map, redirected, index, corpus,
                                                       rpc_max))
        steps["reregistered"] = time.perf_counter() - t_phase
        owners = {uid: new_map.partition_for(uid).index for uid in user_ids}
        waves = {}
        for name, part in (("a", 0), ("b", 1)):
            members = [u for u in user_ids if owners[u] == part][:logins]
            proc = procs[name]
            launches0 = kernel_launches(proc.ops_port)
            waves[name] = asyncio.run(fleet_logins(
                old_map, members, index, provers, rpc_max, gen,
                map_refresh=lambda: new_map))
            waves[name]["launches"] = {k: v - launches0[k] for k, v in
                                       kernel_launches(proc.ops_port).items()}
            if on_card and min(waves[name]["launches"][k] for k in SERVED_KERNELS) < 1:
                raise AssertionError(f"controller: a kernel was not launched at {name}: "
                                     f"{waves[name]['launches']}")
            steps[f"logged_in_at_{name}"] = time.perf_counter() - t_phase
        if waves["b"]["redirects"] < 1:
            raise AssertionError("controller: the old-map client was never redirected")
        out["logins"] = waves
        if on_card:
            out["card_memory_mib"] = {k: daemon_card_memory(procs[k].ops_port)
                                      for k in ("a", "b")}
        for name in ("a", "b"):
            rc, _ = procs[name].terminate(DRAIN_SECONDS + 60)
            if rc != 0:
                raise AssertionError(f"controller: {name} exited {rc}:\n"
                                     f"{procs[name].text()[-3000:]}")
            steps[f"{name}_stopped"] = time.perf_counter() - t_phase
        held = {}
        for name, path in (("a", os.path.join(dirs["a"], "state.json")), ("b", target)):
            with open(path, encoding="utf-8") as f:
                held[name] = set(json.load(f)["users"])
        steps["final_snapshots_read"] = time.perf_counter() - t_phase
        both = held["a"] & held["b"]
        misplaced = [u for u in held["a"] if owners[u] != 0] + [
            u for u in held["b"] if owners[u] != 1]
        held_anywhere = held["a"] | held["b"]
        missing = [u for u in user_ids if u not in held_anywhere]
        out["final"] = {"a_users": len(held["a"]), "b_users": len(held["b"]),
                        "at_both": len(both), "misplaced": len(misplaced),
                        "missing": len(missing), "acked_before_b": len(acked)}
        if both or misplaced or missing:
            raise AssertionError(f"controller: after the split {out['final']}")
        out["steps_s"] = steps
        out["phase_s"] = time.perf_counter() - t_phase
    finally:
        for proc in procs.values():
            proc.kill()
            proc.save_log()
        shutil.rmtree(workdir, ignore_errors=True)
    return out


def summarize_decisions(rows: list) -> dict:
    """Decision counts by action and outcome, and the fired ones."""
    counts: dict = {}
    for d in rows:
        outcome = "fired" if d["fired"] else (f"veto:{d['veto']}" if d["veto"] else "dry_run")
        key = f"{d['action']}/{outcome}"
        counts[key] = counts.get(key, 0) + 1
    return {"counts": counts, "fired": [{k: d[k] for k in ("action", "target", "reason", "at")}
                                        for d in rows if d["fired"]]}


async def register_through_split(pmap, user_ids, index: dict, corpus, rpc_max: int) -> dict:
    """``RegisterBatch`` of ``user_ids`` at the one partition of ``pmap``,
    in calls of ``rpc_max``, ``REPL_REGISTER_IN_FLIGHT`` at a time; user
    ``u`` registers corpus statement ``index[u]``.  An entry is either
    acknowledged or answered with the fleet's wrong-partition redirect
    (after the split's flip); any other failure fails the phase."""
    n, m = len(user_ids), len(corpus)
    bounds = [(lo, min(lo + rpc_max, n)) for lo in range(0, n, rpc_max)]
    window = asyncio.Semaphore(REPL_REGISTER_IN_FLIGHT)
    acked: list = []
    redirected: list = []
    other: list = []
    async with fleet_client(pmap) as client:
        async def call(lo: int, hi: int):
            async with window:
                uids = user_ids[lo:hi]
                resp = await client.register_batch(
                    uids, [corpus[index[u] % m][0].y1.wire() for u in uids],
                    [corpus[index[u] % m][0].y2.wire() for u in uids])
                for uid, r in zip(uids, resp.results):
                    if r.success:
                        acked.append(uid)
                    elif "partition" in r.message:
                        redirected.append(uid)
                    else:
                        other.append(r.message)

        t0 = time.perf_counter()
        await asyncio.gather(*[call(lo, hi) for lo, hi in bounds])
        wall = time.perf_counter() - t0
    if other or len(acked) + len(redirected) != n:
        raise AssertionError(f"controller: {len(other)} registrations failed: {other[:3]}")
    return {"users": n, "calls": len(bounds), "register_s": wall,
            "registrations_per_s": n / wall, "acknowledged": len(acked),
            "redirected_after_flip": len(redirected), "acked": acked,
            "redirected": redirected}


def main() -> int:
    try:
        import torch
    except ImportError as exc:
        print(f"chip_smoke: {exc}", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    try:
        from cpzk_tpu_torch import SecureRng
        from cpzk_tpu_torch.ops import point_kernels as pk
        from cpzk_tpu_torch.ops.backend import TorchBackend
    except ImportError as exc:
        print(f"chip_smoke: run from the repository root ({exc})", file=sys.stderr)
        return 1

    names = set(pk.kernel_names())
    for table, keys in (("POINT_KERNELS + LADDER_KERNELS + PIPPENGER_KERNELS + "
                         "PROVER_KERNELS + CHALLENGE_KERNELS + DECODE_KERNELS",
                         POINT_KERNELS + LADDER_KERNELS + PIPPENGER_KERNELS + PROVER_KERNELS
                         + CHALLENGE_KERNELS + DECODE_KERNELS),
                        ("REPLACES", REPLACES), ("SOURCES", SOURCES)):
        if set(keys) != names:
            raise AssertionError(f"{table} lists {sorted(keys)}, the library's kernels "
                                 f"are {sorted(names)}")

    t_start = time.perf_counter()
    dev = torch.device("cuda", 0)
    os.makedirs(os.path.dirname(JSONL_OUT), exist_ok=True)
    open(JSONL_OUT, "w").close()

    # 1. device
    kind = torch.cuda.get_device_name(0)
    smi = nvidia_smi("name,power.limit")
    max_sm_mhz = float(nvidia_smi("clocks.max.sm").split()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    card = {"device": kind, "nvidia_smi": smi}
    emit({"phase": "device", **card, "count": torch.cuda.device_count(),
          "max_sm_mhz": max_sm_mhz, "sms": sms, "torch": torch.__version__,
          "cuda": torch.version.cuda, "python": sys.version.split()[0]})

    # 2. build
    t0 = time.perf_counter()
    lib_path, report = pk.build()
    ptxas = [ln.strip() for ln in report.splitlines()
             if "registers" in ln or "spill" in ln or "Compiling entry" in ln]
    per_kernel = pk.ptxas_report(report)
    for name in POINT_KERNELS + ("ladder_combined", "ladder_each"):
        per_kernel.setdefault(name, {})["block_threads"] = {
            n: pk.block_threads(n, dev) for n in KERNEL_NS}
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "library": lib_path.name, "kernels": per_kernel, "ptxas": ptxas})

    # 2b. the host core, and the corpus made on its comb
    gen = SeededRng(SEED)
    host, params, corpus, provers = host_core(dev, gen, SERVING_N, SAMPLE_N)
    emit({"phase": "host_core", **host, **card})

    # 3. kernels against their plain versions
    int32_ops_per_s = sms * INT32_OPS_PER_SM_CLOCK * max_sm_mhz * 1e6
    kernel_rows = kernels_vs_plain(dev, KERNEL_NS, int32_ops_per_s, gen)
    emit({"phase": "kernels_vs_plain", "tolerance": "exact after canonicalization", **card,
          "results": kernel_rows})
    scalar_rows = scalar_kernels_vs_plain(dev, SCALAR_NS, SCALAR_CS, SCALAR_TIMED_NS,
                                          int32_ops_per_s)
    emit({"phase": "kernels_vs_plain", "kernels": "scalar", "tolerance": "exact (torch.equal)",
          **card, "results": scalar_rows})
    msm_rows = msm_kernels_vs_plain(dev, MSM_MS, MSM_C, MSM_CHUNK, int32_ops_per_s)
    emit({"phase": "kernels_vs_plain", "kernels": "msm", "seconds": msm_rows.pop("seconds"),
          "tolerance": "equal as group elements (encodings)", **card, "results": msm_rows})
    prover_rows = prover_kernels_vs_plain(dev, PROVE_KERNEL_NS, PROVE_TIMED_NS,
                                          CHALLENGE_MASKS, int32_ops_per_s)
    emit({"phase": "kernels_vs_plain", "kernels": "prover and challenges",
          "tolerance": "exact (bytes, words, limbs; tables in the kernel's layout)", **card,
          "results": prover_rows})
    ladder_rows = ladder_kernels_vs_plain(dev, params, corpus, int32_ops_per_s,
                                          SeededRng(SEED + 41))
    emit({"phase": "kernels_vs_plain", "kernels": "ladders",
          "seconds": ladder_rows.pop("seconds"),
          "tolerance": "bits and verdicts exact; chunk totals equal as group elements "
                       "(canonical encodings)", **card, "results": ladder_rows})
    kernel_rows.update(scalar_rows)
    kernel_rows.update(msm_rows)
    kernel_rows.update(prover_rows)
    kernel_rows.update(ladder_rows)
    # 3e. the pinned vectors of tests/vectors on the card
    emit({"phase": "vectors", **vectors_check(dev), **card})

    rows, beta = north_star_rows(params, corpus, NORTH_STAR_N, SecureRng())

    # 4-5. the main path, with the launch counts set to 0 just before it:
    # the ladder kernels carry it, the point kernels are on none of it
    backend = TorchBackend()
    pk.reset_all_launches()
    parse, serving = serving_batch(backend, params, corpus, SERVING_N, SUB_BATCH_N)
    emit({"phase": "serving_parse", **parse, **card})
    emit({"phase": "serving_batch", **serving, **card})
    star = north_star(backend, rows, beta)
    launches = pk.all_launches()
    emit({"phase": "north_star", **star, "launches": launches, **card})
    for name in LADDER_KERNELS:
        if launches[name] < 1:
            raise AssertionError(f"{name} was never launched on the main path")
    for name in POINT_KERNELS:
        if launches[name]:
            raise AssertionError(f"{name} was launched on the main path: the ladders "
                                 "run as the ladder kernels")

    # 5a. this slice's path: the combined check as a Pippenger MSM, with the
    # host and the device scalar plane (every count set to 0 inside just
    # before it and read just after)
    pip = pippenger_phase(params, corpus, rows, beta, SERVING_N, MSM_CHUNK)
    emit({"phase": "pippenger", **pip, **card})

    # 5a'. this slice's paths: bulk proving on the card, then the device
    # Fiat-Shamir derivation of its proofs (every count set to 0 inside just
    # before each and read just after)
    proved, proofs_out = batch_prove_phase(params, PROVE_STATEMENTS, PROVE_PROOFS,
                                           PROVE_PLAIN_N, PROVE_TAMPER_EVERY, PROVE_HOST_SAMPLE)
    emit({"phase": "batch_prove", **proved, **card})
    chal = device_challenges_phase(params, proofs_out, CHALLENGE_NS, CHALLENGE_REPS,
                                   int32_ops_per_s)
    emit({"phase": "device_challenges", **chal, **card})

    # 5a''. this slice's path: ristretto DECODE on the card at two widths
    # (its count set to 0 inside just before the phase's decodes and read
    # just after), and the limbs.mul variants of CPZK_MUL
    decoded = decode_phase(dev, corpus, DECODE_NS, MUL_VARIANT_N, DECODE_REPS,
                           int32_ops_per_s, SeededRng(SEED + 31))
    emit({"phase": "decode", **decoded, **card})

    # 5b. the serving plane (its own launch counts, reset inside just before
    # the served traffic and read just after)
    plane = serving_plane(params, corpus, SERVING_N, CLOSED_LOOP_N, CLIENTS, GROUP_N)
    emit({"phase": "serving_plane", **plane, **card})

    # 5c. the login state path: the service's stages without gRPC (its own
    # launch counts, reset inside just before the login traffic)
    logins = login_state(params, corpus, provers, SERVING_N, LOGIN_RPC_MAX)
    emit({"phase": "login_state", **logins, **card})

    # 5d. the daemon: the port's entry point in subprocesses, logins over
    # loopback gRPC (launch counts read from its ops plane just before and
    # just after each wave of logins)
    served = daemon_phase(corpus, provers, SERVING_N, LOGIN_RPC_MAX, DAEMON_SHARDS)
    emit({"phase": "daemon", **served, **card})

    # 5e. the durable daemon: snapshot + WAL with fsync = "always", SIGKILL
    # mid-traffic and recovery (launch counts read around each wave)
    durable = durable_daemon_phase(corpus, provers, DURABLE_USERS, SERVING_N, LOGIN_RPC_MAX,
                                   DURABLE_HELD, DURABLE_FURTHER, DURABLE_KILL_AFTER)
    first, wave = served["first"], durable["boot_a"]["logins"]
    durable["beside_daemon_phase"] = {
        "registrations_per_s": {"daemon": first["registrations_per_s"],
                                "durable_daemon": durable["boot_a"]["registrations_per_s"]},
        "logins_per_s": {"daemon": first["logins_per_s"],
                         "durable_daemon": wave["logins_per_s"]},
        "verify_batch_rpc_latency_ms": {"daemon": first["login_rpc_latency_ms"],
                                        "durable_daemon": wave["login_rpc_latency_ms"]},
        "challenges_per_s": {"daemon": first["challenges_per_s"],
                             "durable_daemon": wave["challenges_per_s"]}}
    emit({"phase": "durable_daemon", **durable, **card})

    # 5f. the audit trail: the daemon's proof log written through the port's
    # client, replayed on the card (counts set to 0 inside just before each
    # replay and read just after), and a synthetic log's four replays
    audited = audit_phase(corpus, provers, SERVING_N, LOGIN_RPC_MAX)
    emit({"phase": "audit", **audited, **card})

    # 5g. replication and the fleet: two primary/standby pairs of daemons
    # on the card, a planned handover and a SIGKILL failover (launch counts
    # read from each daemon's ops plane just before and just after each
    # wave of logins)
    replicated = replication_phase(corpus, provers, REPL_USERS, REPL_LOGINS, LOGIN_RPC_MAX,
                                   REPL_FURTHER, REPL_KILL_AFTER)
    emit({"phase": "replication", **replicated, **card})

    # 5h. this slice's paths: two lanes and a mesh lane on the card behind
    # the batcher with a live controller; the sharded paths against one
    # device; two ranks over gloo; a daemon's controller splitting its
    # partition live.  Every count set to 0 just before each and read just
    # after (the daemons' from their ops planes around each wave).
    phase_launches = {}
    path_kernels = {"lanes": SERVED_KERNELS, "mesh": MESH_KERNELS,
                    "multihost": MULTIHOST_KERNELS, "controller": SERVED_KERNELS}
    for name, run_phase in (
            ("lanes", lambda: lanes_phase(params, corpus, SERVING_N, CLOSED_LOOP_N, CLIENTS,
                                          GROUP_N, MESH_ROWS)),
            ("mesh", lambda: mesh_phase(params, rows, beta, MESH_STATEMENTS,
                                        SeededRng(SEED + 23))),
            ("multihost", lambda: multihost_phase(MULTIHOST_ROWS)),
            ("controller", lambda: controller_phase(corpus, provers, CTL_USERS,
                                                    CTL_SPLIT_THRESHOLD,
                                                    CTL_LOGINS_PER_PARTITION,
                                                    LOGIN_RPC_MAX))):
        pk.reset_all_launches()
        result = run_phase()
        synchronize()
        phase_launches[name] = pk.all_launches()
        emit({"phase": name, **result, "launches_in_process": phase_launches[name], **card})
        if name == "controller":
            counts = {k: sum(w["launches"][k] for w in result["logins"].values())
                      for k in LADDER_KERNELS}
        elif name == "multihost":
            counts = {k: sum(r["valid_launches"][k] + r["mixed_launches"][k]
                             for r in result["ranks"]) for k in pk.kernel_names()}
        else:
            counts = phase_launches[name]
        phase_launches[name] = counts
        for k in path_kernels[name]:
            if counts[k] < 1:
                raise AssertionError(f"{k} was never launched on the {name} path")

    # 6. where the time goes
    prof = profile_combined(backend, rows[:SERVING_N], beta)
    emit({"phase": "profile", **prof, **card})
    ab = pippenger_ab(rows, beta, AB_NS, AB_REPS)
    emit({"phase": "pippenger_ab", **ab, **card})

    kernels = []
    # the point kernels: on no serving path's per-row route since the ladder
    # kernels (0 launches on the main path); the Pippenger route's chunk
    # partials and a mesh's slice partials still sum through point_add
    for name in POINT_KERNELS:
        results = kernel_rows[name]
        main_row = next(r for r in results if r["n"] == MAIN_N)
        chunk_row = next(r for r in results if r["n"] == CHUNK_4096_N)
        kernels.append({
            "name": name, "route": "cuda",
            "source": SOURCES[name][0], "sources": SOURCES[name],
            "replaces": REPLACES[name], "launches": launches[name],
            "max_abs_err": max(r["max_abs_err"] for r in results),
            "ms": main_row["ms"], "plain_ms": main_row["plain_ms"],
            "bound_ms": main_row["bound_ms"], "bound_by": main_row["bound_by"],
            "library_ms": None, "n": MAIN_N,
            f"ms_{CHUNK_4096_N}": chunk_row["ms"], f"bound_ms_{CHUNK_4096_N}": chunk_row["bound_ms"],
            "registers": per_kernel[name].get("registers"),
            "spill_bytes": per_kernel[name].get("spill_store_bytes"),
            "launches_in_pippenger": pip["launches"][name],
            "launches_per_16384_pippenger_check":
                pip["big_check"]["launches"]["pippenger_device_rlc"][name],
            "launches_in_daemon_pippenger": served["pippenger"]["launches"][name],
            "launches_in_daemon_all_valid_batch":
                served["pippenger"]["all_valid_batch"]["launches"][name],
            **{f"launches_in_{p}": phase_launches[p][name] for p in ("lanes", "mesh", "multihost")},
        })
    # the ladder kernels: the main path and every serving path's per-row route
    for name in LADDER_KERNELS:
        results = kernel_rows[name]
        timed = [r for r in results if "ms" in r]
        # a 4096-row check's shapes: the combined check's 6,144 lanes, the
        # per-row check's 4096, the 16,384-row check's two chunk totals
        main_row = timed[0]
        kernels.append({
            "name": name, "route": "cuda",
            "source": SOURCES[name][0], "sources": SOURCES[name],
            "replaces": REPLACES[name], "launches": launches[name],
            "max_abs_err": max(r["max_abs_err"] for r in results),
            "ms": main_row["ms"], "plain_ms": main_row["plain_ms"],
            "bound_ms": main_row["bound_ms"], "bound_by": main_row["bound_by"],
            "library_ms": None,
            "shape": {k: main_row[k] for k in ("n", "rows", "k", "lanes", "case")
                      if k in main_row},
            "timed": [{k: r[k] for k in ("n", "k", "case", "ms", "ms_runs", "plain_ms",
                                         "bound_ms", "bound_by", "chain_floor_ms",
                                         "launch_floor_ms") if k in r}
                      for r in timed],
            "chain_floor_ms": main_row.get("chain_floor_ms"),
            "launch_floor_ms": main_row.get("launch_floor_ms"),
            "registers": per_kernel[name].get("registers"),
            "spill_bytes": per_kernel[name].get("spill_store_bytes"),
            "launches_per_4096_verify": serving["valid_launches"][name],
            "launches_per_16384_check": star["valid_launches"][name],
            "launches_in_serving_plane": plane["launches_in_serving_plane"][name],
            "launches_in_login_state": logins["launches_in_login_state"][name],
            "launches_in_daemon": served["first"]["launches"][name],
            "launches_in_daemon_sharded": served["sharded"]["launches"][name],
            "launches_in_durable_daemon": durable["boot_a"]["logins"]["launches"][name],
            "launches_in_durable_recovery": durable["boot_b"]["logins"]["launches"][name],
            "launches_in_pippenger": pip["launches"][name],
            "launches_in_daemon_pippenger": served["pippenger"]["launches"][name],
            "launches_in_daemon_all_valid_batch":
                served["pippenger"]["all_valid_batch"]["launches"][name],
            "launches_in_audit_trail_replay": audited["trail_replay"]["launches"][name],
            "launches_in_audit_synthetic_replay": audited["A"]["launches"][name],
            "launches_in_replication_primaries":
                sum(w[name] for w in replicated["wave"]["launches"].values()),
            "launches_in_replication_promoted_b": replicated["promoted"]["b"]["launches"][name],
            "launches_in_replication_promoted_d": replicated["promoted"]["d"]["launches"][name],
            "launches_in_batch_prove_verify": proved["verify"]["valid"]["launches"][name],
            **{f"launches_in_{p}": phase_launches[p][name] for p in phase_launches},
        })
    from cpzk_tpu_torch.ops.msm_kernels import GLOBALS as MSM_GLOBALS

    for name in PIPPENGER_KERNELS:
        results = kernel_rows[name]
        timed = [r for r in results if "ms" in r]
        # the 4096-row Pippenger check's shapes: its rows, and one full chunk
        # of random digits
        main_row = next(r for r in timed if r.get("n", SERVING_N) == SERVING_N
                        and r.get("case", "random") == "random")
        kernels.append({
            "name": name, "route": "cuda",
            "source": SOURCES[name][0], "sources": SOURCES[name],
            "replaces": REPLACES[name], "launches": pip["launches"][name],
            "max_abs_err": max(r["max_abs_err"] for r in results),
            "ms": main_row["ms"], "plain_ms": main_row["plain_ms"],
            "bound_ms": main_row["bound_ms"], "bound_by": main_row["bound_by"],
            "library_ms": None,
            "shape": {k: main_row[k] for k in ("n", "lanes", "terms", "m", "chunk", "c")
                      if k in main_row},
            "timed": [{k: r[k] for k in ("n", "m", "case", "c", "ms", "ms_runs", "plain_ms",
                                         "bound_ms", "bound_by", "profiler_ms",
                                         "chain_floor_ms", "launch_floor_ms") if k in r}
                      for r in timed],
            "registers": per_kernel[name].get("registers"),
            "spill_bytes": per_kernel[name].get("spill_store_bytes"),
            "launches_in_pippenger": pip["launches"][name],
            "launches_per_16384_check": pip["big_check"]["launches"]["pippenger_device_rlc"][name],
            "launches_in_daemon_pippenger": served["pippenger"]["launches"][name],
            "launches_in_daemon_all_valid_batch":
                served["pippenger"]["all_valid_batch"]["launches"][name],
        })
        if name in ("rlc_scalars", "scalar_recode"):
            kernels[-1].update({k: main_row[k] for k in (
                "ms_runs", "timed_by", "profiler_ms", "chain_floor_ms", "launch_floor_ms")})
        if name == "scalar_recode":
            kernels[-1]["windows"] = [{"n": r["n"], **{k: r["windows"][k] for k in (
                "lanes", "ms", "ms_runs", "plain_ms", "profiler_ms", "bound_ms", "bound_by")}}
                for r in timed]
        if name in MSM_GLOBALS:
            one = next(r for r in timed if r["case"] == "one_bucket")
            kernels[-1].update({
                "ms_runs": main_row["ms_runs"], "timed_by": main_row["timed_by"],
                "globals": MSM_GLOBALS[name],
                "global_launches_per_call": main_row["global_launches_per_call"],
                "registers_by_global": per_kernel[name].get("globals"),
                "profiler": main_row["profiler"], "one_bucket_ms": one["ms"],
                "one_bucket_over_random": one["ms"] / main_row["ms"]})
            if "chain_floor" in main_row:
                kernels[-1]["chain_floor_ms"] = main_row["chain_floor"]["chain_floor_ms"]
                kernels[-1]["chain_floor"] = main_row["chain_floor"]
    # the prover's and the challenges' kernels: launches over their phase's
    # path; times at the shapes that path launches (the prover's 16,384-lane
    # tiles and its tables; the device challenges' 20,480 rows at once)
    for name in PROVER_KERNELS + CHALLENGE_KERNELS:
        results = kernel_rows[name]
        if name in CHALLENGE_KERNELS:
            main_row = chal["kernels_at_path_shape"][name]
            results = results + [main_row]
        else:
            main_row = next(r for r in results if "ms" in r and r.get("n", MAIN_N) == MAIN_N)
        launches_in = proved["launches"] if name in PROVER_KERNELS else chal["launches"]
        kernels.append({
            "name": name, "route": "cuda",
            "source": SOURCES[name][0], "sources": SOURCES[name],
            "replaces": REPLACES[name], "launches": launches_in[name],
            "max_abs_err": max(r["max_abs_err"] for r in results),
            "ms": main_row["ms"], "plain_ms": main_row["plain_ms"],
            "bound_ms": main_row["bound_ms"], "bound_by": main_row["bound_by"],
            "library_ms": None,
            "shape": {k: main_row[k] for k in ("n", "k", "rows", "generator") if k in main_row},
            "timed": [{k: r[k] for k in ("n", "ms", "plain_ms", "bound_ms", "bound_by")
                       if k in r} for r in results if "ms" in r],
            "chain_floor_ms": main_row.get("chain_floor_ms"),
            "registers": per_kernel[name].get("registers"),
            "spill_bytes": per_kernel[name].get("spill_store_bytes"),
            "launches_in_batch_prove": proved["launches"][name],
            "launches_in_device_challenges": chal["launches"][name],
        })
    for name in DECODE_KERNELS:
        results = decoded["results"]
        main_row = next(r for r in results if r["n"] == MAIN_N)
        kernels.append({
            "name": name, "route": "cuda",
            "source": SOURCES[name][0], "sources": SOURCES[name],
            "replaces": REPLACES[name], "launches": decoded["launches"][name],
            "max_abs_err": max(max(r["max_abs_err"], r["host_max_abs_err"]) for r in results),
            "ms": main_row["ms"], "plain_ms": main_row["plain_ms"],
            "bound_ms": main_row["bound_ms"], "bound_by": main_row["bound_by"],
            "library_ms": None, "shape": {"n": MAIN_N},
            "timed": [{k: r[k] for k in ("n", "ms", "plain_ms", "bound_ms", "bound_by")}
                      for r in results],
            "chain_floor_ms": decoded["chain_floor"]["ms"],
            "chain_floor": decoded["chain_floor"],
            "registers": per_kernel[name].get("registers"),
            "spill_bytes": per_kernel[name].get("spill_store_bytes"),
            "launches_in_decode": decoded["launches"][name],
        })
    emit({"phase": "done", "total_s": time.perf_counter() - t_start})
    emit({"kernels": kernels})
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one NVIDIA card and check it.

    python3 chip_smoke.py

Phases (each prints JSON lines, a phase's with `at_s`, the seconds since
the start; any failure raises and exits non-zero):

1. device  -- `nvidia-smi` name and power limit, torch and CUDA versions, then
   the tick kernel's build from raft_sim_tpu_torch/csrc (nvcc, sm_90a) with its
   seconds and the compiler's register/stack/spill report per instantiation
   (tick_kernel<index, ack, node dtype, width tier, nodes per thread, body:
   0 lean, 1 full, 2 mutant; the lean two-nodes-a-thread ones named
   wide_tick_kernel<...>), nine nvcc runs in parallel, the draw kernel's
   (K2, raft_sim_tpu_torch/csrc/draws.cu: one nvcc run, started beside them,
   its ptxas line printed too) and its race proxy's (one more), and the
   tick kernel's race proxy library (below) with them, nine more: all are
   built before any row runs on the card. PARITY_WORKERS worker processes, each with its
   own context on the card and a lower priority than nvcc, start before
   the build; the rows that time nothing -- phases 2, 2b and 3, serve (a),
   trace (a), compact (a), (d) and (e), observe (b) and (e), and the CPU
   and card legs of tools (b) and (c) -- run in them
   (those on the CPU alone beside the build), and all are done before
   phase 4 times anything (`parity_workers`' phase_end line). Their lines
   print in each phase's place and order. The draws_vs_plain rows (2c) run
   there too.
2. kernel_vs_plain -- presets config1-config5 and config3p for 64 ticks,
   config6 and config6r for 96 (config6-cap8 and the ring-LM rows carry
   the compactions), config8 for 160 (its first membership toggle is
   offered at tick 97), config9 for 96 and config10 for 128, at a batch of 200 (config1 at its
   batch of 1), config2 and config5 at a batch of 45 for 64 (a ragged last
   block of clusters at N=5 and at N=51, two nodes a thread), plus
   config6-cap8 (config6 on an
   8-slot ring with 2-entry windows and an offer every 2 ticks) for 96
   ticks: every tick, the kernel (`step_cuda`) on the card equals the plain
   PyTorch tick (`raft_batched.step_b`) on the card from the same state and
   inputs, leaf for leaf; then `simulate` through the kernel equals
   `simulate` through the plain tick for SIM_TICKS ticks (the per-tick check
   already covers the longer runs). Exact equality: the tick is
   integer-only. Over the slice-2 runs it counts restarts drawn, compactions
   (log_base advanced), InstallSnapshot sentinels sent (AppendEntries edges
   with offset -1) and redirect bounces to a down target (config6r), and
   requires each above 0. config6 itself sends no sentinel in 96 ticks at
   this batch (no follower falls 24 entries behind); config6-cap8 does. Over
   config8 and config9 it counts the slice-3 events -- config entries
   appended (a node's cfg_epoch rising), joint exits, TimeoutNow requests
   sent, transfer-sanctioned RequestVotes (req_disrupt), reads served at
   config8 and one-tick (lease) reads at config9 -- and requires each above
   0; config rollbacks (cfg_epoch falling) and removed-leader stepdowns are
   reported, not required. Over config10 it counts the slice-4 events --
   completed flushes (a node's dur_len rising), recoveries that cut a torn
   log to max(dur_len, log_len - torn_drop), term/vote rewinds to the durable
   snapshot, late vote responses and AppendEntries acks held at the
   watermark -- and requires each above 0 (jitter stalls are reported); every
   tick, every node's dur_len must stay at or below its log_len. Slice 6
   adds config4c (200 x 64), config7 (N=101: 200 x 64 and a ragged 45 x 64),
   config7's mix dense at N=128 and at N=255 under partitions (45 x 48), and
   a full-gate row at N=101 (crash churn, compaction, PreVote, membership,
   transfers, reads; 200 x 96), whose restarts, compactions, config
   appends, joint exits, TimeoutNow requests and reads must each be above 0
   (the `slice6_events` line). Slice 7 adds log matching on the compacting
   ring (K1-b): config6 and config9 with the check every tick (200 x 160 and
   200 x 400),
   config6-cap8 with it (200 x 128; its incomparable pairs,
   `lm_skipped_pairs`, must sum above 0) and config7's mix at N=101
   compacting with it (45 x 96, width tier 4, two nodes a thread); each row
   prints a `slice7_events` line and must show no log-matching violation.
   Then n5-e32-cap64 (200 x 96): AppendEntries windows of up to 32 entries,
   one above K1's old limit of 16 required (`widest_window`).
2b. race_proxy -- the kernel built with RS_RACE_PROXY (csrc/tick.cu: node
   slots and clusters-in-tile mapped to threads in reverse, each exchange
   field poisoned once its last reader's phase is over) equals the plain
   tick every tick on config1 and config7 at 1 cluster, on a ragged 45 of
   config2, config5, config3p, config6, config6r, config8, config9,
   config10, config4c, config7 and config6-cap8 with log matching, and on
   the N=128 and N=255 rows, for 32 ticks each. It stands in for a race
   checker, which the card's machine refuses.
2c. draws_vs_plain -- the draw kernel (K2, `draw_engine.draw_cuda`) on the
   card equals the plain draws (sim/faults.py `make_inputs`) on the card,
   every StepInputs leaf and fault fact, on phase 2's presets and wide mixes,
   config5c and config7x (the flat mask), config4c under a numpy-seeded
   genome (every mechanism drawn, a different setting in every cluster and
   segment) and served config9: at ticks 0, 1, 2 and around the first two
   edges of every crash and partition window, cadence and genome segment
   (`draws_ticks`), with and without the facts; on the genome row also
   per-row ticks; and one `draw_span` (DRAWS_SPAN: 16 clusters x 24 ticks,
   one launch) with its facts against the plain span. Two more rows run
   K2's race proxy (csrc/draws.cu built with RS_RACE_PROXY: a tile's rows
   and nodes mapped to threads in reverse, the staged partition side bits
   poisoned before the stage phase) on config5 and the N=255 partitioned
   mix at a ragged 45, every tick equal to the plain draws.
3. card_vs_cpu -- the port's `simulate` on the card equals the port on the CPU
   (config2, config4, config6r, config3p, config8, config9 and config10 at
   64 x 32; config7 at 16 x 32). The CPU tests hold the CPU
   port equal to the JAX package.
4. full_width -- the main path, `simulate` at the presets' own batch through the
   kernel: config2, config6, config6r, config7, config8, config9 and config10
   at 1,000 clusters, config3, config3p, config4 and config4c at 100,000, for
   128 ticks (config6 and config6r 256, config9 352 and config4c 320: their
   liveness checks need the depth), config5 at 10,000 for 128. Launch counts are zeroed just before each run
   and read just after; each must equal the tick count. Every run must have
   zero invariant violations (stale lease reads included) and a leader
   elected in every cluster, the client presets a commit in every cluster,
   config6/config6r/config9 every cluster's max commit above CAP (its ring
   wrapped), config8/config9 reads served in every cluster, config8 a config
   entry appended in some cluster (its first toggle is offered at tick
   97), and config10 an
   fsync lag in every cluster and dur_len <= log_len on every node of the
   final state. Every tick of every run draws through K2, whose launches are
   zeroed with the tick kernel's and must equal the ticks too; while it
   runs, the plain draws raise on the card (`main_path_run`). A
   `kernel_shape` line gives the launch's block shape (tc
   clusters x s node slots, nodes per thread), its dynamic shared-memory
   bytes, the gate set of the body it runs (as the kernel's library decides
   it) and ptxas's registers/stack/spills for that instantiation.
   Then, from the run's final state: FULL_HOLD_TICKS ticks
   of kernel == plain tick at full width (state and StepInfo, exact), kernel
   ms/tick (CUDA events) against its bound (bytes read + written over
   3.35 TB/s), and ms/tick for input generation (the plain draws), the
   wrapped step, the plain step and the metric fold (host clock to a
   synchronize); then K2 at the run's next tick (`draws_cell`): equal to the
   plain draws, its ms a launch (CUDA events) against its bound
   (`draw_engine.bound_ms`: the larger of the threefry blocks' instructions,
   counted from this build's SASS in phase 1 (`draws_block_ops`), over the
   ALU and issue lanes of 132 SMs at the SM clock nvidia-smi reads under the
   draws' load, the `sm_clock` line, and its bytes over 3.35 TB/s), and the
   run's ms a tick end to end. The serve (c), scenario (d), trace (c) and
   compact (c) cells report the same K2 fields. Every later run of the main
   path goes through `main_path_run` too: K2's launches must equal K1's
   wherever K1's are checked (one a span on the B=1 replays and the small
   searches, `span_launches`), and the plain draws raise on the card. Each
   phase prints both kernels' launches in its counted runs
   (`draws_launches`); those of a check or a timing are left out.
4b. long_run -- the slice-7 path at full width: config6 with log matching
   every tick at its preset batch of 1,000 through `driver.Session` and the
   kernel. `simulate` for LONG_T ticks (timed: its ms a tick); a Session run
   of 2 x LONG_T ticks in chunks of LONG_CHUNK with cluster 0's apply log
   attached (timed: the chunked run's ms a tick; launches zeroed before it
   and read after, equal to its ticks); a second Session run of LONG_T
   ticks (equal to `simulate`'s), a `save` (seconds, file size), a
   `restore` (seconds) and LONG_T more ticks, whose state and metrics must
   equal the uninterrupted run's leaf for leaf, with zero violations; every
   node's apply-log stream nonempty and in agreement with the others
   (`stream_check`: a gapless stream is a prefix of the committed values,
   each run between snapshot gaps a contiguous run of them). Then
   FULL_HOLD_TICKS ticks of kernel == plain from the final state, and the
   kernel's ms a tick with and without log matching (CUDA events, in turns)
   against its bound, and the plain tick's.
4c. serve -- the slice-8 path: the standing-fleet serve loop
   (raft_sim_tpu_torch/serve/), every served tick one launch of the kernel
   with the `serve_ingest`/`serve_reads` gates (K1-c). (a) Kernel == plain
   tick every tick under served per-cluster planes at 200 clusters x
   SERVE_T ticks: config9 under the bench's load (4 tenants, a command in
   every (tick, cluster) slot, a read every other tick), config6r, config10
   and config2 (the lean body; writes only), each split among 4 tenants;
   every tenant must have commands acked (the commit-delta stream), and on
   config9 reads served; then the race proxy on a ragged 45 of served
   config9 and config2. (b) A served config9 ServeSession on the card
   equals it on the CPU (16 clusters, a warmup and 2 serving chunks of 64):
   state, metrics, window lines and delta rows. (c) The `config9-serve`
   bench row at 1,000 clusters through ServeSession with a sink: launches
   (zeroed before, read after) equal to the ticks run, zero violations,
   every acknowledged write read back from a quorum of the final state's
   nodes (`readback_check`), the sink valid, the tenants' window lines
   summing to the fleet's; it prints ops/s, commands/s, reads/s, ms per
   chunk, ms per extraction round (CUDA events), the kernel's ms a tick
   served and unserved on the final state against its bound, the input
   draws' ms, and a `kernel_shape` line.
4d. scenario -- the slice-9 path: the scenario engine
   (raft_sim_tpu_torch/scenario/) with the TEST-ONLY mutant hooks in the
   kernel (K1-d). (a) Kernel == plain tick every tick under each of the ten
   mutation.py registry names at its corpus artifact's config (stale-read on
   config9, ignore-truncation-rollback on config8: no artifact), 200
   clusters x SCEN_T ticks, inputs on the scenario path from a numpy-seeded
   genome with a different fault setting in every cluster and two segments
   of SCEN_SEG ticks; the race proxy on a ragged 45 under blind-transfer and
   ack-before-fsync; each row reports its violating cluster-ticks, and a
   `kernel_shape` line shows blind-transfer on the mutant body. (b) Each of
   the seven tests/corpus artifacts replays through the kernel (one launch a
   tick) to its tick and kinds, past it by the event context, with the
   file's events and state lines. (c) A weak-quorum search on the JAX
   scenario tests' kitchen-sink config (16 x 128, 2 generations) on the card
   equals it on the CPU. (d) Full width on config4c: `scenario run`'s
   library path (driver.run_scenario) over a calm / storm (drop 0.2,
   partitions of period 32 at 0.3, skew 0.1) / calm program of
   STORM_RUN_SEG-tick (32) segments at the preset batch of 100,000 for 96
   ticks -- launches ==
   ticks, zero violations, a leader in every cluster, FULL_HOLD_TICKS ticks
   of kernel == plain after it, the wall ms a tick, the input draws', the
   kernel's against its bound, peak memory; then a weak-quorum hunt at a
   population of HUNT_POP, HUNT_T ticks, window HUNT_WINDOW, at most 4
   generations, which must hit; its hit is shrunk and the artifact replays
   to the identical tick through the kernel, and the real config4c on the
   hunt's last generation of genomes shows zero violations.
4e. trace -- the slice-10 path: the protocol trace plane
   (raft_sim_tpu_torch/trace/), every traced tick one launch of the kernel.
   (a) Under track_trace, the kernel on the card == the plain tick on the
   CPU (in the same parity worker, over the card's inputs) every tick on
   TRACE_ROWS (config2, config3p, config5, config6, config8, config9,
   config10 and config4c under a two-segment genome fleet; TRACE_B x
   TRACE_T): state, StepInfo and the extracted TickEvents equal, and the
   untraced config's kernel tick gives the same state; each kind's event
   count equals the CPU plain tick's and the JAX run's
   (tests/trace_kind_counts_jax.json, written by
   tests/trace_kind_counts_jax.py), and the kinds never emitted are the
   JAX run's. (b) `run --trace` (config6, 16 x 128) writes the same trace
   files on the card as on the CPU (both in the parity workers). (c) `run
   --trace` at config6's batch (TRACE_RUN: 1,000 x 128, two windows of 64,
   depth 256, doubled until no window drops an event): launches == ticks, validate() clean, the checker's history
   complete with all six properties passing; ms a tick traced and untraced
   on the same seed, the extraction's and the ring fold's ms (CUDA
   events), events written, sink bytes, the checker's seconds. (d) A
   coverage hunt (coverage fitness, guided proposals) at config4c's
   batch of 100,000, 2 generations x COV_T (64) ticks, two windows of 32,
   depth 32: 0
   violations, launches == ticks, the guided clones of generation 1 and
   its new bits, ms a tick, peak memory; then a weak-quorum coverage hunt
   at 10,000 must hit, and its shrunk artifact's checker replay must be
   rejected naming a property, with a witness. (e) Every tests/corpus
   artifact through `farm/corpus.check_artifact` both ways: the mutant
   replay rejected on a complete history naming its provenance's
   property, with a witness; the real config passing all six.
4f. compact -- the compacted carry layout (cfg.compact_planes,
   raft_sim_tpu_torch/ops/tile.py): `step_cuda` unpacks the packed carry,
   launches the kernel on the dense view and repacks (plain torch on the
   card, outside the kernel). (a) kernel == plain every leaf every tick
   under that boundary: config5c (200 x 64: log-matching ticks 16, 32, 48),
   config7x (250 x 48), the compacting config6 twin (200 x 96) and the
   N=31/32/33 fault-churn twins (64 x 48, the word boundaries). (b) compact
   == dense: config5c against config5 from one seed at 10,000 x 64, every
   tick the unpacked compacted state equal to the dense one. (c) config5c at
   10,000 x 128 and config7x at 250 x 128 through `simulate`: launches ==
   ticks, 0 violations, a leader somewhere (the clusters that never led are
   reported: N=255 under partitions leaves some leaderless); ms a tick end to end, the input
   draws, the kernel on the dense view and the unpack+pack (CUDA events),
   the bound (the dense bytes once over 3.35 TB/s), the plain tick, peak
   memory, beside config5's row of phase 4, then FULL_HOLD_TICKS of kernel
   vs plain at full width. (d) `simulate` card == CPU at config5c (16 x 32)
   and config7x (4 x 32). (e) The entry points this layout's slice added, on
   the card against the CPU: `bench --preset config5c` at 16 x 64 (quality
   equal, "layout": "compact"), `bench --preset config2 --telemetry-dir D
   --scenario P` at 64 x 100 (windows.jsonl and summary.json byte-equal),
   `scan.run` (B=1) and `scan.run_batch` (B=4) traced for 32 ticks, and
   `run --backend cuda` equal to `run --device cuda` at config7x.
4g. observe -- the observability planes (obs/ chunk timer, health/ SLO
   monitors) and the fuzzing farm (farm/). (a) `run --perf --health` at
   config6's batch (OBS_RUN: 1,000 x 192, chunks of 64, window 64, a flight
   ring of 8) equals the same run unarmed: state and metrics (--save), the
   window, flight and summary files; perf.jsonl validates with 3 rows, 2 of
   them warmup, none recompiled, live_bytes an int, the library loaded once;
   launches == ticks; the steady ms a chunk, the device-wait share and the
   armed wall beside the unarmed one. (b) The same at OBS_SMALL (16 x 128)
   on the card and on the CPU: health.jsonl, alerts.jsonl and the evidence
   bundles equal (the device-wait share and the bundles' perf rows, clock
   readings, left out); (b) and (e) run in the parity workers beside
   phase 2. (c) The config9-serve session of the serve phase (1,000 clusters, 4
   tenants, 256 warmup ticks and SERVE_CHUNKS chunks of 256) with perf= and
   health=: commands acked, reads served and the final state equal the serve
   phase's unarmed run; the bench row's `perf` filled; ops/s armed beside
   unarmed. (d) `scenario farm` on config4c under weak-quorum (scalar,
   coverage, guided; FARM_RUN: population 10,000, 192 ticks, window 64,
   depth 32; at most 4 generations, stop on a hit; a copy of tests/corpus,
   --freeze, --health): a hit found, shrunk and frozen or dedup-rejected,
   the out-dir valid; ms a generation (perf.jsonl), the host's share of it,
   K1's ms a tick on the hunt's tick at the population (CUDA events) beside
   its bound and the plain tick, after FULL_HOLD_TICKS ticks of kernel ==
   plain on that state, peak memory, launches. (e) The fresh-freeze
   farm of the CPU tests (blind-transfer, 16 x 192, 4 generations) gives the
   same manifest, hunt rows and frozen artifact on the card as on the CPU.
   (f) `run --profile DIR` at config2 8 x PROFILE_T (32) equals the
   unprofiled run and writes a trace whose kernel rows hold the tick
   kernel's launches; the card's busy share over the profiled span.
4h. shard -- the multi-device tier (raft_sim_tpu_torch/parallel/) with every
   shard on the one card (the cards in turn, where there are more): (a) config3 at 100,000 over 4 cluster shards
   (launches == 4 x 64, state and metrics == the unsharded `simulate`),
   (b) config7x at 250 x SHARD_NODE_T (16) over 4 node shards (the plain tick on each shard;
   `unshard_state` and metrics == the unsharded run; one mailbox gather a
   tick), (c) the two-process gloo check on the card (MULTIHOST_T ticks, run
   in a parity worker beside phase 2), (d) the farm's mesh
   leg (config4c weak-quorum, 2 x 64, 2 generations == unsharded). One
   card proves the partition, the key split, the padding, the exchange
   points and the multi-process control plane; not NCCL, nor copies
   between cards (`shard_phase`).
4i. tools -- a sharded Session's planes and the tools tier (`tools_phase`):
   (a) `run --devices 4 --telemetry-dir D --trace` at config6's batch
   (TOOLS_RUN: 1,000 x 32, two windows of 16, trace depth 256, the four shards on
   the one card) writes every file the
   unsharded run writes, byte for byte, with the same summary and checker
   verdict (all six properties ok); config9 at 1,000 through a 4-shard
   Session's offer/offer_read returns the unsharded Session's dicts, state
   and metrics; ms a tick both ways. (b) `device_parity_check` at its own
   sizes: the card's five runs equal the CPU's (both legs in the parity
   workers). (c) `repro.shrink` of the broken quorum (64 x 1,024, chunks of
   256) equals the CPU's; `repro --corpus tests/corpus` exits 0 (both in the
   parity workers). (d) `bench
   --measurement-pass` (config3 and config5c, A/Bs on config2, the mesh leg
   on config3; 4 ticks a row and 1 timed repeat, the matrix batches)
   rendered by
   `metrics_report --perf`, the anchor-eligible rows named, and
   `traffic_audit --json` on config3 and config7x against it.
4j. analysis -- the analyzer's runtime legs on the card (`analysis_phase`;
   raft_sim_tpu_torch/analysis): (a) `run --sanitize`'s path (a Session's run
   inside `driver.sanitize_ctx`) at config6's batch, SAN_RUN (1,000 x 128,
   chunks and telemetry windows of 32), armed against unarmed: state,
   metrics and sink files equal, the sanitizer's counters above 0, the
   caller's state bit-unchanged. (b) `serve --sanitize`'s path on a
   config9-serve session (SAN_SERVE: 1,000 clusters, 4 tenants, a warmup of
   64 and 2 chunks of 64), armed against unarmed: acks, delta rows, state
   and stats equal. (c) `check --race --dynamic --device cuda` exits 0 (in a
   parity worker). (d) `op_audit`'s programs, one tick of each audit tier's
   four variants on the card: no finding, and each program's op dtypes (its
   (op, output dtypes) histogram) equal to the CPU's; and Pass E's interval
   leg (analysis/interval.py) on the card: each tier's programs captured
   there with the CPU's op hashes, no finding, and the interval records
   (each leg's proven range, rate and horizon, `jax_differs`) equal to the
   CPU's (both in the parity workers). (e) `cost-kernel-resources`: ptxas's registers, stack and
   spills of every K1 instantiation of this build within the pins of
   tests/golden_torch_cost.json. The phase's K1 launches print with it.
5. bench_row -- the port's bench (raft_sim_tpu_torch/bench.py) on config2 at
   64 x 100 ticks, 3 quality seeds and 2 repeats, on the card and on the CPU:
   every quality field equal; the card's row carries backend "cuda", the
   card's name and its power limit.
6. The kernels line (the tick kernel K1 and the draw kernel K2), the card's
   name and power limit, and the result line.

Exits 2 without a result when torch sees no CUDA device, or when the port's
package is not beside the script (the script alone in a directory). It
imports nothing of jax and nothing of the JAX package.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import multiprocessing
import os
import shutil
import sys
import time
from concurrent.futures import ProcessPoolExecutor, ThreadPoolExecutor

HERE = os.path.dirname(os.path.abspath(__file__))
BW_BYTES_PER_S = 3.35e12  # H100 SXM HBM3 (NVIDIA data sheet)
SEED = 0
FULL_HOLD_TICKS = 8  # kernel-vs-plain ticks at full width, per cell
PARITY_WORKERS = 6  # processes for the rows that time nothing (phase 1)
LONG_T = 128  # long_run: the resumed run's half (2 x LONG_T uninterrupted; 150 before PR 15)
SIM_TICKS = 4  # phase 2: ticks of `simulate` through the kernel vs the plain tick
LONG_CHUNK = 50  # long_run's chunk: commit moves < CAP - margin a chunk
SERVE_T = 64  # serve (a): ticks of kernel vs plain under served planes
SERVE_CHUNKS = 2  # serve (c): serving chunks of the config9-serve row (3 before PR 15)
SCEN_T = 48  # scenario (a): ticks of kernel vs plain under each mutant
SCEN_SEG = 24  # scenario (a): ticks a genome segment
HUNT_POP, HUNT_T, HUNT_WINDOW = 10_000, 192, 64  # scenario (d): the weak-quorum hunt
TRACE_T, TRACE_B = 128, 200  # trace (a): ticks and clusters of kernel vs plain under track_trace
# trace (a)'s rows: presets, and config4c under a two-segment genome fleet.
TRACE_ROWS = ("config2", "config3p", "config5", "config6", "config8", "config9", "config10",
              "config4c-genome")
# The per-kind event counts of the JAX package's run of each trace (a) row
# (tests/trace_kind_counts_jax.py writes them): the card's must equal them.
TRACE_COUNTS = os.path.join("tests", "trace_kind_counts_jax.json")
TRACE_RUN = (1_000, 128, 64, 256)  # trace (c): config6's batch, ticks (192 before PR 15), window,
#   first depth
COV_POP, COV_T, COV_WINDOW, COV_DEPTH = 100_000, 64, 32, 32  # trace (d): the coverage hunt
#   (before PR 15: COV_T 128, window 64)
WQ_POP, WQ_T, WQ_WINDOW = 10_000, 192, 64  # trace (d): the weak-quorum coverage hunt's
#   population, ticks, window
OBS_RUN = (1_000, 192, 64)  # observe (a): config6's batch, ticks, chunk (3 perf rows, 2 of them
#   warmup; 256 ticks before PR 15)
OBS_SMALL = (16, 128)  # observe (b): batch, ticks of the card == CPU health run
OBS_SMALL_ARGV = ["run", "--preset", "config6", "--batch", str(OBS_SMALL[0]), "--ticks",
                  str(OBS_SMALL[1]), "--chunk", "64", "--telemetry-window", "64",
                  "--telemetry-ring", "8", "--perf", "--health"]
PROFILE_T = 32  # observe (f): ticks of the profiled config2 run
FARM_RUN = (10_000, 192, 64, 32)  # observe (d): population, ticks, window, trace depth


T_START = time.perf_counter()


def emit(obj) -> None:
    """Print `obj` as a JSON line; a phase's line gains `at_s`, the seconds
    since the script started."""
    if "phase" in obj:
        obj = {**obj, "at_s": time.perf_counter() - T_START}
    print(json.dumps(obj), flush=True)


def _leaves(tree) -> list:
    """The leaves of a NamedTuple tree (nested NamedTuples flattened)."""
    out = []
    for x in tree:
        out += _leaves(x) if isinstance(x, tuple) and hasattr(x, "_fields") else [x]
    return out


def check_equal(want, got, what: str) -> None:
    """Raise unless trees `want` and `got` agree exactly on every leaf. Two
    trees of one type whose tensor leaves pair up on one device, dtype and
    shape are compared on that device with one read back; any other pair,
    or a difference, goes through bridge.first_difference, which names it."""
    import torch
    from raft_sim_tpu_torch import bridge

    a, b = _leaves(want), _leaves(got)
    if type(want) is type(got) and len(a) == len(b) and all(
            isinstance(x, torch.Tensor) and isinstance(y, torch.Tensor) and x.device == y.device
            and x.dtype == y.dtype and x.shape == y.shape for x, y in zip(a, b)):
        if bool(torch.stack([(x == y).all() for x, y in zip(a, b)]).all()):
            return
    diff = bridge.first_difference(want, got)
    if diff is not None:
        raise AssertionError(f"{what}: {diff}")


def wall_ms(fn, reps: int) -> float:
    """Host-clock milliseconds per call of `fn`, to a synchronize."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / reps


# The slice-4 events phase 2 requires above 0 on config10 (jitter stalls are
# reported only).
SLICE4_REQUIRED = ("flushes", "torn_cuts", "rewinds", "late_votes", "ack_clamps")


# The events phase 2 requires above 0 on the full-gate row above 64 nodes.
SLICE6_REQUIRED = ("restarts", "compactions", "config_appends", "joint_exits", "timeout_now_sent",
                   "reads_served")


def n101_full_gates():
    """Phase 2's full-gate row above 64 nodes: N=101 with crash churn,
    compaction, PreVote, the reconfiguration plane, transfers and reads, so
    the wide full body's instantiations run."""
    from raft_sim_tpu_torch.utils.config import RaftConfig

    return RaftConfig(n_nodes=101, log_capacity=16, compact_margin=4, max_entries_per_rpc=4,
                      client_interval=4, pre_vote=True, reconfig_interval=23, transfer_interval=17,
                      read_interval=5, drop_prob=0.05, crash_prob=0.3, crash_period=32,
                      crash_down_ticks=8)


def count_events(cfg, t, s, inp, new, info, ev) -> None:
    """Add one tick's events to the Counter `ev`: restarts drawn, compactions
    (log_base advanced), InstallSnapshot sentinels sent and redirect bounces
    to a down target; on the reconfiguration plane config entries appended,
    rollbacks, joint exits, removed-leader stepdowns, TimeoutNow requests,
    transfer-sanctioned RequestVotes and reads served (all, and in one tick);
    on the storage plane completed flushes, recoveries that cut a torn log,
    term/vote rewinds, late vote responses, acks held at the watermark and
    jitter stalls; and the cluster-ticks that tripped an invariant. `s`/`inp` are the tick's batch-minor state and inputs,
    `new`/`info` its results. Raises if a node's dur_len passes its log_len."""
    import torch
    from raft_sim_tpu_torch import types as T
    from raft_sim_tpu_torch.ops import bitplane

    ev["restarts"] += int(inp.restarted.sum())
    if cfg.max_entries_per_rpc > 16:  # windows above K1's old limit
        ev["widest_window"] = max(ev["widest_window"], int(new.mailbox.ent_count.max()))
    ev["violation_ticks"] += int((info.viol_election_safety | info.viol_commit
                                  | info.viol_log_matching | info.viol_read_stale).sum())
    if cfg.reconfig:
        ev["config_appends"] += int((new.cfg_epoch > s.cfg_epoch).sum())
        ev["config_rollbacks"] += int((new.cfg_epoch < s.cfg_epoch).sum())
        ev["joint_exits"] += int(((s.cfg_pend > 0) & (new.cfg_pend == 0)).sum())
        ids = torch.arange(cfg.n_nodes, device=s.role.device)[:, None]
        member = bitplane.unpack(new.member_old | new.member_new, cfg.n_nodes, axis=1)
        self_in = torch.gather(member, 1, ids.expand(-1, s.role.shape[-1])[:, None]).squeeze(1)
        ev["removed_leader_stepdowns"] += int(
            ((s.role == T.LEADER) & (new.role == T.FOLLOWER) & (new.term == s.term)
             & ~inp.restarted & ~self_in).sum())
    if cfg.leader_transfer:
        ev["timeout_now_sent"] += int((new.mailbox.req_type == T.REQ_TIMEOUT_NOW).sum())
        ev["sanctioned_votes"] += int(
            ((new.mailbox.req_disrupt != 0) & (new.mailbox.req_type == T.REQ_VOTE)).sum())
    if cfg.read_index:
        ev["reads_served"] += int(info.reads_served.sum())
        ev["one_tick_reads"] += int(info.read_hist[0].sum())
    if cfg.compaction and cfg.check_log_matching:
        ev["lm_skipped_pairs"] += int(info.lm_skipped_pairs.sum())
        ev["viol_log_matching"] += int(info.viol_log_matching.sum())
    if cfg.compaction:
        ev["compactions"] += int((new.log_base > s.log_base).sum())
        sentinel = (new.mailbox.req_type == T.REQ_APPEND)[:, None, :] & (new.mailbox.req_off == -1)
        ev["snapshot_sentinels"] += int(sentinel.sum())
    if cfg.client_redirect:
        # The offer each slot held in phase 6: a fresh offer takes the first
        # free slot; an offer still pending after a tick whose target node
        # was down bounced.
        free = s.client_pend == T.NIL
        fresh = (inp.client_cmd != T.NIL)[None] & free & (free.to(torch.int32).cumsum(0) == 1)
        tgt = torch.where(fresh, inp.client_target[None], s.client_dst).long()
        down = ~torch.gather(inp.alive, 0, tgt)
        ev["redirect_bounces"] += int(((new.client_pend != T.NIL) & down).sum())
    if cfg.durable_storage:
        if bool((new.dur_len > new.log_len).any()):
            raise AssertionError(f"tick {t}: a node's dur_len passed its log_len")
        rs, torn = inp.restarted, inp.torn_drop
        ev["flushes"] += int((new.dur_len > s.dur_len).sum())
        # A restarted node receives nothing and appends nothing on its
        # restart tick, so its new log length is the recovered one.
        rec = torch.maximum(s.dur_len, s.log_len - torn)
        ev["torn_cuts"] += int((rs & (torn > 0) & (new.log_len == rec) & (rec < s.log_len)).sum())
        ev["rewinds"] += int((rs & ((s.term != s.dur_term) | (s.voted_for != s.dur_vote))).sum())
        # A vote response to a node that sent no RequestVote last tick.
        mb, mb2 = s.mailbox, new.mailbox
        late = (mb2.resp_kind == T.RESP_VOTE) & (mb.req_type != T.REQ_VOTE)[:, None, :]
        ev["late_votes"] += int(late.sum())
        acked = mb2.a_ok_to.to(torch.int32) != T.NIL
        held = acked & (mb2.a_match.to(torch.int32) == new.dur_len) & (new.dur_len < new.log_len)
        ev["ack_clamps"] += int(held.sum())
        if t % cfg.fsync_interval == 0:
            ev["jitter_stalls"] += int((inp.alive & ~inp.fsync_fire).sum())


def hold_ticks(cfg, s, keys, t0: int, n: int, what: str, events=None, proxy=False,
               genome=None, seg_len=1):
    """`n` ticks from batch-minor state `s`: each tick the kernel (with
    `proxy`, its race proxy) equals the plain tick on the card, state and
    StepInfo, leaf for leaf, on inputs the draw kernel drew. `events`, a
    Counter, accumulates the slice-2/3/4 event counts and the violating
    cluster-ticks. `genome` ([B, S] rows on the card) draws the inputs on
    the scenario path, a span of ticks at a time (scan.input_ticks)."""
    from raft_sim_tpu_torch.kernels import draw_engine, tick_engine
    from raft_sim_tpu_torch.models import raft_batched
    from raft_sim_tpu_torch.sim import scan

    drawn = (scan.input_ticks(cfg, keys, t0, n, genome, seg_len) if genome is not None
             else (draw_engine.draw_cuda(cfg, keys, t) for t in range(t0, t0 + n)))
    for t, inp in zip(range(t0, t0 + n), drawn):
        ref_s, ref_i = raft_batched.step_b(cfg, s, inp, t)
        got_s, got_i = tick_engine.step_cuda(cfg, s, inp, t, proxy=proxy)
        check_equal(ref_s, got_s, f"{what} tick {t}: step_cuda state != step_b")
        check_equal(ref_i, got_i, f"{what} tick {t}: step_cuda StepInfo != step_b")
        if events is not None:
            count_events(cfg, t, s, inp, got_s, got_i, events)
        s = got_s
    return s


def _parity_init() -> None:
    """A parity worker's start: its share of the host's threads, a lower
    priority than the kernels' nvcc runs (which the race proxy's rows wait
    for), and its context on the card, made while the main process builds
    the kernel. The worker loads the library the main process built."""
    import torch

    os.nice(10)
    torch.set_num_threads(2)
    torch.zeros(1, device="cuda")


def _fleet(cfg, batch: int):
    """A fresh batch-minor fleet on the card from SEED, and its keys."""
    import torch
    from raft_sim_tpu_torch.models import raft_batched
    from raft_sim_tpu_torch.types import init_batch
    from raft_sim_tpu_torch.utils import threefry

    dev = torch.device("cuda")
    s = raft_batched.to_batch_minor(init_batch(cfg, threefry.key(SEED, dev), batch))
    return s, threefry.split(threefry.key(SEED + 1, dev), batch)


def _parity_row(name: str, cfg, batch: int, ticks: int) -> tuple:
    """Phase 2's row `name`, in a parity worker: `ticks` ticks of kernel ==
    plain from a fresh fleet, then `simulate` through each for SIM_TICKS.
    Returns its kernel_vs_plain line and its event Counter."""
    import collections

    import torch
    from raft_sim_tpu_torch.models import raft_batched
    from raft_sim_tpu_torch.sim import scan

    dev = torch.device("cuda")
    s, keys = _fleet(cfg, batch)
    ev = collections.Counter()
    hold_ticks(cfg, s, keys, 0, ticks, name, ev)
    sim_ticks = min(ticks, SIM_TICKS)
    f_k, m_k = scan.simulate(cfg, SEED, batch, sim_ticks, device=dev)
    f_p, m_p = scan.simulate(cfg, SEED, batch, sim_ticks, device=dev, step_fn=raft_batched.step_b)
    check_equal(f_p, f_k, f"{name}: simulate state, kernel != plain")
    check_equal(m_p, m_k, f"{name}: simulate RunMetrics, kernel != plain")
    return {"phase": "kernel_vs_plain", "preset": name, "batch": batch, "ticks": ticks,
            "per_tick": "equal", "simulate_ticks": sim_ticks, "simulate": "equal", "max_abs_err": 0,
            "max_commit": int(m_k.max_commit.max()), "violations": int(m_k.violations.sum()),
            "events": dict(ev)}, ev


def _proxy_row(name: str, cfg, batch: int, ticks: int) -> dict:
    """Phase 2b's row `name`, in a parity worker: the race proxy == plain."""
    s, keys = _fleet(cfg, batch)
    hold_ticks(cfg, s, keys, 0, ticks, f"race proxy {name}", proxy=True)
    return {"phase": "race_proxy", "preset": name, "batch": batch, "ticks": ticks,
            "per_tick": "equal", "max_abs_err": 0}


def _card_vs_cpu_row(name: str, batch: int, ticks: int) -> dict:
    """Phase 3's row `name`, in a parity worker: `simulate` card == CPU."""
    from raft_sim_tpu_torch.sim import scan
    from raft_sim_tpu_torch.summary import summarize
    from raft_sim_tpu_torch.utils.config import PRESETS

    cfg, _ = PRESETS[name]
    f_g, m_g = scan.simulate(cfg, SEED, batch, ticks, device="cuda")
    f_c, m_c = scan.simulate(cfg, SEED, batch, ticks, device="cpu")
    check_equal(f_c, f_g, f"{name}: simulate state, card != CPU")
    check_equal(m_c, m_g, f"{name}: simulate RunMetrics, card != CPU")
    return {"phase": "card_vs_cpu", "preset": name, "batch": batch, "ticks": ticks,
            "max_abs_err": 0, "summary_equal": summarize(m_g) == summarize(m_c)}


# draws_vs_plain's genome rows: segments of DRAWS_SEG ticks; its spans: a
# fleet of DRAWS_SPAN[0] clusters for DRAWS_SPAN[1] ticks in one launch.
DRAWS_SEG = 8
DRAWS_SPAN = (16, 24)


def draws_rows() -> list:
    """draws_vs_plain's rows: (name, config, batch, genome seed or None,
    race proxy) -- phase 2's presets and wide mixes, config5c and config7x
    (the flat mask), config4c under a numpy-seeded genome with a different
    fault setting in every cluster and segment, and served config9; then
    K2's race proxy on config5 and the N=255 partitioned mix."""
    from raft_sim_tpu_torch.serve.loop import serve_config
    from raft_sim_tpu_torch.utils.config import PRESETS

    cfg6, cfg7 = PRESETS["config6"][0], PRESETS["config7"][0]
    rows = [(name, PRESETS[name][0], 200, None)
            for name in ("config2", "config3", "config4", "config5", "config3p", "config6",
                         "config6r", "config8", "config9", "config10", "config4c", "config7",
                         "config5c")]
    rows += [("config1", PRESETS["config1"][0], 1, None),
             ("config6-cap8", dataclasses.replace(cfg6, log_capacity=8, compact_margin=4,
                                                  max_entries_per_rpc=2, client_interval=2), 200, None),
             ("config7-mix-n128", dataclasses.replace(cfg7, n_nodes=128), 45, None),
             ("config7-mix-n255-partitions", dataclasses.replace(cfg7, n_nodes=255, partition_period=32,
                                                                 partition_prob=0.25), 45, None),
             ("n101-full-gates", n101_full_gates(), 200, None),
             ("config7x", PRESETS["config7x"][0], 250, None),
             ("config4c-genome", PRESETS["config4c"][0], 200, 3),
             ("config9-served", serve_config(PRESETS["config9"][0]), 200, None)]
    rows = [row + (False,) for row in rows]
    # K2's race proxy on the staged side bits: N=51 and N=255 partitioned.
    rows += [("config5-proxy", PRESETS["config5"][0], 45, None, True),
             ("config7-mix-n255-partitions-proxy",
              dataclasses.replace(cfg7, n_nodes=255, partition_period=32, partition_prob=0.25), 45,
              None, True)]
    return rows


def draws_ticks(cfg, seg_len: int = 0) -> list:
    """Ticks 0, 1 and 2, and the ticks around the first two edges of every
    window and cadence `cfg` runs (the crash and partition windows, the
    client, admin and fsync cadences) and of a genome's segments."""
    edges = {0, 1, 2}
    for p in (cfg.crash_period if cfg.crash_prob > 0 else 0, cfg.partition_period,
              cfg.client_interval, cfg.reconfig_interval, cfg.transfer_interval,
              cfg.read_interval, cfg.fsync_interval, seg_len):
        for m in ((p, 2 * p) if p > 0 else ()):
            edges |= {m - 1, m, m + 1}
    return sorted(edges)


def _facts_tuple(facts):
    import collections

    return collections.namedtuple("FaultFacts", "crashed cut_now cut_prev")(*facts)


def check_draws(cfg, keys, now, what: str, genome=None, seg_len: int = 1, facts=False,
                proxy=False) -> None:
    """The draw kernel (`draw_cuda`; `proxy`: its race proxy) on the card
    equals the plain draws on the card, leaf for leaf, at tick `now` (an
    int, or per-row ticks)."""
    from raft_sim_tpu_torch.kernels import draw_engine

    got = draw_engine.draw_cuda(cfg, keys, now, genome, seg_len, facts, proxy=proxy)
    want = draw_engine.draw_plain(cfg, keys, now, genome, seg_len, facts)
    if facts:
        check_equal(want[0], got[0], f"{what}: draw_cuda inputs != plain")
        check_equal(_facts_tuple(want[1]), _facts_tuple(got[1]), f"{what}: draw_cuda facts != plain")
    else:
        check_equal(want, got, f"{what}: draw_cuda inputs != plain")


def _draws_row(name: str, cfg, batch: int, genome_seed, proxy: bool = False) -> dict:
    """draws_vs_plain's row `name`, in a parity worker: at every tick of
    `draws_ticks`, with and without the facts, the draw kernel (`proxy`:
    its race proxy, which maps the tile's rows and nodes to threads in
    reverse and poisons the staged side bits before they are staged) ==
    the plain draws; on a genome row also per-row ticks; then one
    `draw_span` of a DRAWS_SPAN fleet under a three-segment genome, with
    its facts, against the plain span (its rows in the kernel's layout,
    [T, ..., B])."""
    import torch
    from raft_sim_tpu_torch.kernels import draw_engine
    from raft_sim_tpu_torch.sim import faults
    from raft_sim_tpu_torch.utils import threefry

    dev = torch.device("cuda")
    keys = threefry.split(threefry.key(SEED + 1, dev), batch)
    g = None if genome_seed is None else random_genome(cfg, batch, genome_seed, 3, dev)
    seg = DRAWS_SEG if g is not None else 1
    ticks = draws_ticks(cfg, DRAWS_SEG if g is not None else 0)
    draw_engine.draw_cuda.launches = 0
    for t in ticks:
        for facts in (False, True):
            check_draws(cfg, keys, t, f"draws {name} tick {t}", g, seg, facts, proxy)
    if g is not None:
        now = torch.tensor([ticks[k % len(ticks)] for k in range(batch)], dtype=torch.int32,
                           device=dev)
        check_draws(cfg, keys, now, f"draws {name} per-row ticks", g, seg, True)
    b_s, t_s = DRAWS_SPAN
    g_s = random_genome(cfg, b_s, 7, 3, dev)
    k_s = keys[:b_s] if batch >= b_s else threefry.split(threefry.key(SEED + 2, dev), b_s)
    got = draw_engine.draw_span(cfg, k_s, 1, t_s, g_s, DRAWS_SEG, facts=True)
    want = faults.draw_span(cfg, k_s, 1, t_s, g_s, DRAWS_SEG, facts=True)
    rows = lambda leaves: [x.movedim(1, -1) for x in leaves]  # noqa: E731
    check_equal(type(want[0])(*rows(want[0])), got[0], f"draws {name} span: inputs != plain")
    check_equal(_facts_tuple(rows(want[1])), _facts_tuple(got[1]),
                f"draws {name} span: facts != plain")
    return {"phase": "draws_vs_plain", "preset": name, "batch": batch, "ticks": ticks,
            "race_proxy": proxy, "genome": g is not None, "facts": [False, True],
            "span": {"batch": b_s, "ticks": t_s, "seg_len": DRAWS_SEG},
            "launches": draw_engine.draw_cuda.launches, "max_abs_err": 0}


SM_CLOCK = {}  # the SM clock (MHz) nvidia-smi read under the draws' load (phase 4)
BLOCK_OPS = {}  # K2's instructions a drop draw, read from this build's SASS (phase 1)
PLAIN_DRAWS = ("make_inputs", "draw_span", "trace_fault_inputs")  # sim/faults.py
MAIN_PATH = {"tick": 0, "draws": 0}  # K1's and K2's launches in phase 4's counted runs


@contextlib.contextmanager
def main_path_run(what: str):
    """One run of the main path on the card, counted: K1's and K2's launch
    counts are zeroed on entry and read on exit into the yielded `n.tick`
    and `n.draws` (and added to MAIN_PATH), and the plain draws (sim/faults.py
    PLAIN_DRAWS) raise on CUDA keys meanwhile, so a run that skips K2 fails."""
    import types

    from raft_sim_tpu_torch.kernels import draw_engine, tick_engine
    from raft_sim_tpu_torch.sim import faults

    def refuse(name, fn):
        def guarded(cfg, keys, *args, **kw):
            if keys.device.type == "cuda":
                raise AssertionError(f"{what}: the plain draws (faults.{name}) ran on the card")
            return fn(cfg, keys, *args, **kw)
        return guarded

    saved = {name: getattr(faults, name) for name in PLAIN_DRAWS}
    for name, fn in saved.items():
        setattr(faults, name, refuse(name, fn))
    n = types.SimpleNamespace(tick=0, draws=0)
    tick_engine.step_cuda.launches = draw_engine.draw_cuda.launches = 0
    try:
        yield n
    finally:
        for name, fn in saved.items():
            setattr(faults, name, fn)
        n.tick, n.draws = tick_engine.step_cuda.launches, draw_engine.draw_cuda.launches
        MAIN_PATH["tick"] += n.tick
        MAIN_PATH["draws"] += n.draws


def expect_launches(n, what: str, ticks: int, draws: int | None = None) -> None:
    """Raise unless a `main_path_run` launched K1 `ticks` times and K2
    `draws` times (default: once a tick as well)."""
    draws = ticks if draws is None else draws
    if (n.tick, n.draws) != (ticks, draws):
        raise AssertionError(f"{what}: {n.tick} tick and {n.draws} draw launches, expected "
                             f"{ticks} and {draws}")


def span_launches(batch: int, ticks: int) -> int:
    """K2's launches for `ticks` ticks of a `batch` fleet drawn a span at a
    time (scan.input_ticks: at most SPAN_ROWS rows a span)."""
    from raft_sim_tpu_torch.sim import scan

    return -(-ticks // max(1, scan.SPAN_ROWS // batch))


def draws_cell(cfg, keys, now: int, batch: int, genome=None, seg_len: int = 1,
               facts: bool = False) -> dict:
    """The draw kernel at a cell's full width, after its run: K2 == the
    plain draws at tick `now` (batch-minor, with the facts the run draws),
    then its device ms a launch (CUDA events), its bound and the counts
    behind it. Its own launches are taken back off `draw_cuda.launches`, so
    a phase's count holds its runs' alone."""
    from raft_sim_tpu_torch.kernels import draw_engine

    counted = draw_engine.draw_cuda.launches
    check_draws(cfg, keys, now, f"draws full width tick {now}", genome, seg_len, facts)
    ms = draw_engine.time_draws(cfg, keys, now, genome, seg_len, facts)
    draw_engine.draw_cuda.launches = counted  # a check's and a timing's launches are no run's
    bound = draw_engine.bound_ms(cfg, batch, now, SM_CLOCK["mhz"], genome=genome,
                                 seg_len=seg_len, facts=facts, block_ops=BLOCK_OPS)
    return {"draws_ms": ms, "draws_bound_ms": bound["bound_ms"],
            "draws_bound_by": bound["bound_by"], "draws_bound_share": bound["bound_ms"] / ms,
            "draws_bound": dict(bound, sm_clock_mhz=SM_CLOCK["mhz"]), "draws_vs_plain_tick": now}


def stream_check(writer, n_nodes: int) -> dict:
    """The apply-log streams of one cluster agree. A client value is its
    offer tick + 1, and a log holds entries in the order they were offered,
    so every node's committed values rise, and the committed sequence is the
    sorted union of what the nodes exported. Each node's file is cut into
    runs at its `# snapshot gap` lines (a node that caught up by snapshot
    never held the span): every node exports some value, each run is a
    contiguous run of that sequence, and a gapless stream is a prefix of it."""
    runs = []
    for path in writer.paths:
        cut = [[]]
        with open(path) as fh:
            for line in fh:
                if line.startswith("#"):
                    cut.append([])
                else:
                    cut[-1].append(int(line))
        runs.append([r for r in cut if r])
    ref = sorted({v for node_runs in runs for run in node_runs for v in run})
    where = {v: k for k, v in enumerate(ref)}
    gapped = [bool(writer.gaps(i)) for i in range(n_nodes)]
    for i, node_runs in enumerate(runs):
        if not node_runs:
            raise AssertionError(f"long_run: node_{i}.log holds no value")
        if not gapped[i] and where[node_runs[0][0]] != 0:
            raise AssertionError(f"long_run: node_{i}.log is gapless but starts past the first value")
        for k, run in enumerate(node_runs):
            at = where[run[0]]
            if run != ref[at:at + len(run)]:
                raise AssertionError(f"long_run: node_{i}.log run {k} is not a run of the committed values")
    return {"values_per_node": [sum(map(len, r)) for r in runs], "gapped_nodes": sum(gapped),
            "committed_values": len(ref)}


def long_run(dev, hold_ticks, wall_ms) -> dict:
    """Phase 4b: config6 with log matching at its preset batch through
    driver.Session and the kernel -- chunked runs, a checkpoint round trip
    and the apply log (see the module docstring). Returns its cell."""
    import shutil

    import torch
    from raft_sim_tpu_torch.driver import Session
    from raft_sim_tpu_torch.kernels import draw_engine, tick_engine
    from raft_sim_tpu_torch.models import raft_batched
    from raft_sim_tpu_torch.sim import scan
    from raft_sim_tpu_torch.utils.config import PRESETS

    base, batch = PRESETS["config6"]
    cfg = dataclasses.replace(base, check_log_matching=True)
    work = os.path.join(HERE, "raft_sim_tpu_torch", "build", "long_run")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    t_len = LONG_T

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    with main_path_run("long_run simulate") as n:
        (sim_s, sim_m), sim_wall = timed(lambda: scan.simulate(cfg, SEED, batch, t_len,
                                                               device=dev))
    expect_launches(n, "long_run simulate", t_len)

    whole = Session(cfg, batch=batch, seed=SEED, device=dev)
    whole.attach_apply_log(os.path.join(work, "apply_whole"), cluster=0)
    with main_path_run("long_run") as n:
        _, whole_wall = timed(lambda: whole.run(2 * t_len, chunk=LONG_CHUNK))
    expect_launches(n, "long_run", 2 * t_len)
    launches, draw_launches = n.tick, n.draws
    streams = stream_check(whole.apply_writer, cfg.n_nodes)

    half = Session(cfg, batch=batch, seed=SEED, device=dev)
    with main_path_run("long_run half") as n:
        half.run(t_len, chunk=LONG_CHUNK)
    expect_launches(n, "long_run half", t_len)
    check_equal(sim_s, half.state, "long_run: Session state != simulate")
    check_equal(sim_m, half.metrics, "long_run: Session RunMetrics != simulate")
    path, save_s = timed(lambda: half.save(os.path.join(work, "ck")))
    size = os.path.getsize(path)
    again, load_s = timed(lambda: Session.restore(path, device=dev))
    with main_path_run("long_run resumed") as n:
        again.run(t_len, chunk=LONG_CHUNK)
    expect_launches(n, "long_run resumed", t_len)
    check_equal(whole.state, again.state, "long_run: resumed state != uninterrupted")
    check_equal(whole.metrics, again.metrics, "long_run: resumed RunMetrics != uninterrupted")
    summ = whole.summary()
    if summ["total_violations"] != 0:
        raise AssertionError(f"long_run: {summ['total_violations']} violations")
    if int(whole.metrics.max_commit.min()) <= cfg.log_capacity:
        raise AssertionError("long_run: a cluster's ring never wrapped")

    # Kernel == plain at full width from the final state, then the kernel
    # with and without log matching on it, in turns.
    s = raft_batched.to_batch_minor(whole.state)
    now = 2 * t_len
    hold_ticks(cfg, s, whole.keys, now, FULL_HOLD_TICKS, "config6-lm full width")
    inp = draw_engine.draw_cuda(cfg, whole.keys, now)
    lm_ms, nolm_ms = [], []
    for _ in range(2):
        lm_ms.append(tick_engine.time_kernel(cfg, s, inp, reps=20, now=now))
        nolm_ms.append(tick_engine.time_kernel(base, s, inp, reps=20, now=now))
    plain_ms = wall_ms(lambda: raft_batched.step_b(cfg, s, inp, now), 3)
    rd, wr = tick_engine.traffic_bytes(cfg, batch)
    bound_ms = (rd + wr) / BW_BYTES_PER_S * 1e3
    shape = tick_engine.launch_shape(cfg, batch, dev)
    shape.update(tick_engine.kernel_report(cfg, s, shape["nodes_per_thread"]))
    cell = {
        "phase": "long_run", "preset": "config6-lm", "batch": batch, "ticks": 5 * t_len,
        "chunk": LONG_CHUNK, "resumed_equal": True, "violations": summ["total_violations"],
        "launches": launches, "draws_launches": draw_launches,
        "lm_skipped_pairs": summ["lm_skipped_pairs"],
        "max_commit_min": int(whole.metrics.max_commit.min()),
        "simulate_ms_per_tick": sim_wall * 1e3 / t_len,
        "chunked_ms_per_tick": whole_wall * 1e3 / (2 * t_len),
        "save_s": save_s, "load_s": load_s, "checkpoint_bytes": size,
        "kernel_ms": sum(lm_ms) / len(lm_ms), "kernel_ms_runs": lm_ms,
        "kernel_ms_without_lm": sum(nolm_ms) / len(nolm_ms), "kernel_ms_without_lm_runs": nolm_ms,
        "bound_ms": bound_ms, "bytes_read": rd, "bytes_written": wr, "plain_ms": plain_ms,
        "kernel_vs_plain_ticks": FULL_HOLD_TICKS, "apply_log": streams, "shape": shape,
    }
    emit(cell)
    del whole, half, again, s, inp, sim_s, sim_m
    shutil.rmtree(work, ignore_errors=True)
    torch.cuda.empty_cache()
    return cell


def readback_check(rows: list[dict], state, quorum: int) -> dict:
    """Every acknowledged write is held by a quorum of the final state's
    nodes: for each delta row's entry (cluster c, 1-based index i, value
    v), a node holds it if i is at or below its log_base (compacted into
    its snapshot) or its log reaches i with v in i's ring slot; at least
    `quorum` nodes must hold it, and no node whose commit index reaches i
    may keep another value there. Returns the counts checked."""
    import numpy as np

    cl, idx, val = [], [], []
    for row in rows:
        n = len(row["values"])
        cl.append(np.full(n, row["cluster"], np.int64))
        idx.append(row["start"] + np.arange(n, dtype=np.int64))
        val.append(np.asarray(row["values"], np.int64))
    cl, idx, val = (np.concatenate(x) for x in (cl, idx, val))
    log_val = state.log_val.cpu().numpy()  # [B, N, CAP]
    cap = log_val.shape[-1]
    base = state.log_base.cpu().numpy()[cl]  # [E, N]
    length = state.log_len.cpu().numpy()[cl]
    commit = state.commit_index.cpu().numpy()[cl]
    at = log_val[cl, :, (idx - 1) % cap]  # [E, N]
    live = idx[:, None] > base
    match = at == val[:, None]
    held = ~live | ((idx[:, None] <= length) & match)
    bad = live & (idx[:, None] <= commit) & ~match
    short = held.sum(axis=1) < quorum
    if bad.any() or short.any():
        e = int(np.flatnonzero(bad.any(axis=1) | short)[0])
        raise AssertionError(f"serve: acked entry (cluster {cl[e]}, index {idx[e]}, value "
                             f"{val[e]}) is held by {int(held[e].sum())} nodes, conflicts on "
                             f"{int(bad[e].sum())}")
    return {"entries": int(idx.size), "entries_uncompacted_somewhere": int(live.any(axis=1).sum()),
            "min_holders": int(held.sum(axis=1).min()) if idx.size else None}


def served_rows() -> list:
    """serve (a)'s rows: (name, served config, batch, ticks, proxy)."""
    from raft_sim_tpu_torch.serve.loop import serve_config
    from raft_sim_tpu_torch.utils.config import PRESETS

    rows = [(f"{name}-served", serve_config(PRESETS[name][0]), 200, SERVE_T, False)
            for name in ("config9", "config6r", "config10", "config2")]
    return rows + [(name, cfg, 45, 96, True) for name, cfg, *_ in rows
                   if name in ("config9-served", "config2-served")]


def served_inputs(cfg, keys, t: int, cmds, reads, k: int):
    """Tick `t`'s batch-minor inputs with row `k` of the packed command and
    read planes in place of the scheduled offers."""
    from raft_sim_tpu_torch.kernels import draw_engine

    inp = draw_engine.draw_cuda(cfg, keys, t)._replace(client_cmd=cmds[k])
    if reads is not None:
        inp = inp._replace(read_cmd=reads[k])
    return inp


def _served_row(name: str, cfg, batch: int, ticks: int, proxy: bool) -> dict:
    """serve (a)'s row `name`, in a parity worker: `ticks` ticks of kernel
    (or proxy) == plain under the bench load's planes for `batch` clusters
    split among 4 tenants. Returns its line, with the per-tenant acks and
    reads."""
    import torch
    from raft_sim_tpu_torch import bench
    from raft_sim_tpu_torch.kernels import tick_engine
    from raft_sim_tpu_torch.models import raft_batched
    from raft_sim_tpu_torch.serve import TenantRouter
    from raft_sim_tpu_torch.serve.deltas import DeltaStream

    dev = torch.device("cuda")
    router = TenantRouter(bench.serve_tenants(batch, 4, reads=cfg.read_index), batch,
                          cfg.read_index)
    cmds_np, reads_np = router.pack(ticks)
    cmds = torch.from_numpy(cmds_np).to(dev)
    reads = None if reads_np is None else torch.from_numpy(reads_np).to(dev)
    s, keys = _fleet(cfg, batch)
    served = torch.zeros(batch, dtype=torch.int64, device=dev)
    viol = 0
    for t in range(ticks):
        inp = served_inputs(cfg, keys, t, cmds, reads, t)
        ref_s, ref_i = raft_batched.step_b(cfg, s, inp, t)
        got_s, got_i = tick_engine.step_cuda(cfg, s, inp, t, proxy=proxy)
        check_equal(ref_s, got_s, f"serve {name} tick {t}: step_cuda state != step_b")
        check_equal(ref_i, got_i, f"serve {name} tick {t}: step_cuda StepInfo != step_b")
        served += got_i.reads_served
        viol += int((got_i.viol_election_safety | got_i.viol_commit | got_i.viol_log_matching
                     | got_i.viol_read_stale).sum())
        s = got_s
    router.route_deltas(DeltaStream(batch, depth=64, device=dev, batch_minor=True).drain(s))
    acked = [len(t.acked_values) for t in router.tenants]
    reads_t = [int(served[t.lo:t.hi].sum()) for t in router.tenants]
    if viol or min(acked) <= 0 or (cfg.read_index and min(reads_t) <= 0):
        raise AssertionError(f"serve {name}: violations {viol}, acked per tenant {acked}, "
                             f"reads per tenant {reads_t}")
    if proxy:
        return {"phase": "race_proxy", "preset": name, "batch": batch, "ticks": ticks,
                "per_tick": "equal", "max_abs_err": 0}
    return {"phase": "serve_kernel_vs_plain", "preset": name, "batch": batch, "ticks": ticks,
            "per_tick": "equal", "max_abs_err": 0, "acked_per_tenant": acked,
            "reads_per_tenant": reads_t}


def serve_phase(dev, wall_ms, served) -> tuple:
    """Phase 4c: the serve path (see the module docstring). `served` holds
    (a)'s lines (`_served_row`, in `served_rows` order). Returns its cell
    and (c)'s unarmed outcome (acks, reads, final state, rates), which the
    observe phase's armed run of the same session is held to."""
    import shutil

    import torch
    from raft_sim_tpu_torch import bench
    from raft_sim_tpu_torch.kernels import draw_engine, tick_engine
    from raft_sim_tpu_torch.models import raft_batched
    from raft_sim_tpu_torch.serve import ServeSession
    from raft_sim_tpu_torch.serve.loop import serve_config
    from raft_sim_tpu_torch.sim import faults
    from raft_sim_tpu_torch.utils.config import PRESETS
    from raft_sim_tpu_torch.utils.telemetry_sink import TelemetrySink, read_windows, validate

    work = os.path.join(HERE, "raft_sim_tpu_torch", "build", "serve")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)

    # ---- (a) kernel == plain under served planes, then the race proxy ------
    # The rows ran in the parity workers beside phase 2 (`_served_row`).
    for line in served:
        emit(line)

    # ---- (b) a served ServeSession, card == CPU -----------------------------
    cfg9, batch9 = PRESETS["config9"]
    small = {}
    for label, d in (("card", dev), ("cpu", torch.device("cpu"))):
        sink = TelemetrySink(os.path.join(work, label), serve_config(cfg9), seed=2, batch=16,
                             window=16, ring=0, source="serve", backend=d.type)
        sess = ServeSession(cfg9, batch=16, seed=2, chunk=64, window=16, delta_depth=16, sink=sink,
                            warmup_ticks=64, tenants=bench.serve_tenants(16, 4), device=d)
        st = sess.serve(chunks=2)
        st.pop("wall_s")
        small[label] = (sess, st)
    (g, g_st), (c, c_st) = small["card"], small["cpu"]
    if g_st != c_st:
        raise AssertionError(f"serve card_vs_cpu: stats {g_st} != {c_st}")
    check_equal(c.state, g.state, "serve card_vs_cpu: state")
    check_equal(c.metrics, g.metrics, "serve card_vs_cpu: metrics")
    if c.delta_rows != g.delta_rows:
        raise AssertionError("serve card_vs_cpu: delta rows differ")
    for f in ("windows.jsonl", "deltas.jsonl", "tenants/t0/windows.jsonl"):
        with open(os.path.join(work, "card", f), "rb") as a, open(os.path.join(work, "cpu", f), "rb") as b:
            if a.read() != b.read():
                raise AssertionError(f"serve card_vs_cpu: {f} differs")
    emit({"phase": "serve_card_vs_cpu", "preset": "config9-served", "batch": 16, "chunks": 2,
          "chunk": 64, "equal": ["state", "metrics", "stats", "delta_rows", "windows.jsonl",
                                 "deltas.jsonl", "tenants"], "max_abs_err": 0, **g_st})
    del small, g, c

    # ---- (c) the config9-serve row at full width ----------------------------
    scfg = serve_config(cfg9)
    full_dir = os.path.join(work, "full")
    sink = TelemetrySink(full_dir, scfg, seed=0, batch=batch9, window=64, ring=0, source="serve",
                         backend="cuda")
    torch.cuda.synchronize()
    with main_path_run("serve") as n:
        sess = ServeSession(cfg9, batch=batch9, seed=0, chunk=256, window=64, sink=sink,
                            warmup_ticks=256, tenants=bench.serve_tenants(batch9, 4),
                            device=dev)
        stats = sess.serve(chunks=SERVE_CHUNKS)
        torch.cuda.synchronize()
    launches, draw_launches = n.tick, n.draws
    ticks_run = (sess.warmup_chunks + sess.chunks_done) * sess.chunk
    expect_launches(n, "serve", ticks_run)
    if stats["violations"] != 0:
        raise AssertionError(f"serve: {stats['violations']} violations")
    row = bench.serve_row(sess, stats, "config9", 4, smoke=False)
    state = sess.state
    readback = readback_check(sess.delta_rows, state, scfg.quorum)
    problems = validate(full_dir)
    if problems:
        raise AssertionError(f"serve: sink invalid: {problems[:5]}")
    fleet = read_windows(full_dir)
    per = [read_windows(os.path.join(full_dir, "tenants", t.name)) for t in sess.router.tenants]
    for k, line in enumerate(fleet):
        for field in ("cmds", "reads", "msgs", "violations", "lat_cnt"):
            if line[field] != sum(p[k][field] for p in per):
                raise AssertionError(f"serve: window {k} {field}: tenants do not sum to the fleet")
    acked = [len(t.acked_values) for t in sess.router.tenants]
    reads_t = [t.reads_served for t in sess.router.tenants]
    if min(acked) <= 0 or min(reads_t) <= 0:
        raise AssertionError(f"serve: a tenant got no acks or reads ({acked}, {reads_t})")

    # The kernel on the final state: served inputs against the unserved
    # preset's, in turns, with the input draws and the bound beside them.
    s = sess._s
    now = sess.now
    cmds_np, reads_np = sess.router.pack(FULL_HOLD_TICKS)
    cmds, reads = torch.from_numpy(cmds_np).to(dev), torch.from_numpy(reads_np).to(dev)
    inp_served = served_inputs(scfg, sess.keys, now, cmds, reads, 0)
    inp_plain = draw_engine.draw_cuda(cfg9, sess.keys, now)
    served_ms, plain_cfg_ms = [], []
    for _ in range(2):
        served_ms.append(tick_engine.time_kernel(scfg, s, inp_served, reps=20, now=now))
        plain_cfg_ms.append(tick_engine.time_kernel(cfg9, s, inp_plain, reps=20, now=now))
    inputs_ms = wall_ms(lambda: faults.make_inputs(scfg, sess.keys, now), 5)
    draws = draws_cell(scfg, sess.keys, now, batch9)
    plain_ms = wall_ms(lambda: raft_batched.step_b(scfg, s, inp_served, now), 3)
    # FULL_HOLD_TICKS more served ticks at full width: kernel == plain.
    s_h = s
    for k in range(FULL_HOLD_TICKS):
        inp = served_inputs(scfg, sess.keys, now + k, cmds, reads, k)
        ref_s, ref_i = raft_batched.step_b(scfg, s_h, inp, now + k)
        got_s, got_i = tick_engine.step_cuda(scfg, s_h, inp, now + k)
        check_equal(ref_s, got_s, f"serve full width tick {now + k}: step_cuda state != step_b")
        check_equal(ref_i, got_i, f"serve full width tick {now + k}: step_cuda StepInfo != step_b")
        s_h = got_s
    rd, wr = tick_engine.traffic_bytes(scfg, batch9)
    bound_ms = (rd + wr) / BW_BYTES_PER_S * 1e3
    shape = tick_engine.launch_shape(scfg, batch9, dev)
    shape.update(tick_engine.kernel_report(scfg, s, shape["nodes_per_thread"]), body="node-parallel")
    emit({"phase": "kernel_shape", "preset": "config9-served", "batch": batch9, **shape})
    syncs = sess.sync_times
    chunk_ms = (syncs[-1] - syncs[0]) * 1e3 / (len(syncs) - 1)
    kernel_ms = sum(served_ms) / len(served_ms)
    cell = {
        "phase": "serve", "preset": "config9-serve", "batch": batch9, "ticks": ticks_run,
        "launches": launches, "draws_launches": draw_launches,
        "violations": stats["violations"], "tenants": 4,
        "chunk": sess.chunk, "chunks": stats["chunks"], "warmup_chunks": stats["warmup_chunks"],
        "commands_acked": stats["commands_acked"], "reads_served": stats["reads_served"],
        "ops_per_s": row["ops_per_s"], "commands_per_s": row["commands_per_s"],
        "reads_per_s": row["reads_per_s"], "steady_ticks_per_s": row["steady_ticks_per_s"],
        "wall_s": stats["wall_s"], "ms_per_chunk": chunk_ms, "ms_per_tick": chunk_ms / sess.chunk,
        "extract_ms_per_round": row["extract_ms_per_round"],
        "extract_rounds_per_chunk": sess._drain_rounds,
        "kernel_ms": kernel_ms, "kernel_ms_runs": served_ms,
        "kernel_ms_unserved": sum(plain_cfg_ms) / len(plain_cfg_ms),
        "kernel_ms_unserved_runs": plain_cfg_ms, "bound_ms": bound_ms, "bytes_read": rd,
        "bytes_written": wr, "bound_share": bound_ms / kernel_ms, "inputs_ms": inputs_ms,
        **draws, "plain_ms": plain_ms, "acked_per_tenant": acked, "reads_per_tenant": reads_t,
        "readback": readback, "sink_valid": True, "kernel_vs_plain_ticks": FULL_HOLD_TICKS,
        "shape": shape,
        "nvidia_smi": row["nvidia_smi"],
    }
    emit(cell)
    unarmed = {"commands_acked": stats["commands_acked"], "reads_served": stats["reads_served"],
               "state": state, "ops_per_s": row["ops_per_s"], "wall_s": stats["wall_s"]}
    del sess, s, s_h, inp, inp_served, inp_plain
    shutil.rmtree(work, ignore_errors=True)
    torch.cuda.empty_cache()
    return cell, unarmed


# The kitchen-sink config of the JAX scenario tests (tests/test_scenario.py):
# every fault mechanism on, with a client.
KITCHEN_SINK = dict(n_nodes=5, log_capacity=8, client_interval=4, drop_prob=0.2,
                    partition_period=16, partition_prob=0.3, crash_prob=0.3, crash_period=32,
                    crash_down_ticks=8, clock_skew_prob=0.1)

# scenario (d): the three-segment nemesis program of the config4c run row.
STORM_PROGRAM = {
    "name": "calm-storm-calm", "seg_len": 64,
    "segments": [
        {"client_interval": 8},
        {"client_interval": 8, "drop_prob": 0.2, "partition_period": 32, "partition_prob": 0.3,
         "clock_skew_prob": 0.1},
        {"client_interval": 8},
    ],
}


# scenario (d): the run row's segment length (64 before PR 15: 192 ticks).
STORM_RUN_SEG = 32


def random_genome(cfg, batch: int, seed: int, segments: int, device):
    """A [batch, segments] genome from a numpy seed: a different fault
    setting in every cluster and segment (drop, partitions, crashes, skew,
    and the cadences and disk faults of the planes `cfg` runs)."""
    import numpy as np
    import torch
    from raft_sim_tpu_torch.scenario import genome as genome_mod

    rng = np.random.default_rng(seed)
    rows = []
    for _ in range(batch):
        segs = []
        for _ in range(segments):
            kw = dict(drop_prob=rng.uniform(0, 0.4), partition_period=int(rng.integers(0, 65)),
                      partition_prob=rng.uniform(0, 1), crash_prob=rng.uniform(0, 0.5),
                      crash_down_ticks=int(rng.integers(1, cfg.crash_period + 1)),
                      clock_skew_prob=rng.uniform(0, 0.3))
            for f, on in (("client_interval", cfg.client_interval > 0),
                          ("reconfig_interval", cfg.reconfig),
                          ("transfer_interval", cfg.leader_transfer),
                          ("read_interval", cfg.read_interval > 0)):
                if on:
                    kw[f] = int(rng.integers(1, 2 * getattr(cfg, f) + 1))
            if cfg.durable_storage:
                kw.update(fsync_interval=int(rng.integers(1, 9)),
                          fsync_jitter_prob=rng.uniform(0, 0.6), torn_tail_prob=rng.uniform(0, 0.6),
                          lost_suffix_span=int(rng.integers(1, cfg.log_capacity // 2 + 1)))
            segs.append(genome_mod.segment(**kw))
        rows.append(segs)
    g = genome_mod.ScenarioGenome(**{
        f: torch.tensor([[sg[f] for sg in r] for r in rows], dtype=genome_mod.leaf_dtype(f))
        for f in genome_mod.ScenarioGenome._fields
    })
    genome_mod.validate(cfg, g)
    return genome_mod.to_device(g, device)


def trace_rows(device):
    """trace (a)'s rows: [(name, config under track_trace, batch, ticks,
    genome or None, seg_len)], each row's state from init_batch(key(SEED))
    and its run keys split from key(SEED + 1), as phase 2's."""
    from raft_sim_tpu_torch.utils.config import PRESETS

    rows = []
    for name in TRACE_ROWS:
        preset = name.split("-")[0]
        cfg = dataclasses.replace(PRESETS[preset][0], track_trace=True)
        genome = random_genome(cfg, TRACE_B, SEED + 100, 2, device) if name.endswith(
            "-genome") else None
        rows.append((name, cfg, TRACE_B, TRACE_T, genome, TRACE_T // 2))
    return rows


def scenario_phase(dev, wall_ms, hold_ticks) -> dict:
    """Phase 4d: the scenario engine (raft_sim_tpu_torch/scenario/) on the
    card, every tick one launch of the kernel, under the mutant hooks
    (K1-d). Returns the config4c run row's cell (the main path's)."""
    import collections
    import glob

    import torch
    from raft_sim_tpu_torch import driver
    from raft_sim_tpu_torch.kernels import draw_engine, tick_engine
    from raft_sim_tpu_torch.models import raft_batched
    from raft_sim_tpu_torch.scenario import genome as genome_mod
    from raft_sim_tpu_torch.scenario import program as program_mod
    from raft_sim_tpu_torch.scenario import search as search_mod
    from raft_sim_tpu_torch.scenario import shrink as shrink_mod
    from raft_sim_tpu_torch.scenario.mutation import MUTANTS, mutant_config
    from raft_sim_tpu_torch.sim import faults, scan, telemetry
    from raft_sim_tpu_torch.summary import summarize
    from raft_sim_tpu_torch.types import init_batch
    from raft_sim_tpu_torch.utils import threefry
    from raft_sim_tpu_torch.utils.config import PRESETS, RaftConfig

    corpus = {}
    for path in sorted(glob.glob(os.path.join(HERE, "tests", "corpus", "*.json"))):
        art = shrink_mod.load_artifact(path)
        corpus[art["mutant"]] = (os.path.relpath(path, HERE), art)
    if len(corpus) != 7:
        raise AssertionError(f"scenario: {len(corpus)} corpus artifacts, expected 7")

    # ---- (a) kernel == plain every tick under each mutant, heterogeneous genomes
    rows = []
    for name in MUTANTS:
        src = "single-server-change" if name == "joint-bypass" else name
        if src in corpus:
            origin, base = corpus[src][0], RaftConfig(**corpus[src][1]["config"])
        else:  # no artifact: config9 (ReadIndex) and config8 (membership)
            origin = "config9" if name == "stale-read" else "config8"
            base = PRESETS[origin][0]
        rows.append((name, mutant_config(name, base), origin, 200, False))
    rows += [(f"{name}-proxy-b45", cfg, origin, 45, True)
             for name, cfg, origin, _, _ in rows if name in ("blind-transfer", "ack-before-fsync")]
    for k, (name, cfg, origin, batch, proxy) in enumerate(rows):
        g = random_genome(cfg, batch, SEED + k, 2, dev)
        s = raft_batched.to_batch_minor(init_batch(cfg, threefry.key(SEED, dev), batch))
        keys = threefry.split(threefry.key(SEED + 1, dev), batch)
        ev = collections.Counter()
        s = hold_ticks(cfg, s, keys, 0, SCEN_T, f"scenario {name}", ev, proxy=proxy, genome=g,
                       seg_len=SCEN_SEG)
        emit({"phase": "scenario_kernel_vs_plain", "mutant": name, "config": origin,
              "batch": batch, "ticks": SCEN_T, "segments": 2, "seg_len": SCEN_SEG,
              "race_proxy": proxy, "per_tick": "equal", "max_abs_err": 0,
              "violation_ticks": ev["violation_ticks"], "restarts": ev["restarts"]})
        if name == "blind-transfer":
            shape = tick_engine.launch_shape(cfg, batch, dev)
            shape.update(tick_engine.kernel_report(cfg, s, shape["nodes_per_thread"]))
            emit({"phase": "kernel_shape", "preset": f"{origin} blind-transfer", "batch": batch,
                  **shape})
            if shape["gate_set"] != "mutant":
                raise AssertionError(f"scenario: blind-transfer ran the {shape['gate_set']} body")

    # ---- (b) the corpus through the kernel ---------------------------------
    replayed = 0
    for mutant, (path, art) in sorted(corpus.items()):
        # Past the violation by the artifact's event context, so the events
        # after it come back too (the file's stop where its hunt's run did).
        horizon = art["tick"] + 31
        t0 = time.perf_counter()
        with main_path_run(f"scenario corpus {path}") as n:
            rep = shrink_mod.replay_artifact(art, horizon=horizon, device=dev)
        wall = time.perf_counter() - t0
        expect_launches(n, f"scenario corpus {path}", horizon, span_launches(1, horizon))
        last = max(t for t, _ in art["events"])
        events = [[t, e] for t, e in rep["events"] if t <= last]
        ok = (rep["tick"] == art["tick"] and rep["kinds"] == art["kinds"]
              and events == art["events"] and rep["state_lines"] == art["state_lines"])
        if not ok:
            raise AssertionError(f"scenario corpus {path}: tick {rep['tick']} {rep['kinds']}, "
                                 f"expected {art['tick']} {art['kinds']}, events or state lines")
        replayed += horizon
        emit({"phase": "scenario_corpus", "artifact": path, "mutant": mutant, "tick": rep["tick"],
              "kinds": rep["kinds"], "events": len(events), "state_lines": "equal",
              "horizon": horizon, "launches": horizon, "draws_launches": n.draws,
              "wall_s": wall})

    # ---- (c) a search on the card equals it on the CPU ----------------------
    ks = mutant_config("weak-quorum", RaftConfig(**KITCHEN_SINK))
    spec = search_mod.SearchSpec(generations=2, population=16, ticks=128, window=32, seed=SEED)
    with main_path_run("scenario search") as n:
        res_g = search_mod.search(ks, spec, device=dev)
    gens = len(res_g.generations)  # a hit stops the search
    expect_launches(n, "scenario search", 128 * gens, gens * span_launches(16, 128))
    res_c = search_mod.search(ks, spec, device="cpu")
    if res_g.to_json() != res_c.to_json():
        raise AssertionError("scenario search: card != CPU")
    emit({"phase": "scenario_card_vs_cpu", "mutant": "weak-quorum", "population": 16,
          "ticks": 128, "generations": len(res_g.generations), "hit": res_g.hit is not None,
          "equal": ["generations", "hit", "spec"], "max_abs_err": 0})

    # ---- (d) full width: a program run and a hunt on config4c ---------------
    cfg4c, batch = PRESETS["config4c"]
    prog = program_mod.from_dict(dict(STORM_PROGRAM, seg_len=STORM_RUN_SEG), cfg4c)
    run_t = prog.seg_len * prog.n_segments
    state, keys = scan.seed_fleet(cfg4c, SEED, batch, dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with main_path_run("scenario run") as n:
        final, metrics = driver.run_scenario(cfg4c, prog, run_t, state, keys,
                                             chunk=prog.seg_len)
        summ = summarize(metrics)  # copies to the host: waits for the device
    wall = time.perf_counter() - t0
    launches, draw_launches = n.tick, n.draws
    peak = torch.cuda.max_memory_allocated()
    expect_launches(n, "scenario run", run_t)
    if summ.total_violations != 0:
        raise AssertionError(f"scenario run: {summ.total_violations} violations")
    if int((metrics.first_leader_tick >= scan.NEVER).sum()) != 0:
        raise AssertionError("scenario run: a cluster never elected a leader")
    g = genome_mod.to_device(genome_mod.broadcast(prog.genome, batch), dev)
    s = raft_batched.to_batch_minor(final)
    hold_ticks(cfg4c, s, keys, run_t, FULL_HOLD_TICKS, "scenario run full width", genome=g,
               seg_len=prog.seg_len)
    storm = prog.seg_len  # the storm segment's first tick: every mechanism draws
    inp = draw_engine.draw_cuda(cfg4c, keys, storm, genome=g, seg_len=prog.seg_len)
    inputs_ms = wall_ms(lambda: faults.make_inputs(cfg4c, keys, storm, genome=g,
                                                   seg_len=prog.seg_len), 5)
    draws = draws_cell(cfg4c, keys, storm, batch, genome=g, seg_len=prog.seg_len)
    kernel_ms = tick_engine.time_kernel(cfg4c, s, inp, reps=20, now=run_t)
    plain_ms = wall_ms(lambda: raft_batched.step_b(cfg4c, s, inp, run_t), 3)
    rd, wr = tick_engine.traffic_bytes(cfg4c, batch)
    bound_ms = (rd + wr) / BW_BYTES_PER_S * 1e3
    run_cell = {
        "phase": "scenario_run", "preset": "config4c-storm", "program": prog.name, "batch": batch,
        "ticks": run_t, "segments": prog.n_segments, "seg_len": prog.seg_len,
        "launches": launches, "draws_launches": draw_launches,
        "violations": summ.total_violations,
        "wall_s": wall, "wall_ms_per_tick": wall * 1e3 / run_t,
        "inputs_ms": inputs_ms, **draws, "kernel_ms": kernel_ms, "bound_ms": bound_ms,
        "bound_share": bound_ms / kernel_ms, "plain_ms": plain_ms, "bytes_read": rd,
        "bytes_written": wr, "peak_mem_bytes": peak, "kernel_vs_plain_ticks": FULL_HOLD_TICKS,
        "max_term": summ.max_term, "total_cmds": summ.total_cmds,
    }
    emit(run_cell)
    del final, metrics, s, inp, g, state
    torch.cuda.empty_cache()

    pop, hunt_t, window = HUNT_POP, HUNT_T, HUNT_WINDOW
    wq = mutant_config("weak-quorum", cfg4c)
    spec = search_mod.SearchSpec(generations=4, population=pop, ticks=hunt_t, window=window,
                                 seed=SEED, stop_on_hit=True)
    last = {}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with main_path_run("scenario hunt") as n:
        res = search_mod.search(wq, spec, device=dev,
                                on_generation=lambda gen, g, seed: last.update(genome=g,
                                                                               seed=seed))
    hunt_wall = time.perf_counter() - t0
    hunt_launches, hunt_draws = n.tick, n.draws
    hunt_peak = torch.cuda.max_memory_allocated()
    expect_launches(n, "scenario hunt", hunt_t * len(res.generations))
    if res.hit is None:
        raise AssertionError(f"scenario hunt: weak-quorum survived {res.generations}")
    t0 = time.perf_counter()
    with main_path_run("scenario shrink") as n:
        art = shrink_mod.shrink(wq, res.hit, mutant="weak-quorum", device=dev)
    shrink_wall = time.perf_counter() - t0
    shrink_launches, shrink_draws = n.tick, n.draws
    if shrink_draws <= 0 or shrink_draws > shrink_launches:  # a span of ticks a trial
        raise AssertionError(f"scenario shrink: {shrink_draws} draw launches for "
                             f"{shrink_launches} ticks")
    rep = shrink_mod.replay_artifact(art, device=dev)
    if not rep["reproduced"] or rep["tick"] != art["tick"]:
        raise AssertionError(f"scenario hunt: the artifact replayed to {rep['tick']} "
                             f"{rep['kinds']}, expected {art['tick']} {art['kinds']}")
    # The real config on the hunt's last generation of genomes: clean.
    g_last = genome_mod.to_device(last["genome"], dev)
    final, m_real, _, _ = telemetry.simulate_windowed(cfg4c, last["seed"], pop, hunt_t, window,
                                                      genome=g_last, device=dev)
    real_viol = int(m_real.violations.sum())
    if real_viol != 0:
        raise AssertionError(f"scenario hunt: the real config4c broke on the last generation "
                             f"({real_viol} violating cluster-ticks)")
    keys = scan.seed_fleet(cfg4c, last["seed"], pop, dev)[1]
    s = raft_batched.to_batch_minor(final)
    inp = draw_engine.draw_cuda(wq, keys, hunt_t, genome=g_last)
    inputs_ms = wall_ms(lambda: faults.make_inputs(wq, keys, hunt_t, genome=g_last), 5)
    draws = draws_cell(wq, keys, hunt_t, pop, genome=g_last)
    kernel_ms = tick_engine.time_kernel(wq, s, inp, reps=20, now=hunt_t)
    plain_ms = wall_ms(lambda: raft_batched.step_b(wq, s, inp, hunt_t), 3)
    rd, wr = tick_engine.traffic_bytes(wq, pop)
    hunt_bound = (rd + wr) / BW_BYTES_PER_S * 1e3
    emit({"phase": "scenario_hunt", "preset": "config4c", "mutant": "weak-quorum",
          "population": pop, "ticks": hunt_t, "window": window,
          "generations": len(res.generations), "hit": {k: res.hit[k] for k in (
              "seed", "cluster", "first_viol_tick")},
          "violating_clusters": [gn["violating_clusters"] for gn in res.generations],
          "launches": hunt_launches, "draws_launches": hunt_draws, "wall_s": hunt_wall,
          "wall_ms_per_tick": hunt_wall * 1e3 / (hunt_t * len(res.generations)),
          "shrink": {"tick": art["tick"], "kinds": art["kinds"], "removed": art["removed"],
                     "launches": shrink_launches, "draws_launches": shrink_draws,
                     "wall_s": shrink_wall},
          "replay": {"reproduced": rep["reproduced"], "tick": rep["tick"]},
          "real_config_violations": real_viol, "inputs_ms": inputs_ms, **draws,
          "kernel_ms": kernel_ms,
          "bound_ms": hunt_bound, "bound_share": hunt_bound / kernel_ms, "plain_ms": plain_ms,
          "bytes_read": rd, "bytes_written": wr, "peak_mem_bytes": hunt_peak,
          "corpus_ticks_replayed": replayed})
    del final, m_real, s, inp, g_last, last
    torch.cuda.empty_cache()
    return run_cell


def _cli(argv) -> dict:
    """Run `python -m raft_sim_tpu_torch` in process with `argv`; returns the
    summary JSON line it prints (its other output is dropped)."""
    import contextlib
    import io

    from raft_sim_tpu_torch import __main__ as cli

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(argv)
    if rc != 0:
        raise AssertionError(f"{argv}: exit {rc}")
    return json.loads(buf.getvalue().strip().splitlines()[-1])


def _cpu_row(cfg, s, ticks):
    """trace (a)'s plain tick on the CPU over one row's card-drawn inputs: each tick's state, StepInfo and TickEvents must
    equal the kernel's on the card. `s` and `ticks` ((t, inputs, fault facts,
    the card's (state, StepInfo, TickEvents))) are numpy trees, batch-minor.
    Returns the per-kind event counts."""
    import torch
    from raft_sim_tpu_torch.models import raft_batched
    from raft_sim_tpu_torch.trace import events as tev

    def tensors(tree):
        return raft_batched._map(torch.from_numpy, tree)

    kinds = torch.from_numpy(tev.slot_kinds(cfg.n_nodes)).long()
    counts = torch.zeros(tev.N_KINDS, dtype=torch.int64)
    s = tensors(s)
    for t, inp, facts, card in ticks:
        inp = tensors(inp)
        s2, info = raft_batched.step_b(cfg, s, inp, t)
        ev = tev.extract(cfg, s, s2, inp, info, *(torch.from_numpy(x) for x in facts))
        for part, want, got in zip(("state", "StepInfo", "TickEvents"), (s2, info, ev), card):
            check_equal(want, tensors(got), f"tick {t}: the kernel's {part} != the CPU plain tick's")
        counts.index_add_(0, kinds, ev.flags.sum(dim=1))
        s = s2
    return counts


def _trace_row(name: str) -> tuple:
    """trace (a)'s row `name`, in a parity worker: every tick under
    track_trace the kernel on the card (its state equal to the untraced
    config's kernel tick) and the extraction of its TickEvents, then the
    plain tick on the CPU over the card's inputs (`_cpu_row`). Returns
    (batch, ticks, genome or not, the card's and the CPU's per-kind event
    counts, the row's seconds)."""
    import torch
    from raft_sim_tpu_torch.kernels import draw_engine, tick_engine
    from raft_sim_tpu_torch.sim import scan
    from raft_sim_tpu_torch.trace import events as tev
    from raft_sim_tpu_torch.utils import device as device_mod

    def host(tree):
        """A tree (NamedTuples and lists) of tensors as numpy arrays."""
        return device_mod.host_numpy(*device_mod.to_host_async(tree))

    t_row = time.perf_counter()
    dev = torch.device("cuda")
    _, cfg, batch, ticks, genome, seg_len = next(r for r in trace_rows(dev) if r[0] == name)
    untraced = dataclasses.replace(cfg, track_trace=False)
    s, keys = _fleet(cfg, batch)
    s0 = host(s)
    kinds = torch.from_numpy(tev.slot_kinds(cfg.n_nodes)).long().to(dev)
    counts = torch.zeros(tev.N_KINDS, dtype=torch.int64, device=dev)
    drawn = (scan.input_ticks(cfg, keys, 0, ticks, genome, seg_len, trace=True)
             if genome is not None else None)
    cpu_ticks = []
    for t in range(ticks):
        inp, facts = next(drawn) if drawn is not None else draw_engine.draw_cuda(cfg, keys, t,
                                                                                 facts=True)
        facts = list(facts)
        got_s, got_i = tick_engine.step_cuda(cfg, s, inp, t)
        got_e = tev.extract(cfg, s, got_s, inp, got_i, *facts)
        check_equal(tick_engine.step_cuda(untraced, s, inp, t)[0], got_s,
                    f"trace {name} tick {t}: traced state != untraced")
        counts.index_add_(0, kinds, got_e.flags.sum(dim=1))
        inp_h, facts_h, s_h, i_h, e_h = host([inp, facts, got_s, got_i, got_e])
        cpu_ticks.append((t, inp_h, facts_h, (s_h, i_h, e_h)))
        s = got_s
    try:
        counts_cpu = _cpu_row(cfg, s0, cpu_ticks)
    except AssertionError as ex:
        raise AssertionError(f"trace {name}: {ex}") from None
    by_kind = lambda c: {k: int(c[code]) for k, code in sorted(tev.KINDS.items())}  # noqa: E731
    return (batch, ticks, genome is not None, by_kind(counts.cpu()), by_kind(counts_cpu),
            time.perf_counter() - t_row)


def _trace_files(directory: str) -> dict:
    """{name: bytes} of a sink directory's trace files."""
    out = {}
    for name in ("trace.jsonl", "trace_windows.jsonl", "trace_meta.json"):
        with open(os.path.join(directory, name), "rb") as f:
            out[name] = f.read()
    return out


TRACE_SMALL_ARGV = ["run", "--preset", "config6", "--batch", "16", "--ticks", "128", "--seed",
                    str(SEED), "--telemetry-window", "64", "--trace", "--trace-depth", "256"]


def _trace_small_leg(device: str, work: str) -> dict:
    """trace (b) on `device` ("cuda" or "cpu"), in a parity worker: `run
    --trace` at TRACE_SMALL_ARGV's 16 x 128; returns its trace files."""
    tdir = os.path.join(work, f"trace_b_{device}")
    _cli([*TRACE_SMALL_ARGV, "--telemetry-dir", tdir, "--device", device])
    return _trace_files(tdir)


def trace_phase(dev, wall_ms, trace_a, trace_b) -> list:
    """Phase 4e: the protocol trace plane (raft_sim_tpu_torch/trace/) on the
    card, every traced tick one launch of the kernel. `trace_a` holds (a)'s
    rows' results (`_trace_row`, in TRACE_ROWS order), `trace_b` (b)'s trace
    files on the card and on the CPU ({"cuda": ..., "cpu": ...},
    `_trace_small_leg`). Returns the cells of its main-path runs ((c) and
    (d)), each with its launches."""
    import collections
    import glob
    import shutil
    import tempfile

    import torch
    from raft_sim_tpu_torch.farm import corpus as corpus_mod
    from raft_sim_tpu_torch.kernels import draw_engine, tick_engine
    from raft_sim_tpu_torch.models import raft_batched
    from raft_sim_tpu_torch.scenario import search as search_mod
    from raft_sim_tpu_torch.scenario import shrink as shrink_mod
    from raft_sim_tpu_torch.scenario.mutation import mutant_config
    from raft_sim_tpu_torch.sim import faults, scan
    from raft_sim_tpu_torch.trace import checker, history
    from raft_sim_tpu_torch.trace import events as tev
    from raft_sim_tpu_torch.trace import ring as tring
    from raft_sim_tpu_torch.utils import telemetry_sink
    from raft_sim_tpu_torch.utils.config import PRESETS

    cells = []
    work = tempfile.mkdtemp(prefix="trace_", dir=HERE)

    # ---- (a) kernel == plain under track_trace, TickEvents included --------
    # The rows ran in the parity workers beside phase 2 (`_trace_row`).
    with open(os.path.join(HERE, TRACE_COUNTS)) as f:
        jax_counts = json.load(f)
    totals = collections.Counter()
    for name, (batch, ticks, genomed, card, on_cpu, _) in zip(TRACE_ROWS, trace_a):
        if card != on_cpu:
            raise AssertionError(f"trace {name}: event counts card {card} != CPU {on_cpu}")
        if card != jax_counts[name]["counts"]:
            raise AssertionError(f"trace {name}: event counts {card} != the JAX run's "
                                 f"{jax_counts[name]['counts']} ({TRACE_COUNTS})")
        totals.update(card)
        emit({"phase": "trace_kernel_vs_plain", "preset": name, "batch": batch, "ticks": ticks,
              "genome": genomed, "per_tick": "equal", "plain": "cpu",
              "equal": ["state", "info", "events", "untraced_state"], "max_abs_err": 0,
              "events": sum(card.values()), "counts": card, "counts_cpu": "equal",
              "counts_jax": "equal"})
    never = sorted(k for k in tev.KINDS if totals[k] == 0)
    jax_never = sorted(k for k in tev.KINDS
                       if sum(r["counts"][k] for r in jax_counts.values()) == 0)
    if never != jax_never:
        raise AssertionError(f"trace: kinds never emitted {never}, the JAX run's {jax_never}")
    emit({"phase": "trace_kinds", "rows": list(TRACE_ROWS), "totals": dict(sorted(totals.items())),
          "never_emitted": never, "jax_never_emitted": jax_never,
          "worker_seconds": sum(r[-1] for r in trace_a)})

    # ---- (b) run --trace on the card == on the CPU (in the parity workers) ----
    if trace_b["cuda"] != trace_b["cpu"]:
        raise AssertionError("trace (b): the card's trace files != the CPU's")
    emit({"phase": "trace_card_vs_cpu", "preset": "config6", "batch": 16, "ticks": 128,
          "equal": sorted(trace_b["cuda"]),
          "bytes": {k: len(v) for k, v in trace_b["cuda"].items()}, "max_abs_err": 0,
          "in_worker": True})

    # ---- (c) run --trace at config6's own batch ------------------------------
    batch, ticks, window, depth = TRACE_RUN
    cfg6 = dataclasses.replace(PRESETS["config6"][0], track_trace=True)
    base = ["run", "--preset", "config6", "--batch", str(batch), "--ticks", str(ticks),
            "--seed", str(SEED), "--telemetry-window", str(window), "--device", dev.type]
    while True:
        tdir = os.path.join(work, f"c_depth{depth}")
        t0 = time.perf_counter()
        with main_path_run("trace run") as n:
            out = _cli([*base, "--telemetry-dir", tdir, "--trace", "--trace-depth", str(depth)])
        wall = time.perf_counter() - t0
        launches, draw_launches = n.tick, n.draws
        with open(os.path.join(tdir, "trace_windows.jsonl")) as f:
            dropped = sum(json.loads(line)["dropped"] for line in f)
        if not dropped:
            break
        emit({"phase": "trace_run_overflow", "depth": depth, "dropped": dropped})
        depth *= 2
    expect_launches(n, "trace run", ticks)
    if out["total_violations"] != 0:
        raise AssertionError(f"trace run: {out['total_violations']} violations")
    errors = telemetry_sink.validate(tdir)
    if errors:
        raise AssertionError(f"trace run: validate() {errors[:4]}")
    t0 = time.perf_counter()
    hist = history.load(tdir)
    rep = checker.check_history(hist)
    check_s = time.perf_counter() - t0
    if not (rep.complete and rep.ok and all(r.ok is True for r in rep.results.values())):
        raise AssertionError(f"trace run: checker {rep.to_dict()['violated']}, complete "
                             f"{rep.complete}: {[r.note for r in rep.results.values()][:2]}")
    udir = os.path.join(work, "c_untraced")
    t0 = time.perf_counter()
    with main_path_run("trace run untraced") as n:
        out_u = _cli([*base, "--telemetry-dir", udir])
    wall_u = time.perf_counter() - t0
    expect_launches(n, "trace run untraced", ticks)
    for k in ("total_violations", "max_term", "total_msgs", "total_cmds"):
        if out_u[k] != out[k]:
            raise AssertionError(f"trace run: untraced {k} {out_u[k]} != traced {out[k]}")
    # The extraction and the ring fold on a full-width mid-run state (CUDA events).
    state, keys = scan.seed_fleet(cfg6, SEED, batch, dev)
    s = raft_batched.to_batch_minor(state)
    m = raft_batched.to_batch_minor(scan.init_metrics_batch(batch, dev))
    t_mid = window
    for t in range(t_mid):
        s, m, _ = scan.tick_batch_minor(cfg6, s, keys, m, t)
    inp, facts = draw_engine.draw_cuda(cfg6, keys, t_mid, facts=True)
    s2, info = tick_engine.step_cuda(cfg6, s, inp, t_mid)
    spec = tring.TraceSpec(depth=depth)
    tw, tp = tring.init_window(spec, batch, dev), tring.init_persist(spec, batch, dev)

    def events_ms(fn, reps=20):
        fn()
        torch.cuda.synchronize()
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        b.synchronize()
        return a.elapsed_time(b) / reps

    ev = tev.extract(cfg6, s, s2, inp, info, *facts)
    extract_ms = events_ms(lambda: tev.extract(cfg6, s, s2, inp, info, *facts))
    record_ms = events_ms(lambda: tring.record(cfg6, spec, tw, tp, ev, s.now))
    inputs_ms = wall_ms(lambda: faults.make_inputs(cfg6, keys, t_mid), 5)
    inputs_facts_ms = wall_ms(lambda: faults.make_inputs(cfg6, keys, t_mid, facts=True), 5)
    draws = draws_cell(cfg6, keys, t_mid, batch, facts=True)
    kernel_ms = tick_engine.time_kernel(cfg6, s, inp, reps=20, now=t_mid)
    plain_ms = wall_ms(lambda: raft_batched.step_b(cfg6, s, inp, t_mid), 3)
    sizes = {f: os.path.getsize(os.path.join(tdir, f)) for f in sorted(os.listdir(tdir))}
    with open(os.path.join(tdir, "trace.jsonl"), "rb") as f:
        n_events = sum(1 for _ in f)
    rd, wr = tick_engine.traffic_bytes(cfg6, batch)
    run_cell = {
        "phase": "trace_run", "preset": "config6", "batch": batch, "ticks": ticks,
        "window": window, "depth": depth, "launches": launches,
        "draws_launches": draw_launches, "dropped": 0,
        "validate": "clean", "checker": {"complete": rep.complete, "ok": rep.ok,
                                         "properties": list(rep.results)},
        "wall_s": wall, "ms_per_tick": wall * 1e3 / ticks,
        "wall_s_untraced": wall_u, "ms_per_tick_untraced": wall_u * 1e3 / ticks,
        "extract_ms": extract_ms, "record_ms": record_ms, "inputs_ms": inputs_ms,
        "inputs_with_facts_ms": inputs_facts_ms, **draws, "kernel_ms": kernel_ms,
        "bound_ms": (rd + wr) / BW_BYTES_PER_S * 1e3, "plain_ms": plain_ms,
        "events_written": n_events, "sink_bytes": sizes, "checker_s": check_s,
    }
    emit(run_cell)
    cells.append(dict(run_cell, preset="trace-config6", kernel_vs_plain_ticks=0))
    del s, s2, m, inp, info, ev, tw, tp, state, hist
    shutil.rmtree(work, ignore_errors=True)
    work = tempfile.mkdtemp(prefix="trace_", dir=HERE)
    torch.cuda.empty_cache()

    # ---- (d) the coverage hunt at config4c's preset batch -------------------
    cfg4c, pop = PRESETS["config4c"]
    if pop != COV_POP:
        raise AssertionError(f"config4c's preset batch is {pop}, expected {COV_POP}")
    spec = search_mod.SearchSpec(generations=2, population=pop, ticks=COV_T, window=COV_WINDOW,
                                 seed=SEED, fitness="coverage", proposal="coverage-guided",
                                 trace_depth=COV_DEPTH)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with main_path_run("coverage hunt") as n:
        res = search_mod.search(cfg4c, spec, device=dev)
    hunt_wall = time.perf_counter() - t0
    hunt_launches = n.tick
    peak = torch.cuda.max_memory_allocated()
    gens = res.generations
    if len(gens) != 2:
        raise AssertionError(f"coverage hunt: {len(gens)} generations")
    expect_launches(n, "coverage hunt", COV_T * len(gens))
    if res.hit is not None or any(g["violating_clusters"] for g in gens):
        raise AssertionError(f"coverage hunt: the real config4c violated: {gens}")
    # Generation 1 draws guided clones iff generation 0 lit a new bit.
    guided = min(round(spec.guided_frac * pop), pop) if gens[0]["cov_new_bits"] > 0 else 0
    if guided <= 0:
        raise AssertionError("coverage hunt: generation 0 lit no coverage bit")
    hunt_cell = {
        "phase": "trace_coverage_hunt", "preset": "config4c", "population": pop,
        "ticks": COV_T, "window": COV_WINDOW, "depth": COV_DEPTH, "generations": len(gens),
        "launches": hunt_launches, "draws_launches": n.draws, "violations": 0,
        "guided_proposals_gen1": guided,
        "cov_new_bits": [g["cov_new_bits"] for g in gens],
        "cov_total_bits": gens[-1]["cov_total_bits"], "wall_s": hunt_wall,
        "ms_per_tick": hunt_wall * 1e3 / hunt_launches, "peak_mem_bytes": peak,
    }
    emit(hunt_cell)
    cells.append(dict(hunt_cell, preset="trace-coverage-config4c", batch=pop,
                      kernel_vs_plain_ticks=0))
    torch.cuda.empty_cache()

    wq = mutant_config("weak-quorum", cfg4c)
    spec = search_mod.SearchSpec(generations=4, population=WQ_POP, ticks=WQ_T, window=WQ_WINDOW,
                                 seed=SEED, fitness="coverage", proposal="coverage-guided",
                                 trace_depth=COV_DEPTH)
    t0 = time.perf_counter()
    with main_path_run("weak-quorum coverage hunt") as n:
        res = search_mod.search(wq, spec, device=dev)
    wq_wall = time.perf_counter() - t0
    wq_launches, wq_draws = n.tick, n.draws
    if res.hit is None:
        raise AssertionError(f"weak-quorum coverage hunt: no hit in {res.generations}")
    expect_launches(n, "weak-quorum coverage hunt", WQ_T * len(res.generations))
    with main_path_run("weak-quorum coverage shrink") as n:
        art = shrink_mod.shrink(wq, res.hit, mutant="weak-quorum", device=dev)
        rep = corpus_mod.check_artifact(art, device=dev)
    if not 0 < n.draws <= n.tick:  # a span of ticks a trial and a check
        raise AssertionError(f"weak-quorum coverage shrink: {n.draws} draw launches for "
                             f"{n.tick} ticks")
    if not (rep.complete and rep.violated and rep.results[rep.violated[0]].witness):
        raise AssertionError(f"weak-quorum coverage hunt: the checker did not reject the "
                             f"artifact with a witness: {rep.to_dict()}")
    emit({"phase": "trace_coverage_hunt_weak_quorum", "preset": "config4c",
          "population": WQ_POP, "ticks": WQ_T, "generations": len(res.generations),
          "launches": wq_launches, "draws_launches": wq_draws, "wall_s": wq_wall,
          "hit": {k: res.hit[k] for k in ("seed", "cluster", "first_viol_tick")},
          "cov_new_bits": [g["cov_new_bits"] for g in res.generations],
          "shrunk": {"tick": art["tick"], "kinds": art["kinds"], "removed": art["removed"]},
          "checker": {"complete": rep.complete, "violated": rep.violated,
                      "witness": rep.results[rep.violated[0]].witness}})
    torch.cuda.empty_cache()

    # ---- (e) the corpus checker on the card, both ways -----------------------
    paths = sorted(glob.glob(os.path.join(HERE, "tests", "corpus", "*.json")))
    if len(paths) != 7:
        raise AssertionError(f"trace corpus: {len(paths)} artifacts, expected 7")
    t_e = time.perf_counter()
    replayed = 0
    for path in paths:
        art = shrink_mod.load_artifact(path)
        prop = art["provenance"]["checker_property"]
        horizon = -(-int(art["ticks"]) // 64) * 64
        verdicts = {}
        for real in (False, True):
            with main_path_run(f"trace corpus {path}") as n:
                rep = corpus_mod.check_artifact(art, real=real, device=dev)
            expect_launches(n, f"trace corpus {path}", horizon, span_launches(1, horizon))
            replayed += horizon
            if not rep.complete:
                raise AssertionError(f"trace corpus {path}: incomplete history ({rep.problems})")
            if real and not (rep.ok and all(r.ok is True for r in rep.results.values())):
                raise AssertionError(f"trace corpus {path}: the real config failed {rep.violated}")
            if not real and not (rep.violated and rep.violated[0] == prop
                                 and rep.results[prop].witness):
                raise AssertionError(f"trace corpus {path}: rejected {rep.violated}, expected "
                                     f"{prop} with a witness")
            verdicts["real" if real else "mutant"] = rep.violated or "all six pass"
        emit({"phase": "trace_corpus", "artifact": os.path.relpath(path, HERE),
              "mutant": art["mutant"], "checker_property": prop, "horizon": horizon,
              "launches": 2 * horizon, **verdicts})
    emit({"phase": "trace_corpus_done", "artifacts": len(paths), "ticks_replayed": replayed,
          "seconds": time.perf_counter() - t_e})
    cells.append({"preset": "trace-corpus", "batch": 1, "launches": replayed,
                  "kernel_vs_plain_ticks": 0})
    shutil.rmtree(work, ignore_errors=True)
    return cells


# compact (a): the N=31/32/33 twins, tests/test_tile.py's fault churn.
def churn_twin(n: int):
    from raft_sim_tpu_torch.utils.config import RaftConfig

    return RaftConfig(n_nodes=n, log_capacity=8, max_entries_per_rpc=2, client_interval=2,
                      drop_prob=0.25, crash_prob=0.4, crash_period=16, crash_down_ticks=8,
                      compact_planes=True)


COMPACT_T = 128  # compact (c): full-width ticks a cell


def compact_rows() -> list:
    """compact (a)'s rows: (name, config, batch, ticks)."""
    from raft_sim_tpu_torch import types
    from raft_sim_tpu_torch.utils.config import PRESETS

    rows = [("config5c", PRESETS["config5c"][0], 200, 64),
            ("config7x", PRESETS["config7x"][0], 250, 48),
            ("config6-compact", types.compact_twin(PRESETS["config6"][0]), 200, 96)]
    return rows + [(f"n{n}-compact", churn_twin(n), 64, 48) for n in (31, 32, 33)]


def _compact_row(name: str, cfg, batch: int, ticks: int) -> dict:
    """compact (a)'s row `name`, in a parity worker: kernel == plain under
    the unpack/pack boundary, a launch a tick, the carry still packed."""
    from raft_sim_tpu_torch.kernels import tick_engine

    s, keys = _fleet(cfg, batch)
    before = tick_engine.step_cuda.launches
    s = hold_ticks(cfg, s, keys, 0, ticks, name)
    if tick_engine.step_cuda.launches - before != ticks:
        raise AssertionError(f"compact {name}: {tick_engine.step_cuda.launches - before} "
                             f"launches for {ticks} ticks")
    if s.ack_age.dim() != 2:
        raise AssertionError(f"compact {name}: the carry came back unpacked")
    return {"phase": "compact_kernel_vs_plain", "preset": name, "batch": batch, "ticks": ticks,
            "max_abs_err": 0, "packed_words": {f: list(getattr(s, f).shape[:-1])
                                               for f in ("votes", "ack_age")}}


def _compact_cpu_row(name: str, batch: int) -> dict:
    """compact (d)'s row `name`, in a parity worker: `simulate` card == CPU."""
    from raft_sim_tpu_torch.sim import scan
    from raft_sim_tpu_torch.utils.config import PRESETS

    cfg = PRESETS[name][0]
    f_g, m_g = scan.simulate(cfg, SEED, batch, 32, device="cuda")
    f_c, m_c = scan.simulate(cfg, SEED, batch, 32, device="cpu")
    check_equal(f_c, f_g, f"compact {name}: simulate state, card != CPU")
    check_equal(m_c, m_g, f"compact {name}: simulate RunMetrics, card != CPU")
    return {"phase": "compact_card_vs_cpu", "preset": name, "batch": batch, "ticks": 32,
            "max_abs_err": 0}


def _compact_bench_leg(device: str, work: str) -> tuple:
    """compact (e)'s bench runs on `device`, in a parity worker: `bench` of
    config5c at 16 x 64, and `bench --preset config2 --telemetry-dir
    --scenario` at 64 x 100. Returns (the config5c row, the config2 row, its
    windows.jsonl and summary.json bytes)."""
    from raft_sim_tpu_torch import bench
    from raft_sim_tpu_torch.utils.config import PRESETS

    row = bench.bench(PRESETS["config5c"][0], 16, 64, repeats=1, quality_seeds=3,
                      config_name="config5c", smoke=True, device=device)
    prog = os.path.join(work, f"storm_{device}.json")
    with open(prog, "w") as f:
        json.dump({**STORM_PROGRAM, "seg_len": 32}, f)
    out = os.path.join(work, device)
    doc = _cli(["bench", "--preset", "config2", "--batch", "64", "--ticks", "100", "--repeats",
                "1", "--telemetry-dir", out, "--scenario", prog, "--device", device])
    files = {}
    for fname in ("windows.jsonl", "summary.json"):
        with open(os.path.join(out, "config2", fname), "rb") as f:
            files[fname] = f.read()
    return row, doc["matrix"]["config2"], files


def _compact_scan_runs() -> dict:
    """compact (e)'s other entry points, in a parity worker: `scan.run` (B=1)
    and `scan.run_batch` (B=4) traced for 32 ticks, card == CPU, and `run
    --backend cuda` == `run --device cuda` at config7x. Returns the fields
    of (e)'s line."""
    from raft_sim_tpu_torch import types
    from raft_sim_tpu_torch.sim import scan
    from raft_sim_tpu_torch.utils import threefry
    from raft_sim_tpu_torch.utils.config import PRESETS

    cfg5c = PRESETS["config5c"][0]
    runs = {}
    for d in ("cuda", "cpu"):
        key = threefry.key(SEED + 3, d)
        one = scan.run(cfg5c, types.init_state(cfg5c, key), threefry.key(SEED + 4, d), 32,
                       trace_states=True)
        many = scan.run_batch(cfg5c, types.init_batch(cfg5c, key, 4),
                              threefry.split(threefry.key(SEED + 4, d), 4), 32, trace=True)
        runs[d] = (*one[:2], *one[2], *many)
    for part, want, got in zip(("run state", "run metrics", "run infos", "run states",
                                "run_batch state", "run_batch metrics", "run_batch infos"),
                               runs["cpu"], runs["cuda"]):
        check_equal(want, got, f"compact (e): scan.{part} card != CPU")
    argv = ["run", "--preset", "config7x", "--batch", "8", "--ticks", "32"]
    summaries = [_cli(argv + flag) for flag in (["--backend", "cuda"], ["--device", "cuda"])]
    for r in summaries:
        r.pop("wall_s")
        r.pop("cluster_ticks_per_s")
    if summaries[0] != summaries[1] or summaries[0]["device"] == "cpu":
        raise AssertionError(f"compact (e): run --backend cuda != run --device cuda: {summaries}")
    return {"scan_run_equal": True, "backend_equals_device": True, "max_abs_err": 0}


def compact_phase(dev, wall_ms, hold_ticks, config5_cell, legs) -> list:
    """Phase 4f (module docstring): the compacted carry layout on the card.
    `legs` holds the results of its rows that ran in the parity workers:
    (a)'s and (d)'s lines ("rows", "card_vs_cpu"), (e)'s bench legs by
    device ("bench") and its scan and backend checks ("scan"). Returns the
    (c) cells for the kernels line."""
    import torch
    from raft_sim_tpu_torch import types
    from raft_sim_tpu_torch.kernels import draw_engine, tick_engine
    from raft_sim_tpu_torch.models import raft_batched
    from raft_sim_tpu_torch.ops import tile
    from raft_sim_tpu_torch.sim import faults, scan
    from raft_sim_tpu_torch.summary import summarize
    from raft_sim_tpu_torch.utils import threefry
    from raft_sim_tpu_torch.utils.config import PRESETS

    cfg5c, cfg7x = PRESETS["config5c"][0], PRESETS["config7x"][0]

    # (a) kernel == plain under the boundary, (d) card == CPU: the rows ran in
    # the parity workers beside phase 2 (`_compact_row`, `_compact_cpu_row`).
    for line in legs["rows"]:
        emit(line)

    # (b) compact == dense from one seed at config5's batch.
    batch = PRESETS["config5"][1]
    cfg5 = PRESETS["config5"][0]
    sc, keys = scan.seed_fleet(cfg5c, SEED, batch, dev)
    sd, _ = scan.seed_fleet(cfg5, SEED, batch, dev)
    sc, sd = raft_batched.to_batch_minor(sc), raft_batched.to_batch_minor(sd)
    mc = md = raft_batched.to_batch_minor(scan.init_metrics_batch(batch, dev))
    for t in range(64):
        sc, mc, _ = scan.tick_batch_minor(cfg5c, sc, keys, mc, t)
        sd, md, _ = scan.tick_batch_minor(cfg5, sd, keys, md, t)
        check_equal(sd, tile.unpack_state(cfg5c, sc), f"compact (b) tick {t}: unpacked != dense")
    check_equal(md, mc, "compact (b): RunMetrics compact != dense")
    emit({"phase": "compact_vs_dense", "preset": "config5c", "batch": batch, "ticks": 64,
          "max_abs_err": 0})
    del sc, sd, mc, md

    # (c) full width, timed.
    cells = []
    for name, cfg in (("config5c", cfg5c), ("config7x", cfg7x)):
        batch = PRESETS[name][1]
        dcfg = types.compact_twin(cfg, on=False)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        with main_path_run(f"compact {name}") as n:
            final, metrics = scan.simulate(cfg, SEED, batch, COMPACT_T, device=dev)
            summ = summarize(metrics)  # copies to the host: waits for the device
        wall = time.perf_counter() - t0
        launches, draw_launches = n.tick, n.draws
        peak = torch.cuda.max_memory_allocated()
        expect_launches(n, f"compact {name}", COMPACT_T)
        if summ.total_violations != 0:
            raise AssertionError(f"compact {name}: {summ.total_violations} violations")
        # N=255 under rolling partitions: some clusters stay leaderless for
        # 128 ticks, the dense twin's trajectory too (compact (b), (d)).
        never_led = int((metrics.first_leader_tick >= scan.NEVER).sum())
        if never_led == batch:
            raise AssertionError(f"compact {name}: no cluster elected a leader")
        s = raft_batched.to_batch_minor(final)
        keys = threefry.split(threefry.split(threefry.key(SEED, dev), 2)[1], batch)
        hold_ticks(cfg, s, keys, COMPACT_T, FULL_HOLD_TICKS, f"compact {name} full width")
        inp = draw_engine.draw_cuda(cfg, keys, COMPACT_T)
        ds, dinp = tile.unpack_state(cfg, s), tile.unpack_inputs(cfg, inp)
        kernel_ms = tick_engine.time_kernel(dcfg, ds, dinp, reps=20, now=COMPACT_T)

        def boundary():
            tile.unpack_inputs(cfg, inp)
            return tile.pack_state(cfg, tile.unpack_state(cfg, s), reuse=s)

        boundary()
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(20):
            boundary()
        end.record()
        torch.cuda.synchronize()
        rd, wr = tick_engine.traffic_bytes(dcfg, batch)
        bound_ms = (rd + wr) / BW_BYTES_PER_S * 1e3
        cell = {
            "phase": "compact_full_width", "preset": name, "batch": batch, "ticks": COMPACT_T,
            "launches": launches, "draws_launches": draw_launches,
            "kernel_vs_plain_ticks": FULL_HOLD_TICKS, "wall_s": wall,
            "ms_per_tick": wall * 1e3 / COMPACT_T,
            "inputs_ms": wall_ms(lambda: faults.make_inputs(cfg, keys, COMPACT_T), 5),
            **draws_cell(cfg, keys, COMPACT_T, batch),
            "kernel_ms": kernel_ms, "unpack_pack_ms": start.elapsed_time(end) / 20,
            "unpack_pack_host_ms": wall_ms(boundary, 10),
            "step_ms": wall_ms(lambda: tick_engine.step_cuda(cfg, s, inp, COMPACT_T), 10),
            "plain_ms": wall_ms(lambda: raft_batched.step_b(cfg, s, inp, COMPACT_T), 3),
            "bound_ms": bound_ms, "bytes_read": rd, "bytes_written": wr,
            "bound_share": bound_ms / kernel_ms, "peak_mem_bytes": peak,
            "clusters_never_led": never_led,
            "packed_carry_bytes": sum(x.numel() * x.element_size() for x in _leaves(s)),
            "dense_carry_bytes": sum(x.numel() * x.element_size() for x in _leaves(ds)),
            "summary": summ._asdict(),
        }
        if name == "config5c":
            cell["config5"] = {k: config5_cell[k] for k in (
                "batch", "ticks", "wall_s", "inputs_ms", "kernel_ms", "step_ms", "plain_ms",
                "bound_ms", "peak_mem_bytes", "launches")}
            cell["config5"]["ms_per_tick"] = config5_cell["wall_s"] * 1e3 / config5_cell["ticks"]
        cells.append(cell)
        emit(cell)
        del final, metrics, s, inp, ds, dinp
        torch.cuda.empty_cache()

    for line in legs["card_vs_cpu"]:
        emit(line)

    # (e) the entry points, card against CPU (`_compact_bench_leg` on each,
    # `_compact_scan_runs`, in the parity workers).
    quality = ("p50_stable_tick", "pct_stable", "p50_commit_latency", "lat_p50", "lat_p95",
               "lat_p99", "lat_excluded", "total_cmds", "violations", "noop_blocked",
               "lm_skipped_pairs", "multi_leader", "layout")
    (row_g, doc_g, files_g), (row_c, doc_c, files_c) = legs["bench"]["cuda"], legs["bench"]["cpu"]
    differ = [k for k in quality if row_g[k] != row_c[k]]
    if differ or row_g["layout"] != "compact":
        raise AssertionError(f"compact (e): bench config5c card != CPU on {differ}: {row_g} {row_c}")
    for fname in files_g:
        if files_g[fname] != files_c[fname]:
            raise AssertionError(f"compact (e): bench --telemetry-dir {fname} card != CPU")
    differ = [k for k in quality if doc_g[k] != doc_c[k]]
    if differ or doc_g.get("scenario") != STORM_PROGRAM["name"]:
        raise AssertionError(f"compact (e): bench --scenario card != CPU on {differ}")
    emit({"phase": "compact_entry_points", "bench_config5c_layout": row_g["layout"],
          "bench_telemetry_scenario_equal": True, **legs["scan"]})
    return cells


def _health_files(directory: str) -> dict:
    """{name: content} of a directory's health.jsonl (each line's clock-derived
    SLI, the device-wait share, left out), alerts.jsonl and evidence bundles
    (their perf.jsonl, clock readings, left out)."""
    out = {}
    for root, _, names in os.walk(directory):
        for name in names:
            rel = os.path.relpath(os.path.join(root, name), directory)
            if rel in ("health.jsonl", "alerts.jsonl") or (
                    rel.startswith("evidence_") and not rel.endswith("perf.jsonl")):
                with open(os.path.join(root, name)) as f:
                    text = f.read()
                if rel == "health.jsonl":
                    rows = [json.loads(x) for x in text.splitlines()]
                    for r in rows:
                        r["slis"]["device_wait"].pop("share")
                    text = rows
                out[rel] = text
    return out


def _fresh_farm(device: str, out: str, corpus: str) -> tuple:
    """observe (e): the fresh-freeze farm of the CPU tests (blind-transfer,
    16 x 192, 4 generations, freezing into the empty `corpus`) on `device`:
    (manifest without its dedup paths, hunt rows, frozen artifacts' bytes)."""
    from raft_sim_tpu_torch.farm import FarmSpec, run_farm
    from raft_sim_tpu_torch.scenario.mutation import mutant_config
    from raft_sim_tpu_torch.utils.config import RaftConfig

    cfg = mutant_config("blind-transfer", RaftConfig(n_nodes=5, log_capacity=16,
                                                     client_interval=2, transfer_interval=9))
    spec = FarmSpec(portfolio=("scalar", "coverage"), budget_gens=4, population=16, ticks=192,
                    window=32, trace_depth=16, seed=0)
    os.makedirs(corpus)
    res = run_farm(cfg, spec, mutant="blind-transfer", out_dir=out, corpus_dir=corpus,
                   freeze=True, device=device)
    man = res.manifest
    for d in man["dedup_rejected"]:
        d.pop("path")
    hunts = []
    for m in ("scalar", "coverage"):
        with open(os.path.join(out, "members", m, "hunt.jsonl"), "rb") as f:
            hunts.append(f.read())
    frozen = []
    for p in res.frozen:
        with open(p, "rb") as f:
            frozen.append(f.read())
    return man, hunts, frozen


def _observe_leg(device: str, work: str) -> tuple:
    """observe (b) and (e) on `device` ("cuda" or "cpu"), in a parity worker
    beside phase 2: (b)'s health files, (e)'s farm outcome."""
    small = os.path.join(work, f"small_{device}")
    _cli([*OBS_SMALL_ARGV, "--device", device, "--telemetry-dir", small])
    return (_health_files(small),
            _fresh_farm(device, os.path.join(work, f"fresh_{device}"),
                        os.path.join(work, f"fresh_corpus_{device}")))


def observe_phase(dev, serve_unarmed, legs) -> list:
    """Phase 4g: the chunk timer, the health plane and the fuzzing farm on the
    card (see the module docstring). `legs` holds (b) and (e)'s results on
    the card and on the CPU ({"cuda": ..., "cpu": ...}, `_observe_leg`).
    Returns the cells of its main-path runs ((a), (c), (d)), each with its
    launches."""
    import glob
    import shutil

    import torch
    from raft_sim_tpu_torch import bench
    from raft_sim_tpu_torch.farm import validate_farm_dir
    from raft_sim_tpu_torch.kernels import draw_engine, tick_engine
    from raft_sim_tpu_torch.models import raft_batched
    from raft_sim_tpu_torch.obs import ChunkTimer, summarize_rows
    from raft_sim_tpu_torch.scenario.mutation import mutant_config
    from raft_sim_tpu_torch.serve import ServeSession
    from raft_sim_tpu_torch.serve.loop import serve_config
    from raft_sim_tpu_torch.sim import scan
    from raft_sim_tpu_torch.utils import checkpoint
    from raft_sim_tpu_torch.utils.config import PRESETS
    from raft_sim_tpu_torch.utils.telemetry_sink import TelemetrySink, validate

    work = os.path.join(HERE, "raft_sim_tpu_torch", "build", "observe")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    cells = []

    def read_bytes(path):
        with open(path, "rb") as f:
            return f.read()

    # ---- (a) run --perf --health at config6's batch, armed == unarmed -------
    b_a, t_a, chunk_a = OBS_RUN
    base = ["run", "--device", "cuda", "--preset", "config6", "--batch", str(b_a), "--ticks",
            str(t_a), "--chunk", str(chunk_a), "--telemetry-window", "64", "--telemetry-ring", "8"]
    runs = {}
    libs_before = len(tick_engine._LIBS)
    for label, extra in (("unarmed", []), ("armed", ["--perf", "--health"])):
        d = os.path.join(work, label)
        torch.cuda.synchronize()
        with main_path_run(f"observe (a) {label}") as n:
            out = _cli([*base, "--telemetry-dir", d, "--save", d + ".npz", *extra])
        expect_launches(n, f"observe (a) {label}", t_a)
        runs[label] = (d, out, n.tick)
    (ud, u_out, _), (ad, a_out, a_launches) = runs["unarmed"], runs["armed"]
    _, s_u, _, m_u, *_ = checkpoint.load(ud + ".npz", dev)
    _, s_a, _, m_a, *_ = checkpoint.load(ad + ".npz", dev)
    check_equal(s_u, s_a, "observe (a): armed state != unarmed")
    check_equal(m_u, m_a, "observe (a): armed metrics != unarmed")
    files = sorted(os.path.basename(p) for p in glob.glob(os.path.join(ud, "*.json*"))
                   if not p.endswith("manifest.json"))
    for name in files:
        if read_bytes(os.path.join(ud, name)) != read_bytes(os.path.join(ad, name)):
            raise AssertionError(f"observe (a): {name} differs armed vs unarmed")
    problems = validate(ad)
    if problems:
        raise AssertionError(f"observe (a): sink invalid: {problems[:5]}")
    with open(os.path.join(ad, "perf.jsonl")) as f:
        perf = [json.loads(x) for x in f]
    if (len(perf) != t_a // chunk_a or sum(r["warmup"] for r in perf) != 2
            or any(r["recompiled"] for r in perf)
            or not all(isinstance(r["live_bytes"], int) for r in perf)
            or {r["jit_cache"]["tick_engine._load_cuda"] for r in perf} != {libs_before}):
        raise AssertionError(f"observe (a): perf rows off: {perf}")
    roll = summarize_rows(perf, label="run", batch=b_a)
    cell = {
        "phase": "observe_run", "preset": "observe-config6", "batch": b_a, "ticks": t_a,
        "chunk": chunk_a, "launches": a_launches, "perf_rows": len(perf), "warmup_rows": 2,
        "equal": ["state", "metrics", *files], "sink_valid": True,
        "library_loads": libs_before, "recompiled": False,
        "steady_ms_per_chunk": roll["steady_wall_s"] * 1e3 / roll["steady_chunks"],
        "device_wait_share": roll["device_wait_s"] / roll["steady_wall_s"],
        "host_gap_frac": roll["host_gap_frac"],
        "dispatch_share": sum(r["dispatch_s"] for r in perf[2:]) / roll["steady_wall_s"],
        "live_bytes_peak": roll["live_bytes_peak"],
        "armed_wall_s": a_out["wall_s"], "unarmed_wall_s": u_out["wall_s"],
        "health": a_out["health"], "perf_rollup": roll,
    }
    emit(cell)
    cells.append(cell)

    # ---- (b) the health plane, card == CPU (run beside phase 2) ---------------
    (got, card_farm), (cpu_health, cpu_farm) = legs["cuda"], legs["cpu"]
    if got != cpu_health:
        raise AssertionError("observe (b): the health files differ card vs CPU")
    n_alerts = len(got["alerts.jsonl"].splitlines())
    emit({"phase": "observe_health_card_vs_cpu", "preset": "config6", "batch": OBS_SMALL[0],
          "ticks": OBS_SMALL[1],
          "equal": sorted(got), "left_out": ["slis.device_wait.share", "evidence_*/perf.jsonl"],
          "alerts": n_alerts, "max_abs_err": 0})

    # ---- (c) serve with its planes armed ---------------------------------------
    cfg9, batch9 = PRESETS["config9"]
    sd = os.path.join(work, "serve")
    sink = TelemetrySink(sd, serve_config(cfg9), seed=0, batch=batch9, window=64, ring=0,
                         source="serve", backend="cuda")
    torch.cuda.synchronize()
    with main_path_run("observe (c)") as n:
        sess = ServeSession(cfg9, batch=batch9, seed=0, chunk=256, window=64, sink=sink,
                            warmup_ticks=256, tenants=bench.serve_tenants(batch9, 4), device=dev,
                            perf=ChunkTimer(label="serve", batch=batch9, sink=sink),
                            health="default")
        stats = sess.serve(chunks=SERVE_CHUNKS)
        torch.cuda.synchronize()
    expect_launches(n, "observe (c)", (sess.warmup_chunks + sess.chunks_done) * sess.chunk)
    launches = n.tick
    row = bench.serve_row(sess, stats, "config9", 4, smoke=False)
    for k in ("commands_acked", "reads_served"):
        if stats[k] != serve_unarmed[k]:
            raise AssertionError(f"observe (c): {k} {stats[k]} armed != {serve_unarmed[k]}")
    check_equal(serve_unarmed["state"], sess.state, "observe (c): armed final state != unarmed")
    if not row["perf"] or row["perf"]["steady_chunks"] < 1:
        raise AssertionError(f"observe (c): the bench row's perf is not filled: {row['perf']}")
    problems = validate(sd)
    if problems:
        raise AssertionError(f"observe (c): sink invalid: {problems[:5]}")
    cell = {
        "phase": "observe_serve", "preset": "observe-config9-serve", "batch": batch9,
        "ticks": (sess.warmup_chunks + sess.chunks_done) * sess.chunk, "launches": launches,
        "commands_acked": stats["commands_acked"], "reads_served": stats["reads_served"],
        "equal": ["commands_acked", "reads_served", "state"], "sink_valid": True,
        "ops_per_s_armed": row["ops_per_s"], "ops_per_s_unarmed": serve_unarmed["ops_per_s"],
        "wall_s_armed": stats["wall_s"], "wall_s_unarmed": serve_unarmed["wall_s"],
        "perf": row["perf"], "health": stats["health"],
    }
    emit(cell)
    cells.append(cell)
    del sess, sink

    # ---- (d) the farm at full width -------------------------------------------
    pop, ticks, window, depth = FARM_RUN
    fd, corpus = os.path.join(work, "farm"), os.path.join(work, "corpus")
    shutil.copytree(os.path.join(HERE, "tests", "corpus"), corpus)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with main_path_run("observe (d)") as n:
        doc = _cli(["scenario", "farm", "--device", "cuda", "--preset", "config4c", "--mutant",
                    "weak-quorum", "--portfolio", "scalar,coverage", "--population", str(pop),
                    "--ticks", str(ticks), "--window", str(window), "--trace-depth", str(depth),
                    "--budget-gens", "4", "--stop-on", "hit", "--out-dir", fd,
                    "--corpus-dir", corpus, "--freeze", "--health"])
    wall = time.perf_counter() - t0
    launches, farm_draws = n.tick, n.draws
    peak = torch.cuda.max_memory_allocated()
    if not doc["found"] or not (doc["frozen"] or doc["dedup_rejected"]):
        raise AssertionError(f"observe (d): the farm found or processed no hit: {doc}")
    problems = validate_farm_dir(fd)
    if problems:
        raise AssertionError(f"observe (d): farm dir invalid: {problems[:5]}")
    with open(os.path.join(fd, "perf.jsonl")) as f:
        gens = [json.loads(x) for x in f]
    eval_launches = ticks * len(gens)
    if not eval_launches <= farm_draws <= launches:  # a draw a tick, a span a replay
        raise AssertionError(f"observe (d): {farm_draws} draw launches for {launches} tick "
                             f"launches, {eval_launches} of them the hunt's")
    # K1 on the hunt's tick (the weak-quorum body, traced) at the population,
    # from a state 32 ticks in; these launches are not the farm's.
    run_cfg = dataclasses.replace(mutant_config("weak-quorum", PRESETS["config4c"][0]),
                                  track_trace=True)
    final, _ = scan.simulate(run_cfg, SEED, pop, 32, device=dev)
    s = raft_batched.to_batch_minor(final)
    keys = scan.seed_fleet(run_cfg, SEED, pop, dev)[1]
    # FULL_HOLD_TICKS ticks of kernel == plain on that state first.
    hold_ticks(run_cfg, s, keys, 32, FULL_HOLD_TICKS, "farm full width")
    inp = draw_engine.draw_cuda(run_cfg, keys, 32)
    kernel_ms = tick_engine.time_kernel(run_cfg, s, inp, reps=20, now=32)
    plain_ms = wall_ms(lambda: raft_batched.step_b(run_cfg, s, inp, 32), 3)
    rd, wr = tick_engine.traffic_bytes(run_cfg, pop)
    bound_ms = (rd + wr) / BW_BYTES_PER_S * 1e3
    gen_ms = [r["wall_s"] * 1e3 for r in gens]
    gen_host = [(r["dispatch_s"] + r["host_s"]) / r["wall_s"] for r in gens]
    cell = {
        "phase": "observe_farm", "preset": "farm-config4c-weak-quorum", "batch": pop,
        "ticks": ticks, "window": window, "trace_depth": depth, "launches": launches,
        "draws_launches": farm_draws, "evaluation_launches": eval_launches,
        "generations": len(gens),
        "hits": doc["hits"], "frozen": doc["frozen"],
        "dedup_rejected": [d["duplicate_of"] for d in doc["dedup_rejected"]],
        "outcome": "frozen" if doc["frozen"] else "dedup-rejected", "farm_dir_valid": True,
        "wall_s": wall, "ms_per_generation": gen_ms, "host_share_per_generation": gen_host,
        "device_wait_s": [r["device_wait_s"] for r in gens],
        "kernel_ms": kernel_ms, "bound_ms": bound_ms, "bytes_read": rd, "bytes_written": wr,
        "bound_share": bound_ms / kernel_ms, "plain_ms": plain_ms, "peak_mem_bytes": peak,
        "kernel_vs_plain_ticks": FULL_HOLD_TICKS,
        "health": json.load(open(os.path.join(fd, "farm_manifest.json"))).get("health"),
    }
    emit(cell)
    cells.append(cell)
    del final, s, inp, keys
    torch.cuda.empty_cache()

    # ---- (e) the farm, card == CPU (run beside phase 2) ------------------------
    if card_farm != cpu_farm:
        raise AssertionError("observe (e): the fresh-freeze farm differs card vs CPU")
    emit({"phase": "observe_farm_card_vs_cpu", "batch": 16, "ticks": 192, "generations": 4,
          "equal": ["manifest", "hunt rows", "frozen artifact"], "frozen": cpu_farm[0]["frozen"],
          "max_abs_err": 0})

    # ---- (f) --profile ---------------------------------------------------------
    prof = ["run", "--device", "cuda", "--preset", "config2", "--batch", "8", "--ticks",
            str(PROFILE_T), "--chunk", "32"]
    pd = os.path.join(work, "profile")
    got, want = _cli([*prof, "--profile", pd]), _cli(prof)
    clocks = ("wall_s", "cluster_ticks_per_s")
    if {k: v for k, v in got.items() if k not in clocks} != {
            k: v for k, v in want.items() if k not in clocks}:
        raise AssertionError("observe (f): the profiled run differs from the unprofiled one")
    with open(os.path.join(pd, "torch_trace.json")) as f:
        events = json.load(f)["traceEvents"]
    kernel_rows = [e for e in events if e.get("cat") == "kernel"]
    tick_rows = [e for e in kernel_rows if "tick_kernel" in e.get("name", "")]
    # The card's busy share over the profiled run: its kernel and copy rows'
    # time over the span from the first one's start to the last one's end.
    device_rows = [e for e in events if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
    span_us = (max(e["ts"] + e.get("dur", 0) for e in device_rows)
               - min(e["ts"] for e in device_rows))
    if len(tick_rows) < PROFILE_T:
        raise AssertionError(f"observe (f): {len(tick_rows)} tick_kernel rows in the trace "
                             f"({len(kernel_rows)} kernel rows)")
    emit({"phase": "observe_profile", "preset": "config2", "batch": 8, "ticks": PROFILE_T,
          "equal": True, "kernel_rows": len(kernel_rows), "tick_kernel_rows": len(tick_rows),
          "tick_kernel_us_mean": sum(e.get("dur", 0) for e in tick_rows) / len(tick_rows),
          "device_rows": len(device_rows), "device_span_us": span_us,
          "device_busy_share": sum(e.get("dur", 0) for e in device_rows) / span_us,
          "trace_bytes": os.path.getsize(os.path.join(pd, "torch_trace.json"))})
    shutil.rmtree(work, ignore_errors=True)
    return cells


SHARD_T = 64  # shard (a): ticks of the sharded run and its reference
SHARD_NODE_T = 16  # shard (b): ticks of the node-sharded run and its reference
#   (64 before PR 15)
SHARD_SHARDS = 4  # shard (a), (b): shards on the one card
SHARD_FARM = (64, 64, 32, 2)  # shard (d): population a shard, ticks, window, generations
MULTIHOST_T = 16  # shard (c): ticks of the two-process check's workload (32 before PR 15)
TOOLS_RUN = (1_000, 32, 16, 256)  # tools (a): config6's batch, ticks, window (before PR 15:
#   64 ticks, windows of 32), trace depth
TOOLS_OFFERS = (1_000, 32, 16)  # tools (a): config9's batch, ticks before the offers, wait
SAN_RUN = (1_000, 128, 32)  # analysis (a): config6's batch, ticks, chunk and window
SAN_SERVE = (1_000, 64, 2, 64)  # analysis (b): batch, warmup ticks, chunks, chunk (= window)
REPRO_RUN = (64, 1_024, 256)  # tools (c): the broken quorum's batch, ticks, chunk
# tools (d): the measurement pass's rows cut to 4 ticks and 1 timed repeat
# (the JAX pass's defaults: each row's preset ticks, 3 repeats); batches are
# the matrix's.
MEASURE = ["--configs", "config3,config5c", "--ab-preset", "config2", "--mesh-preset", "config3",
           "--ticks", "4", "--repeats", "1"]


def shard_devices(n: int) -> list:
    """n shard devices: the cards in turn, so one card carries all n and
    four cards one each."""
    import torch

    count = torch.cuda.device_count()
    return [torch.device("cuda", i % count) for i in range(n)]


def _multihost_leg() -> dict:
    """shard (c)'s two-process check, in a parity worker beside phase 2 (it
    times nothing): `python -m raft_sim_tpu_torch.multihost_check --device
    cuda` at MULTIHOST_T ticks; returns its exit code, output, artifact path
    and seconds for the shard phase to check."""
    import subprocess

    t0 = time.perf_counter()
    art = os.path.join(HERE, "raft_sim_tpu_torch", "build", "multichip_cuda.json")
    proc = subprocess.run([sys.executable, "-m", "raft_sim_tpu_torch.multihost_check",
                           "--device", "cuda", "--ticks", str(MULTIHOST_T), "--out", art,
                           "--timeout", "300"],
                          capture_output=True, text=True, cwd=HERE, timeout=360)
    return {"rc": proc.returncode, "stdout": proc.stdout, "stderr": proc.stderr,
            "artifact": art, "seconds": time.perf_counter() - t0}


def shard_phase(dev, multihost) -> list:
    """Phase 4h: the multi-device tier (raft_sim_tpu_torch/parallel/). With
    one card every shard shares it: these rows then prove the partition,
    the key split, the padding, the exchange points and the multi-process
    control plane, not NCCL or copies between cards (with several cards the
    shards spread over them and copy between them; the process group is
    gloo, never NCCL). Sharding is slower than one shard today: every
    shard's input draws are host work on one thread (PERF.md). (a) The
    cluster axis at full width: config3 at its batch of 100,000 over
    SHARD_SHARDS shards (`simulate_sharded`), every tick of every shard one
    K1 launch: launches == shards x ticks, zeroed and read
    around the run; the final state and RunMetrics equal the unsharded
    `simulate`'s; 0 violations; wall ms a tick both ways. (b) The node axis
    at full width: config7x (N=255) at its batch of 250 on the dense twin
    over SHARD_SHARDS node shards (n_pad 256), the plain tick on each shard
    as in JAX (no K1 launch): `unshard_state` and the metrics equal the
    unsharded run's (through K1); the exchange's per-tick counts (one
    mailbox gather, the folds, the leaders gather). (c) `python -m
    raft_sim_tpu_torch.multihost_check --device cuda`: two processes on
    the card over gloo, match true, 0 violations, the multichip-v2 artifact
    valid (run in a parity worker beside phase 2: `multihost`, the
    future of `_multihost_leg`). (d) The farm's mesh leg: config4c under
    weak-quorum, 2 shards x
    a population of 64, 2 generations: the unsharded farm's hunt rows, hits
    and manifest. Each row prints its seconds; nothing here is caught.
    The shards take the cards in turn (`shard_devices`): with one card, all
    of them share it. Returns the cells whose launches count."""
    import torch
    from raft_sim_tpu_torch.analysis import op_audit
    from raft_sim_tpu_torch.farm import FarmSpec, run_farm
    from raft_sim_tpu_torch.parallel import mesh as mesh_mod, nodeshard
    from raft_sim_tpu_torch.scenario.mutation import mutant_config
    from raft_sim_tpu_torch.sim import scan
    from raft_sim_tpu_torch.summary import summarize
    from raft_sim_tpu_torch.types import compact_twin
    from raft_sim_tpu_torch.utils.config import PRESETS
    from raft_sim_tpu_torch.utils.telemetry_sink import validate_multichip

    cells = []

    def timed(fn, what: str, draws: int):
        """(fn's result, seconds, K1's launches) of one counted run, whose
        K2 launches must be `draws`."""
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with main_path_run(what) as n:
            out = fn()
            torch.cuda.synchronize()
        if n.draws != draws:
            raise AssertionError(f"{what}: {n.draws} draw launches, expected {draws}")
        return out, time.perf_counter() - t0, n.tick

    # ---- (a) the cluster axis: config3 at 100,000 over 4 shards ----------------
    t_row = time.perf_counter()
    cfg, batch = PRESETS["config3"]
    mesh = mesh_mod.make_mesh(devices=shard_devices(SHARD_SHARDS))
    (fs, ms), wall_s, launches = timed(
        lambda: mesh_mod.simulate_sharded(cfg, SEED, batch, SHARD_T, mesh), "shard (a) sharded",
        SHARD_SHARDS * SHARD_T)
    if launches != SHARD_SHARDS * SHARD_T:
        raise AssertionError(f"shard (a): {launches} kernel launches for {SHARD_SHARDS} shards x "
                             f"{SHARD_T} ticks")
    (fd, md), wall_d, launches_d = timed(lambda: scan.simulate(cfg, SEED, batch, SHARD_T, device=dev),
                                         "shard (a) unsharded", SHARD_T)
    if launches_d != SHARD_T:
        raise AssertionError(f"shard (a): {launches_d} kernel launches unsharded for {SHARD_T} ticks")
    check_equal(fd, fs, "shard (a): sharded final state != unsharded")
    check_equal(md, ms, "shard (a): sharded metrics != unsharded")
    summ = mesh_mod.summarize(ms)
    if summ.total_violations:
        raise AssertionError(f"shard (a): {summ.total_violations} violations")
    cell = {"phase": "shard_cluster_axis", "preset": "shard-config3", "batch": batch,
            "ticks": SHARD_T, "shards": SHARD_SHARDS, "devices": [str(d) for d in mesh.flat()],
            "launches": launches + launches_d, "launches_sharded": launches,
            "launches_unsharded": launches_d, "equal": ["state", "metrics"], "max_abs_err": 0,
            "violations": summ.total_violations, "ms_per_tick_sharded": wall_s * 1e3 / SHARD_T,
            "ms_per_tick_unsharded": wall_d * 1e3 / SHARD_T,
            "seconds": time.perf_counter() - t_row}
    emit(cell)
    cells.append(cell)
    del fs, ms, fd, md
    torch.cuda.empty_cache()

    # ---- (b) the node axis: config7x (N=255) over 4 node shards ----------------
    t_row = time.perf_counter()
    cfg, batch = PRESETS["config7x"]
    dense = compact_twin(cfg, False)
    nmesh = nodeshard.make_node_mesh(SHARD_SHARDS, devices=shard_devices(SHARD_SHARDS))
    counts = {}
    (fs, ms), wall_s, launches = timed(lambda: nodeshard.simulate_node_sharded(
        cfg, SEED, batch, SHARD_NODE_T, nmesh, counts=counts), "shard (b) sharded",
        SHARD_SHARDS * SHARD_NODE_T)  # every node shard draws the real N
    if launches:
        raise AssertionError(f"shard (b): {launches} kernel launches on the node axis (the "
                             "plain tick runs each shard)")
    (fd, md), wall_d, launches_d = timed(lambda: scan.simulate(dense, SEED, batch, SHARD_NODE_T,
                                                               device=dev),
                                         "shard (b) unsharded", SHARD_NODE_T)
    if launches_d != SHARD_NODE_T:
        raise AssertionError(f"shard (b): {launches_d} kernel launches unsharded")
    check_equal(fd, nodeshard.unshard_state(cfg, fs), "shard (b): unshard_state != unsharded")
    check_equal(md, ms, "shard (b): node-sharded metrics != unsharded")
    per_tick = {k: v / SHARD_NODE_T for k, v in counts.items()}
    # The kinds and gathers a tick that parallel/comm.py declares (the
    # analyzer's node-collectives rule).
    bad = op_audit.check_node_collectives(dense, counts, SHARD_NODE_T, name="shard-config7x")
    if bad:
        raise AssertionError(f"shard (b): collectives a tick {per_tick}: "
                             f"{[f.message for f in bad]}")
    summ = summarize(ms)
    if summ.total_violations:
        raise AssertionError(f"shard (b): {summ.total_violations} violations")
    cell = {"phase": "shard_node_axis", "preset": "shard-config7x", "batch": batch,
            "ticks": SHARD_NODE_T, "node_shards": SHARD_SHARDS, "n_pad": int(fs.role.shape[1]),
            "devices": [str(d) for d in nmesh.flat()],
            "launches": launches_d, "launches_sharded": launches,
            "launches_unsharded": launches_d, "collectives_per_tick": per_tick,
            "equal": ["unshard_state", "metrics"], "max_abs_err": 0,
            "violations": summ.total_violations,
            "ms_per_tick_sharded": wall_s * 1e3 / SHARD_NODE_T,
            "ms_per_tick_unsharded": wall_d * 1e3 / SHARD_NODE_T,
            "seconds": time.perf_counter() - t_row}
    emit(cell)
    cells.append(cell)
    del fs, ms, fd, md
    torch.cuda.empty_cache()

    # ---- (c) two processes on the card over gloo (run beside phase 2) -----------
    leg = multihost.result()
    if leg["rc"] != 0:
        raise AssertionError(f"shard (c): multihost_check exit {leg['rc']}: "
                             f"{leg['stdout'][-2000:]} {leg['stderr'][-2000:]}")
    verdict = json.loads(leg["stdout"].strip().splitlines()[-1])
    problems = validate_multichip(leg["artifact"])
    if not verdict["match"] or verdict["violations"] or problems:
        raise AssertionError(f"shard (c): {verdict} {problems}")
    with open(leg["artifact"]) as f:
        doc = json.load(f)
    emit({"phase": "shard_multihost", "n_processes": verdict["n_processes"],
          "global_shards": verdict["global_devices"], "device": verdict["device"],
          "batch": verdict["batch"], "ticks": verdict["ticks"], "match": True,
          "violations": 0, "artifact_valid": True,
          "throughput_ticks_per_s": doc["throughput_ticks_per_s"],
          "reference_ticks_per_s": doc["reference_ticks_per_s"],
          "seconds": leg["seconds"], "in_worker": True})

    # ---- (d) the farm's mesh leg -------------------------------------------------
    t_row = time.perf_counter()
    pop, ticks, window, gens = SHARD_FARM
    fcfg = mutant_config("weak-quorum", PRESETS["config4c"][0])
    spec = FarmSpec(portfolio=("scalar", "coverage"), budget_gens=gens, population=2 * pop,
                    ticks=ticks, window=window, trace_depth=16, seed=SEED, stop_on="budget")
    r_s, wall_s, launches = timed(lambda: run_farm(
        fcfg, spec, mutant="weak-quorum", mesh=mesh_mod.make_mesh(devices=shard_devices(2)),
        device=dev), "shard (d) sharded", 2 * gens * span_launches(pop, ticks))
    r_d, wall_d, launches_d = timed(lambda: run_farm(fcfg, spec, mutant="weak-quorum",
                                                     device=dev), "shard (d) unsharded",
                                    gens * span_launches(2 * pop, ticks))  # small fleets: spans
    if launches != 2 * ticks * gens or launches_d != ticks * gens:
        raise AssertionError(f"shard (d): launches {launches} sharded, {launches_d} unsharded")
    rows = lambda r: json.dumps(r.generations, sort_keys=True)  # noqa: E731
    if rows(r_s) != rows(r_d) or r_s.hits != r_d.hits or r_s.manifest != r_d.manifest:
        raise AssertionError("shard (d): the mesh farm's hunt differs from the unsharded farm's")
    cell = {"phase": "shard_farm", "preset": "shard-farm-config4c-weak-quorum",
            "batch": 2 * pop, "shards": 2, "ticks": ticks, "window": window,
            "generations": gens, "launches": launches + launches_d,
            "launches_sharded": launches, "launches_unsharded": launches_d,
            "hits": len(r_s.hits), "manifest_hash": r_s.manifest["manifest_hash"],
            "equal": ["hunt rows", "hits", "manifest"],
            "s_per_generation_sharded": wall_s / gens, "s_per_generation_unsharded": wall_d / gens,
            "seconds": time.perf_counter() - t_row}
    emit(cell)
    cells.append(cell)
    return cells


def _device_parity_leg(name: str, device: str) -> tuple:
    """tools (b): one device-parity config at its own size on `device`, in a
    parity worker beside phase 2 (it times nothing); returns its leaves and
    the kernel launches it made."""
    from raft_sim_tpu_torch import device_parity_check
    from raft_sim_tpu_torch.kernels import tick_engine

    before = getattr(tick_engine.step_cuda, "launches", 0)
    out = device_parity_check.leaves(name, device)
    return out, getattr(tick_engine.step_cuda, "launches", 0) - before


def _broken_quorum():
    """The repro test's deliberately unsafe config: quorum one vote short."""
    from raft_sim_tpu_torch.utils.config import RaftConfig

    class BrokenQuorum(RaftConfig):
        @property
        def quorum(self):
            return self.n_nodes // 2

    return BrokenQuorum(n_nodes=5, drop_prob=0.3)


def _repro_leg(device: str) -> tuple:
    """tools (c), in a parity worker (it times nothing): `repro.shrink` of
    the broken quorum on `device`, the kernel launches it made and its
    seconds; on the card, then `repro --corpus tests/corpus` too (its exit
    code, last line, launches and seconds)."""
    from raft_sim_tpu_torch import repro
    from raft_sim_tpu_torch.kernels import tick_engine

    def launches():
        return getattr(tick_engine.step_cuda, "launches", 0)

    batch, ticks, chunk = REPRO_RUN
    n0, t0 = launches(), time.perf_counter()
    got = repro.shrink(_broken_quorum(), 1, batch, ticks, chunk=chunk, device=device)
    shrink = (got, launches() - n0, time.perf_counter() - t0)
    if device == "cpu":
        return shrink, None
    n0, t0 = launches(), time.perf_counter()
    rc, text = _tool_main(repro.main, ["--corpus", os.path.join(HERE, "tests", "corpus"),
                                       "--device", device])
    return shrink, (rc, json.loads(text.strip().splitlines()[-1]), launches() - n0,
                    time.perf_counter() - t0)


def _sink_files(directory: str) -> dict:
    """{name: bytes} of a telemetry directory's files, the manifest without
    its creation time."""
    out = {}
    for name in sorted(os.listdir(directory)):
        with open(os.path.join(directory, name), "rb") as f:
            data = f.read()
        if name == "manifest.json":
            data = {k: v for k, v in json.loads(data).items() if k != "created_unix"}
        out[name] = data
    return out


def _tool_main(main, argv) -> tuple:
    """(exit code, stdout) of a package tool's `main(argv)`, in process (its
    stderr, progress lines and tables, dropped)."""
    import contextlib
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf), contextlib.redirect_stderr(io.StringIO()):
        rc = main(argv)
    return rc, buf.getvalue()


def tools_phase(dev, legs) -> list:
    """Phase 4i: a sharded Session's planes and the tools tier on the card.
    (a) `run --devices 4 --telemetry-dir D --trace` at config6's batch
    (TOOLS_RUN: 1,000 x 32, two windows of 16, trace depth 256) on the one
    card: every sink and trace file byte-equal to the unsharded run's (the
    manifest but its creation time), the same summary line, the checker's
    verdict equal and all six properties ok; launches 4 x 32 and 32; ms a
    tick both ways.
    Then config9 at 1,000 through a 4-shard Session's offer/offer_read
    (after TOOLS_OFFERS' 32 ticks, waits of 16): every returned dict, the
    state and the metrics equal the unsharded Session's. (b)
    `device_parity_check` at its own sizes: the card's run of each of its
    five configs equals the CPU's, every non-mailbox state leaf and metric
    (both legs ran in the parity workers beside phase 2: they time
    nothing). (c) `repro.shrink` of the broken quorum (REPRO_RUN: 64 x
    1,024 in chunks of 256) on the card equals the CPU's, and `repro
    --corpus tests/corpus` on the card exits 0 (all in the parity workers). (d) `bench --measurement-pass` (MEASURE: config3
    and config5c, the A/Bs on config2, the mesh leg on config3, 4 ticks a
    row, 1 timed repeat, the matrix batches) renders through `metrics_report
    --perf`, with the anchor-eligible rows named; `traffic_audit --json` on
    config3 and config7x against that document. Nothing here is caught.
    Returns the cells whose launches count."""
    import torch
    from raft_sim_tpu_torch import __main__ as cli
    from raft_sim_tpu_torch import device_parity_check, metrics_report, traffic_audit
    from raft_sim_tpu_torch.driver import Session
    from raft_sim_tpu_torch.trace import checker
    from raft_sim_tpu_torch.utils.config import PRESETS

    cells = []
    work = os.path.join(HERE, "raft_sim_tpu_torch", "build", "tools")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)

    def counted(fn, what: str, spans: bool = False):
        """(fn's result, seconds, K1's launches) of one counted run, which
        must launch K2 once a K1 launch (with `spans`, where small fleets
        draw a span of ticks a launch: at least once, at most so)."""
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with main_path_run(what) as n:
            out = fn()
            torch.cuda.synchronize()
        if not (0 < n.draws <= n.tick if spans else n.draws == n.tick):
            raise AssertionError(f"{what}: {n.draws} draw launches for {n.tick} tick launches")
        return out, time.perf_counter() - t0, n.tick

    # ---- (a) the sharded planes: config6 traced over 4 shards, config9's offers ----
    t_row = time.perf_counter()
    batch, ticks, window, depth = TOOLS_RUN
    argv = ["run", "--preset", "config6", "--batch", str(batch), "--ticks", str(ticks),
            "--telemetry-window", str(window), "--trace", "--trace-depth", str(depth),
            "--device", "cuda"]
    runs = {}
    for name, extra in (("unsharded", []), ("sharded", ["--devices", str(SHARD_SHARDS)])):
        d = os.path.join(work, name)
        out, wall, launches = counted(lambda: _cli([*argv, *extra, "--telemetry-dir", d]),
                                      f"tools (a) {name}")
        for k in ("wall_s", "cluster_ticks_per_s"):
            out.pop(k)
        runs[name] = (out, wall, launches, _sink_files(d), checker.check_directory(d).to_dict())
    (out1, wall1, l1, files1, verdict1), (out4, wall4, l4, files4, verdict4) = (
        runs["unsharded"], runs["sharded"])
    if l1 != ticks or l4 != SHARD_SHARDS * ticks:
        raise AssertionError(f"tools (a): launches {l1} unsharded, {l4} sharded for {ticks} ticks")
    if files4 != files1:
        raise AssertionError("tools (a): the sharded run's files differ: "
                             f"{sorted(k for k in files1 if files1[k] != files4.get(k))}")
    if out4 != out1:
        raise AssertionError(f"tools (a): the sharded summary differs: {out4} != {out1}")
    if verdict4 != verdict1 or not (verdict1["complete"] and verdict1["ok"]):
        raise AssertionError(f"tools (a): checker verdicts {verdict1} / {verdict4}")
    if out1["total_violations"]:
        raise AssertionError(f"tools (a): {out1['total_violations']} violations")
    cell = {"phase": "tools_sharded_planes", "preset": "tools-config6-sharded", "batch": batch,
            "ticks": ticks, "window": window, "shards": SHARD_SHARDS, "trace_depth": depth,
            "launches": l1 + l4, "launches_sharded": l4, "launches_unsharded": l1,
            "files_equal": sorted(files1), "summary_equal": True, "checker": "all six ok",
            "ms_per_tick_sharded": wall4 * 1e3 / ticks, "ms_per_tick_unsharded": wall1 * 1e3 / ticks,
            "seconds": time.perf_counter() - t_row}
    emit(cell)
    cells.append(cell)

    t_row = time.perf_counter()
    batch, warm, wait = TOOLS_OFFERS
    cfg9 = PRESETS["config9"][0]

    def offers(devices):
        sess = Session(cfg9, batch=batch, seed=SEED, device=dev, devices=devices)
        sess.run(warm, chunk=warm)
        got = [sess.offer(7, wait=wait), sess.offer_read(wait=wait), sess.offer(9, wait=wait),
               sess.offer_read(wait=wait)]
        return got, sess.state, sess.metrics, sess.now

    (got1, st1, m1, now1), wall1, l1 = counted(lambda: offers(None), "tools (a) offers")
    (got4, st4, m4, now4), wall4, l4 = counted(lambda: offers(shard_devices(SHARD_SHARDS)),
                                               "tools (a) sharded offers")
    if got4 != got1 or now4 != now1:
        raise AssertionError(f"tools (a): sharded offers {got4} != unsharded {got1}")
    check_equal(st1, st4, "tools (a): the offers' sharded state != unsharded")
    check_equal(m1, m4, "tools (a): the offers' sharded metrics != unsharded")
    if not (got1[0]["committed"] and got1[1]["served"]) or l1 != now1 or l4 != SHARD_SHARDS * now1:
        raise AssertionError(f"tools (a): offers {got1}, launches {l1}/{l4} for {now1} ticks")
    cell = {"phase": "tools_sharded_offers", "preset": "tools-config9-offers", "batch": batch,
            "ticks": now1, "shards": SHARD_SHARDS, "offers": got1, "launches": l1 + l4,
            "launches_sharded": l4, "launches_unsharded": l1, "equal": ["dicts", "state", "metrics"],
            "ms_per_tick_sharded": wall4 * 1e3 / now1, "ms_per_tick_unsharded": wall1 * 1e3 / now1,
            "seconds": time.perf_counter() - t_row}
    emit(cell)
    cells.append(cell)
    del st1, st4, m1, m4
    torch.cuda.empty_cache()

    # ---- (b) the device parity check: the card against the CPU ------------------
    # Both legs ran in the parity workers (they time nothing); the card's
    # launches were counted there.
    t_row = time.perf_counter()
    result, launches = {}, 0
    for name, (card_fut, cpu_fut) in legs["parity"].items():
        card, n = card_fut.result()
        launches += n
        result[name] = device_parity_check.mismatches(card, cpu_fut.result()[0])
    ticks = sum(t for *_, t in device_parity_check.CONFIGS.values())
    if any(result.values()) or launches != ticks:
        raise AssertionError(f"tools (b): {result}, {launches} launches for {ticks} ticks")
    cell = {"phase": "tools_device_parity", "preset": "tools-device-parity",
            "configs": {n: list(c[1:]) for n, c in device_parity_check.CONFIGS.items()},
            "launches": 0, "launches_in_workers": launches, "mismatched": {}, "max_abs_err": 0,
            "seconds": time.perf_counter() - t_row}
    emit(cell)
    cells.append(cell)

    # ---- (c) repro: the broken quorum's shrink, the corpus replay ----------------
    # Both ran in the parity workers (they time nothing).
    t_row = time.perf_counter()
    (got, launches, wall), (rc, last, launches_c, wall_c) = legs["repro"]["cuda"].result()
    want = legs["repro"]["cpu"].result()[0][0]
    brief = lambda r: r and {k: r[k] for k in ("cluster", "tick", "kinds")}  # noqa: E731
    if got is None or got != want:
        raise AssertionError(f"tools (c): the card's shrink {brief(got)} != the CPU's {brief(want)}")
    if rc != 0 or last.get("reproduced") != last.get("artifacts"):
        raise AssertionError(f"tools (c): repro --corpus exit {rc}: {last}")
    cell = {"phase": "tools_repro", "preset": "tools-repro", "batch": REPRO_RUN[0],
            "ticks": REPRO_RUN[1], "chunk": REPRO_RUN[2], "cluster": got["cluster"],
            "tick": got["tick"], "kinds": got["kinds"], "equal_cpu": True,
            "corpus": last, "launches": 0, "launches_in_workers": launches + launches_c,
            "launches_shrink": launches, "launches_corpus": launches_c, "shrink_s": wall,
            "corpus_s": wall_c, "seconds": time.perf_counter() - t_row}
    emit(cell)
    cells.append(cell)

    # ---- (d) the measurement pass, its report, the traffic audit ----------------
    t_row = time.perf_counter()
    doc_path = os.path.join(work, "measurement.json")
    (rc, _), wall, launches = counted(lambda: _tool_main(cli.main, [
        "bench", "--measurement-pass", *MEASURE, "--device", "cuda", "--out", doc_path]),
        "tools (d)", spans=True)  # the scenario-path A/B draws its small rows in spans
    with open(doc_path) as f:
        doc = json.load(f)
    rc_r, report = _tool_main(metrics_report.main, ["--perf", doc_path])
    rc_a, audit = _tool_main(traffic_audit.main, ["--configs", "config3,config7x", "--json",
                                                  "--measurement", doc_path])
    if rc or rc_r or rc_a or doc["backend"] != "cuda" or "mesh scaling" not in report:
        raise AssertionError(f"tools (d): exits {rc}/{rc_r}/{rc_a}")
    if launches <= 0 or any(r.get("violations") for r in doc["matrix"].values()):
        raise AssertionError(f"tools (d): {launches} launches")
    rec = doc["reconciliation"]
    cell = {"phase": "tools_measurement", "preset": "tools-measurement-pass", "argv": MEASURE,
            "launches": launches, "wall_s": wall,
            "matrix": {n: {k: r[k] for k in ("batch", "ticks", "steady_ticks_per_s",
                                               "repeat_walls_s")}
                       for n, r in doc["matrix"].items()},
            "ab": {k: (v or {}).get("on_over_off_ticks_per_s") for k, v in doc["ab"].items()},
            "mesh_ticks_per_s": {k: r["cluster_ticks_per_s"]
                                 for k, r in doc["mesh_scaling"]["rows"].items()},
            "reconciliation": [{k: r[k] for k in ("config", "measured_ticks_per_s",
                                                  "predicted_roofline_ticks_per_s",
                                                  "roofline_fraction", "anchor")}
                               for r in rec["rows"]],
            "anchor_eligible": rec["anchor_eligible"], "report_lines": len(report.splitlines()),
            "traffic_audit": [{k: r.get(k) for k in ("config", "packed_logical", "k1_read",
                                                     "k1_written", "recorded_ticks_per_s")}
                              for r in json.loads(audit)],
            "seconds": time.perf_counter() - t_row}
    emit(cell)
    cells.append(cell)
    shutil.rmtree(work, ignore_errors=True)
    return cells


def _analysis_dynamic_leg() -> dict:
    """analysis (c): `check --race --dynamic --device cuda` in a parity
    worker (it times nothing): its exit code, JSON report and K1 launches."""
    import contextlib
    import io

    from raft_sim_tpu_torch import check
    from raft_sim_tpu_torch.kernels import tick_engine

    tick_engine.step_cuda.launches = 0
    t0 = time.perf_counter()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = check.main(["--race", "--dynamic", "--device", "cuda", "--format", "json"])
    return {"rc": rc, "report": json.loads(buf.getvalue()),
            "launches": tick_engine.step_cuda.launches, "seconds": time.perf_counter() - t0}


def _analysis_ops_leg(device: str) -> dict:
    """analysis (d): one recorded tick of each audit tier's four programs on
    `device` (analysis/op_audit.py), in a parity worker: the per-program
    rules' findings, each program's (op, output dtypes) histogram
    (`op_audit.op_dtypes`: fills, literal tables and their copies to the
    card left out), the peak
    device memory and, on the card, K1's passthrough notes."""
    import torch
    from raft_sim_tpu_torch.analysis import op_audit
    from raft_sim_tpu_torch.utils.config import PRESETS

    t0 = time.perf_counter()
    if device == "cuda":
        torch.cuda.reset_peak_memory_stats()
    found, hists = [], {}
    for name in op_audit.AUDIT_CONFIGS:
        for prog in op_audit.programs(name, PRESETS[name][0], device):
            found += (op_audit.check_float_ops(prog) + op_audit.check_plane_widening(prog)
                      + op_audit.check_carry(prog) + op_audit.check_large_constants(prog))
            hists[prog.label] = op_audit.op_dtypes(prog.records)
    out = {"findings": [f.to_json() for f in found], "hists": hists,
           "seconds": time.perf_counter() - t0}
    if device == "cuda":
        out["peak_mem_bytes"] = torch.cuda.max_memory_allocated()
        out["k1_passthrough"] = op_audit.k1_notes(device=device)
    # Pass E's interval leg: every tier's programs captured on `device` and
    # interpreted (analysis/interval.py); the records and op hashes must be
    # the CPU's.
    from raft_sim_tpu_torch.analysis import range_audit

    t0 = time.perf_counter()
    dint, captures, ifound = range_audit.derive_intervals(device=device)
    out["interval"] = {"tiers": dint["tiers"], "programs": dint["programs"],
                       "findings": [f.to_json() for f in ifound],
                       "hashes": {f"{n}/{v}": c.get("hash") for n, caps in captures.items()
                                  for v, c in caps.items() if "hash" in c},
                       "seconds": time.perf_counter() - t0}
    return out


def analysis_phase(dev, legs, resources) -> list:
    """Phase 4j: the analyzer's runtime legs on the card (the module
    docstring's 4j). (a) and (b) run here, armed against unarmed; (c) and
    (d) ran in the parity workers (`legs`), (e) on the build's ptxas report
    (`resources`, checked right after the build). Returns the cells whose
    launches count."""
    import argparse

    import torch
    from raft_sim_tpu_torch import bench, driver
    from raft_sim_tpu_torch.analysis import sanitizer
    from raft_sim_tpu_torch.serve import ServeSession
    from raft_sim_tpu_torch.utils.config import PRESETS

    cells = []
    work = os.path.join(HERE, "raft_sim_tpu_torch", "build", "analysis_phase")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)

    # ---- (a) run --sanitize at config6's batch, armed == unarmed ---------------
    t_row = time.perf_counter()
    batch, ticks, chunk = SAN_RUN
    runs = {}
    for label, arm in (("unarmed", False), ("armed", True)):
        d = os.path.join(work, label)
        sess = driver.Session(PRESETS["config6"][0], batch=batch, seed=SEED, device=dev)
        sess.attach_telemetry(d, window=chunk, ring=8)
        before = sess.state
        snap = sanitizer.snapshot(before)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with main_path_run(f"analysis (a) {label}") as n, \
                driver.sanitize_ctx(argparse.Namespace(sanitize=arm)) as san:
            sess.run(ticks, chunk=chunk)
            summ = sess.summary()  # copies to the host: waits for the device
        wall = time.perf_counter() - t0
        expect_launches(n, f"analysis (a) {label}", ticks)
        driver.sanitize_report(san)
        sess.finalize_telemetry()
        changed = sanitizer.mismatched_leaves(snap, sanitizer.snapshot(before))
        runs[label] = (sess, d, san, n.tick, wall, summ, changed)
    us, ud, _, u_launch, u_wall, u_summ, _ = runs["unarmed"]
    as_, ad, san, a_launch, a_wall, a_summ, changed = runs["armed"]
    if a_launch != ticks or u_launch != ticks:
        raise AssertionError(f"analysis (a): {u_launch}/{a_launch} kernel launches for {ticks}")
    check_equal(us.state, as_.state, "analysis (a): armed state != unarmed")
    check_equal(us.metrics, as_.metrics, "analysis (a): armed metrics != unarmed")
    if changed:
        raise AssertionError(f"analysis (a): the caller's state changed at {changed[:3]}")
    files = sorted(f for f in os.listdir(ud)
                   if f != "manifest.json" and f.endswith((".json", ".jsonl")))
    for name in files:
        with open(os.path.join(ud, name), "rb") as fu, open(os.path.join(ad, name), "rb") as fa:
            if fu.read() != fa.read():
                raise AssertionError(f"analysis (a): {name} differs armed vs unarmed")
    if san["calls"] != {"sim.telemetry._chunk_t": ticks // chunk} or not (
            san["poisoned"] > 0 and san["released"] > 0):
        raise AssertionError(f"analysis (a): sanitizer counters {san}")
    if a_summ["total_violations"] or a_summ != u_summ:
        raise AssertionError(f"analysis (a): summaries {a_summ} vs {u_summ}")
    cell = {"phase": "analysis_run_sanitize", "preset": "config6", "batch": batch,
            "ticks": ticks, "chunk": chunk, "launches": a_launch + u_launch,
            "equal": ["state", "metrics", *files], "caller_unchanged": True,
            "sanitizer": {k: v for k, v in san.items()},
            "ms_per_tick_armed": a_wall * 1e3 / ticks, "ms_per_tick_unarmed": u_wall * 1e3 / ticks,
            "seconds": time.perf_counter() - t_row}
    emit(cell)
    cells.append(cell)
    del runs, us, as_
    torch.cuda.empty_cache()

    # ---- (b) serve --sanitize on config9-serve, armed == unarmed ----------------
    t_row = time.perf_counter()
    batch9, warm, n_chunks, chunk9 = SAN_SERVE
    serves = {}
    for label, arm in (("unarmed", False), ("armed", True)):
        sess = ServeSession(PRESETS["config9"][0], batch=batch9, seed=0, chunk=chunk9,
                            window=chunk9, warmup_ticks=warm,
                            tenants=bench.serve_tenants(batch9, 4), device=dev)
        torch.cuda.synchronize()
        with main_path_run(f"analysis (b) {label}") as n, \
                driver.sanitize_ctx(argparse.Namespace(sanitize=arm)) as san:
            stats = sess.serve(chunks=n_chunks)
        expect_launches(n, f"analysis (b) {label}", n_chunks * chunk9)  # warmup ran before
        driver.sanitize_report(san)
        stats = {k: v for k, v in stats.items() if not k.endswith("_s")}
        serves[label] = (sanitizer.snapshot((sess.state, sess.metrics)), sess.delta_rows,
                         [t.acked_values for t in sess.router.tenants], stats, san, n.tick)
    u_tree, u_rows, u_acks, u_stats, _, u_launch = serves["unarmed"]
    a_tree, a_rows, a_acks, a_stats, san, a_launch = serves["armed"]
    bad = sanitizer.mismatched_leaves(u_tree, a_tree)
    if bad or u_rows != a_rows or u_acks != a_acks or u_stats != a_stats:
        raise AssertionError(f"analysis (b): armed serve differs from unarmed ({bad[:3]})")
    if a_launch != n_chunks * chunk9 or san["calls"] != {"serve.loop._serve_chunk": n_chunks} \
            or san["released"] <= 0 or a_stats["commands_acked"] <= 0:
        raise AssertionError(f"analysis (b): launches {a_launch}, sanitizer {san}, {a_stats}")
    cell = {"phase": "analysis_serve_sanitize", "preset": "config9-serve", "batch": batch9,
            "warmup": warm, "chunks": n_chunks, "chunk": chunk9, "launches": a_launch + u_launch,
            "equal": ["acks", "delta rows", "state", "metrics", "stats"],
            "commands_acked": a_stats["commands_acked"], "reads_served": a_stats["reads_served"],
            "sanitizer": {k: v for k, v in san.items()}, "seconds": time.perf_counter() - t_row}
    emit(cell)
    cells.append(cell)
    del serves
    torch.cuda.empty_cache()

    # ---- (c) check --race --dynamic on the card (run beside phase 2) ------------
    dyn = legs["dynamic"]
    rep = dyn["report"]
    if dyn["rc"] != 0 or rep["n_unwaived"] or not rep["device"].startswith("cuda"):
        raise AssertionError(f"analysis (c): check --race --dynamic exit {dyn['rc']}: {rep}")
    loops = rep["info"]["dynamic"]["loops"]
    if len(loops) != 3 or any(st["poisoned"] + st["released"] <= 0 for st in loops.values()):
        raise AssertionError(f"analysis (c): loop counters {loops}")
    emit({"phase": "analysis_check_dynamic", "exit": 0, "loops": loops,
          "launches_in_worker": dyn["launches"], "seconds": dyn["seconds"]})

    # ---- (d) the op audit's programs on the card == on the CPU (beside phase 2) --
    card, cpu = legs["ops"]["cuda"], legs["ops"]["cpu"]
    if card["findings"] or cpu["findings"]:
        raise AssertionError(f"analysis (d): findings {card['findings'][:3]} {cpu['findings'][:3]}")
    differ = [k for k in cpu["hists"] if card["hists"].get(k) != cpu["hists"][k]]
    if differ or set(card["hists"]) != set(cpu["hists"]):
        raise AssertionError(f"analysis (d): op dtypes differ card vs CPU in {differ[:4]}")
    ci, pi = card["interval"], cpu["interval"]
    if ci["findings"] or pi["findings"]:
        raise AssertionError(f"analysis (d): interval findings {ci['findings'][:3]} "
                             f"{pi['findings'][:3]}")
    if ci["hashes"] != pi["hashes"]:
        raise AssertionError(f"analysis (d): capture op hashes differ card vs CPU in "
                             f"{[k for k in pi['hashes'] if ci['hashes'].get(k) != pi['hashes'][k]][:4]}")
    if ci["tiers"] != pi["tiers"]:
        raise AssertionError(f"analysis (d): interval records differ card vs CPU in "
                             f"{[k for k in pi['tiers'] if ci['tiers'].get(k) != pi['tiers'][k]]}")
    emit({"phase": "analysis_op_audit", "programs": len(card["hists"]), "findings": 0,
          "op_dtypes_equal": True, "peak_mem_bytes": card["peak_mem_bytes"],
          "k1_passthrough": card["k1_passthrough"], "seconds_card": card["seconds"],
          "seconds_cpu": cpu["seconds"],
          "interval_programs_proven": len(ci["programs"]) * len(ci["tiers"]),
          "interval_tiers": len(ci["tiers"]),
          "interval_jax_differs": sum(len(t.get("jax_differs") or {}) for t in ci["tiers"].values()),
          "interval_legs_equal_jax": sum(len(t["legs"]) - len(t.get("jax_differs") or {})
                                         for t in ci["tiers"].values()),
          "interval_hashes_equal": True, "interval_records_equal": True,
          "interval_seconds_card": ci["seconds"], "interval_seconds_cpu": pi["seconds"]})

    # ---- (e) cost-kernel-resources against the build's ptxas report -----------
    if resources["findings"]:
        raise AssertionError(f"analysis (e): {resources['findings'][:3]}")
    emit({"phase": "analysis_kernel_resources", "instantiations": resources["instantiations"],
          "classes": resources["classes"], "findings": 0})
    launches = sum(c["launches"] for c in cells)
    emit({"phase": "analysis_launches", "main": launches, "workers": dyn["launches"]})
    shutil.rmtree(work, ignore_errors=True)
    return cells


def parity_phases(pool, proxy_build, t_start: float) -> None:
    """Phases 2, 2b and 3 (see the module docstring): rows that time nothing,
    run in `pool`'s worker processes on the card (`_parity_row`,
    `_proxy_row`, `_card_vs_cpu_row`), their lines printed in row order.
    `proxy_build` is the race proxy's build (a future, done with the card's
    build); 2b's rows are queued after phase 2's. Every comparison raises on the first differing leaf,
    so an exact match (max |err| 0) is what reaching the kernels line means."""
    from raft_sim_tpu_torch.kernels import tick_engine
    from raft_sim_tpu_torch.utils.config import PRESETS

    # ---- 2: kernel vs plain, on the card ---------------------------------------
    # 45 clusters: a ragged, masked last block at any block shape (8, 16 or
    # 32 clusters a block). config6-cap8 makes followers fall behind the
    # leader's base, so the InstallSnapshot path runs (config6 itself sends no
    # sentinel at this size).
    cfg6 = PRESETS["config6"][0]
    parity = [(name, PRESETS[name][0], 1 if name == "config1" else 200, 64)
              for name in ("config1", "config2", "config3", "config4", "config5", "config3p")]
    parity += [(f"{name}-ragged-b45", PRESETS[name][0], 45, 64) for name in ("config2", "config5")]
    cap8 = dataclasses.replace(cfg6, log_capacity=8, compact_margin=4, max_entries_per_rpc=2,
                               client_interval=2)
    parity += [("config6", cfg6, 200, 96), ("config6r", PRESETS["config6r"][0], 200, 96),
               ("config6-cap8", cap8, 200, 96),
               ("config8", PRESETS["config8"][0], 200, 160), ("config9", PRESETS["config9"][0], 200, 96),
               ("config10", PRESETS["config10"][0], 200, 128)]
    # Slice 6: config4c, and clusters above 64 nodes -- config7 (N=101, width
    # tier 4), its mix dense at N=128 (int16 node ids) and at N=255 (width
    # tier 8) under partitions, and the full gate body at N=101.
    slice2_rows = {name for name, *_ in parity} - {"config8", "config9", "config10"}
    cfg7 = PRESETS["config7"][0]
    wide = {
        "config7-mix-n128": dataclasses.replace(cfg7, n_nodes=128),
        "config7-mix-n255-partitions": dataclasses.replace(cfg7, n_nodes=255, partition_period=32,
                                                           partition_prob=0.25),
    }
    parity += [("config4c", PRESETS["config4c"][0], 200, 64), ("config7", cfg7, 200, 64),
               ("config7-ragged-b45", cfg7, 45, 64)]
    parity += [(f"{name}-b45", cfg, 45, 48) for name, cfg in wide.items()]
    parity += [("n101-full-gates", n101_full_gates(), 200, 96)]
    # Slice 7: log matching on the compacting ring (K1-b).
    ring_lm = {
        "config6-lm": (dataclasses.replace(cfg6, check_log_matching=True), 200, 160),
        # config9's CAP=64 ring first compacts near tick 300 at this batch.
        "config9-lm": (dataclasses.replace(PRESETS["config9"][0], check_log_matching=True), 200, 400),
        "config6-cap8-lm": (dataclasses.replace(cap8, check_log_matching=True), 200, 128),
        "config7-mix-n101-compaction-lm-b45": (
            dataclasses.replace(cfg7, compact_margin=4, check_log_matching=True), 45, 96),
    }
    parity += [(name, cfg, batch, ticks) for name, (cfg, batch, ticks) in ring_lm.items()]
    # K1's AppendEntries windows above its old limit of 16: E = 32 on a
    # 64-slot log, a client every tick under drop (lagging followers are
    # sent windows of up to 25-27 entries in 96 ticks, the CPU's plain tick).
    parity += [("n5-e32-cap64", dataclasses.replace(PRESETS["config2"][0], log_capacity=64,
                                                    max_entries_per_rpc=32, client_interval=1,
                                                    drop_prob=0.3), 200, 96)]
    # The longest rows are queued first, so that the workers end together.
    futs = {name: None for name, *_ in parity}
    for name, cfg, batch, ticks in sorted(parity, key=lambda r: -r[3]):
        futs[name] = pool.submit(_parity_row, name, cfg, batch, ticks)

    # 2b's rows: the race proxy on one cluster and on a ragged 45 of every
    # gate set and width tier. No race checker runs on this machine
    # (PERF.md), so the proxy build of the kernel (csrc/tick.cu with
    # RS_RACE_PROXY: node slots and clusters mapped to threads in reverse,
    # each exchange field poisoned once its last reader's phase is over) is
    # held to the plain tick. Its library built with the card's, before any
    # card row.
    t0 = time.perf_counter()
    proxy_path = proxy_build.result()
    proxy_waited = time.perf_counter() - t0
    proxy_rows = [("config1", PRESETS["config1"][0], 1, 32), ("config7", cfg7, 1, 32)]
    proxy_rows += [(name, PRESETS[name][0], 45, 32)
                   for name in ("config2", "config5", "config3p", "config6", "config6r", "config8",
                                "config9", "config10", "config4c", "config7")]
    proxy_rows += [(name, cfg, 45, 32) for name, cfg in wide.items()]
    proxy_rows += [("config6-cap8-lm", ring_lm["config6-cap8-lm"][0], 45, 32)]
    proxy_futs = [pool.submit(_proxy_row, *row) for row in proxy_rows]
    # ---- 3: card vs CPU --------------------------------------------------------
    cpu_futs = [pool.submit(_card_vs_cpu_row, *row) for row in (
        ("config2", 64, 32), ("config4", 64, 32), ("config6r", 64, 32), ("config3p", 64, 32),
        ("config8", 64, 32), ("config9", 64, 32), ("config10", 64, 32), ("config7", 16, 32))]

    events = {"restarts": 0, "compactions": 0, "snapshot_sentinels": 0, "redirect_bounces": 0}
    slice3 = {"config_appends": 0, "joint_exits": 0, "timeout_now_sent": 0, "sanctioned_votes": 0,
              "reads_served_config8": 0, "one_tick_reads_config9": 0,
              "config_rollbacks": 0, "removed_leader_stepdowns": 0}
    for name, cfg, batch, ticks in parity:
        line, ev = futs[name].result()
        if name == "config10":
            slice4 = {k: ev[k] for k in (*SLICE4_REQUIRED, "jitter_stalls", "restarts")}
        elif name in ("config8", "config9"):
            for k in slice3:
                slice3[k] += ev.get(k, 0)
            if name == "config8":
                slice3["reads_served_config8"] += ev["reads_served"]
            else:  # config9's one-tick reads are lease serves
                slice3["one_tick_reads_config9"] += ev["one_tick_reads"]
        elif name in slice2_rows:
            for k in events:
                events[k] += ev[k]
        elif name == "n101-full-gates":
            slice6 = {k: ev[k] for k in SLICE6_REQUIRED}
        elif name in ring_lm:
            slice7 = {k: ev[k] for k in ("lm_skipped_pairs", "viol_log_matching", "compactions",
                                         "restarts")}
            emit({"phase": "slice7_events", "preset": name, "batch": batch, "ticks": ticks, **slice7})
            if slice7["viol_log_matching"] or slice7["compactions"] <= 0:
                raise AssertionError(f"{name}: {slice7}")
            if name == "config6-cap8-lm" and slice7["lm_skipped_pairs"] <= 0:
                raise AssertionError(f"{name}: no incomparable pair met ({slice7})")
        elif name == "n5-e32-cap64" and ev["widest_window"] <= 16:
            raise AssertionError(f"{name}: no window above 16 entries was sent ({dict(ev)})")
        emit(line)
    emit({"phase": "slice2_events", **events})
    for k, v in events.items():
        if v <= 0:
            raise AssertionError(f"kernel_vs_plain: no {k} on the slice-2 runs")
    emit({"phase": "slice3_events", **slice3})
    for k, v in slice3.items():
        if v <= 0 and k not in ("config_rollbacks", "removed_leader_stepdowns"):
            raise AssertionError(f"kernel_vs_plain: no {k} on the slice-3 runs")
    emit({"phase": "slice4_events", **slice4})
    for k in SLICE4_REQUIRED:
        if slice4[k] <= 0:
            raise AssertionError(f"kernel_vs_plain: no {k} on the config10 run")
    emit({"phase": "slice6_events", **slice6})
    for k in SLICE6_REQUIRED:
        if slice6[k] <= 0:
            raise AssertionError(f"kernel_vs_plain: no {k} on the n101-full-gates run")
    emit({"phase": "phase_end", "name": "kernel_vs_plain", "seconds": time.perf_counter() - t_start})

    emit({"phase": "race_proxy_build", "waited_s": proxy_waited,
          "nvcc_seconds": tick_engine.PROXY_BUILD_INFO.get("seconds"),
          "library": os.path.relpath(proxy_path, HERE)})
    for fut in proxy_futs:
        emit(fut.result())
    emit({"phase": "phase_end", "name": "race_proxy", "seconds": time.perf_counter() - t_start})
    for fut in cpu_futs:
        emit(fut.result())
    emit({"phase": "phase_end", "name": "card_vs_cpu", "seconds": time.perf_counter() - t_start})


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(HERE, "raft_sim_tpu_torch")):
        print(f"chip_smoke: no raft_sim_tpu_torch package beside {__file__}: run it from a "
              "checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    import raft_sim_tpu_torch
    from raft_sim_tpu_torch.kernels import draw_engine, tick_engine
    from raft_sim_tpu_torch import bench
    from raft_sim_tpu_torch.models import raft_batched
    from raft_sim_tpu_torch.sim import scan
    from raft_sim_tpu_torch.summary import summarize
    from raft_sim_tpu_torch.utils import threefry
    from raft_sim_tpu_torch.utils.config import PRESETS

    if not os.path.abspath(raft_sim_tpu_torch.__file__).startswith(HERE + os.sep):
        raise RuntimeError(f"raft_sim_tpu_torch imported from {raft_sim_tpu_torch.__file__}, not {HERE}")
    dev = torch.device("cuda")
    t_start = time.perf_counter()

    # ---- 1: device and build ---------------------------------------------------
    smi = bench.card_line()
    emit({"phase": "device", "nvidia_smi": smi, "torch": torch.__version__,
          "cuda": torch.version.cuda, "kind": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count()})
    # The parity workers start now, their start-up (torch, a context on the
    # card) beside the build. The rows on the CPU alone need no library and
    # start beside it too (observe (b) and (e), compact (e)'s bench runs).
    # The race proxy's library builds together with the card's, both before
    # any card row is queued: beside the workers' card rows its nvcc ran
    # 1.4-2.8x slower than alone (PERF.md). On any failure the workers are
    # stopped and the build's thread joined, so no process outlives the
    # script.
    parity_pool = ProcessPoolExecutor(max_workers=PARITY_WORKERS, initializer=_parity_init,
                                      mp_context=multiprocessing.get_context("spawn"))
    pool = ThreadPoolExecutor(max_workers=1)
    legs_dir = os.path.join(HERE, "raft_sim_tpu_torch", "build", "parity_legs")
    shutil.rmtree(legs_dir, ignore_errors=True)
    os.makedirs(legs_dir)
    draws_build = draws_proxy_build = None
    try:
        obs_legs = {"cpu": parity_pool.submit(_observe_leg, "cpu", legs_dir)}
        trace_b = {"cpu": parity_pool.submit(_trace_small_leg, "cpu", legs_dir)}
        bench_legs = {"cpu": parity_pool.submit(_compact_bench_leg, "cpu", legs_dir)}
        t0 = time.perf_counter()
        draws_build = draw_engine.start_build()  # K2's one nvcc, beside K1's nine
        draws_proxy_build = draw_engine.start_build(proxy=True)  # and its race proxy's
        proxy_build = pool.submit(tick_engine.build, proxy=True)
        lib_path = tick_engine.build()
        tick_engine._load_cuda()
        draws_path = draw_engine.finish_build(draws_build)
        draw_engine._load_cuda()
        draws_proxy_path = draw_engine.finish_build(draws_proxy_build, proxy=True)
        BLOCK_OPS.update(draw_engine.sass_block_ops(draws_path))  # K2's bound, from its SASS
        card_s = time.perf_counter() - t0
        proxy_path = proxy_build.result()
        # One entry per instantiation: its name, then stack/spill and registers.
        ptxas = [ln.split("ptxas info    :")[-1].strip()
                 for ln in tick_engine.BUILD_INFO.get("ptxas", "").splitlines()
                 if "Compiling entry" in ln or "registers" in ln or "stack frame" in ln]
        # analysis (e): the build's ptxas report against its pins.
        from raft_sim_tpu_torch.analysis import cost_model

        with open(cost_model.golden_path()) as f:
            pins = json.load(f)["kernel_resources"]
        report = tick_engine.ptxas_report()
        resources = {"findings": [x.to_json()
                                  for x in cost_model.check_kernel_resources(report, pins)],
                     "instantiations": len(report), "classes": sorted(pins)}
        draws_ptxas = [ln.split("ptxas info    :")[-1].strip()
                       for ln in draw_engine.BUILD_INFO.get("ptxas", "").splitlines()
                       if "Compiling entry" in ln or "registers" in ln or "stack frame" in ln]
        emit({"phase": "build", "seconds": time.perf_counter() - t0, "card_seconds": card_s,
              "nvcc_seconds": tick_engine.BUILD_INFO.get("seconds"),
              "proxy_nvcc_seconds": tick_engine.PROXY_BUILD_INFO.get("seconds"),
              "draws_nvcc_seconds": draw_engine.BUILD_INFO.get("seconds"),
              "library": os.path.relpath(lib_path, HERE),
              "draws_library": os.path.relpath(draws_path, HERE),
              "proxy_library": os.path.relpath(proxy_path, HERE),
              "draws_proxy_library": os.path.relpath(draws_proxy_path, HERE), "ptxas": ptxas,
              "draws_ptxas": draws_ptxas, "draws_block_ops": BLOCK_OPS})
        # The other rows that time nothing join phase 2's, the longest first:
        # observe (b) and (e) and compact (e)'s bench runs on the card, trace
        # (a), serve (a), compact (a), (d) and (e)'s other entry points. Every
        # worker is done before phase 4 times anything; each phase prints its
        # rows' lines in its place.
        # shard (c)'s two processes first: their start-up overlaps the rest;
        # then analysis (c) and (d)'s legs.
        multihost = parity_pool.submit(_multihost_leg)
        analysis_legs = {"dynamic": parity_pool.submit(_analysis_dynamic_leg),
                         "ops": {d: parity_pool.submit(_analysis_ops_leg, d)
                                 for d in ("cuda", "cpu")}}
        obs_legs["cuda"] = parity_pool.submit(_observe_leg, "cuda", legs_dir)
        trace_b["cuda"] = parity_pool.submit(_trace_small_leg, "cuda", legs_dir)
        bench_legs["cuda"] = parity_pool.submit(_compact_bench_leg, "cuda", legs_dir)
        draws_futs = [parity_pool.submit(_draws_row, *row) for row in draws_rows()]
        trace_futs = [parity_pool.submit(_trace_row, name) for name in TRACE_ROWS]
        served_futs = [parity_pool.submit(_served_row, *row) for row in served_rows()]
        compact_futs = [parity_pool.submit(_compact_row, *row) for row in compact_rows()]
        compact_cpu_futs = [parity_pool.submit(_compact_cpu_row, name, batch)
                            for name, batch in (("config5c", 16), ("config7x", 4))]
        scan_fut = parity_pool.submit(_compact_scan_runs)
        # tools (b) and (c)'s legs on the card and on the CPU: the device
        # parity configs at their own sizes, the repro shrink and the corpus
        # replay. The CPU legs wait for the build, whose two nvcc runs take
        # every core.
        from raft_sim_tpu_torch import device_parity_check

        tools_legs = {"parity": {name: tuple(parity_pool.submit(_device_parity_leg, name, d)
                                             for d in ("cuda", "cpu"))
                                 for name in device_parity_check.CONFIGS},
                      "repro": {d: parity_pool.submit(_repro_leg, d) for d in ("cuda", "cpu")}}
        parity_phases(parity_pool, proxy_build, t_start)
        for fut in draws_futs:
            emit(fut.result())
        emit({"phase": "phase_end", "name": "draws_vs_plain",
              "seconds": time.perf_counter() - t_start})
        trace_a = [f.result() for f in trace_futs]
        served = [f.result() for f in served_futs]
        compact_legs = {"rows": [f.result() for f in compact_futs],
                        "card_vs_cpu": [f.result() for f in compact_cpu_futs],
                        "bench": {d: f.result() for d, f in bench_legs.items()},
                        "scan": scan_fut.result()}
        obs_legs = {d: f.result() for d, f in obs_legs.items()}
        trace_b = {d: f.result() for d, f in trace_b.items()}
        for fut in (*(f for pair in tools_legs["parity"].values() for f in pair),
                    *tools_legs["repro"].values(), multihost):
            fut.result()
        analysis_legs = {"dynamic": analysis_legs["dynamic"].result(),
                         "ops": {d: f.result() for d, f in analysis_legs["ops"].items()}}
    finally:
        parity_pool.shutdown(cancel_futures=True)
        pool.shutdown()
        for started in (draws_build, draws_proxy_build):  # K2's nvcc runs, if the build failed
            if started is not None:                       # before they were waited for
                started[0].kill()
    shutil.rmtree(legs_dir, ignore_errors=True)
    emit({"phase": "phase_end", "name": "parity_workers", "seconds": time.perf_counter() - t_start})

    # ---- 4: full width, the main path -----------------------------------------
    cells = []
    total_launches = 0
    # The SM clock under the draws' load, for K2's bound: config3's draws at
    # its batch, over and over for a second.
    cfg3, b3 = PRESETS["config3"]
    k3 = scan.fleet_keys(SEED, b3, dev)[1]
    SM_CLOCK["mhz"] = bench.sm_clock_mhz(lambda: draw_engine.draw_cuda(cfg3, k3, 0))
    emit({"phase": "sm_clock", "mhz": SM_CLOCK["mhz"], "load": "config3 draws, 100,000 clusters"})
    del k3
    # 128 full-width ticks a cell, so the script keeps well inside its time
    # limit with the later phases beside them (the crash cells' input draws
    # take 50-120 ms a tick, by the host); longer where a liveness check
    # needs the depth: config6/config6r's and config9's rings must wrap
    # (256 and 352), and every config4c cluster must commit (320); config8
    # offers its first membership toggle at tick 97, so its 128 ticks see
    # config entries appended (checked below).
    full_cells = (("config2", 128), ("config3", 128), ("config4", 128), ("config5", 128),
                  ("config6", 256), ("config6r", 256), ("config3p", 128), ("config8", 128),
                  ("config9", 352), ("config10", 128), ("config4c", 320), ("config7", 128))
    for name, ticks in full_cells:
        cfg, batch = PRESETS[name]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        with main_path_run(name) as n:
            final, metrics = scan.simulate(cfg, SEED, batch, ticks, device=dev)
            summ = summarize(metrics)  # copies to the host: waits for the device
        wall = time.perf_counter() - t0
        launches, draw_launches = n.tick, n.draws
        peak = torch.cuda.max_memory_allocated()
        total_launches += launches
        expect_launches(n, name, ticks)
        if summ.total_violations != 0:
            raise AssertionError(f"{name}: {summ.total_violations} violations")
        if int((metrics.first_leader_tick >= scan.NEVER).sum()) != 0:
            raise AssertionError(f"{name}: a cluster never elected a leader")
        min_commit = int(metrics.max_commit.min())  # the least of the clusters' max commits
        if cfg.client_interval and not (summ.total_cmds > 0 and min_commit > 0):
            raise AssertionError(f"{name}: a cluster committed no client command")
        if cfg.compaction and min_commit <= cfg.log_capacity:
            raise AssertionError(f"{name}: a cluster's ring never wrapped (min max_commit {min_commit})")
        if cfg.read_index and int((metrics.reads_served <= 0).sum()) != 0:
            raise AssertionError(f"{name}: a cluster served no read")
        # Clusters in which a node holds a config entry (cfg_epoch above 0).
        member_clusters = int((final.cfg_epoch > 0).any(dim=-1).sum())
        if cfg.reconfig_interval and member_clusters == 0:
            raise AssertionError(f"{name}: no membership change was appended in {ticks} ticks")
        if cfg.durable_storage:
            if int((metrics.fsync_lag_sum <= 0).sum()) != 0:
                raise AssertionError(f"{name}: a cluster's disk never lagged its log")
            if bool((final.dur_len > final.log_len).any()):
                raise AssertionError(f"{name}: a node's dur_len passed its log_len")

        s = raft_batched.to_batch_minor(final)
        shape = tick_engine.launch_shape(cfg, batch, dev)
        shape.update(tick_engine.kernel_report(cfg, s, shape["nodes_per_thread"]), body="node-parallel")
        emit({"phase": "kernel_shape", "preset": name, "batch": batch, **shape})

        # Kernel vs plain at full width from the run's final state, for
        # FULL_HOLD_TICKS ticks (one log-matching tick at config5's interval
        # of 16, two client offers at config2's interval of 8).
        keys = threefry.split(threefry.split(threefry.key(SEED, dev), 2)[1], batch)
        hold_ticks(cfg, s, keys, ticks, FULL_HOLD_TICKS, f"{name} full width")

        # Per-tick breakdown on the run's final state, at full width.
        inp = draw_engine.draw_cuda(cfg, keys, ticks)
        m_t = raft_batched.to_batch_minor(scan.init_metrics_batch(batch, dev))
        _, info = tick_engine.step_cuda(cfg, s, inp, ticks)
        kernel_ms = tick_engine.time_kernel(cfg, s, inp, reps=20, now=ticks)
        inputs_ms = wall_ms(lambda: draw_engine.draw_plain(cfg, keys, ticks), 5)
        draws = draws_cell(cfg, keys, ticks, batch)
        step_ms = wall_ms(lambda: tick_engine.step_cuda(cfg, s, inp, ticks), 10)
        plain_ms = wall_ms(lambda: raft_batched.step_b(cfg, s, inp, ticks), 3)
        acc_ms = wall_ms(lambda: scan._accumulate(m_t, info, s.now), 10)
        rd, wr = tick_engine.traffic_bytes(cfg, batch)
        bound_ms = (rd + wr) / BW_BYTES_PER_S * 1e3
        cell = {
            "phase": "full_width", "preset": name, "batch": batch, "ticks": ticks,
            "launches": launches, "draws_launches": draw_launches,
            "kernel_vs_plain_ticks": FULL_HOLD_TICKS, "wall_s": wall,
            "ms_per_tick": wall * 1e3 / ticks, "cluster_ticks_per_s": batch * ticks / wall,
            "kernel_ms": kernel_ms, "bound_ms": bound_ms, "bytes_read": rd,
            "bytes_written": wr, "bound_share": bound_ms / kernel_ms,
            "inputs_ms": inputs_ms, **draws, "step_ms": step_ms, "plain_ms": plain_ms,
            "accumulate_ms": acc_ms, "peak_mem_bytes": peak,
            "max_commit_min": min_commit,
            "max_commit_median": float(metrics.max_commit.float().median()),
            "noop_blocked": int(metrics.noop_blocked.sum()),
            "reads_served_min": int(metrics.reads_served.min()),
            "membership_clusters": member_clusters,
            "fsync_lag_sum_min": int(metrics.fsync_lag_sum.min()),
            "summary": summ._asdict(), "shape": shape,
        }
        cells.append(cell)
        emit(cell)
        del final, metrics, s, inp, info
        torch.cuda.empty_cache()

    emit({"phase": "phase_end", "name": "full_width", "seconds": time.perf_counter() - t_start})

    def phase_draws(name: str) -> None:
        """Print K1's and K2's launches over phase `name`'s counted runs
        (MAIN_PATH since the last call)."""
        emit({"phase": "draws_launches", "name": name, "tick_launches": MAIN_PATH["tick"] - seen[0],
              "launches": MAIN_PATH["draws"] - seen[1]})
        seen[:] = [MAIN_PATH["tick"], MAIN_PATH["draws"]]

    seen = [MAIN_PATH["tick"], MAIN_PATH["draws"]]
    # ---- 4b: the long-horizon path, config6 with log matching at 1,000 ---------
    long_cell = long_run(dev, hold_ticks, wall_ms)
    cells.append(long_cell)
    total_launches += long_cell["launches"]
    phase_draws("long_run")
    emit({"phase": "phase_end", "name": "long_run", "seconds": time.perf_counter() - t_start})

    # ---- 4c: the serve path, the config9-serve row at 1,000 -------------------
    serve_cell, serve_unarmed = serve_phase(dev, wall_ms, served)
    cells.append(serve_cell)
    total_launches += serve_cell["launches"]
    phase_draws("serve")
    emit({"phase": "phase_end", "name": "serve", "seconds": time.perf_counter() - t_start})

    # ---- 4d: the scenario engine under the mutant hooks ------------------------
    scen_cell = scenario_phase(dev, wall_ms, hold_ticks)
    cells.append(scen_cell)
    total_launches += scen_cell["launches"]
    phase_draws("scenario")
    emit({"phase": "phase_end", "name": "scenario", "seconds": time.perf_counter() - t_start})

    # ---- 4e: the protocol trace plane --------------------------------------------
    for cell in trace_phase(dev, wall_ms, trace_a, trace_b):
        cells.append(cell)
        total_launches += cell["launches"]
    phase_draws("trace")
    emit({"phase": "phase_end", "name": "trace", "seconds": time.perf_counter() - t_start})

    # ---- 4f: the compacted carry layout -------------------------------------------
    config5_cell = next(c for c in cells if c["preset"] == "config5")
    for cell in compact_phase(dev, wall_ms, hold_ticks, config5_cell, compact_legs):
        cells.append(cell)
        total_launches += cell["launches"]
    phase_draws("compact")
    emit({"phase": "phase_end", "name": "compact", "seconds": time.perf_counter() - t_start})

    # ---- 4g: the observability planes and the farm --------------------------------
    for cell in observe_phase(dev, serve_unarmed, obs_legs):
        cells.append(cell)
        total_launches += cell["launches"]
    del serve_unarmed
    phase_draws("observe")
    emit({"phase": "phase_end", "name": "observe", "seconds": time.perf_counter() - t_start})

    # ---- 4h: the multi-device tier on the one card --------------------------------
    for cell in shard_phase(dev, multihost):
        cells.append(cell)
        total_launches += cell["launches"]
    phase_draws("shard")
    emit({"phase": "phase_end", "name": "shard", "seconds": time.perf_counter() - t_start})

    # ---- 4i: the sharded planes and the tools tier ---------------------------------
    for cell in tools_phase(dev, tools_legs):
        cells.append(cell)
        total_launches += cell["launches"]
    phase_draws("tools")
    emit({"phase": "phase_end", "name": "tools", "seconds": time.perf_counter() - t_start})

    # ---- 4j: the analyzer's runtime legs ------------------------------------------
    for cell in analysis_phase(dev, analysis_legs, resources):
        cells.append(cell)
        total_launches += cell["launches"]
    phase_draws("analysis")
    emit({"phase": "phase_end", "name": "analysis", "seconds": time.perf_counter() - t_start})

    # ---- 5: the port's bench row, card vs CPU -----------------------------------
    cfg2 = PRESETS["config2"][0]
    with main_path_run("bench_row") as n:
        row_g = bench.bench(cfg2, 64, 100, repeats=2, quality_seeds=3, config_name="config2",
                            device=dev)
    if n.tick <= 0 or n.draws != n.tick:
        raise AssertionError(f"bench_row: {n.tick} tick and {n.draws} draw launches")
    phase_draws("bench_row")
    row_c = bench.bench(cfg2, 64, 100, repeats=2, quality_seeds=3, config_name="config2", device="cpu")
    quality = ("p50_stable_tick", "pct_stable", "p50_commit_latency", "lat_p50", "lat_p95", "lat_p99",
               "lat_excluded", "total_cmds", "violations", "noop_blocked", "lm_skipped_pairs",
               "multi_leader")
    differ = [k for k in quality if row_g[k] != row_c[k]]
    if differ:
        raise AssertionError(f"bench_row: card != CPU on {differ}")
    if row_g["backend"] != "cuda" or row_g.get("nvidia_smi") != smi or not row_g.get("device"):
        raise AssertionError(f"bench_row: the card's row lacks its backend or card: {row_g}")
    emit({"phase": "bench_row", "preset": "config2", "quality_equal": True, "card": row_g,
          "cpu_cluster_ticks_per_s": row_c["cluster_ticks_per_s"]})

    # ---- 6: the kernels line, the card, the result -----------------------------
    emit({"phase": "elapsed", "seconds": time.perf_counter() - t_start})
    # config3: the 100,000-cluster BASELINE throughput row.
    main_cell = next(c for c in cells if c["preset"] == "config3")
    draws_keys = ("batch", "draws_ms", "draws_bound_ms", "draws_bound_by", "draws_bound_share",
                  "inputs_ms", "draws_launches", "ms_per_tick", "wall_ms_per_tick")
    emit({"kernels": [{
        "name": "tick",
        "route": "cuda",
        "source": "raft_sim_tpu_torch/csrc/tick.cu",
        "replaces": "raft_sim_tpu/experiments/pallas_engine.py:70",
        "launches": total_launches,
        "max_abs_err": 0,  # every comparison above raises on a differing leaf
        "ms": main_cell["kernel_ms"],
        "plain_ms": main_cell["plain_ms"],
        "bound_ms": main_cell["bound_ms"],
        "bound_by": "bytes",
        "library_ms": None,
        "match": True,
        "measured_at": f"{main_cell['preset']} batch {main_cell['batch']}",
        "cells": {c["preset"]: {k: c[k] for k in ("batch", "kernel_ms", "bound_ms", "plain_ms",
                                                  "launches", "kernel_vs_plain_ticks", "shape")
                                if k in c}
                  for c in cells},
    }, {
        "name": "draws",
        "route": "cuda",
        "source": "raft_sim_tpu_torch/csrc/draws.cu",
        "replaces": "raft_sim_tpu/sim/faults.py:302 (XLA-fused on the TPU; no Pallas kernel)",
        "launches": MAIN_PATH["draws"],  # K2 in the counted runs (checks and timings left out)
        "max_abs_err": 0,  # every draws_vs_plain row and cell check raises on a differing leaf
        "ms": main_cell["draws_ms"],
        "plain_ms": main_cell["inputs_ms"],
        "bound_ms": main_cell["draws_bound_ms"],
        "bound_by": main_cell["draws_bound_by"],
        "library_ms": None,
        "match": True,
        "measured_at": f"{main_cell['preset']} batch {main_cell['batch']}",
        "sm_clock_mhz": SM_CLOCK["mhz"],
        "block_ops": BLOCK_OPS,
        "cells": {c["preset"]: {k: c[k] for k in draws_keys if k in c}
                  for c in cells if "draws_ms" in c},
    }]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Simulator configuration (the port's own copy of raft_sim_tpu/utils/config.py).

The port never imports the JAX package -- importing raft_sim_tpu.utils.config
runs raft_sim_tpu/__init__.py, which imports jax -- so this module restates
RaftConfig, its validator, its derived properties and PRESETS field for field.
tests/test_torch_config.py holds every default, property and preset equal to
the JAX package's.

The reference hardcodes every constant: host 127.0.0.1 (core.clj:11), port 8080+id
(core.clj:13), log filename (core.clj:17), channel buffer sizes 5 (server.clj:37,
client.clj:18), heartbeat 3000 ms and election timeout 5000+rand(5000) ms
(core.clj:171-174), and takes topology from CLI args (core.clj:197-200).

Here every knob lives in one frozen (hashable) dataclass so a config can be a static
`jit` argument: cluster size, log capacity, timer windows in *tick units* (the reference's
3000 ms heartbeat : 5000-10000 ms election ratio is preserved as 3 : 6-12 ticks), and the
fault-injection schedule parameters. The five BASELINE.json configs are named presets in
`PRESETS`.
"""

from __future__ import annotations

import dataclasses

# Saturation ceilings for ClusterState.ack_age (ticks since a peer's last
# AppendEntries ack; re-exported by types.py). Ages cap instead of growing
# without bound so the field fits a narrow dtype on arbitrarily long runs: int8
# saturating at 120 when ack_timeout_ticks fits under it (every preset does --
# the timeout is a small multiple of the heartbeat), else int16 at 30000.
# Saturation only has to exceed the timeout: every consumer tests
# `age <= ack_timeout_ticks`, so trajectories are identical at either ceiling
# (only the saturated VALUES differ). Lives here (not types.py) because the
# config validator needs it and config is the leaf module.
ACK_AGE_SAT_NARROW = 120
ACK_AGE_SAT = 30000

# --- Ceiling derivations (single source for types.py and analysis Pass E) ---
#
# The narrow-dtype ceilings used to live as hand-computed literals with ad-hoc
# module-level asserts in types.py. They are now DERIVED here from the two
# encoding bounds that motivate them, so the constants, the dtype-policy
# functions in types.py, and the value-range audit (analysis/range_audit.py)
# all read one formula and cannot drift apart.


def window_min_encoding_max(log_capacity: int) -> int:
    """Largest value the single-pass window-start min ever encodes.

    models/raft_batched.py phase 8 folds responsiveness into one min by
    biasing prev-index (0..cap) with K = cap + 1: self contributes +2K,
    unresponsive peers +K, so the ceiling is 2K + cap = 3*cap + 2.
    """
    return 3 * log_capacity + 2


def max_log_capacity_for(dtype_max: int) -> int:
    """Largest log_capacity whose window-min encoding fits a dtype ceiling."""
    return (dtype_max - 2) // 3


def max_nodes_for(dtype_max: int) -> int:
    """Largest n_nodes whose node-id vocabulary fits a dtype ceiling.

    Node planes carry ids 0..n-1, NIL = -1, and the out-of-range sentinel n
    (reconfig swaps use it as "no node"), so n itself must fit: n <= dtype_max
    with one slot to spare for the sentinel -> ceiling dtype_max - 1.
    """
    return dtype_max - 1


# Upper bound on RaftConfig.log_capacity. Log indices ride int16 state planes
# at most (ClusterState.next_index/match_index; int8 below
# types.MAX_INT8_LOG_CAPACITY = max_log_capacity_for(127)), and the
# single-pass window-start min (models/raft_batched.py phase 8) encodes its
# responsiveness fallback with K = cap + 1 offsets, so its largest encoded
# value window_min_encoding_max(cap) = 3 * cap + 2 must fit the plane dtype.
MAX_LOG_CAPACITY = 4095
assert window_min_encoding_max(MAX_LOG_CAPACITY) <= 32767  # int16 tier


@dataclasses.dataclass(frozen=True)
class RaftConfig:
    """Static simulation parameters (hashable -> usable as a static jit arg)."""

    # Topology (reference: CLI args, core.clj:197-200; dev default 3 nodes, dev/user.clj:14)
    n_nodes: int = 5

    # Replicated log (reference: unbounded vector, log.clj:33; XLA needs static shapes)
    log_capacity: int = 32
    # Max entries shipped per AppendEntries RPC (reference ships arbitrary suffixes,
    # core.clj:59-67; a bounded window keeps the mailbox record fixed-width)
    max_entries_per_rpc: int = 4

    # Timers, in ticks (reference: 3000 ms heartbeat, 5000+rand(5000) ms election,
    # core.clj:171-174 -- same 3 : 6..12 ratio here)
    heartbeat_ticks: int = 3
    election_min_ticks: int = 6
    election_range_ticks: int = 6

    # Fault injection (reference's only "fault" is a silently dropped HTTP call,
    # client.clj:38-40; here faults are first-class pure inputs)
    drop_prob: float = 0.0
    # If True, each cluster draws its own drop probability uniformly from [0, drop_prob]
    # (BASELINE config 4: p in [0, 0.3]).
    drop_prob_uniform: bool = False
    # Rolling partitions: every `partition_period` ticks, with prob `partition_prob`,
    # split the cluster into two random halves that cannot exchange messages.
    partition_period: int = 0
    partition_prob: float = 0.0
    # Clock skew: each tick, a node's local clock advances by 0 or 2 instead of 1 with
    # this probability (split evenly between stall and jump).
    clock_skew_prob: float = 0.0
    # Node crash/restart: the reference's real-world failure mode is a killed process
    # restarting with amnesia -- only committed values hit disk (log.clj:16-18), so
    # term/vote/entries are lost (bug 2.3.12). Here restart is spec-correct: the Raft
    # persistent triple (currentTerm, votedFor, log[]) survives; everything else
    # (role, leaderId, votes, next/matchIndex, commitIndex, timers) is volatile and
    # wiped. The schedule is a pure function of (cluster key, tick): time is split
    # into windows of `crash_period` ticks; in each window each node independently
    # crashes with prob `crash_prob`, staying down for a uniform 1..`crash_down_ticks`
    # span at a random offset (clipped at the window edge).
    crash_prob: float = 0.0
    crash_period: int = 64
    crash_down_ticks: int = 12

    # Shared-entry-window responsiveness horizon (ticks). A leader's AppendEntries
    # entry payload is one shared E-entry window per tick (types.Mailbox); the window
    # start is the minimum prev-index over peers that acked an AppendEntries within
    # this many ticks (falling back to all peers when none have). Without the
    # responsiveness filter a permanently dead peer pins the window start forever and
    # live followers can never receive entries past window_start + E -- a liveness
    # loss the reference cannot have (it ships unbounded per-peer suffixes,
    # core.clj:59-67). Must comfortably exceed heartbeat_ticks + the 2-tick RPC round
    # trip so a live peer is never spuriously excluded by ordinary heartbeat cadence.
    ack_timeout_ticks: int = 12

    # Log compaction / snapshotting. The reference's log is an unbounded vector
    # (log.clj:33, append at log.clj:61-67): a reference cluster accepts client
    # writes forever. 0 (default) keeps the fixed-capacity log: once full, commands
    # are rejected permanently. > 0 turns the [N, CAP] arrays into a RING over
    # absolute 1-based indices (entry i at slot (i-1) mod CAP) and each node
    # compacts its committed prefix: whenever the retained window
    # (log_len - log_base) exceeds CAP - compact_margin, log_base advances toward
    # commit_index, freeing slots so appends can wrap -- unbounded-horizon client
    # workloads never exhaust the log. Entries below log_base live on only as
    # (log_base, base_term, base_chk); leaders whose peer's next_index falls below
    # their base send an InstallSnapshot analogue instead of entries
    # (models/raft.py phase 3/8). Compaction configs carry absolute indices, so
    # the capacity-bounded next/match planes and the match/hint wire fields
    # widen to int32 (types.index_dtype).
    compact_margin: int = 0

    # Client command injection (reference: external curl POST /client-set,
    # server.clj:8-12, core.clj:151-160). Every `client_interval` ticks one command is
    # offered to each cluster; 0 disables.
    client_interval: int = 0
    # Client request routing. False: the omniscient client writes straight to the
    # current live leader (the original simulator shortcut). True: the reference's
    # real write path (core.clj:151-160, server.clj:62-63) -- each offer targets a
    # RANDOM node; a non-leader target redirects the client to its known leader
    # (the HTTP 302 analogue, costing one tick per bounce) or to a random peer
    # when leaderless (core.clj:154); the client keeps up to `client_pipeline`
    # commands in flight and drops offers only when every slot is busy.
    # Offer->commit latency is tracked either way
    # (RunMetrics.lat_sum/lat_cnt; the reference's commit watch, log.clj:83-87,
    # never fired -- bug 2.3.9).
    client_redirect: bool = False
    # In-flight client pipeline depth K (redirect mode only): the simulated
    # client holds up to K commands in flight, each independently chasing 302
    # redirects -- the array form of the reference's buffered(5) request channel
    # with one private response channel per pending client-set
    # (server.clj:18-23, 37). A fresh offer takes the first free slot (dropped
    # only when all K are busy); at most one slot is accepted per NODE per tick
    # (the reference's loop dequeues one message per wait iteration), lowest
    # slot first. 1 = the single-command client.
    client_pipeline: int = 1

    # Durable storage plane (raft_sim_tpu/storage; dissertation section 3.8's
    # persistence requirements made falsifiable). The reference persists its
    # log through a file-backed atom (log.clj:16-18) whose restart path
    # forgets term/vote (bug 2.3.12); with this gate OFF the simulator models
    # the opposite extreme -- a PERFECT disk where every write is durable the
    # instant it happens -- so the whole class of durability failures is
    # inexpressible. A nonzero `fsync_interval` turns on the explicit
    # persistence model: each node carries durable watermarks (dur_len +
    # durable term/vote snapshots) advanced only when its fsync completes
    # (cadence `fsync_interval` ticks, each due flush stalled to the next
    # cadence tick with prob `fsync_jitter_prob` -- the latency lattice),
    # AppendEntries acks and vote grants reflect ONLY durable state (the
    # section 3.8 gate: replication stalls behind a slow disk instead of
    # lying), and crash recovery truncates the un-fsynced log suffix and
    # rewinds term/vote to the durable snapshot. A restart's durable tail may
    # additionally be TORN (prob `torn_tail_prob` per restart): the WAL
    # checksum detects the partial record and recovery drops up to
    # `lost_suffix_span` extra entries. Structural-gate contract like
    # client_interval: the nonzero cadence decides which carry legs compile;
    # the cadence/probability VALUES are tunable (the scenario genome retimes
    # them as data -- disk-fault axes, scenario/genome.py). v1 restriction:
    # mutually exclusive with ring-log compaction (compact_margin > 0) -- the
    # durable watermark would need to fold across snapshot installs and
    # compaction rebases; lift when a workload needs both.
    fsync_interval: int = 0
    fsync_jitter_prob: float = 0.0
    torn_tail_prob: float = 0.0
    lost_suffix_span: int = 1

    # Standing-fleet serving (raft_sim_tpu/serve). When True, the simulator
    # expects externally ingested client commands (the CLI's `serve`,
    # Session.offer) even with client_interval == 0, so the offer-tick plane
    # (ClusterState.log_tick) and the commit-latency metric stay live for
    # them. Purely a structural gate: it changes which carry legs the tick
    # maintains (like pre_vote/compaction), never the protocol semantics --
    # a serve config with no offers ticks identically to the plain config.
    serve_ingest: bool = False

    # Protocol trace plane (raft_sim_tpu/trace). When True, telemetry runs may
    # carry the device-side event ring + transition-coverage bitmap
    # (trace/ring.py) beside the window records: role transitions, term bumps,
    # votes, commit advances, and fault-lattice events stream out per window
    # for whole-history checking (trace/checker.py). Purely a structural gate
    # with the same zero-cost-when-off contract as track_offer_ticks: with it
    # False (the default) no trace leg exists in ANY compiled program -- every
    # standing program lowers bit-identically to pre-trace builds -- and a
    # telemetry run that requests tracing under a False gate is an error
    # (sim/telemetry.py). Event EXTRACTION never perturbs the trajectory
    # either way (tests/test_trace.py pins instrumented == plain).
    track_trace: bool = False

    # Reconfiguration plane (raft_sim_tpu/reconfig; thesis chapter 4 /
    # 3.10 / 6.4 -- all three BEYOND the reference). Each extension follows
    # the client_interval pattern: the nonzero cadence is the STRUCTURAL gate
    # (it decides which carry legs the tick maintains and which quorum form
    # compiles), while the cadence VALUE itself is tunable -- the scenario
    # genome can retime commands without forking a compile.
    #
    # Joint-consensus membership change (thesis 4.3): every
    # `reconfig_interval` ticks the admin offers a membership toggle of a
    # rotating node to the leader; the cluster transitions through a joint
    # phase in which every quorum test needs a majority of BOTH the old and
    # new configurations (ClusterState.member_old/member_new docstring).
    reconfig_interval: int = 0
    # TimeoutNow leadership transfer (thesis 3.10): every `transfer_interval`
    # ticks the admin asks the current leader to transfer leadership to a
    # rotating target. The leader stops accepting client commands while the
    # transfer is pending (the lease handoff), waits for the target to match
    # its log, then fires REQ_TIMEOUT_NOW; the target starts a REAL election
    # immediately, bypassing its timer AND pre-vote.
    transfer_interval: int = 0
    # ReadIndex linearizable reads (thesis 6.4): every `read_interval` ticks
    # one read-only request is offered. The leader captures its commit index
    # (only once it has committed a current-term entry), confirms leadership
    # with a round of AppendEntries responses from a quorum, then serves --
    # a read traffic class with its own latency histogram
    # (StepInfo.read_hist) beside the write path's commit latency.
    read_interval: int = 0
    # Lease-based reads (thesis 6.4.1): with a nonzero lease term, a leader
    # holding a fresh quorum of AppendEntries acknowledgments -- every member
    # of a configuration majority acked within the last `read_lease_ticks`
    # GLOBAL ticks (the ack_age plane) -- serves a pending read immediately,
    # with NO confirmation round. Steady-state reads then cost zero quorum
    # rounds. The safety argument (docs/PROTOCOL.md "Lease reads") leans on
    # a clock assumption: voters deny RequestVote while they heard from a
    # leader within the minimum election timeout ON THEIR LOCAL CLOCK
    # (thesis 4.2.3 -- enabled by this gate), and local clocks may run up to
    # 2x global time under clock skew, so the lease term must fit under
    # HALF the minimum election timeout with slack for the election round
    # trip: 2 * read_lease_ticks + 4 <= election_min_ticks (validated
    # below). The TEST-ONLY `lease_skew_safe` mutant hook drops exactly that
    # 2x factor -- the skewed-clock lease violation the scenario hunt must
    # produce and the trace checker's read_linearizability must reject.
    # Requires the ReadIndex plane (read_index) and the offer-tick plane
    # (track_offer_ticks: the staleness invariant reads lat_frontier).
    read_lease_ticks: int = 0
    # Standing-fleet read ingest (raft_sim_tpu/serve): keep the ReadIndex
    # plane compiled for EXTERNALLY offered reads (Session.offer_read, the
    # serve loop's per-tenant read planes) even with read_interval == 0 --
    # the read-side mirror of serve_ingest, and a structural gate like it.
    serve_reads: bool = False

    # Compacted carry layout (ops/tile.py; docs/PERF.md "node-blocked
    # tiling"). When True, the per-edge value planes
    # (next/match/ack_age/req_off/resp_kind) are carried bit-packed to their
    # config-bounded value ranges as flat uint32 word legs, and the narrow
    # word/window planes (votes, the shared entry windows, the delivery
    # mask) are carried flattened so the TPU sublane tile stops padding
    # their minor dim. PHYSICAL layout only: both kernels unpack at tick
    # entry and repack at exit, so trajectories are bit-identical with the
    # dense layout (tests/test_tile.py) -- a structural gate like pre_vote
    # (it changes which programs compile, never the protocol semantics).
    # Under compaction the unbounded int32 index planes stay dense; the
    # other legs still compact.
    compact_planes: bool = False

    # PreVote (Raft thesis 9.6; BEYOND the reference, which has neither
    # pre-vote nor leadership transfer -- SURVEY.md 2.3.12). When True, an
    # expired node becomes a PRECANDIDATE and probes a majority at its
    # prospective next term WITHOUT bumping its real term; only a pre-quorum
    # promotes it to a real candidate. Voters deny the probe while they heard
    # from a leader within the minimum election timeout, so a node partitioned
    # away cannot inflate its term and depose a stable leader when the
    # partition heals.
    pre_vote: bool = False

    # On-device safety checking (north star: invariants checked every tick)
    check_invariants: bool = True
    # Log-matching check is O(N^2 * CAP) per tick -- gate separately.
    check_log_matching: bool = False
    # Run the log-matching check only on ticks where state.now % interval == 0
    # (1 = every tick). With a large N the check dominates the tick; periodic
    # sampling keeps the strongest Raft safety property checked at bounded cost
    # (the wide-cluster preset runs it every 16 ticks). The batch runs in
    # lockstep (every cluster's `now` is equal -- init_batch starts all at 0 and
    # every path ticks them together), so the hot path skips the whole
    # computation via lax.cond on check ticks' complement.
    log_matching_interval: int = 1

    def __post_init__(self):
        # Node ids ride node_dtype wire fields (Mailbox v_to/a_ok_to): int8 up
        # to 126 nodes, int16 above (types.node_dtype). 255 is the validated
        # giant-N ceiling (config7x, the node-sharded tier); past it nothing
        # overflows int16, but no preset or test exercises the territory.
        assert 2 <= self.n_nodes <= 255
        # Narrow-dtype wire/state bounds (types.py): log indices ride int16 planes
        # (next/match and the per-responder match/hint wire fields), the AE window
        # offset rides int8, and ack ages saturate below int16 max.
        assert 1 <= self.log_capacity <= MAX_LOG_CAPACITY
        assert 1 <= self.max_entries_per_rpc <= min(self.log_capacity, 127)
        assert self.ack_timeout_ticks < ACK_AGE_SAT
        assert self.heartbeat_ticks >= 1
        assert self.election_min_ticks > self.heartbeat_ticks
        assert self.election_range_ticks >= 1
        # Needs real slack beyond heartbeat cadence + the 2-tick RPC round trip:
        # at zero slack a single dropped ack transiently excludes every live peer.
        assert self.ack_timeout_ticks >= self.heartbeat_ticks + 4
        if self.crash_prob > 0:
            assert self.crash_period >= 2
            assert 1 <= self.crash_down_ticks <= self.crash_period
        assert self.log_matching_interval >= 1
        # The pipeline is client-side redirect state; the omniscient direct
        # client never queues.
        assert self.client_pipeline == 1 or self.client_redirect
        assert 1 <= self.client_pipeline <= 16
        # Compaction slack: client injections stop max(1, margin // 2) slots short
        # of the ring so election no-ops always find room (models/raft.py phase 6);
        # margin >= 2 keeps that client ceiling above the steady-state retained
        # window (CAP - margin), and the margin must not consume the whole ring.
        assert self.compact_margin == 0 or 2 <= self.compact_margin < self.log_capacity
        # Reconfiguration-plane cadences are non-negative; membership change
        # needs at least 3 nodes so a removal can never strand a 1-voter
        # configuration mid-experiment (the kernel additionally refuses any
        # toggle that would leave < 2 voters).
        assert self.reconfig_interval >= 0
        assert self.transfer_interval >= 0
        assert self.read_interval >= 0
        # Durable storage plane (raft_sim_tpu/storage): the fsync cadence is
        # the structural gate; the disk-fault probabilities only have a
        # reader when it is on.
        assert self.fsync_interval >= 0
        assert 0.0 <= self.fsync_jitter_prob <= 1.0
        assert 0.0 <= self.torn_tail_prob <= 1.0
        if self.fsync_interval > 0:
            # v1 restriction: no ring-log compaction under the durability
            # model. The durable watermark (dur_len) tracks a plain-prefix
            # log; folding it across snapshot installs and compaction
            # rebases (the base/bterm/bchk triple becoming durable state)
            # is a designed follow-up, not a silent interaction.
            assert self.compact_margin == 0, (
                "fsync_interval > 0 is v1-incompatible with compact_margin "
                "> 0: the durable watermark does not fold across snapshot "
                "installs yet (raft_sim_tpu/storage docstring)"
            )
            # The torn-tail draw removes 1..span extra entries at recovery;
            # a span past the log capacity could never matter.
            assert 1 <= self.lost_suffix_span <= self.log_capacity
        else:
            assert self.torn_tail_prob == 0.0, (
                "torn_tail_prob needs the durable storage plane: set a "
                "nonzero fsync_interval as the base cadence it perturbs"
            )
            assert self.fsync_jitter_prob == 0.0, (
                "fsync_jitter_prob needs the durable storage plane: set a "
                "nonzero fsync_interval as the base cadence it perturbs"
            )
        assert self.reconfig_interval == 0 or self.n_nodes >= 3
        assert self.read_lease_ticks >= 0
        if self.read_lease_ticks > 0:
            # Lease reads ride the ReadIndex slot machinery and the staleness
            # invariant reads the lat_frontier leg (track_offer_ticks).
            assert self.read_index, (
                "read_lease_ticks needs the ReadIndex plane: set a nonzero "
                "read_interval or serve_reads"
            )
            assert self.track_offer_ticks, (
                "read_lease_ticks needs the offer-tick plane (client_interval "
                "> 0 or serve_ingest): the lease staleness invariant reads "
                "the committed frontier leg"
            )
            # The skew-safe bound (docs/PROTOCOL.md "Lease reads"): voters
            # deny votes for election_min_ticks of LOCAL clock after leader
            # contact, local clocks advance at most 2 per global tick, and an
            # election needs >= 2 more ticks to commit -- so the lease term
            # must fit under half the denial window with that slack.
            assert 2 * self.read_lease_ticks + 4 <= self.election_min_ticks, (
                f"read_lease_ticks {self.read_lease_ticks} breaks the "
                f"skew-safe bound 2*L+4 <= election_min_ticks "
                f"({self.election_min_ticks})"
            )
            # The lease predicate compares against the SATURATING ack_age
            # plane: any window at or past the ceiling would treat
            # arbitrarily stale (saturated) acks as fresh and hold the lease
            # forever. Bounded for the mutant's widened no-skew window
            # (election_min + 2) too, so even the TEST-ONLY weakening can
            # never alias into saturation.
            assert self.election_min_ticks + 2 < self.ack_age_sat, (
                f"lease windows (up to election_min_ticks + 2 = "
                f"{self.election_min_ticks + 2}) must stay below the ack_age "
                f"saturation ceiling ({self.ack_age_sat})"
            )
            # Lease reads and TimeoutNow transfers COEXIST since the
            # disruptive-RequestVote override (thesis 3.10 pairs TimeoutNow
            # with a flag that bypasses the 4.2.3 denial): a transfer
            # target's election carries Mailbox.req_disrupt, voters process
            # it despite their lease obligation, and the transferring leader
            # stops serving lease reads while the transfer pends (the
            # handoff covers the read path too -- docs/PROTOCOL.md "Lease
            # reads" staleness argument). The PR-11 mutual-exclusion
            # validator is gone.

    @property
    def track_offer_ticks(self) -> bool:
        """True when the offer-tick plane (ClusterState.log_tick, the
        Mailbox.ent_tick wire window, and the commit-latency metric) is
        maintained: any config that can see client commands whose latency
        should be measured -- a scheduled cadence (client_interval > 0) or a
        standing serve ingest (serve_ingest). Payload values are arbitrary
        int32 either way; latency reads ONLY this plane (never values)."""
        return self.client_interval > 0 or self.serve_ingest

    @property
    def compaction(self) -> bool:
        """True when the ring-log compaction path is active (compact_margin > 0)."""
        return self.compact_margin > 0

    @property
    def reconfig(self) -> bool:
        """True when the joint-consensus membership plane is active: the
        member bitplanes are maintained and every quorum test is
        configuration-masked (dual popcount during joint phases)."""
        return self.reconfig_interval > 0

    @property
    def leader_transfer(self) -> bool:
        """True when the TimeoutNow transfer plane is active (xfer_to state,
        the xfer_tgt wire header, and the REQ_TIMEOUT_NOW handler compile)."""
        return self.transfer_interval > 0

    @property
    def read_index(self) -> bool:
        """True when the ReadIndex read traffic class is active (read slot
        state, ack banking, and the read latency histogram compile): a
        scheduled read cadence, or standing-fleet read ingest (serve_reads --
        externally offered reads, the read-side serve_ingest)."""
        return self.read_interval > 0 or self.serve_reads

    @property
    def read_lease(self) -> bool:
        """True when lease-based reads are active (read_lease_ticks > 0):
        the vote-denial rule compiles into RequestVote handling, the lease
        predicate into read serving, and the read_fr frontier leg + the
        viol_read_stale device invariant go live."""
        return self.read_lease_ticks > 0

    @property
    def durable_storage(self) -> bool:
        """True when the durable storage plane is active (fsync_interval >
        0): the per-node durable watermarks (dur_len/dur_term/dur_vote)
        compile into the carry, the section-3.8 gates into ack/grant
        handling, and crash recovery truncates to the durable snapshot
        (raft_sim_tpu/storage)."""
        return self.fsync_interval > 0

    # -- TEST-ONLY mutation hooks (scenario/mutation.py). Each extension's
    # correctness hinges on one rule; these properties are that rule as data,
    # so a mutant config subclass can weaken exactly it and the CE hunt must
    # re-find the injected bug. Production configs always return True.
    @property
    def joint_consensus(self) -> bool:
        """False (mutants only): a membership change is ONE log entry that
        switches the configuration wholly at append -- the single-server
        change (thesis 4.1) with its known-unsafe interleaving: two leaders'
        uncommitted single-entry changes can yield majorities that do not
        intersect (the bug the joint phase exists to rule out)."""
        return True

    @property
    def act_on_append(self) -> bool:
        """False (mutants only): each node derives its configuration from
        the COMMITTED prefix of its log instead of the whole appended prefix
        -- "act on commit", the dissertation-ch.-4 anti-rule. Nodes then
        disagree about when a change takes effect (a config entry's commit
        is itself judged under some config), and the old configuration keeps
        electing leaders the new one cannot see: disjoint quorums."""
        return True

    @property
    def truncation_rollback(self) -> bool:
        """False (mutants only): a node whose truncated log LOST config
        entries keeps acting on the stale derived configuration (the
        rollback the dissertation requires is skipped). A follower that
        briefly held an uncommitted change then truncated it keeps voting
        under the phantom configuration -- quorums drawn from member sets no
        log chain ever contained."""
        return True

    @property
    def read_confirm(self) -> bool:
        """False (mutants only): ReadIndex serves at capture time with no
        leadership confirmation round and no current-term-commit capture
        gate -- the stale-read-below-the-committed-frontier bug."""
        return True

    @property
    def xfer_election(self) -> bool:
        """False (mutants only): a TimeoutNow target assumes leadership
        DIRECTLY (no vote round, no up-to-date check) and the leader fires
        without waiting for the target to catch up -- transfer as a coup."""
        return True

    @property
    def lease_skew_safe(self) -> bool:
        """False (mutants only): the lease window is judged as if local
        clocks advanced exactly one unit per global tick -- the kernel
        serves lease reads for election_min_ticks + 2 instead of the
        configured skew-safe read_lease_ticks. Correct on unskewed clocks
        (a deposing election needs a full election_min of vote-denial
        expiry plus the vote and commit round trips, one tick more than
        the widened lease);
        under clock skew a fast follower's vote-denial window halves in
        global time, a new leader commits inside the optimistic lease, and
        the deposed leader serves a stale read -- the thesis-6.4.1 clock
        assumption made falsifiable (the hunt drives the skew genome axis)."""
        return True

    @property
    def durable_acks(self) -> bool:
        """False (mutants only): AppendEntries acks and vote grants reflect
        the node's VOLATILE state -- an ack can name entries whose fsync has
        not completed, and a grant can precede the vote's persistence. The
        canonical ack-before-fsync storage bug: a leader counts a follower's
        acked-but-unfsynced entries toward commit, the follower crashes, and
        recovery truncates entries the cluster already reported committed --
        committed-entry loss (leader_completeness). Recovery still truncates
        honestly; only the acknowledgment lies."""
        return True

    @property
    def persist_vote(self) -> bool:
        """False (mutants only): crash recovery restores term/log from the
        durable snapshot but forgets votedFor -- the reference's own restart
        bug (log.clj:16-18, SURVEY.md 2.3.12) expressed inside the storage
        plane. A restarted voter re-grants in a term it already voted in, two
        candidates each reach "quorum", and two leaders share the term
        (election_safety)."""
        return True

    @property
    def ack_age_sat(self) -> int:
        """Saturation ceiling for the ack-age plane: the int8 ceiling whenever
        the responsiveness horizon fits under it (see ACK_AGE_SAT_NARROW)."""
        return (
            ACK_AGE_SAT_NARROW
            if self.ack_timeout_ticks < ACK_AGE_SAT_NARROW
            else ACK_AGE_SAT
        )

    @property
    def quorum(self) -> int:
        """Votes needed for leadership: floor(N/2)+1.

        The reference computes ceil(N/2) over peers+self (majority? core.clj:19-21),
        which equals floor(N/2)+1 for odd N but is NOT a majority for even N
        (ceil(4/2)=2 of 4). We use the spec-correct strict majority.
        """
        return self.n_nodes // 2 + 1


def nondefault_fields(cfg: RaftConfig) -> dict:
    """cfg's fields that differ from their defaults: the portable config
    encoding of hit files, repro artifacts and the farm's identity
    (RaftConfig(**this) rebuilds cfg)."""
    return {f.name: getattr(cfg, f.name) for f in dataclasses.fields(RaftConfig)
            if getattr(cfg, f.name) != f.default}


# The five BASELINE.json configs as named presets (see BASELINE.md). config1 is the
# 10k-tick correctness reference: its log capacity must hold every command injected
# over the run (10k ticks / interval 8 = 1250 commands).
PRESETS: dict[str, tuple[RaftConfig, int]] = {
    # name -> (config, batch size)
    "config1": (
        RaftConfig(
            n_nodes=5,
            log_capacity=2048,
            max_entries_per_rpc=8,
            client_interval=8,
            check_log_matching=True,
        ),
        1,
    ),
    "config2": (RaftConfig(n_nodes=5, client_interval=8), 1_000),
    "config3": (RaftConfig(n_nodes=5), 100_000),
    "config4": (
        RaftConfig(
            n_nodes=7,
            drop_prob=0.3,
            drop_prob_uniform=True,
            clock_skew_prob=0.1,
        ),
        100_000,
    ),
    "config5": (
        RaftConfig(
            n_nodes=51,
            log_capacity=16,
            partition_period=32,
            partition_prob=0.5,
            check_invariants=True,
            # BASELINE row 5 promises on-device safety asserts; log matching is
            # the strongest of them and O(N^2 * CAP) at N=51, so it runs on a
            # 16-tick sampling cadence (measured <= ~10% throughput cost).
            check_log_matching=True,
            log_matching_interval=16,
        ),
        10_000,
    ),
    # config5 under the compacted carry layout (ops/tile.py): the
    # SAME workload, trajectories bit-identical (tests/test_tile.py), only
    # the physical carry form moves -- the standing layout-A/B row that
    # prices the node-blocked tiling against config5's dense wall
    # (docs/PERF.md "the config5 roofline"). Priced by Pass C under its own
    # tier; bench runs it beside config5 so the first chip session measures
    # the layout delta with no extra flags.
    "config5c": (
        RaftConfig(
            n_nodes=51,
            log_capacity=16,
            partition_period=32,
            partition_prob=0.5,
            check_invariants=True,
            check_log_matching=True,
            log_matching_interval=16,
            compact_planes=True,
        ),
        10_000,
    ),
    # Not a BASELINE row: the ring-compaction acceptance preset. A deliberately
    # small ring under an unbounded client workload (one command per 4 ticks
    # forever) plus crash + drop faults: run >= 100k ticks, commands must keep
    # being accepted (commit passes many multiples of CAP) with zero violations.
    # The reference passes this trivially (unbounded log vector, log.clj:33); the
    # fixed-CAP log without compaction fails it by construction.
    "config6": (
        RaftConfig(
            n_nodes=5,
            log_capacity=32,
            compact_margin=8,
            max_entries_per_rpc=4,
            client_interval=4,
            drop_prob=0.1,
            crash_prob=0.3,
            crash_period=64,
            crash_down_ticks=12,
        ),
        1_000,
    ),
    # config6 through the reference's real write path (curl -> 302 redirect
    # chase, core.clj:151-160, server.clj:62-63): every offer targets a random
    # node, bounces cost one tick each, and the client holds up to 5 commands
    # in flight -- the reference's buffered(5) request channel (server.clj:37).
    "config6r": (
        RaftConfig(
            n_nodes=5,
            log_capacity=32,
            compact_margin=8,
            max_entries_per_rpc=4,
            client_interval=4,
            drop_prob=0.1,
            crash_prob=0.3,
            crash_period=64,
            crash_down_ticks=12,
            client_redirect=True,
            client_pipeline=5,
        ),
        1_000,
    ),
    # config3 with PreVote (thesis 9.6): the standing bench row that prices
    # pre_vote's cost against the config3 baseline -- the number used to live
    # in docs/PERF.md prose, now measured every bench run (ROADMAP item 5).
    "config3p": (RaftConfig(n_nodes=5, pre_vote=True), 100_000),
    # Reconfiguration-plane acceptance preset (raft_sim_tpu/reconfig): the
    # three thesis extensions -- joint-consensus membership change,
    # TimeoutNow leadership transfer, ReadIndex reads -- all live at once,
    # under client traffic + drop + crash churn. The add/remove-under-fire
    # tier: membership toggles land every ~97 ticks while elections, crashes,
    # and transfers are in flight; the trace checker must pass all properties
    # over its histories (tests/test_reconfig.py, CI reconfig smoke).
    "config8": (
        RaftConfig(
            n_nodes=5,
            log_capacity=64,
            max_entries_per_rpc=4,
            client_interval=4,
            drop_prob=0.1,
            crash_prob=0.25,
            crash_period=64,
            crash_down_ticks=12,
            reconfig_interval=97,
            transfer_interval=61,
            read_interval=7,
        ),
        1_000,
    ),
    # Lease-read acceptance preset (the tenancy plane's read tier): client
    # writes + a dense scheduled read stream served through leases
    # (read_lease_ticks = 4 against the widened election_min_ticks = 12 --
    # the skew-safe bound 2*4+4 <= 12 exactly), under drop + clock skew so
    # the lease's clock assumption is exercised, not idle. The trace checker
    # must pass all six properties over its histories while the lease-skew
    # mutant of the same preset is rejected naming read_linearizability
    # (tests/test_lease.py, CI serve smoke).
    "config9": (
        RaftConfig(
            n_nodes=5,
            log_capacity=64,
            compact_margin=8,
            max_entries_per_rpc=4,
            election_min_ticks=12,
            election_range_ticks=8,
            client_interval=4,
            read_interval=3,
            read_lease_ticks=4,
            drop_prob=0.05,
            clock_skew_prob=0.1,
        ),
        1_000,
    ),
    # Giant-N tier (node-axis sharding, raft_sim_tpu_torch/parallel/
    # nodeshard.py): one cluster too large for comfortable single-device
    # batches, partitioned row-wise across the mesh's "nodes" axis. N=101
    # keeps W=4 packed words and the threshold-quorum form (log_capacity <
    # N), with client traffic + drops so replication is exercised at scale,
    # not just elections. The feature set deliberately stays inside the
    # sharded surface (no reconfig/transfer/reads/redirect/log-matching);
    # the same preset runs unsharded for the bit-exactness acceptance
    # (tests/test_torch_nodeshard.py).
    "config7": (
        RaftConfig(
            n_nodes=101,
            log_capacity=16,
            max_entries_per_rpc=4,
            client_interval=4,
            drop_prob=0.05,
        ),
        1_000,
    ),
    # The N=255 ceiling tier (W=8 words, node ids at the int16 dtype tier):
    # config7's workload at the largest supported cluster, under rolling
    # partitions, carried in the COMPACTED layout on the single-device
    # path -- the node-sharded run takes the same preset dense
    # (types.compact_twin; raft_sim_tpu_torch/parallel/nodeshard.py), so one
    # preset prices both the packed carry and the per-shard bytes.
    "config7x": (
        RaftConfig(
            n_nodes=255,
            log_capacity=16,
            max_entries_per_rpc=4,
            client_interval=4,
            drop_prob=0.05,
            partition_period=32,
            partition_prob=0.25,
            compact_planes=True,
        ),
        250,
    ),
    # Durable-storage acceptance preset (raft_sim_tpu/storage): the
    # fsync/WAL model live under the full disk-fault lattice -- a 3-tick
    # fsync cadence with 20% latency jitter, torn durable tails on 30% of
    # restarts (up to 3 extra entries dropped at recovery), crash churn so
    # recovery actually runs, and client traffic + drops so the section-3.8
    # ack gate is exercised under replication pressure, not just elections.
    # Compaction stays off (the v1 restriction above). The trace checker must
    # pass all six properties over its histories while the ack-before-fsync /
    # volatile-vote mutants of the same preset are rejected naming
    # leader_completeness / election_safety (tests/test_storage.py, CI
    # durability smoke).
    "config10": (
        RaftConfig(
            n_nodes=5,
            log_capacity=64,
            max_entries_per_rpc=4,
            client_interval=4,
            drop_prob=0.1,
            crash_prob=0.3,
            crash_period=64,
            crash_down_ticks=12,
            fsync_interval=3,
            fsync_jitter_prob=0.2,
            torn_tail_prob=0.3,
            lost_suffix_span=3,
        ),
        1_000,
    ),
    # config4's fault mix carrying client traffic, so offer->commit latency is
    # measured UNDER faults in the standing bench (not only on reliable nets).
    "config4c": (
        RaftConfig(
            n_nodes=7,
            log_capacity=64,
            max_entries_per_rpc=8,
            drop_prob=0.3,
            drop_prob_uniform=True,
            clock_skew_prob=0.1,
            client_interval=8,
        ),
        100_000,
    ),
}

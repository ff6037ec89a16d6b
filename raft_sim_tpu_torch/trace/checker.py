"""Whole-history checker: the Raft safety properties over a complete run (the
port of raft_sim_tpu/trace/checker.py; pure Python over a History).

The per-tick `viol_*` flags (the tick's invariant phase) check each property's
INSTANTANEOUS form -- two leaders this tick, a mutated prefix this tick. The
Raft paper states them as HISTORY claims (fig. 3), and some violations only
exist as history: two leaders elected for one term three windows apart never
coexist on any tick. This module replays a reconstructed History
(trace/history.py) through a per-cluster state machine and verifies:

  election_safety        at most one leader ELECTED per term across the whole
                         run (pure history: the EV_LEADER events; witness =
                         the two conflicting leader events).
  leader_append_only     a node never truncates its log while it holds
                         leadership (pure history: EV_TRUNCATE between a
                         node's EV_LEADER and its role loss).
  leader_completeness    the cluster's committed frontier (max commit index
                         ever witnessed) is never re-committed-below by a
                         LEADER: a correct leader's commit advance only lands
                         on current-term entries, which sit strictly above
                         everything committed before its election -- a
                         leader commit below the frontier means its log was
                         missing committed entries. Followers legally trail
                         the frontier; only leader-attributed commits count.
  state_machine_safety   per-node commit indices are monotone except across a
                         restart (commit legally resumes from the durable
                         snapshot base), plus the device-side committed-
                         prefix-immutability flag (EV_VIOLATION commit bit --
                         index monotonicity alone cannot see a same-index
                         CONTENT change; the kernel's carried checksum can).
  log_matching           device-backed: the kernel's O(N^2 CAP) cross-node
                         prefix comparison runs on device (EV_VIOLATION
                         log-matching bit); the history carries its verdicts.
                         Content never leaves the device, so this property is
                         honest about being flag-backed, not re-derived.
  read_linearizability   a served ReadIndex read's index covers the committed
                         frontier as of the read's issue (checked at serve:
                         a stale leader may capture a stale index, but must
                         never serve it).

  The within-tick event order events.py defines is load-bearing here: role
  transitions precede commit/append/truncate kinds, so "stepped down then
  truncated in one tick" replays in kernel phase order.

A history with holes (ring overflow, truncated or reordered trace.jsonl)
can still FAIL -- a witnessed violation is a violation -- but can never PASS:
undecided properties report ok=None with an incomplete-history note.

CLI: `python -m raft_sim_tpu_torch.trace.checker <telemetry dir> [--json]`
exit 0 = all six hold, 1 = a named property is violated (witness printed),
2 = incomplete history and no violation found.
"""

from __future__ import annotations

import dataclasses
import json

from raft_sim_tpu_torch.trace import events as tev
from raft_sim_tpu_torch.trace.history import Event, History

PROPERTIES = (
    "election_safety",
    "leader_append_only",
    "log_matching",
    "leader_completeness",
    "state_machine_safety",
    "read_linearizability",
)


@dataclasses.dataclass
class PropertyResult:
    name: str
    ok: bool | None  # None = undecidable (incomplete history, no witness)
    witness: list[dict]  # minimal witnessing events (empty when ok)
    note: str = ""

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


@dataclasses.dataclass
class CheckReport:
    results: dict[str, PropertyResult]
    complete: bool
    problems: list[str]
    clusters: int

    @property
    def ok(self) -> bool:
        return all(r.ok for r in self.results.values())

    @property
    def violated(self) -> list[str]:
        return [n for n, r in self.results.items() if r.ok is False]

    def to_dict(self) -> dict:
        return {
            "ok": self.ok,
            "complete": self.complete,
            "violated": self.violated,
            "problems": self.problems,
            "clusters": self.clusters,
            "properties": {n: r.to_dict() for n, r in self.results.items()},
        }


def _check_cluster(c: int, evs: list[Event], fail) -> None:
    """Replay one cluster's timeline; report violations via fail(prop,
    witness_events, note)."""
    # Election safety is UNCONDITIONAL per term under log-carried
    # configuration (models/cfglog.py; thesis 4.3): every vote is cast under
    # the voter's own log-derived configuration, every configuration is a
    # chain of log entries from the boot config, and joint consensus makes
    # adjacent configurations' majorities intersect -- so two same-term
    # leaders ALWAYS imply a double-voted node or a broken config chain
    # (exactly what the act-on-commit / single-server-change mutants break).
    # The admin-era EPOCH_EXEMPT_DISTANCE carve-out is GONE: it existed
    # because lockstep admin switches were not log entries, so distant
    # electorates could legally be disjoint; per-node log-carried configs
    # cannot. A second, per-voter check keys on (voter, term): granting two
    # DIFFERENT candidates in one term is named directly -- under log-carried
    # configs no config state can excuse it, so the config is deliberately
    # NOT part of the key -- while an idempotent re-grant (same candidate,
    # e.g. after a restart) stays legal. Each node's cfg_epoch is replayed
    # from the EV_CFG_APPLY/EV_CFG_ROLLBACK stream and recorded with every
    # vote for ATTRIBUTION only: the failure note names the config era each
    # grant was cast under (what makes act-on-commit witnesses readable).
    leaders_by_term: dict[int, list[Event]] = {}  # term -> [ev]
    leader_set: dict[int, Event] = {}  # node -> its EV_LEADER event
    node_term: dict[int, int] = {}  # node -> current term (role/term events)
    node_cfg_epoch: dict[int, int] = {}  # node -> derived config epoch
    votes_cast: dict[tuple[int, int], tuple[int, int, Event]] = {}
    # (voter, term) -> (candidate, cfg_epoch at vote time, ev)
    frontier = 0
    frontier_ev: Event | None = None
    last_commit: dict[int, tuple[int, Event]] = {}
    restarted_since: dict[int, bool] = {}
    # ReadIndex linearizability: a read captured at issue time must cover the
    # committed frontier AS OF ISSUE (every write committed anywhere before
    # the read began) -- checked when the read is SERVED, because a stale
    # leader legally captures a stale index it can never confirm (the real
    # kernel's quorum round kills it; only a served stale read violates).
    pending_reads: dict[int, tuple[int, int, Event]] = {}  # node -> (idx, frontier, ev)
    # Vote-durability model (raft_sim_tpu/storage). Under the durable
    # storage plane a cast vote is EXPOSED only once a flush covers it
    # (section-3.8 gate 2), and crash recovery rewinds votedFor to the
    # durable snapshot -- so a vote cast after the node's last flush is
    # legally un-promised by a restart, and counting it against a
    # post-recovery re-vote would fail the REAL kernel. Votes therefore sit
    # in `pending_votes` until the node's next EV_FSYNC makes them durable
    # (clears the pending set; the votes stay cast), and an EV_RESTART
    # un-casts whatever is still pending. The model activates only when the
    # history shows the plane (any storage event): perfect-disk histories
    # keep the strict rule. Known limit: a durability history whose every
    # flush stalled shows no storage event, so a never-flushed vote stays
    # cast -- but such a run exposes no votes and elects no leaders either.
    durable = any(e.kind in (tev.EV_FSYNC, tev.EV_RECOVER_TRUNC) for e in evs)
    pending_votes: dict[int, list[tuple[int, int]]] = {}  # node -> [(term, cand)]
    for e in evs:
        k = e.kind
        if k in (tev.EV_FOLLOWER, tev.EV_PRECANDIDATE, tev.EV_CANDIDATE):
            leader_set.pop(e.node, None)
            node_term[e.node] = e.detail  # role kinds carry the new term
        elif k == tev.EV_TERM:
            node_term[e.node] = e.detail
        elif k in (tev.EV_CFG_APPLY, tev.EV_CFG_ROLLBACK):
            node_cfg_epoch[e.node] = e.detail  # detail = the new cfg_epoch
        elif k == tev.EV_VOTE:
            # Double-vote detection, keyed on the voter's (term, config) at
            # vote time: granting two DIFFERENT candidates in one term is a
            # genuine election-safety break no configuration can excuse;
            # re-granting the SAME candidate (restart re-grant) is legal.
            t = node_term.get(e.node, 0)
            ce = node_cfg_epoch.get(e.node, 0)
            prev_v = votes_cast.get((e.node, t))
            if prev_v is not None and prev_v[0] != e.detail:
                fail(
                    "election_safety", [prev_v[2], e],
                    f"cluster {c}: node {e.node} voted for both node "
                    f"{prev_v[0]} (config epoch {prev_v[1]}) and node "
                    f"{e.detail} (config epoch {ce}) in term {t}",
                )
            votes_cast[(e.node, t)] = (e.detail, ce, e)
            if durable:
                pending_votes.setdefault(e.node, []).append((t, e.detail))
        elif k == tev.EV_FSYNC:
            # The flush covers the node's live (term, votedFor): every
            # pending vote is durable now -- it survives restarts and stays
            # in votes_cast permanently.
            pending_votes.pop(e.node, None)
        elif k == tev.EV_READ_ISSUE:
            pending_reads[e.node] = (e.detail, frontier, e)
        elif k == tev.EV_READ_SERVE:
            pend = pending_reads.pop(e.node, None)
            if pend is not None and e.detail < pend[1]:
                fail(
                    "read_linearizability", [pend[2], e],
                    f"cluster {c}: node {e.node} served a ReadIndex read at "
                    f"index {e.detail} (issued tick {pend[2].tick}) below the "
                    f"committed frontier {pend[1]} at issue time: the read "
                    "misses committed writes",
                )
        elif k == tev.EV_LEADER:
            term = e.detail
            node_term[e.node] = term
            prior = next(iter(leaders_by_term.get(term, [])), None)
            if prior is not None:
                fail(
                    "election_safety", [prior, e],
                    f"cluster {c}: two leaders elected for term {term} "
                    f"(node {prior.node} at tick {prior.tick}, node "
                    f"{e.node} at tick {e.tick}) -- under log-carried "
                    "configuration every electorate chains from the boot "
                    "config through joint phases, so same-term majorities "
                    "always intersect: a double-voted node or a broken "
                    "config chain (act-on-commit / single-server-change)",
                )
            leaders_by_term.setdefault(term, []).append(e)
            leader_set[e.node] = e
        elif k == tev.EV_TRUNCATE:
            led = leader_set.get(e.node)
            if led is not None:
                fail(
                    "leader_append_only", [led, e],
                    f"cluster {c}: node {e.node} truncated its log to "
                    f"{e.detail} at tick {e.tick} while leader (elected tick "
                    f"{led.tick}, term {led.detail})",
                )
        elif k == tev.EV_COMMIT:
            if e.node in leader_set and e.detail < frontier:
                fw = [frontier_ev, e] if frontier_ev else [e]
                fail(
                    "leader_completeness", fw,
                    f"cluster {c}: leader node {e.node} committed index "
                    f"{e.detail} at tick {e.tick} below the committed "
                    f"frontier {frontier}: its log was missing committed "
                    "entries at election",
                )
            prev = last_commit.get(e.node)
            if (
                prev is not None
                and e.detail < prev[0]
                and not restarted_since.get(e.node, False)
            ):
                fail(
                    "state_machine_safety", [prev[1], e],
                    f"cluster {c}: node {e.node} commit index regressed "
                    f"{prev[0]} -> {e.detail} without an intervening restart",
                )
            last_commit[e.node] = (e.detail, e)
            restarted_since[e.node] = False
            if e.detail > frontier:
                frontier, frontier_ev = e.detail, e
        elif k == tev.EV_RESTART:
            restarted_since[e.node] = True
            leader_set.pop(e.node, None)  # restart wipes role (defensive:
            # the same-tick EV_FOLLOWER, ordered first, already removed it)
            if e.detail > 0:
                # detail = the post-tick term: recovery can REWIND the term
                # (a decrease the EV_TERM increase-delta never reports), so
                # re-anchor the model here. Pre-storage-plane histories
                # carry detail 0 -- skip, the old model had no rewinds.
                node_term[e.node] = e.detail
            for t, cand in pending_votes.pop(e.node, []):
                # Un-cast never-flushed votes: recovery rewound votedFor to
                # the durable snapshot, and gate 2 means the grant was never
                # exposed -- the protocol never saw it, so a post-recovery
                # re-vote in the same term is NOT a double vote.
                cur = votes_cast.get((e.node, t))
                if cur is not None and cur[0] == cand:
                    votes_cast.pop((e.node, t))
        elif k == tev.EV_VIOLATION:
            if e.detail & tev.VIOL_LOG_MATCHING:
                fail(
                    "log_matching", [e],
                    f"cluster {c}: device log-matching check failed at tick "
                    f"{e.tick} (cross-node committed prefixes disagree)",
                )
            if e.detail & tev.VIOL_COMMIT:
                fail(
                    "state_machine_safety", [e],
                    f"cluster {c}: device commit invariant failed at tick "
                    f"{e.tick} (committed prefix mutated or commit left "
                    "bounds -- the carried checksum check)",
                )
            if e.detail & tev.VIOL_ELECTION:
                # Per-tick concurrent same-term leaders: normally the two
                # EV_LEADER events already witnessed this; keep the flag as
                # the fallback witness (e.g. when one election predates a
                # partial history's first window).
                fail(
                    "election_safety", [e],
                    f"cluster {c}: device election-safety flag at tick "
                    f"{e.tick} (two same-term leaders coexist)",
                )


def check_history(hist: History) -> CheckReport:
    """Run the six property checks over every cluster's timeline."""
    results = {p: PropertyResult(p, True, []) for p in PROPERTIES}

    def fail(prop: str, witness: list[Event], note: str, cluster: int = -1):
        r = results[prop]
        if r.ok is False:
            return  # first witness per property is the minimal report
        r.ok = False
        r.witness = [w.to_dict(cluster if cluster >= 0 else None) for w in witness]
        r.note = note

    for c in sorted(hist.events):
        _check_cluster(
            c, hist.events[c],
            lambda prop, w, note, _c=c: fail(prop, w, note, _c),
        )
    if not hist.complete:
        gaps = hist.incomplete_clusters()
        parts = []
        if gaps:
            parts.append(f"events dropped in clusters {gaps[:8]}")
        if hist.freeze_armed:
            parts.append(
                "recording freeze-truncated by design (freeze_kind armed: "
                "a capture-economy prefix, not a whole-run history)"
            )
        parts.extend(hist.problems[:4])
        note = "incomplete history: " + "; ".join(parts)
        for r in results.values():
            if r.ok is True:  # a found violation stands; a pass demotes
                r.ok = None
                r.note = note
    return CheckReport(
        results=results,
        complete=hist.complete,
        problems=list(hist.problems),
        clusters=len(hist.events),
    )


def check_directory(directory: str) -> CheckReport:
    from raft_sim_tpu_torch.trace import history as hmod

    return check_history(hmod.load(directory))


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(
        prog="raft_sim_tpu_torch.trace.checker", description=__doc__.splitlines()[0]
    )
    ap.add_argument("directory", help="telemetry sink dir with trace.jsonl")
    ap.add_argument("--json", action="store_true", help="machine-readable report")
    args = ap.parse_args(argv)
    rep = check_directory(args.directory)
    if args.json:
        print(json.dumps(rep.to_dict(), indent=1))
    else:
        for name in PROPERTIES:
            r = rep.results[name]
            verdict = {True: "ok", False: "VIOLATED", None: "undecided"}[r.ok]
            line = f"{name:<22} {verdict}"
            if r.note:
                line += f"  ({r.note})"
            print(line)
            for w in r.witness:
                print(f"    witness: {w}")
        if not rep.complete:
            print(f"history INCOMPLETE: {'; '.join(rep.problems[:6]) or 'events dropped'}")
    if rep.violated:
        return 1
    if not rep.complete or not rep.ok:
        return 2
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(main())

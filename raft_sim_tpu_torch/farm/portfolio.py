"""Portfolio members: the farm's parallel fitness functions (the port of
raft_sim_tpu/farm/portfolio.py).

One CE hunt optimizes ONE notion of "closer to breaking", and the scalar
weights encode one hypothesis about where bugs live. The farm hedges: it
partitions the fleet's batch axis among MEMBERS -- each a named fitness
function with its own CE distribution -- exactly the way serve/tenancy.py
partitions tenants, so a 5-member portfolio still evaluates in ONE
`simulate_windowed` call per generation (the genome rows differ per cluster;
the tick never sees the partition).

Each fitness is a host-side function over the member's slice of the fetched
telemetry windows, as numpy (the farm copies a generation's records to the
host once): `f(records, metrics, novelty) -> [b] float64`, where
`novelty` is the per-cluster count of coverage bits unseen farm-wide before
this generation (`search.coverage_novelty`; None when the farm runs
untraced). Violations dominate
lexicographically in EVERY member -- the portfolio diversifies the gradient
toward trouble, never the definition of trouble itself.
"""

from __future__ import annotations

import numpy as np

from raft_sim_tpu_torch.scenario import search as search_mod


# The counter interpretations (leaderless windows, term churn, commit
# stalls) are search.py's shared extractors -- one reading of the telemetry
# plane for the scalar blend and every member here.
def _viol(metrics) -> np.ndarray:
    return search_mod.W_VIOLATION * np.asarray(metrics.violations, np.float64)


def fit_scalar(records, metrics, novelty) -> np.ndarray:
    """The hand-tuned distress blend `scenario search` default mode uses."""
    return search_mod.fitness_from_records(records, metrics)


def fit_coverage(records, metrics, novelty) -> np.ndarray:
    """Transition-coverage novelty against the FARM-WIDE seen set: new
    protocol behavior scores, repeats do not (violations still dominate --
    an all-bits-seen generation must not zero the violation term)."""
    if novelty is None:
        raise ValueError("coverage member needs a traced farm (novelty=None)")
    return _viol(metrics) + novelty


def fit_multi_leader(records, metrics, novelty) -> np.ndarray:
    """Hunt split-brain exposure directly: concurrent LEADER ticks are the
    election-safety precursor, here promoted from one
    term of the scalar blend to the member's whole objective."""
    multi = np.asarray(metrics.multi_leader, np.float64)
    return _viol(metrics) + 50.0 * multi + search_mod.term_churn(metrics)


def fit_commit_stall(records, metrics, novelty) -> np.ndarray:
    """Hunt liveness collapse: windows whose commit frontier froze under a
    live client workload -- the precondition for commit/completeness breaks
    (a leader that cannot advance is a leader about to be replaced by one
    missing entries)."""
    return (
        _viol(metrics)
        + 20.0 * search_mod.commit_stalls(records, metrics)
        + 5.0 * search_mod.leaderless_windows(records)
    )


def fit_read_staleness(records, metrics, novelty) -> np.ndarray:
    """Hunt stale-read preconditions: a deposed-but-unaware leader serving
    reads needs concurrent leadership AND read traffic actually flowing, so
    weight split-brain exposure with a small served-read term (no reads, no
    stale serves) -- viol_read_stale itself rides the dominant violation
    term (scan.step_bad folds it)."""
    multi = np.asarray(metrics.multi_leader, np.float64)
    reads = np.asarray(metrics.reads_served, np.float64)
    return (
        _viol(metrics)
        + 30.0 * multi
        + 5.0 * search_mod.leaderless_windows(records)
        + search_mod.term_churn(metrics)
        + 0.01 * reads
    )


def fit_durability(records, metrics, novelty) -> np.ndarray:
    """Hunt committed-while-volatile exposure (the durable storage plane): the
    ack-before-fsync loss needs the commit frontier to ADVANCE while the
    durable watermark lags (entries counted off volatile acks), then crash
    churn to truncate and re-elect -- so weight each window's commit advance
    by its fsync lag and add the churn that converts exposure into loss.
    The pure-distress members anti-select this (a stalled cluster commits
    nothing, so nothing it commits can be lost); zero exposure term when
    the storage plane is off (the lag counters are gated device zeros)."""
    mc = np.asarray(records.metrics.max_commit, np.float64)  # [B, W]
    lag = np.asarray(records.metrics.fsync_lag_max, np.float64)  # [B, W]
    if mc.shape[1] > 1:
        adv = np.clip(np.diff(mc, axis=1), 0.0, None)
        exposure = (adv * np.minimum(lag[:, 1:], 8.0)).sum(axis=1)
    else:
        exposure = np.zeros(mc.shape[0])
    # Exposure DOMINANT, churn a tiebreak only: the distress terms the other
    # members lean on anti-correlate with the traffic this exposure needs,
    # and letting them lead walks the CE distribution into partition-dead
    # clusters (churn without commits can never lose a committed entry).
    return (
        _viol(metrics)
        + 5.0 * exposure
        + search_mod.term_churn(metrics)
    )


# name -> (fitness fn, needs the trace-variant program for its signal).
FITNESS = {
    "scalar": (fit_scalar, False),
    "coverage": (fit_coverage, True),
    "multi_leader": (fit_multi_leader, False),
    "commit_stall": (fit_commit_stall, False),
    "read_staleness": (fit_read_staleness, False),
    "durability": (fit_durability, False),
}


def parse_portfolio(names) -> tuple[str, ...]:
    """Validate a portfolio member list (a comma string or iterable of
    registry names). Duplicate members are legal -- two 'scalar' members run
    independent CE distributions over disjoint slices -- but get distinct
    hunt-stream names from the farm (scalar, scalar2, ...)."""
    if isinstance(names, str):
        names = [n.strip() for n in names.split(",") if n.strip()]
    names = tuple(names)
    if not names:
        raise ValueError("a portfolio needs at least one member")
    unknown = [n for n in names if n not in FITNESS]
    if unknown:
        raise ValueError(
            f"unknown portfolio member(s) {unknown} (have {sorted(FITNESS)})"
        )
    return names

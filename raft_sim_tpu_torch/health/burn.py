"""Multi-window multi-burn-rate alerting (Google SRE Workbook, ch. 5); the
port of raft_sim_tpu/health/burn.py.

Burn rate = (bad-event fraction over a window) / (error budget). A burn of
1.0 spends exactly the budget over the objective's horizon; 6.0 exhausts it
six times faster. Each spec rule pairs a LONG window (is the budget really
burning?) with a SHORT one (is it burning NOW, i.e. the alert resets quickly
once the cause stops) -- an alert condition is met only when BOTH windows
burn at or above the rule's threshold. Windows are measured in evaluation
periods (the fleet's clock is the telemetry window, not wall time), with
partial history allowed at the front of a run so a standing loop is covered
from its first eval.

Lifecycle per (objective, rule):

    ok --met--> pending --met x pending_evals--> firing --clean x
    resolve_evals--> resolved (-> ok)

`pending_evals` consecutive ADDITIONAL met evals promote pending to firing
(default 1: fire on the 2nd consecutive met eval; 0 = page immediately --
the safety/recompile default). A pending alert whose condition clears drops
straight back to ok. Budget-0 objectives report BURN_INF when burning: any
rule fires.
"""

from __future__ import annotations

import dataclasses

# Stand-in for an infinite burn (budget 0, error > 0): finite so it survives
# JSON, larger than any sane rule threshold.
BURN_INF = 1e9

ALERT_STATES = ("ok", "pending", "firing", "resolved")


def burn_rate(err_mean: float, budget: float) -> float:
    if budget <= 0:
        return BURN_INF if err_mean > 0 else 0.0
    return min(err_mean / budget, BURN_INF)


@dataclasses.dataclass
class _RuleState:
    state: str = "ok"
    met_evals: int = 0
    clean_evals: int = 0


class BurnEngine:
    """Streaming burn-rate evaluator over one scope's eval stream. Feed it
    each period's {objective: err fraction} + budgets; it returns the alert
    TRANSITIONS (state changes only -- steady states emit nothing), each
    carrying the short/long burns that justified it."""

    def __init__(self, spec: dict):
        self.spec = spec
        self.rules = spec["rules"]
        max_long = max(r["long"] for r in self.rules)
        self._hist: dict[str, list[float]] = {
            name: [] for name in spec["objectives"]
        }
        self._max_long = max_long
        self._state: dict[tuple[str, str], _RuleState] = {
            (name, r["name"]): _RuleState()
            for name in spec["objectives"]
            for r in self.rules
        }

    def _burns(self, name: str, budget: float, rule: dict) -> tuple[float, float]:
        h = self._hist[name]
        short = h[-rule["short"]:]
        long = h[-rule["long"]:]
        return (
            burn_rate(sum(short) / len(short), budget),
            burn_rate(sum(long) / len(long), budget),
        )

    def update(self, errs: dict, budgets: dict) -> list[dict]:
        """Advance one evaluation period; returns transition dicts
        {objective, rule, state, burn_short, burn_long}."""
        transitions = []
        for name in self.spec["objectives"]:
            h = self._hist[name]
            h.append(float(errs[name]))
            del h[:-self._max_long]
            obj = self.spec["objectives"][name]
            pending_evals = obj.get("pending_evals", 1)
            resolve_evals = obj.get(
                "resolve_evals", self.spec["resolve_evals"]
            )
            for rule in self.rules:
                bs, bl = self._burns(name, budgets[name], rule)
                met = bs >= rule["burn"] and bl >= rule["burn"]
                st = self._state[(name, rule["name"])]
                new = None
                if st.state in ("ok", "resolved"):
                    if met:
                        st.met_evals = 1
                        new = "firing" if st.met_evals > pending_evals else "pending"
                elif st.state == "pending":
                    if met:
                        st.met_evals += 1
                        if st.met_evals > pending_evals:
                            new = "firing"
                    else:
                        st.met_evals = 0
                        new = "ok"
                elif st.state == "firing":
                    if met:
                        st.clean_evals = 0
                    else:
                        st.clean_evals += 1
                        if st.clean_evals >= resolve_evals:
                            st.met_evals = 0
                            st.clean_evals = 0
                            new = "resolved"
                if new is not None:
                    st.state = new
                    transitions.append({
                        "objective": name,
                        "rule": rule["name"],
                        "state": new,
                        "burn_short": round(bs, 4),
                        "burn_long": round(bl, 4),
                    })
        return transitions

    def burns(self, name: str, budget: float) -> dict:
        """Current per-rule [short, long] burns for the health line."""
        if not self._hist[name]:
            return {}
        return {
            r["name"]: [round(b, 4) for b in self._burns(name, budget, r)]
            for r in self.rules
        }

    def status(self) -> str:
        """Worst live state across every (objective, rule): the one-word
        answer a dashboard wants. `resolved` reads as ok -- it is a
        transition label, not a standing state."""
        states = {st.state for st in self._state.values()}
        if "firing" in states:
            return "firing"
        if "pending" in states:
            return "pending"
        return "ok"

    def firing(self) -> list[tuple[str, str]]:
        return sorted(
            key for key, st in self._state.items() if st.state == "firing"
        )

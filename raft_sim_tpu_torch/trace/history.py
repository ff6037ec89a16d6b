"""Host-side history reconstruction: exported trace windows -> per-cluster
timelines (the port of raft_sim_tpu/trace/history.py).

The trace ring (ring.py) exports one bounded event buffer per telemetry
window; this module decodes those buffers (the exported tensors, on any
device, or a sink directory's trace.jsonl) into per-cluster event TIMELINES
with an explicit completeness verdict. Completeness is load-bearing: the checker (trace/checker.py) must
never pass vacuously on a history with holes, so every reconstruction tracks
per-cluster dropped-event counts (window overflow), window contiguity, and
per-cluster tick monotonicity, and `History.complete` is False the moment
any of them fails.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Iterator, NamedTuple

import numpy as np
import torch

from raft_sim_tpu_torch.trace import events as tev


class Event(NamedTuple):
    tick: int
    node: int  # NIL (-1) = cluster-scope
    kind: int  # EV_* (trace/events.py)
    detail: int

    def to_dict(self, cluster: int | None = None) -> dict:
        d = {
            "tick": self.tick,
            "node": self.node,
            "kind": tev.KIND_NAMES.get(self.kind, str(self.kind)),
            "detail": self.detail,
        }
        if cluster is not None:
            d["cluster"] = cluster
        return d


@dataclasses.dataclass
class History:
    """Per-cluster event timelines plus the completeness facts about them."""

    events: dict[int, list[Event]]  # cluster -> events, (tick, slot) order
    emitted: dict[int, int]  # cluster -> events emitted by the ring
    dropped: dict[int, int]  # cluster -> events lost to window overflow
    n_windows: int
    problems: list[str]  # ordering/contiguity defects found while loading
    # A freeze_kind was armed (TraceSpec / trace_meta.json): recording stops
    # per cluster after the chosen event, so the history is a DELIBERATE
    # prefix -- fine for capture economy, but the checker must still refuse
    # to pass it as a whole-run verdict (ticks stay monotone and nothing
    # counts as dropped, so this flag is the only trace of the truncation).
    freeze_armed: bool = False

    @property
    def complete(self) -> bool:
        """True iff every cluster's full event stream is present and in
        order -- the precondition for a checker PASS (a violation found in a
        partial history is still a violation; a pass needs the whole story).
        Freeze-armed streams are by-design prefixes: never complete."""
        return (not self.problems and not any(self.dropped.values())
                and not self.freeze_armed)

    def incomplete_clusters(self) -> list[int]:
        return sorted(c for c, d in self.dropped.items() if d)


def _np(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def iter_window_events(traws) -> Iterator[tuple[int, int, list[Event]]]:
    """Decode a batch-minor stacked TraceWindowOut (leaves [W, R, B] / [W, B],
    tensors on any device or numpy arrays) into (window_index, cluster,
    events) triples, clusters with events only. Slot order within a window
    IS event order (ring.py clamps, never wraps)."""
    win = traws.win
    planes = [_np(x) for x in (win.ev_tick, win.ev_node, win.ev_kind, win.ev_detail)]
    n = _np(win.n)
    n_windows, depth, _ = planes[0].shape
    for w in range(n_windows):
        kept = np.minimum(n[w], depth)
        cols = np.flatnonzero(kept)
        rows = [p[w][:, cols].T.tolist() for p in planes]  # [cluster][slot] ints
        for j, c in enumerate(cols.tolist()):
            k = int(kept[c])
            yield w, c, [Event(*e) for e in zip(*(r[j][:k] for r in rows))]


def from_device(traws, spec=None) -> History:
    """Build a History straight from one run's stacked trace windows (leaves
    [W, R, B] / [W, B], tensors or arrays; the sink's path is `load`). Pass the run's TraceSpec so a freeze-armed capture is
    marked as the deliberate prefix it is."""
    n = _np(traws.win.n)
    n_windows, b = n.shape
    depth = traws.win.ev_kind.shape[1]
    events: dict[int, list[Event]] = {c: [] for c in range(b)}
    for _, c, evs in iter_window_events(traws):
        events[c].extend(evs)
    emitted = {c: int(n[:, c].sum()) for c in range(b)}
    dropped = {
        c: int(np.maximum(n[:, c] - depth, 0).sum()) for c in range(b)
    }
    return History(
        events=events, emitted=emitted, dropped=dropped,
        n_windows=n_windows, problems=[],
        freeze_armed=bool(spec is not None and spec.freeze_kind),
    )


def load(directory: str) -> History:
    """Rebuild a History from a sink directory's trace stream (trace.jsonl +
    trace_windows.jsonl, utils/telemetry_sink.py). Defects -- unparseable
    lines, non-contiguous window indices, per-cluster tick regressions
    (truncated or reordered files) -- are collected as `problems`, making the
    history incomplete rather than silently droppable."""
    problems: list[str] = []
    events: dict[int, list[Event]] = {}
    emitted: dict[int, int] = {}
    dropped: dict[int, int] = {}
    wpath = os.path.join(directory, "trace_windows.jsonl")
    epath = os.path.join(directory, "trace.jsonl")
    n_windows = 0
    prev_w = -1
    freeze_armed = False
    meta_path = os.path.join(directory, "trace_meta.json")
    if os.path.isfile(meta_path):
        try:
            with open(meta_path) as f:
                freeze_armed = bool(json.load(f).get("freeze_kind"))
        except (OSError, json.JSONDecodeError) as ex:
            problems.append(f"trace_meta.json unreadable: {ex}")
    if os.path.isfile(wpath):
        with open(wpath) as f:
            for ln, raw in enumerate(f, 1):
                try:
                    row = json.loads(raw)
                except json.JSONDecodeError as ex:
                    problems.append(f"trace_windows.jsonl:{ln}: not JSON: {ex}")
                    continue
                w = row.get("window")
                if not isinstance(w, int) or w != prev_w + 1:
                    problems.append(
                        f"trace_windows.jsonl:{ln}: window index {w!r} "
                        f"(expected {prev_w + 1}) -- stream truncated or "
                        "reordered"
                    )
                if isinstance(w, int):
                    prev_w = w
                n_windows += 1
                for c, d in (row.get("dropped_by_cluster") or {}).items():
                    dropped[int(c)] = dropped.get(int(c), 0) + int(d)
    else:
        problems.append("missing trace_windows.jsonl")
    if not os.path.isfile(epath):
        problems.append("missing trace.jsonl")
        return History(events, emitted, dropped, n_windows, problems,
                       freeze_armed)
    last_tick: dict[int, int] = {}
    with open(epath) as f:
        for ln, raw in enumerate(f, 1):
            try:
                row = json.loads(raw)
                c, t = int(row["c"]), int(row["t"])
                e = Event(t, int(row["node"]), int(row["k"]), int(row["d"]))
            except (json.JSONDecodeError, KeyError, TypeError, ValueError) as ex:
                problems.append(f"trace.jsonl:{ln}: bad event line: {ex}")
                continue
            if t < last_tick.get(c, -1):
                problems.append(
                    f"trace.jsonl:{ln}: cluster {c} tick {t} after tick "
                    f"{last_tick[c]} -- out-of-order or spliced stream"
                )
            last_tick[c] = max(last_tick.get(c, -1), t)
            events.setdefault(c, []).append(e)
            emitted[c] = emitted.get(c, 0) + 1
    # emitted counts include dropped events; file counts do not.
    for c, d in dropped.items():
        emitted[c] = emitted.get(c, 0) + d
    return History(events, emitted, dropped, n_windows, problems, freeze_armed)


def timeline_lines(hist: History, cluster: int, every: int = 1) -> Iterator[str]:
    """Render one cluster's timeline as human-readable lines."""
    for i, e in enumerate(hist.events.get(cluster, [])):
        if i % every:
            continue
        yield (
            f"tick {e.tick:>6}  "
            f"{'cluster' if e.node < 0 else f'node {e.node}':<8} "
            f"{tev.KIND_NAMES.get(e.kind, str(e.kind)):<12} {e.detail}"
        )


def chrome_trace(hist: History, clusters=None) -> dict:
    """Export histories as Chrome-trace / Perfetto JSON: one process per
    cluster, one track (tid) per node (cluster-scope events on a 'cluster'
    track), instant events named by kind -- opens in ui.perfetto.dev or
    chrome://tracing."""
    out = []
    sel = sorted(hist.events) if clusters is None else list(clusters)
    for c in sel:
        evs = hist.events.get(c, [])
        nodes = sorted({e.node for e in evs})
        for nd in nodes:
            out.append({
                "name": "thread_name", "ph": "M", "pid": c,
                "tid": nd + 1,
                "args": {"name": "cluster" if nd < 0 else f"node {nd}"},
            })
        for e in evs:
            out.append({
                "name": tev.KIND_NAMES.get(e.kind, str(e.kind)),
                "ph": "i",
                "s": "t",
                "ts": e.tick * 1000,  # 1 tick = 1ms, readable zoom levels
                "pid": c,
                "tid": e.node + 1,
                "args": {"detail": e.detail},
            })
    return {"traceEvents": out, "displayTimeUnit": "ms"}

"""Bytes moved per cluster-tick, leaf by leaf (the port of
tools/traffic_audit.py, for the tick kernel K1's layout).

Every tick reads the carry (ClusterState, its Mailbox and the RunMetrics),
writes it back, and draws the StepInputs; at large N those planes are the
tick's memory traffic. This audit lists each of them per cluster
(`_leaf_rows`: shape x itemsize, from the port's own structures), less the
legs the config leaves loop-invariant (`invariant_leaves`, the JAX
package's rule: no tick writes them), and prices the carry twice a tick
(read and write) and the inputs once. Beside each leaf it gives K1's view
(`tick_engine.leg_live`): whether the kernel reads or writes the leg at
all, or passes it through untouched; and it totals what K1 itself moves
(`tick_engine.traffic_bytes`), the count the port's bounds and its
reconciliation (obs/reconcile.py) use.

It then rebuilds the table for the dense layout before bit packing
(`_densify`: votes and the delivery mask as [N, N] bool, pre-vote grants
riding the resp_kind plane), the compacted layout's twin (ops/tile.py),
the telemetry carry (`--telemetry-ring K`), the scenario genome table
(`--scenario S`) and the serve mode's live offer plane (`--serve`).

The JAX tool's TPU lane/sublane padding column is left out: the card has no
such tile padding, so every figure here is logical bytes. Its roofline
projection anchors on a measurement of the port (`--measurement P`: a
`bench --measurement-pass` or `bench --out` document of the card): the
row's steady cluster-ticks/s times K1's bytes is the rate the card reached,
and the other layouts are projected at that rate. With no document given
there is no projection (the JAX tool's TPU round-5 numbers are no anchor
for the card). Nothing runs on the card: the shapes come from a one-cluster
fleet on the CPU.

    python -m raft_sim_tpu_torch.traffic_audit                     # configs 3/4/5
    python -m raft_sim_tpu_torch.traffic_audit --configs config5 --top 12
    python -m raft_sim_tpu_torch.traffic_audit --configs config3,config7x --json
    python -m raft_sim_tpu_torch.traffic_audit --serve --measurement pass.json
"""

from __future__ import annotations

import argparse
import json
import math
import sys

from raft_sim_tpu_torch.kernels import tick_engine
from raft_sim_tpu_torch.ops import bitplane
from raft_sim_tpu_torch.utils.config import PRESETS, RaftConfig


def invariant_leaves(cfg: RaftConfig) -> set[str]:
    """Carry legs the tick passes through untouched under `cfg` (the JAX
    package's analysis/policy.invariant_leaves, kept here: the port imports
    nothing of it). State fields bare, mailbox fields as `mb.<field>`,
    metrics as `metric.<field>`."""
    inv = set()
    if not cfg.pre_vote:
        inv |= {"mb.pv_grant"}
        if not cfg.read_lease and not cfg.reconfig:
            # heard_clock feeds the pre-vote quiet rule, the lease vote
            # denial and the removed-server denial: any gate keeps it live.
            inv |= {"heard_clock"}
    if not cfg.compaction:
        inv |= {"mb.req_base", "mb.req_base_term", "mb.req_base_chk", "log_base", "base_term",
                "base_chk"}
    if not cfg.client_redirect:
        inv |= {"client_pend", "client_dst"}
    if not cfg.track_offer_ticks:
        inv |= {"log_tick", "mb.ent_tick", "client_tick", "lat_frontier"}
    elif not cfg.client_redirect:
        inv |= {"client_tick"}
    if not cfg.reconfig:
        inv |= {"member_old", "member_new", "cfg_epoch", "cfg_pend", "log_cfg", "mb.ent_cfg"}
    if not (cfg.reconfig and cfg.compaction):
        inv |= {"base_mold", "base_pend", "base_epoch", "mb.req_base_mold", "mb.req_base_pend",
                "mb.req_base_epoch"}
    if not (cfg.leader_transfer and (cfg.reconfig or cfg.read_lease)):
        inv |= {"mb.req_disrupt"}
    if not cfg.leader_transfer:
        inv |= {"xfer_to", "mb.xfer_tgt"}
    if not cfg.read_index:
        inv |= {"read_idx", "read_tick", "read_acks", "metric.reads_served",
                "metric.read_lat_sum", "metric.read_hist"}
    if not cfg.read_lease:
        inv |= {"read_fr"}
    if not cfg.durable_storage:
        inv |= {"dur_len", "dur_term", "dur_vote", "metric.fsync_lag_sum",
                "metric.fsync_lag_max"}
    return inv


def _rows_of(group: str, prefix: str, tree) -> list[tuple]:
    """(group, name, per-cluster shape, itemsize) of every leaf of a
    one-cluster [1, ...] tree."""
    return [(group, prefix + f, tuple(v.shape[1:]), v.element_size())
            for f, v in zip(tree._fields, tree) if f != "mailbox"]


def _leaf_rows(cfg: RaftConfig) -> list[tuple]:
    """(group, name, shape, itemsize) of every carry leaf and per-tick input
    (shapes per cluster), less the loop-invariant legs."""
    from raft_sim_tpu_torch.sim import faults, scan

    state, keys = scan.seed_fleet(cfg, 0, 1, "cpu")
    inputs = faults.make_inputs(cfg, keys, 0)
    rows = _rows_of("state", "", state)
    rows += _rows_of("mailbox", "mb.", state.mailbox)
    rows += _rows_of("inputs", "in.", inputs)
    rows += _rows_of("metrics", "metric.", scan.init_metrics_batch(1, "cpu"))
    skip = invariant_leaves(cfg)
    return [r for r in rows if r[1] not in skip]


def _densify(rows, cfg: RaftConfig) -> list[tuple]:
    """The layout before bit packing: [N, N] bool votes and delivery mask,
    pre-vote grants riding resp_kind (no pv_grant plane)."""
    n = cfg.n_nodes
    out = []
    for g, name, shape, isize in rows:
        if name in ("votes", "in.deliver_mask"):
            out.append((g, name + " (dense)", (n, n), 1))
        elif name == "mb.pv_grant":
            continue  # its bit rode the resp_kind byte plane
        else:
            out.append((g, name, shape, isize))
    return out


def _telemetry_rows(cfg: RaftConfig, ring_k: int) -> list[tuple]:
    """Rows of the telemetry carry (sim/telemetry.py): the window-local
    RunMetrics and first-violation tick, and at ring_k > 0 the flight
    recorder (K stacked StepInfos, slot ticks, pos, frozen)."""
    from raft_sim_tpu_torch.sim import scan, telemetry

    rows = [("telemetry", f"tel.wm.{f}", shape, isize)
            for _, f, shape, isize in _rows_of("telemetry", "", scan.init_metrics_batch(1))]
    rows.append(("telemetry", "tel.first_viol", (), 4))
    if ring_k > 0:
        rec = telemetry.init_recorder(cfg, ring_k, 1)
        rows += [("telemetry", f"tel.ring.{f}", tuple(v.shape[:-1]), v.element_size())
                 for f, v in zip(rec.ring._fields, rec.ring)]
        rows += [("telemetry", "tel.ring.tick", (ring_k,), 4), ("telemetry", "tel.pos", (), 4),
                 ("telemetry", "tel.frozen", (), 1)]
    return rows


def _scenario_rows(s_count: int) -> list[tuple]:
    """Rows of the scenario genome table: each ScenarioGenome leaf, [S] per
    cluster, 4 bytes an element."""
    from raft_sim_tpu_torch.scenario.genome import ScenarioGenome

    return [("scenario", f"gen.{f}", (s_count,), 4) for f in ScenarioGenome._fields]


def _logical(shape, isize) -> int:
    return math.prod(shape) * isize


def k1_live(cfg: RaftConfig, row) -> bool:
    """Whether K1 reads or writes the row's leg (tick_engine.leg_live); the
    metric legs by their gate."""
    group, name = row[0], row[1].split(".", 1)[-1].split(" ")[0]
    if group == "metrics":
        return tick_engine.leg_live(cfg, "info_out", name)
    return (tick_engine.leg_live(cfg, group, name)
            or tick_engine.leg_live(cfg, group + "_out", name))


def total(rows) -> int:
    """Bytes a cluster-tick: the carry twice (read and write), inputs once."""
    return sum((1 if g == "inputs" else 2) * _logical(s, i) for g, _, s, i in rows)


def audit(cfg: RaftConfig) -> dict:
    """The per-cluster-tick byte totals of the packed layout, the dense one
    before packing, the bool-free bound and K1's own count."""
    packed = _leaf_rows(cfg)
    dense = _densify(packed, cfg)
    boolfree = [r for r in packed if r[1] not in ("votes", "in.deliver_mask", "mb.pv_grant")]
    live = [r for r in packed if k1_live(cfg, r)]
    read, written = tick_engine.traffic_bytes(cfg, 1)
    return {
        "packed_rows": packed,
        "dense_rows": dense,
        "packed_logical": total(packed),
        "dense_logical": total(dense),
        "boolfree_logical": total(boolfree),
        "k1_live_logical": total(live),
        "k1_passthrough_logical": total(packed) - total(live),
        "k1_read": read,
        "k1_written": written,
    }


def _fmt_bytes(b) -> str:
    return f"{b / 1024:.2f} KiB" if b >= 1024 else f"{b:.0f} B"


def measured_rates(path: str | None) -> dict:
    """{config: steady cluster-ticks/s} of a port measurement document (a
    `bench --measurement-pass` or `bench --out` document), card rows only;
    {} with no path."""
    if not path:
        return {}
    with open(path) as f:
        doc = json.load(f)
    return {name: row.get("steady_ticks_per_s") or row.get("cluster_ticks_per_s")
            for name, row in (doc.get("matrix") or {}).items()
            if isinstance(row, dict) and row.get("backend") == "cuda"
            and (row.get("steady_ticks_per_s") or row.get("cluster_ticks_per_s"))}


def report(name: str, cfg: RaftConfig, top: int, out=sys.stdout,
           telemetry_ring: int | None = None, scenario_segments: int | None = None,
           serve: bool = False, rates: dict | None = None) -> dict:
    a = audit(cfg)
    w = bitplane.n_words(cfg.n_nodes)
    print(f"\n== {name}: N={cfg.n_nodes} (W={w}), CAP={cfg.log_capacity}, "
          f"E={cfg.max_entries_per_rpc} ==", file=out)
    print(f"{'plane':28} {'shape':>14} {'bytes':>10} {'K1':>12}", file=out)
    for row in sorted(a["packed_rows"], key=lambda r: -_logical(r[2], r[3]))[:top]:
        print(f"{row[1]:28} {str(row[2]):>14} {_logical(row[2], row[3]):>10,} "
              f"{'live' if k1_live(cfg, row) else 'pass-through':>12}", file=out)
    dl, pl = a["dense_logical"], a["packed_logical"]
    k1 = a["k1_read"] + a["k1_written"]
    print(f"{'per-cluster-tick DENSE':28} {'':>14} {dl:>10,}", file=out)
    print(f"{'per-cluster-tick PACKED':28} {'':>14} {pl:>10,}", file=out)
    print(f"{'  of which K1 passes through':28} {'':>14} {a['k1_passthrough_logical']:>10,}",
          file=out)
    print(f"{'K1 moves (read + written)':28} {'':>14} {k1:>10,}", file=out)
    print(f"reduction: {100 * (1 - pl / dl):.1f}%", file=out)
    res = {
        "config": name,
        "n": cfg.n_nodes,
        "dense_logical": dl,
        "packed_logical": pl,
        "boolfree_logical": a["boolfree_logical"],
        "k1_live_logical": a["k1_live_logical"],
        "k1_passthrough_logical": a["k1_passthrough_logical"],
        "k1_read": a["k1_read"],
        "k1_written": a["k1_written"],
    }
    if not cfg.compact_planes:
        from raft_sim_tpu_torch.types import compact_twin

        c = audit(compact_twin(cfg))
        res["compact_logical"] = c["packed_logical"]
        print(f"{'per-cluster-tick COMPACTED':28} {'':>14} {c['packed_logical']:>10,}", file=out)
    rec = (rates or {}).get(name)
    if rec:
        from raft_sim_tpu_torch.obs.reconcile import HBM_BYTES_PER_S

        bw = rec * k1
        res.update(recorded_ticks_per_s=rec, implied_bytes_per_s=bw,
                   card_roofline_ticks_per_s=HBM_BYTES_PER_S / k1,
                   boolfree_projection_ticks_per_s=bw / a["boolfree_logical"] * k1 / pl)
        print(f"measured: {rec / 1e6:.3f}M ticks/s -> K1 moves {bw / 1e9:.1f} GB/s "
              f"({100 * bw / HBM_BYTES_PER_S:.1f}% of the card's HBM peak); roofline "
              f"{HBM_BYTES_PER_S / k1 / 1e6:.1f}M ticks/s", file=out)
        if "compact_logical" in res:
            res["compact_projection_ticks_per_s"] = rec * pl / res["compact_logical"]
            print(f"COMPACTED projection at that rate: "
                  f"{res['compact_projection_ticks_per_s'] / 1e6:.3f}M ticks/s", file=out)
    if telemetry_ring is not None:
        tel_rows = _telemetry_rows(cfg, telemetry_ring)
        tel = total(tel_rows)
        wm = total([r for r in tel_rows if not r[1].startswith("tel.ring")
                    and r[1] not in ("tel.pos", "tel.frozen")])
        print(f"telemetry carry legs (window accumulator"
              + (f" + ring K={telemetry_ring}" if telemetry_ring else "")
              + f"): {_fmt_bytes(tel)} per cluster-tick = +{100 * tel / pl:.1f}% over the packed "
              f"tick (windows alone: +{100 * wm / pl:.1f}%)", file=out)
        res.update(telemetry_ring=telemetry_ring, telemetry_logical=tel,
                   telemetry_window_only_logical=wm, telemetry_overhead_frac=tel / pl)
    if serve:
        from raft_sim_tpu_torch.serve.loop import serve_config

        scfg = serve_config(cfg)
        s_rows = _leaf_rows(scfg)
        plane = [r for r in s_rows if r[1] in ("log_tick", "mb.ent_tick", "client_tick")]
        s_total = total(s_rows)
        s_k1 = sum(tick_engine.traffic_bytes(scfg, 1))
        print(f"serve mode (offer-tick plane live): {_fmt_bytes(pl)} -> {_fmt_bytes(s_total)} "
              f"per cluster-tick (+{100 * (s_total - pl) / pl:.1f}%); the plane itself "
              f"({', '.join(r[1] for r in plane)}) costs {_fmt_bytes(total(plane))}; K1 moves "
              f"{s_k1:,} B", file=out)
        res.update(serve_logical=s_total, serve_plane_logical=total(plane), serve_k1_bytes=s_k1,
                   serve_overhead_frac=(s_total - pl) / pl)
    if scenario_segments is not None:
        sc = sum(_logical(s, i) for _, _, s, i in _scenario_rows(scenario_segments))
        print(f"scenario genome table (S={scenario_segments} segments): {_fmt_bytes(sc)} per "
              f"cluster-tick = +{100 * sc / pl:.2f}% over the packed tick", file=out)
        res.update(scenario_segments=scenario_segments, scenario_logical=sc,
                   scenario_overhead_frac=sc / pl)
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m raft_sim_tpu_torch.traffic_audit",
                                 description=__doc__.splitlines()[0])
    ap.add_argument("--configs", default="config3,config4,config5",
                    help="comma-separated preset names")
    ap.add_argument("--top", type=int, default=8, help="largest planes listed")
    ap.add_argument("--json", action="store_true",
                    help="one JSON line on stdout (the tables go to stderr)")
    ap.add_argument("--telemetry-ring", type=int, default=None, metavar="K",
                    help="also price the telemetry carry: the window accumulator and a K-deep "
                         "flight recorder (K=0: windows alone)")
    ap.add_argument("--scenario", type=int, default=None, metavar="S",
                    help="also price an S-segment scenario genome table per cluster")
    ap.add_argument("--serve", action="store_true",
                    help="also price serve mode: the offer-tick plane live")
    ap.add_argument("--measurement", metavar="P", default=None,
                    help="a port measurement document of the card (bench --measurement-pass "
                         "or bench --out): anchors the roofline projection on its rows")
    args = ap.parse_args(argv)
    table_out = sys.stderr if args.json else sys.stdout
    rates = measured_rates(args.measurement)
    results = []
    for name in args.configs.split(","):
        name = name.strip()
        if name not in PRESETS:
            print(f"unknown preset {name!r}", file=sys.stderr)
            return 2
        results.append(report(name, PRESETS[name][0], args.top, out=table_out,
                              telemetry_ring=args.telemetry_ring,
                              scenario_segments=args.scenario, serve=args.serve, rates=rates))
    if args.json:
        print(json.dumps(results))
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""ChunkTimer: per-chunk runtime attribution for the standing loops (the port
of raft_sim_tpu/obs/timer.py).

Every long-horizon loop of the port advances the fleet in chunks with host
work between them (metric merges, telemetry export, ingest packing, fitness
evaluation). That boundary is where runtime behaviour shows without touching
the tick. The timer splits each chunk's wall time into host-measurable
phases:

    begin ──(last launch queued)── dispatched ──(host work)── sync ── end
      │         dispatch_s                │        host_s       │ device_wait_s
      └────────────────────────────── wall_s ───────────────────────┘
    gap_s = time from the previous chunk's end to this begin.

`device_wait_s` is the time blocked on a forced HOST COPY of a small chunk
output (`end(sync=...)`: a `.cpu()` of `metrics.ticks`). It is a lower bound
on device time: whatever the card ran while the host was still queueing
launches or doing host work is hidden in `dispatch_s` and `host_s`. The port
queues each tick's kernel launch from the host, so a chunk's `dispatch_s`
holds the host's launch loop and the card runs behind it; the wait is what
is left once the host has queued the last launch. Arming the timer adds one
host sync a chunk.

At every chunk boundary the timer samples the card's allocated bytes
(`live_bytes`, None on the CPU) and each registered probe: the kernel path's
caches (`tick_engine.cache_probes`) under the row field `jit_cache`, kept
under the JAX package's name so both packages' validate() read the rows. A
probe that GROWS after warmup is the recompile watchdog firing: a library
loaded or a launch template worked out mid-run. The row is marked, the
summary says so and `finish()` prints a finding.

Rows stream to the telemetry sink as perf.jsonl (utils/telemetry_sink.py
validates them). Everything here is host-side, so the timer never changes a
trajectory.
"""

from __future__ import annotations

import sys
import time

import torch


def device_live_bytes(device=None) -> int | None:
    """Bytes the caching allocator holds for tensors on `device` (a card), or
    None where there is no such count (the CPU, or no device given)."""
    if device is None:
        return None
    dev = torch.device(device)
    if dev.type != "cuda":
        return None
    return int(torch.cuda.memory_allocated(dev))


class ChunkTimer:
    """Per-chunk runtime attribution (the module docstring has the phases).

    >>> t = ChunkTimer(label="run", batch=batch, sink=sink); t.watch(dev)
    >>> t.begin(n_ticks); out = run_chunk(...); t.dispatched()
    >>> ...host work...; t.end(sync=lambda: out.ticks.cpu())
    >>> t.finish()  # the summary; prints the watchdog's finding if it fired

    `warmup_chunks` rows are flagged warmup and left out of the steady-state
    rollup. The default is 2, as in the JAX package, so that rows and rollups
    of the two packages have the same shape. The JAX reason (a donated chunk
    re-specialises at its second call) does not hold here; what does is that
    chunk 0 loads and, in a fresh checkout, builds the kernel library and
    works out each launch template, and chunk 1 is the first that runs on
    warm caches and a warm allocator. The watchdog's baseline is the first
    steady chunk's probe sample. `sink` (a TelemetrySink or anything with
    `append_perf`) streams each row to perf.jsonl; without one, rows stay on
    `self.rows`. The loop's `watch(device)` names the device it runs on.
    """

    def __init__(self, label: str = "run", batch: int = 1, sink=None, warmup_chunks: int = 2):
        if warmup_chunks < 0:
            raise ValueError(f"warmup_chunks must be >= 0, got {warmup_chunks}")
        self.label = label
        self.batch = int(batch)
        self.sink = sink
        self.warmup_chunks = warmup_chunks
        self.device = None
        self.rows: list[dict] = []
        self._probes: dict[str, object] = {}
        self._probe_base: dict[str, int] = {}
        self._recompiled = False
        self._chunk = 0
        self._t_begin = self._t_disp = None
        self._t_prev_end = None
        self._ticks = 0
        self._gap = 0.0
        self._extra: dict = {}

    # -------------------------------------------------------------- probes

    def add_probe(self, name: str, fn) -> None:
        """Register a zero-argument int callable sampled at every chunk
        boundary. Idempotent: the loops register theirs unconditionally."""
        if name not in self._probes:
            self._probes[name] = fn

    def watch(self, device) -> None:
        """What every loop calls before its first chunk: register the kernel
        path's cache probes, and take the loop's device."""
        from raft_sim_tpu_torch.kernels import tick_engine

        for name, fn in tick_engine.cache_probes().items():
            self.add_probe(name, fn)
        self.device = device

    def _cache_sizes(self) -> dict[str, int]:
        out = {}
        for name, fn in self._probes.items():
            try:
                out[name] = int(fn())
            except Exception:
                out[name] = -1  # unprobeable: visible, not fatal
        return out

    # --------------------------------------------------------------- phases

    def begin(self, ticks: int) -> None:
        t = time.perf_counter()
        self._gap = 0.0 if self._t_prev_end is None else t - self._t_prev_end
        self._ticks = int(ticks)
        self._t_begin = t
        self._t_disp = None

    def dispatched(self) -> None:
        """Call right after the chunk's last launch is queued."""
        self._t_disp = time.perf_counter()

    def annotate(self, **extra) -> None:
        """Attach loop-measured sub-phase fields (JSON-able) to the current
        chunk's row, e.g. the serve loop's export_s and pack_s."""
        self._extra.update(extra)

    def end(self, sync=None) -> dict:
        """Close the chunk: `sync` forces a host copy of a small chunk output
        (its duration is the device wait); sample memory and the probes,
        append the row and stream it to the sink."""
        if self._t_begin is None:
            raise RuntimeError("ChunkTimer.end() without begin()")
        t_host = time.perf_counter()
        if sync is not None:
            sync()
        t = time.perf_counter()
        t_disp = self._t_disp if self._t_disp is not None else t_host
        caches = self._cache_sizes()
        warmup = self._chunk < self.warmup_chunks
        recompiled = False
        if not warmup:
            for name, size in caches.items():
                base = self._probe_base.setdefault(name, size)
                if size > base:
                    recompiled = True
                    self._recompiled = True
        row = {
            "chunk": self._chunk,
            "ticks": self._ticks,
            "warmup": warmup,
            "wall_s": round(t - self._t_begin, 6),
            "dispatch_s": round(t_disp - self._t_begin, 6),
            "host_s": round(t_host - t_disp, 6),
            "device_wait_s": round(t - t_host, 6),
            "gap_s": round(self._gap, 6),
            "live_bytes": device_live_bytes(self.device),
            "jit_cache": caches,
            "recompiled": recompiled,
            **self._extra,
        }
        self._extra = {}
        self.rows.append(row)
        if self.sink is not None:
            self.sink.append_perf([row])
        self._chunk += 1
        self._t_begin = self._t_disp = None
        self._t_prev_end = t
        return row

    # -------------------------------------------------------------- rollups

    def summary(self) -> dict:
        """Steady-state rollup over the recorded rows (warmup left out)."""
        return summarize_rows(self.rows, label=self.label, batch=self.batch,
                              warmup_chunks=self.warmup_chunks)

    def finish(self, out="stderr") -> dict:
        """End-of-run summary; prints the watchdog's finding (and which probe
        grew) when a steady chunk grew a cache. `out` is resolved at call
        time (sys.stderr by default); None silences it."""
        s = self.summary()
        if out == "stderr":
            out = sys.stderr
        if s["recompiled_after_warmup"] and out is not None:
            grown = [
                f"{name} {self._probe_base.get(name, '?')}->{size}"
                for name, size in (self.rows[-1]["jit_cache"] or {}).items()
                if size > self._probe_base.get(name, size)
            ]
            print(f"perf watchdog [{self.label}]: kernel cache grew after warmup "
                  f"({', '.join(grown) or 'see perf.jsonl jit_cache'}) -- a standing loop "
                  "loaded a library or worked out a launch template mid-run", file=out)
        return s


def summarize_rows(rows: list[dict], label: str = "run", batch: int = 1,
                   warmup_chunks: int | None = None) -> dict:
    """Fold perf rows (live ChunkTimer rows or re-read perf.jsonl lines) into
    the steady-state summary. `warmup_chunks` None trusts each row's own
    `warmup` flag (what the file form must do)."""
    if warmup_chunks is None:
        steady = [r for r in rows if not r.get("warmup")]
    else:
        steady = [r for r in rows if r["chunk"] >= warmup_chunks]
    ticks = sum(r["ticks"] for r in steady)
    wall = sum(r["wall_s"] + r["gap_s"] for r in steady)
    host_gap = sum(r["dispatch_s"] + r["host_s"] + r["gap_s"] for r in steady)
    wait = sum(r["device_wait_s"] for r in steady)
    live = [r["live_bytes"] for r in rows if r.get("live_bytes") is not None]
    return {
        "label": label,
        "batch": int(batch),
        "chunks": len(rows),
        "steady_chunks": len(steady),
        "steady_ticks": ticks,
        "steady_wall_s": round(wall, 6),
        "steady_ticks_per_s": round(ticks / wall, 1) if wall > 0 else None,
        "steady_cluster_ticks_per_s": round(batch * ticks / wall, 1) if wall > 0 else None,
        "device_wait_s": round(wait, 6),
        "host_gap_s": round(host_gap, 6),
        "host_gap_frac": round(host_gap / wall, 4) if wall > 0 else None,
        "live_bytes_peak": max(live) if live else None,
        "jit_cache_final": dict(rows[-1]["jit_cache"]) if rows else {},
        "recompiled_after_warmup": any(r.get("recompiled") for r in rows),
    }

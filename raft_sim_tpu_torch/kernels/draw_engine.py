"""The Hopper draw kernel's wrapper (K2): `draw_cuda(cfg, keys, now, ...)`.

The tick's input draws -- `faults.make_inputs` over the threefry streams,
the scalar path, the genome path and the trace plane's fault facts -- as one
kernel launch a tick (csrc/draws.cu over csrc/draws.cuh), and `draw_span`'s
span of ticks as one launch. It replaces no TPU kernel: XLA fuses
`jax.vmap(faults.make_inputs)` into the JAX package's scan program; this is
the port's counterpart of that fused program.

Dispatch is by the device the keys lie on, as `step_cuda`'s: CPU keys go to
the plain draws (`draw_plain`: sim/faults.py), CUDA keys to the kernel, or
raise -- a leaf of the wrong device, dtype or shape raises ValueError, a
per-row tick off the genome path TypeError (as the plain version), a gate
the kernel does not take NotImplementedError, and a refused launch
RuntimeError. Nothing on the card falls back to the plain draws.

Every leaf comes batch-minor (`[..., B]`, contiguous; a span's `[T, ...,
B]`), the layout the tick kernel reads, so `scan.tick_batch_minor` moves
nothing between the two launches.

Build: at first use, `nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17
-O3 -Xcompiler -fPIC -Xptxas -v -shared` compiles csrc/draws.cu into one
library in raft_sim_tpu_torch/build/ (ignored by git), named by a hash of
the sources (chip_smoke.py starts it beside the tick kernel's nine objects:
`start_build`, `finish_build`); ctypes loads it. `draw_cuda.launches` counts kernel
launches (and nothing else). The same body compiled by g++
(csrc/draws_host.cpp, `host_library`, `draw_host`) is what the CPU tests
hold against the plain draws, in both worker orders with the staging
poisoned. The race proxy (`build(proxy=True)`, -DRS_RACE_PROXY: the tile's
rows and nodes mapped to threads in reverse, the staged side bits poisoned
before they are staged) is a library of its own that `draw_cuda(...,
proxy=True)` launches for chip_smoke.py; the main path never loads it.
"""

from __future__ import annotations

import ctypes
import math
import os
import re
import subprocess
import threading
import time
from pathlib import Path

import numpy as np
import torch

from raft_sim_tpu_torch import types as T
from raft_sim_tpu_torch.kernels import tick_engine
from raft_sim_tpu_torch.ops import bitplane
from raft_sim_tpu_torch.scenario.genome import U32_FIELDS, ScenarioGenome
from raft_sim_tpu_torch.sim import faults

CSRC = tick_engine.CSRC
BUILD_DIR = tick_engine.BUILD_DIR
SOURCES = ("draws.cuh", "draws.cu")
HOST_SOURCES = ("draws.cuh", "draws_host.cpp")

# csrc/draws.cuh's `Ptr` enum: the keys, the per-row tick, the genome's
# leaves (ScenarioGenome's field order), StepInputs, the fault facts.
FACTS_OUT = ("crashed", "cut_now", "cut_prev")
PTR_ORDER = (
    [("keys", "keys"), ("now", "now")]
    + [("genome", f) for f in ScenarioGenome._fields]
    + [("inputs", f) for f in T.StepInputs._fields]
    + [("facts", f) for f in FACTS_OUT]
)

# Hopper's integer rates a clock per SM: 4 schedulers issue one warp
# instruction each (128 lanes); a funnel shift, logic op or compare runs only
# on the ALU pipe (4 x 16 lanes), an add there (IADD3) or on the FMA-heavy
# pipe (IMAD.IADD, 4 x 16 more).
ISSUE_LANES_PER_SM = 128
ALU_LANES_PER_SM = 64
# One drop draw as the leaner of the draw kernels runs it, read from their
# SASS (`sass_block_ops`; nvcc 12.9, sm_90a): the counter, the threefry
# block with its key hoisted out of the loop, the output xor and the
# threshold compare -- 69 instructions, 42 of them ALU-only (rotates, xors,
# the counter's high word, the compare), the rest adds.
BLOCK_OPS = {"total": 69, "alu_only": 42}
# SASS opcodes the FMA pipe cannot run (the rest of a block's are adds).
ALU_ONLY = ("SHF", "LOP3", "ISETP", "LEA", "SEL", "PLOP3", "PRMT")


class DrawParams(ctypes.Structure):
    """csrc/draws.cuh `DrawParams`."""

    _fields_ = [
        ("rows", ctypes.c_int64),
        ("kb", ctypes.c_int64),
        ("now0", ctypes.c_int64),
        ("n", ctypes.c_int32),
        ("w", ctypes.c_int32),
        ("k", ctypes.c_int32),
        ("genome", ctypes.c_int32),
        ("s_count", ctypes.c_int32),
        ("seg_len", ctypes.c_int32),
        ("facts", ctypes.c_int32),
        ("redirect", ctypes.c_int32),
        ("el_min", ctypes.c_int32),
        ("el_range", ctypes.c_int32),
        ("crash_period", ctypes.c_int32),
        ("drop_uniform", ctypes.c_int32),
        ("drop_t", ctypes.c_uint32),
        ("drop_base", ctypes.c_uint32),
        ("part_period", ctypes.c_int32),
        ("part_t", ctypes.c_uint32),
        ("skew_t", ctypes.c_uint32),
        ("crash_t", ctypes.c_uint32),
        ("crash_down", ctypes.c_int32),
        ("client_interval", ctypes.c_int32),
        ("reconfig_interval", ctypes.c_int32),
        ("transfer_interval", ctypes.c_int32),
        ("read_interval", ctypes.c_int32),
        ("fsync_interval", ctypes.c_int32),
        ("jit_t", ctypes.c_uint32),
        ("torn_t", ctypes.c_uint32),
        ("torn_span", ctypes.c_int32),
    ]


BUILD_INFO: dict = {}
PROXY_BUILD_INFO: dict = {}
_LIBS: dict = {}
_COUNT = threading.Lock()  # node shards launch from threads of their own


def build_cmd(out: Path, proxy: bool = False) -> list[str]:
    """The nvcc command that compiles csrc/draws.cu into the library `out`
    (`proxy`: the race proxy's)."""
    return [tick_engine._nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
            "-Xcompiler", "-fPIC", "-Xptxas", "-v", *(["-DRS_RACE_PROXY"] if proxy else []),
            "-shared", "-o", str(out), str(CSRC / "draws.cu")]


def library_path(proxy: bool = False) -> Path:
    name = "libdraws_proxy" if proxy else "libdraws"
    return BUILD_DIR / f"{name}_{tick_engine._source_tag(SOURCES)}.so"


def start_build(proxy: bool = False):
    """Start the nvcc run of a missing library (`proxy`: the race proxy's):
    (process, temporary output, start time, proxy), or None when the library
    is built; `finish_build` waits for it. A caller may start it beside
    `tick_engine.build`'s nine."""
    out = library_path(proxy)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    return tick_engine.spawn(build_cmd(tmp, proxy)), tmp, time.perf_counter(), proxy


def finish_build(started, proxy: bool = False) -> Path:
    """Wait for `start_build`'s nvcc run and move its library into place;
    BUILD_INFO (PROXY_BUILD_INFO) records the seconds and ptxas's report."""
    if started is None:
        return library_path(proxy)
    proc, tmp, t0, proxy = started
    (report,) = tick_engine.reap([proc], ["nvcc (csrc/draws.cu)"])
    return tick_engine.install(tmp, library_path(proxy), report, t0,
                               PROXY_BUILD_INFO if proxy else BUILD_INFO)


def build(proxy: bool = False) -> Path:
    """Compile csrc/draws.cu for sm_90a into BUILD_DIR (once per source hash)
    and return the library's path (`proxy`: the race proxy's)."""
    return finish_build(start_build(proxy), proxy)


def _declare(lib, entry: str) -> ctypes.CDLL:
    fn = getattr(lib, entry)
    fn.argtypes = [ctypes.POINTER(DrawParams), ctypes.POINTER(ctypes.c_void_p)] + (
        [ctypes.c_void_p] if entry == "rs_draws_launch" else [ctypes.c_int, ctypes.c_int])
    fn.restype = ctypes.c_int
    lib.rs_draws_n_ptr.restype = ctypes.c_int
    if lib.rs_draws_n_ptr() != len(PTR_ORDER):
        raise RuntimeError("csrc/draws.cuh Ptr enum and PTR_ORDER disagree")
    return lib


def _load_cuda(proxy: bool = False) -> ctypes.CDLL:
    name = "proxy" if proxy else "cuda"
    if name not in _LIBS:
        _LIBS[name] = _declare(ctypes.CDLL(str(build(proxy))), "rs_draws_launch")
    return _LIBS[name]


def host_library(cxx: str) -> Path:
    """The g++ build of the draw body (csrc/draws_host.cpp) for the current
    sources, in BUILD_DIR under their hash: built once, under a file lock."""
    out = BUILD_DIR / f"libdraws_host_{tick_engine._source_tag(HOST_SOURCES)}.so"
    return tick_engine.locked_build(out, lambda tmp: subprocess.run(
        [cxx, "-std=c++17", "-O2", "-Wall", "-Werror", "-fPIC", "-shared", "-o", str(tmp),
         str(CSRC / "draws_host.cpp")], check=True, capture_output=True, text=True))


def load_host(path) -> ctypes.CDLL:
    """Load a g++ build of the draw body (`host_library`) for `draw_host`."""
    lib = _declare(ctypes.CDLL(str(path)), "rs_draws_host")
    lib.rs_draws_tile_rows.argtypes = [ctypes.c_int]
    lib.rs_draws_tile_rows.restype = ctypes.c_int
    lib.rs_draws_threefry.argtypes = [ctypes.c_int, ctypes.c_int64] + [ctypes.c_void_p] * 3 + [
        ctypes.c_int64, ctypes.c_int64, ctypes.c_void_p]
    lib.rs_draws_threefry.restype = None
    return lib


# ---- the plain draws ----------------------------------------------------------


def _minor(out, facts: bool, axis: int):
    """The plain draws' leaves with the batch axis `axis` moved last."""
    move = lambda x: x.movedim(axis, -1).contiguous()  # noqa: E731
    if not facts:
        return T.StepInputs(*map(move, out))
    return T.StepInputs(*map(move, out[0])), tuple(map(move, out[1]))


def draw_plain(cfg: T.RaftConfig, keys: torch.Tensor, now, genome=None, seg_len: int = 1,
               facts: bool = False):
    """The plain PyTorch draws (sim/faults.py `make_inputs`), in the kernel's
    batch-minor output layout: the kernel's counterpart on any device, and
    what CPU keys dispatch to."""
    return _minor(faults.make_inputs(cfg, keys, now, genome=genome, seg_len=seg_len,
                                     facts=facts), facts, 0)


# ---- the launch -----------------------------------------------------------------


def params(cfg: T.RaftConfig, kb: int, ticks: int, now0: int, genome, seg_len: int,
           facts: bool) -> DrawParams:
    """The kernel's DrawParams for `kb` clusters over `ticks` tick groups from
    `now0` (the scalar path's fault settings from `cfg`; gated-off mechanisms
    carry threshold or interval 0)."""
    uniform = cfg.drop_prob > 0 and cfg.drop_prob_uniform
    dur = cfg.durable_storage
    _u32 = faults.p_to_u32
    return DrawParams(
        rows=kb * ticks, kb=kb, now0=now0, n=cfg.n_nodes, w=bitplane.n_words(cfg.n_nodes),
        k=cfg.client_pipeline, genome=int(genome is not None),
        s_count=0 if genome is None else genome.drop.shape[-1], seg_len=seg_len,
        facts=int(facts), redirect=int(cfg.client_redirect),
        el_min=cfg.election_min_ticks, el_range=cfg.election_range_ticks,
        crash_period=cfg.crash_period if (genome is not None or cfg.crash_prob > 0) else 1,
        drop_uniform=int(uniform),
        drop_t=_u32(cfg.drop_prob) if cfg.drop_prob > 0 and not uniform else 0,
        drop_base=min(_u32(cfg.drop_prob), (1 << 32) - 2) if uniform else 0,
        part_period=max(cfg.partition_period, 0), part_t=_u32(cfg.partition_prob),
        skew_t=_u32(cfg.clock_skew_prob) if cfg.clock_skew_prob > 0 else 0,
        crash_t=_u32(cfg.crash_prob) if cfg.crash_prob > 0 else 0,
        crash_down=cfg.crash_down_ticks, client_interval=cfg.client_interval,
        reconfig_interval=cfg.reconfig_interval, transfer_interval=cfg.transfer_interval,
        read_interval=cfg.read_interval, fsync_interval=cfg.fsync_interval,
        jit_t=_u32(cfg.fsync_jitter_prob) if dur else 0,
        torn_t=_u32(cfg.torn_tail_prob) if dur else 0, torn_span=cfg.lost_suffix_span,
    )


def out_specs(cfg: T.RaftConfig, facts: bool) -> dict:
    """{(group, name): (per-row shape, dtype)} of every leaf the kernel writes."""
    n, k = cfg.n_nodes, cfg.client_pipeline
    w = bitplane.n_words(n)
    i32, b8 = torch.int32, torch.bool
    specs = {
        ("inputs", "deliver_mask"): ((n * w,) if cfg.compact_planes else (n, w), i32),
        ("inputs", "skew"): ((n,), i32), ("inputs", "timeout_draw"): ((n,), i32),
        ("inputs", "client_cmd"): ((), i32), ("inputs", "client_target"): ((), i32),
        ("inputs", "client_bounce"): ((k,), i32), ("inputs", "alive"): ((n,), b8),
        ("inputs", "restarted"): ((n,), b8), ("inputs", "reconfig_cmd"): ((), i32),
        ("inputs", "transfer_cmd"): ((), i32), ("inputs", "read_cmd"): ((), i32),
        ("inputs", "fsync_fire"): ((n,), b8), ("inputs", "torn_drop"): ((n,), i32),
    }
    if facts:
        specs.update({("facts", "crashed"): ((n,), b8), ("facts", "cut_now"): ((), i32),
                      ("facts", "cut_prev"): ((), i32)})
    return specs


def _check(name: str, x, shape, dtype, device) -> None:
    if not isinstance(x, torch.Tensor):
        raise ValueError(f"{name}: expected a tensor, got {type(x).__name__}")
    if x.device != device:
        raise ValueError(f"{name}: on {x.device}, keys on {device}")
    if x.dtype != dtype or tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name}: {tuple(x.shape)} {x.dtype}, expected {tuple(shape)} {dtype}")
    if not x.is_contiguous():
        raise ValueError(f"{name}: not contiguous")


def check_supported(cfg: T.RaftConfig, genome) -> None:
    """Raise NotImplementedError for what the kernel does not take."""
    if genome is not None and cfg.crash_period < 1:
        raise NotImplementedError(f"the draw kernel's genome path needs crash_period >= 1, "
                                  f"got {cfg.crash_period}")


def _prepare(cfg, keys, now, genome, seg_len, facts, ticks):
    """Validate the leaves, allocate the outputs and build the launch
    arguments: (params, ptrs, outs). `ticks` is None for one tick (`now` an
    int, or a [B] int32 tensor of per-row ticks on the genome path), else a
    span of `ticks` ticks from the int `now`."""
    check_supported(cfg, genome)
    dev = keys.device
    if keys.dim() != 2:
        raise ValueError(f"keys: {tuple(keys.shape)}, expected [B, 2]")
    kb = keys.shape[0]
    _check("keys", keys, (kb, 2), torch.int64, dev)
    per_row = isinstance(now, torch.Tensor)
    if per_row and genome is None:
        raise TypeError("make_inputs: per-row ticks are taken on the scenario path only")
    if per_row:
        if ticks is not None:
            raise TypeError("draw_span: t0 is an int")
        _check("now", now, (kb,), torch.int32, dev)
    if genome is not None:
        s_count = genome.drop.shape[-1] if genome.drop.dim() == 2 else 0
        for name in ScenarioGenome._fields:
            dtype = torch.int64 if name in U32_FIELDS else torch.int32
            _check(f"genome.{name}", getattr(genome, name), (kb, s_count), dtype, dev)
        if s_count < 1 or seg_len < 1:
            raise ValueError(f"genome: {s_count} segments of {seg_len} ticks")
    n_ticks = 1 if ticks is None else ticks
    outs = {}
    ptrs = (ctypes.c_void_p * len(PTR_ORDER))()
    specs = out_specs(cfg, facts)
    for j, (group, name) in enumerate(PTR_ORDER):
        if group == "keys":
            ptrs[j] = keys.data_ptr()
        elif group == "now":
            ptrs[j] = now.data_ptr() if per_row else None
        elif group == "genome":
            ptrs[j] = getattr(genome, name).data_ptr() if genome is not None else None
        elif (group, name) in specs:
            shape, dtype = specs[(group, name)]
            full = (() if ticks is None else (ticks,)) + shape + (kb,)
            x = outs[(group, name)] = torch.empty(full, dtype=dtype, device=dev)
            ptrs[j] = x.data_ptr()
        else:
            ptrs[j] = None
    p = params(cfg, kb, n_ticks, 0 if per_row else int(now), genome, seg_len, facts)
    return p, ptrs, outs


def _assemble(outs, facts: bool):
    inp = T.StepInputs(*(outs[("inputs", f)] for f in T.StepInputs._fields))
    if not facts:
        return inp
    return inp, tuple(outs[("facts", f)] for f in FACTS_OUT)


def _cuda_launch(p: DrawParams, ptrs, device, proxy: bool = False) -> None:
    """THE launch site: one draw kernel on the current stream, counted."""
    lib = _load_cuda(proxy)
    stream = torch.cuda.current_stream(device).cuda_stream
    rc = lib.rs_draws_launch(ctypes.byref(p), ptrs, ctypes.c_void_p(stream))
    if rc != 0:
        raise RuntimeError(f"draw kernel refused or failed to launch (code {rc})")
    with _COUNT:
        draw_cuda.launches += 1


def draw_cuda(cfg: T.RaftConfig, keys: torch.Tensor, now, genome=None, seg_len: int = 1,
              facts: bool = False, proxy: bool = False):
    """`faults.make_inputs(cfg, keys, now, genome, seg_len, facts)` for the
    clusters keyed by `keys` ([B, 2]), batch-minor: CPU keys run the plain
    draws, CUDA keys the kernel (or raise). `now` is an int, or on the
    genome path a [B] int32 tensor of per-row ticks. Returns StepInputs
    (with `facts`, (StepInputs, (crashed [N, B], cut_now [B], cut_prev
    [B]))). `proxy` launches the race proxy's build instead (a check for
    chip_smoke.py, never the main path)."""
    if keys.device.type == "cpu":
        return draw_plain(cfg, keys, now, genome, seg_len, facts)
    if keys.device.type != "cuda":
        raise ValueError(f"draw_cuda: keys on {keys.device}, expected cpu or cuda")
    with torch.cuda.device(keys.device):
        p, ptrs, outs = _prepare(cfg, keys, now, genome, seg_len, facts, None)
        if keys.shape[0]:
            _cuda_launch(p, ptrs, keys.device, proxy)
        return _assemble(outs, facts)


draw_cuda.launches = 0


def draw_span(cfg: T.RaftConfig, keys: torch.Tensor, t0: int, n_ticks: int, genome,
              seg_len: int = 1, facts: bool = False):
    """`faults.draw_span`: ticks t0 .. t0 + n_ticks - 1 of the clusters keyed
    by `keys` under `genome` ([B, S] rows), each leaf [n_ticks, ..., B]
    (tick k's batch-minor inputs are row k). CPU keys run the plain span;
    CUDA keys one kernel launch over its n_ticks x B rows."""
    if keys.device.type == "cpu":
        return _minor(faults.draw_span(cfg, keys, t0, n_ticks, genome, seg_len, facts=facts),
                      facts, 1)
    if keys.device.type != "cuda":
        raise ValueError(f"draw_span: keys on {keys.device}, expected cpu or cuda")
    with torch.cuda.device(keys.device):
        p, ptrs, outs = _prepare(cfg, keys, t0, genome, seg_len, facts, n_ticks)
        if keys.shape[0] and n_ticks:
            _cuda_launch(p, ptrs, keys.device)
        return _assemble(outs, facts)


def draw_host(lib, cfg: T.RaftConfig, keys: torch.Tensor, now, genome=None, seg_len: int = 1,
              facts: bool = False, ticks: int | None = None, reverse: bool = False,
              poison: bool = False):
    """The kernel's body built for the CPU (`load_host`), on CPU tensors: the
    same leaf checks, pointer table and outputs as `draw_cuda` (with `ticks`,
    as `draw_span` from tick `now`), so tests hold the kernel's own logic
    against the plain draws. `reverse` runs each phase's (row, node) workers
    in reverse order; `poison` fills the side-bit staging with the race
    proxy's byte before each tile's stage phase."""
    p, ptrs, outs = _prepare(cfg, keys, now, genome, seg_len, facts, ticks)
    _host_launch(lib, p, ptrs, reverse, poison)
    return _assemble(outs, facts)


def _host_tile_rows(lib, n: int) -> int:
    """Rows a tile (a block on the card) for `n` nodes (csrc/draws.cuh
    `tile_rows`), from a library of the body."""
    return int(lib.rs_draws_tile_rows(n))


def _host_launch(lib, p: DrawParams, ptrs, reverse: bool = False, poison: bool = False) -> None:
    rc = lib.rs_draws_host(ctypes.byref(p), ptrs, int(reverse), int(poison))
    if rc != 0:
        raise RuntimeError(f"draw body refused the parameters (code {rc})")


def time_draws(cfg: T.RaftConfig, keys: torch.Tensor, now: int, genome=None, seg_len: int = 1,
               facts: bool = False, reps: int = 20) -> float:
    """Device milliseconds per draw launch on CUDA `keys`
    (`tick_engine.time_launches`): the leaves are checked and the outputs
    allocated once. Each launch counts."""
    with torch.cuda.device(keys.device):
        p, ptrs, outs = _prepare(cfg, keys, now, genome, seg_len, facts, None)
        return tick_engine.time_launches(lambda: _cuda_launch(p, ptrs, keys.device), reps)


# ---- what the bound is computed from --------------------------------------------


def traffic_bytes(cfg: T.RaftConfig, b: int, genome: bool = False,
                  facts: bool = False) -> tuple[int, int]:
    """(bytes read, bytes written) by one tick's draws for `b` clusters: the
    keys (and on the genome path each cluster's active segment, 6 uint32
    thresholds in int64 and 8 int32 fields) read once, every output leaf
    written once."""
    read = b * (16 + (6 * 8 + 8 * 4 if genome else 0))
    size = lambda shape, dtype: math.prod(shape) * torch.empty((), dtype=dtype).element_size()  # noqa: E731
    written = b * sum(size(*spec) for spec in out_specs(cfg, facts).values())
    return read, written


def threefry_blocks(cfg: T.RaftConfig, b: int, now: int, genome=None, seg_len: int = 1,
                    facts: bool = False) -> int:
    """The threefry blocks one tick's draws need for `b` clusters at tick
    `now` (`genome`: the [B, S] rows, whose thresholds decide which
    mechanisms draw): the key chain, every draw an output reads whatever the
    data (the N^2 drop bits, the N skew, timeout and liveness-selection bits,
    the partition window's activation, the storage draws on their ticks, the
    offers' targets on their ticks), each counted once a cluster. Draws that
    only some data needs -- the side bits of an active partition window, a
    crashed node's start and span, a torn node's span -- are left out, so
    the count is a floor of the work, as a bound wants."""
    n, k = cfg.n_nodes, cfg.client_pipeline
    if genome is None:
        cad = lambda iv: int(iv > 0 and now % iv == 0)  # noqa: E731
        g = {"drop": int(cfg.drop_prob > 0), "part": int(cfg.partition_period > 0),
             "crash": int(cfg.crash_prob > 0), "skew": int(cfg.clock_skew_prob > 0),
             "jit": cad(cfg.fsync_interval) * int(cfg.fsync_jitter_prob > 0),
             "torn": int(cfg.durable_storage and cfg.torn_tail_prob > 0),
             "rcfg": cad(cfg.reconfig_interval) * int(now > 0),
             "xfer": cad(cfg.transfer_interval) * int(now > 0)}
        g = {key: np.full(b, v, dtype=np.int64) for key, v in g.items()}
    else:
        seg = min(max(now // seg_len, 0), genome.drop.shape[-1] - 1)
        gn = {f: np.asarray(getattr(genome, f).cpu())[:, seg].astype(np.int64)
              for f in ScenarioGenome._fields}
        cad = lambda iv: ((iv > 0) & (now % np.maximum(iv, 1) == 0)).astype(np.int64)  # noqa: E731
        g = {"drop": gn["drop"] > 0, "part": (gn["part_period"] > 0) & (gn["part"] > 0),
             "crash": gn["crash"] > 0, "skew": gn["skew"] > 0,
             "jit": cad(gn["fsync_interval"]) * (gn["fsync_jitter"] > 0),
             "torn": gn["torn"] > 0, "rcfg": cad(gn["reconfig_interval"]) * int(now > 0),
             "xfer": cad(gn["transfer_interval"]) * int(now > 0)}
        g = {key: np.asarray(v, dtype=np.int64) for key, v in g.items()}
    uniform = int(genome is None and cfg.drop_prob > 0 and cfg.drop_prob_uniform)
    per = 2 + 1 + 2 + 2 * n  # k_ticks, tkey; k_timeout; the timeout split and its 2N bits
    per = per + g["drop"] * (1 + n * n) + uniform * 2  # k_drop and N^2 bits; k_rate and its bits
    per = per + g["part"] * (1 + 3 * (1 + int(facts)))  # k_part; window key, k_active, its bit
    per = per + g["skew"] * (1 + n)
    windows = 1 if (now < 1 or (now - 1) // cfg.crash_period == now // cfg.crash_period) else 2
    # ckey (and k_part when no partition drew it); a window key, k_sel, N bits a window.
    per = per + g["crash"] * ((1 - g["part"]) + 1 + windows * (2 + n))
    if cfg.client_redirect:
        per = per + 3 + 4 + 2 + 2 * k  # fold 3, its split, the target's randint, the bounces'
    per = per + np.minimum(g["rcfg"] + g["xfer"], 1) + 4 * g["rcfg"] + 4 * g["xfer"]
    per = per + np.minimum(g["jit"] + g["torn"], 1) + g["jit"] * (1 + n) + g["torn"] * (1 + n)
    return int(np.sum(per))


def bound_ms(cfg: T.RaftConfig, b: int, now: int, sm_clock_mhz: float, sms: int = 132,
             genome=None, seg_len: int = 1, facts: bool = False,
             bytes_per_s: float = 3.35e12, block_ops: dict = BLOCK_OPS) -> dict:
    """The least time one tick's draws could take on the card: the larger of
    the threefry blocks' integer instructions (`block_ops` a block) at the
    SMs' rates at `sm_clock_mhz` -- ALU-only ones over the ALU lanes, all of
    them over the issue lanes, whichever is slower -- and the bytes over
    `bytes_per_s`; which bounds it."""
    blocks = threefry_blocks(cfg, b, now, genome, seg_len, facts)
    ops_ms = blocks * block_clocks(block_ops) / (sms * sm_clock_mhz * 1e6) * 1e3
    rd, wr = traffic_bytes(cfg, b, genome is not None, facts)
    bytes_ms = (rd + wr) / bytes_per_s * 1e3
    return {"bound_ms": max(ops_ms, bytes_ms), "bound_by": "operations" if ops_ms >= bytes_ms
            else "bytes", "ops_ms": ops_ms, "bytes_ms": bytes_ms, "threefry_blocks": blocks,
            "int32_ops": blocks * block_ops["total"],
            "alu_only_ops": blocks * block_ops["alu_only"], "bytes_read": rd,
            "bytes_written": wr}


def parse_block_ops(sass: str) -> dict:
    """{"total", "alu_only"} instructions of one drop draw in the draw
    kernels' SASS (`cuobjdump -sass`): in each kernel (draws_kernel, the
    tile, and draws_flat_kernel, the flat grid), the first region that an
    innermost loop branches over and that holds one threefry block (20
    funnel-shift rotates) ending in an unsigned threshold compare; of the
    kernels', the one that takes the fewest clocks (`block_clocks`). Both do
    the same work a draw, so the bound counts what the leaner form needs."""
    found = []
    for fn in sass.split("Function :")[1:]:
        name = fn.split(None, 1)[0] if fn.strip() else ""
        if "draws_kernel" in name or "draws_flat_kernel" in name:
            ops = _drop_draw(fn)
            if ops is not None:
                found.append(ops)
    if not found:
        raise ValueError("no drop draw found in the draw kernels' SASS")
    return min(found, key=lambda o: (block_clocks(o), o["total"]))


def block_clocks(block_ops: dict) -> float:
    """An SM's clocks a threefry block: its ALU-only instructions over the
    ALU lanes or all of them over the issue lanes, whichever is slower."""
    return max(block_ops["alu_only"] / ALU_LANES_PER_SM, block_ops["total"] / ISSUE_LANES_PER_SM)


def _drop_draw(kernel: str) -> dict | None:
    """`parse_block_ops`' count in one function's SASS, or None."""
    ins = [(int(m.group(1), 16), m.group(2).strip())
           for m in re.finditer(r"/\*([0-9a-f]{4,})\*/\s+([^;]*);", kernel)]
    at = {a: i for i, (a, _) in enumerate(ins)}
    target = lambda t: re.search(r"BRA\s+0x([0-9a-f]+)", t)  # noqa: E731
    loops = [(at[int(m.group(1), 16)], i) for i, (a, t) in enumerate(ins)
             if (m := target(t)) and int(m.group(1), 16) <= a]
    for s, e in loops:
        if any(s <= s2 and e2 < e for s2, e2 in loops if (s2, e2) != (s, e)):
            continue  # not innermost
        for j in range(s, e):
            m = re.match(r"@!?P\d BRA\s+0x([0-9a-f]+)", ins[j][1])
            if not m or int(m.group(1), 16) <= ins[j][0]:
                continue
            region = [re.sub(r"^@!?P\w+\s+", "", t).split()[0]
                      for _, t in ins[j + 1:at[int(m.group(1), 16)]]]
            if sum(op.startswith("SHF.L.W") for op in region) == 20 and \
                    region[-1].startswith("ISETP") and ".U32" in region[-1]:
                alu = sum(op.split(".")[0] in ALU_ONLY for op in region)
                return {"total": len(region), "alu_only": alu}
    return None


def sass_block_ops(path: Path | None = None) -> dict:
    """`parse_block_ops` of the built library (`build()`), through the CUDA
    toolkit's cuobjdump."""
    tool = Path(tick_engine._nvcc()).parent / "cuobjdump"
    out = subprocess.run([str(tool), "-sass", str(path or build())], check=True,
                         capture_output=True, text=True)
    return parse_block_ops(out.stdout)

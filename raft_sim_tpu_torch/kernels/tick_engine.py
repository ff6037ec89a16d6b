"""The Hopper tick kernel's wrapper: `step_cuda(cfg, s, inp)`.

The port of raft_sim_tpu/experiments/pallas_engine.py `step_pallas` -- one
whole tick (`step_b` + `_step_info_b`) as one kernel -- minus its `block_b`
and `interpret` arguments: any batch size is taken (the kernel masks the
ragged edge), and there is no interpret mode.

Dispatch is by the device the tensors lie on. CPU tensors go to the plain
PyTorch tick (models/raft_batched.step_b). CUDA tensors go to the kernel
(csrc/tick.cu: one thread per node of a cluster, blocks of `block_shape`
clusters x node slots, over the phase functions of csrc/tick.cuh), or
raise: unsupported gates raise NotImplementedError, a leaf of the wrong device,
dtype, shape or layout raises ValueError, and a refused launch raises
RuntimeError. Nothing falls back.

The compacted carry layout (`compact_planes`, ops/tile.py) never reaches the
launch, as the reference kernel refuses it too: `step_cuda` (and
`step_host`) unpack the state and inputs, launch on the dense view under the
config's dense twin, and repack the result with the gated-off legs of the
input state (plain torch on the card, outside the kernel).

Build: at first use, `nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17
-O3 -Xcompiler -fPIC -c` compiles csrc/tick.cu once per (index dtype tier,
width tier) (-DRS_IDX_BYTES=1, 2, 4 x -DRS_WIDTH=2, 4, 8: nine nvcc processes
started together), and `nvcc -shared` links the objects into one library in
raft_sim_tpu_torch/build/ (ignored by git), named by a hash of the sources;
ctypes loads it. The library has a plain C interface (no PyTorch headers), so
the build takes well under two minutes. `step_cuda.launches` counts kernel
launches (and nothing else).
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import math
import os
import re
import shutil
import subprocess
import time
from pathlib import Path

import torch

from raft_sim_tpu_torch import types as T
from raft_sim_tpu_torch.ops import bitplane, tile
from raft_sim_tpu_torch.models import raft_batched

PKG = Path(__file__).resolve().parent.parent
CSRC = PKG / "csrc"
BUILD_DIR = PKG / "build"
SOURCES = ("tick.cuh", "tick.cu")

# Leaf pointers in the order of csrc/tick.cuh's `Ptr` enum. State and mailbox
# leaves are read and written under the same names.
STATE_IO = (
    "role", "term", "voted_for", "leader_id", "votes", "next_index",
    "match_index", "ack_age", "commit_index", "commit_chk", "log_base",
    "base_term", "base_chk", "log_term", "log_val", "log_tick", "log_len",
    "clock", "deadline", "heard_clock", "client_pend", "client_dst",
    "client_tick", "lat_frontier", "now", "member_old", "member_new",
    "cfg_epoch", "cfg_pend", "log_cfg", "base_mold", "base_pend", "base_epoch",
    "xfer_to", "read_idx", "read_tick", "read_acks", "read_fr", "dur_len",
    "dur_term", "dur_vote",
)
MAILBOX_IO = (
    "req_type", "req_term", "req_commit", "req_last_index", "req_last_term",
    "ent_start", "ent_prev_term", "ent_count", "ent_term", "ent_val",
    "ent_tick", "req_base", "req_base_term", "req_base_chk", "req_off",
    "resp_kind", "pv_grant", "v_to", "a_ok_to", "a_match", "a_hint",
    "resp_term", "xfer_tgt", "req_disrupt", "ent_cfg", "req_base_mold",
    "req_base_pend", "req_base_epoch",
)
INPUTS_IN = (
    "deliver_mask", "skew", "timeout_draw", "client_cmd", "client_target",
    "client_bounce", "alive", "restarted", "reconfig_cmd", "transfer_cmd",
    "read_cmd", "fsync_fire", "torn_drop",
)
INFO_OUT = (
    "viol_election_safety", "viol_commit", "viol_log_matching", "leader",
    "n_leaders", "max_term", "max_commit", "min_commit", "msgs_delivered",
    "cmds_injected", "lat_sum", "lat_cnt", "lat_hist", "lat_excluded",
    "noop_blocked", "reads_served", "read_lat_sum", "read_hist",
    "viol_read_stale", "fsync_lag_sum", "fsync_lag_max", "lm_skipped_pairs",
)
PTR_ORDER = (
    [("state", f) for f in STATE_IO]
    + [("mailbox", f) for f in MAILBOX_IO]
    + [("inputs", f) for f in INPUTS_IN]
    + [("state_out", f) for f in STATE_IO]
    + [("mailbox_out", f) for f in MAILBOX_IO]
    + [("info_out", f) for f in INFO_OUT]
)
# Legs a gate makes live, by name (either direction): with the gate off the
# kernel neither reads nor writes them -- they get a null pointer and pass
# through uncopied.
_rcf = lambda c: c.reconfig  # noqa: E731
_rcf_comp = lambda c: c.reconfig and c.compaction  # noqa: E731
_dur = lambda c: c.durable_storage  # noqa: E731
_GATED = {
    "log_tick": lambda c: c.track_offer_ticks,
    "ent_tick": lambda c: c.track_offer_ticks,
    "base_term": lambda c: c.compaction,
    "req_base": lambda c: c.compaction,
    "req_base_term": lambda c: c.compaction,
    "req_base_chk": lambda c: c.compaction,
    "noop_blocked": lambda c: c.compaction,
    "heard_clock": lambda c: c.pre_vote or c.read_lease or c.reconfig,
    "pv_grant": lambda c: c.pre_vote,
    "client_pend": lambda c: c.client_redirect,
    "client_dst": lambda c: c.client_redirect,
    "client_target": lambda c: c.client_redirect,
    "client_bounce": lambda c: c.client_redirect,
    "client_tick": lambda c: c.client_redirect and c.track_offer_ticks,
    # The reconfiguration plane: membership, transfer, reads, leases.
    "member_old": _rcf,
    "member_new": _rcf,
    "cfg_pend": _rcf,
    "log_cfg": _rcf,
    "ent_cfg": _rcf,
    "reconfig_cmd": _rcf,
    "req_base_mold": _rcf_comp,
    "req_base_pend": _rcf_comp,
    "req_base_epoch": _rcf_comp,
    "xfer_to": lambda c: c.leader_transfer,
    "xfer_tgt": lambda c: c.leader_transfer,
    "transfer_cmd": lambda c: c.leader_transfer,
    "req_disrupt": lambda c: c.leader_transfer and (c.reconfig or c.read_lease),
    "read_idx": lambda c: c.read_index,
    "read_tick": lambda c: c.read_index,
    "read_acks": lambda c: c.read_index,
    "read_cmd": lambda c: c.read_index,
    "reads_served": lambda c: c.read_index,
    "read_lat_sum": lambda c: c.read_index,
    "read_hist": lambda c: c.read_index,
    "read_fr": lambda c: c.read_lease,
    "viol_read_stale": lambda c: c.read_lease,
    # The durable storage plane: watermarks, disk draws, the lag pair.
    "dur_len": _dur,
    "dur_term": _dur,
    "dur_vote": _dur,
    "fsync_fire": _dur,
    "torn_drop": _dur,
    "fsync_lag_sum": _dur,
    "fsync_lag_max": _dur,
    # Ring-form log matching counts the pairs it cannot compare.
    "lm_skipped_pairs": lambda c: c.compaction and c.check_log_matching,
}
# Legs whose read and write sides differ: (read gate, write gate). log_base
# and base_chk are read on every config (a restart resumes commit at the
# snapshot) but written only under compaction; cfg_epoch is only derived
# (read back by the truncation-rollback mutant alone); the snapshot config
# context is read under reconfig (the end-of-tick derivation) but moves only
# under compaction.
_always = lambda c: True  # noqa: E731
_SPLIT = {
    "log_base": (_always, lambda c: c.compaction),
    "base_chk": (_always, lambda c: c.compaction),
    "cfg_epoch": (lambda c: c.reconfig and not c.truncation_rollback, _rcf),
    "base_mold": (_rcf, _rcf_comp),
    "base_pend": (_rcf, _rcf_comp),
    "base_epoch": (_rcf, _rcf_comp),
}


def leg_live(cfg: T.RaftConfig, group: str, name: str) -> bool:
    """Whether the kernel touches leg `name` of `group` under `cfg`."""
    if name in _SPLIT:
        read, write = _SPLIT[name]
        return (write if group.endswith("_out") else read)(cfg)
    gate = _GATED.get(name)
    return gate is None or gate(cfg)


MAX_ENTRIES = 16


class TickParams(ctypes.Structure):
    """csrc/tick.cuh `TickParams`."""

    _fields_ = [
        ("b", ctypes.c_int64),
        ("n", ctypes.c_int32),
        ("e", ctypes.c_int32),
        ("cap", ctypes.c_int32),
        ("w", ctypes.c_int32),
        ("quorum", ctypes.c_int32),
        ("heartbeat", ctypes.c_int32),
        ("ack_sat", ctypes.c_int32),
        ("ack_timeout", ctypes.c_int32),
        ("check_invariants", ctypes.c_int32),
        ("log_matching_due", ctypes.c_int32),
        ("track", ctypes.c_int32),
        ("comp", ctypes.c_int32),
        ("compact_margin", ctypes.c_int32),
        ("pre_vote", ctypes.c_int32),
        ("election_min", ctypes.c_int32),
        ("redirect", ctypes.c_int32),
        ("k", ctypes.c_int32),
        ("reconfig", ctypes.c_int32),
        ("transfer", ctypes.c_int32),
        ("reads", ctypes.c_int32),
        ("lease", ctypes.c_int32),
        ("lease_ticks", ctypes.c_int32),
        ("durable", ctypes.c_int32),
        ("durable_acks", ctypes.c_int32),
        ("joint_consensus", ctypes.c_int32),
        ("act_on_append", ctypes.c_int32),
        ("truncation_rollback", ctypes.c_int32),
        ("read_confirm", ctypes.c_int32),
        ("xfer_election", ctypes.c_int32),
        ("persist_vote", ctypes.c_int32),
    ]


def _source_tag(sources=SOURCES) -> str:
    h = hashlib.sha256()
    for name in sources:
        h.update((CSRC / name).read_bytes())
    return h.hexdigest()[:16]


def _nvcc() -> str:
    for cand in (
        os.environ.get("CUDA_HOME") and os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"),
        shutil.which("nvcc"),
        "/usr/local/cuda/bin/nvcc",
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


BUILD_INFO: dict = {}
PROXY_BUILD_INFO: dict = {}

IDX_TIERS = (1, 2, 4)  # index dtype byte widths
WIDTH_TIERS = (2, 4, 8)  # packed words a row (`width_tier`): one object per (index, width) pair


def build(proxy: bool = False) -> Path:
    """Compile csrc/tick.cu for sm_90a into BUILD_DIR (once per source hash)
    and return the library's path: one nvcc per (index tier, width tier), all
    started together, then one link. BUILD_INFO records the seconds and the
    compiler's register/stack/spill report of the last build. `proxy` builds
    the race proxy instead (-DRS_RACE_PROXY: reversed thread map, poisoned
    exchange; csrc/tick.cu), a library of its own that the main path never
    loads; PROXY_BUILD_INFO records its build."""
    tag = _source_tag()
    name = "libtick_proxy" if proxy else "libtick"
    out = BUILD_DIR / f"{name}_{tag}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc, pid = _nvcc(), os.getpid()
    arch = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-Xcompiler", "-fPIC"]
    defs = ["-DRS_RACE_PROXY"] if proxy else []
    parts = [(k, w) for k in IDX_TIERS for w in WIDTH_TIERS]
    t0 = time.perf_counter()
    objs, procs = [], []
    for k, w in parts:
        obj = BUILD_DIR / f"{name}_i{k}_w{w}_{tag}.{pid}.o"
        cmd = [nvcc, *arch, *defs, "-Xptxas", "-v", "-c", f"-DRS_IDX_BYTES={k}", f"-DRS_WIDTH={w}",
               "-o", str(obj), str(CSRC / "tick.cu")]
        objs.append(obj)
        procs.append(subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    try:
        reports = [proc.communicate()[1] for proc in procs]  # waits for every one
        for part, proc, err in zip(parts, procs, reports):
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc (index, width tier {part}) failed ({proc.returncode}):\n{err[-4000:]}")
        tmp = out.with_suffix(f".{pid}.tmp")
        link = subprocess.run([nvcc, *arch, "-shared", "-o", str(tmp), *map(str, objs)],
                              capture_output=True, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({link.returncode}):\n{link.stderr[-4000:]}")
    finally:
        for obj in objs:
            obj.unlink(missing_ok=True)
    os.replace(tmp, out)
    info = PROXY_BUILD_INFO if proxy else BUILD_INFO
    info.update(seconds=time.perf_counter() - t0, ptxas="".join(reports), path=str(out))
    return out


def ptxas_report(text: str | None = None) -> dict:
    """{mangled kernel name: {"registers", "stack", "spill_stores",
    "spill_loads"}} from nvcc's -Xptxas -v output (the last build's)."""
    text = BUILD_INFO.get("ptxas", "") if text is None else text
    out, name = {}, None
    for ln in text.splitlines():
        m = re.search(r"Function properties for (\S+)", ln)
        if m:
            name = m.group(1)
            out.setdefault(name, {})
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads", ln)
        if m and name:
            out[name].update(stack=int(m[1]), spill_stores=int(m[2]), spill_loads=int(m[3]))
        m = re.search(r"Used (\d+) registers", ln)
        if m and name:
            out[name]["registers"] = int(m[1])
    return out


_ITANIUM = {1: "a", 2: "s", 4: "i"}  # int8_t, int16_t, int32_t in a mangled name
BODIES = ("lean", "full", "mutant")  # csrc/tick.cuh `body_for`


def kernel_report(cfg: T.RaftConfig, s: T.ClusterState, nodes_per_thread: int, lib=None) -> dict:
    """The body a launch on state `s` runs, at `nodes_per_thread` (from
    `launch_shape`): lean, full or mutant, as the library `lib` (default:
    the card's) decides it (csrc/tick.cuh `body_for`), and ptxas's report of
    its instantiation tick_kernel<IdxT, AckT, NodeT, width tier, nodes per
    thread, body>."""
    lib = _load_cuda() if lib is None else lib
    body = int(lib.rs_tick_body(ctypes.byref(_params(cfg, s, False))))
    tag = "tick_kernelI" + "".join(
        _ITANIUM[x.element_size()] for x in (s.next_index, s.ack_age, s.mailbox.v_to)
    ) + f"Li{width_tier(cfg.n_nodes)}ELi{nodes_per_thread}ELi{body}E"
    hits = [v for k, v in ptxas_report().items() if tag in k]
    return dict(hits[0] if hits else {}, instantiation=tag, gate_set=BODIES[body])


_LIBS: dict = {}


@functools.lru_cache(maxsize=8)
def _sm_count(device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _load_cuda(proxy: bool = False):
    """The card's library (`build`), or the race proxy's with `proxy`."""
    if proxy not in _LIBS:
        lib = ctypes.CDLL(str(build(proxy)))
        lib.rs_tick_launch.argtypes = [
            ctypes.POINTER(TickParams), ctypes.POINTER(ctypes.c_void_p),
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_void_p,
        ]
        lib.rs_tick_launch.restype = ctypes.c_int
        lib.rs_tick_smem_bytes.argtypes = [ctypes.c_int, ctypes.c_int]
        lib.rs_tick_smem_bytes.restype = ctypes.c_longlong
        _check_lib(lib)
        _LIBS[proxy] = lib
    return _LIBS[proxy]


def _check_lib(lib) -> None:
    """Declare the entry points the card's library and the host build share,
    and check their pointer table against PTR_ORDER."""
    lib.rs_tick_n_ptr.restype = ctypes.c_int
    lib.rs_tick_lean.argtypes = [ctypes.POINTER(TickParams)]
    lib.rs_tick_lean.restype = ctypes.c_int
    lib.rs_tick_body.argtypes = [ctypes.POINTER(TickParams)]
    lib.rs_tick_body.restype = ctypes.c_int
    if lib.rs_tick_n_ptr() != len(PTR_ORDER):
        raise RuntimeError("csrc/tick.cuh Ptr enum and PTR_ORDER disagree")


@functools.lru_cache(maxsize=64)
def leaf_specs(cfg: T.RaftConfig, b: int) -> dict:
    """{(group, name): (shape, dtype)} of every batch-minor leaf the kernel
    may read, for `b` clusters (`leg_live` says which the config makes live).
    Cached per (config, batch): the boot state it is read from is built on
    the meta device, whose ops run as Python reference code (milliseconds a
    launch under reconfig). Callers only read the dict."""
    boot = T.boot_state(T.compact_twin(cfg, on=False),
                        torch.empty((b, cfg.n_nodes), dtype=torch.int32, device="meta"))
    minor = lambda x: (tuple(x.shape[1:]) + (b,), x.dtype)  # noqa: E731
    specs = {("state", f): minor(getattr(boot, f)) for f in STATE_IO}
    specs.update({("mailbox", f): minor(getattr(boot.mailbox, f)) for f in MAILBOX_IO})
    n, w = cfg.n_nodes, bitplane.n_words(cfg.n_nodes)
    specs.update({
        ("inputs", "deliver_mask"): ((n, w, b), torch.int32),
        ("inputs", "skew"): ((n, b), torch.int32),
        ("inputs", "timeout_draw"): ((n, b), torch.int32),
        ("inputs", "client_cmd"): ((b,), torch.int32),
        ("inputs", "client_target"): ((b,), torch.int32),
        ("inputs", "client_bounce"): ((cfg.client_pipeline, b), torch.int32),
        ("inputs", "alive"): ((n, b), torch.bool),
        ("inputs", "restarted"): ((n, b), torch.bool),
        ("inputs", "reconfig_cmd"): ((b,), torch.int32),
        ("inputs", "transfer_cmd"): ((b,), torch.int32),
        ("inputs", "read_cmd"): ((b,), torch.int32),
        ("inputs", "fsync_fire"): ((n, b), torch.bool),
        ("inputs", "torn_drop"): ((n, b), torch.int32),
    })
    return specs


def _info_spec(name: str, b: int):
    if name.startswith("viol"):
        return (b,), torch.bool
    if name.endswith("_hist"):
        return (T.LAT_HIST_BINS, b), torch.int32
    return (b,), torch.int32


def check_supported(cfg: T.RaftConfig) -> None:
    """Raise NotImplementedError for what the kernel does not take: the
    launch takes the dense layout only (`step_cuda` unpacks compacted
    carries before it)."""
    if cfg.compact_planes:
        raise NotImplementedError("the tick kernel's launch does not take compact_planes "
                                  "(packed legs): launch on the dense view")
    if cfg.max_entries_per_rpc > MAX_ENTRIES:
        raise NotImplementedError(
            f"step_cuda takes max_entries_per_rpc <= {MAX_ENTRIES}, got {cfg.max_entries_per_rpc}"
        )


def _params(cfg: T.RaftConfig, s: T.ClusterState, lm_due: bool) -> TickParams:
    """The kernel's TickParams for state `s`; `lm_due` says whether this tick
    runs the log-matching check."""
    return TickParams(
        b=s.role.shape[-1], n=cfg.n_nodes, e=cfg.max_entries_per_rpc, cap=cfg.log_capacity,
        w=bitplane.n_words(cfg.n_nodes), quorum=cfg.quorum,
        heartbeat=cfg.heartbeat_ticks, ack_sat=cfg.ack_age_sat,
        ack_timeout=cfg.ack_timeout_ticks,
        check_invariants=int(cfg.check_invariants),
        log_matching_due=int(lm_due),
        track=int(cfg.track_offer_ticks),
        comp=int(cfg.compaction), compact_margin=cfg.compact_margin,
        pre_vote=int(cfg.pre_vote), election_min=cfg.election_min_ticks,
        redirect=int(cfg.client_redirect), k=cfg.client_pipeline,
        reconfig=int(cfg.reconfig), transfer=int(cfg.leader_transfer),
        reads=int(cfg.read_index), lease=int(cfg.read_lease),
        lease_ticks=raft_batched.lease_window(cfg),
        durable=int(cfg.durable_storage), durable_acks=int(cfg.durable_acks),
        joint_consensus=int(cfg.joint_consensus), act_on_append=int(cfg.act_on_append),
        truncation_rollback=int(cfg.truncation_rollback), read_confirm=int(cfg.read_confirm),
        xfer_election=int(cfg.xfer_election), persist_vote=int(cfg.persist_vote),
    )


def _prepare(cfg, s, inp, now, device_type):
    """Validate every leaf, allocate the outputs and build the launch
    arguments: (params, ptrs, tiers, outs). `tiers` are the byte widths of the
    index, ack and node dtypes."""
    check_supported(cfg)
    b = s.role.shape[-1]
    groups = {"state": s, "mailbox": s.mailbox, "inputs": inp}
    for (group, name), (shape, dtype) in leaf_specs(cfg, b).items():
        if not leg_live(cfg, group, name):
            continue
        x = getattr(groups[group], name)
        if not isinstance(x, torch.Tensor):
            raise ValueError(f"{group}.{name}: expected a tensor, got {type(x).__name__}")
        if x.device.type != device_type:
            raise ValueError(f"{group}.{name}: on {x.device}, expected {device_type}")
        if x.dtype != dtype or tuple(x.shape) != shape:
            raise ValueError(
                f"{group}.{name}: {tuple(x.shape)} {x.dtype}, expected {shape} {dtype}"
            )
        if not x.is_contiguous():
            raise ValueError(f"{group}.{name}: not contiguous")
        if x.device != s.role.device:
            raise ValueError(f"{group}.{name}: on {x.device}, state on {s.role.device}")
    dev = s.role.device
    outs = {"state_out": {}, "mailbox_out": {}, "info_out": {}}
    ptrs = (ctypes.c_void_p * len(PTR_ORDER))()
    for k, (group, name) in enumerate(PTR_ORDER):
        if not leg_live(cfg, group, name):
            ptrs[k] = None  # gated off: never touched, passed through
            continue
        if group == "state_out":
            src = outs[group][name] = torch.empty_like(getattr(s, name))
        elif group == "mailbox_out":
            src = outs[group][name] = torch.empty_like(getattr(s.mailbox, name))
        elif group == "info_out":
            shape, dtype = _info_spec(name, b)
            src = outs[group][name] = torch.empty(shape, dtype=dtype, device=dev)
        else:
            src = getattr(groups[group], name)
        ptrs[k] = src.data_ptr()
    params = _params(cfg, s, raft_batched.log_matching_due(cfg, s, now))
    tiers = (
        s.next_index.element_size(), s.ack_age.element_size(),
        s.mailbox.v_to.element_size(),
    )
    return params, ptrs, tiers, outs


def _assemble(s, outs):
    """The new state (gated-off legs passed through) and StepInfo (gated-off
    leaves as zeros of the JAX dtype and shape)."""
    b = s.role.shape[-1]
    dev = s.role.device
    new_mb = s.mailbox._replace(**outs["mailbox_out"])
    new_state = s._replace(**outs["state_out"], mailbox=new_mb)
    info = dict(outs["info_out"])
    for f in T.StepInfo._fields:
        if f not in info:
            shape, dtype = _info_spec(f, b)
            info[f] = torch.zeros(shape, dtype=dtype, device=dev)
    return new_state, T.StepInfo(**info)


def width_tier(n: int) -> int:
    """Packed words a row in the body instantiated for `n` nodes
    (csrc/tick.cuh `width_for`): 2 up to 64 nodes, 4 up to 128, else 8."""
    return 2 if n <= 64 else 4 if n <= 128 else 8


@functools.lru_cache(maxsize=64)
def block_shape(n: int, b: int, sms: int) -> tuple[int, int]:
    """(tc, s): a block of `tc` consecutive clusters x `s` node slots for `b`
    clusters of `n` nodes on a card of `sms` SMs. s = n up to 32 nodes, else
    the width tier's 32 x words (32, 64 or 128) with two nodes a thread; tc =
    32 while s <= 16, 16 at s = 32 -- each halved down to 8 while that leaves
    fewer than two blocks per SM -- and 512 / s above (8 or 4): at most 512
    threads a block (csrc/tick.cuh MAX_THREADS), and the exchange of 4 x 255
    nodes fits a block's shared memory where 8 would not."""
    s = n if n <= 32 else 16 * width_tier(n)
    if s > 32:
        return 512 // s, s
    tc = 32 if s <= 16 else 16
    while tc > 8 and -(-b // tc) < 2 * sms:
        tc //= 2
    return tc, s


def launch_shape(cfg: T.RaftConfig, b: int, device=None) -> dict:
    """The block shape, nodes per thread and dynamic shared-memory bytes a
    launch for `b` clusters of `cfg` takes on `device` (a card)."""
    dev = torch.device("cuda", torch.cuda.current_device()) if device is None else torch.device(device)
    tc, s = block_shape(cfg.n_nodes, b, _sm_count(dev))
    smem = int(_load_cuda().rs_tick_smem_bytes(cfg.n_nodes, tc))
    return {"tc": tc, "s": s, "threads": tc * s, "nodes_per_thread": -(-cfg.n_nodes // s),
            "blocks": -(-b // tc), "smem_bytes": smem}


def cache_probes() -> dict:
    """{name: zero-argument int callable}: the kernel path's caches, for the
    chunk timer's recompile watchdog (obs/timer.py). A growth after warmup
    is a new library loaded (`_load_cuda`) or a new launch template worked
    out mid-run (`leaf_specs`, `block_shape`: their lru_cache misses, which
    keep counting once a cache is full). The CPU path runs the plain tick
    and builds nothing, so these stay flat there."""
    return {
        "tick_engine._load_cuda": lambda: len(_LIBS),
        "tick_engine.leaf_specs": lambda: leaf_specs.cache_info().misses,
        "tick_engine.block_shape": lambda: block_shape.cache_info().misses,
    }


def _cuda_launch(params, ptrs, tiers, device, proxy: bool = False) -> None:
    """THE launch site: one tick kernel on the current stream, counted."""
    lib = _load_cuda(proxy)
    stream = torch.cuda.current_stream(device).cuda_stream
    tc, s = block_shape(params.n, params.b, _sm_count(device))
    rc = lib.rs_tick_launch(ctypes.byref(params), ptrs, *tiers, tc, s, ctypes.c_void_p(stream))
    if rc != 0:
        raise RuntimeError(f"tick kernel refused or failed to launch (code {rc})")
    step_cuda.launches += 1


def step_cuda(cfg: T.RaftConfig, s: T.ClusterState, inp: T.StepInputs, now: int | None = None,
              proxy: bool = False):
    """One tick for B clusters, batch-minor. CPU tensors run the plain
    PyTorch tick; CUDA tensors run the Hopper kernel (or raise). `now` is the
    host's copy of the lockstep tick (read back once when not given and the
    log-matching cadence needs it). `proxy` runs the race proxy's build of
    the kernel (`build(proxy=True)`) instead: a check for chip_smoke.py and
    the card tests, never the main path."""
    if s.role.device.type == "cpu":
        return raft_batched.step_b(cfg, s, inp, now)
    if s.role.device.type != "cuda":
        raise ValueError(f"step_cuda: tensors on {s.role.device}, expected cpu or cuda")
    if cfg.compact_planes:
        return tile.through_dense(cfg, s, inp, lambda *a: step_cuda(*a, now=now, proxy=proxy))
    with torch.cuda.device(s.role.device):
        params, ptrs, tiers, outs = _prepare(cfg, s, inp, now, "cuda")
        _cuda_launch(params, ptrs, tiers, s.role.device, proxy)
        return _assemble(s, outs)


step_cuda.launches = 0


def time_kernel(cfg, s, inp, reps: int = 20, now: int | None = None) -> float:
    """Device milliseconds per kernel launch on CUDA state `s` and inputs
    `inp`: the leaves are checked and the outputs allocated once, then `reps`
    launches run back to back between two CUDA events, behind a device-side
    sleep so the host's enqueueing stays off the clock. Each launch counts."""
    with torch.cuda.device(s.role.device):
        params, ptrs, tiers, outs = _prepare(cfg, s, inp, now, "cuda")
        _cuda_launch(params, ptrs, tiers, s.role.device)  # warm-up
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(50_000_000)
        start.record()
        for _ in range(reps):
            _cuda_launch(params, ptrs, tiers, s.role.device)
        end.record()
        torch.cuda.synchronize()
        del outs
        return start.elapsed_time(end) / reps


# csrc/tick_host.cpp's parts: (width tier, node-id bytes) pairs the body is
# instantiated for, one object each.
HOST_PARTS = ((2, 1), (4, 1), (4, 2), (8, 2))


def build_host(out: Path, cxx: str) -> Path:
    """Compile the CPU build of the tick body (csrc/tick_host.cpp) with the
    host C++ compiler `cxx` into the shared library `out`: one object per
    part of HOST_PARTS, the compilers started together, then one link."""
    flags = ["-std=c++17", "-O2", "-Wall", "-Werror", "-fPIC"]
    objs = [out.with_name(f"{out.stem}_w{w}_n{nb}.o") for w, nb in HOST_PARTS]
    procs = [
        subprocess.Popen([cxx, *flags, "-c", f"-DRS_HOST_WIDTH={w}", f"-DRS_HOST_NODE_BYTES={nb}",
                          "-o", str(obj), str(CSRC / "tick_host.cpp")],
                         stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for (w, nb), obj in zip(HOST_PARTS, objs)
    ]
    errs = [proc.communicate()[1] for proc in procs]  # waits for every one
    for part, proc, err in zip(HOST_PARTS, procs, errs):
        if proc.returncode != 0:
            raise RuntimeError(f"{cxx} (part {part}) failed ({proc.returncode}):\n{err[-4000:]}")
    subprocess.run([cxx, "-shared", "-o", str(out), *map(str, objs)], check=True,
                   capture_output=True, text=True)
    return out


def host_library(cxx: str) -> Path:
    """The CPU build of the tick body for the current sources, in BUILD_DIR
    under their hash: built once (`build_host`, under a file lock, so
    processes that ask at once build it once) and reused after."""
    import fcntl

    out = BUILD_DIR / f"libtick_host_{_source_tag(('tick.cuh', 'tick_host.cpp'))}.so"
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / "host_build.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not out.exists():
            tmp = out.with_name(f"{out.stem}.{os.getpid()}.so")
            build_host(tmp, cxx)
            os.replace(tmp, out)
            for obj in BUILD_DIR.glob(f"{tmp.stem}_w*.o"):
                obj.unlink()
    return out


def load_host(path) -> ctypes.CDLL:
    """Load a CPU build of the tick body (`build_host`) for `step_host`."""
    lib = ctypes.CDLL(str(path))
    lib.rs_tick_host.argtypes = [
        ctypes.POINTER(TickParams), ctypes.POINTER(ctypes.c_void_p),
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
    ]
    lib.rs_tick_host.restype = ctypes.c_int
    _check_lib(lib)
    return lib


def step_host(lib, cfg, s, inp, now: int | None = None, reverse: bool = False,
              poison: bool = False):
    """The kernel's phase-structured body, built for the CPU (`load_host`), on
    CPU tensors: the same leaf checks, pointer table and outputs as
    `step_cuda`, so tests hold the kernel's own logic against the plain tick.
    `reverse` runs each phase's (cluster, node) workers in reverse order;
    `poison` overwrites each exchange field after its last reader's phase
    (the race proxy's schedule, csrc/tick.cuh `poison_fields`). A compacted
    carry goes through the same boundary as in `step_cuda`."""
    if cfg.compact_planes:
        return tile.through_dense(cfg, s, inp,
                                  lambda c, d, i: step_host(lib, c, d, i, now, reverse, poison))
    params, ptrs, tiers, outs = _prepare(cfg, s, inp, now, "cpu")
    rc = lib.rs_tick_host(ctypes.byref(params), ptrs, *tiers, int(reverse), int(poison))
    if rc != 0:
        raise RuntimeError(f"tick body refused the shapes or tiers (code {rc})")
    return _assemble(s, outs)


def traffic_bytes(cfg: T.RaftConfig, b: int) -> tuple[int, int]:
    """(bytes read, bytes written) by one tick of the kernel on `b` clusters:
    every live leg it reads once and every live leg it writes once (legs a
    gate leaves untouched pass through and move nothing) -- the memory
    traffic its bound is computed from."""
    size = lambda shape, dtype: math.prod(shape) * torch.empty((), dtype=dtype).element_size()  # noqa: E731
    specs = leaf_specs(cfg, b)
    read = sum(size(*spec) for (group, name), spec in specs.items() if leg_live(cfg, group, name))
    written = sum(
        size(*specs[("state", f)]) for f in STATE_IO if leg_live(cfg, "state_out", f)
    ) + sum(
        size(*specs[("mailbox", f)]) for f in MAILBOX_IO if leg_live(cfg, "mailbox_out", f)
    ) + sum(
        size(*_info_spec(f, b)) for f in INFO_OUT if leg_live(cfg, "info_out", f)
    )
    return read, written

"""Simulator checkpoint and resume (the port of raft_sim_tpu/utils/checkpoint.py).

A checkpoint is the whole simulator: every ClusterState and Mailbox leaf of
the [B, ...]-leading fleet, the per-cluster run keys, the accumulated
RunMetrics (they hold absolute tick numbers, so they must resume with the
state), the seed and the config. Inputs are pure functions of (key, tick),
so nothing else is needed to continue a run bit-exactly.

The file is the JAX package's, format v25: one .npz with the keys
`__version__`, `seed`, `config_json`, `scenario_json`, `state_<field>`,
`mb_<field>`, `metrics_<field>` and `keys`, each leaf with the JAX leaf's
dtype. So the two packages load each other's files. The port's carriers
differ in two places and are converted at the file's edge: the uint32 legs
(`types.u32_leaves(cfg)`, int32 bit patterns here; a compacted carry's packed
legs among them) are written as uint32, and the
keys (int64 [B, 2] words here, utils/threefry.py) as JAX's uint32
`key_data` [B, 2]. `scenario_json` records the nemesis program of a
scenario run (scenario/program.py `to_dict(exact=True)`), `{}` for a plain
run; `load` returns it, so `scenario run --resume` restores the genome path
and a plain `Session.restore` refuses the file.
"""

from __future__ import annotations

import dataclasses
import json

import numpy as np
import torch

from raft_sim_tpu_torch import bridge, types
from raft_sim_tpu_torch.sim.scan import RunMetrics
from raft_sim_tpu_torch.types import ClusterState, Mailbox
from raft_sim_tpu_torch.utils import device as device_mod
from raft_sim_tpu_torch.utils.config import RaftConfig

# The JAX package's format version (its version log names each field change);
# a file of any other version is refused.
FORMAT_VERSION = 25

# Fingerprint of the serialized schema: (version, sha256 of the ordered field
# names and each leaf's rank and public dtype of ClusterState / Mailbox /
# RunMetrics under the analyzer's canonical config). The JAX package pins the
# same pair for the same file format. The analyzer (raft_sim_tpu_torch/
# analysis, rule `checkpoint-version`) recomputes the hash from the live
# NamedTuples and fails when the field set changed without bumping
# FORMAT_VERSION and refreshing this pin. Refresh with:
#     python -c "from raft_sim_tpu_torch.analysis import policy; print(policy.schema_fingerprint())"
_SCHEMA_FINGERPRINT = (25, "541dcec1cfa9709e")


def _check_dtypes(cfg: RaftConfig, state: ClusterState, metrics: RunMetrics, where: str) -> None:
    """Raise TypeError unless every leaf has the dtype the JAX package gives
    it under `cfg` (the port's boot state's, built on the meta device in
    the config's layout) and
    every metric is int32: a JAX load would widen a stray int64 silently."""
    boot = types.boot_state(cfg, torch.empty(state.role.shape, dtype=torch.int32, device="meta"))
    pairs = [(f, getattr(state, f), getattr(boot, f)) for f in ClusterState._fields if f != "mailbox"]
    pairs += [(f"mailbox.{f}", getattr(state.mailbox, f), getattr(boot.mailbox, f))
              for f in Mailbox._fields]
    pairs += [(f"metrics.{f}", v, torch.empty((), dtype=torch.int32)) for f, v in zip(RunMetrics._fields, metrics)]
    for name, got, want in pairs:
        if got.dtype != want.dtype:
            raise TypeError(f"{where}: leaf {name} is {got.dtype}, the format has {want.dtype}")


def _normalize(path: str) -> str:
    """np.savez appends '.npz' to bare paths; normalize so save and load agree."""
    return path if path.endswith(".npz") else path + ".npz"


def save(
    path: str,
    cfg: RaftConfig,
    state: ClusterState,
    keys: torch.Tensor,
    metrics: RunMetrics,
    seed: int = 0,
    scenario: dict | None = None,
) -> str:
    """Write (config, [B, ...] state, [B, 2] run keys, accumulated metrics,
    seed, and the scenario program of a scenario run -- None for a plain
    run); returns the path written (always .npz-suffixed)."""
    path = _normalize(path)
    _check_dtypes(cfg, state, metrics, "checkpoint.save")
    st = bridge.to_numpy(state, types.u32_leaves(cfg))
    arrays = {f"state_{f}": getattr(st, f) for f in ClusterState._fields if f != "mailbox"}
    arrays |= {f"mb_{f}": getattr(st.mailbox, f) for f in Mailbox._fields}
    arrays |= {f"metrics_{f}": v for f, v in zip(RunMetrics._fields, bridge.to_numpy(metrics))}
    arrays["keys"] = keys.detach().cpu().numpy().astype(np.uint32)
    np.savez_compressed(
        path,
        __version__=np.int32(FORMAT_VERSION),
        seed=np.int64(seed),
        config_json=np.bytes_(json.dumps(dataclasses.asdict(cfg)).encode()),
        scenario_json=np.bytes_(json.dumps(scenario or {}).encode()),
        **arrays,
    )
    return path


def load(path: str, device="cuda"):
    """Read a checkpoint onto `device` (the card unless the caller asks for
    the CPU); returns (cfg, state, keys, metrics, seed, scenario), the state
    and metrics [B, ...]-leading in the port's carriers. `scenario` is None
    for a plain run, else the nemesis program the file records."""
    dev = device_mod.resolve(device)
    with np.load(_normalize(path)) as z:
        version = int(z["__version__"])
        if version != FORMAT_VERSION:
            direction = "older" if version < FORMAT_VERSION else "newer"
            raise ValueError(
                f"checkpoint was written as format v{version}, but this build reads "
                f"v{FORMAT_VERSION} (the file is {direction} than the code). Checkpoints "
                "do not migrate: re-generate it from its (seed, config) with this build, "
                f"or load it with the release that wrote v{version}."
            )
        cfg = RaftConfig(**json.loads(bytes(z["config_json"]).decode()))
        leaves = {f: z[f"state_{f}"] for f in ClusterState._fields if f != "mailbox"}
        leaves["mailbox"] = {f: z[f"mb_{f}"] for f in Mailbox._fields}
        state = bridge.to_port(leaves, ClusterState, dev)
        metrics = bridge.to_port({f: z[f"metrics_{f}"] for f in RunMetrics._fields}, RunMetrics, dev)
        keys = torch.from_numpy(z["keys"].astype(np.int64)).to(dev)
        _check_dtypes(cfg, state, metrics, f"checkpoint.load({path!r})")
        seed = int(z["seed"])
        scenario = json.loads(bytes(z["scenario_json"]).decode()) or None
    return cfg, state, keys, metrics, seed, scenario

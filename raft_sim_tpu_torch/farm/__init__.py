"""The fuzzing farm (the port of raft_sim_tpu/farm/): portfolio hunts over one
fleet run a generation, coverage-guided mutation against a farm-wide seen
set, and the self-growing checker-gated safety corpus. farm/core.py is the
loop, farm/portfolio.py the members, farm/corpus.py the freeze policy.
"""

from raft_sim_tpu_torch.farm.core import (  # noqa: F401
    FARM_MANIFEST_SCHEMA,
    FARM_NEGATIVE_SCHEMA,
    FarmResult,
    FarmSpec,
    manifest_hash,
    run_farm,
    validate_farm_dir,
)
from raft_sim_tpu_torch.farm.portfolio import FITNESS, parse_portfolio  # noqa: F401

"""The scenario engine (the port of raft_sim_tpu/scenario): per-cluster fault
genomes, phased nemesis programs, the violation hunt and its shrink to a
repro artifact, over the port's scan and telemetry loops.

  genome.py    ScenarioGenome: per-cluster, per-segment fault parameters as
               tensors, threaded through sim/faults.make_inputs.
  program.py   phased timelines (S segments of seg_len ticks) from JSON.
  search.py    the cross-entropy hunt: one fleet run a generation, fitness
               from the telemetry windows.
  shrink.py    minimizes a hit to an artifact that replays to the same tick;
               replays the artifacts of tests/corpus.
  mutation.py  TEST-ONLY weakened tick variants, the hunt's ground truth.

scenario/ sits above sim/: sim/faults.py takes the genome by its field names
and never imports this package.
"""

from raft_sim_tpu_torch.scenario.genome import ScenarioGenome
from raft_sim_tpu_torch.scenario.program import ScenarioProgram

__all__ = ["ScenarioGenome", "ScenarioProgram"]

"""The fuzzing farm's corpus half (the port of raft_sim_tpu/farm/corpus.py):
dedup signatures, provenance stamps and the six-property checker gate over
tests/corpus. The farm's hunt portfolio is not ported yet."""

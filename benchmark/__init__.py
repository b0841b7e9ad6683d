"""The benchmark of euclider_tpu_torch on one H100: one command runs one
cell once (``python3 -m benchmark.run --workload <name> ...``).  See
README.md beside this file."""

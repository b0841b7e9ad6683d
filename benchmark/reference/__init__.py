"""The benchmark's plain reference: a frozen copy of the port's plain
render (``scene/``, ``ops/``), its camera orbit, and the benchmark's own
row-blocked render and work count on it.  It imports nothing of the
program."""

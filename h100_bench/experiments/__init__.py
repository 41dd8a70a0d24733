"""The program's side of each experiment: how the benchmark builds it,
hands it its inputs and reads its state (one module an experiment, found
by a configuration's ``experiment`` key)."""

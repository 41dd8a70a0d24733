"""Plain float32 PyTorch references of the benchmark's configurations and
of its data feed; they import nothing of the program."""

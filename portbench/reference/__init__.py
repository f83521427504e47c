"""Plain PyTorch and numpy references that decide a run's ``correct``.

They import nothing of the program and take nothing it made: they work
out again, from the inputs the benchmark made, whatever the program
derived from them (topologies, features, packed or rounded weights)."""

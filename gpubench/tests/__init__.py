"""CPU tests of the benchmark; run with `python -m pytest gpubench/tests`."""

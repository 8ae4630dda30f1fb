"""The benchmark of the PyTorch and CUDA port (`ray_tpu_torch`): a harness
driven by data. `BENCHMARK.json` names the cells; each cell's
configuration, traffic mix, limits and per-layer readers are files of
their own here, found by name (`spec.py`). `python3 -m gpubench --help`."""

"""The benchmark harness of moonshine_tpu_torch (the PyTorch/CUDA port).

``benchmark/run.py`` runs one cell of ``BENCHMARK.json`` once and prints
one JSON line.  Everything that belongs to one configuration, traffic mix,
cell or per-layer metric is a file of its own, found by name:

- ``configs/<config>.json``: the model's published sizes;
- ``traffic/<mix>.json``: the mix's parameters, read by the driver it names
  (``portbench/drivers/<driver>.py``);
- ``workloads/<cell>.json``: the cell's configuration, mix, chips,
  precision and correctness limits;
- ``metrics/<metric>.py``: a per-layer metric's reader.
"""

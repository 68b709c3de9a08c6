"""The benchmark of the PyTorch/CUDA port (``repro_torch``) on one H100.

``python3 portbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json``.  Everything that
belongs to one configuration, traffic mix, metric, kernel count or
reference family is a file of its own, found by name:

  configs/<config>.json     the model's sizes, dtype and weight draws
  traffic/<traffic>.json    the mix's loop size, lengths and fail-stop
  limits/<cell>.json        the limits of the output comparison
  metrics/<metric>.py       ``compute(record)`` of one metric
  counts/<name>.py          operations and bytes of a kernel or a model
  reference/<family>.py     plain float32 PyTorch of a model family

No module here imports ``jax`` or the JAX package, and nothing under
``reference/`` imports the port.
"""

"""One module a metric, named as in ``BENCHMARK.json``, each with
``compute(record) -> float | None`` (None: nothing to read in this run;
the metric is then left out of the result).  The record is built by
``harness.record``:

  window_s, setup_s        seconds (the window: whole loops, less
                           the harness's reading of a profile)
  model                    the configuration's model sizes
  flops                    the family's ``counts`` module
  commits                  [{S, n, since_loop_s}] per commit
  loops                    [{n_requests, n_committed, n_duplicates,
                             hung, span_s, worker_busy}]
  groups                   [{rows, S, n, wall_s, prefill_s}] executed
  trace                    the profiled loop (traced runs): kernel_s,
                           busy_s, span_s, device_ops, idle_gaps, groups
"""

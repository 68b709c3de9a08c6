"""Streaming telemetry and spec calibration over the flight recorder.

The flight recorder (``repro_torch.core.trace``) made every run's event stream
available; this package converts that stream into *decisions*:

  * :mod:`repro_torch.obs.metrics` — online estimators (Welford mean/variance,
    P² quantile sketches, EWMA rates) behind a :class:`MetricsHub` that
    every engine ticks through its ``TraceRecorder`` — same
    zero-cost-when-off contract as tracing (``ExecutionSpec.metrics``).
  * :mod:`repro_torch.obs.calibrate` — fit a calibrated ``RunSpec`` back from
    an observed run (measured per-worker speeds, dispatch overhead h,
    inter-chunk latency), with reason-annotated residuals; plus the
    in-loop :class:`SpecCalibrator` the adaptive controller uses when
    ``AdaptiveSpec.calibrate=True`` (EWMA drift detection → forecast
    from measured conditions, not declared ones).
"""

from repro_torch.obs.metrics import (  # noqa: F401
    EWMA, MetricsHub, P2Quantile, Welford, run_telemetry,
)
from repro_torch.obs.calibrate import (  # noqa: F401
    CalibrationResult, Residual, SpecCalibrator, calibrate_trace,
)

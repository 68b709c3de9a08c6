"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates without sparsity, at the 700 W power limit), and the roofline
bound of a launch.  Frozen copies of ``chip_smoke.py``'s ``PEAK_*`` and
``bound_ms``."""

PEAK_FP32 = 67e12           # FP32 outside the tensor cores
PEAK_BF16 = 989e12          # dense tensor-core rate
PEAK_BYTES = 3.35e12        # HBM3


def bound_ms(n_bytes: float, n_ops: float,
             peak: float = PEAK_FP32) -> tuple[float, str]:
    t_bytes = n_bytes / PEAK_BYTES * 1e3
    t_ops = n_ops / peak * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")

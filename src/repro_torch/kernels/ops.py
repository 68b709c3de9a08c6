"""Public kernel wrappers (the API the rest of the port calls)."""

from repro_torch.kernels.dispatch import status as kernel_status  # noqa: F401
from repro_torch.kernels.flash_attention import (  # noqa: F401
    flash_decode, flash_decode_gqa)
from repro_torch.kernels.mandelbrot import mandelbrot  # noqa: F401
from repro_torch.kernels.rwkv6_scan import (  # noqa: F401
    wkv6, wkv6_batched, wkv6_decode)
from repro_torch.kernels.spin_image import spin_image  # noqa: F401

"""Plain PyTorch versions of the kernels, under the names that
``repro.kernels.ref`` uses for its oracles (the parity targets)."""

from repro_torch.kernels.mandelbrot import (  # noqa: F401
    mandelbrot_plain as mandelbrot)
from repro_torch.kernels.spin_image import (  # noqa: F401
    spin_image_plain as spin_image)

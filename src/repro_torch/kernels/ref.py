"""Plain PyTorch versions of the kernels, under the names that
``repro.kernels.ref`` uses for its oracles (the parity targets), and
``wkv6_decode`` / ``wkv6_batched``, which have no oracle there.

``wkv6`` returns y in r's dtype, as the port's ``ops.wkv6`` does; the
reference's ``ref.wkv6`` is the sequential scan and returns float32."""

from repro_torch.kernels.flash_attention import (  # noqa: F401
    flash_attention_plain as attention,
    flash_decode_plain as attention_decode)
from repro_torch.kernels.mandelbrot import (  # noqa: F401
    mandelbrot_plain as mandelbrot)
from repro_torch.kernels.rwkv6_scan import (  # noqa: F401
    wkv6_batched_plain as wkv6_batched,
    wkv6_decode_plain as wkv6_decode,
    wkv6_plain as wkv6)
from repro_torch.kernels.spin_image import (  # noqa: F401
    spin_image_plain as spin_image)

from repro_torch.apps import mandelbrot, psia  # noqa: F401

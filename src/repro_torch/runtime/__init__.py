from repro_torch.runtime.backends import FnBackend  # noqa: F401

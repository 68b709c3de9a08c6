from repro_torch.runtime.backends import FnBackend, ServeBackend  # noqa: F401
from repro_torch.runtime.serve_executor import (  # noqa: F401
    RDLBServeExecutor, Request, ServeStats,
)

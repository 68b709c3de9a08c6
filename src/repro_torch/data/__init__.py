from repro_torch.data.pipeline import (  # noqa: F401
    SyntheticTokens, as_tensors, batch_for_step, chunk_batch,
)

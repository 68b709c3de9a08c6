"""Plain float32 PyTorch of each model family the benchmark serves,
written from the published equations.  Nothing here imports the port,
``jax`` or the JAX package.  Each family module has
``logits(weights, model, seqs, positions, *, precision, device)``."""

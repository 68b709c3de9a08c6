"""Deterministic synthetic data pipeline: a copy of ``repro.data.pipeline``
(numpy only), with :func:`as_tensors` to put a batch on a device.

Every batch row is a pure function of ``(seed, step, global_row_index)`` —
the property the rDLB executor depends on: when a failed/straggling
worker's grad-chunk is RE-EXECUTED on another worker, the replacement
computes on bit-identical data, so duplicate results are interchangeable
and gradient accumulation is exactly-once by construction.

The stream is a fixed-vocabulary Markov-ish mixture (cheap, reproducible,
non-degenerate token statistics) produced with counter-based hashing —
no RNG state is carried, so any (step, row) can be materialized on any
host independently (also what makes elastic re-sharding trivial).

``batch_for_step`` returns numpy arrays, equal to the reference's bit for
bit; :func:`as_tensors` makes tensors of them on an explicit device.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.models.config import ModelConfig


def _hash_u32(x: np.ndarray) -> np.ndarray:
    """xorshift-mult avalanche over uint32 lanes (vectorized, stateless)."""
    with np.errstate(over="ignore"):
        x = np.asarray(x, dtype=np.uint32)
        x = x ^ (x >> np.uint32(16))
        x = (x * np.uint32(0x7feb352d)).astype(np.uint32)
        x = x ^ (x >> np.uint32(15))
        x = (x * np.uint32(0x846ca68b)).astype(np.uint32)
        x = x ^ (x >> np.uint32(16))
    return x


@dataclasses.dataclass(frozen=True)
class SyntheticTokens:
    vocab_size: int
    seq_len: int
    seed: int = 0

    def rows(self, step: int, row_ids: np.ndarray) -> np.ndarray:
        """(len(row_ids), seq_len+1) int32 token stream (+1 for labels)."""
        S = self.seq_len + 1
        pos = np.arange(S, dtype=np.uint32)[None, :]
        base = (np.uint32(self.seed) * np.uint32(2654435761)
                ^ _hash_u32(np.uint32(step) + np.uint32(0x9e3779b9)))
        rid = _hash_u32(row_ids.astype(np.uint32) ^ base)[:, None]
        h = _hash_u32(rid + pos * np.uint32(0x85ebca6b))
        return (h % np.uint32(self.vocab_size)).astype(np.int32)


def batch_for_step(cfg: ModelConfig, step: int, global_batch: int,
                   seq_len: int, *, seed: int = 0,
                   row_offset: int = 0) -> dict:
    """Full global batch (or a slice via row_offset/global_batch), as
    numpy arrays: tokens and labels (B, seq_len) int32."""
    gen = SyntheticTokens(cfg.vocab_size, seq_len, seed)
    rows = gen.rows(step, np.arange(row_offset, row_offset + global_batch))
    out = {
        "tokens": rows[:, :-1],
        "labels": rows[:, 1:],
    }
    if cfg.family == "vlm":
        h = _hash_u32(np.arange(global_batch * cfg.n_patch_tokens
                                * cfg.d_model, dtype=np.uint32)
                      + np.uint32(step))
        out["patches"] = ((h.astype(np.float32) / 2**31) - 1.0).reshape(
            global_batch, cfg.n_patch_tokens, cfg.d_model)
    if cfg.family == "encdec":
        h = _hash_u32(np.arange(global_batch * cfg.encoder_seq
                                * cfg.d_model, dtype=np.uint32)
                      + np.uint32(step * 7 + 3))
        out["frames"] = ((h.astype(np.float32) / 2**31) - 1.0).reshape(
            global_batch, cfg.encoder_seq, cfg.d_model)
    return out


def chunk_batch(batch: dict, start_row: int, n_rows: int) -> dict:
    """Slice a chunk of batch rows (a DLS task) out of the global batch."""
    return {k: v[start_row:start_row + n_rows] for k, v in batch.items()}


def as_tensors(batch: dict, device) -> dict:
    """A batch of numpy arrays or tensors as tensors on ``device``:
    integer arrays (tokens, labels) as int64, the rest as float32."""
    out = {}
    for k, v in batch.items():
        t = torch.as_tensor(v)
        out[k] = (t.float() if t.is_floating_point() else t.long()).to(device)
    return out

"""Architecture registry + the assigned input-shape grid.

10 architectures x 4 shapes = 40 cells.  ``long_500k`` requires
sub-quadratic attention => only rwkv6-1.6b and hymba-1.5b run it.
A copy of ``repro.configs.registry`` with ``smoke_batch`` drawn by
torch.  ``input_specs`` returns tensors on the ``meta`` device (shapes
and dtypes, no memory) where the reference returns ``ShapeDtypeStruct``
stand-ins — consumed by the dry run (``repro_torch.launch.dryrun``).
"""

from __future__ import annotations

import dataclasses
import importlib
from typing import Optional

import torch

from repro_torch.device import resolve
from repro_torch.models.config import ModelConfig

_MODULES = {
    "deepseek-v3-671b": "deepseek_v3_671b",
    "deepseek-v2-lite-16b": "deepseek_v2_lite_16b",
    "deepseek-coder-33b": "deepseek_coder_33b",
    "qwen3-4b": "qwen3_4b",
    "olmo-1b": "olmo_1b",
    "qwen2-72b": "qwen2_72b",
    "paligemma-3b": "paligemma_3b",
    "whisper-tiny": "whisper_tiny",
    "rwkv6-1.6b": "rwkv6_1b6",
    "hymba-1.5b": "hymba_1b5",
}
ARCH_IDS = tuple(_MODULES)


def _module(arch: str):
    if arch not in _MODULES:
        raise ValueError(f"unknown arch {arch!r}; choose from {ARCH_IDS}")
    return importlib.import_module(f"repro_torch.configs.{_MODULES[arch]}")


def get_config(arch: str) -> ModelConfig:
    return _module(arch).CONFIG


def get_smoke(arch: str) -> ModelConfig:
    return _module(arch).SMOKE


# ------------------------------------------------------------------ shapes
@dataclasses.dataclass(frozen=True)
class Shape:
    name: str
    seq_len: int
    global_batch: int
    kind: str            # train | prefill | decode


SHAPES = {
    "train_4k": Shape("train_4k", 4096, 256, "train"),
    "prefill_32k": Shape("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": Shape("decode_32k", 32768, 128, "decode"),
    "long_500k": Shape("long_500k", 524288, 1, "decode"),
}


def applicable_shapes(cfg: ModelConfig) -> list[str]:
    """long_500k only for sub-quadratic archs (others: N/A-by-design)."""
    names = ["train_4k", "prefill_32k", "decode_32k"]
    if cfg.subquadratic:
        names.append("long_500k")
    return names


# ------------------------------------------------------------- modality
def modality_inputs(cfg: ModelConfig, batch: int, *,
                    device="meta") -> dict:
    """Frontend STUBS: precomputed patch / frame embeddings, float32,
    as uninitialised tensors on ``device`` (default ``meta``: shapes and
    dtypes only, no memory)."""
    out = {}
    if cfg.family == "vlm":
        out["patches"] = torch.empty((batch, cfg.n_patch_tokens,
                                      cfg.d_model), device=device)
    if cfg.family == "encdec":
        out["frames"] = torch.empty((batch, cfg.encoder_seq, cfg.d_model),
                                    device=device)
    return out


def smoke_batch(cfg: ModelConfig, generator: Optional[torch.Generator] = None,
                batch: int = 2, seq: int = 16, *, device=None) -> dict:
    """Concrete tiny batch for the per-arch smoke tests: tokens and their
    next-token labels, plus standard-normal patches (vlm) or frames
    (encdec), drawn from ``generator`` (one seeded with 0 when None) on
    ``device`` (None: the card)."""
    dev = resolve(device)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    tokens = torch.randint(0, cfg.vocab_size, (batch, seq + 1),
                           generator=generator, device=dev)
    out = {"tokens": tokens[:, :-1], "labels": tokens[:, 1:]}
    for key, t in modality_inputs(cfg, batch).items():
        out[key] = torch.randn(t.shape, generator=generator, device=dev)
    return out


# ------------------------------------------------------------- input specs
def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def input_specs(cfg: ModelConfig, shape: Shape, model=None) -> dict:
    """``meta`` stand-ins for every input of the step: tokens (and labels
    to train), the modality stubs, and to decode one new token against
    a cache of ``seq_len`` entries built by ``model.init_cache`` on
    ``meta`` (the reference's ``jax.eval_shape``), with its position."""
    B, S = shape.global_batch, shape.seq_len
    if shape.kind == "train":
        specs = {"tokens": _meta((B, S), torch.int32),
                 "labels": _meta((B, S), torch.int32)}
        specs.update(modality_inputs(cfg, B))
        return specs
    if shape.kind == "prefill":
        specs = {"tokens": _meta((B, S), torch.int32)}
        specs.update(modality_inputs(cfg, B))
        return specs
    if model is None:
        from repro_torch.models import build_model
        model = build_model(cfg)
    return {"cache": model.init_cache(B, S, device="meta"),
            "tokens": _meta((B, 1), torch.int32),
            "pos": _meta((), torch.int32)}


# --------------------------------------------------------- train settings
_TRAIN = {
    # arch: (num_microbatches for train_4k, optimizer)
    "deepseek-v3-671b": (32, "adafactor"),
    "deepseek-v2-lite-16b": (16, "adafactor"),
    "deepseek-coder-33b": (8, "adafactor"),
    "qwen3-4b": (4, "adamw"),
    "olmo-1b": (2, "adamw"),
    "qwen2-72b": (8, "adafactor"),
    "paligemma-3b": (4, "adamw"),
    "whisper-tiny": (1, "adamw"),
    "rwkv6-1.6b": (4, "adamw"),
    "hymba-1.5b": (4, "adamw"),
}


def train_config(arch: str) -> dict:
    ub, opt = _TRAIN[arch]
    return {"num_microbatches": ub, "optimizer": opt}

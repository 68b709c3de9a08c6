"""Unified model configuration covering all 10 assigned architectures.

A jax-free copy of ``repro.models.config.ModelConfig``: the same fields
with the same defaults.  ``param_dtype`` is a torch dtype, and
:meth:`ModelConfig.from_reference` builds one from any object (or dict)
carrying those fields, e.g. the reference config itself.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Mapping, Optional

import torch

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def _rope_scaling(v) -> tuple:
    """A ``rope_scaling`` value as sorted (key, value) pairs: a mapping
    (the published dict) or pairs already; None or empty -> ()."""
    if not v:
        return ()
    items = dict(v.items() if isinstance(v, Mapping) else v)
    kind = items.pop("type", "yarn")
    if kind != "yarn":
        raise ValueError(f"rope_scaling type {kind!r}: only yarn is ported")
    return tuple(sorted((k, float(x)) for k, x in items.items()))


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str = "model"
    family: str = "dense"          # dense | moe | vlm | encdec | rwkv | hybrid
    n_layers: int = 2
    d_model: int = 128
    n_heads: int = 2
    n_kv_heads: int = 2
    d_head: Optional[int] = None   # default d_model // n_heads
    d_ff: int = 512
    vocab_size: int = 1024
    norm: str = "rmsnorm"          # rmsnorm | layernorm | nonparam_ln
    act: str = "silu"              # silu (swiglu) | gelu (geglu) | gelu_mlp
    qkv_bias: bool = False         # qwen2
    qk_norm: bool = False          # qwen3
    rope_theta: float = 10000.0
    # port-only: YaRN's rope scaling as (key, value) pairs of the published
    # ``rope_scaling`` dict ("factor", "original_max_position_embeddings",
    # "beta_fast", "beta_slow", "mscale", "mscale_all_dim"); () = plain RoPE
    rope_scaling: tuple = ()
    tie_embeddings: bool = False
    max_seq_len: int = 8192

    # --- MoE (deepseek family) ---
    moe: bool = False
    n_routed_experts: int = 0
    n_shared_experts: int = 0
    top_k: int = 0
    d_expert: int = 0              # per-expert FFN hidden
    n_dense_layers: int = 0        # leading dense layers (deepseek-v3: 3)
    capacity_factor: float = 1.25
    router_aux_coef: float = 0.001
    # port-only, off by default (the reference has no such fields): the
    # published DeepSeek routing.  ``moe_dropless`` routes every token to
    # its top-k experts with no capacity and weights each routed row by
    # its own gate (``models.moe``); ``norm_topk_prob`` renormalises the
    # top-k gates to sum to 1 (the GShard path always does);
    # ``routed_scaling_factor`` multiplies the routed experts' gates.
    moe_dropless: bool = False
    norm_topk_prob: bool = True
    routed_scaling_factor: float = 1.0

    # --- MLA (deepseek family) ---
    mla: bool = False
    kv_lora_rank: int = 0
    q_lora_rank: int = 0           # 0 = no q compression (v2-lite)
    rope_head_dim: int = 64
    v_head_dim: int = 128
    nope_head_dim: int = 128

    # --- MTP (deepseek-v3) ---
    mtp: bool = False
    mtp_loss_coef: float = 0.3

    # --- sliding window / hybrid ---
    sliding_window: int = 0        # 0 = full attention
    global_layers: tuple = ()      # layer indices with full attention (hymba)
    n_meta_tokens: int = 0         # hymba learnable prefix

    # --- SSM (hymba mamba heads / rwkv) ---
    ssm_state: int = 0
    ssm_conv: int = 4
    ssm_expand: float = 2.0
    rwkv_head_dim: int = 64

    # --- enc-dec (whisper) ---
    encoder_layers: int = 0
    encoder_seq: int = 0           # precomputed-frame stub length
    encoder_d_model: int = 0

    # --- vlm (paligemma) ---
    n_patch_tokens: int = 0        # precomputed patch-embedding stub length

    dtype: str = "bfloat16"
    remat_policy: str = "nothing_saveable"
    scan_layers: bool = True
    fsdp: bool = False             # shard params over the data axis (ZeRO-3)
    logit_softcap: float = 0.0

    # --- performance knobs (defaults = baseline) ---
    # The port calls its kernels whenever the tensors lie on the card and
    # their plain versions on the CPU, whatever this flag says: it is kept
    # only so that a config converts to and from the reference unchanged.
    use_kernel: bool = False
    flash_threshold: int = 8192    # min seq len for chunked online-softmax
    flash_causal_skip: bool = False  # triangle schedule (skip future chunks)
    attn_scores_bf16: bool = False   # bf16 S^2 tensors (fp32 row-max shift)
    parallelism: str = "tp"        # "tp" | "dp" (sharding; no effect here)
    moe_group_size: int = 512      # MoE dispatch token-group size

    @property
    def head_dim(self) -> int:
        return self.d_head if self.d_head else self.d_model // self.n_heads

    @property
    def yarn(self) -> Optional[dict]:
        """The YaRN settings as a dict, or None for plain RoPE."""
        return dict(self.rope_scaling) if self.rope_scaling else None

    @property
    def param_dtype(self) -> torch.dtype:
        return _DTYPES[self.dtype]

    @property
    def attention_free(self) -> bool:
        return self.family == "rwkv"

    @property
    def subquadratic(self) -> bool:
        """True when long-context decode (500k) is feasible by design."""
        return self.family in ("rwkv", "hybrid")

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    @classmethod
    def from_reference(cls, obj: Any) -> "ModelConfig":
        """A config with the fields of ``obj``: any object carrying them
        as attributes (the reference ``ModelConfig``) or a mapping such as
        ``dataclasses.asdict`` of one.  Fields ``obj`` lacks keep their
        defaults; ``global_layers`` comes back as a tuple, and a
        ``rope_scaling`` mapping as its sorted (key, value) pairs (its
        ``"type"``, "yarn", left out: YaRN is the one scaling taken)."""
        get = (obj.get if isinstance(obj, Mapping)
               else lambda k, d: getattr(obj, k, d))
        missing = object()
        kw = {}
        for f in dataclasses.fields(cls):
            v = get(f.name, missing)
            if v is missing:
                continue
            if f.name == "global_layers":
                v = tuple(v)
            elif f.name == "rope_scaling":
                v = _rope_scaling(v)
            kw[f.name] = v
        return cls(**kw)

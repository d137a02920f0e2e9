"""Architecture config schema + the assigned input-shape sets (port of
``repro/configs/base.py``).

Every assigned architecture is a frozen ``ArchConfig``; reduced smoke
variants are derived with ``cfg.reduced()``. The schema is ``repro``'s,
field for field, so the ten configs copy as data; the port runs every
family (``models/api.py::Model``) and reads no training or compile field
(``remat``, ``scan_layers``, ``scan_unroll``). Its
``attention_impl`` tokens are ``"auto" | "cuda" | "torch"``
(``kernels/ops.py``): ``"auto"`` launches the flash-attention kernel on a
CUDA tensor and runs the plain version on a CPU tensor.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Mapping

__all__ = ["ArchConfig", "SHAPES", "ShapeSpec"]


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


SHAPES: Mapping[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524288, 1, "decode"),
}


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                 # dense | moe | ssm | hybrid | encdec
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0            # 0 -> d_model // n_heads
    # --- MoE ---
    n_experts: int = 0
    expert_top_k: int = 0
    moe_capacity_factor: float = 1.25
    # --- attention details ---
    qk_norm: bool = False
    attn_softcap: float | None = None
    logit_softcap: float | None = None
    local_window: int | None = None      # sliding window size
    layer_pattern: str = "global"        # global | local_global | ssm |
                                         # xlstm | hybrid_shared_attn
    shared_attn_period: int = 0          # zamba2: shared block every N
    sandwich_norm: bool = False          # gemma2 pre+post norms
    mlp_kind: str = "swiglu"             # swiglu | gelu
    rope_theta: float = 10000.0
    # --- SSM (mamba2) ---
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_chunk: int = 256
    # --- xLSTM ---
    slstm_layers: tuple = ()             # indices using sLSTM blocks
    # --- enc-dec ---
    enc_layers: int = 0                  # seamless: encoder depth
    # --- numerics / system ---
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    tie_embeddings: bool = True
    remat: str = "full"                  # none | full | dots
    attention_impl: str = "auto"         # auto | cuda | torch
    scan_layers: bool = True
    scan_unroll: bool = False            # dry-run cost pass: unroll scans so
                                         # HLO cost analysis counts every
                                         # iteration (see launch/dryrun.py)
    # --- modality stub ---
    input_kind: str = "tokens"           # tokens | frames (audio stub)
    # --- scope notes ---
    subquadratic: bool = False           # eligible for long_500k

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def padded_vocab(self) -> int:
        return int(math.ceil(self.vocab / 2048) * 2048)

    def reduced(self, **over) -> "ArchConfig":
        """Tiny same-family variant for CPU smoke tests."""
        kw = dict(
            n_layers=(4 if self.layer_pattern == "xlstm" else
                      min(self.n_layers, 2 if not self.shared_attn_period
                          else self.shared_attn_period + 1)),
            d_model=64,
            n_heads=4,
            n_kv_heads=min(self.n_kv_heads, 4) if self.n_kv_heads > 1 else 1,
            d_ff=128 if self.d_ff else 0,
            vocab=256,
            head_dim=16,
            n_experts=min(self.n_experts, 4),
            expert_top_k=min(self.expert_top_k, 2),
            ssm_state=min(self.ssm_state, 16) if self.ssm_state else 0,
            ssm_head_dim=16 if self.ssm_state else 64,
            ssm_chunk=16,
            local_window=16 if self.local_window else None,
            enc_layers=min(self.enc_layers, 2),
            slstm_layers=((3,) if self.layer_pattern == "xlstm"
                          else ()),
            param_dtype="float32",
            compute_dtype="float32",
            remat="none",
            scan_layers=self.scan_layers,
        )
        kw.update(over)
        return dataclasses.replace(self, **kw)

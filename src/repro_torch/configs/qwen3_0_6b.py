"""qwen3-0.6b [dense]: 28L d1024 16H (kv=8) d_ff=3072, vocab 151936,
qk-norm. [hf:Qwen/Qwen3-8B family]"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="qwen3-0.6b",
    family="dense",
    n_layers=28,
    d_model=1024,
    n_heads=16,
    n_kv_heads=8,
    d_ff=3072,
    vocab=151936,
    head_dim=128,
    qk_norm=True,
    rope_theta=1e6,
    mlp_kind="swiglu",
)

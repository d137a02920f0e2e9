"""granite-moe-1b-a400m [moe]: 24L d1024 16H (kv=8) d_ff=512/expert,
vocab 49155, 32 experts top-8. [hf:ibm-granite/granite-3.0-1b-a400m-base]"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="granite-moe-1b-a400m",
    family="moe",
    n_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=8,
    d_ff=512,
    vocab=49155,
    n_experts=32,
    expert_top_k=8,
    mlp_kind="swiglu",
)

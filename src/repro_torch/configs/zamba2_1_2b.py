"""zamba2-1.2b [hybrid]: 38L d2048, Mamba2 blocks (state=64) + one SHARED
attention block (32H, MHA) applied every 6 layers. [arXiv:2411.15242]"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="zamba2-1.2b",
    family="hybrid",
    n_layers=38,
    d_model=2048,
    n_heads=32,
    n_kv_heads=32,
    d_ff=8192,
    vocab=32000,
    layer_pattern="hybrid_shared_attn",
    shared_attn_period=6,
    ssm_state=64,
    ssm_head_dim=64,
    ssm_expand=2,
    mlp_kind="swiglu",
    subquadratic=True,
)

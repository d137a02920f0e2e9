"""gemma2-9b [dense]: 42L d3584 16H (kv=8) d_ff=14336, vocab 256000.
local(4096)/global alternating, attn+logit softcaps, sandwich norms.
[arXiv:2408.00118]"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="gemma2-9b",
    family="dense",
    n_layers=42,
    d_model=3584,
    n_heads=16,
    n_kv_heads=8,
    d_ff=14336,
    vocab=256000,
    head_dim=256,
    layer_pattern="local_global",
    local_window=4096,
    attn_softcap=50.0,
    logit_softcap=30.0,
    sandwich_norm=True,
    mlp_kind="swiglu",
)

"""chameleon-34b [vlm]: 48L d8192 64H (kv=8) d_ff=22016, vocab 65536.
Early fusion: VQ image tokens are ordinary vocab entries, so the frontend
stub is the identity on token ids. [arXiv:2405.09818]"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="chameleon-34b",
    family="dense",
    n_layers=48,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=22016,
    vocab=65536,
    qk_norm=True,  # chameleon uses qk-norm for stability
    mlp_kind="swiglu",
    tie_embeddings=False,
)

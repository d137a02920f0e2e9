"""seamless-m4t-large-v2 [audio]: enc-dec, 24L (24 enc + 24 dec) d1024 16H
(kv=16) d_ff=8192, vocab 256206. Modality frontend is a STUB: the encoder
consumes precomputed frame embeddings. [arXiv:2308.11596]"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="seamless-m4t-large-v2",
    family="encdec",
    n_layers=24,
    enc_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    d_ff=8192,
    vocab=256206,
    mlp_kind="gelu",
    input_kind="frames",
)

"""xlstm-125m [ssm]: 12L d768 4H, vocab 50304; sLSTM + mLSTM blocks
(sLSTM at 1/4 positions), no separate FFN (d_ff=0). [arXiv:2405.04517]"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="xlstm-125m",
    family="ssm",
    n_layers=12,
    d_model=768,
    n_heads=4,
    n_kv_heads=4,
    d_ff=0,
    vocab=50304,
    layer_pattern="xlstm",
    slstm_layers=(3, 7, 11),
    scan_layers=False,
    subquadratic=True,
)

"""zamba2-7b [hybrid] — Mamba2 backbone + shared attention blocks.

[arXiv:2411.15242; unverified]
81L d_model=3584 32H (MHA kv=32) d_ff=14336 vocab=32000, ssm_state=64
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(
    ModelConfig(
        name="zamba2-7b",
        family="hybrid",
        num_layers=81,
        d_model=3584,
        num_heads=32,
        num_kv_heads=32,
        head_dim=112,
        d_ff=14336,
        vocab_size=32000,
        ssm_state=64,
        ssm_head_dim=64,
        ssm_expand=2,
        attn_every=6,  # shared transformer block applied every 6 mamba layers
        tie_embeddings=True,
        act="swiglu",
    )
)

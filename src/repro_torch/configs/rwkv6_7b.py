"""rwkv6-7b [ssm] — Finch, data-dependent decay. [arXiv:2404.05892; hf]

32L d_model=4096 (attn-free) d_ff=14336 vocab=65536
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(
    ModelConfig(
        name="rwkv6-7b",
        family="ssm",
        num_layers=32,
        d_model=4096,
        num_heads=64,      # rwkv heads = d_model / rwkv_head_dim
        num_kv_heads=64,
        head_dim=64,
        d_ff=14336,
        vocab_size=65536,
        rwkv_head_dim=64,
        rope=False,
        tie_embeddings=False,
        act="sq_relu",     # rwkv channel-mix uses squared relu
        act_shard="seq",   # chunk-scan-local residuals (see §Perf cell 2)
    )
)

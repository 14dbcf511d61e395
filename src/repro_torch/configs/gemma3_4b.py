"""gemma3-4b [dense] — 5:1 local:global sliding window, 128k context.

[hf:google/gemma-3-1b-pt; unverified]
34L d_model=2560 8H (GQA kv=4) d_ff=10240 vocab=262144
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(
    ModelConfig(
        name="gemma3-4b",
        family="dense",
        num_layers=34,
        d_model=2560,
        num_heads=8,
        num_kv_heads=4,
        head_dim=256,
        d_ff=10240,
        vocab_size=262144,
        sliding_window=1024,
        global_layer_every=6,  # 5 local : 1 global
        qk_norm=True,
        tie_embeddings=True,
        act="gelu",
        rope_theta=1_000_000.0,
    )
)

"""llava-next-34b [vlm] — anyres tiling; backbone only, patch embeds stubbed.

[hf:llava-hf/llava-v1.6-mistral-7b-hf; unverified]
60L d_model=7168 56H (GQA kv=8) d_ff=20480 vocab=64000
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(
    ModelConfig(
        name="llava-next-34b",
        family="vlm",
        num_layers=60,
        d_model=7168,
        num_heads=56,
        num_kv_heads=8,
        head_dim=128,
        d_ff=20480,
        vocab_size=64000,
        frontend="vision",
        num_patches=1024,  # anyres: base tile + 4 sub-tiles of pooled patches
        tie_embeddings=False,
        act="swiglu",
        rope_theta=5_000_000.0,
    )
)

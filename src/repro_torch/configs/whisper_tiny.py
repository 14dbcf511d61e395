"""whisper-tiny [audio] — enc-dec, conv frontend stubbed. [arXiv:2212.04356; unverified]

4L d_model=384 6H (MHA kv=6) d_ff=1536 vocab=51865
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(
    ModelConfig(
        name="whisper-tiny",
        family="encdec",
        num_layers=4,             # decoder layers
        num_encoder_layers=4,
        d_model=384,
        num_heads=6,
        num_kv_heads=6,
        head_dim=64,
        d_ff=1536,
        vocab_size=51865,         # padded to vocab_pad_multiple for TP
        frontend="audio",
        rope=False,               # learned positions
        max_positions=36864,      # covers decode_32k cache + sampling margin
        norm="layernorm",
        act="gelu",
        tie_embeddings=True,
    )
)

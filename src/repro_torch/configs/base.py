"""Configuration system: model configs, input shapes, and the arch registry.

A copy of the reference's ``repro/configs/base.py``: every field and
value is the same, so a reference config carries across as
``dataclasses.asdict``.  In the port, ``attn_impl="pallas"`` selects the
hand-written CUDA flash-attention kernel (``repro_torch.kernels``) and
``param_count`` counts the port's own parameters.

Every assigned architecture provides a full-size config (exercised only through
the abstract dry-run) and a reduced ``smoke`` config (instantiated on CPU in
tests).  Configs are frozen dataclasses so they hash and are safe as jit static
arguments.
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass, field
from typing import Optional, Tuple

# ---------------------------------------------------------------------------
# Model configuration
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | encdec | vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0  # 0 -> d_model // num_heads

    # --- MoE ---
    num_experts: int = 0
    experts_per_token: int = 0
    moe_capacity_factor: float = 1.25

    # --- SSM (Mamba2) ---
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_conv_width: int = 4
    # hybrid: apply the shared attention block before mamba layer i when
    # i % attn_every == 0 (Zamba2-style shared transformer block)
    attn_every: int = 0

    # --- RWKV ---
    rwkv_head_dim: int = 64

    # --- attention pattern ---
    sliding_window: int = 0          # 0 -> full attention
    global_layer_every: int = 0      # gemma3: every k-th layer is global
    qkv_bias: bool = False
    qk_norm: bool = False
    causal: bool = True
    rope: bool = True
    rope_theta: float = 10_000.0

    # --- MLP ---
    act: str = "swiglu"  # swiglu | sq_relu | gelu

    # --- encoder-decoder ---
    num_encoder_layers: int = 0      # >0 -> encoder-decoder (whisper)
    max_positions: int = 0           # learned-position table size (rope=False)

    # --- modality frontend (stubbed: embeddings come in via input_specs) ---
    frontend: str = "none"           # none | vision | audio
    num_patches: int = 0             # vlm: patch-embed prefix length

    # --- embeddings ---
    tie_embeddings: bool = True
    vocab_pad_multiple: int = 128

    # --- norm ---
    norm: str = "rmsnorm"            # rmsnorm | layernorm

    # --- numerics / scan ---
    dtype: str = "bfloat16"
    param_dtype: str = "float32"
    remat: bool = True
    scan_layers: bool = True
    attn_chunk_q: int = 512          # chunked (flash-style) attention block sizes
    attn_chunk_kv: int = 1024
    attn_direct_max_seq: int = 2048  # below this, use direct attention
    ssm_chunk: int = 128             # mamba2 / rwkv6 chunk length
    # attention implementation for S>1 self-attention:
    #   'jax'    — pure-JAX chunked online-softmax (differentiable default)
    #   'pallas' — VMEM-tiled flash kernel (TPU; interpret-mode on CPU);
    #              in the port, the CUDA flash kernel (plain version on CPU)
    #   'stub'   — HBM-contract stand-in (reads q/k/v, writes o) used by
    #              the dry-run to measure the Pallas kernel's memory term
    attn_impl: str = "jax"
    # remat policy for the scanned layer body (perf lever, §Perf):
    #   'full'      — checkpoint everything (baseline; bwd re-runs the
    #                 whole layer INCLUDING its TP all-reduces)
    #   'save_coll' — save the post-collective activations (attn/moe/mlp
    #                 block outputs): bwd recompute stops at them, so the
    #                 forward TP all-reduces are not replayed
    #   'none'      — no remat (peak activation memory, fewest FLOPs)
    remat_policy: str = "full"
    # MoE dispatch: 'global' scatters every token into ONE (E, C, D)
    # buffer sharded only over experts — each device computes the FULL
    # global capacity (DP-redundant).  'dp' additionally shards the
    # capacity dim over the data axis so expert GEMMs scale with DP.
    moe_dispatch: str = "global"
    # residual-stream activation sharding between blocks:
    #   'seq'    — (batch, SEQUENCE over model, d_model) — fine for
    #              attention stacks, but time-RECURRENT stacks (SSM/RWKV
    #              chunk scans) then all-gather the stream every chunk
    #   'dmodel' — (batch, seq, D_MODEL over model) — aligns with the
    #              head/channel sharding recurrent blocks use internally
    #   'batch'  — batch only; XLA propagates TP inside the block (best
    #              for chunked-attention stacks, measured in §Perf)
    act_shard: str = "batch"
    # recurrent-core implementation (mamba2 SSD / rwkv6 WKV):
    #   'jax'    — chunked scan (differentiable default)
    #   'pallas' — VMEM-tiled SSD kernel (mamba2; oracle-recompute bwd)
    #   'stub'   — VMEM-kernel HBM contract (reads the projected inputs,
    #              writes y + final state) for dry-run bound measurement
    ssm_impl: str = "jax"

    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim", self.d_model // self.num_heads)

    # -- derived ----------------------------------------------------------
    @property
    def padded_vocab(self) -> int:
        m = self.vocab_pad_multiple
        return ((self.vocab_size + m - 1) // m) * m

    @property
    def is_encdec(self) -> bool:
        return self.num_encoder_layers > 0

    @property
    def is_attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def sub_quadratic(self) -> bool:
        """True if a 500k-token decode is feasible (bounded KV memory)."""
        if self.family in ("ssm", "hybrid"):
            return True
        # local:global sliding window keeps most layers' KV bounded
        return self.sliding_window > 0 and self.global_layer_every > 0

    @property
    def d_inner(self) -> int:  # mamba2 inner width
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    @property
    def rwkv_heads(self) -> int:
        return self.d_model // self.rwkv_head_dim

    def param_count(self) -> int:
        """Analytic parameter count (used for MODEL_FLOPS = 6*N*D)."""
        from repro_torch.models import model as _m
        return _m.count_params(self)

    def active_param_count(self) -> int:
        """Active params per token (MoE: only routed experts count)."""
        from repro_torch.models import model as _m
        return _m.count_params(self, active_only=True)

    # -- traffic sizing (scenario synthesis) ------------------------------
    def layer_param_count(self) -> int:
        """Analytic parameter count of ONE decoder block.

        Used by ``repro.scenarios.ml`` to size gradient/activation
        collectives without instantiating the model; approximate for
        hybrid families (recurrent core only), which is fine for traffic
        synthesis — payload sizes, not training math.
        """
        d, ff = self.d_model, self.d_ff
        if self.family in ("ssm", "hybrid"):
            core = 3 * d * self.d_inner + self.d_inner * d
        else:
            core = (d * self.num_heads * self.head_dim
                    + 2 * d * self.num_kv_heads * self.head_dim
                    + self.num_heads * self.head_dim * d)
        if self.num_experts:
            mlp = d * self.num_experts + 3 * d * ff * self.num_experts
        else:
            mlp = (3 if self.act == "swiglu" else 2) * d * ff
        return core + mlp

    def embed_param_count(self) -> int:
        """Embedding-table parameters (padded vocab), for weight
        distribution / setup traffic."""
        return self.padded_vocab * self.d_model

    def smoke(self) -> "ModelConfig":
        """A reduced config of the same family for CPU smoke tests."""
        kw = dict(
            name=self.name + "-smoke",
            num_layers=min(self.num_layers, 3),
            d_model=64,
            num_heads=4,
            num_kv_heads=min(self.num_kv_heads, 2)
            if self.num_kv_heads < self.num_heads
            else 4,
            head_dim=16,
            d_ff=128,
            vocab_size=256,
            vocab_pad_multiple=8,
            num_patches=8 if self.frontend == "vision" else 0,
            num_encoder_layers=2 if self.is_encdec else 0,
            max_positions=128 if self.max_positions else 0,
            sliding_window=16 if self.sliding_window else 0,
            global_layer_every=self.global_layer_every and 2,
            num_experts=min(self.num_experts, 4),
            experts_per_token=min(self.experts_per_token, 2),
            ssm_state=16 if self.ssm_state else 0,
            ssm_head_dim=16,
            rwkv_head_dim=16,
            attn_every=2 if self.attn_every else 0,
            ssm_chunk=8,
            attn_chunk_q=8,
            attn_chunk_kv=8,
            attn_direct_max_seq=32,
            dtype="float32",
        )
        return dataclasses.replace(self, **kw)


# ---------------------------------------------------------------------------
# Input shapes (assigned)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


SHAPES: dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524_288, 1, "decode"),
}


def cell_is_runnable(cfg: ModelConfig, shape: ShapeSpec) -> Tuple[bool, str]:
    """Whether an (arch x shape) cell runs, and the reason if skipped.

    Skips follow the brief: ``long_500k`` needs a sub-quadratic backbone.
    """
    if shape.name == "long_500k" and not cfg.sub_quadratic:
        return False, "long_500k skipped: pure full-attention arch (see DESIGN.md)"
    return True, ""


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------

_REGISTRY: dict[str, ModelConfig] = {}


def register(cfg: ModelConfig) -> ModelConfig:
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_config(name: str) -> ModelConfig:
    _load_all()
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; have {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def list_archs() -> list[str]:
    _load_all()
    return sorted(_REGISTRY)


_ARCH_MODULES = [
    "llava_next_34b",
    "qwen3_moe_30b_a3b",
    "dbrx_132b",
    "zamba2_7b",
    "rwkv6_7b",
    "whisper_tiny",
    "gemma3_4b",
    "qwen1_5_4b",
    "qwen2_1_5b",
    "nemotron_4_15b",
]


def _load_all() -> None:
    import importlib

    for mod in _ARCH_MODULES:
        importlib.import_module(f"repro_torch.configs.{mod}")

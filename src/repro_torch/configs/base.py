"""Configuration dataclasses: ``CNNConfig`` and ``InceptionSpec``
(``repro/models/cnn.py``'s), and ``ModelConfig`` with its ``BlockSpec``,
``MoESpec`` and ``SSMSpec`` and ``TrainConfig``
(``repro/configs/base.py``'s), kept field for field."""
from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class InceptionSpec:
    n1: int      # 1x1 branch
    r3: int      # 3x3 reduce
    n3: int      # 3x3 branch
    r5: int      # 5x5 reduce
    n5: int      # 5x5 branch
    pp: int      # pool-proj branch

    @property
    def out(self) -> int:
        return self.n1 + self.n3 + self.n5 + self.pp


@dataclasses.dataclass(frozen=True)
class CNNConfig:
    name: str
    img: tuple[int, int, int]            # (H, W, C)
    stem: tuple[tuple[int, int, int], ...]  # (k, out_ch, stride) convs
    modules: tuple[InceptionSpec, ...]
    pool_between: tuple[int, ...]        # module idxs preceded by a maxpool
    num_classes: int = 1000
    family: str = "cnn"

    def param_count(self) -> int:
        n, c = 0, self.img[2]
        for (k, out, _s) in self.stem:
            n += k * k * c * out + out
            c = out
        for m in self.modules:
            n += c * m.n1 + m.n1
            n += c * m.r3 + m.r3 + 9 * m.r3 * m.n3 + m.n3
            n += c * m.r5 + m.r5 + 25 * m.r5 * m.n5 + m.n5
            n += c * m.pp + m.pp
            c = m.out
        return n + c * self.num_classes + self.num_classes


@dataclasses.dataclass(frozen=True)
class MoESpec:
    n_experts: int
    top_k: int
    d_expert: int
    shared_f: int = 0            # shared-expert ffn width (0 = none)
    capacity_factor: float = 1.25


@dataclasses.dataclass(frozen=True)
class SSMSpec:
    d_inner: int
    n_heads: int
    head_dim: int
    d_state: int
    n_groups: int
    conv_width: int = 4
    chunk: int = 128


@dataclasses.dataclass(frozen=True)
class BlockSpec:
    """One position of the repeating layer pattern."""
    mixer: str = "attn"          # "attn" | "mamba"
    mlp: str = "dense"           # "dense" | "moe" | "none"
    window: Optional[int] = None  # sliding-window attention
    cross: bool = False          # add cross-attention (enc-dec decoder)


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """A language model: the layer pattern repeated ``n_layers /
    len(pattern)`` times (data only; ``models/transformer.py`` runs it)."""
    name: str
    family: str                  # dense | moe | hybrid | ssm | vlm | audio
    d_model: int
    n_layers: int
    vocab: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    pattern: tuple[BlockSpec, ...] = (BlockSpec(),)
    moe: Optional[MoESpec] = None
    ssm: Optional[SSMSpec] = None
    rope_theta: Optional[float] = 10000.0
    attn_softcap: Optional[float] = None
    final_softcap: Optional[float] = None
    qkv_bias: bool = False
    activation: str = "silu"
    norm: str = "rms"            # "rms" | "ln"
    post_norm: bool = False      # gemma2-style post-block norms
    tie_embeddings: bool = True
    embed_scale: bool = False    # gemma-style sqrt(d) embed multiplier
    query_scale: Optional[float] = None
    # encoder-decoder (whisper)
    enc_dec: bool = False
    n_enc_layers: int = 0
    enc_context_len: int = 1500  # stub frontend frames
    # modality frontend stub: None | "patch" | "frame"
    frontend: Optional[str] = None
    frontend_len: int = 256      # prepended patch embeddings (vlm)
    sub_quadratic: bool = False  # may run long_500k
    notes: str = ""

    @property
    def is_attention_free(self) -> bool:
        return all(b.mixer != "attn" for b in self.pattern)

    def param_count(self) -> int:
        """Analytic parameter count (for MODEL_FLOPS = 6*N*D)."""
        d, v = self.d_model, self.vocab
        n = v * d  # embed
        if not self.tie_embeddings:
            n += v * d
        per = {"attn": 0, "mamba": 0, "dense": 0, "moe": 0, "cross": 0}
        per["attn"] = d * self.n_heads * self.head_dim * 2 \
            + d * self.n_kv_heads * self.head_dim * 2
        gate = 1 if self.activation in ("silu", "gelu") else 0
        per["dense"] = (2 + gate) * d * self.d_ff
        if self.moe:
            per["moe"] = self.moe.n_experts * (2 + gate) * d \
                * self.moe.d_expert + d * self.moe.n_experts
            if self.moe.shared_f:
                per["moe"] += (2 + gate) * d * self.moe.shared_f
        if self.ssm:
            s = self.ssm
            d_xbc = s.d_inner + 2 * s.n_groups * s.d_state
            per["mamba"] = d * (s.d_inner + d_xbc + s.n_heads) \
                + s.conv_width * d_xbc + s.d_inner * d + 3 * s.n_heads
        per["cross"] = per["attn"]
        reps = self.n_layers // len(self.pattern)
        for b in self.pattern:
            n += reps * per[b.mixer]
            n += reps * per[b.mlp] if b.mlp != "none" else 0
            if b.cross:
                n += reps * per["cross"]
        if self.enc_dec:
            n += self.n_enc_layers * (per["attn"] + per["dense"])
        return n

    def active_param_count(self) -> int:
        """Active params per token (MoE: top_k experts only)."""
        if not self.moe:
            return self.param_count()
        full = self.param_count()
        gate = 1 if self.activation in ("silu", "gelu") else 0
        reps = self.n_layers // len(self.pattern)
        n_moe_layers = sum(1 for b in self.pattern if b.mlp == "moe") * reps
        per_expert = (2 + gate) * self.d_model * self.moe.d_expert
        inactive = n_moe_layers * (self.moe.n_experts - self.moe.top_k) \
            * per_expert
        return full - inactive


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Training knobs (``repro/configs/base.py``'s ``TrainConfig``, kept
    field for field)."""
    lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 1000
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    b1: float = 0.9
    b2: float = 0.95
    opt_state_dtype: str = "float32"   # "bfloat16" for the 398B config
    param_dtype: str = "float32"
    remat: bool = True
    fsdp: bool = True
    moe_aux_weight: float = 0.01

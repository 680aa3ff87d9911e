"""Config schema: model / mesh / training / quantization / serving.

The port's own copy of ``repro/configs/base.py`` (the port imports
nothing of the JAX package).  One frozen dataclass tree per architecture
lives in repro_torch/configs/<id>.py; the registry in
repro_torch/configs/__init__.py resolves ``--arch <id>``.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field, replace


@dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    capacity_factor: float = 1.25
    aux_loss_coef: float = 0.01
    # dtype of the EP combine psum (§Perf: bf16 halves the MoE collective)
    combine_dtype: str = "float32"


@dataclass(frozen=True)
class SSMConfig:
    state_dim: int = 128          # N
    head_dim: int = 64            # P
    expand: int = 2               # d_inner = expand * d_model
    ngroups: int = 1              # B/C groups G
    conv_width: int = 4
    dt_min: float = 1e-3
    dt_max: float = 1e-1


# One layer = mixer ("attn" | "ssm") + ffn ("dense" | "moe" | "none").
LayerSpec = tuple  # (mixer, ffn)


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                   # dense | moe | ssm | hybrid | audio | vlm
    num_layers: int
    d_model: int
    num_heads: int                # 0 for attention-free
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0             # 0 -> d_model // num_heads
    qkv_bias: bool = False
    mlp_bias: bool = False
    mlp_type: str = "swiglu"      # swiglu | gelu
    norm_type: str = "rmsnorm"    # rmsnorm | layernorm
    norm_eps: float = 1e-5
    rope_theta: float = 10000.0
    sliding_window: int | None = None
    # serving: prefill prompts in chunks of this many tokens (None = one
    # shot up to the KV ring width, then auto-chunk at the ring width);
    # bounds peak prefill activation memory at O(chunk * window)
    prefill_chunk: int | None = None
    # decode KV-cache backend: "auto" (ring for sliding-window models,
    # dense otherwise) | "dense" | "ring" | "paged" (page pool + block
    # tables — what the ServeEngine admits into)
    cache_kind: str = "auto"
    tie_embeddings: bool = False
    moe: MoEConfig | None = None
    ssm: SSMConfig | None = None
    # Layer group pattern, scanned num_layers/len(group) times.  Defaults
    # to a single homogeneous layer per group.
    group: tuple[LayerSpec, ...] = ()
    modality: str = "text"        # text | audio | vlm (audio/vlm: stub frontend)
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    logit_softcap: float | None = None

    def __post_init__(self):
        if not self.group:
            ffn = "none" if self.d_ff == 0 else ("moe" if self.moe else "dense")
            mixer = "ssm" if self.ssm and self.num_heads == 0 else "attn"
            object.__setattr__(self, "group", ((mixer, ffn),))
        if self.head_dim == 0 and self.num_heads:
            object.__setattr__(self, "head_dim", self.d_model // self.num_heads)
        assert self.num_layers % len(self.group) == 0, (
            self.num_layers, len(self.group))

    @property
    def num_groups(self) -> int:
        return self.num_layers // len(self.group)

    @property
    def padded_vocab(self) -> int:
        """Vocab padded to a 256 multiple so it shards over any mesh axis."""
        return math.ceil(self.vocab_size / 256) * 256

    @property
    def attn_positions(self) -> tuple[int, ...]:
        return tuple(i for i, (m, _) in enumerate(self.group) if m == "attn")

    @property
    def ssm_positions(self) -> tuple[int, ...]:
        return tuple(i for i, (m, _) in enumerate(self.group) if m == "ssm")

    @property
    def is_sub_quadratic(self) -> bool:
        """Can this arch decode at 500k context?  True for SSM/hybrid (O(1)
        or O(window) state) and SWA models; False for pure full attention."""
        if self.num_heads == 0 or self.ssm is not None:
            return True
        return self.sliding_window is not None

    def _layer_params(self, mixer: str, ffn: str, active: bool) -> int:
        d = self.d_model
        n = 0
        if mixer == "attn":
            hd = self.head_dim
            n += d * self.num_heads * hd + 2 * d * self.num_kv_heads * hd
            n += self.num_heads * hd * d
            if self.qkv_bias:
                n += (self.num_heads + 2 * self.num_kv_heads) * hd
            n += d  # pre-norm
        elif mixer == "ssm":
            s = self.ssm
            d_in = s.expand * d
            nheads = d_in // s.head_dim
            conv_dim = d_in + 2 * s.ngroups * s.state_dim
            n += d * (2 * d_in + 2 * s.ngroups * s.state_dim + nheads)  # in_proj
            n += conv_dim * s.conv_width                                # conv filt
            n += 3 * nheads                                             # A, dt_bias, D
            n += d_in * d                                               # out_proj
            n += d + d_in                                               # norms
        if ffn in ("dense", "moe"):
            mult = 3 if self.mlp_type == "swiglu" else 2
            per_expert = mult * d * self.d_ff
            if ffn == "dense":
                n += per_expert + d
            else:
                e = self.moe.top_k if active else self.moe.num_experts
                n += e * per_expert + d * self.moe.num_experts + d
        return n

    def _count(self, active: bool) -> int:
        d = self.d_model
        n = self.padded_vocab * d * (1 if self.tie_embeddings else 2)
        n += sum(self._layer_params(m, f, active) for m, f in self.group) * self.num_groups
        return n + d  # final norm

    def param_count(self) -> int:
        """Total parameters (embedding + layers + head), exact."""
        return self._count(active=False)

    def active_param_count(self) -> int:
        """Params touched per token (MoE: top_k of num_experts active)."""
        return self._count(active=True)


@dataclass(frozen=True)
class MeshConfig:
    """Logical mesh; built by launch/mesh.py."""
    data: int = 16
    model: int = 16
    pod: int = 1

    @property
    def num_devices(self) -> int:
        return self.data * self.model * self.pod

    @property
    def axis_names(self) -> tuple[str, ...]:
        return ("pod", "data", "model") if self.pod > 1 else ("data", "model")

    @property
    def shape(self) -> tuple[int, ...]:
        return ((self.pod, self.data, self.model) if self.pod > 1
                else (self.data, self.model))


@dataclass(frozen=True)
class ShapeConfig:
    """One benchmark cell: (kind, seq_len, global_batch)."""
    name: str
    kind: str                 # train | prefill | decode
    seq_len: int
    global_batch: int


SHAPES = {
    "train_4k": ShapeConfig("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeConfig("prefill_32k", "prefill", 32768, 32),
    "decode_32k": ShapeConfig("decode_32k", "decode", 32768, 128),
    "long_500k": ShapeConfig("long_500k", "decode", 524288, 1),
}


@dataclass(frozen=True)
class OptimConfig:
    lr: float = 3e-4
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    schedule: str = "cosine"      # cosine | wsd | linear
    warmup_steps: int = 100
    total_steps: int = 10000
    wsd_decay_frac: float = 0.1   # WSD: final decay fraction (MiniCPM)


@dataclass(frozen=True)
class QuantConfig:
    """EN-T w8a8 serving quantization."""
    enabled: bool = False
    ent_encode: bool = True       # store weights as EN-T digit planes
    per_channel: bool = True
    skip_patterns: tuple[str, ...] = ("embed", "lm_head", "norm", "router")


@dataclass(frozen=True)
class TrainConfig:
    seq_len: int = 4096
    global_batch: int = 256
    microbatch: int = 0           # 0 = no accumulation
    remat: str = "none"           # none | full | dots
    checkpoint_every: int = 500
    checkpoint_dir: str = "/tmp/repro_ckpt"
    log_every: int = 10
    grad_compression: str = "none"  # none | int8_ef (cross-pod int8 + error feedback)
    grad_prepin: bool = False       # pin per-microbatch grads (reduce-scatter hint)
    grad_dtype: str = "float32"     # bfloat16 halves grad-reduction bytes


@dataclass(frozen=True)
class RunConfig:
    model: ModelConfig
    mesh: MeshConfig = field(default_factory=MeshConfig)
    optim: OptimConfig = field(default_factory=OptimConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    quant: QuantConfig = field(default_factory=QuantConfig)

    def with_mesh(self, **kw) -> "RunConfig":
        return replace(self, mesh=replace(self.mesh, **kw))

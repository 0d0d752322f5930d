"""Architecture / shape / mesh configuration system.

Every assigned architecture is expressed as an ``ArchConfig``: a *layer
pattern* (a short heterogeneous block) repeated ``repeats`` times plus an
unrolled ``remainder``, with the pattern's parameters stacked on a leading
``repeats`` axis. This supports interleaves like gemma3's 5 local : 1
global or jamba's 7 mamba : 1 attention. A copy of ``repro.configs.base``:
the two must agree (``tests/test_torch_lm_model.py``).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional, Tuple

# ---------------------------------------------------------------------------
# Layer specs
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class AttentionSpec:
    """Self-attention configuration for one layer."""

    num_heads: int
    num_kv_heads: int
    head_dim: int
    kind: str = "full"  # full | sliding | chunked
    window: int = 0  # sliding-window length or chunk size (kind != full)
    # Multi-head latent attention (deepseek-v2).  When set, K/V are
    # compressed to rank ``kv_lora`` (+ ``rope_dim`` decoupled rope dims).
    kv_lora: int = 0
    q_lora: int = 0
    rope_dim: int = 0  # decoupled rope dims for MLA
    causal: bool = True
    rope: bool = True
    rope_frac: float = 1.0  # fraction of head_dim rotated (stablelm: 0.25)
    softmax_scale: Optional[float] = None
    qk_norm: bool = False  # gemma3-style RMSNorm on q/k

    @property
    def is_mla(self) -> bool:
        return self.kv_lora > 0

    @property
    def cache_kv_heads(self) -> int:
        return self.num_kv_heads

    def cache_len(self, seq_len: int) -> int:
        """KV-cache length actually required for decode at context seq_len."""
        if self.kind in ("sliding", "chunked") and self.window > 0:
            return min(self.window, seq_len)
        return seq_len


@dataclasses.dataclass(frozen=True)
class MoESpec:
    num_experts: int
    top_k: int
    d_ff_expert: int
    num_shared: int = 0
    d_ff_shared: int = 0
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01


@dataclasses.dataclass(frozen=True)
class MLPSpec:
    kind: str = "dense"  # dense | moe | none
    d_ff: int = 0
    activation: str = "silu"  # silu (gated) | gelu (ungated)
    moe: Optional[MoESpec] = None


@dataclasses.dataclass(frozen=True)
class SSMSpec:
    """Mamba2 (SSD) block spec."""

    d_inner: int
    d_state: int = 128
    head_dim: int = 64
    conv_width: int = 4
    chunk: int = 256
    expand: int = 2

    @property
    def num_heads(self) -> int:
        return self.d_inner // self.head_dim


@dataclasses.dataclass(frozen=True)
class LayerSpec:
    kind: str  # "attn" | "mamba"
    attn: Optional[AttentionSpec] = None
    mlp: MLPSpec = MLPSpec(kind="none")
    ssm: Optional[SSMSpec] = None


@dataclasses.dataclass(frozen=True)
class EncoderSpec:
    """Bidirectional encoder stack (whisper)."""

    num_layers: int
    num_heads: int
    d_ff: int
    source_len: int = 1500  # frames after the (stubbed) conv frontend


# ---------------------------------------------------------------------------
# Architecture config
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | vlm | audio
    citation: str
    d_model: int
    vocab_size: int
    pattern: Tuple[LayerSpec, ...]
    repeats: int
    prefix: Tuple[LayerSpec, ...] = ()  # unrolled layers BEFORE the scanned pattern
    remainder: Tuple[LayerSpec, ...] = ()  # unrolled layers AFTER the scanned pattern
    norm: str = "rmsnorm"  # rmsnorm | layernorm
    norm_eps: float = 1e-6
    rope_theta: float = 10000.0
    rope_theta_local: float = 0.0  # gemma3: distinct base for local layers
    tie_embeddings: bool = False
    logits_softcap: float = 0.0
    embed_scale: bool = False  # gemma: scale embeddings by sqrt(d_model)
    encoder: Optional[EncoderSpec] = None  # whisper
    frontend: str = "none"  # none | audio_stub | vision_stub
    frontend_tokens: int = 0  # patches/frames prepended for stub frontends
    # long_500k applicability (sub-quadratic attention / bounded caches)
    supports_long_context: bool = False
    # dtype policy
    param_dtype: str = "bfloat16"
    compute_dtype: str = "bfloat16"

    # ---- derived ----------------------------------------------------------
    @property
    def num_layers(self) -> int:
        return len(self.prefix) + len(self.pattern) * self.repeats + len(self.remainder)

    def all_layers(self) -> Tuple[LayerSpec, ...]:
        return self.prefix + self.pattern * self.repeats + self.remainder

    def param_count(self) -> int:
        """Analytic parameter count (embedding + layers + head)."""
        total = self.vocab_size * self.d_model  # embedding
        if not self.tie_embeddings:
            total += self.vocab_size * self.d_model
        for spec in self.all_layers():
            total += _layer_params(self.d_model, spec)
        total += self.d_model  # final norm
        if self.encoder is not None:
            e = self.encoder
            hd = self.d_model // e.num_heads
            enc_layer = (
                4 * self.d_model * e.num_heads * hd + 2 * self.d_model * e.d_ff
            )
            total += e.num_layers * enc_layer
        return total

    def active_param_count(self) -> int:
        """Params touched per token (MoE: only routed top-k + shared)."""
        total = self.vocab_size * self.d_model
        if not self.tie_embeddings:
            total += self.vocab_size * self.d_model
        for spec in self.all_layers():
            total += _layer_params(self.d_model, spec, active_only=True)
        total += self.d_model
        return total

    def reduced(self) -> "ArchConfig":
        """A tiny same-family variant for CPU smoke tests.

        2 pattern layers (preserving heterogeneity), d_model <= 512,
        <= 4 experts, vocab <= 512.
        """
        d_model = min(self.d_model, 256)
        # keep one of each distinct layer kind from the pattern
        kinds_seen = []
        small_pattern = []
        for spec in self.pattern + self.prefix + self.remainder:
            sig = (spec.kind, spec.attn.kind if spec.attn else "", spec.mlp.kind)
            if sig not in kinds_seen and len(small_pattern) < 2:
                kinds_seen.append(sig)
                small_pattern.append(_reduce_layer(spec, d_model))
        while len(small_pattern) < 2:
            small_pattern.append(small_pattern[-1])
        encoder = None
        if self.encoder is not None:
            encoder = EncoderSpec(
                num_layers=2, num_heads=4, d_ff=2 * d_model, source_len=64
            )
        return dataclasses.replace(
            self,
            name=self.name + "-reduced",
            d_model=d_model,
            vocab_size=min(self.vocab_size, 512),
            pattern=tuple(small_pattern),
            repeats=1,
            prefix=(),
            remainder=(),
            encoder=encoder,
            frontend_tokens=min(self.frontend_tokens, 16) if self.frontend_tokens else 0,
            param_dtype="float32",
            compute_dtype="float32",
        )


def _layer_params(d_model: int, spec: LayerSpec, active_only: bool = False) -> int:
    total = 2 * d_model  # two norms
    if spec.kind == "mamba":
        s = spec.ssm
        di, ds = s.d_inner, s.d_state
        nh = s.num_heads
        total += d_model * (2 * di + 2 * ds + nh)  # in_proj (z,x,B,C,dt)
        total += di * s.conv_width + di  # conv + skip D... (approx)
        total += di * d_model  # out_proj
    a = spec.attn
    if a is not None:
        if a.is_mla:
            total += d_model * (a.kv_lora + a.rope_dim)  # kv down
            total += a.kv_lora * a.num_heads * 2 * a.head_dim  # kv up
            if a.q_lora:
                total += d_model * a.q_lora
                total += a.q_lora * a.num_heads * (a.head_dim + a.rope_dim)
            else:
                total += d_model * a.num_heads * (a.head_dim + a.rope_dim)
            total += a.num_heads * a.head_dim * d_model  # o_proj
        else:
            total += d_model * a.num_heads * a.head_dim  # q
            total += 2 * d_model * a.num_kv_heads * a.head_dim  # k,v
            total += a.num_heads * a.head_dim * d_model  # o
    m = spec.mlp
    if m.kind == "dense":
        mult = 3 if m.activation == "silu" else 2
        total += mult * d_model * m.d_ff
    elif m.kind == "moe":
        mo = m.moe
        n_routed = mo.top_k if active_only else mo.num_experts
        total += n_routed * 3 * d_model * mo.d_ff_expert
        total += mo.num_shared * 3 * d_model * mo.d_ff_shared
        total += d_model * mo.num_experts  # router
    return total


def _reduce_layer(spec: LayerSpec, d_model: int) -> LayerSpec:
    attn = spec.attn
    if attn is not None:
        heads = 4
        kv = max(1, min(attn.num_kv_heads * heads // max(attn.num_heads, 1), heads))
        attn = dataclasses.replace(
            attn,
            num_heads=heads,
            num_kv_heads=kv,
            head_dim=d_model // heads,
            window=min(attn.window, 32) if attn.window else 0,
            kv_lora=32 if attn.is_mla else 0,
            q_lora=32 if attn.q_lora else 0,
            rope_dim=16 if attn.is_mla else 0,
        )
    mlp = spec.mlp
    if mlp.kind == "dense":
        mlp = dataclasses.replace(mlp, d_ff=2 * d_model)
    elif mlp.kind == "moe":
        mo = mlp.moe
        mlp = dataclasses.replace(
            mlp,
            moe=dataclasses.replace(
                mo,
                num_experts=4,
                top_k=min(mo.top_k, 2),
                d_ff_expert=d_model,
                num_shared=min(mo.num_shared, 1),
                d_ff_shared=d_model if mo.num_shared else 0,
            ),
        )
    ssm = spec.ssm
    if ssm is not None:
        ssm = SSMSpec(d_inner=2 * d_model, d_state=16, head_dim=32, chunk=16)
    return LayerSpec(kind=spec.kind, attn=attn, mlp=mlp, ssm=ssm)


# ---------------------------------------------------------------------------
# Input shapes (assigned)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    mode: str  # train | prefill | decode


TRAIN_4K = ShapeConfig("train_4k", 4_096, 256, "train")
PREFILL_32K = ShapeConfig("prefill_32k", 32_768, 32, "prefill")
DECODE_32K = ShapeConfig("decode_32k", 32_768, 128, "decode")
LONG_500K = ShapeConfig("long_500k", 524_288, 1, "decode")

INPUT_SHAPES = {s.name: s for s in (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)}


def shape_applicable(arch: "ArchConfig", shape: ShapeConfig) -> Tuple[bool, str]:
    """Whether (arch, shape) is a required dry-run pair; reason if not."""
    if shape.name == "long_500k" and not arch.supports_long_context:
        return False, (
            "pure full-attention at every layer (or enc-dec with bounded "
            "decoder context) — 500k KV cache unsupported; noted in DESIGN.md"
        )
    return True, ""


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------

_REGISTRY: dict = {}


def register(fn: Callable[[], ArchConfig]):
    cfg = fn()
    _REGISTRY[cfg.name] = cfg
    return fn


def get_arch(name: str) -> ArchConfig:
    if name not in _REGISTRY:
        # late import of the config modules
        from repro_torch import configs as _c  # noqa: F401

        _c.load_all()
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def all_archs() -> dict:
    from repro_torch import configs as _c

    _c.load_all()
    return dict(_REGISTRY)

"""llama4-maverick-400b-a17b [moe] — 48L d_model=5120 40H (GQA kv=8)
d_ff_expert=8192 vocab=202048, MoE 128e top-1 + 1 shared expert on every
other layer (interleave step 2), dense d_ff=16384 otherwise; 3 chunked-local
(8192) : 1 global attention; early-fusion multimodal (vision stub).
[hf:meta-llama/Llama-4-Scout-17B-16E family]
"""
from repro_torch.configs.base import (
    ArchConfig,
    AttentionSpec,
    LayerSpec,
    MLPSpec,
    MoESpec,
    register,
)

_LOCAL = AttentionSpec(
    num_heads=40, num_kv_heads=8, head_dim=128, kind="chunked", window=8192
)
_GLOBAL = AttentionSpec(num_heads=40, num_kv_heads=8, head_dim=128, kind="full")
_DENSE = MLPSpec(kind="dense", d_ff=16384, activation="silu")
_MOE = MLPSpec(
    kind="moe",
    moe=MoESpec(
        num_experts=128,
        top_k=1,
        d_ff_expert=8192,
        num_shared=1,
        d_ff_shared=8192,
    ),
)


@register
def llama4_maverick_400b() -> ArchConfig:
    # 4-layer block: [local+dense, local+moe, local+dense, global+moe] x 12
    pattern = (
        LayerSpec(kind="attn", attn=_LOCAL, mlp=_DENSE),
        LayerSpec(kind="attn", attn=_LOCAL, mlp=_MOE),
        LayerSpec(kind="attn", attn=_LOCAL, mlp=_DENSE),
        LayerSpec(kind="attn", attn=_GLOBAL, mlp=_MOE),
    )
    return ArchConfig(
        name="llama4-maverick-400b-a17b",
        family="moe",
        citation="hf:meta-llama/Llama-4-Scout-17B-16E (maverick sibling)",
        d_model=5120,
        vocab_size=202_048,
        pattern=pattern,
        repeats=12,
        rope_theta=500_000.0,
        norm_eps=1e-5,
        frontend="vision_stub",
        frontend_tokens=144,  # early-fusion image patches
        # 36/48 layers chunked-local (8192-bounded cache); 12 global layers
        # decode linearly in S => long_500k applicable.
        supports_long_context=True,
    )

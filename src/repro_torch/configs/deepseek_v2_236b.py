"""deepseek-v2-236b [moe] — 60L d_model=5120 128H d_ff_expert=1536
vocab=102400. MLA kv_lora=512 (+64 decoupled rope dims), q_lora=1536,
2 shared + 160 routed experts top-6. First layer is dense (d_ff 12288).
[arXiv:2405.04434]
"""
from repro_torch.configs.base import (
    ArchConfig,
    AttentionSpec,
    LayerSpec,
    MLPSpec,
    MoESpec,
    register,
)

_MLA = AttentionSpec(
    num_heads=128,
    num_kv_heads=128,  # MLA decompresses to per-head K/V
    head_dim=128,
    kv_lora=512,
    q_lora=1536,
    rope_dim=64,
)
_MOE_LAYER = LayerSpec(
    kind="attn",
    attn=_MLA,
    mlp=MLPSpec(
        kind="moe",
        moe=MoESpec(
            num_experts=160,
            top_k=6,
            d_ff_expert=1536,
            num_shared=2,
            d_ff_shared=1536,
        ),
    ),
)
_DENSE_LAYER = LayerSpec(
    kind="attn",
    attn=_MLA,
    mlp=MLPSpec(kind="dense", d_ff=12288, activation="silu"),
)


@register
def deepseek_v2_236b() -> ArchConfig:
    return ArchConfig(
        name="deepseek-v2-236b",
        family="moe",
        citation="arXiv:2405.04434",
        d_model=5120,
        vocab_size=102_400,
        prefix=(_DENSE_LAYER,),
        pattern=(_MOE_LAYER,),
        repeats=59,
        rope_theta=10_000.0,
    )

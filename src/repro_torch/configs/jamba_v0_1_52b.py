"""jamba-v0.1-52b [hybrid] — 32L d_model=4096 32H (GQA kv=8) d_ff=14336
vocab=65536, MoE 16e top-2. Mamba+attention 1:7 interleave (attention at
index 4 of each 8-layer block), MoE on every other layer. [arXiv:2403.19887]
"""
from repro_torch.configs.base import (
    ArchConfig,
    AttentionSpec,
    LayerSpec,
    MLPSpec,
    MoESpec,
    SSMSpec,
    register,
)

_SSM = SSMSpec(d_inner=8192, d_state=128, head_dim=64, conv_width=4, chunk=256)
_DENSE = MLPSpec(kind="dense", d_ff=14336, activation="silu")
_MOE = MLPSpec(
    kind="moe",
    moe=MoESpec(num_experts=16, top_k=2, d_ff_expert=14336),
)
_ATTN = AttentionSpec(num_heads=32, num_kv_heads=8, head_dim=128, rope=False)


def _layer(idx: int) -> LayerSpec:
    mlp = _MOE if idx % 2 == 1 else _DENSE
    if idx == 4:
        return LayerSpec(kind="attn", attn=_ATTN, mlp=mlp)
    return LayerSpec(kind="mamba", ssm=_SSM, mlp=mlp)


@register
def jamba_v0_1_52b() -> ArchConfig:
    return ArchConfig(
        name="jamba-v0.1-52b",
        family="hybrid",
        citation="arXiv:2403.19887",
        d_model=4096,
        vocab_size=65_536,
        pattern=tuple(_layer(i) for i in range(8)),
        repeats=4,
        # attention in only 4/32 layers => 500k decode cache is 4 layers'
        # worth of KV; mamba state is O(1).
        supports_long_context=True,
    )

"""gemma3-27b [dense] — 62L d_model=5376 32H (GQA kv=16) d_ff=21504
vocab=262144, 5:1 local:global sliding-window interleave, 128k context.
[hf:google/gemma-3-1b-pt family, scaled to 27b]
"""
from repro_torch.configs.base import (
    ArchConfig,
    AttentionSpec,
    LayerSpec,
    MLPSpec,
    register,
)

_LOCAL = LayerSpec(
    kind="attn",
    attn=AttentionSpec(
        num_heads=32,
        num_kv_heads=16,
        head_dim=128,
        kind="sliding",
        window=1024,
        qk_norm=True,
    ),
    mlp=MLPSpec(kind="dense", d_ff=21504, activation="silu"),
)
_GLOBAL = LayerSpec(
    kind="attn",
    attn=AttentionSpec(
        num_heads=32, num_kv_heads=16, head_dim=128, kind="full", qk_norm=True
    ),
    mlp=MLPSpec(kind="dense", d_ff=21504, activation="silu"),
)


@register
def gemma3_27b() -> ArchConfig:
    # 62 layers = (5 local + 1 global) * 10 + 2 local remainder
    return ArchConfig(
        name="gemma3-27b",
        family="dense",
        citation="hf:google/gemma-3-1b-pt (5:1 local:global, 128k)",
        d_model=5376,
        vocab_size=262_144,
        pattern=(_LOCAL, _LOCAL, _LOCAL, _LOCAL, _LOCAL, _GLOBAL),
        repeats=10,
        remainder=(_LOCAL, _LOCAL),
        rope_theta=1_000_000.0,
        rope_theta_local=10_000.0,
        tie_embeddings=True,
        embed_scale=True,
        # 51/62 layers have a 1024-token bounded cache; the 11 global layers
        # decode linearly in S => long_500k applicable.
        supports_long_context=True,
    )

"""mamba2-370m [ssm] — 48L d_model=1024 attention-free, vocab=50280,
ssm_state=128, SSD (state-space duality). [arXiv:2405.21060]
"""
from repro_torch.configs.base import ArchConfig, LayerSpec, MLPSpec, SSMSpec, register

_LAYER = LayerSpec(
    kind="mamba",
    ssm=SSMSpec(d_inner=2048, d_state=128, head_dim=64, conv_width=4, chunk=256),
    mlp=MLPSpec(kind="none"),
)


@register
def mamba2_370m() -> ArchConfig:
    return ArchConfig(
        name="mamba2-370m",
        family="ssm",
        citation="arXiv:2405.21060",
        d_model=1024,
        vocab_size=50_280,
        pattern=(_LAYER,),
        repeats=48,
        norm_eps=1e-5,
        tie_embeddings=True,
        supports_long_context=True,  # O(1) recurrent state
    )

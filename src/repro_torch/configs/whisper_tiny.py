"""whisper-tiny [audio] — 4L d_model=384 6H (kv=6) d_ff=1536 vocab=51865.
Encoder-decoder; the mel-spectrogram + conv frontend is a STUB —
``input_specs`` provides precomputed frame embeddings. [arXiv:2212.04356]
"""
from repro_torch.configs.base import (
    ArchConfig,
    AttentionSpec,
    EncoderSpec,
    LayerSpec,
    MLPSpec,
    register,
)

_DEC = LayerSpec(
    kind="attn",
    attn=AttentionSpec(num_heads=6, num_kv_heads=6, head_dim=64, rope=False),
    mlp=MLPSpec(kind="dense", d_ff=1536, activation="gelu"),
)


@register
def whisper_tiny() -> ArchConfig:
    return ArchConfig(
        name="whisper-tiny",
        family="audio",
        citation="arXiv:2212.04356",
        d_model=384,
        vocab_size=51_865,
        pattern=(_DEC,),
        repeats=4,
        norm="layernorm",
        norm_eps=1e-5,
        tie_embeddings=True,
        encoder=EncoderSpec(num_layers=4, num_heads=6, d_ff=1536, source_len=1500),
        frontend="audio_stub",
        # decoder context is architecturally bounded (448 in the paper);
        # long_500k decode is not meaningful for whisper.
        supports_long_context=False,
    )

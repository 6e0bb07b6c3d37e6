"""whisper-base [audio]: 6L d_model=512 8H (MHA kv=8) d_ff=2048 vocab=51865
— encoder-decoder; the conv-mel frontend is a stub (precomputed frame
embeddings) [arXiv:2212.04356].

The backbone only, as the reference: 6 encoder and 6 decoder layers,
layernorm, GELU, non-gated MLP, tied embeddings. Positions use rope in
place of whisper's learned absolute embeddings, as the reference does.
"""
from repro_torch.nn.config import ArchConfig, EncoderConfig

CONFIG = ArchConfig(
    name="whisper-base",
    family="audio",
    num_layers=6,                   # decoder layers
    d_model=512,
    num_heads=8,
    num_kv_heads=8,
    d_ff=2048,
    vocab_size=51865,
    encoder=EncoderConfig(num_layers=6, frames=1500),
    frontend="audio_stub",
    norm="layernorm",
    act="gelu",
    gated_mlp=False,
    tie_embeddings=True,
)

"""phi-3-vision-4.2b [vlm]: 32L d_model=3072 32H (MHA, kv=32) d_ff=8192
vocab=32064 — the phi3-mini text backbone and a CLIP vision frontend
[hf:microsoft/Phi-3-vision-128k-instruct].

The CLIP frontend is a stub, as in the reference: the caller passes
precomputed patch embeddings (B, num_patches, d_model), which the LM puts
in front of the token embeddings. Head dim 3072 / 32 = 96.
"""
from repro_torch.nn.config import ArchConfig

CONFIG = ArchConfig(
    name="phi-3-vision-4.2b",
    family="vlm",
    num_layers=32,
    d_model=3072,
    num_heads=32,
    num_kv_heads=32,
    d_ff=8192,
    vocab_size=32064,
    frontend="vision_stub",
    num_patches=1024,
    act="silu",
    gated_mlp=True,
    tie_embeddings=False,
)

"""qwen3-4b [dense]: 36L d_model=2560 32H (GQA kv=8) d_ff=9728 vocab=151936
— per-head qk-norm, GQA [hf:Qwen/Qwen3-8B family]. head_dim explicit 128."""
from repro_torch.nn.config import ArchConfig

CONFIG = ArchConfig(
    name="qwen3-4b",
    family="dense",
    num_layers=36,
    d_model=2560,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=9728,
    vocab_size=151936,
    qk_norm=True,
    rope_theta=1000000.0,
    act="silu",
    gated_mlp=True,
    tie_embeddings=True,
)

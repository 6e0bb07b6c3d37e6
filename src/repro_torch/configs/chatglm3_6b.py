"""chatglm3-6b [dense]: 28L d_model=4096 32H (GQA kv=2) d_ff=13696
vocab=65024 — partial ('2d') RoPE over half the head dim, multi-query-style
GQA [arXiv:2406.12793]."""
from repro_torch.nn.config import ArchConfig

CONFIG = ArchConfig(
    name="chatglm3-6b",
    family="dense",
    num_layers=28,
    d_model=4096,
    num_heads=32,
    num_kv_heads=2,
    d_ff=13696,
    vocab_size=65024,
    rope_fraction=0.5,               # chatglm rotary on half the dims
    act="silu",
    gated_mlp=True,
    tie_embeddings=False,            # separate output head
)

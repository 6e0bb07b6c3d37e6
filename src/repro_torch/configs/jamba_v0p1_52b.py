"""jamba-v0.1-52b [hybrid]: 32L d_model=4096 32H (GQA kv=8) d_ff=14336
vocab=65536, MoE 16 experts top-2 — Mamba:attention 1:7 interleave (one
attention layer per 8-layer Jamba block), MoE every other layer
[arXiv:2403.19887].

Jamba v0.1 uses Mamba-1's selective scan; the reference realizes its ssm
layers in Mamba2's SSD chunked-matmul form, with the same state size (16)
and the same interleave, and the port follows the reference.
"""
from repro_torch.nn.config import ArchConfig, MoEConfig, SSMConfig

CONFIG = ArchConfig(
    name="jamba-v0.1-52b",
    family="hybrid",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    d_ff=14336,
    vocab_size=65536,
    layer_pattern="jamba",          # 8-layer superblock, attn at index 4
    ssm=SSMConfig(d_state=16, headdim=64, expand=2, chunk=256,
                  conv_kernel=4, n_groups=1),
    moe=MoEConfig(num_experts=16, top_k=2, d_ff_expert=14336,
                  every_k_layers=2),  # MoE on odd superblock positions
    act="silu",
    gated_mlp=True,
    tie_embeddings=False,
)

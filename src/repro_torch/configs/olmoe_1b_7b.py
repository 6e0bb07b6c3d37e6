"""olmoe-1b-7b [moe]: 16L d_model=2048 16H (GQA kv=16) d_ff=1024 vocab=50304,
MoE 64 experts top-8 [arXiv:2409.02060]. Every layer is MoE; OLMoE uses
qk-norm."""
from repro_torch.nn.config import ArchConfig, MoEConfig

CONFIG = ArchConfig(
    name="olmoe-1b-7b",
    family="moe",
    num_layers=16,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    d_ff=1024,                   # per-expert width
    vocab_size=50304,
    qk_norm=True,
    moe=MoEConfig(num_experts=64, top_k=8, d_ff_expert=1024,
                  every_k_layers=1),
    act="silu",
    gated_mlp=True,
    tie_embeddings=False,
)

"""llama4-scout-17b-a16e [moe]: 48L d_model=5120 40H (GQA kv=8) d_ff=8192
vocab=202048, MoE 16 experts top-1 with an always-on shared expert
[hf:meta-llama/Llama-4-Scout-17B-16E]. The multimodal early-fusion frontend
is out of scope for this entry (text backbone; phi-3-vision covers the vlm
frontend-stub pattern)."""
from repro_torch.nn.config import ArchConfig, MoEConfig

CONFIG = ArchConfig(
    name="llama4-scout-17b-a16e",
    family="moe",
    num_layers=48,
    d_model=5120,
    num_heads=40,
    num_kv_heads=8,
    head_dim=128,
    d_ff=8192,
    vocab_size=202048,
    moe=MoEConfig(num_experts=16, top_k=1, d_ff_expert=8192,
                  every_k_layers=1, shared_expert_ff=8192),
    rope_theta=500000.0,
    act="silu",
    gated_mlp=True,
    tie_embeddings=False,
)

"""gemma2-27b [dense]: 46L d_model=4608 32H (GQA kv=16) d_ff=36864
vocab=256000 — local+global alternating attention, logit softcapping
[arXiv:2408.00118]. head_dim is an explicit 128 (32·128 ≠ 4608)."""
from repro_torch.nn.config import ArchConfig

CONFIG = ArchConfig(
    name="gemma2-27b",
    family="dense",
    num_layers=46,
    d_model=4608,
    num_heads=32,
    num_kv_heads=16,
    head_dim=128,
    d_ff=36864,
    vocab_size=256000,
    layer_pattern="local_global",     # alternating sliding-window / global
    local_window=4096,
    attn_softcap=50.0,
    final_softcap=30.0,
    post_norms=True,                  # sandwich norms
    zero_centered_norm=True,          # (1 + g) RMSNorm
    scale_embeddings=True,            # x *= sqrt(d_model)
    act="gelu_tanh",
    gated_mlp=True,
    tie_embeddings=True,
    rope_theta=10000.0,
)

"""mamba2-2.7b [ssm]: 64L d_model=2560, attention-free, d_ff=0 vocab=50280,
ssm_state=128 — SSD (state-space duality) [arXiv:2405.21060].

Mamba2 blocks have no separate MLP (d_ff=0): the expand-2 in-projection is
the block's full width. num_heads is vestigial for the attention-free path
(kept >0 so generic shape code works); heads = d_in/headdim = 80.
"""
from repro_torch.nn.config import ArchConfig, SSMConfig

CONFIG = ArchConfig(
    name="mamba2-2.7b",
    family="ssm",
    num_layers=64,
    d_model=2560,
    num_heads=8,                 # unused (attention-free)
    num_kv_heads=8,
    d_ff=0,                      # no MLP — the SSM block is the layer
    vocab_size=50280,
    layer_pattern="ssm",
    ssm=SSMConfig(d_state=128, headdim=64, expand=2, chunk=256,
                  conv_kernel=4, n_groups=1),
    norm="rmsnorm",
    tie_embeddings=True,
)

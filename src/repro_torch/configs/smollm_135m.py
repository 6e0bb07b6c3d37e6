"""smollm-135m [dense]: 30L d_model=576 9H (GQA kv=3) d_ff=1536 vocab=49152
— llama-architecture small model [hf:HuggingFaceTB/SmolLM-135M]."""
from repro_torch.nn.config import ArchConfig

CONFIG = ArchConfig(
    name="smollm-135m",
    family="dense",
    num_layers=30,
    d_model=576,
    num_heads=9,
    num_kv_heads=3,
    d_ff=1536,
    vocab_size=49152,
    act="silu",
    gated_mlp=True,
    tie_embeddings=True,
)

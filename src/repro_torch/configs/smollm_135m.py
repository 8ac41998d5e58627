"""smollm-135m [dense]: 30L d_model=576 9H (GQA kv=3) d_ff=1536 vocab=49152.
llama-arch small. [hf:HuggingFaceTB/SmolLM-135M]"""
from repro_torch.configs.base import ATTN_GLOBAL, ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="smollm-135m", family="dense",
        n_layers=30, d_model=576, n_heads=9, n_kv_heads=3, head_dim=64,
        d_ff=1536, vocab_size=49152,
        pattern=(ATTN_GLOBAL,),
        rope_theta=10_000.0,
        tie_embeddings=True, max_seq_len=2048,
    )

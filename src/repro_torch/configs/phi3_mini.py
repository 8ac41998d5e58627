"""phi3-mini-3.8b [dense]: 32L d_model=3072 32H (kv=32) d_ff=8192 vocab=32064.
RoPE SwiGLU. [arXiv:2404.14219]"""
from repro_torch.configs.base import ATTN_GLOBAL, ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="phi3-mini-3.8b", family="dense",
        n_layers=32, d_model=3072, n_heads=32, n_kv_heads=32, head_dim=96,
        d_ff=8192, vocab_size=32064,
        pattern=(ATTN_GLOBAL,),
        rope_theta=10_000.0,
        tie_embeddings=False, max_seq_len=4096,
    )

"""gemma2-9b [dense]: 42L d_model=3584 16H (GQA kv=8) d_ff=14336 vocab=256000.
Local+global alternating, logit softcaps. [arXiv:2408.00118]"""
from repro_torch.configs.base import ATTN_GLOBAL, ATTN_LOCAL, ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="gemma2-9b", family="dense",
        n_layers=42, d_model=3584, n_heads=16, n_kv_heads=8, head_dim=256,
        d_ff=14336, vocab_size=256000,
        pattern=(ATTN_LOCAL, ATTN_GLOBAL),
        window=4096,
        attn_softcap=50.0, final_softcap=30.0,
        query_scale=(3584 // 16) ** -0.5,   # query_pre_attn_scalar = d/heads
        post_norm=True, embed_scale=True,
        act="gelu", tie_embeddings=True, max_seq_len=8192,
    )

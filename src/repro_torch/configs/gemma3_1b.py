"""gemma3-1b [dense]: 26L d_model=1152 4H (GQA kv=1) d_ff=6912 vocab=262144.
5:1 local:global attention, 128k context. [hf:google/gemma-3-1b-pt]"""
from repro_torch.configs.base import ATTN_GLOBAL, ATTN_LOCAL, ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="gemma3-1b", family="dense",
        n_layers=26, d_model=1152, n_heads=4, n_kv_heads=1, head_dim=256,
        d_ff=6912, vocab_size=262144,
        pattern=(ATTN_LOCAL,) * 5 + (ATTN_GLOBAL,),
        window=512,
        rope_theta=1_000_000.0, rope_local_theta=10_000.0,
        qk_norm=True, post_norm=True, embed_scale=True,
        act="gelu", tie_embeddings=True, max_seq_len=131072,
    )

"""llava-next-34b [vlm]: 60L d_model=7168 56H (GQA kv=8) d_ff=20480
vocab=64000; anyres vision tower is a stub (precomputed patch embeddings
prepended to the token stream). [hf:llava-hf/llava-v1.6]"""
from repro_torch.configs.base import ATTN_GLOBAL, ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="llava-next-34b", family="vlm",
        n_layers=60, d_model=7168, n_heads=56, n_kv_heads=8, head_dim=128,
        d_ff=20480, vocab_size=64000,
        pattern=(ATTN_GLOBAL,),
        n_patches=576,
        rope_theta=5_000_000.0,
        tie_embeddings=False, max_seq_len=4096,
    )

"""whisper-tiny [audio]: 4L enc + 4L dec, d_model=384 6H d_ff=1536
vocab=51865; conv frontend is a stub (precomputed frame embeddings).
[arXiv:2212.04356]"""
from repro_torch.configs.base import ATTN_GLOBAL, EncoderConfig, ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="whisper-tiny", family="audio",
        n_layers=4, d_model=384, n_heads=6, n_kv_heads=6, head_dim=64,
        d_ff=1536, vocab_size=51865,
        pattern=(ATTN_GLOBAL,),
        encoder=EncoderConfig(n_layers=4, max_frames=1500),
        use_rope=False,
        tie_embeddings=True, max_seq_len=448,
    )

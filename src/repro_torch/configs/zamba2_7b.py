"""zamba2-7b [hybrid]: 81L d_model=3584, Mamba2 backbone + one SHARED
attention+MLP block applied every 6th site, d_ff=14336, vocab=32000,
ssm_state=64. [arXiv:2411.15242]"""
from repro_torch.configs.base import (MIXER_SHARED_ATTN, MIXER_SSM, ModelConfig,
                                SSMConfig)


def config() -> ModelConfig:
    return ModelConfig(
        name="zamba2-7b", family="hybrid",
        n_layers=81, d_model=3584, n_heads=32, n_kv_heads=32, head_dim=112,
        d_ff=14336, vocab_size=32000,
        pattern=(MIXER_SSM,) * 5 + (MIXER_SHARED_ATTN,),
        ssm=SSMConfig(d_state=64, d_conv=4, expand=2, head_dim=64,
                      n_groups=1, chunk=256),
        rope_theta=10_000.0,
        tie_embeddings=True, max_seq_len=1_048_576,
    )

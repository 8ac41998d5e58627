"""mamba2-370m [ssm]: 48L d_model=1024, attention-free SSD, vocab=50280,
ssm_state=128. [arXiv:2405.21060]"""
from repro_torch.configs.base import MIXER_SSM, ModelConfig, SSMConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="mamba2-370m", family="ssm",
        n_layers=48, d_model=1024, n_heads=1, n_kv_heads=1, head_dim=64,
        d_ff=0, vocab_size=50280,
        pattern=(MIXER_SSM,),
        ssm=SSMConfig(d_state=128, d_conv=4, expand=2, head_dim=64,
                      n_groups=1, chunk=256),
        tie_embeddings=True, max_seq_len=1_048_576,
    )

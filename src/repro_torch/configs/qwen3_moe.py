"""qwen3-moe-30b-a3b [moe]: 48L d_model=2048 32H (GQA kv=4), 128 experts
top-8 d_expert=768, vocab=151936. [hf:Qwen/Qwen3-30B-A3B]"""
from repro_torch.configs.base import ATTN_GLOBAL, ModelConfig, MoEConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen3-moe-30b-a3b", family="moe",
        n_layers=48, d_model=2048, n_heads=32, n_kv_heads=4, head_dim=128,
        d_ff=768, vocab_size=151936,
        pattern=(ATTN_GLOBAL,),
        moe=MoEConfig(n_experts=128, top_k=8, d_expert=768, n_shared=0,
                      norm_topk=True),
        qk_norm=True, rope_theta=1_000_000.0,
        tie_embeddings=False, max_seq_len=40960,
    )

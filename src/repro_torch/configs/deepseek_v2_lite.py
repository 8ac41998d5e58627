"""deepseek-v2-lite-16b [moe]: 27L d_model=2048 16H, MLA kv_lora=512,
64 routed experts top-6 + 2 shared, d_expert=1408, first layer dense,
vocab=102400. [arXiv:2405.04434]"""
from repro_torch.configs.base import ATTN_GLOBAL, MLAConfig, ModelConfig, MoEConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="deepseek-v2-lite-16b", family="moe",
        n_layers=27, d_model=2048, n_heads=16, n_kv_heads=16, head_dim=128,
        d_ff=10944, vocab_size=102400,
        pattern=(ATTN_GLOBAL,),
        mla=MLAConfig(kv_lora_rank=512, q_lora_rank=0,
                      qk_nope_head_dim=128, qk_rope_head_dim=64,
                      v_head_dim=128),
        moe=MoEConfig(n_experts=64, top_k=6, d_expert=1408, n_shared=2,
                      first_k_dense=1, dense_d_ff=10944, norm_topk=False),
        rope_theta=10_000.0,
        tie_embeddings=False, max_seq_len=32768,
    )

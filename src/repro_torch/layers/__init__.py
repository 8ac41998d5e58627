from repro_torch.layers.attention import (AttnOpts, attn_decode,
                                          attn_decode_paged, attn_forward,
                                          fill_kv_cache, init_attention,
                                          init_kv_cache, init_paged_kv_pool)
from repro_torch.layers.embeddings import embed, init_embedding
from repro_torch.layers.mlp import init_mlp, mlp_forward
from repro_torch.layers.norms import rms_norm, softcap
from repro_torch.layers.rope import apply_rope
from repro_torch.layers.ssm import (SSMOpts, fill_ssm_cache, init_ssm,
                                    init_ssm_cache, ssd_scan, ssm_decode,
                                    ssm_forward)

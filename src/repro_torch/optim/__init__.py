from repro_torch.optim.adamw import (AdamWConfig, adamw_update,
                                     adamw_update_,
                                     clip_by_global_norm, global_norm,
                                     init_opt_state, schedule)
from repro_torch.optim.compress import (compressed_psum, dequantize_int8,
                                        init_residuals, quantize_int8,
                                        wire_bytes_fp32, wire_bytes_int8)

from repro_torch.runtime.paged import PagePoolManager
from repro_torch.runtime.serve import (BatchingEngine, Request,
                                      make_paged_serve_step,
                                      make_prefill_step, make_serve_step)

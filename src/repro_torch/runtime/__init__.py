from repro_torch.runtime.paged import PagePoolManager
from repro_torch.runtime.serve import BatchingEngine, Request

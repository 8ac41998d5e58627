from repro_torch.runtime.events import Event, EventLoop, EventQueue
from repro_torch.runtime.faults import FakeClock, FaultEvent, FaultInjector
from repro_torch.runtime.fleet import GatewayFleet, JournalEntry
from repro_torch.runtime.gateway import ServingGateway, TenantSession
from repro_torch.runtime.paged import PagePoolManager
from repro_torch.runtime.serve import (BatchingEngine, Request,
                                      make_paged_serve_step,
                                      make_prefill_step, make_serve_step)

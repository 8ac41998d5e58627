from repro_torch.runtime.adversary import (BEHAVIORS, CancelChurn,
                                           PageSquat, PrefixProbe,
                                           PromptFlood, ScenarioReport,
                                           run_scenario)
from repro_torch.runtime.events import Event, EventLoop, EventQueue
from repro_torch.runtime.faults import FakeClock, FaultEvent, FaultInjector
from repro_torch.runtime.fleet import GatewayFleet, JournalEntry
from repro_torch.runtime.gateway import ServingGateway, TenantSession
from repro_torch.runtime.loadgen import (Arrival, FleetSpec, SoakMatrix,
                                         TraceSpec, replay_trace, synthesize,
                                         tenant_shares)
from repro_torch.runtime.losses import chunked_xent, full_xent
from repro_torch.runtime.paged import PagePoolManager
from repro_torch.runtime.serve import (BatchingEngine, GreedyLoop,
                                      PrefillProgram, Request,
                                      clear_prefill_programs, jit_serve_step,
                                      make_paged_serve_step,
                                      make_prefill_step, make_serve_step,
                                      prefill_program)
from repro_torch.runtime.train import (TrainOpts, TrainProgram,
                                      dp_train_program, init_train_state,
                                      jit_train_step, make_dp_train_step,
                                      make_inplace_dp_train_step,
                                      make_inplace_train_step, make_loss_fn,
                                      make_train_step, train_program)

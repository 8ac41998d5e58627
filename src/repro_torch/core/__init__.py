"""RC3E core: the paper's primary contribution (hypervisor + vFPGA
virtualization + service models) as the control plane of a PyTorch device."""
from repro_torch.core.device_db import (MAX_SLOTS, DeviceDB, DeviceState,
                                        NoCapacityError, PhysicalDevice,
                                        SliceState, VSlice)
from repro_torch.core.elastic import ElasticController
from repro_torch.core.hypervisor import ClusterSpec, Hypervisor
from repro_torch.core.monitor import Monitor, MonitorConfig
from repro_torch.core.reconfig import (ProgramCache, ProgramEntry,
                                       Reconfigurator, fingerprint)
from repro_torch.core.scheduler import BatchScheduler, Job, JobState
from repro_torch.core.service_models import (BAaaSSession, RAaaSSession,
                                             RSaaSSession)

"""RC2F: the Reconfigurable Cloud Computing Framework dataplane."""
from repro_torch.rc2f.admission import (DEFAULT_QUOTAS, AdmissionController,
                                        AdmissionError, ServiceQuota,
                                        admit_core)
from repro_torch.rc2f.control import ConfigSpace, make_gcs, make_ucs
from repro_torch.rc2f.core_api import CoreSpec, StreamSpec, compile_core
from repro_torch.rc2f.fifo import (H100_HOST_LINK_BYTES_S,
                                   H100_NVLINK_BYTES_S, PCIE_LINK_BYTES_S,
                                   OutputFIFO, SharedLink, StreamFIFO,
                                   core_throughput)
from repro_torch.rc2f.shell import FusedShell, SpatialShell

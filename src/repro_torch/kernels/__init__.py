"""Hand-written CUDA kernels for Hopper (``csrc/``), their plain PyTorch
versions, and device dispatch (``ops``). Importing builds nothing: a kernel
library is compiled at its first launch (see ``_lib``)."""
from repro_torch.kernels import ops
from repro_torch.kernels._lib import launches

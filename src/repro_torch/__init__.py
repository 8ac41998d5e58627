"""PyTorch/CUDA port of the ``repro`` package for NVIDIA Hopper (H100).

The JAX package ``repro`` is the reference; this package mirrors its module
layout and imports nothing of it (nor of JAX). Pure-Python modules
(``configs``, ``analysis.lifecycle``, ``runtime.paged``, most of ``core``
and the quota half of ``rc2f.admission``) are copies; the serving path's
attention kernels and the RAaaS path's streaming matmul are hand-written
CUDA C++ under ``kernels/csrc`` (see ``kernels/ops.py`` for dispatch).
"""

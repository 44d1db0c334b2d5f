"""PyTorch/CUDA port of the cluster-wise SpGEMM system.

The package mirrors the layout of the JAX package ``repro`` module for
module (``core/formats.py``, ``kernels/ops.py``, ``planner/service.py``,
``serve/engine.py`` …) so each module's counterpart is easy to find. It
imports ``torch`` and numpy and nothing of ``repro``: the numpy-only host
stages it needs are its own copies.

Entry points (:class:`repro_torch.planner.service.Planner`,
:class:`repro_torch.serve.engine.SpGEMMServer`) run on the CUDA card
unless the caller passes ``device="cpu"``; asked for a card that is not
there, they raise. The Sp×Sp and SpMM kernels are hand-written CUDA C++
for Hopper (``kernels/csrc/``), compiled with ``nvcc`` at first use.
"""

"""Hand-written Hopper kernels of the port and their plain PyTorch versions.

=====================  =======================================  ===========================
wrapper                replaces (Pallas, ``repro/kernels``)     source
=====================  =======================================  ===========================
``neighbor_kernel``    ``idm.py::neighbor_kernel``              ``csrc/idm.cu``
``idm_accel_kernel``   ``idm.py::idm_accel_kernel``             ``csrc/idm.cu``
``flash_attention``    ``flash_attention.py::flash_attention``  ``csrc/flash_attention.cu``
=====================  =======================================  ===========================

The plain versions live in :mod:`repro_torch.kernels.ref`; the build in
:mod:`repro_torch.kernels.build`. ``rglru_linear_scan`` and ``wkv6`` are
not ported yet: no model path of the reference reaches them (ROADMAP
queue 2).
"""

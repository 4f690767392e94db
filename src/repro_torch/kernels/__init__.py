"""Hand-written Hopper kernels of the port and their plain PyTorch versions.

=======================  =======================================  ===========================
wrapper                  replaces (Pallas, ``repro/kernels``)     source
=======================  =======================================  ===========================
``neighbor_kernel``      ``idm.py::neighbor_kernel``              ``csrc/idm.cu``
``idm_accel_kernel``     ``idm.py::idm_accel_kernel``             ``csrc/idm.cu``
``flash_attention``      ``flash_attention.py::flash_attention``  ``csrc/flash_attention.cu``
``rglru_linear_scan``    ``rglru.py::rglru_linear_scan``          ``csrc/rglru.cu``
``wkv6``                 ``rwkv6.py::wkv6``                       ``csrc/wkv6.cu``
=======================  =======================================  ===========================

Each wrapper lives in the module of the same name as the Pallas kernel's
(``idm``, ``flash_attention``, ``rglru``, ``rwkv6``) with a ``launches``
dict and ``reset_launches()``. The plain versions live in
:mod:`repro_torch.kernels.ref`; the build in :mod:`repro_torch.kernels.build`.
"""

"""Hand-written Hopper kernels of the port and their plain PyTorch versions.

=====================  =======================================  ===========================  ===========================================
wrapper                replaces (Pallas, ``repro/kernels``)     source                       on the card
=====================  =======================================  ===========================  ===========================================
``neighbor_kernel``    ``idm.py::neighbor_kernel``              ``csrc/idm.cu``              sort and search; all-pairs past 8192 slots
``idm_accel_kernel``   ``idm.py::idm_accel_kernel``             ``csrc/idm.cu``              sort and search; all-pairs past 8192 slots
``flash_attention``    ``flash_attention.py::flash_attention``  ``csrc/flash_attention.cu``  bf16 wgmma + TMA; f32 on CUDA cores
``rglru_linear_scan``  ``rglru.py::rglru_linear_scan``          ``csrc/rglru.cu``            64-step chunks, decoupled look-back
``wkv6``               ``rwkv6.py::wkv6``                       ``csrc/wkv6.cu``             chunkwise, 3xTF32, decoupled look-back
=====================  =======================================  ===========================  ===========================================

The two sweep kernels share one design: up to 8192 slots one block an
instance sorts its (lane, position) keys and searches them; past that an
all-pairs kernel answers. The IDM one is also reachable at any N as
``idm._idm_accel_wide``, the sort form's bit-exact oracle.

Each wrapper lives in the module of the same name as the Pallas kernel's
(``idm``, ``flash_attention``, ``rglru``, ``rwkv6``) with a ``launches``
dict and ``reset_launches()``. The plain versions live in
:mod:`repro_torch.kernels.ref`; the build in :mod:`repro_torch.kernels.build`.
"""

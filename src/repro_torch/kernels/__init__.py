"""Hand-written Hopper kernels of the port and their plain PyTorch versions.

=========================  ==========================================  ==============
wrapper                    replaces (Pallas, ``repro/kernels``)        source
=========================  ==========================================  ==============
``neighbor_kernel``        ``idm.py::neighbor_kernel``                 ``csrc/idm.cu``
``idm_accel_kernel``       ``idm.py::idm_accel_kernel``                ``csrc/idm.cu``
=========================  ==========================================  ==============

The plain versions live in :mod:`repro_torch.kernels.ref`; the build in
:mod:`repro_torch.kernels.build`. ``flash_attention``, ``rglru_linear_scan``
and ``wkv6`` belong to the LM stack and are not ported yet.
"""

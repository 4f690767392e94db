"""Core of the port: PRNG, neighborhood engine, scenarios, simulator, sweep.

Modules mirror ``repro/core``: :mod:`~repro_torch.core.prng`,
:mod:`~repro_torch.core.neighbors`, :mod:`~repro_torch.core.scenario`,
:mod:`~repro_torch.core.scenarios`, :mod:`~repro_torch.core.simulator`,
:mod:`~repro_torch.core.sweep` and :mod:`~repro_torch.core.aggregate`.
"""

"""Core of the port: PRNG, neighborhood engine, scenarios, simulator, sweep,
recording, faults and fleet supervision.

Modules mirror ``repro/core``: :mod:`~repro_torch.core.prng`,
:mod:`~repro_torch.core.neighbors`, :mod:`~repro_torch.core.scenario`,
:mod:`~repro_torch.core.scenarios`, :mod:`~repro_torch.core.simulator`,
:mod:`~repro_torch.core.sweep`, :mod:`~repro_torch.core.aggregate`,
:mod:`~repro_torch.core.record`, :mod:`~repro_torch.core.tokens`,
:mod:`~repro_torch.core.fault` and :mod:`~repro_torch.core.fleet`.
"""

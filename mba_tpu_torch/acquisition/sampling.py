"""Dynamometer calibration (a host copy of part of
``mba_tpu/acquisition/sampling.py``).

Holds only :func:`dynamometer_volt_to_force` (``sampling.py:32``), which
the enriched serial frame needs for its %MVC force.  The sampling
processes and the accuracy sampler drive hardware (ROADMAP A10).
"""
from __future__ import annotations

DYNAMOMETER_COEFF = 2.2
DYNAMOMETER_EXPONENT = 4.1071


def dynamometer_volt_to_force(volts: float, offset: float = 0.0,
                              mvc_kg: float | None = None) -> float:
    """Fitted power-law dynamometer calibration (reference :213-219).

    Returns kg, or %MVC when ``mvc_kg`` is given.
    """
    force_kg = DYNAMOMETER_COEFF * (volts ** DYNAMOMETER_EXPONENT) + offset
    if mvc_kg is not None and mvc_kg > 0:
        return 100.0 * force_kg / mvc_kg
    return force_kg

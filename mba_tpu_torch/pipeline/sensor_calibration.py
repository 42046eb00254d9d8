"""Dynamometer calibration: power-law fit of force vs voltage (a host copy
of ``mba_tpu/pipeline/sensor_calibration.py``).

Parity target: reference ``src/pipeline/sensor_calibration.py`` — guided
2.5–40 kg holds sampled over serial (:124-159), ``scipy.optimize.curve_fit``
power law F = a·V^b (:167-177; the study's fit was F = 2.8708·V^4.1071),
and an RMSE check (:180-186).
"""
from __future__ import annotations

import time

import numpy as np
from scipy.optimize import curve_fit

CALIBRATION_WEIGHTS_KG = [2.5, 5.0, 10.0, 20.0, 30.0, 40.0]


def power_law(volts, a, b):
    return a * np.asarray(volts, float) ** b


def fit_power_law(volts: np.ndarray, forces_kg: np.ndarray,
                  p0=(2.0, 4.0)) -> tuple[float, float]:
    """Fit F = a·V^b; returns (a, b)."""
    popt, _ = curve_fit(power_law, np.asarray(volts, float),
                        np.asarray(forces_kg, float), p0=p0,
                        maxfev=20000)
    return float(popt[0]), float(popt[1])


def calibration_rmse(volts, forces_kg, a, b) -> float:
    pred = power_law(volts, a, b)
    return float(np.sqrt(np.mean((pred - np.asarray(forces_kg)) ** 2)))


def run_calibration_session(shared_dict, weights_kg=None,
                            hold_sec: float = 3.0,
                            poll_hz: float = 50.0,
                            prompt=input) -> dict:
    """Guided calibration: hold each weight, record mean voltage, fit.

    Mirrors the reference script's interactive loop (:124-186) with the
    prompt injected for headless use.
    """
    weights_kg = weights_kg or CALIBRATION_WEIGHTS_KG
    mean_volts = []
    for w in weights_kg:
        prompt(f"Apply {w} kg and press Enter to record "
               f"{hold_sec:.0f}s...")
        t_end = time.monotonic() + hold_sec
        samples = []
        while time.monotonic() < t_end:
            v = shared_dict.get("fsr")
            if v is not None:
                samples.append(v)
            time.sleep(1.0 / poll_hz)
        mean_volts.append(float(np.mean(samples)) if samples
                          else np.nan)
    a, b = fit_power_law(mean_volts, weights_kg)
    rmse = calibration_rmse(mean_volts, weights_kg, a, b)
    print(f"Fitted F = {a:.4f} * V^{b:.4f} (RMSE {rmse:.3f} kg)")
    return {"a": a, "b": b, "rmse_kg": rmse,
            "volts": mean_volts, "weights_kg": list(weights_kg)}

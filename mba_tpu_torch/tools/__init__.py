"""Study synthesis for the port's tests and ``chip_smoke.py``."""

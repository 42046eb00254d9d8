"""Acquisition helpers of the port: only the dynamometer calibration the
serial frame needs (the hardware layer is ROADMAP A10)."""

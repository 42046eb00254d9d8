"""Real-time acquisition & experiment-control subsystem (host-side; a
copy of ``mba_tpu/acquisition``).

The multiprocess sampling loop feeding the shared state and the
triple-tier CSV saves, the dummy (no-hardware) sampler, dynamometer
calibration, the trial accuracy sampler and the event-driven experiment
phase machine, with headless controllers in place of the study's GUI
forms (``acquisition/views.py`` draws them with matplotlib, imported only
when a view is built).  No part of it runs on the card.
"""
from mba_tpu_torch.acquisition.sampling import (  # noqa: F401
    read_serial_measurements, sampling_process, dummy_sampling_process,
    accuracy_sampler, dynamometer_volt_to_force, probe_serial_device,
)
from mba_tpu_torch.acquisition.experiment import (  # noqa: F401
    start_experiment_processes, calibrate_mvc, ExperimentConfig,
)

"""The one generator of recordings, read from a cell's parameters.

A recording is a set of named float32 arrays (samples × channels, or
subjects × samples × channels), unit white noise in every channel plus
a shared drive in a frequency band, at an amplitude, in every channel:
the drive is what couples EEG to EMG.  Parameters (from the cell's
traffic file and its configuration):

- ``sampling_hz``; ``seconds``, or ``trials`` {count, seconds,
  silence_seconds}: a session of trials separated by silences, the
  drive on during the trials only;
- ``arrays``: {name: channels}; ``subjects`` (optional): a leading
  subject axis, the drive shared by every subject;
- ``drive``: {kind, band_hz, amplitude}.  ``filtered_white``: white
  noise with its spectrum cut to the band (``bench.py:55-70``);
  ``random_phase``: unit magnitude and uniform random phase in every
  bin of the band (``bench.py:261-279``).  Either is scaled to unit
  standard deviation before the amplitude.

Everything is drawn on ``device`` from one ``torch.Generator`` seeded
with the run's seed, and copied once, subject by subject, to ordinary
(pageable) host memory that numpy allocates, as ``np.load`` would give
it.
"""
from __future__ import annotations

import numpy as np
import torch


def session_samples(p: dict) -> int:
    fs = p["sampling_hz"]
    if "trials" in p:
        t = p["trials"]
        hop = t["seconds"] + t["silence_seconds"]
        return int(fs * (t["count"] * hop - t["silence_seconds"]))
    return int(fs * p["seconds"])


def trial_starts(p: dict) -> np.ndarray:
    """Start of each trial in seconds (one trial over the whole
    recording where there are none)."""
    if "trials" not in p:
        return np.zeros(1)
    t = p["trials"]
    return np.arange(t["count"]) * (t["seconds"] + t["silence_seconds"])


def _drive(n: int, p: dict, gen: torch.Generator, device) -> torch.Tensor:
    d = p["drive"]
    f = torch.fft.rfftfreq(n, 1.0 / p["sampling_hz"], device=device,
                           dtype=torch.float64)
    band = (f >= d["band_hz"][0]) & (f <= d["band_hz"][1])
    if d["kind"] == "filtered_white":
        spec = torch.fft.rfft(torch.randn(n, generator=gen, device=device,
                                          dtype=torch.float64))
        spec = torch.where(band, spec, 0)
    elif d["kind"] == "random_phase":
        phase = 2 * np.pi * torch.rand(f.shape, generator=gen,
                                       device=device, dtype=torch.float64)
        spec = torch.where(band, torch.polar(torch.ones_like(phase), phase),
                           0)
    else:
        raise ValueError(f"unknown drive kind {d['kind']!r}")
    x = torch.fft.irfft(spec, n=n)
    x = x / (x.std() + 1e-12)
    if "trials" in p:
        on = torch.zeros(n, dtype=torch.bool, device=device)
        fs, secs = p["sampling_hz"], p["trials"]["seconds"]
        for t0 in trial_starts(p):
            on[int(t0 * fs):int((t0 + secs) * fs)] = True
        x = x * on
    return (d["amplitude"] * x).to(torch.float32)


def recording(p: dict, gen: torch.Generator, device) -> dict:
    """{name: host float32 array} for one recording."""
    n = session_samples(p)
    drive = _drive(n, p, gen, device)[:, None]
    lead = (p["subjects"],) if "subjects" in p else ()
    out = {}
    for name, channels in p["arrays"].items():
        x = torch.randn((*lead, n, channels), generator=gen, device=device,
                        dtype=torch.float32)
        x += drive
        # numpy's own allocation (which asks the kernel for huge pages)
        # faults the host pages in far fewer steps than a tensor's
        host = np.empty(tuple(x.shape), np.float32)
        for part, dst in zip(x.reshape(-1, n, channels),
                             host.reshape(-1, n, channels)):
            torch.from_numpy(dst).copy_(part)
        out[name] = host
        del x
    return out

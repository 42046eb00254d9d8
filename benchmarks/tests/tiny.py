"""Small sizes of each configuration and entry, for runs on the CPU."""

TINY = {
    "config": {
        "subject64": {"sampling_hz": 256, "recording_seconds": 12},
        "cohort12": {"sampling_hz": 256, "subjects": 3,
                     "trials": {"count": 3, "seconds": 6.0,
                                "silence_seconds": 2.0},
                     "surrogates": 200, "surrogate_chunk": 100},
    },
    "traffic": {
        "multitaper_msc": {"recording": {"arrays": {"eeg": 4, "emg": 3}}},
        "rotation_null": {"recording": {"arrays": {"eeg": 4, "emg": 3}}},
    },
}


def tiny(catalog, cell: str) -> dict:
    """The overrides that run ``cell`` small."""
    traffic = catalog.traffic(cell)
    return {"config": TINY["config"][traffic["config"]],
            "traffic": TINY["traffic"][traffic["entry"]]}

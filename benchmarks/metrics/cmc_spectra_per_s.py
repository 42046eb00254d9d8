"""cmc_spectra_per_s: coherence spectra completed per second,
in millions: every call's active windows × EEG × EMG channels, over the
window."""


def read(run):
    spectra = run["units"].get("spectra")
    if spectra is None or not run["calls"]:
        return None
    return spectra * len(run["calls"]) / run["window_s"] / 1e6

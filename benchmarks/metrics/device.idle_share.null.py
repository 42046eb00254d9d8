"""device.idle_share.null: 100 × (1 − the union of the device's
kernel, memcpy and memset intervals over the traced window)."""


def read(run):
    share = (run["trace"] or {}).get("idle_share")
    return None if share is None else 100.0 * share

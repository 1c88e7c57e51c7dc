"""filter_roofline_pct: the least time the card could take for a call's
work (the larger of its int32 operations over PEAK_INT32_S and its bytes
over PEAK_BYTES_S, counted from shapes by `benchmark.work`) over the device
kernel time a call in the traced stretch, in percent."""

from benchmark.peaks import least_seconds


def read(obs):
    tr, work = obs.get("trace"), obs.get("work")
    if not tr or not work or not tr["calls"] or tr["kernel_s"] <= 0:
        return None
    return 100.0 * least_seconds(*work) * tr["calls"] / tr["kernel_s"]

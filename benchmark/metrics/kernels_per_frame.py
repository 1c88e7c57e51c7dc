"""kernels_per_frame: device kernels the profiler counted in the traced
stretch, over the output frames of its calls."""


def read(obs):
    tr = obs.get("trace")
    if not tr or not tr.get("frames"):
        return None
    return tr["kernels"] / tr["frames"]

"""frames_per_s: output frames completed in the window over its seconds
(host clock; the window ends with the synchronize of its last call)."""


def read(obs):
    if "call_s" not in obs or obs["window_s"] <= 0:
        return None
    return obs["frames"] / obs["window_s"]

"""stream_frames_per_s: output frames the CLI delivered on its standard
output inside the window, over the window's seconds."""


def read(obs):
    if "stream_frames" not in obs or obs["window_s"] <= 0:
        return None
    return obs["stream_frames"] / obs["window_s"]

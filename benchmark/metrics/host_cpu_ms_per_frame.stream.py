"""host_cpu_ms_per_frame.stream: the CLI process's user plus system CPU
time over the window (from /proc/<pid>/stat), per output frame delivered
in it, in ms."""


def read(obs):
    if not obs.get("stream_frames") or "cpu_s" not in obs:
        return None
    return 1e3 * obs["cpu_s"] / obs["stream_frames"]

"""device_idle_pct.stream: `device_idle_pct` in the CLI's process, over a
stretch of the stream's window."""

from benchmark.trace import idle_pct


def read(obs):
    return idle_pct(obs.get("trace"))

"""device_idle_pct: 100 x (1 - the union of the card's kernel, memcpy and
memset intervals over the traced stretch's wall time), in the process that
calls the entry."""

from benchmark.trace import idle_pct


def read(obs):
    return idle_pct(obs.get("trace"))

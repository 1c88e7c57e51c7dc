"""call_ms_p95: the 95th percentile (nearest rank) of every call of the
window, from its start to the end of its synchronize, in ms."""

import math


def read(obs):
    calls = sorted(obs.get("call_s", ()))
    if not calls:
        return None
    return calls[math.ceil(0.95 * len(calls)) - 1] * 1e3

"""call_ms_p95.compat: the 95th percentile (nearest rank) of the calls of
a traced run outside its profiled stretch, from a call's start to the end
of its synchronize, in ms.  ``call_ms_p95`` per layer, where a host-bound
call's tail swings too much from process to process for a bound."""

import math


def read(obs):
    calls = sorted(obs.get("quiet_call_s", ()))
    if not calls:
        return None
    return calls[math.ceil(0.95 * len(calls)) - 1] * 1e3

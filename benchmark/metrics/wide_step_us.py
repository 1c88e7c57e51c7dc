"""wide_step_us: the device time a serial row step of K4
(``shard_full_kernel``), the field kernel's wide route: over the traced
stretch, the summed device time of the kernels whose launch call lies
inside a `sangnom/launch` span of that kernel, over the summed ``steps``
those spans count, in microseconds.  The driver `api_call_launches`
attributes each kernel to its launch span by the launch call's correlation
id; a program whose K4 launch spans count no steps gives nothing."""

from benchmark.drivers.api_call_launches import step_us


def read(obs):
    return step_us(obs, "shard_full_kernel")

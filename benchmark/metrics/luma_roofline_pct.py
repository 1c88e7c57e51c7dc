"""luma_roofline_pct: the least time the card could take for a call's work
on the luma plane (its bytes and int32 operations, counted from its shape
by `benchmark.work.main`, over `benchmark.peaks`) over the device time a
call of the kernels issued inside the luma plane's `sangnom/plane` span,
in percent.  The driver `api_call_planes` attributes each kernel of the
traced stretch to its plane span by its launch call's correlation id."""

from benchmark.drivers.api_call_planes import group_roofline_pct


def read(obs):
    return group_roofline_pct(obs, "0")

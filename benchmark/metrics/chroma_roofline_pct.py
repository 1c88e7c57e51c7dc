"""chroma_roofline_pct: `luma_roofline_pct` for U and V, which one launch
walks together inside the "uv" `sangnom/plane` span: the least time of
their work a call over the device time a call of the kernels attributed to
that span, in percent."""

from benchmark.drivers.api_call_planes import group_roofline_pct


def read(obs):
    return group_roofline_pct(obs, "uv")

"""sangnom_tpu_torch: the SangNom2 filter framework on PyTorch and CUDA.

The PyTorch port of `sangnom_tpu`, with the same public surface: an
edge-directed single-field deinterlacer / anti-aliaser (the SangNom2
AviSynth plugin, Asd-g/AviSynth-SangNom2 v0.6.1).  Planes are torch tensors
on an explicit device.  On an NVIDIA Hopper GPU the field interpolation runs
in a hand-written CUDA kernel (``csrc/deint.cu``), and the shared-pool mode
(``pool_compat=True``) in ``csrc/pool.cu``; on the CPU a plain PyTorch path
computes the same bits.

    sangnom2(clip, order=1, aa=48, aac=0, threads=0, dh=False, luma=True,
             chroma=True, opt=-1, pool_compat=False, numerics="c") -> Clip
    sangnom(clip, order=1, aa=48, opt=-1, pool_compat=False,
            numerics="c") -> Clip                          # legacy wrapper
"""

__version__ = "0.5.0"

# Version of the reference plugin whose capability surface is replicated.
REFERENCE_VERSION = "0.6.1"

from sangnom_tpu_torch.core.formats import VideoFormat, get_format, FORMATS  # noqa: E402
from sangnom_tpu_torch.core.clip import Clip  # noqa: E402
from sangnom_tpu_torch.core.fields import (  # noqa: E402
    bob,
    double_weave,
    separate_fields,
    weave,
)
from sangnom_tpu_torch.api import (  # noqa: E402
    SangNom2Filter,
    register_plugin_functions,
    sangnom,
    sangnom2,
)

__all__ = [
    "Clip",
    "VideoFormat",
    "get_format",
    "FORMATS",
    "sangnom2",
    "sangnom",
    "SangNom2Filter",
    "bob",
    "separate_fields",
    "double_weave",
    "weave",
    "register_plugin_functions",
    "__version__",
    "REFERENCE_VERSION",
]

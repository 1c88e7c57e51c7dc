"""Host-environment adapters.

The reference is a plugin inside a scripting host (AviSynth,
reference src/SangNom2.cpp:474-484 registers `SangNom2`/`SangNom` into the
host's function table).  This package provides the same integration for
hosts this framework can reach, each running the filter on a ``device``
("cuda" unless the caller asks for another):

  * `sangnom_tpu_torch.hosts.vapoursynth` — a VapourSynth adapter exposing
    the filter as dimension-aware `std.ModifyFrame` graph nodes.
  * `sangnom_tpu_torch.hosts.avisynth` — the reference's OWN host contract
    as a Python protocol: verbatim AddFunction signature strings, AVSValue
    binding, Create_ factories erroring through env.throw_error,
    GetFrame/GetParity serving, SetCacheHints MT contract
    (src/SangNom2.cpp:399-484, src/SangNom2.h:61-66).
  * `sangnom_tpu_torch.hosts.avs_script` — evaluates AviSynth script TEXT
    (the plugin's usage subset: implicit `last`, OOP chaining, named args)
    against a ScriptEnvironment, so existing .avs recipe lines run
    unmodified.
  * `sangnom_tpu_torch.hosts.window` — the shared host-agnostic windowed
    batching runner both adapters serve frames through.
  * the in-process CLI host (`sangnom_tpu_torch.cli`) and the plain
    registry surface (`sangnom_tpu_torch.api.register_plugin_functions`).
"""

"""Drive the filter through the reference plugin's OWN host contract.

`hosts/avisynth.py` reimplements the AviSynth plugin ABI the reference
ships against (reference src/SangNom2.cpp:399-484): function registration
with typed signature strings, AVSValue positional/named argument binding,
factory validation through env.throw_error, and pull-model frame serving
(GetFrame / GetParity / SetCacheHints).  An AviSynth-minded caller keeps
their mental model; the frames come off ``--device`` in windowed batches.

    python -m sangnom_tpu_torch.examples.avisynth_host in.y4m out.y4m
"""

import argparse

import numpy as np

from sangnom_tpu_torch import Clip
from sangnom_tpu_torch.hosts.avisynth import (CACHE_GET_MTMODE, ArraySource,
                                              ScriptEnvironment,
                                              avisynth_plugin_init)
from sangnom_tpu_torch.io import read_y4m, write_y4m


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("input")
    p.add_argument("output")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    env = ScriptEnvironment(device=args.device)
    print("plugin id:", avisynth_plugin_init(env))  # "SangNom2", as AvisynthPluginInit3 returns

    # the source frames stay on the host, as an AviSynth source's do
    clip = read_y4m(args.input, device="cpu")
    src = ArraySource([p.numpy() for p in clip.planes], clip.format,
                      parity=clip.get_parity(0))

    # a script line like SangNom2(order=1, aa=48, dh=true) — names are
    # case-insensitive, defaults fill unset slots, validation errors carry
    # the reference's exact strings through env.throw_error
    flt = env.invoke("SangNom2", src, order=1, AA=48, dh=True)
    print("MT mode:", flt.set_cache_hints(CACHE_GET_MTMODE, 0),
          "(2 = MT_MULTI_INSTANCE, the reference's answer)")

    vi = flt.get_video_info()
    frames = [flt.get_frame(n, env) for n in range(vi.num_frames)]
    planes = [np.stack([fr.planes[i] for fr in frames])
              for i in range(vi.num_components())]
    write_y4m(args.output, Clip.from_numpy(planes, vi.format, device="cpu"))
    print(f"wrote {vi.num_frames} frames at {vi.width}x{vi.height}")


if __name__ == "__main__":
    main()

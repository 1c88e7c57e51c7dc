"""setup_s: seconds from the harness's start until the window opens
(imports, CUDA context, the kernel library's load or build, the inputs,
the warm calls or warm-up frames)."""


def read(obs):
    return obs.get("setup_s")

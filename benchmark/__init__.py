"""The benchmark of sangnom_tpu_torch on an NVIDIA H100: cells of a
configuration under a traffic mix, driven through the program's public
entries, timed on the host's clock, traced with torch.profiler, and judged
against a plain reference (`benchmark.reference`).  Entry point:
``python3 -m benchmark.run``."""

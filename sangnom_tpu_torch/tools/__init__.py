"""Probes of the cost-model path: op-class rate calibration (K8), the
step-isolation arms (K9) and the dynamic-row probe (K10), each a CUDA kernel
in ``csrc/probes.cu`` (bound by ``tools.probe_kernel``) with a plain PyTorch
version beside it."""

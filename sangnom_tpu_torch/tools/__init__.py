"""Tools of the port.

The cost-model probes: op-class rate calibration (K8), the step-isolation
arms (K9) and the dynamic-row probe (K10), each a CUDA kernel in
``csrc/probes.cu`` (bound by ``tools.probe_kernel``) with a plain PyTorch
version beside it; ``sass_mix`` and the A/B timers (``deint_ab``,
``pool_ab``, ``shard_ab``, ``probe_ab`` on ``ab``).

The verification and streaming tools, over the public API:
- ``parity_campaign``: the kernels at API level on the card against the
  native oracle and the plain path (the fixed set, ``--random``,
  ``--compat``, ``--bob``, ``--sharded``), case for case as the TPU
  campaign recorded them;
- ``parity_campaign_cpu``: the plain path on the CPU against the oracle
  over random configs, with a compat arm;
- ``stream_soak``: a long clip through the CLI whole and windowed, byte
  identity and peak RSS;
- ``stream_attr``: the rate of each stage of the CLI's windowed pipeline,
  and the CLI end to end with the writer overlap off and on.
"""

"""Runnable examples of the port's API, I/O, hosts and ``parallel``, each
the counterpart of a script of the repository's ``examples/``.  Each takes
``--device`` (default "cuda")::

    python -m sangnom_tpu_torch.examples.deinterlace_file in.y4m out.y4m
    python -m sangnom_tpu_torch.examples.sharded_batch --device cpu
"""

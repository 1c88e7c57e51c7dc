"""The CLI's process (`benchmark.drivers.cli_child`) with a fault planted
in the program's entry:

    python3 -m benchmark.tests.faulty_child FAULT --result-fd W -- <CLI arguments>
"""

from __future__ import annotations

import sys

import sangnom_tpu_torch as snt
from benchmark.drivers import cli_child
from benchmark.tests import faults

if __name__ == "__main__":
    fault = sys.argv.pop(1)
    snt.bob = faults.broken(snt.bob, "bob", fault)
    sys.exit(cli_child.main())

"""Instruction mix of the calibration's integer arms, read from their SASS.

Compiles ``csrc/probes.cu`` with the library's flags to a cubin for sm_90a,
disassembles it with ``cuobjdump -sass`` and, for each named arm of
``line_kernel`` (K8's integer and shift arms), prints the opcodes of its
innermost loops: the instructions between a backward branch and its target.
Integer adds that the compiler issues as ``IMAD.IADD`` or moves as
``IMAD.MOV`` go to the FMA pipe; ``IADD3``, ``LOP3`` and the min/max
instructions to the integer ALU pipe.  It needs nvcc and cuobjdump, not a
card::

    python -m sangnom_tpu_torch.tools.sass_mix add mul min where shift_and mix

A rolling arm's loop shows its shuffles (``SHFL``) and, on a line of
several warps, one ``BAR`` with the edge values' few ``STS``/``LDS``.
"""

from __future__ import annotations

import re
import subprocess
import sys
from collections import Counter
from pathlib import Path

from sangnom_tpu_torch.tools.probe_kernel import CALIBRATE_CODES

DEFAULT_ARMS = ("add", "mul", "min", "where", "shift_and", "mix")

_FUNC = re.compile(r"Function : (\S+)")
_INSN = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P[T0-9]\s+)?([A-Z][A-Z0-9_.]*)([^;]*);")
_TARGET = re.compile(r"0x([0-9a-f]+)")


def functions(sass: str) -> dict[str, list[tuple[int, str, str]]]:
    """cuobjdump -sass text -> {mangled name: [(address, opcode, operands)]}."""
    out: dict[str, list[tuple[int, str, str]]] = {}
    body = None
    for line in sass.splitlines():
        m = _FUNC.search(line)
        if m:
            body = out.setdefault(m.group(1), [])
            continue
        m = _INSN.search(line)
        if m and body is not None:
            body.append((int(m.group(1), 16), m.group(2), m.group(3).strip()))
    return out


def innermost_loops(body: list[tuple[int, str, str]]) -> list[list[str]]:
    """Opcodes of each loop (a backward BRA and its target) that holds no
    other loop, in address order."""
    spans = []
    for addr, op, args in body:
        m = _TARGET.search(args)
        if op.startswith("BRA") and m and int(m.group(1), 16) <= addr:
            spans.append((int(m.group(1), 16), addr))
    inner = [s for s in spans
             if not any(o != s and s[0] <= o[0] and o[1] <= s[1] for o in spans)]
    return [[op for addr, op, _ in body if lo <= addr <= hi] for lo, hi in sorted(inner)]


def arm_loops(sass: str, arm: str) -> list[list[str]]:
    """Innermost loops of line_kernel<arm> (or <arm, C>, where the kernel
    takes its columns a thread as a second template argument)."""
    tag = re.compile(rf"line_kernelILi{CALIBRATE_CODES[arm]}E(?:Li\d+E)?E")
    for name, body in functions(sass).items():
        if tag.search(name):
            return innermost_loops(body)
    raise KeyError(f"line_kernel for arm {arm!r} not in the SASS")


def disassemble() -> str:
    """SASS of csrc/probes.cu, compiled as the library compiles it."""
    from sangnom_tpu_torch.ops import deint_kernel as dk

    nvcc = Path(dk._nvcc())
    cubin = dk._BUILD_DIR / "probes.sass_mix.cubin"
    dk._BUILD_DIR.mkdir(exist_ok=True)
    flags = [f for f in dk.NVCC_FLAGS if f not in ("-Xcompiler", "-fPIC")]
    subprocess.run([str(nvcc), *flags, "-cubin", str(dk._SRC_DIR / "probes.cu"),
                    "-o", str(cubin)], check=True, capture_output=True, text=True)
    try:
        return subprocess.run([str(nvcc.with_name("cuobjdump")), "-sass", str(cubin)],
                              check=True, capture_output=True, text=True).stdout
    finally:
        cubin.unlink(missing_ok=True)


def main(argv: list[str] | None = None) -> int:
    arms = (argv if argv is not None else sys.argv[1:]) or list(DEFAULT_ARMS)
    sass = disassemble()
    for arm in arms:
        for i, ops in enumerate(arm_loops(sass, arm)):
            mix = Counter(ops)
            fma = sum(n for op, n in mix.items() if op.startswith("IMAD"))
            print(f"{arm:10s} loop {i}: {len(ops)} instructions, {fma} on the FMA pipe "
                  f"(IMAD*): " + ", ".join(f"{op} {n}" for op, n in mix.most_common()),
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

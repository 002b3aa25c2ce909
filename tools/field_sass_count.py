"""Count csrc/field_fold.cu's field-arithmetic instructions per MAC, by pipe.

Reads the SASS of the built library and, for each instance of
``field_fold_kernel``, finds its hottest loop (the backward branch whose body
holds the most 64-bit loads and no other loop: nvcc's unrolled j loop) and counts the
instructions of that body that do the mod-(2^64 - 1) multiply-accumulate:

- FMA pipe: ``IMAD``, ``IMAD.WIDE.U32``, ``IMAD.X``, ``IMAD.IADD`` (the
  partial products of the 128-bit product and the carries folded through it);
- integer pipe: ``IADD3``, ``ISETP``, ``SEL``, ``LOP3`` (the carry adds and the
  compare/select of the carry fold).

Left out, as kernel 1's count leaves them out: loads, instructions that write a
load's address register (``IMAD.WIDE R, R, 0x8, R`` strides, pointer
``IADD3``/``IADD3.X``), register copies (``IMAD.MOV``), and loop control
(``VIADD``, ``ISETP.NE``/``.GT``/``.LT`` and the like, ``PLOP3``, ``BRA``).
A MAC loads one word of A and one of B, so MACs = loads / 2.

Run it on the card, where ``cuobjdump`` is:

    cuobjdump -sass build/torch_kernels/libfield_fold-*.so | python tools/field_sass_count.py

It prints one line per instance: MACs in the body, each pipe's count and its
count per MAC, and which pipe bounds.
"""

from __future__ import annotations

import re
import sys

FUNC = re.compile(r"Function : (\S+)")
INSN = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(@!?P\d\s+)?([A-Z0-9_.]+)\s*([^;]*);")
ADDR = re.compile(r"\[(R\d+)\.64")
BRA = re.compile(r"BRA\s+0x([0-9a-f]+)")

FMA_OPS = ("IMAD", "IMAD.WIDE", "IMAD.WIDE.U32", "IMAD.WIDE.U32.X", "IMAD.X", "IMAD.IADD", "IMAD.HI.U32")
FIELD_COMPARES = ("ISETP.GE.U32.AND", "ISETP.GE.U32.AND.EX", "ISETP.LT.U32.AND",
                  "ISETP.LT.U32.AND.EX", "ISETP.GT.U32.AND", "ISETP.GT.U32.AND.EX")


def _functions(text: str):
    name, body = None, []
    for line in text.splitlines():
        m = FUNC.search(line)
        if m:
            if name:
                yield name, body
            name, body = m.group(1), []
            continue
        m = INSN.search(line)
        if m and name:
            body.append((int(m.group(1), 16), m.group(3), m.group(4).strip()))
    if name:
        yield name, body


def _back_branch(insn) -> bool:
    addr, op, args = insn
    m = BRA.search(f"{op} {args}")
    return bool(m) and int(m.group(1), 16) < addr


def _hot_loop(body):
    best = None
    for i, (addr, op, args) in enumerate(body):
        m = BRA.search(f"{op} {args}")
        if not m or int(m.group(1), 16) >= addr:
            continue
        start = int(m.group(1), 16)
        loop = [x for x in body if start <= x[0] <= addr]
        if any(_back_branch(x) for x in loop[:-1]):
            continue  # an outer loop: keep to innermost ones
        loads = sum(1 for x in loop if x[1].startswith("LDG"))
        if best is None or loads > best[0]:
            best = (loads, loop)
    return best


def _regs(text: str) -> set[str]:
    return set(re.findall(r"\bR\d+\b", text))


def _dests(op: str, args: str) -> set[str]:
    first = args.split(",")[0].strip()
    if op.startswith(("ISETP", "PLOP3", "BRA")) or not re.fullmatch(r"R\d+", first):
        return set()
    n = int(first[1:])
    return {first, f"R{n + 1}"} if ".WIDE" in op or ".64" in op else {first}


def _reads(op: str, args: str) -> set[str]:
    if op.startswith("LDG"):
        return {r for a in ADDR.findall(args) for r in (a, f"R{int(a[1:]) + 1}")}
    return _regs(",".join(args.split(",")[1:]))


def _address_ops(loop) -> set[int]:
    """Positions in the loop whose results only ever feed load addresses.

    The greatest fixpoint: start from every instruction with a register
    result and drop one whose result (read before it is written again,
    around the loop) reaches anything but a load's address or another
    member, so a pointer that steps itself each trip stays in."""
    n = len(loop)
    readers = {}
    for i, (_, op, args) in enumerate(loop):
        found = []
        for d in _dests(op, args):
            for s in range(1, n + 1):
                j = (i + s) % n
                _, op2, args2 = loop[j]
                if d in _reads(op2, args2):
                    found.append(j)
                if d in _dests(op2, args2):
                    break
        readers[i] = found
    member = {i for i in readers if readers[i] and not loop[i][1].startswith("LDG")}
    changed = True
    while changed:
        changed = False
        for i in sorted(member):
            if any(not loop[j][1].startswith("LDG") and j not in member for j in readers[i]):
                member.discard(i)
                changed = True
    return member


def count(body) -> dict:
    loads, loop = _hot_loop(body)
    address = _address_ops(loop)
    fma = alu = 0
    for i, (_, op, args) in enumerate(loop):
        if op.startswith(("LDG", "BRA", "VIADD", "PLOP3", "IMAD.MOV")) or i in address:
            continue
        if op in FMA_OPS:
            fma += 1
        elif op.startswith(("IADD3", "SEL", "LOP3")) or op in FIELD_COMPARES:
            alu += 1
    macs = loads // 2
    return {"macs": macs, "fma": fma, "alu": alu,
            "fma_per_mac": fma / macs, "alu_per_mac": alu / macs,
            "bound_pipe": "fma" if fma >= alu else "integer"}


def main() -> int:
    text = sys.stdin.read()
    found = 0
    for name, body in _functions(text):
        m = re.search(r"field_fold_kernelILb([01])ELb([01])E", name)
        if not m:
            continue
        found += 1
        c = count(body)
        print(f"SMALL={m.group(1)} SCATTER={m.group(2)}: {c['macs']} MACs a trip, "
              f"FMA pipe {c['fma']} ({c['fma_per_mac']:.4f} a MAC), integer pipe "
              f"{c['alu']} ({c['alu_per_mac']:.4f} a MAC), bound by the {c['bound_pipe']} pipe")
    return 0 if found else 1


if __name__ == "__main__":
    sys.exit(main())

"""tools/field_sass_count.py: the per-MAC instruction count behind F1/F3's
bound (chip_smoke's FIELD_OPS_PER_MAC) keeps only field arithmetic.

A synthetic SASS listing in cuobjdump's layout: an outer loop around an
unrolled inner loop of two MACs, with a B-pointer stride, a register copy,
an A-pointer increment and loop control beside the arithmetic."""

import importlib.util
import os

import pytest

_PATH = os.path.join(os.path.dirname(__file__), os.pardir, "tools", "field_sass_count.py")
_spec = importlib.util.spec_from_file_location("field_sass_count", _PATH)
fsc = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(fsc)

_BODY = [
    "IMAD.MOV.U32 R2, RZ, RZ, 0x4",                    # outer set-up
    "LDG.E.64.CONSTANT R18, desc[UR12][R14.64]",      # inner loop starts here (0x20)
    "LDG.E.64.CONSTANT R30, desc[UR12][R10.64]",
    "IMAD.WIDE R14, R24, 0x8, R14",                    # B stride: address
    "IMAD.WIDE.U32 R16, R31, R18, RZ",                 # field arithmetic from here
    "IMAD.MOV.U32 R12, RZ, RZ, R17",                   # copy: left out
    "IMAD.WIDE.U32.X R12, R31, R19, R12, P3",
    "IADD3 R27, P3, R27, R16, RZ",
    "ISETP.GE.U32.AND P0, PT, R27, R16, PT",
    "SEL R13, RZ, 0x1, P0",
    "LDG.E.64.CONSTANT R20, desc[UR12][R14.64]",
    "LDG.E.64.CONSTANT R22, desc[UR12][R10.64+0x8]",
    "IMAD.WIDE R14, R24, 0x8, R14",                    # B stride: address
    "IMAD R17, R21, R22, RZ",
    "IMAD.X R28, R28, 0x1, R17, P3",
    "IADD3 R27, P4, R27, R13, RZ",
    "ISETP.GE.U32.AND.EX P0, PT, R28, R17, PT, P0",
    "VIADD R2, R2, 0xfffffffe",                        # loop control
    "ISETP.NE.AND P1, PT, R2, RZ, PT",
    "IADD3 R10, P4, R10, 0x10, RZ",                    # A pointer: address
    "IADD3.X R11, RZ, R11, RZ, P4, !PT",
    "@P1 BRA 0x10",                                    # inner back branch
    "@!P2 BRA 0x0",                                    # outer back branch
]


def _listing(name: str) -> str:
    lines = [f"\t\tFunction : {name}"]
    for i, insn in enumerate(_BODY):
        lines.append(f"        /*{i * 16:04x}*/                   {insn} ;   /* 0x0000 */")
        lines.append("                                                   /* 0x0000 */")
    return "\n".join(lines) + "\n"


def test_counts_only_the_field_arithmetic_of_the_innermost_loop():
    (name, body), = fsc._functions(_listing("_Z17field_fold_kernelILb0ELb0EEv"))
    c = fsc.count(body)
    assert c["macs"] == 2
    # FMA pipe: IMAD.WIDE.U32, IMAD.WIDE.U32.X, IMAD, IMAD.X
    # integer pipe: IADD3 x2, ISETP.GE x2, SEL
    assert (c["fma"], c["alu"]) == (4, 5)
    assert c["bound_pipe"] == "integer"
    assert c["alu_per_mac"] == pytest.approx(2.5)


def test_main_prints_one_line_per_instance(capsys, monkeypatch):
    import io

    text = _listing("_Z17field_fold_kernelILb0ELb1EEv") + _listing("_Z17field_fold_kernelILb1ELb0EEv")
    monkeypatch.setattr("sys.stdin", io.StringIO(text))
    assert fsc.main() == 0
    lines = capsys.readouterr().out.splitlines()
    assert [ln.split(":")[0] for ln in lines] == ["SMALL=0 SCATTER=1", "SMALL=1 SCATTER=0"]
    monkeypatch.setattr("sys.stdin", io.StringIO("no kernels here\n"))
    assert fsc.main() == 1

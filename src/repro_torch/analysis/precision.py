"""Precision-flow pass (PF1xx): dtype-lattice checks over walked cells.

The port of the reference's ``repro.analysis.precision``. Precision is a
per-feature-group property: packed codes live at their assigned widths
until the one sanctioned dequant. These rules catch the ways that
discipline erodes, on the op walk of a cell (``analysis.op_walk``):

  PF101  an op produces a float64/complex128 value — double precision is
         never incidental on the device path. (The port's deliberate
         float64 sums sit inside kernel regions, which the walk does not
         enter.)
  PF102  a narrow quantized dtype is widened to float outside the
         sanctioned dequant modules (``core/packing.py``,
         ``core/quantizer.py``). Narrow = int8/int16/uint8/uint16 always;
         in cells marked *packed* int32/uint32 too, because unpacked codes
         travel as int32 there. A widening is a conversion
         (``_to_copy``, ``copy_``) or an arithmetic op that promotes a
         narrow operand into a float result (torch promotes inside the
         op, where jax inserts a ``convert_element_type``).
  PF103  a uint32 value is widened to float — packed *words* leaking into
         float math decode garbage wherever it happens.
  PF104  integer arithmetic producing int8 (``add``/``sub``/``mul``/
         ``mm``/``bmm``) — wraps at ±127; quantized arithmetic must widen
         (or dequantize) first.

Attribution is by the op's innermost user frame: routing a dequant
through ``core.quantizer`` moves the frame into the sanctioned module.
Frames outside ``src/repro_torch`` (torch's own) are sanctioned.
"""
from __future__ import annotations

from repro_torch.analysis.findings import Finding

#: modules whose frames may widen quantized codes to float.
SANCTIONED_DEQUANT = ("repro_torch/core/quantizer.py",
                      "repro_torch/core/packing.py")

_NARROW_INTS = ("int8", "uint8", "int16", "uint16")
_PACKED_EXTRA = ("int32", "uint32")
_FLOATS = ("float16", "bfloat16", "float32", "float64")
_CONVERTS = frozenset({"_to_copy", "copy_", "copy", "to", "_copy_from"})
_PROMOTING = frozenset({"add", "sub", "mul", "div", "true_divide", "where",
                        "addcmul", "addcdiv", "lerp", "mm", "bmm", "matmul",
                        "maximum", "minimum", "pow"})
_ARITH = frozenset({"add", "sub", "mul", "mm", "bmm", "add_", "sub_",
                    "mul_"})


def _opname(name: str) -> str:
    """``aten.mul.Tensor`` → ``mul``."""
    parts = name.split(".")
    return parts[1] if len(parts) > 1 else name


def _sanctioned(file: str | None) -> bool:
    if file is None:
        return True           # no user frame: torch-internal, not ours
    norm = file.replace("\\", "/")
    if "repro_torch/" not in norm:
        return True
    return any(norm.endswith(s) for s in SANCTIONED_DEQUANT)


def check_precision(walk, where: str, *, packed: bool = False
                    ) -> list[Finding]:
    """PF101–PF104 over one walked cell (an ``OpWalk``).

    ``packed`` marks cells serving from packed/quantized tables: their
    int32-carried codes join the narrow set for PF102."""
    findings = []
    narrow = _NARROW_INTS + (_PACKED_EXTRA if packed else ())
    for item in walk.items:
        if item.kind != "op":
            continue
        name = _opname(item.name)

        for dt in item.out_dtypes:
            if dt in ("float64", "complex128"):
                findings.append(Finding(
                    "PF101", f"op '{item.name}' produces {dt} — double "
                    f"precision is never incidental on this path",
                    where, file=item.file, line=item.line))
                break

        out_float = next((dt for dt in item.out_dtypes if dt in _FLOATS),
                         None)
        if out_float is not None and (name in _CONVERTS
                                      or name in _PROMOTING):
            if name in ("copy_", "copy"):        # copy_(dst, src)
                srcs = item.in_dtypes[1:2]
            elif name in _CONVERTS:
                srcs = item.in_dtypes[:1]
            else:
                srcs = item.in_dtypes
            src = "uint32" if "uint32" in srcs else \
                next((s for s in srcs if s in narrow), None)
            if src == "uint32":
                findings.append(Finding(
                    "PF103", f"uint32 -> {out_float} in '{item.name}': "
                    f"packed words must go through core.packing."
                    f"unpack_codes, never into float math",
                    where, file=item.file, line=item.line))
            elif src is not None and not _sanctioned(item.file):
                findings.append(Finding(
                    "PF102", f"{src} -> {out_float} in '{item.name}' "
                    f"outside the sanctioned dequant modules "
                    f"({', '.join(SANCTIONED_DEQUANT)}) — route through "
                    f"core.quantizer",
                    where, file=item.file, line=item.line))

        if name in _ARITH and item.out_dtypes and \
                item.out_dtypes[0] == "int8":
            findings.append(Finding(
                "PF104", f"int8 '{item.name}' — 8-bit arithmetic wraps at "
                f"±127; widen (or dequantize) before computing",
                where, file=item.file, line=item.line))
    return findings

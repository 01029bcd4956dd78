"""K1, the port's ELL SpMM (``csrc/ell_spmm.cu``): forward and adjoint.

The least an SpMM needs of memory: per real edge its source id and weight
once (8 bytes), the gathered matrix read once and the output written once
(4 bytes a value). Its operations: 2 FLOP per edge and column. Counted from
the shapes, never from the ELL layout's pad slots, virtual rows or split
flags, so the same work is counted whatever implements it (the byte count
of ``chip_smoke.py::_rect_spmm_bound`` without the layout's row ids and
split flags).
"""

PATTERN = r"ell_spmm_kernel"


def work(op):
    """(bytes, FLOPs) of one operation of the step, None if not an SpMM."""
    if op.kind != "spmm":
        return None
    return (op.cols + op.rows) * op.f * 4 + op.edges * 8, 2 * op.edges * op.f

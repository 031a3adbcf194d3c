"""The ssw kernel's share of its int32 roofline over the window's jobs,
counted as ssw_roofline.post_asm counts it (that file's hooks() and
read()): the DP cells of every call, from the length tensors handed to
ops/ssw.py::_sw_ends_cuda, x SSW_OPS_PER_CELL over the card's int32 rate,
over the calls' device time (a CUDA event pair around each call of the C
entry)."""

import importlib.util
import os

_spec = importlib.util.spec_from_file_location(
    "benchmark.metrics.ssw_roofline__post_asm",
    os.path.join(os.path.dirname(os.path.abspath(__file__)), "ssw_roofline.post_asm.py"))
_count = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_count)

hooks = _count.hooks
read = _count.read

"""The profiler-trace reduction of tools/op_profile.py, fed GPU-shaped input:
kernel events on "/device:GPU:<n>" planes, attributed to plan operators
(qop<idx> scopes) through their HLO-op stat."""

import importlib.util
import os

import pytest

_spec = importlib.util.spec_from_file_location(
    "op_profile", os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "tools", "op_profile.py"))
op_profile = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(op_profile)

OP_OF = {"fusion.1": "qop2_Filter", "sort.3": "qop1_Aggregate"}


def _stream_events():
    return [
        ("fusion_1_kernel", 5000, {"hlo_op": "fusion.1",
                                   "hlo_module": "jit_fn"}),
        ("sort_3", 7000, {"hlo_op": "sort.3"}),
        # not in the HLO map: the scope comes from the op-name stat
        ("loop_gather_fusion", 11000,
         {"hlo_op": "gather.9", "tf_op": "jit(fn)/qop4_Join/gather"}),
        ("memcpy", 2000, {}),
    ]


def test_reduce_gpu_stream_lines():
    planes = [
        ("/host:CPU", [("python", [("fusion.1", 999999, {})])]),
        ("/device:GPU:0", [("Stream #13(Compute)", _stream_events()),
                           ("Launch Stats", [("x", 1, {})])]),
        ("/device:GPU:1", [("Stream #7", [("sort_3", 1000,
                                          {"hlo_op": "sort.3"})])]),
        ("/device:TPU:0", [("XLA Ops", [("fusion.1", 5, {})])]),
    ]
    per_op, per_instr, total = op_profile.reduce_planes(planes, OP_OF)
    assert per_op == {"qop2_Filter": 5000, "qop1_Aggregate": 8000,
                      "qop4_Join": 11000, "(unattributed)": 2000}
    assert per_instr[("qop1_Aggregate", "sort.3")] == 8000
    assert total == 26000


def test_reduce_prefers_xla_ops_line():
    """Where the profiler wrote the derived "XLA Ops" line, the stream lines
    hold the same kernels again and must not count twice."""
    planes = [("/device:GPU:0", [
        ("XLA Ops", [("%fusion.1 = f32[8] fusion(...)", 4000,
                      {"device_duration_ps": 4500})]),
        ("Stream #13", _stream_events()),
    ])]
    per_op, _, total = op_profile.reduce_planes(planes, OP_OF)
    assert per_op == {"qop2_Filter": 4500}
    assert total == 4500


@pytest.mark.parametrize("header", ["%fused_computation.2 (p: s32[8]) -> "
                                    "s32[8] {", "fused_computation.2 {"])
def test_parse_hlo_fusion_inherits_scope(header):
    text = "\n".join([
        "HloModule jit_fn",
        header,
        '  %a = s32[8] add(p, p), metadata={op_name="jit(fn)/qop3_Join/add"}',
        '  %b = s32[8] mul(a, a), metadata={op_name="jit(fn)/qop3_Join/mul"}',
        "}",
        "ENTRY %main.5 (x: s32[8]) -> s32[8] {",
        "  %fusion.2 = s32[8] fusion(x), kind=kLoop, "
        "calls=%fused_computation.2",
        '  %sort.1 = s32[8] sort(x), metadata={op_name="jit(fn)/qop1_Sort/'
        'sort"}',
        "}",
    ])
    op_of = {}
    op_profile.parse_hlo_text(text, op_of)
    assert op_of["fusion.2"] == "qop3_Join"
    assert op_of["sort.1"] == "qop1_Sort"

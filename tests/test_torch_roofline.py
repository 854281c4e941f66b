"""The port's roofline module (``repro_torch.launch.roofline``) held
against the reference's (``repro.launch.roofline``): the HLO-text parsers
on the same fixed lines (tuple outputs, ``-start`` / ``-done`` pairs, iota
and list replica groups, a ``while`` body for the split), `ring_bytes` on
counted collectives against the parser on the equivalent lines, and
``model_flops`` for every architecture and shape.  Exact, but for the
floats of ``model_flops`` (rtol 1e-12)."""

import numpy as np
import pytest

from repro.configs import get_config as jget_config
from repro.configs.base import SHAPES as JSHAPES
from repro.launch import roofline as jrl
from repro_torch.configs import ARCH_IDS, SHAPES, get_config
from repro_torch.launch import roofline as rl

HLO = """\
HloModule jit_step, entry_computation_layout={(f32[16,8]{1,0})->f32[16,8]{1,0}}

%add (a: f32[], b: f32[]) -> f32[] {
  %a = f32[] parameter(0)
  %b = f32[] parameter(1)
  ROOT %s = f32[] add(f32[] %a, f32[] %b)
}

%body.7 (p: (s32[], f32[4])) -> (s32[], f32[4]) {
  %p = (s32[], f32[4]{0}) parameter(0)
  %q = f32[4]{0} get-tuple-element((s32[], f32[4]{0}) %p), index=1
  %ar.2 = f32[4]{0} all-reduce(f32[4]{0} %q), channel_id=3, replica_groups=[2,2]<=[4], to_apply=%add
  %rs.2 = bf16[2,4]{1,0} reduce-scatter(bf16[32,4]{1,0} %r), channel_id=4, replica_groups={{0,1,2,3,4,5,6,7,8,9,10,11,12,13,14,15}}, dimensions={0}, to_apply=%add
  ROOT %t = (s32[], f32[4]{0}) tuple(s32[] %i, f32[4]{0} %ar.2)
}

ENTRY %main.9 (p0: f32[16,8]) -> f32[16,8] {
  %p0 = f32[16,8]{1,0} parameter(0)
  %ar = f32[16,8]{1,0} all-reduce(f32[16,8]{1,0} %p0), channel_id=1, replica_groups=[16,16]<=[256], to_apply=%add
  %ag-start = (bf16[4,8]{1,0}, bf16[64,8]{1,0}) all-gather-start(bf16[4,8]{1,0} %x), channel_id=2, replica_groups={{0,1,2,3},{4,5,6,7}}, dimensions={0}
  %ag-done = bf16[64,8]{1,0} all-gather-done((bf16[4,8]{1,0}, bf16[64,8]{1,0}) %ag-start)
  %tup = (f32[8]{0}, s32[2]{0}) all-reduce(f32[8]{0} %u, s32[2]{0} %v), replica_groups=[4,64]<=[256], to_apply=%add
  %a2a = f32[16,16]{1,0} all-to-all(f32[16,16]{1,0} %y), replica_groups={{0,1}}, dimensions={0}
  %cp = s32[10]{0} collective-permute(s32[10]{0} %z), source_target_pairs={{0,1},{1,0}}
  %nogroup = u8[100]{0} all-reduce(u8[100]{0} %w), to_apply=%add
  %w = (s32[], f32[4]{0}) while((s32[], f32[4]{0}) %init), condition=%cond.3, body=%body.7
  ROOT %out = f32[16,8]{1,0} copy(f32[16,8]{1,0} %ar)
}
"""


def test_collective_bytes_equal_the_references():
    got, want = rl.collective_bytes(HLO), jrl.collective_bytes(HLO)
    assert got == want
    # the fixed lines cover every type; the -done line is not counted twice
    assert all(got[c] > 0 for c in rl._COLLECTIVES)
    assert got["all-gather"] == (4 * 8 * 2 + 64 * 8 * 2) * 3 / 4


def test_collective_bytes_split_equals_the_references():
    got, want = rl.collective_bytes_split(HLO), jrl.collective_bytes_split(HLO)
    assert got == want
    loop, once, per_comp = got
    assert set(per_comp) == {"body.7", "main.9"}
    assert loop == per_comp["body.7"] > 0 and once == per_comp["main.9"] > 0


def test_line_parsers_equal_the_references():
    for dt, dims in (("f32", "16,8"), ("bf16", ""), ("pred", "3"),
                     ("c128", "2,2"), ("f8e4m3fn", "5"), ("weird9", "2")):
        assert rl._shape_bytes(dt, dims) == jrl._shape_bytes(dt, dims)
    for line in ("replica_groups=[4,64]<=[256]", "replica_groups={{0,1,2}}",
                 "no groups here"):
        assert rl._group_size(line) == jrl._group_size(line)
    assert rl._DTYPE_BYTES == jrl._DTYPE_BYTES
    assert rl._COLLECTIVES == jrl._COLLECTIVES


@pytest.mark.parametrize("op,payload,G", [
    ("all-reduce", 512, 16), ("all-gather", 1024, 4),
    ("reduce-scatter", 64, 16), ("all-to-all", 1024, 2),
    ("collective-permute", 40, 2), ("all-reduce", 100, 1)])
def test_ring_bytes_equal_the_parser_on_the_same_collective(op, payload, G):
    """A counted collective of ``payload`` bytes (f32 elements) over a
    group of G gives the bytes the parser gives its HLO line."""
    groups = "{{" + ",".join(str(i) for i in range(G)) + "}}"
    line = (f"  %c = f32[{payload // 4}]{{0}} {op}(f32[{payload // 4}]{{0}} "
            f"%x), replica_groups={groups}\n")
    want = jrl.collective_bytes(line)
    got = rl.ring_bytes([(op, payload, G)])
    assert got == want
    assert rl.ring_bytes([(op, payload, G)] * 3)["total"] == \
        3 * want["total"]


def test_ring_bytes_refuses_an_unknown_type():
    with pytest.raises(ValueError, match="unknown collective"):
        rl.ring_bytes([("broadcast", 8, 2)])
    assert rl.ring_bytes([]) == jrl.collective_bytes("")


@pytest.mark.parametrize("shape", sorted(SHAPES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_model_flops_equal_the_references(arch, shape):
    for active, chips in ((361821120.0, 256), (2.6e9, 512), (1.0, 1)):
        got = rl.model_flops(get_config(arch), SHAPES[shape], active, chips)
        want = jrl.model_flops(jget_config(arch), JSHAPES[shape], active,
                               chips)
        np.testing.assert_allclose(got, want, rtol=1e-12)


def test_hw_holds_the_h100_data_sheet_and_the_terms():
    assert rl.HW == {"peak_flops": 989.4e12, "hbm_bw": 3.35e12,
                     "link_bw": 450e9}
    t = rl.roofline_terms(989.4e12, 2 * 3.35e12, 0.5 * 450e9)
    assert (t.compute_s, t.memory_s, t.collective_s) == (1.0, 2.0, 0.5)
    assert t.dominant == "memory" and t.step_s == 2.0
    assert t.fraction_of_roofline == 0.5
    # the same arithmetic as the reference's Roofline on the same terms
    j = jrl.Roofline(1.0, 2.0, 0.5)
    assert (j.dominant, j.step_s, j.fraction_of_roofline) == \
        (t.dominant, t.step_s, t.fraction_of_roofline)
    assert rl.flops_and_bytes({"flops": 3, "bytes": 4}) == \
        {"flops": 3.0, "bytes": 4.0}
    info = rl.memory_info()
    assert info["available"] is False and "no compiled program" in info["why"]

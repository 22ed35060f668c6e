"""The port's roofline and cost counter (``repro_torch.analysis.{roofline,cost}``)
against the JAX package's ``repro.analysis.roofline``: the HLO collective parser,
the roofline terms, the hardware figures, MODEL_FLOPS and the shape matrix equal
the reference's exactly; ``kernel_costs`` against a hand count; ``CostCounter``
giving one unit per kernel-library call, equal on CPU and meta tensors; and each
collective of ``distributed/collectives.py`` under its HLO key."""

import dataclasses

import numpy as np
import pytest
import torch

from repro.analysis import roofline as ref_roofline
from repro.configs import ARCHS as REF_ARCHS
from repro.configs import SHAPES as REF_SHAPES
from repro_torch.analysis import HW, collective_bytes, roofline_terms
from repro_torch.analysis.cost import CostCounter
from repro_torch.analysis.roofline import HW_H100, kernel_costs, model_flops
from repro_torch.configs import ARCHS, SHAPES, shape_applicable
from repro_torch.distributed import collectives as coll
from repro_torch.distributed.ctx import Mesh
from repro_torch.kernels import ops

HLO = """
HloModule test
ENTRY main {
  %p0 = bf16[16,4096,512] parameter(0)
  %ag = bf16[16,4096,8192]{2,1,0} all-gather(%p0), dimensions={2}
  %ar = f32[1024,1024] all-reduce(%x), to_apply=%add
  ROOT %t = (f32[2,2]) tuple(%y)
  %rs.1 = bf16[8,128]{1,0} reduce-scatter(%z), dimensions={0}
  %a2a = (bf16[4,64]{1,0}, bf16[4,64]{1,0}) all-to-all(%a, %b)
  %cp = u32[16] collective-permute(%c), source_target_pairs={{0,1}}
  %ags = bf16[32,32] all-gather-start(%w)
  %agd = bf16[32,32] all-gather-done(%ags)
}
"""


def test_collective_parser():
    out = collective_bytes(HLO)
    assert out["all-gather_bytes"] == 16 * 4096 * 8192 * 2 + 32 * 32 * 2
    assert out["all-reduce_bytes"] == 1024 * 1024 * 4
    assert out["reduce-scatter_bytes"] == 8 * 128 * 2
    assert out["all-to-all_bytes"] == 2 * 4 * 64 * 2
    assert out["collective-permute_bytes"] == 16 * 4
    assert out["all-gather_count"] == 2  # -start counted once, -done skipped
    assert out["total_bytes"] == sum(
        out[f"{k}_bytes"]
        for k in ("all-gather", "all-reduce", "reduce-scatter", "all-to-all", "collective-permute")
    )
    assert out == ref_roofline.collective_bytes(HLO)


def test_roofline_terms():
    t = roofline_terms(197e12, 819e9, 100e9)   # exactly 1 s compute & memory, 2 s coll
    assert t["t_compute_s"] == pytest.approx(1.0)
    assert t["t_memory_s"] == pytest.approx(1.0)
    assert t["t_collective_s"] == pytest.approx(2.0)
    assert t["bottleneck"] == "collective"
    for args in [(197e12, 819e9, 100e9), (3e13, 1e9, 0.0), (1.0, 5e12, 2e11)]:
        assert roofline_terms(*args) == ref_roofline.roofline_terms(*args)


def test_shape_applicability_matrix():
    """40 cells: 34 applicable + 6 documented long_500k skips, as in the reference."""
    total = ok = 0
    skipped = []
    for arch, cfg in ARCHS.items():
        for name, shape in SHAPES.items():
            total += 1
            a, why = shape_applicable(cfg, shape)
            if a:
                ok += 1
            else:
                skipped.append((arch, name))
    assert total == 40 and ok == 34
    assert all(s == "long_500k" for _, s in skipped)
    assert {a for a, _ in skipped} == {
        "internvl2-26b", "whisper-small", "mistral-large-123b",
        "internlm2-20b", "deepseek-v2-lite-16b", "deepseek-moe-16b",
    }


def test_hw_equals_reference_and_h100_is_the_data_sheet():
    ours, theirs = dataclasses.asdict(HW()), dataclasses.asdict(ref_roofline.HW())
    assert ours == theirs == {"peak_flops": 197e12, "hbm_bw": 819e9, "link_bw": 50e9}
    assert dataclasses.asdict(HW_H100) == {"peak_flops": 989e12, "hbm_bw": 3.35e12,
                                           "link_bw": 450e9}
    t = roofline_terms(989e12, 3.35e12, 900e9, HW_H100)
    assert (t["t_compute_s"], t["t_memory_s"], t["t_collective_s"]) == (1.0, 1.0, 2.0)


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_model_flops_equal_reference(arch):
    for name, shape in SHAPES.items():
        want = ref_roofline.model_flops(REF_ARCHS[arch], REF_SHAPES[name], shape.kind)
        assert model_flops(ARCHS[arch], shape, shape.kind) == want


def _t(*shape, dtype=torch.float32, device="cpu", seed=0):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(dtype)
    return x if device == "cpu" else torch.empty(shape, dtype=dtype, device=device)


def test_kernel_costs_against_a_hand_count():
    q, k, v = _t(3, 8, 16), _t(3, 8, 16), _t(3, 8, 16)
    # causal, Sq = Sk = 8: 36 visible pairs a head; two products of D MACs each
    assert kernel_costs("flash_attention", q, k, v, causal=True) == {
        "flops": 3 * 36 * 2 * 2 * 16, "bytes": 4 * 4 * 3 * 8 * 16}
    assert kernel_costs("flash_attention", q, k, v, causal=False)["flops"] == 3 * 64 * 4 * 16
    kl = _t(3, 24, 16)
    assert kernel_costs("flash_attention", q, kl, kl, causal=True) == {
        "flops": 3 * 8 * 24 * 4 * 16, "bytes": 4 * (2 * 3 * 8 * 16 + 2 * 3 * 24 * 16)}
    bf = [t.to(torch.bfloat16) for t in (q, k, v)]
    assert kernel_costs("flash_attention", *bf)["bytes"] == 2 * 4 * 3 * 8 * 16
    # ssd: BH=2, S=12, P=5, N=3, chunk 4: 3 chunks of a 10-pair triangle
    x, dt, a = _t(2, 12, 5), _t(2, 12), _t(2)
    b, c = _t(2, 12, 3), _t(2, 12, 3)
    per_chunk = 2 * (10 * (3 + 5) + 2 * 4 * 5 * 3)
    inputs = 2 * 12 * 5 + 2 * 12 + 2 + 2 * (2 * 12 * 3)
    assert kernel_costs("ssd_chunk", x, dt, a, b, c, chunk=4) == {
        "flops": 2 * 3 * per_chunk, "bytes": 4 * (inputs + 2 * 12 * 5 + 2 * 5 * 3)}
    with pytest.raises(ValueError, match="no formula"):
        kernel_costs("merge_join_counts", q)


@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_is_one_unit_equal_on_cpu_and_meta(causal):
    counts = []
    for device in ("cpu", "meta"):
        q, k, v = (_t(4, 32, 16, device=device, seed=s) for s in range(3))
        with CostCounter() as c:
            out = ops.flash_attention(q, k, v, causal=causal)
        assert out.shape == (4, 32, 16) and out.device.type == device
        counts.append((c.flops, c.bytes, c.units, c.by_op))
    assert counts[0] == counts[1]
    want = kernel_costs("flash_attention", q, k, v, causal=causal)
    assert counts[0][:3] == (want["flops"], want["bytes"], {"flash_attention": 1})
    assert counts[0][3] == {}             # nothing inside the unit is counted


def test_ssd_chunk_is_one_unit_equal_on_cpu_and_meta():
    counts = []
    for device in ("cpu", "meta"):
        args = [_t(*s, device=device, seed=i)
                for i, s in enumerate([(3, 32, 8), (3, 32), (3,), (3, 32, 4), (3, 32, 4)])]
        with CostCounter() as c:
            y, state = ops.ssd_chunk(*args, chunk=8)
        assert y.shape == (3, 32, 8) and state.shape == (3, 8, 4)
        assert {y.device.type, state.device.type} == {device}
        counts.append((c.flops, c.bytes, c.units, c.by_op))
    assert counts[0] == counts[1]
    want = kernel_costs("ssd_chunk", *args, chunk=8)
    assert counts[0][:3] == (want["flops"], want["bytes"], {"ssd_chunk": 1})


def test_meta_tensors_reach_no_kernel_and_no_plain_version(monkeypatch):
    """Meta tensors give empty outputs of the right shapes after the same checks,
    with neither plain version nor kernel called; CPU tensors still get the plain
    version's values; the join kernels and a mix of devices still raise."""
    x = _t(2, 8, 16)
    want = ops.flash_attention(x, x, x)
    assert torch.equal(want, ops._ref.flash_attention_ref(x, x, x, causal=True))

    def refuse(*a, **k):
        raise AssertionError("reached")

    for mod, name in [(ops._ref, "flash_attention_ref"), (ops._ref, "ssd_chunked_ref"),
                      (ops._fa, "flash_attention_cuda"), (ops._ssd, "ssd_chunk_cuda")]:
        monkeypatch.setattr(mod, name, refuse)
    q = torch.empty((2, 8, 16), device="meta")
    assert ops.ssd_chunk(q, q[..., 0], q[:, 0, 0], q, q, chunk=4)[1].shape == (2, 16, 16)
    with pytest.raises(ValueError, match="multiples"):
        ops.flash_attention(q[:, :6], q, q, bq=4)
    with pytest.raises(ValueError, match="one device type"):
        ops.flash_attention(q, _t(2, 8, 16), q)
    keys = torch.empty((1, 8), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="one device type"):
        ops.merge_join_counts(keys, keys)
    assert ops.flash_attention(q, q, q).dtype == torch.float32
    assert ops.flash_attention(q.bfloat16(), q.bfloat16(), q.bfloat16()).dtype == torch.bfloat16


def test_view_ops_move_no_bytes_and_writes_do():
    x = _t(4, 6)
    w = _t(6, 5)
    with CostCounter() as c:
        y = x.view(2, 12).t().reshape(12, 2).expand(3, 12, 2)[1].permute(1, 0)
        assert y.shape == (2, 12)
    assert (c.flops, c.bytes) == (0, 0)
    with CostCounter() as c:
        z = (x.reshape(2, 2, 6) @ w)          # mm, then an unannotated _unsafe_view
    assert z.shape == (2, 2, 5)
    assert c.flops == 2 * 4 * 6 * 5 and c.bytes == 4 * (24 + 30 + 20)
    assert "aten._unsafe_view.default" in c.by_op and c.by_op["aten._unsafe_view.default"][2] == 0
    with CostCounter() as c:
        e = torch.empty(100)
        e.add_(1.0)
    assert c.bytes == 2 * 400 and c.by_op["aten.empty.memory_format"][2] == 0


def test_counters_do_not_nest():
    with CostCounter():
        with pytest.raises(RuntimeError, match="already counting"):
            CostCounter().__enter__()


@pytest.mark.parametrize("fn,key,per_device", [
    (lambda x, m: coll.psum(x, m, "model"), "all-reduce", 5 * 4),
    (lambda x, m: coll.pmax(x, m, "data"), "all-reduce", 5 * 4),
    (lambda x, m: coll.all_gather(x, m, "model", 0), "all-gather", 4 * 5 * 4),
    (lambda x, m: coll.psum_scatter(x.sum(-1, keepdim=True).expand(2, 4, 4), m, "model", 0),
     "reduce-scatter", 4),
    (lambda x, m: coll.all_to_all(x[..., :4], m, "model", 0, 0), "all-to-all", 4 * 4),
    (lambda x, m: coll.ppermute(x, m, "model", [(0, 1), (1, 2), (2, 3), (3, 0)]),
     "collective-permute", 5 * 4),
])
def test_each_collective_is_counted_under_its_hlo_key(fn, key, per_device):
    """x on a (data 2, model 4) mesh, a (5,) float32 block per device: each
    collective's result bytes per device under ``collective_bytes``'s key."""
    mesh = Mesh((2, 4), ("data", "model"))
    x = _t(2, 4, 5)
    with CostCounter() as c:
        fn(x, mesh)
    got = c.collectives
    assert got[f"{key}_bytes"] == per_device and got[f"{key}_count"] == 1
    assert got["total_bytes"] == per_device
    assert set(got) == set(collective_bytes(""))

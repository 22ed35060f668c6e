"""The port's partitioner count (``repro_torch.analysis.partition``): the collectives a
GSPMD partitioner adds to a sharded step, derived from the spec rules.

Every rule's bytes are written out from the shapes on a (data 2, model 4) mesh: a
reduced h2o-danube-1.8b layer forward and backward, a reduced mamba2-780m layer's
projections, and one small case per rule. Then the fallbacks (no layout; a spec
``_fit`` leaves replicated), the same count on CPU and meta tensors, the probe
identity for collective bytes, and the dry run's collective bytes per device at full
width against the JAX package's ``run_cell`` (its compiled HLO on 512 fake host
devices, in a subprocess): within [0.5, 2]x in each of ten cells, with the per-kind
ratios printed.
"""

import json
import os
import subprocess
import sys
from dataclasses import replace
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch

from repro_torch.analysis.cost import CostCounter
from repro_torch.analysis.partition import Layout
from repro_torch.analysis.roofline import COLLECTIVES, HW, HW_H100
from repro_torch.configs import ARCHS, reduced_for_smoke
from repro_torch.distributed import specs as spec_rules
from repro_torch.distributed.ctx import Mesh, MeshAxes, shard
from repro_torch.distributed.specs import P, batch_pspecs, cache_pspecs, param_pspecs
from repro_torch.launch import dryrun
from repro_torch.models.attention import attn_decode
from repro_torch.models.layers import Params, cross_entropy, embed_apply, logits_apply
from repro_torch.models.model import _block_apply, _positions, init_params
from repro_torch.train.data import synth_batch
from repro_torch.train.step import TrainConfig, init_train_state, make_prefill_step, make_train_step

ROOT = Path(__file__).resolve().parents[1]
META = torch.device("meta")
MESH = Mesh((2, 4), ("data", "model"))
AXES = MeshAxes(data=("data",), model="model")
DP, TP, F32 = 2, 4, 4          # data shards of the batch, model shards, bytes a collective element


def _empty(*shape, dtype=torch.float32, grad=False):
    return torch.empty(shape, dtype=dtype, device=META, requires_grad=grad)


def _layout(params=None, specs=None, axes=AXES, **kw):
    return Layout(MESH, axes, params or {}, specs or {}, P("data", None), **kw)


def _bytes(counter):
    got = counter.partitioner_collectives
    return {k: got[f"{k}_bytes"] for k in COLLECTIVES if got[f"{k}_bytes"]}


def _shard_bytes(t, split):
    """A weight's model-axis shard in f32: what its FSDP all-gather returns."""
    return t.numel() * F32 // (TP if split else 1)


# ---------------------------------------------------------------------------
# hand counts
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("backward", [False, True])
def test_danube_layer_by_hand(backward):
    """Reduced h2o-danube-1.8b, one layer on (B 4, S 16), float32. Forward: each
    weight's FSDP all-gather, K and V all-gathered to the replicated layout
    attention gives them, the partial sums of ``wo`` and ``w_out`` all-reduced at
    the residual adds. Backward: each weight read again (its input gradient), the
    K and V gradients gathered to that layout, the five column-parallel input
    gradients all-reduced one by one, and every gradient reduced over the data
    axes (the weights at their model shard, the two norm scales whole)."""
    cfg = replace(reduced_for_smoke(ARCHS["h2o-danube-1.8b"]), dtype="float32")
    model = init_params(cfg, device="meta")
    specs = param_pspecs(model, MESH, AXES)
    layer = model.layers[0]
    mixer, ffn = layer.mixer, layer.ffn
    split_cols = ("data", "model")
    for name in ("mixer.wq", "mixer.wk", "mixer.wv", "ffn.w_gate", "ffn.w_up"):
        assert specs[f"layers.0.{name}"] == split_cols, name
    for name in ("mixer.wo", "ffn.w_out"):
        assert specs[f"layers.0.{name}"] == ("model", "data"), name
    b, s, d = 4, 16, cfg.d_model
    weights = (mixer.wq, mixer.wk, mixer.wv, mixer.wo, ffn.w_gate, ffn.w_up, ffn.w_out)
    fsdp = sum(_shard_bytes(w, True) for w in weights)
    act = b * s * d * F32 // DP                        # one (B, S, d) activation
    kv = b * s * cfg.n_kv_heads * cfg.head_dim * F32 // DP
    scales = 2 * d * F32                               # norm1 and norm2, replicated

    x = _empty(b, s, d, grad=backward)
    params = list(layer.parameters())
    with CostCounter(layout=_layout(model, specs)) as c:
        for p in params:
            p.requires_grad_(backward)
        with torch.set_grad_enabled(backward):
            y, _ = _block_apply(cfg, layer.spec, layer, x, _positions(s, META))
            if backward:
                torch.autograd.grad(y, [x] + params, torch.ones_like(y))
    gather, reduce = fsdp + 2 * kv, 2 * act
    n_gather, n_reduce = len(weights) + 2, 2
    if backward:
        gather += fsdp + 2 * kv
        reduce += 5 * act + fsdp + scales
        n_gather += len(weights) + 2
        n_reduce += 5 + len(weights) + 2
    assert _bytes(c) == {"all-gather": gather, "all-reduce": reduce}
    got = c.partitioner_collectives
    assert (got["all-gather_count"], got["all-reduce_count"]) == (n_gather, n_reduce)
    assert c.collectives == got                        # no collective of the program's own


def test_mamba_projections_by_hand():
    """Reduced mamba2-780m, one layer forward on (B 4, S 16), float32: ``w_z``,
    ``w_x`` and ``w_out`` gathered at their model shard, ``w_B``, ``w_C`` and
    ``w_dt`` (split over the data axes only) whole; the out projection's partial sum
    all-reduced at the residual add, and the gated RMS norm over the split
    ``d_inner`` all-reduces its (B, S) statistics."""
    cfg = replace(reduced_for_smoke(ARCHS["mamba2-780m"]), dtype="float32")
    model = init_params(cfg, device="meta")
    specs = param_pspecs(model, MESH, AXES)
    mixer = model.layers[0].mixer
    split = {"w_z": True, "w_x": True, "w_out": True, "w_B": False, "w_C": False,
             "w_dt": False}
    for name, is_split in split.items():
        assert ("model" in specs[f"layers.0.mixer.{name}"]) == is_split, name
        assert "data" in specs[f"layers.0.mixer.{name}"], name
    b, s, d = 4, 16, cfg.d_model
    with CostCounter(layout=_layout(model, specs)) as c:
        _block_apply(cfg, model.layers[0].spec, model.layers[0], _empty(b, s, d),
                     _positions(s, META))
    fsdp = sum(_shard_bytes(getattr(mixer, n), is_split) for n, is_split in split.items())
    assert _bytes(c) == {"all-gather": fsdp,
                         "all-reduce": b * s * d * F32 // DP + b * s * F32 // DP}


def _fsdp_reads():
    """Three products read a (data, model) weight: directly, through a view and
    through a cast; each gathers its model shard."""
    w, x = _empty(8, 16), _empty(4, 8)

    def run():
        x @ w
        x @ w.T.T
        x.double() @ w.double()

    return {"w": w}, {"w": P("data", "model")}, run, {"all-gather": 3 * _shard_bytes(w, True)}


def _fit_replicated():
    """7 rows do not divide over the data axis: ``_fit`` drops it, so nothing is
    gathered."""
    w, x = _empty(7, 16), _empty(4, 7)
    spec = spec_rules._fit(MESH, tuple(w.shape), ("data", "model"), 0)
    assert spec == (None, "model")
    return {"w": w}, {"w": spec}, lambda: x @ w, {}


def _partial_sums():
    """A row-parallel product leaves a partial sum: views and casts pass it on, the
    first other op reduces it once, later readers reuse it; a partial sum nothing
    reads is never reduced."""
    wo, h = _empty(16, 8), _empty(4, 6, 16)

    def run():
        hs = shard(h, "dp", None, "tp")
        y = hs @ wo
        y.view(24, 8).float()
        y + 1.0
        y * 2.0
        hs @ wo                                        # never read

    return {"wo": wo}, {"wo": P("model", None)}, run, {"all-reduce": 4 * 6 * 8 * F32 // DP}


def _gradient_reduction():
    """A (data, None) weight: gathered whole for the forward read, and its gradient
    all-reduced whole over the data axes."""
    w, x = _empty(8, 16, grad=True), _empty(4, 8)

    def run():
        with torch.enable_grad():
            torch.autograd.grad((x @ w).sum(), [w])

    whole = _shard_bytes(w, False)
    return {"w": w}, {"w": P("data", None)}, run, {"all-gather": whole, "all-reduce": whole}


def _heads_that_do_not_divide():
    """K with 2 heads pinned replicated over 4 model shards is all-gathered; 3 heads
    of a split projection (neither dividing 4 nor divided by it) are gathered where
    the view cuts them."""
    k, h3 = _empty(4, 6, 32), _empty(4, 6, 48)

    def run():
        shard(shard(k, "dp", None, "tp").reshape(4, 6, 2, 16), "dp", None, None, None)
        shard(h3, "dp", None, "tp").reshape(4, 6, 3, 16)

    return {}, {}, run, {"all-gather": (4 * 6 * 32 + 4 * 6 * 48) * F32 // DP}


def _vocab_parallel():
    """A vocab-sharded embedding: the lookup is a partial sum, all-reduced where the
    embedding output is pinned; the loss over the vocab-sharded logits all-reduces
    its max, its sum-exp and its picked logit, each a (B, S) float."""
    cfg = SimpleNamespace(vocab=60)
    p = Params({"embedding": _empty(64, 8)})
    tokens = torch.empty((4, 6), dtype=torch.int64, device=META)

    def run():
        cross_entropy(cfg, logits_apply(cfg, p, embed_apply(cfg, p, tokens)), tokens)

    bs = 4 * 6 * F32 // DP
    return ({"embedding": p.embedding}, {"embedding": P("model", None)}, run,
            {"all-reduce": 4 * 6 * 8 * F32 // DP + 3 * bs})


def _decode_on_a_split_cache():
    """One-token attention over a cache whose 512 positions are split over the model
    axis: the (2 KV heads x 2) query is gathered to meet the split keys, the softmax
    over the split positions all-reduces its max and its sum, the attention output
    is a partial sum over the positions (all-reduced where ``wo`` reads it), and
    ``wo``'s own partial sum is all-reduced at the residual add. Every weight is
    gathered at its model shard."""
    cfg = SimpleNamespace(n_heads=4, n_kv_heads=2, head_dim=8)
    p = Params({"wq": _empty(16, 32), "wk": _empty(16, 16), "wv": _empty(16, 16),
                "wo": _empty(32, 16)})
    cache = {"k": _empty(4, 512, 2, 8), "v": _empty(4, 512, 2, 8)}
    cache_specs = cache_pspecs({"layers": [cache]}, MESH, AXES, cfg)["layers"][0]
    assert cache_specs["k"] == ("data", "model", None, None)
    x = _empty(4, 1, 16)

    def run():
        x + attn_decode(cfg, p, x, cache["k"], cache["v"], 100, window=0, rope_theta=1e4)

    params = dict(p.named_parameters())
    specs = {"wq": P("data", "model"), "wk": P("data", "model"), "wv": P("data", "model"),
             "wo": P("model", "data")}
    fsdp = sum(_shard_bytes(w, True) for w in params.values())
    q = 4 * 1 * 32 * F32 // DP                       # (B, 1, H x hd): the query, the output
    stats = 4 * 2 * 2 * F32 // DP                    # (B, KV, H / KV, 1)
    return (params, specs, run,
            {"all-gather": fsdp + q, "all-reduce": 2 * stats + q + 4 * 16 * F32 // DP},
            {"cache": cache, "cache_specs": cache_specs})


def _bf16_counts_f32():
    """A bf16 partial sum counts 4 bytes an element, as the reference's HLO carries it."""
    wo, h = _empty(16, 8, dtype=torch.bfloat16), _empty(4, 6, 16, dtype=torch.bfloat16)

    def run():
        (shard(h, "dp", None, "tp") @ wo) + 1.0

    return {"wo": wo}, {"wo": P("model", None)}, run, {"all-reduce": 4 * 6 * 8 * F32 // DP}


def _sequence_parallel_gather():
    """Under sequence parallelism the residual stream is split on the sequence; two
    column-parallel products read it: it is all-gathered once, for both."""
    wq, wk, x = _empty(16, 32), _empty(16, 16), _empty(4, 8, 16)

    def run():
        xs = shard(x, "dp", "sp", None)
        xs @ wq
        xs @ wk

    return ({"wq": wq, "wk": wk}, {"wq": P("data", "model"), "wk": P("data", "model")}, run,
            {"all-gather": 4 * 8 * 16 * F32 // DP + _shard_bytes(wq, True)
             + _shard_bytes(wk, True)})


RULES = {"fsdp-reads": _fsdp_reads, "fit-replicated": _fit_replicated,
         "partial-sums": _partial_sums, "gradient-reduction": _gradient_reduction,
         "heads": _heads_that_do_not_divide, "vocab-parallel": _vocab_parallel,
         "decode-split-cache": _decode_on_a_split_cache, "bf16-width": _bf16_counts_f32,
         "sequence-parallel": _sequence_parallel_gather}


@pytest.mark.parametrize("rule", sorted(RULES))
def test_rule_by_hand(rule):
    """Each case's weights (and cache) laid out by the specs it states; the count
    equals the bytes written out from its shapes."""
    params, specs, run, want, *extra = RULES[rule]()
    axes = MeshAxes(sequence_parallel=True) if rule == "sequence-parallel" else AXES
    with CostCounter(layout=_layout(params, specs, axes, **(extra[0] if extra else {}))) as c:
        run()
    assert _bytes(c) == want


# ---------------------------------------------------------------------------
# fallbacks and agreement across devices
# ---------------------------------------------------------------------------


def _reduced(arch, **kw):
    return replace(reduced_for_smoke(ARCHS[arch]), **kw)


def _step_counts(cfg, device, layout_of=None):
    """A train step and a prefill of ``cfg`` on a 2 x 16 ``synth_batch`` on
    ``device``, each counted (under ``layout_of(model, batch)``'s layout, if given)."""
    raw = synth_batch(cfg, step=0, global_batch=2, seq=16)
    batch = {k: torch.from_numpy(v) for k, v in raw.items()}
    if device == "meta":
        batch = {k: torch.empty(v.shape, dtype=v.dtype, device=META) for k, v in batch.items()}
    model = init_params(cfg, seed=0, device=device)
    state = init_train_state(cfg, TrainConfig(), model)
    layout = layout_of(model, batch) if layout_of else None
    with CostCounter(layout=layout) as train:
        make_train_step(cfg, TrainConfig())(model, state, batch)
    with CostCounter(layout=layout) as pre:
        make_prefill_step(cfg)(model, {k: v for k, v in batch.items() if k != "labels"})
    return train, pre


def _mesh_layout(model, batch):
    return Layout(MESH, AXES, model, param_pspecs(model, MESH, AXES),
                  batch_pspecs(batch, MESH, AXES))


def test_no_layout_counts_no_partitioner_collectives():
    """A bare counter has no partitioner: its partitioner part is zeros and its
    collectives are the program's (none in this step). A layout changes no FLOP,
    byte or kernel unit: only the collectives."""
    cfg = _reduced("h2o-danube-1.8b", remat="nothing")
    bare = _step_counts(cfg, "meta")
    laid = _step_counts(cfg, "meta", _mesh_layout)
    for b, lay in zip(bare, laid):
        assert b.partition is None
        assert b.partitioner_collectives["total_bytes"] == b.collectives["total_bytes"] == 0
        assert all(v == 0 for v in b.partitioner_collectives.values())
        assert (b.flops, b.bytes, b.units) == (lay.flops, lay.bytes, lay.units)
        assert lay.collectives == lay.partitioner_collectives
        assert lay.collectives["total_bytes"] > 0


@pytest.mark.parametrize("arch,remat", [("h2o-danube-1.8b", "nothing"), ("mamba2-780m", "nothing"),
                                        ("whisper-small", "none")])
def test_partitioner_counts_the_same_on_cpu_and_meta(arch, remat):
    """A train step and a prefill under a (data 2, model 4) layout: every collective
    kind's bytes and count equal on CPU tensors (the kernels' plain versions run
    inside their units) and on meta stand-ins."""
    cfg = _reduced(arch, remat=remat)
    cpu = _step_counts(cfg, "cpu", _mesh_layout)
    meta = _step_counts(cfg, "meta", _mesh_layout)
    for c, m in zip(cpu, meta):
        assert c.partitioner_collectives == m.partitioner_collectives
        assert c.partitioner_collectives["total_bytes"] > 0
        assert (c.flops, c.bytes, c.units) == (m.flops, m.bytes, m.units)


@pytest.mark.parametrize("arch", ["h2o-danube-1.8b", "mamba2-780m", "gemma3-12b"])
@pytest.mark.parametrize("shape", ["prefill_32k", "train_4k", "decode_32k"])
def test_probe_identity_holds_for_collective_bytes(arch, shape):
    """count(step at 2R groups) - count(step at R groups) = R x probe in collective
    bytes, exactly, on the production mesh: the partitioner's collectives of a
    group are the probe's (gemma3-12b's sequence parallelism included: a probe's
    input has the layout every block leaves the residual stream in)."""
    cfg = reduced_for_smoke(ARCHS[arch])
    small = dryrun.run_cell(arch, shape, False, cfg_override=cfg)
    r = cfg.n_repeats
    big = dryrun.run_cell(arch, shape, False, cfg_override=replace(
        cfg, n_layers=len(cfg.prefix) + 2 * r * len(cfg.pattern)))
    (extra, probe), = [(p["extra_repeats"], p) for p in small["probes"]]
    assert extra == r - 1
    diff = big["raw_module"]["coll_bytes"] - small["raw_module"]["coll_bytes"]
    assert diff == r * probe["coll_bytes"] > 0


# ---------------------------------------------------------------------------
# the reference's compiled HLO at full width
# ---------------------------------------------------------------------------

#: (arch, shape, multi_pod): the full-width cells held against the reference
FULL_CELLS = [("h2o-danube-1.8b", "train_4k", False), ("h2o-danube-1.8b", "train_4k", True),
              ("h2o-danube-1.8b", "prefill_32k", False), ("h2o-danube-1.8b", "decode_32k", False),
              ("mamba2-780m", "train_4k", False), ("mamba2-780m", "prefill_32k", False),
              ("mamba2-780m", "decode_32k", True), ("deepseek-moe-16b", "prefill_32k", False),
              ("whisper-small", "train_4k", False), ("gemma3-12b", "prefill_32k", True)]

#: the band the port's collective bytes per device keep around the reference's
BAND = (0.5, 2.0)

REF_FULL_CODE = r"""
import json, os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=512"
os.environ["JAX_PLATFORMS"] = "cpu"
from repro.analysis import probes
from repro.launch import dryrun

seen = []
_bytes = probes.collective_bytes


def recording(hlo):
    seen.append(_bytes(hlo))
    return seen[-1]


probes.collective_bytes = recording
out = {}
for arch, shape, mp in json.loads(sys.argv[1]):
    seen.clear()
    r = dryrun.run_cell(arch, shape, mp)
    kinds = {k: v for k, v in r["collectives"].items() if k.endswith("_bytes")}
    for p, c in zip(r["probes"], seen):
        for k in kinds:
            kinds[k] += p["extra_repeats"] * c[k]
    out[f"{arch}|{shape}|{int(mp)}"] = {"coll_bytes_per_device": r["coll_bytes_per_device"],
                                        "kinds": kinds, "roofline": r["roofline"]}
print("REF_JSON " + json.dumps(out))
"""


@pytest.fixture(scope="module")
def reference_full():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src")
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=512"
    res = subprocess.run([sys.executable, "-c", REF_FULL_CODE, json.dumps(FULL_CELLS)],
                         capture_output=True, text=True, timeout=900, env=env, cwd=str(ROOT))
    assert res.returncode == 0, res.stderr[-3000:]
    line = next(ln for ln in res.stdout.splitlines() if ln.startswith("REF_JSON "))
    return json.loads(line[len("REF_JSON "):])


def _holds_its_totals(got):
    """The dry run's collective bytes per device: the total of ``collectives``, the
    program's and the partitioner's."""
    coll, part = got["collectives"], got["collectives_partitioner"]
    assert got["coll_bytes_per_device"] == coll["total_bytes"] > 0
    program = {k: coll[k] - part[k] for k in coll}
    assert all(v >= 0 for v in program.values())
    assert coll["total_bytes"] == program["total_bytes"] + part["total_bytes"]
    assert part["total_bytes"] > 0
    assert got["roofline"]["t_collective_s"] == got["coll_bytes_per_device"] / HW().link_bw
    assert (got["roofline_h100"]["t_collective_s"]
            == got["coll_bytes_per_device"] / HW_H100.link_bw)


@pytest.mark.parametrize("arch,shape,multi_pod", FULL_CELLS)
def test_full_width_collective_bytes_match_reference(reference_full, arch, shape, multi_pod):
    """Each cell's collective bytes per device within BAND of the reference's (its
    module's HLO plus (R - 1) x each probe's); the per-kind ratios and both
    rooflines' bottlenecks beside the reference's are printed."""
    want = reference_full[f"{arch}|{shape}|{int(multi_pod)}"]
    got = dryrun.run_cell(arch, shape, multi_pod)
    _holds_its_totals(got)
    ratio = got["coll_bytes_per_device"] / want["coll_bytes_per_device"]
    kinds = {k[:-6]: round(got["collectives"][k] / v, 3) if v else None
             for k, v in want["kinds"].items() if k != "total_bytes"}
    tpu, h100, ref = got["roofline"], got["roofline_h100"], want["roofline"]
    print(f"\n{arch} {shape} {'pod2' if multi_pod else 'pod1'}: collective bytes per device "
          f"{got['coll_bytes_per_device']:.4e} against {want['coll_bytes_per_device']:.4e} "
          f"(x{ratio:.3f}); by kind {kinds}; TPU figures t_x {tpu['t_collective_s']:.4g} s, "
          f"t_m {tpu['t_memory_s']:.4g} s: {tpu['bottleneck']}; H100 t_x "
          f"{h100['t_collective_s']:.4g} s, t_m {h100['t_memory_s']:.4g} s: "
          f"{h100['bottleneck']}; reference t_x {ref['t_collective_s']:.4g} s, t_m "
          f"{ref['t_memory_s']:.4g} s: {ref['bottleneck']}")
    assert BAND[0] <= ratio <= BAND[1], ratio

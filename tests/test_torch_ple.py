"""PLE at the paper's form on the port: ``PLELayer``'s ``paper_form``
(each task's own gated input above level 1, ReLU on every bank layer)
and its default against a per-expert loop of the equations, ``PLEModel`` served through
``build_scorer`` on a per-field one-hot ``FeatureConfig`` with dense
floats against the benchmark's plain reference
(``port_bench/reference/ple-aliexpress.py``, loaded by path) on seeded
random weights, and its parameters at MTReclib's AliExpress widths
against the reference's.  The layer's defaults are held to Flax in
``tests/test_torch_multitask.py``.

No JAX here: the JAX package has no PLE of this form.  The ``cuda``
tests run on the card with ``python -m pytest --noconftest
tests/test_torch_ple.py -q -m cuda``.

Tolerances: the layer against its equations 1e-6 of the largest output
(float32 on both sides, the bank's batched product and the loop's
per-expert ones summing in other orders, widths under 20); the model
against the reference 1e-5 of the largest logit (float32, sums in other
orders through two levels, the gates' softmax and the towers); B8's
banks on the card against ``multi_dense_xla`` in float64 1e-5 of the
largest output (split TF32 lands ~5e-7 away, and 2,176-deep float32
sums in another order up to a few 1e-6); the served logits on the card
against the CPU's 1e-5 of the largest.
"""
import importlib.util
import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from rec_now_tpu_torch.core import profiling
from rec_now_tpu_torch.embedding.table import EmbeddingTable
from rec_now_tpu_torch.layers import PLELayer
from rec_now_tpu_torch.models import FeatureConfig, PLEModel
from rec_now_tpu_torch.ops import gather_kernel as gk
from rec_now_tpu_torch.ops import multi_dense_kernel as mk
from rec_now_tpu_torch.serving import ServingState, build_scorer

torch.set_num_threads(1)

PB = Path(__file__).resolve().parents[1] / "port_bench"
REF = PB / "reference"
# the small model of the comparisons: 3 fields of 8, 5 dense floats, two
# levels (16, 8), 2 shared experts and 2 a task, towers 6-4
ROWS = (5, 7, 3)
SMALL = {"num_dense_features": 5, "num_sparse_features": 3,
         "embedding_dim": 8, "num_embeddings_per_feature": list(ROWS),
         "multi_hot_sizes": [1, 1, 1], "bottom_mlp_dims": [16, 8],
         "tower_mlp_dims": [6, 4], "task_num": 2, "shared_expert_num": 2,
         "specific_expert_num": 2, "bias_init_scale": 0.1}


def _reference():
    if str(REF) not in sys.path:
        sys.path.insert(0, str(REF))
    spec = importlib.util.spec_from_file_location("ple_reference",
                                                  REF / "ple-aliexpress.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _fc(cfg=SMALL):
    return FeatureConfig(num_dense=cfg["num_dense_features"],
                         num_sparse=cfg["num_sparse_features"],
                         embedding_dim=cfg["embedding_dim"],
                         field_rows=tuple(cfg["num_embeddings_per_feature"]),
                         hotness=tuple(cfg["multi_hot_sizes"]))


def _model(cfg=SMALL, device="cpu"):
    return PLEModel(_fc(cfg), expert_dims=tuple(cfg["bottom_mlp_dims"]),
                    num_task=cfg["task_num"],
                    shared_experts=cfg["shared_expert_num"],
                    task_experts=cfg["specific_expert_num"],
                    tower_dims=tuple(cfg["tower_mlp_dims"]), device=device)


def _randomize(module, seed):
    """Every parameter U(-0.5, 0.5) / sqrt(its fan-in axis), so biases
    are not zero and the gates not uniform."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in module.parameters():
            fan = p.shape[-2] if p.dim() == 3 else p.shape[-1]
            p.copy_((torch.rand(p.shape, generator=gen) - 0.5) * 2
                    / max(fan, 1) ** 0.5)
    return module


# -- the layer against the paper's equations ----------------------------------
def _equations(layer, x, num_task, paper):
    """The layer's outputs computed one expert at a time: at level l each
    module's input is x (l = 0), its own gated output of level l - 1
    (``paper``), or the concatenation the default form reads; each expert
    is its bank's Linears with ReLU between (and after the last with
    ``paper``); a special task's gate weighs [its experts; the shared
    ones], the shared module's [every bank in module order], dropped at
    the last level."""
    names, shared = layer.names, layer.is_shared
    total = len(names)
    prev = [x] * total
    for l in range(layer.num_layer):
        banks = getattr(layer, f"ple_layer_{l}")
        gates = getattr(layer, f"ple_gate_{l}")
        last = l == layer.num_layer - 1
        ins, experts = [], []
        for t in range(total):
            if l == 0:
                xi = x
            elif paper:
                xi = prev[t]
            elif shared[t]:
                xi = torch.cat(prev, -1)
            else:
                xi = torch.cat([prev[t]] + [prev[s] for s in range(total)
                                            if shared[s]], -1)
            ins.append(xi)
            layers = list(banks[f"task_{names[t]}"].values())
            outs = []
            for e in range(layers[0].kernel.shape[0]):
                h = xi
                for i, md in enumerate(layers):
                    h = h @ md.kernel[e] + md.bias[e, 0]
                    if paper or i < len(layers) - 1:
                        h = torch.relu(h)
                outs.append(h)
            experts.append(outs)
        nxt = []
        for t in range(total):
            if shared[t] and last:
                nxt.append(None)
                continue
            mix = ([e for s in range(total) for e in experts[s]] if shared[t]
                   else experts[t] + [e for s in range(total) if shared[s]
                                      for e in experts[s]])
            dense = gates[f"task_{names[t]}"]["dense"]
            w = torch.softmax(ins[t] @ dense.weight.t() + dense.bias, -1)
            out = w[:, :1] * mix[0]
            for e in range(1, len(mix)):
                out = out + w[:, e:e + 1] * mix[e]
            nxt.append(out)
        prev = nxt
    return [o for o, sh in zip(prev, shared) if not sh]


@pytest.mark.parametrize("paper", [True, False])
@pytest.mark.parametrize("tasks,dims,experts", [
    (2, [[12], [7]], [[3, 2, 2]]),            # the paper's shape, narrow
    (3, [[9, 6], [5]], [[2, 3, 1, 2], 2]),    # two-layer banks, 3 tasks
    (2, [[8], [6], [5]], [[2, 1, 3]]),        # a middle level's shared gate
])
def test_ple_options_match_the_equations(paper, tasks, dims, experts):
    x = torch.from_numpy(np.random.RandomState(tasks).randn(
        37, 10).astype(np.float32))
    layer = _randomize(PLELayer(10, tasks, dims, experts,
                                torch.Generator().manual_seed(0),
                                device="cpu", paper_form=paper), 1)
    with torch.no_grad():
        got = layer(x)
        want = _equations(layer, x, tasks, paper)
    assert len(got) == len(want) == tasks
    for a, b in zip(got, want):
        assert a.shape == b.shape
        assert float((a - b).abs().max()) <= 1e-6 * float(b.abs().max())


def test_ple_options_shape_the_banks_and_gates():
    """The paper's form: a level-2 bank and gate read the module's own
    level-1 width, where the default reads the concatenations, and the
    last bank layer ends in ReLU."""
    def shapes(**kw):
        layer = PLELayer(10, 2, [[12], [7]], 2,
                         torch.Generator().manual_seed(0), device="cpu",
                         **kw)
        banks, gates = layer.ple_layer_1, layer.ple_gate_1
        return ({n: b["MultiDenseLayer_0"].kernel.shape[1]
                 for n, b in banks.items()},
                {n: g["dense"].in_features for n, g in gates.items()},
                layer.ple_layer_0["task_shared_0"][
                    "MultiDenseLayer_0"].activation)
    assert shapes() == ({"task_shared_0": 36, "task_special_0": 24,
                         "task_special_1": 24},
                        {"task_special_0": 24, "task_special_1": 24}, None)
    assert shapes(paper_form=True) == (
        {"task_shared_0": 12, "task_special_0": 12, "task_special_1": 12},
        {"task_special_0": 12, "task_special_1": 12}, "relu")


# -- the model against the benchmark's reference ------------------------------
def _weights(ref, cfg, seed):
    """Seeded random weights in the reference's names and shapes, each
    U(-limit, limit)."""
    rng = np.random.RandomState(seed)
    return {name: torch.from_numpy(rng.uniform(
        -limit, limit, size=shape).astype(np.float32))
        for name, shape, limit in ref.param_specs(cfg)}


def _request(fc, b, seed):
    rng = np.random.RandomState(seed)
    table = torch.from_numpy(rng.uniform(-0.5, 0.5, (fc.total_rows,
                                                     fc.embedding_dim))
                             .astype(np.float32))
    dense = np.log1p(rng.exponential(1.0, (b, fc.num_dense))
                     ).astype(np.float32)
    ids = rng.randint(0, 1000, size=(b, fc.num_sparse)).astype(np.int32)
    return table, dense, ids


def test_model_serves_as_the_reference():
    ref = _reference()
    fc = _fc()
    model = _model()
    params = _weights(ref, SMALL, 0)
    assert {n: tuple(p.shape) for n, p in model.named_parameters()} == {
        n: tuple(p.shape) for n, p in params.items()}
    table, dense, ids = _request(fc, 64, 1)
    scorer = build_scorer(model, fc, EmbeddingTable(fc.total_rows, 8, "cpu"),
                          device="cpu")
    before = gk.gather_rows.launches
    profiling.enable()
    try:
        got = scorer(ServingState(params, table), dense, ids)
        spans = profiling.span_report()["spans"]
    finally:
        profiling.disable()
    for name in ("ple", "towers"):
        assert spans[name]["count"] >= 1 and "stream_ms" not in spans[name]
    assert gk.gather_rows.launches == before      # the CPU's plain lookup
    with torch.no_grad():
        want = ref.forward(params, torch.from_numpy(dense),
                           ref.global_rows(ids, SMALL, "cpu"), table, SMALL)
    assert got.shape == want.shape == (2, 64)
    for t in range(2):
        assert float((got[t] - want[t]).abs().max()) <= 1e-5 * float(
            want[t].abs().max())
    # the two tasks' logits are not the same row
    assert float((want[0] - want[1]).abs().max()) > 0.1 * float(
        want.abs().max())


def test_model_is_the_same_in_every_grad_mode():
    ref = _reference()
    fc = _fc()
    model = _model()
    model.load_state_dict(_weights(ref, SMALL, 2))
    table, dense, ids = _request(fc, 16, 3)
    emb = table[fc.global_ids(torch.from_numpy(ids))]
    x = torch.from_numpy(dense)
    with torch.no_grad():
        a = model(x, emb)
    b = model(x, emb)
    assert b.requires_grad and torch.equal(a, b.detach())


def test_aliexpress_widths_are_the_references():
    """At the configuration's widths the model's parameters are the
    reference's, name for name and shape for shape (2,176 in, levels of
    512 and 256, 4 + 2 x 4 experts, towers 128-64-1)."""
    cfg = json.loads((PB / "configs" / "ple-aliexpress.json").read_text())
    model = _model(cfg)
    want = {n: tuple(s) for n, s, _ in _reference().param_specs(cfg)}
    assert {n: tuple(p.shape) for n, p in model.named_parameters()} == want
    assert want["ple.ple_layer_0.task_shared_0.MultiDenseLayer_0.kernel"] \
        == (4, 2176, 512)
    assert want["ple.ple_layer_1.task_special_1.MultiDenseLayer_0.kernel"] \
        == (4, 512, 256)
    assert want["ple.ple_gate_0.task_shared_0.dense.weight"] == (12, 2176)
    assert want["ple.ple_gate_1.task_special_0.dense.weight"] == (8, 512)
    assert "ple.ple_gate_1.task_shared_0.dense.weight" not in want


# -- the banks and the model on the card --------------------------------------
@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _counts():
    c = profiling.span_report()["counters"]
    return {k: c.get(k, 0) for k in ("multi_dense.mma", "multi_dense.tc",
                                     "multi_dense.gate",
                                     "multi_dense.tc_wgmma")}


def _launched(before):
    after = _counts()
    return {k: after[k] - before[k] for k in after}


def _bank(dev, b, n, d, u, seed):
    gen = torch.Generator().manual_seed(seed)
    x = (torch.rand(1, b, d, generator=gen) - 0.5).to(dev)
    w = ((torch.rand(n, d, u, generator=gen) - 0.5) * 2
         * (6 / (d + u)) ** 0.5).to(dev)
    bias = ((torch.rand(n, 1, u, generator=gen) - 0.5) * 0.2).to(dev)
    return x, w, bias


def _close_f64(got, x, w, bias, relu):
    want = mk.multi_dense_xla(x.double(), w.double(),
                              None if bias is None else bias.double(),
                              "relu" if relu else None)
    assert got.shape == want.shape
    assert float((got.double() - want).abs().max()) <= 1e-5 * float(
        want.abs().max())


# (nx, n, b, d, u, x aligned, taken): the PLE cell's two banks (level 1's
# three read one x); the same at B off the 128-row tile, at 64 rows and
# with x off the 16-byte grid; config 4's banks at B = 8,192 (MMoE layer 0
# at D = 429, layer 1 per expert, the gate bank, PLE's experts at D = 128)
# and at its training batch of 2,048; the small model's two levels at B =
# 1,000; per-expert inputs at the cell's widths; N = 1; the depth's edge;
# 16 columns at many outputs (the gate kernel's, or the tile's where W is
# too deep for it)
BANK_ROUTES = [
    (1, 4, 8192, 2176, 512, True, True),
    (1, 4, 8192, 512, 256, True, True),
    (1, 4, 8191, 2176, 512, True, True),
    (1, 4, 64, 512, 256, True, True),
    (1, 4, 8192, 2176, 512, False, False),
    (1, 4, 8192, 429, 128, True, False),
    (4, 4, 8192, 128, 64, True, False),
    (1, 2, 8192, 429, 4, True, False),
    (1, 2, 8192, 128, 64, True, False),
    (1, 2, 2048, 128, 64, True, False),
    (1, 2, 1000, 24, 16, True, False),
    (1, 2, 1000, 16, 8, True, False),
    (4, 4, 8192, 2176, 512, True, False),
    (1, 1, 8192, 512, 256, True, True),
    (1, 2, 8192, 188, 64, True, False),
    (1, 2, 8192, 192, 64, True, True),
    (1, 4, 1 << 20, 5000, 4, True, False),
]


@pytest.mark.parametrize("nx,n,b,d,u,aligned,taken", BANK_ROUTES)
def test_wgmma_bank_routing(nx, n, b, d, u, aligned, taken):
    """``takes_wgmma_bank`` at the cell's, config 4's and the small
    model's shapes and at the edges: a shared input, D % 4 == 0, x on
    the 16-byte grid, more than 16 columns, the crossover's depth and
    outputs."""
    assert mk.takes_wgmma_bank(nx, n, b, d, u, aligned) is taken


@pytest.mark.parametrize("n,d,u", [(4, 2176, 512), (4, 512, 256),
                                   (2, 256, 64), (1, 192, 17)])
def test_wgmma_bank_crossover(n, d, u):
    """The least batch the predicate gives the wgmma design is the one
    whose B * N * U reaches ``BANK_WGMMA_MIN_OUTPUTS``, and no batch
    gives it a bank shallower than ``BANK_WGMMA_MIN_DEPTH``."""
    least = -(-mk.BANK_WGMMA_MIN_OUTPUTS // (n * u))
    assert mk.takes_wgmma_bank(1, n, least, d, u, True)
    assert not mk.takes_wgmma_bank(1, n, least - 1, d, u, True)
    shallow = mk.BANK_WGMMA_MIN_DEPTH - 4
    assert not mk.takes_wgmma_bank(1, n, 1 << 20, shallow, u, True)


@pytest.mark.cuda
@pytest.mark.parametrize("with_bias", [True, False])
@pytest.mark.parametrize("d,u", [(2176, 512), (512, 256)])
def test_banks_at_the_cells_shapes(dev, d, u, with_bias):
    """Each level's bank as the cell runs it, (1, 8,192, D) x (4, D, U)
    with ReLU, bias on and off, on the banks' wgmma design (counted
    ``multi_dense.tc`` and ``multi_dense.tc_wgmma``, not
    ``multi_dense.gate``), against ``multi_dense_xla`` in float64."""
    x, w, bias = _bank(dev, 8192, 4, d, u, d + u)
    bias = bias if with_bias else None
    assert not mk.takes_gate_kernel(1, 4, d, u)
    assert mk.takes_wgmma_bank(1, 4, 8192, d, u, x.data_ptr() % 16 == 0)
    before = _counts()
    got = mk.multi_dense_fused(x, w, bias, True)
    assert _launched(before) == {
        "multi_dense.mma": 1, "multi_dense.tc": 1, "multi_dense.gate": 0,
        "multi_dense.tc_wgmma": 1}
    _close_f64(got, x, w, bias, True)


# (b, n, d, u) forced onto the wgmma design: B off the 128-row tile; U
# that no pass width divides (passes of 200 straddle the experts of 96
# units); an odd U (one float a store, pairs across experts); N = 1; D off
# the 32-float k-block; a single row
WGMMA_EDGES = [(1000, 4, 512, 256), (300, 4, 64, 96), (257, 3, 40, 17),
               (777, 1, 512, 256), (129, 2, 36, 64), (1, 4, 128, 128)]


@pytest.mark.cuda
@pytest.mark.parametrize("b,n,d,u", WGMMA_EDGES)
def test_wgmma_bank_edges(dev, b, n, d, u):
    """The banks' wgmma design at edge shapes, forced below the
    crossover: ReLU and bias each on and off against float64, each call
    one ``multi_dense.tc_wgmma`` launch; a repeat bit-equal."""
    x, w, bias = _bank(dev, b, n, d, u, b + d + u)
    for bb in (bias, None):
        for relu in (True, False):
            before = _counts()
            got = mk._multi_dense_fused(x, w, bb, relu, True)
            assert _launched(before) == {
                "multi_dense.mma": 1, "multi_dense.tc": 1,
                "multi_dense.gate": 0, "multi_dense.tc_wgmma": 1}
            _close_f64(got, x, w, bb, relu)
    assert torch.equal(got, mk._multi_dense_fused(x, w, None, False, True))


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["per_expert", "d429", "off_grid",
                                  "below", "shallow"])
def test_wgmma_bank_refusals_stay_on_the_tile(dev, case):
    """What ``takes_wgmma_bank`` refuses runs the split-TF32 tile as
    before, ``multi_dense.tc`` +1 and ``multi_dense.tc_wgmma`` +0: a
    per-expert input, config 4's D = 429, x off the 16-byte grid, one
    row short of the crossover's outputs, D = 128 (config 4's PLE
    experts' depth); a repeat bit-equal."""
    n, u = 4, 256
    d = {"d429": 429, "shallow": 128}.get(case, 512)
    b = 8192 if case != "below" else mk.BANK_WGMMA_MIN_OUTPUTS // (n * u) - 1
    x, w, bias = _bank(dev, b, n, d, u, 31)
    if case == "per_expert":
        x = torch.cat([x, x.flip(1), -x, 2 * x])
    if case == "off_grid":
        x = torch.empty(x.numel() + 1, device=dev)[1:].view(x.shape).copy_(x)
    assert not mk.takes_wgmma_bank(x.shape[0], n, b, d, u,
                                   x.data_ptr() % 16 == 0)
    before = _counts()
    got = mk.multi_dense_fused(x, w, bias, True)
    assert _launched(before) == {
        "multi_dense.mma": 1, "multi_dense.tc": 1, "multi_dense.gate": 0,
        "multi_dense.tc_wgmma": 0}
    assert torch.equal(got, mk.multi_dense_fused(x, w, bias, True))
    _close_f64(got, x, w, bias, True)


@pytest.mark.cuda
def test_gate_kernel_is_counted_apart(dev):
    """A shared input with N * U <= 16 takes the f32 gate kernel, counted
    ``multi_dense.gate``."""
    x = torch.rand(1, 300, 64, device=dev)
    w = torch.rand(2, 64, 4, device=dev)
    assert mk.takes_gate_kernel(1, 2, 64, 4)
    before = _counts()
    mk.multi_dense_fused(x, w, None, False)
    assert _launched(before) == {
        "multi_dense.mma": 1, "multi_dense.tc": 0, "multi_dense.gate": 1,
        "multi_dense.tc_wgmma": 0}


@pytest.mark.cuda
def test_served_model_on_the_card(dev):
    """The small model served on the card: six bank launches a request
    (3 banks a level), each on the kernel ``takes_gate_kernel`` names for
    its shape (level 1's on the tile, level 2's N * U = 16 on the gate
    kernel), the spans ``ple`` and ``towers`` with stream time, and the
    logits within 1e-5 of the CPU's."""
    ref = _reference()
    fc = _fc()
    params = _weights(ref, SMALL, 4)
    table, dense, ids = _request(fc, 1000, 5)
    out = {}
    for device in ("cpu", dev):
        scorer = build_scorer(_model(device=device), fc,
                              EmbeddingTable(fc.total_rows, 8, device),
                              device=device)
        state = ServingState({k: p.to(device) for k, p in params.items()},
                             table.to(device))
        before = _counts()
        profiling.enable()
        try:
            out[str(device)] = scorer(state, dense, ids).cpu()
            spans = profiling.span_report()["spans"]
        finally:
            profiling.disable()
        after = _counts()
        got = {k: after[k] - before[k] for k in after}
        if device == "cpu":
            assert got == {k: 0 for k in got}
        else:
            assert got == {"multi_dense.mma": 6, "multi_dense.tc": 3,
                           "multi_dense.gate": 3, "multi_dense.tc_wgmma": 0}
            assert not mk.takes_gate_kernel(1, 2, 24, 16)
            assert mk.takes_gate_kernel(1, 2, 16, 8)
            for name in ("ple", "towers"):
                assert spans[name]["stream_ms"] > 0
    want = out["cpu"]
    assert float((out[str(dev)] - want).abs().max()) <= 1e-5 * float(
        want.abs().max())

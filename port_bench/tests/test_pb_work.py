"""FLOP counts and kernel bounds on hand-counted shapes."""
import pytest
import torch

import harness
import work


def _bound(name):
    return harness.load_path(harness.ROOT / "bounds" / f"{name}.py",
                             "t_bound_" + name)


def test_pb_cin_flops_by_hand():
    # F = 2, prev = x0: 3 symmetric products a row, 2 multiply-adds per
    # (channel, product): 3 + 2 * 1 * 3 = 9 against W first 2*1*2*3 = 12
    assert work.cin_flops(1, 2, 2, 1, True) == 9
    # prev of H = 1, F = 2: 2 products, 2 * K * 2 = 8 -> 10; W first 2*2*2*2
    assert work.cin_flops(1, 2, 1, 2, False) == 10
    assert work.bound_s(495e12, 0) == pytest.approx(1.0)
    assert work.bound_s(0, 3.35e12) == pytest.approx(1.0)


def test_pb_gather_bound():
    table = torch.zeros(10, 4)
    ids = torch.tensor([[1, 1, 3], [9, 30, -2]])        # clamps: 9, 9, 0
    ops, nbytes = _bound("gather_rows").work(
        _bound("gather_rows").record((table, ids), {}))
    assert ops == 0 and nbytes == 4 * 16 + 6 * 16 + 6 * 8


def test_pb_cin_flat_bound():
    x0 = torch.zeros(6, 2)
    b = _bound("cin_flat")
    # layer 1: prev is x0 itself, read once, on its symmetric pairs
    rec = b.record((x0, x0, torch.zeros(3, 2, 2)), {})
    assert b.work(rec) == (work.cin_flops(6, 2, 2, 3, True),
                           (12 + 12 + 18) * 4)
    prev = torch.zeros(6, 3)
    rec = b.record((x0, prev, torch.zeros(4, 2, 3)), {})
    assert b.work(rec) == (work.cin_flops(6, 2, 3, 4, False),
                           (12 + 18 + 24 + 24) * 4)


def test_pb_model_flops_by_hand():
    cfg = {"num_fields": 3, "embedding_dim": 2, "cin_layer_size": 4,
           "cin_layers": 2, "dnn_layer_size": 5, "dnn_layers": 2}
    m = 7 * 2
    # layer 1 on 6 symmetric pairs: min(6m + 2*4*6m, 2*4*3*4m); layer 2
    # min(12m + 2*4*12m, 2*4*3*5m); pooling 4m each
    cin = min(6 * m + 48 * m, 96 * m) + min(12 * m + 96 * m, 120 * m) + 8 * m
    per = 2 * 6 * 5 + 2 * 5 * 5 + 2 * (8 + 5) + 3
    assert harness.flops("xdeepfm-criteo").request_flops(cfg, 7) == (
        cin + 7 * per)

"""The comparison that decides ``correct`` fails when the timed path is
broken underneath, at a small size on the CPU: a served answer altered
where it is produced, half of a request's answers left out (the rest
repeated in their place), and a CIN layer's work left out."""
from conftest import small_cell


def _run():
    cell = small_cell()
    return cell.driver().run(cell)


def test_pb_sound_run_is_correct():
    out = _run()
    assert out["correct"] is True and out["failed"] == 0


def test_pb_altered_answer_fails(monkeypatch):
    import rec_now_tpu_torch.serving as serving
    forward = serving._forward

    def altered(*args):
        out = forward(*args)
        return out + 1e-2 * out.abs().max()

    monkeypatch.setattr(serving, "_forward", altered)
    assert _run()["correct"] is False


def test_pb_half_batch_fails(monkeypatch):
    import torch

    import rec_now_tpu_torch.serving as serving
    forward = serving._forward

    def half(model, fc, table, can, state, dense, ids):
        n = ids.shape[0] // 2
        out = forward(model, fc, table, can, state, dense[:n], ids[:n])
        return torch.cat([out, out])[:ids.shape[0]]

    monkeypatch.setattr(serving, "_forward", half)
    assert _run()["correct"] is False


def test_pb_cin_layer_left_out_fails(monkeypatch):
    import torch

    import rec_now_tpu_torch.layers.cin_layer as cin_layer
    contract = cin_layer.cin_contract
    calls = []

    def third_left_out(x0, prev, w):
        calls.append(1)
        out = contract(x0, prev, w)
        return torch.zeros_like(out) if len(calls) % 3 == 0 else out

    monkeypatch.setattr(cin_layer, "cin_contract", third_left_out)
    out = _run()
    assert calls and out["correct"] is False

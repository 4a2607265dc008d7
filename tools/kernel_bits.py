"""Hold the in-batch loss and count kernels (B3, B6, B7a, B7c), the dense
Adagrad pass (B9) and lazy Adam (B10) of two trees of the port bit for
bit, on the card, and time the pair counts (B7a/b/c), the general
pairwise loss, B9 and B10 of one tree.

    python tools/kernel_bits.py dump TREE OUT.pt  # TREE/rec_now_tpu_torch
    python tools/kernel_bits.py compare A.pt B.pt  # exit 1 on a difference
    python tools/kernel_bits.py time TREE          # B7a/b/c, general, B9, B10

``dump`` runs each kernel of ``TREE``'s package (built into its own
``_build/``) on inputs made from fixed seeds and saves the outputs: B3
at B = 8,192 on a ``SyntheticCriteo`` batch's labels with five kinds of
main group (SyntheticCriteo's zipf users, one group, singletons, ids at
the int32 ends, 1,100 random ids), power 0 and -0.5; B6 (the listwise
loss) on the clicks and each of the five; B7a on the same five with the batch's graded labels (click + conversion),
its domain as the second condition and a 0/1 mask, with and without the
wrong-order filter; B7c on the five main groups with the clicks, with
and without a 0/1 mask; B9 and B10 at every width of D / 4 threads a row
(4 to 128) on tables of 2.6M (D = 16), 12,345, 1,001, 777, 513 and 300
rows, B10 with a share of rows touched, t = 1 and 1,000.  ``compare``
prints how many of the cases differ.  ``time`` prints B7a, B7b and B7c
on the inputs of ``chip_smoke.py`` phase 3's timing (B7a the graded
labels, two conditions and the mask; B7b the group vector and B7a's
counts; B7c the clicks and the mask) through the public wrappers, the
general call of the public ``pairwise_loss`` (the graded labels, the two
conditions, the mask, power -0.5, the loss's sum and its dlogits by
autograd, the entry point's own ops included), B9 over the 2.6M x 16
table and config 5's 100,000 x 272 CAN table, and B10 over the 2.6M x 16
table with 212,992 random rows touched and over the CAN table with the
batch's field-8 rows (a width the tree refuses is named so): CUDA events (median of 20) and the
device time by kernel (``torch.profiler``, a call's mean over 20, with
the count of device operations a call).  Run each mode once per tree,
each in its own process: both trees name their package
``rec_now_tpu_torch``.
"""
import os
import sys

import torch


def _inputs(dev):
    """The SyntheticCriteo B = 8,192 batch on the card, its five kinds of
    main group, logits and a 0/1 mask from a fixed seed."""
    from rec_now_tpu_torch.training.data import SyntheticCriteo
    gen = torch.Generator().manual_seed(7)
    batch = next(SyntheticCriteo(seed=0).batches(8192, 1, seed=1))
    grp = torch.as_tensor(batch.group_ids).to(dev)
    x = torch.randn(8192, generator=gen).to(dev)
    wide = torch.tensor([-2 ** 31, 2 ** 31 - 1, -70000, -7, 0, 2 ** 24 + 1],
                        dtype=torch.int32)
    wide = wide[torch.randint(0, 6, (8192,), generator=gen)].to(dev)
    groups = {"zipf": grp, "one": torch.zeros_like(grp),
              "singletons": torch.arange(8192, device=dev,
                                         dtype=torch.int32),
              "wide ids": wide,
              "random": torch.randint(0, 1100, (8192,),
                                      generator=gen).int().to(dev)}
    return dict(
        x=x, groups=groups, gen=gen,
        lab=torch.as_tensor(batch.labels).to(dev),
        can_ids=torch.as_tensor(batch.sparse_ids[:, 8] % 100_000).long()
        .to(dev),
        graded=torch.as_tensor(batch.labels + batch.cvr_labels).to(dev),
        dom=torch.as_tensor(batch.domain_idx).to(dev),
        mask=(torch.rand(8192, generator=gen) > 0.1).float().to(dev))


def dump(tree: str, out: str) -> None:
    sys.path.insert(0, tree)
    from rec_now_tpu_torch.ops import listwise_kernel as lk
    from rec_now_tpu_torch.ops import pairwise_kernel as pk
    from rec_now_tpu_torch.ops import table_update_kernel as tk
    dev = torch.device("cuda", 0)
    inp = _inputs(dev)
    x, lab, gen = inp["x"], inp["lab"], inp["gen"]
    res = {}
    for name, g in inp["groups"].items():
        for power in (-0.5, 0.0):
            got = pk.pair_loss_fused(x, lab, g, 0.8, power)
            res[f"B3 {name} power={power}"] = [t.cpu() for t in got]
        got = lk.listwise_loss_fused(x, lab, g)
        res[f"B6 {name}"] = [t.cpu() for t in got]
    for name, g in inp["groups"].items():
        for wrong in (False, True):
            got = pk.pair_row_counts(x, inp["graded"], [g, inp["dom"]],
                                     inp["mask"], wrong)
            res[f"B7a {name} wrong_order={wrong}"] = [got.cpu()]
        for mask in (inp["mask"], None):
            got = pk.group_pair_counts_binary(g, lab, mask)
            res[f"B7c {name} mask={mask is not None}"] = [got.cpu()]
    for v, d in ((2_600_000, 16), (12345, 16), (1001, 8), (513, 4),
                 (777, 32), (300, 64), (300, 128)):
        table = torch.randn(v, d, generator=gen).to(dev) * 1e-3
        acc = torch.rand(v, generator=gen).to(dev) * 0.1
        g = torch.randn(v, d, generator=gen).to(dev) * (
            torch.rand(v, generator=gen) < 0.3).to(dev)[:, None]
        tk.adagrad_dense_pass(table, acc, g, 0.05)
        res[f"B9 V={v} D={d}"] = [table.cpu(), acc.cpu()]
    for v, d, share in ((2_600_000, 16, 0.014), (12345, 16, 0.3),
                        (1001, 8, 0.5), (513, 16, 0.5), (513, 4, 0.5),
                        (777, 32, 0.5), (300, 64, 0.5), (300, 128, 0.5)):
        touched = (torch.rand(v, generator=gen) < share).to(dev)
        table = torch.randn(v, d, generator=gen).to(dev) * 1e-3
        m = torch.randn(v, d, generator=gen).to(dev) * 1e-3
        vv = torch.randn(v, d, generator=gen).to(dev).square() * 1e-6
        g = torch.randn(v, d, generator=gen).to(dev) * 1e-3 * touched[:, None]
        for t in (1, 1000):
            count = torch.tensor(t, dtype=torch.int32, device=dev)
            state = [z.clone() for z in (table, m, vv)]
            tk.adam_dense_pass(*state, g, touched, count, 1e-3)
            res[f"B10 V={v} D={d} t={t}"] = [z.cpu() for z in state]
    torch.save(res, out)


def time_counts(tree: str) -> None:
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    import chip_smoke as cs
    sys.path.insert(0, tree)
    from rec_now_tpu_torch.losses.pairwise import pairwise_loss
    from rec_now_tpu_torch.ops import pairwise_kernel as pk
    from rec_now_tpu_torch.ops import table_update_kernel as tk
    dev = torch.device("cuda", 0)
    inp = _inputs(dev)
    grp, mask = inp["groups"]["zipf"], inp["mask"]
    two = [grp, inp["dom"]]
    counts = pk.pair_row_counts_plain(inp["x"], inp["graded"], two, mask)
    xg = inp["x"].clone().requires_grad_()

    def general():
        loss = pairwise_loss(xg, inp["graded"], two,
                             click_occurance_power=-0.5, mask=mask,
                             reduce_mean=False)
        return torch.autograd.grad(loss, xg)

    gen = inp["gen"]
    ids = torch.randint(0, 2_600_000, (212_992,), generator=gen).to(dev)
    touched = torch.zeros(2_600_000, dtype=torch.bool, device=dev)
    touched.index_fill_(0, ids, True)
    tables = {d: [torch.randn(v, d, generator=gen).to(dev) * 1e-3,
                  torch.full((v,), 0.1, device=dev),
                  torch.randn(v, d, generator=gen).to(dev)]
              for v, d in ((2_600_000, 16), (100_000, 272))}
    t16, _, g16 = tables[16]
    m16, v16 = torch.zeros_like(t16), torch.zeros_like(t16)
    one = torch.ones((), dtype=torch.int32, device=dev)
    # config 5's CAN table with the batch's field-8 rows touched
    t272, _, g272 = tables[272]
    m272, v272 = torch.zeros_like(t272), torch.zeros_like(t272)
    can = torch.zeros(100_000, dtype=torch.bool, device=dev)
    can.index_fill_(0, inp["can_ids"], True)
    calls = {"B7a pair_row_counts": lambda: pk.pair_row_counts(
                 inp["x"], inp["graded"], two, mask),
             "B7b same_group_matvec": lambda: pk.same_group_matvec(
                 grp, counts),
             "B7c group_pair_counts_binary": lambda: pk
             .group_pair_counts_binary(grp, inp["lab"], mask),
             "general pairwise_loss, fwd + bwd": general,
             "B9 adagrad_dense_pass V=2600000 D=16": lambda: tk
             .adagrad_dense_pass(*tables[16], 0.05),
             "B9 adagrad_dense_pass V=100000 D=272": lambda: tk
             .adagrad_dense_pass(*tables[272], 0.05),
             f"B10 adam_dense_pass V=2600000 D=16, {int(touched.sum())} "
             f"rows touched": lambda: tk.adam_dense_pass(
                 t16, m16, v16, g16, touched, one, 1e-3),
             f"B10 adam_dense_pass V=100000 D=272, {int(can.sum())} rows "
             f"touched": lambda: tk.adam_dense_pass(
                 t272, m272, v272, g272, can, one, 1e-3)}
    card = cs.smi()
    for what, fn in calls.items():
        try:
            fn()
        except ValueError as e:            # a width the tree refuses
            print(f"{tree}: {what} refused: {e} [{card}]")
            continue
        ms = cs.cuda_ms(torch, fn)
        seq = cs.profiled_sequence(torch, fn)
        by = {}
        for n, t in seq:
            by[cs.kernel_name(n)] = by.get(cs.kernel_name(n), 0.0) + t / 20
        print(f"{tree}: {what} {ms:.4f} ms by events, "
              f"{sum(by.values()):.4f} on the device in {len(seq) / 20:g} "
              f"operations a call ("
              + "; ".join(f"{n} {t:.4f}" for n, t in by.items())
              + f") [{card}]")


def compare(a: str, b: str) -> int:
    ra, rb = torch.load(a), torch.load(b)
    if ra.keys() != rb.keys():
        print(f"the dumps hold other cases: {sorted(ra)} vs {sorted(rb)}")
        return 1
    bad = [k for k in ra
           if not all(torch.equal(x, y) for x, y in zip(ra[k], rb[k]))]
    print(f"bit-compare: {len(ra)} cases, {len(bad)} differ: {bad}")
    return 1 if bad else 0


if __name__ == "__main__":
    argc = {"dump": 4, "compare": 4, "time": 3}
    if len(sys.argv) < 2 or argc.get(sys.argv[1]) != len(sys.argv):
        sys.exit(__doc__)
    if sys.argv[1] == "compare":
        sys.exit(compare(sys.argv[2], sys.argv[3]))
    if sys.argv[1] == "time":
        time_counts(sys.argv[2])
    else:
        dump(sys.argv[2], sys.argv[3])

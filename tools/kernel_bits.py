"""Hold the pair loss (kernel B3) and lazy Adam (B10) of two trees of the
port bit for bit, on the card.

    python tools/kernel_bits.py dump TREE OUT.pt  # TREE/rec_now_tpu_torch
    python tools/kernel_bits.py compare A.pt B.pt  # exit 1 on a difference

``dump`` runs each kernel of ``TREE``'s package (built into its own
``_build/``) on inputs made from fixed seeds -- B3 at B = 8,192 on a
``SyntheticCriteo`` batch's labels with five kinds of main group
(SyntheticCriteo's zipf users, one group, singletons, ids at the int32
ends, 1,100 random ids), power 0 and -0.5; B10 on tables of 2.6M, 12,345,
1,001 and 513 rows with a share of rows touched, t = 1 and 1,000 -- and
saves the outputs.  ``compare`` prints how many of the cases differ.  Run
``dump`` once per tree, each in its own process: both trees name their
package ``rec_now_tpu_torch``.
"""
import sys

import torch


def dump(tree: str, out: str) -> None:
    sys.path.insert(0, tree)
    from rec_now_tpu_torch.ops import pairwise_kernel as pk
    from rec_now_tpu_torch.ops import table_update_kernel as tk
    from rec_now_tpu_torch.training.data import SyntheticCriteo
    dev = torch.device("cuda", 0)
    gen = torch.Generator().manual_seed(7)
    res = {}
    batch = next(SyntheticCriteo(seed=0).batches(8192, 1, seed=1))
    lab = torch.as_tensor(batch.labels).to(dev)
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
    for name, g in groups.items():
        for power in (-0.5, 0.0):
            got = pk.pair_loss_fused(x, lab, g, 0.8, power)
            res[f"B3 {name} power={power}"] = [t.cpu() for t in got]
    for v, d, share in ((2_600_000, 16, 0.014), (12345, 16, 0.3),
                        (1001, 8, 0.5), (513, 16, 0.5)):
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
    if len(sys.argv) != 4 or sys.argv[1] not in ("dump", "compare"):
        sys.exit(__doc__)
    if sys.argv[1] == "compare":
        sys.exit(compare(sys.argv[2], sys.argv[3]))
    dump(sys.argv[2], sys.argv[3])

"""The check of sampled-minibatch training.

Sampling draws from the program's own generator, so the reference follows
the program's batches: each checked batch is first judged against the
generated graph (``reference.graph.sample_violations``: every edge a graph
edge, each hop's fanout, the node order, the in-neighbour matrix, seeds
from the train split), and the features the step received against the
generated features at the batch's node ids. The reference then computes
each step from the batch's edges, the generated features and labels, and
is compared on each step's loss and logits, the first gradient and the
parameters' change.
"""

from __future__ import annotations

import torch

from gnnbench import spec
from gnnbench.reference import common, graph


def _follow(record, data, cell, prec):
    cfg = cell.config
    plain = spec.reference(cfg["family"])
    model, opt = cfg["model"], cfg["optimizer"]
    batches = []
    for b in record["blocks"]:
        ids = b["node_ids"].long()
        inputs = (data.features[ids], b["src"].long(), b["dst"].long())
        batches.append((inputs, data.labels[b["seeds"].long()],
                        b["seed_mask"]))
    return common.train_steps(
        lambda p, x, pr: plain.forward(p, x, model, pr), record["params0"],
        batches, lr=opt["learning_rate"], weight_decay=opt["weight_decay"],
        prec=prec)


def readings(record, data, cell, prec=common.EXACT,
             details=None) -> dict:
    n = data.n_nodes
    keys = torch.sort(data.dst * n + data.src).values
    in_degree = torch.bincount(data.dst, minlength=n)
    bad = sum(graph.sample_violations(b, keys, in_degree, n,
                                      cell.mix["fanouts"], data.train_mask)
              for b in record["blocks"])
    del keys
    fed = 0
    for b, x in zip(record["blocks"], record["inputs"]):
        fed += int((x != data.features[b["node_ids"].long()]).sum())
    fed += abs(len(record["inputs"]) - len(record["blocks"]))
    ref = _follow(record, data, cell, prec)
    out = common.training_readings(record, ref, record["params0"])
    if details is not None:
        details.update(common.training_details(record, ref,
                                                record["params0"]))
    out.update(sample_violations=bad, feature_mismatch=fed)
    return out


def control(record, data, cell, kinds=("tf32",)) -> dict:
    """``{kind: (readings, details)}`` of the reference run as each of
    ``kinds`` (``common.KINDS``) in the program's place."""
    ref = _follow(record, data, cell, common.EXACT)
    out = {}
    for kind in kinds:
        ctl = _follow(record, data, cell, common.KINDS[kind])
        out[kind] = (common.training_readings(ctl, ref, record["params0"]),
                     common.training_details(ctl, ref, record["params0"]))
    return out

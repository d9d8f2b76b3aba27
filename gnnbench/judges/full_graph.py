"""The check of full-graph training.

Compared: the view the step took against the reference's own rule (dense
blocks where the largest component fits 128 nodes, else ELL), each slot of
both ELL packings against the generated edges, and, over the checked steps
(one AdamW step each over the whole graph), each step's loss and logits,
the first gradient and the parameters' change.
"""

from __future__ import annotations

from gnnbench import spec
from gnnbench.reference import common, graph


def _follow(record, data, cell, prec):
    cfg = cell.config
    plain = spec.reference(cfg["family"])
    model, opt = cfg["model"], cfg["optimizer"]
    inputs = (data.features, data.src, data.dst)
    steps = len(record["losses"]) or cell.mix["check_steps"]
    return common.train_steps(
        lambda p, x, pr: plain.forward(p, x, model, pr), record["params0"],
        [(inputs, data.labels, data.train_mask)] * steps,
        lr=opt["learning_rate"], weight_decay=opt["weight_decay"], prec=prec)


def readings(record, data, cell, prec=common.EXACT,
             details=None) -> dict:
    n = data.n_nodes
    view = int(record["view"] != graph.expected_view(data.src, data.dst, n))
    if record["view"] == "ell":
        view += graph.ell_view_mismatch(record["dst_view"], data.dst,
                                        data.src, n)
        view += graph.ell_view_mismatch(record["src_view"], data.src,
                                        data.dst, n)
    ref = _follow(record, data, cell, prec)
    out = common.training_readings(record, ref, record["params0"])
    if details is not None:
        details.update(common.training_details(record, ref,
                                                record["params0"]))
    out["view_mismatch"] = view
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

"""Worker of tests/test_torch_multiprocess.py: one of two gloo processes.

    python tests/torch_multiproc_worker.py RANK WORKDIR

Joins a two-rank gloo group through a file store in WORKDIR and runs, on
the process mesh, against the same computation on a local mesh of two
shards in this process:

- per-process row loading: ``process_row_range`` and
  ``sharded_node_array`` over a memmap, each rank reading its own rows;
- the halo plan kept by rank (every rank builds it whole and keeps its
  row of each plan array);
- one gradient step of ``halo_attention_ell`` with a replicated
  projection: the loss, the node gradients and the projection's gradient
  (summed over ranks in rank order) against the local mesh within 1e-5;
  the same attention on a 2-D (edge, head) process mesh equal to it;
- ``fit_edge_partitioned`` for 2 epochs against the local mesh within
  1e-5;
- ``fit_sampled_dp`` at P = 2 against the local mesh bit for bit;
- a ``torch.save`` checkpoint of this rank's shards that round-trips.

Prints lines the parent test reads; ``PASS <rank>`` last.
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-5)


def close(a, b, what):
    torch.testing.assert_close(a, b, **TOL, msg=what)


def main():
    rank, workdir = int(sys.argv[1]), sys.argv[2]
    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", init_method=f"file://{os.path.join(workdir, 'store')}",
        rank=rank, world_size=2)

    from custom_op_benchmark_tpu_torch.data import planted_partition
    from custom_op_benchmark_tpu_torch.data.distributed import (
        memmap_rows,
        process_row_range,
        sharded_node_array,
    )
    from custom_op_benchmark_tpu_torch.graph import random_graph
    from custom_op_benchmark_tpu_torch.models import GraphSAGE
    from custom_op_benchmark_tpu_torch.parallel import (
        fit_edge_partitioned,
        halo_attention_ell,
        halo_ell,
        global_sum,
        halo_graph,
        make_mesh,
        psum_grads,
    )
    from custom_op_benchmark_tpu_torch.train import fit_sampled_dp

    mesh = make_mesh(axis_names=("edge",), group=True)
    local = make_mesh((2,), ("edge",), device="cpu")
    assert mesh.shape == {"edge": 2} and not mesh.is_local

    # Per-process rows of a memmapped feature file.
    g = random_graph(96, 800, seed=2, power_law=True)
    hg = halo_graph(g, mesh)
    n_pad, d = hg.n_pad, 8
    lo, hi = process_row_range(n_pad, mesh, "edge")
    assert (lo, hi) == (rank * n_pad // 2, (rank + 1) * n_pad // 2)
    print(f"ROWRANGE {rank} {lo} {hi}", flush=True)
    calls = []
    base = memmap_rows(os.path.join(workdir, "feats.npy"))

    def loader(a, b):
        calls.append((a, b))
        return base(a, b)

    x = sharded_node_array(loader, n_pad, (d,), mesh)
    assert calls == [(lo, hi)], calls
    full = np.load(os.path.join(workdir, "feats.npy"))[:n_pad]
    assert np.array_equal(x.numpy(), full[lo:hi])

    # The plan kept by rank.
    for f in ("send_idx", "src_ext", "dst_loc", "eid", "recv_pos"):
        mine, host = getattr(hg, f), getattr(hg.host, f)
        assert mine.shape[0] == 1 and np.array_equal(mine[0].numpy(),
                                                     host[rank]), f
    print(f"PLAN {rank} ok", flush=True)

    # One halo-ELL gradient step across the two processes.
    he = halo_ell(hg, mesh)
    hgl = halo_graph(g, local)
    hel = halo_ell(hgl, local)
    w0 = torch.from_numpy(np.random.default_rng(1).normal(
        0, 0.3, (d, 2 * d)).astype(np.float32))

    def step(m, hgr, hel_, xs):
        w = w0.clone().requires_grad_()
        xs = xs.clone().requires_grad_()
        q = (xs @ w).reshape(xs.shape[0], 2, d)
        loss = (halo_attention_ell(hgr, hel_, m, q, q, q) ** 2).sum()
        gx, gw = torch.autograd.grad(loss, (xs, w))
        if not m.is_local:
            (gw,) = psum_grads(m, "edge", [gw])
            loss = global_sum(m, "edge", loss.detach())
        return loss.detach(), gx, gw

    loss_p, gx_p, gw_p = step(mesh, hg, he, x)
    loss_l, gx_l, gw_l = step(local, hgl, hel, torch.from_numpy(full))
    close(loss_p, loss_l, "loss")
    close(gx_p, gx_l[lo:hi], "node gradient")
    close(gw_p, gw_l, "projection gradient")
    print(f"STEP {rank} loss={loss_p.item():.6f}", flush=True)

    # The same step on a 2-D (edge, head) process mesh of 2 × 1: the
    # edge-axis collectives run in the axis's subgroup.
    mesh2 = make_mesh((2, 1), ("edge", "head"), group=True)
    hg2 = halo_graph(g, mesh2)
    he2 = halo_ell(hg2, mesh2)
    q2 = (x @ w0).reshape(x.shape[0], 2, d)
    y2 = halo_attention_ell(hg2, he2, mesh2, q2, q2, q2, head_axis="head")
    y1 = halo_attention_ell(hg, he, mesh, q2, q2, q2)
    assert torch.equal(y2, y1)
    print(f"MESH2D {rank} ok", flush=True)

    # Edge-partitioned training, 2 epochs.
    ds = planted_partition(num_classes=3, nodes_per_class=24, feat_dim=8,
                           avg_degree=6, seed=3)
    kw = dict(hidden=8, num_heads=2, num_layers=2, epochs=2,
              order="cluster")
    _, met_p = fit_edge_partitioned(ds, mesh, **kw)
    _, met_l = fit_edge_partitioned(ds, local, **kw)
    for key in ("loss", "train_acc", "val_acc"):
        assert abs(met_p[key] - met_l[key]) <= 1e-5 * (1 + abs(met_l[key])), \
            (key, met_p[key], met_l[key])
    print(f"FIT {rank} loss={met_p['loss']:.6f}", flush=True)

    # fit_sampled_dp at P = 2, bit for bit.
    dsa = planted_partition(num_classes=3, nodes_per_class=30, feat_dim=8,
                            avg_degree=6, seed=1)
    mesh_b = make_mesh(axis_names=("batch",), group=True)
    local_b = make_mesh((2,), ("batch",), device="cpu")
    runs = []
    for m in (mesh_b, local_b):
        model = GraphSAGE(hidden_dim=8, out_dim=3, num_layers=2, in_dim=8)
        state, met = fit_sampled_dp(model, dsa, m, fanouts=(4, 3),
                                    batch_size=8, epochs=1, max_steps=4,
                                    learning_rate=1e-2)
        runs.append((met["losses"], [p.detach().clone()
                                      for p in model.parameters()]))
    assert runs[0][0] == runs[1][0], (runs[0][0], runs[1][0])
    assert all(torch.equal(a, b) for a, b in zip(runs[0][1], runs[1][1]))
    print(f"DP {rank} steps={len(runs[0][0])} equal", flush=True)

    # A checkpoint of this rank's shards.
    path = os.path.join(workdir, f"ckpt_{rank}.pt")
    torch.save({"x": x, "gx": gx_p}, path)
    dist.barrier()
    back = torch.load(path)
    assert torch.equal(back["x"], x) and torch.equal(back["gx"], gx_p)
    print(f"CKPT {rank} ok", flush=True)
    dist.destroy_process_group()
    print(f"PASS {rank}", flush=True)


if __name__ == "__main__":
    main()

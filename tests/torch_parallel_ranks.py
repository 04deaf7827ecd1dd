"""Rank bodies of the multi-device CPU tests (tests/test_torch_parallel.py,
tests/test_torch_multi_device.py), run by ``parallel.mesh.launch`` in
processes of their own over gloo.  They import only the port: the test
process computes the JAX references and passes the inputs in a pickle;
each rank writes its results to ``<out>/rank<r>.pkl``."""

import os
import pickle

import numpy as np
import torch
import torch.distributed as dist


def _dump(out_dir, results):
    with open(os.path.join(out_dir, f"rank{dist.get_rank()}.pkl"), "wb") as f:
        pickle.dump(results, f)


def _named_grads(model, grads):
    return {name: g.detach().numpy().copy()
            for (name, _), g in zip(model.named_parameters(), grads)}


def loss_cases(case_path, out_dir):
    """For each case: this rank's global loss and the parameter gradients
    summed over the ranks (edgeshard losses), or the data- plus
    tensor-parallel step's loss and gradients (``form`` "dp")."""
    from gcnbmp_tpu_torch.convert import from_jax_params
    from gcnbmp_tpu_torch.models.packed import make_packed_predictor
    from gcnbmp_tpu_torch.parallel import edgeshard as es
    from gcnbmp_tpu_torch.parallel.collectives import all_reduce_sum_list
    from gcnbmp_tpu_torch.parallel.mesh import graph_mesh

    with open(case_path, "rb") as f:
        cases = pickle.load(f)
    rank, n = dist.get_rank(), dist.get_world_size()
    mesh = graph_mesh("cpu")
    losses = {"coo": es.make_edgeshard_coo_loss,
              "dense": es.make_edgeshard_loss,
              "gwm": es.make_edgeshard_gwm_loss,
              "coattn": es.make_edgeshard_coattn_loss}
    shards = {"coo": es.shard_packed_coo_batch,
              "dense": lambda b, m, device: es.shard_packed_batch(
                  b.to_dense(), m, device=device),
              "gwm": es.shard_packed_gwm_batch,
              "coattn": lambda b, m, device: es.shard_packed_coattn_batch(
                  b, m, n_max=c["n_max"], device=device),
              "pairlocal": lambda b, m, device:
                  es.shard_packed_coattn_batch_pairlocal(
                      b, c["meta"], m, n_max=c["n_max"], device=device)}
    results = {}
    for c in cases:
        if c["form"] in ("dp", "scan", "global"):
            results[c["name"]] = {"dp": _dp_case, "scan": _scan_case,
                                  "global": _global_case}[c["form"]](c)
            continue
        model = from_jax_params(c["tree"], make_packed_predictor(
            **c["kwargs"], compact=c["form"] != "dense"))
        elem = es.elementwise_loss_for(c["loss"], **c.get("loss_kwargs", {}))
        form = "coattn" if c["form"] == "pairlocal" else c["form"]
        loss_fn = losses[form](model, mesh, elementwise_loss=elem,
                               **c.get("form_kwargs", {}))
        loss = loss_fn(*shards[c["form"]](c["batch"], mesh, device="cpu"))
        loss.backward()
        grads = [torch.zeros_like(p) if p.grad is None else p.grad
                 for p in model.parameters()]
        grads = all_reduce_sum_list(grads)
        results[c["name"]] = (loss.item(), _named_grads(model, grads))
    _dump(out_dir, results)


def dense_cases(case_path, out_dir):
    """For each case (a dense batch, weights, a learning rate): this
    rank's global loss of ``make_edgeshard_loss`` over its block
    (``shard_packed_batch``) and the parameter gradients summed over the
    ranks; then two steps of ``make_edgeshard_train_step`` from the same
    weights on the case's two batches: (loss, gradients, step losses,
    parameters after the steps)."""
    from gcnbmp_tpu_torch.convert import from_jax_params
    from gcnbmp_tpu_torch.models.packed import make_packed_predictor
    from gcnbmp_tpu_torch.parallel import edgeshard as es
    from gcnbmp_tpu_torch.parallel.collectives import all_reduce_sum_list
    from gcnbmp_tpu_torch.parallel.mesh import graph_mesh
    from gcnbmp_tpu_torch.train.loop import ChainedAdam

    with open(case_path, "rb") as f:
        cases = pickle.load(f)
    mesh = graph_mesh("cpu")
    results = {}
    for c in cases:
        def fresh():
            return from_jax_params(c["tree"], make_packed_predictor(
                **c["kwargs"], compact=False))

        model = fresh()
        loss = es.make_edgeshard_loss(model, mesh)(
            *es.shard_packed_batch(c["batches"][0], mesh, device="cpu"))
        loss.backward()
        grads = _named_grads(model, all_reduce_sum_list(
            [torch.zeros_like(p) if p.grad is None else p.grad
             for p in model.parameters()]))
        model = fresh()
        step = es.make_edgeshard_train_step(
            model, ChainedAdam(list(model.parameters()),
                               lambda count: c["lr"]), mesh)
        losses = [step(*es.shard_packed_batch(b, mesh, device="cpu")).item()
                  for b in c["batches"]]
        results[c["name"]] = (loss.item(), grads, losses,
                              {n: p.detach().numpy().copy()
                                       for n, p in model.named_parameters()})
    _dump(out_dir, results)


def _scan_case(c):
    """``make_edgeshard_scan_train_step`` over ``stack_sharded_batches``
    of the case's partitions, and the same steps one by one through
    ``make_edgeshard_coo_train_step``: (scan losses, step losses, the
    parameters after each)."""
    from gcnbmp_tpu_torch.convert import from_jax_params
    from gcnbmp_tpu_torch.models.packed import make_packed_predictor
    from gcnbmp_tpu_torch.parallel import edgeshard as es
    from gcnbmp_tpu_torch.parallel.mesh import graph_mesh
    from gcnbmp_tpu_torch.train.loop import ChainedAdam

    mesh = graph_mesh("cpu")
    rank, n = dist.get_rank(), dist.get_world_size()
    out = []
    for scan in (True, False):
        model = from_jax_params(c["tree"],
                                make_packed_predictor(**c["kwargs"]))
        opt = ChainedAdam(list(model.parameters()), lambda count: 1e-2)
        if scan:
            stacked, labels = es.stack_sharded_batches(c["argses"], mesh)
            losses = es.make_edgeshard_scan_train_step(
                es.make_edgeshard_coo_loss(model, mesh), opt, mesh)(
                [torch.as_tensor(a) for a in stacked],
                torch.as_tensor(labels))
        else:
            step = es.make_edgeshard_coo_train_step(model, opt, mesh)
            losses = torch.stack([
                step(*(torch.as_tensor(np.asarray(a)) for a in
                       (*wire, lab)))
                for wire, lab in (es.local_wire(a, rank, n)
                                  for a in c["argses"])])
        out.append((losses.numpy().copy(), {
            k: v.detach().numpy().copy()
            for k, v in model.state_dict().items()}))
    return out


def _global_case(c):
    """``multihost.global_mesh`` over the ranks and
    ``host_local_to_global`` of each data rank's block: the whole
    array."""
    from gcnbmp_tpu_torch.parallel.multihost import (
        global_mesh, host_local_to_global)

    mesh = global_mesh(model_parallel=2, device_type="cpu")
    block = np.split(c["array"], mesh["data"].size())[
        mesh.get_local_rank("data")]
    return host_local_to_global(block, mesh).full_tensor().numpy()


def _dp_case(c):
    """``parallel.dp``'s step on the padded predictor over a 2 x 2 (data,
    model) mesh: the loss and the full gradients (each split weight's
    gathered from its model group)."""
    from gcnbmp_tpu_torch.convert import from_jax_params
    from gcnbmp_tpu_torch.models.predictor import set_up_predictor
    from gcnbmp_tpu_torch.parallel import (
        make_mesh, make_sharded_train_step, shard_params)
    from gcnbmp_tpu_torch.parallel.collectives import all_gather_tensor
    from gcnbmp_tpu_torch.parallel.dp import ColumnShardedLinear
    from gcnbmp_tpu_torch.train.loop import ChainedAdam

    seen = {}

    class Recording(ChainedAdam):
        def step(self, grads=None):
            seen["grads"] = [g.clone() for g in grads]
            super().step(grads)

    mesh = make_mesh(model_parallel=2, device_type="cpu")
    model = shard_params(from_jax_params(
        c["tree"], set_up_predictor(**c["kwargs"])), mesh)
    split = {name for name, m in model.named_modules()
             if isinstance(m, ColumnShardedLinear)}
    opt = Recording(list(model.parameters()), lambda count: 1e-3)
    loss = make_sharded_train_step(model, opt, mesh)(
        *(torch.as_tensor(a) for a in c["batch"]))
    grads = {}
    group = mesh.get_group("model")
    for (name, _), g in zip(model.named_parameters(), seen["grads"]):
        if name.rpartition(".")[0] in split and name.endswith("weight"):
            g = all_gather_tensor(g, group)
        grads[name] = g.numpy().copy()
    return float(loss), grads, sorted(split)


def cli_runs(spec_path, out_dir):
    """Each run of the spec through the train CLI (``--multi-device`` in
    its argv): this rank's step losses, its final parameters and epoch,
    how often it wrote a checkpoint, and the text of a refusal."""
    from gcnbmp_tpu_torch.cli import train as train_cli
    from gcnbmp_tpu_torch.train import checkpoints, loop

    with open(spec_path, "rb") as f:
        runs = pickle.load(f)
    results = {}
    real_step, real_save = loop.train_step, checkpoints.save_checkpoint
    real_fit = loop.Trainer.fit
    for name, argv in runs:
        rec = {"losses": [], "saves": 0}

        def step(*args, **kwargs):
            loss = real_step(*args, **kwargs)
            rec["losses"].append(float(loss))
            return loss

        def save(*args, **kwargs):
            rec["saves"] += 1
            return real_save(*args, **kwargs)

        def fit(self, *args, **kwargs):
            out = real_fit(self, *args, **kwargs)
            rec["epoch"] = out["state"].epoch
            rec["params"] = {k: v.detach().numpy().copy() for k, v in
                             self.model.state_dict().items()}
            rec["log"] = out["log"]
            return out

        loop.train_step, checkpoints.save_checkpoint = step, save
        loop.Trainer.fit = fit
        try:
            rec["rc"] = train_cli.main(argv)
        except ValueError as e:  # a refusal, the same on every rank
            rec["error"] = str(e)
        finally:
            loop.train_step, checkpoints.save_checkpoint = real_step, real_save
            loop.Trainer.fit = real_fit
        results[name] = rec
        dist.barrier()
    _dump(out_dir, results)


def prefetch_runs(spec_path, out_dir):
    """Each ``(name, csv path, TrainConfig kwargs)`` of the spec through
    the port's ``Trainer`` with ``multi_device`` on this process group
    (its ``out_dir`` under ``out_dir``): this rank's step losses."""
    from gcnbmp_tpu_torch.data import CSVPairParser
    from gcnbmp_tpu_torch.train import loop
    from gcnbmp_tpu_torch.train.config import TrainConfig

    with open(spec_path, "rb") as f:
        runs = pickle.load(f)
    results = {}
    real_step = loop.train_step
    for name, csv_path, kw in runs:
        losses = []

        def step(*args, **kwargs):
            loss = real_step(*args, **kwargs)
            losses.append(float(loss))
            return loss

        ds = CSVPairParser().parse(csv_path).dataset
        cfg = TrainConfig(**kw, multi_device=True,
                          out_dir=os.path.join(out_dir, name))
        loop.train_step = step
        try:
            loop.Trainer(cfg, ds, ds, device="cpu").fit()
        finally:
            loop.train_step = real_step
        results[name] = losses
        dist.barrier()
    _dump(out_dir, results)

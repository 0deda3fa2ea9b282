"""Rank workers of ``tests/test_torch_parallel.py``,
``tests/test_torch_parallel_training.py``,
``tests/test_torch_parallel_heads.py``,
``tests/test_torch_parallel_families.py`` and
``tests/test_torch_parallel_routes.py``.

Every function here runs on each rank started by
``anemoi_tpu_torch.parallel.distributed.spawn`` (gloo on the CPU, one thread
a rank) and returns plain numpy, which the test process holds against the
JAX package.  The module imports the port alone: a spawned rank imports
neither ``tests/conftest.py`` nor jax.
"""

from __future__ import annotations

import copy
import os

import numpy as np
import torch

from anemoi_tpu_torch.data_indices.collection import IndexCollection
from anemoi_tpu_torch.models.graph import SubGraphArrays
from anemoi_tpu_torch.models.interface import AnemoiModelInterface
from anemoi_tpu_torch.parallel import distributed
from anemoi_tpu_torch.parallel.halo import halo_gt_attention, pad_rows, permute_rows
from anemoi_tpu_torch.parallel.mesh import MeshSpec, create_mesh
from anemoi_tpu_torch.training.losses import get_loss_function
from anemoi_tpu_torch.training.losses.scalers import create_scalers
from anemoi_tpu_torch.training.optimizers import build_optimizer
from anemoi_tpu_torch.training.step import TrainState, make_step_fns


def _np(t, like=None):
    """numpy of ``t``; a gradient that never formed (a rank without rows)
    as zeros shaped ``like``."""
    if t is None:
        return np.zeros(tuple(like.shape), np.float32)
    return t.detach().cpu().numpy()


def halo_attention(cases):
    """Per case (an edge set, the inputs of the whole sets, the model group's
    size ``S`` and an ``overlap`` flag) this rank's share of
    ``halo_gt_attention`` with the projection fused (K1's form): its rows of
    the output and of dq / dk / dv, and its shares of the gradients of the
    edge attributes and of the projection (the test sums those over the
    ranks of one model group).  A world of W ranks runs ``S`` < W as W / S
    data groups of the same model group shape."""
    world = distributed.launch().world
    meshes = {s: create_mesh(MeshSpec(data=world // s, model=s))
              for s in sorted({c["S"] for c in cases})}
    out = []
    for case in cases:
        mesh = meshes[case["S"]]
        sub = SubGraphArrays(
            edge_index=torch.as_tensor(case["edge_index"]),
            dst_ptr=torch.as_tensor(case["dst_ptr"]), edge_attr=torch.as_tensor(case["attr"]),
            num_src=case["num_src"], num_dst=case["num_dst"])
        shard = sub.sharded_edge_data(mesh.size("model"), mesh.index("model"),
                                      mesh.group("model"), overlap=case["overlap"])
        dst, src = shard.dst_rows, shard.src_rows
        leaf = {k: torch.tensor(case[k], requires_grad=True) for k in ("attr", "weight", "bias")}
        q = torch.tensor(case["q"][:, dst], requires_grad=True)
        k = torch.tensor(case["k"][:, src], requires_grad=True)
        v = torch.tensor(case["v"][:, src], requires_grad=True)
        res = halo_gt_attention(
            pad_rows(q, shard.n_local), pad_rows(k, shard.n_local_src),
            pad_rows(v, shard.n_local_src), shard, case["heads"],
            edge_attr=permute_rows(leaf["attr"], shard.edge_perm, shard.edge_perm_inv),
            weight=leaf["weight"], bias=leaf["bias"])[:, : q.shape[1]]
        (res * torch.as_tensor(case["cotangent"][:, dst])).sum().backward()
        out.append({"out": _np(res), "dq": _np(q.grad, q), "dk": _np(k.grad, k),
                    "dv": _np(v.grad, v),
                    **{f"d_{name}": _np(t.grad, t) for name, t in leaf.items()},
                    "dst": (dst.start, dst.stop), "src": (src.start, src.stop),
                    "data_index": mesh.index("data")})
    return out


def _interface(setup, mesh, config):
    graph = setup["graph"]
    indices = {ds: IndexCollection(**kw) for ds, kw in setup["indices"].items()}
    iface = AnemoiModelInterface(config=config, graph=graph, data_indices=indices,
                                 statistics=setup["statistics"], device="cpu", training=True,
                                 mesh=mesh)
    iface.load_state_dict({k: torch.as_tensor(v) for k, v in setup["state_dict"].items()},
                          strict=True)
    return iface


class FixedDraws:
    """The port's standard normal draws (the ensemble noise and every
    transport draw) replaced by given arrays, one per shape, the same array
    at every call: the one-process arrays of the global batch and grid that
    a test hands the JAX package too (whose jitted step draws once)."""

    def __init__(self, draws):
        from anemoi_tpu_torch.models.layers import ensemble
        from anemoi_tpu_torch.models.transport import random_fields

        self.draws, self.patched = draws or {}, []
        if self.draws:
            for module in (ensemble, random_fields):
                self.patched.append((module, module.standard_normal))
                module.standard_normal = self.normal

    def normal(self, shape, generator, dtype=torch.float32):
        return torch.from_numpy(self.draws[tuple(int(s) for s in shape)]).to(dtype)

    def restore(self):
        for module, fn in self.patched:
            module.standard_normal = fn


def _step_fns(iface, run, losses):
    if run.get("task") == "transport":
        from anemoi_tpu_torch.training.transport_step import make_transport_step_fns

        return make_transport_step_fns(iface, losses, objective="edm")
    return make_step_fns(iface, losses, rollout=1, remat_rollout=False,
                         ensemble_size=run.get("ensemble_size", 1))


def train_runs(setup, runs):
    """Per run (a mesh ``data`` x ``model`` x ``ensemble``, model-config
    overrides, the number of steps, ``zero``, the loss, ``ensemble_size``,
    the transport ``task``, ``draws`` for :class:`FixedDraws`, ``params``
    and ``routes`` to return the parameters after the last step and each
    component's route, :func:`routes`): the losses of
    each step and the reduced step-1 gradients, from a fresh interface with
    the setup's weights, trained on its rows of the setup's batch (the grid
    cut by the step, or read as the rank's block with ``shard_grid``); with
    ``predict``, ``predict_step`` of the first window tiled over
    ``ensemble_size`` members; with ``sample`` (a transport model), one
    generative forecast step of that many sampling steps from a generator
    seeded 7."""
    launch = distributed.launch()
    world = 1 if launch is None else launch.world  # one process: the test's own
    results = []
    for run in runs:
        ens = run.get("ensemble", 1)
        spec = MeshSpec(data=run["data"], model=world // (run["data"] * ens), ensemble=ens)
        mesh = create_mesh(spec)
        config = copy.deepcopy(setup["config"])
        config["model"].update(run.get("model", {}), num_model_shards=spec.model)
        iface = _interface(setup, mesh, config)
        losses = {"data": get_loss_function(
            run.get("loss", setup["loss"]), create_scalers(setup["scalers"], graph=setup["graph"]),
            graph=setup["graph"])}
        opt = dict(setup["optimizer"])
        if run.get("zero"):
            opt["optimizer"] = {"name": "adamw", "zero": True}
        state = TrainState.create(iface, build_optimizer(opt, data_group=mesh.group("data")))
        draws = FixedDraws(run.get("draws"))
        try:
            train_step, _ = _step_fns(iface, run, losses)
            batch = setup["batch"]
            rows = batch.shape[0] // spec.data
            local = batch[mesh.index("data") * rows : (mesh.index("data") + 1) * rows]
            if run.get("shard_grid"):
                local = local[:, :, :, iface.model.grid_rows("data")]
            local = {"data": torch.as_tensor(local)}
            out = {"losses": [], "grads": None, "halo": iface.model.halo is not None,
                   "coords": mesh.coords}
            for step in range(run["steps"]):
                loss = train_step.compute_gradients(state, local)
                if step == 0:
                    out["grads"] = {n: _np(p.grad) for n, p in iface.named_parameters()}
                state.apply_gradients()
                out["losses"].append(float(loss))
            if run.get("params"):
                out["params"] = {n: _np(p) for n, p in iface.named_parameters()}
            if run.get("routes"):
                out["routes"] = routes(iface.model)
            if run.get("predict"):
                window = np.repeat(setup["batch"][:1], run.get("ensemble_size", 1), axis=2)
                out["predict"] = {ds: _np(y) for ds, y in iface.predict_step(
                    {"data": torch.as_tensor(window)}).items()}
        finally:
            draws.restore()
        if run.get("sample"):
            out["sample"] = sample_forecast(iface, setup["batch"][:1], run["sample"])
        if run.get("forecast"):
            from anemoi_tpu_torch.inference import make_forecast_fn

            out["forecast"] = _np(make_forecast_fn(iface, run["forecast"])(
                {"data": torch.as_tensor(setup["window"])})["data"])
        results.append(out)
    return results


def sample_forecast(iface, window, num_steps: int):
    """One generative forecast step of a transport interface (EDM-Heun,
    ``num_steps`` sampling steps, a generator seeded 7): the whole grid."""
    from anemoi_tpu_torch.inference import make_transport_forecast_fn

    forecast = make_transport_forecast_fn(iface, 1, num_steps=num_steps)
    return _np(forecast({"data": torch.as_tensor(window)},
                        torch.Generator().manual_seed(7))["data"])


def heads_attention(cases):
    """Per case (global ``q``, ``k``, ``v`` ``[B, N, H, D]``, a cotangent,
    the window, softcap, ALiBi and rotary flags) this rank's rows of
    ``ulysses_mhsa`` over the world's model group and of the gradients of
    q, k and v; and ``heads_to_seq(seq_to_heads(x))`` with its gradient."""
    from anemoi_tpu_torch.models.layers.attention import get_alibi_slopes
    from anemoi_tpu_torch.parallel.halo import pad_rows
    from anemoi_tpu_torch.parallel.heads import (
        HeadsShard,
        heads_to_seq,
        seq_to_heads,
        ulysses_mhsa,
    )

    mesh = create_mesh(MeshSpec(model=distributed.launch().world))
    group, s, i = mesh.group("model"), mesh.size("model"), mesh.index("model")
    out = []
    for case in cases:
        n, h = case["q"].shape[1], case["q"].shape[2]
        shard = HeadsShard(group, s, i, n)
        rows = shard.dst_rows
        leaves = [torch.tensor(case[k][:, rows], requires_grad=True) for k in ("q", "k", "v")]
        q, k, v = (pad_rows(t.flatten(2), shard.n_local).unflatten(2, t.shape[2:])
                   for t in leaves)
        slopes = get_alibi_slopes(h) if case["alibi"] else None
        res = ulysses_mhsa(q, k, v, shard, case["window"], case["softcap"], slopes,
                           case["rotary"])[:, : rows.stop - rows.start]
        (res * torch.as_tensor(case["cotangent"][:, rows])).sum().backward()
        out.append({"rows": (rows.start, rows.stop), "out": _np(res),
                    **{f"d{name}": _np(t.grad, t) for name, t in zip("qkv", leaves)}})
    x = torch.randn(2, 8, 4, 3, generator=torch.Generator().manual_seed(i), requires_grad=True)
    back = heads_to_seq(seq_to_heads(x, group), group)
    (back * back).sum().backward()
    out.append({"round_trip": bool(torch.equal(back, x)),
                "grad": bool(torch.equal(x.grad, 2 * x.detach()))})
    try:
        seq_to_heads(torch.zeros(1, 8, s + 1, 2), group)
    except ValueError as err:
        out.append({"refused": str(err)})
    return out


def serve_bundle(bundle, batch):
    """``predict_step`` of a bundle served over a model group of every rank."""
    from anemoi_tpu_torch.training.checkpoint import load_inference_checkpoint

    mesh = create_mesh(MeshSpec(model=distributed.launch().world))
    iface = load_inference_checkpoint(bundle, device="cpu", mesh=mesh)
    halo = iface.model.halo is not None
    y = iface.predict_step({"data": torch.as_tensor(batch)})
    return {"halo": halo, "data": _np(y["data"])}


def fail_on_rank_one():
    """Rank 1 fails after the world started; rank 0 waits on a collective
    that never completes: the spawn must stop it and raise."""
    if distributed.launch().rank == 1:
        raise RuntimeError("rank 1 fails")
    torch.distributed.barrier()
    return "rank 0 went on alone"


def lonely_rank(port):
    """A rank that asks for a world of 2 in which nobody joins it."""
    distributed.shutdown()
    os.environ.update({distributed.ENV_COORDINATOR: f"127.0.0.1:{port}",
                       distributed.ENV_NUM_PROCESSES: "2", distributed.ENV_PROCESS_ID: "0",
                       distributed.ENV_INIT_TIMEOUT: "3"})
    distributed.maybe_initialize("cpu")
    return "initialised alone"


def sequence(calls):
    """``[fn(*args) for fn, args in calls]`` on this rank (several checks in
    one world: a spawn costs seconds)."""
    return [fn(*args) for fn, args in calls]


def cli_predict(bundle, output):
    """``cli predict`` in a world a launcher started: the ranks serve the
    bundle over one model group and rank 0 writes ``output``."""
    from anemoi_tpu_torch.training.cli import main

    return main(["predict", bundle, "--steps", "2", "--platform", "cpu", "--output", output])


def routes(model) -> dict:
    """Each component's share on this rank of a sharded model: the class of
    its shard (``HaloShard``, ``HeadsShard``, ``BandShard``, ``BlockShard``),
    per part and, for a mapper, per dataset."""
    out = {}
    for part, shard in (model.halo or {}).items():
        if isinstance(shard, dict):
            for key, value in shard.items():
                out[f"{part}/{key}"] = type(value).__name__
        else:
            out[part] = type(shard).__name__
    return out


def loss_shards(cases):
    """Per case (a loss config, its scalers' arrays, ``pred`` and ``target``
    ``[B, T, E, G, V]``, the grid's ``graph`` for a multiscale loss) this
    rank's value of ``grid_sharded`` on its grid rows, the model group's sum
    of the values, and the gradient of its rows of ``pred``."""
    from anemoi_tpu_torch.parallel.distributed import all_reduce
    from anemoi_tpu_torch.parallel.mesh import grid_block
    from anemoi_tpu_torch.training.losses.base import grid_sharded

    mesh = create_mesh(MeshSpec(model=distributed.launch().world))
    group, s, i = mesh.group("model"), mesh.size("model"), mesh.index("model")
    out = []
    for case in cases:
        n = case["pred"].shape[3]
        rows = grid_block(n, s, i)
        loss = grid_sharded(get_loss_function(case["loss"], case["scalers"], graph=case.get("graph"),
                                              data_indices=case.get("indices")),
                            rows, n, group)
        pred = torch.tensor(case["pred"][:, :, :, rows], requires_grad=True)
        value = loss(pred, torch.as_tensor(case["target"][:, :, :, rows]))
        value.backward()
        total = all_reduce(value.detach().clone(), group)
        out.append({"rows": (rows.start, rows.stop), "value": float(value),
                    "total": float(total), "grad": _np(pred.grad, pred),
                    "route": getattr(loss, "grid_route", None) or type(loss).__name__})
    return out


def band_attention_cases(cases):
    """Per case (global ``q``, ``k``, ``v`` ``[B, N, H, D]``, a cotangent, the
    window, ``attention_impl``, softcap, ALiBi and rotary flags) this rank's
    rows of the band halo's attention (``parallel/band.band_mhsa``) over the
    world's model group, and of the gradients of q, k and v."""
    from anemoi_tpu_torch.models.layers.attention import get_alibi_slopes
    from anemoi_tpu_torch.parallel.band import BandShard, band_mhsa

    mesh = create_mesh(MeshSpec(model=distributed.launch().world))
    group, s, i = mesh.group("model"), mesh.size("model"), mesh.index("model")
    out = []
    for case in cases:
        n, h = case["q"].shape[1], case["q"].shape[2]
        shard = BandShard.build(group, s, i, n, case["window"], case["impl"], "cpu")
        rows = shard.dst_rows
        leaves = [torch.tensor(case[k][:, rows], requires_grad=True) for k in ("q", "k", "v")]
        q, k, v = (pad_rows(t.flatten(2), shard.n_local).unflatten(2, t.shape[2:])
                   for t in leaves)
        slopes = get_alibi_slopes(h) if case["alibi"] else None
        res = band_mhsa(q, k, v, shard, case["softcap"], slopes,
                        case["rotary"])[:, : rows.stop - rows.start]
        (res * torch.as_tensor(case["cotangent"][:, rows])).sum().backward()
        out.append({"rows": (rows.start, rows.stop), "out": _np(res), "h": shard.h,
                    "ext": (shard.ext_rows.start, shard.ext_rows.stop), "full": shard.full,
                    **{f"d{name}": _np(t.grad, t) for name, t in zip("qkv", leaves)}})
    return out

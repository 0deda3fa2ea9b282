"""What a run makes from its seed and its configuration file: the graph, the
variables and their statistics, the weights and the data.  The same objects
go to the program under test and to the plain reference.

The graph is built by the program's graph builder from the configuration's
recipe (o96 -> ico-5 for the configurations here).  The reference gets its
node coordinates and its edges' endpoints as arrays, and works out the edge
features and the area weights itself.  The weights are drawn on the device
in one call and cut by name; the data are drawn on the device and held
pinned on the host.

The configuration's ``reference`` names the plain reference of its model
family, a module under ``perfbench/`` (``reference/encprocdec.py`` here):
it gives the parameters' names and shapes, the graph's tensors, the
forward pass and the yardstick's view of the model.
"""

from __future__ import annotations

import importlib
import math
import time
from dataclasses import dataclass, field
from typing import Dict

import numpy as np
import torch

from perfbench.reference.encprocdec import Variables

BIAS_STD = 0.1
NORM_STD = 0.1
HEAD_SCALE = 0.1  # the output head's weights: small increments a step, as a trained model
HEAD = "decoder.data.node_data_extractor.1.weight"


def sub_seed(seed: int, stream: int) -> int:
    """A seed of its own for each thing a run draws."""
    return (int(seed) * 1_000_003 + stream) % (2**63)


def reference_module(config: dict):
    """The plain reference the configuration names: a file under
    ``perfbench/``, imported as a module of the package."""
    path = config["reference"]
    if not path.startswith("perfbench/") or not path.endswith(".py") or ".." in path:
        raise ValueError(f"the reference {path} is not a file under perfbench/")
    return importlib.import_module(path[: -len(".py")].replace("/", "."))


@dataclass
class Inputs:
    config: dict
    graph: object  # the program's Graph
    arrays: dict  # node coordinates and edge endpoints, for the reference
    variables: Variables
    statistics: Dict[str, np.ndarray]
    shapes: Dict[str, tuple]
    ref: object  # the reference module
    seed: int
    timings: Dict[str, float] = field(default_factory=dict)

    @property
    def num_nodes(self) -> Dict[str, int]:
        return {k: int(v.shape[0]) for k, v in self.arrays["coords"].items()}


def build_inputs(config: dict, seed: int) -> Inputs:
    from anemoi_tpu_torch.graphs.create import GraphCreator

    ref = reference_module(config)
    t0 = time.perf_counter()
    graph = GraphCreator(config["graph"]["recipe"]).create()
    t_graph = time.perf_counter() - t0
    arrays = {"coords": {n: graph[n].coords for n in ("data", "hidden")}, "edges": {}}
    for part, key in ref.PARTS.items():
        e = graph[key]
        arrays["edges"][part] = {"src": e.edge_index[0], "dst": e.edge_index[1]}
    v = config["variables"]
    variables = Variables(list(v["names"]), list(v["forcing"]), list(v["diagnostic"]))
    rng = np.random.default_rng(sub_seed(seed, 1))
    n = len(variables.names)
    mean = rng.normal(size=n).astype(np.float32)
    stdev = rng.uniform(0.5, 2.0, size=n).astype(np.float32)
    statistics = {"mean": mean, "stdev": stdev, "minimum": mean - 3 * stdev,
                  "maximum": mean + 3 * stdev}
    num_nodes = {k: int(c.shape[0]) for k, c in arrays["coords"].items()}
    shapes = ref.parameter_shapes(config["model"], num_nodes, len(variables.input_idx),
                                  len(variables.output_idx), ref.edge_dim(config))
    return Inputs(config, graph, arrays, variables, statistics, shapes, ref, seed,
                  {"graph_s": t_graph})


def draw_weights(shapes: Dict[str, tuple], seed: int, device, dtype=torch.float32
                 ) -> Dict[str, torch.Tensor]:
    """Every weight from one standard normal draw on ``device``, cut by name
    in sorted order: a Linear's weight scaled to variance 1 / fan_in (the
    output head's by a further 0.1), its bias 0.1, a norm's weight 1 + 0.1 z
    and its bias 0.1 z, the trainable node attributes z."""
    names = sorted(shapes)
    sizes = [math.prod(shapes[k]) for k in names]
    gen = torch.Generator(device=device).manual_seed(sub_seed(seed, 2))
    flat = torch.randn(sum(sizes), generator=gen, device=device, dtype=torch.float32)
    out, offset = {}, 0
    for name, size in zip(names, sizes):
        t = flat[offset : offset + size].view(shapes[name])
        offset += size
        if name.endswith(".trainable"):
            pass
        elif name.endswith(".weight") and t.dim() == 2:
            t.mul_((HEAD_SCALE if name == HEAD else 1.0) / math.sqrt(t.shape[1]))
        elif name.endswith(".weight"):
            t.mul_(NORM_STD).add_(1.0)
        else:
            t.mul_(BIAS_STD)
        out[name] = t if dtype == torch.float32 else t.to(dtype)
    return out


@torch.no_grad()
def load_weights(model: torch.nn.Module, weights: Dict[str, torch.Tensor]) -> None:
    """Copy ``weights`` into the program's parameters, which must be exactly
    these names and shapes."""
    params = dict(model.named_parameters())
    if sorted(params) != sorted(weights):
        missing = sorted(set(weights) - set(params))[:5]
        extra = sorted(set(params) - set(weights))[:5]
        raise RuntimeError(f"the program's parameters differ from the configuration's: "
                           f"missing {missing}, unexpected {extra}")
    for name, p in params.items():
        if tuple(p.shape) != tuple(weights[name].shape):
            raise RuntimeError(f"{name}: shape {tuple(p.shape)}, expected "
                               f"{tuple(weights[name].shape)}")
        p.copy_(weights[name])


def draw_data(shape: tuple, statistics: Dict[str, np.ndarray], seed: int, device,
              pin: bool) -> torch.Tensor:
    """Raw fields [R, T, 1, G, V] on the host: mean + stdev * a z, with an
    amplitude of its own for each of the R samples (0.5 to 1.5), drawn on
    ``device``."""
    gen = torch.Generator(device=device).manual_seed(sub_seed(seed, 3))
    z = torch.randn(shape, generator=gen, device=device, dtype=torch.float32)
    amp = torch.rand((shape[0],) + (1,) * (len(shape) - 1), generator=gen, device=device) + 0.5
    mean = torch.as_tensor(statistics["mean"], device=device)
    std = torch.as_tensor(statistics["stdev"], device=device)
    raw = (mean + std * amp * z).cpu()
    return raw.pin_memory() if pin else raw


def program_interface(inputs: Inputs, device, training: bool):
    """The program's model with its processors, weights not yet loaded;
    built on ``device`` directly."""
    from anemoi_tpu_torch.data_indices.collection import IndexCollection
    from anemoi_tpu_torch.models.interface import AnemoiModelInterface

    v = inputs.variables
    indices = {"data": IndexCollection({n: i for i, n in enumerate(v.names)},
                                       forcing=v.forcing, diagnostic=v.diagnostic)}
    config = {"model": dict(inputs.config["model"]),
              "data": {"processors": [{"name": "InputNormalizer", "default": "mean-std"}]}}
    with torch.device(device):
        return AnemoiModelInterface(
            config=config, graph=inputs.graph, data_indices=indices,
            statistics={"data": inputs.statistics}, device=device, training=training,
            initialise=False)


def reference_graph(inputs: Inputs, device) -> dict:
    return inputs.ref.graph_tensors(inputs.config, inputs.arrays, device)


def model_shape(inputs: Inputs):
    """The yardstick's view of the configuration."""
    return inputs.ref.model_shape(inputs.config, inputs.arrays, inputs.shapes)

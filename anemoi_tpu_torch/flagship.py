"""The flagship GraphTransformer configuration, as plain dicts.

The port's counterpart of ``__graft_entry__._build_interface`` (and of the
bench's flagship): an o96 reduced-Gaussian grid -> ico-5 ``TriNodes`` mesh
with the hidden nodes sorted along a space-filling curve, 512 channels, 16
processor layers, 16 heads, 2 input steps, trainable node attributes
``{data: 8, hidden: 8}``, edge attributes ``[edge_dirs, edge_length]``, the
7-variable dataset and an ``InputNormalizer``.  Sizes are arguments so that
tests can build the same model small.

``example_o96_gt_config`` is the JAX package's packaged training example
(``config/example_o96_gt.yaml`` composed with its ``graphtransformer``,
``multi_scale``, ``default`` training, diagnostics and dataloader groups)
as one dict, at the flagship's widths: the port's trainer and CLI run it.

``transformer_config`` is the ``transformer`` preset of the JAX package
(``config/model/transformer.yaml``, anemoi-core's ``transformer.yaml``) on
the same graph: GraphTransformer encoder and decoder with edge attributes
``[edge_length, edge_dirs]``, a dense ``TransformerProcessor`` with a
sliding window over the SFC-sorted hidden nodes, 1024 channels, 16 layers,
16 heads, window 512.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from anemoi_tpu_torch.data_indices.collection import IndexCollection

VARIABLES = ["q", "t", "u", "v", "z", "tp", "cos_lat"]
EDGE_ATTRIBUTES = ["edge_dirs", "edge_length"]


def flagship_recipe(grid: str = "o96", mesh_resolution: int = 5) -> dict:
    ea = {"edge_length": {"name": "EdgeLength"}, "edge_dirs": {"name": "EdgeDirection"}}
    return {
        "nodes": {
            "data": {
                "node_builder": {"name": "ReducedGaussianGridNodes", "grid": grid},
                "attributes": {"area_weight": {"name": "CosineLatWeightedAttribute",
                                               "norm": "unit-max"}},
            },
            "hidden": {"node_builder": {"name": "TriNodes", "resolution": mesh_resolution}},
        },
        "edges": [
            {"source_name": "data", "target_name": "hidden",
             "edge_builder": {"name": "CutOffEdges", "cutoff_factor": 0.6,
                              "max_num_neighbours": 32},
             "attributes": ea},
            {"source_name": "hidden", "target_name": "hidden",
             "edge_builder": {"name": "MultiScaleEdges", "x_hops": 1}, "attributes": ea},
            {"source_name": "hidden", "target_name": "data",
             "edge_builder": {"name": "KNNEdges", "num_nearest_neighbours": 3},
             "attributes": ea},
        ],
        "post_processors": [{"name": "SortNodesBySpaceFillingCurve", "nodes_name": "hidden"}],
    }


def flagship_config(
    num_channels: int = 512, num_layers: int = 16, num_heads: int = 16,
    inference_precision: str = "bf16",
) -> dict:
    gt = {"num_heads": num_heads, "mlp_hidden_ratio": 4.0,
          "sub_graph_edge_attributes": list(EDGE_ATTRIBUTES)}
    return {
        "model": {
            "name": "AnemoiModelEncProcDec",
            "num_channels": num_channels,
            "n_step_input": 2,
            "n_step_output": 1,
            "graph_attention_backend": "paged",
            "inference_precision": inference_precision,
            "trainable_parameters": {"data": 8, "hidden": 8},
            "encoder": {"name": "GraphTransformerForwardMapper", **gt},
            "processor": {"name": "GraphTransformerProcessor", "num_layers": num_layers, **gt},
            "decoder": {"name": "GraphTransformerBackwardMapper", **gt},
        },
        "data": {"processors": [{"name": "InputNormalizer", "default": "mean-std"}]},
    }


def transformer_config(
    num_channels: int = 1024, num_layers: int = 16, num_heads: int = 16,
    window_size: int = 512, inference_precision: str = "bf16",
) -> dict:
    """The ``transformer`` preset.  Its processor takes the default
    ``attention_impl`` (``xla``), which computes the band when
    ``2 * window_size + 1 < num_hidden_nodes``, as at ico-5."""
    gt = {"num_heads": num_heads, "mlp_hidden_ratio": 4.0,
          "sub_graph_edge_attributes": ["edge_length", "edge_dirs"]}
    return {
        "model": {
            "name": "AnemoiModelEncProcDec",
            "num_channels": num_channels,
            "n_step_input": 2,
            "n_step_output": 1,
            "latent_skip": True,
            "inference_precision": inference_precision,
            "trainable_parameters": {"data": 8, "hidden": 8},
            "encoder": {"name": "GraphTransformerForwardMapper", **gt},
            "processor": {"name": "TransformerProcessor", "num_layers": num_layers,
                          "num_heads": num_heads, "mlp_hidden_ratio": 4.0,
                          "window_size": window_size},
            "decoder": {"name": "GraphTransformerBackwardMapper", **gt},
        },
        "data": {"processors": [{"name": "InputNormalizer", "default": "mean-std"}]},
    }


def flagship_indices() -> Dict[str, IndexCollection]:
    name_to_index = {n: i for i, n in enumerate(VARIABLES)}
    return {"data": IndexCollection(name_to_index, forcing=["cos_lat", "z"], diagnostic=["tp"])}


def flagship_statistics(seed: int = 0) -> Dict[str, Dict[str, np.ndarray]]:
    """Per-variable statistics (seeded; the bench uses zeros and ones)."""
    rng = np.random.default_rng(seed)
    n = len(VARIABLES)
    mean = rng.normal(size=n).astype(np.float32)
    stdev = rng.uniform(0.5, 2.0, size=n).astype(np.float32)
    return {"data": {"mean": mean, "stdev": stdev,
                     "minimum": mean - 3 * stdev, "maximum": mean + 3 * stdev}}


EXAMPLE_VARIABLES = ["q_850", "q_500", "t_850", "t_500", "u_850", "v_850", "z_500", "2t", "10u",
                     "10v", "tp", "cos_lat"]


def example_o96_gt_config(
    num_channels: int = 512, num_layers: int = 16, precision: str = "bf16",
    grid: str = "o96", mesh_resolution: int = 5, num_times: int = 64,
) -> dict:
    """The packaged example ``example_o96_gt.yaml`` as the JAX package's
    ``load_config`` composes it, with ``model.num_channels``,
    ``model.processor.num_layers`` and ``training.precision`` set (the
    defaults: the flagship's 512 channels and 16 layers, bf16); the
    synthetic o96 dataset of 12 variables and 64 times.  The grid, the mesh
    and the dataset's length are arguments so that tests can run it small."""
    ea = {"edge_length": {"name": "EdgeLength"}, "edge_dirs": {"name": "EdgeDirection"}}
    gt = {"num_heads": 16, "mlp_hidden_ratio": 4.0,
          "sub_graph_edge_attributes": ["edge_length", "edge_dirs"]}
    return {
        "model": {
            "name": "AnemoiModelEncProcDec",
            "num_channels": num_channels,
            "n_step_input": 2,
            "n_step_output": 1,
            "latent_skip": True,
            "graph_attention_backend": "padded",
            "trainable_parameters": {"data": 8, "hidden": 8},
            "encoder": {"name": "GraphTransformerForwardMapper", **gt},
            "processor": {"name": "GraphTransformerProcessor", "num_layers": num_layers,
                          "num_heads": 16, "mlp_hidden_ratio": 4.0, "qk_norm": False,
                          "sub_graph_edge_attributes": ["edge_length", "edge_dirs"]},
            "decoder": {"name": "GraphTransformerBackwardMapper", "num_heads": 16,
                        "mlp_hidden_ratio": 4.0, "initialise_data_extractor_zero": False,
                        "sub_graph_edge_attributes": ["edge_length", "edge_dirs"]},
        },
        "graph": {
            "recipe": {
                "nodes": {
                    "data": {
                        "node_builder": {"name": "ReducedGaussianGridNodes", "grid": grid},
                        "attributes": {"area_weight": {"name": "SphericalAreaWeights",
                                                       "norm": "unit-max"}},
                    },
                    "hidden": {"node_builder": {"name": "TriNodes",
                                                "resolution": mesh_resolution}},
                },
                "edges": [
                    {"source_name": "data", "target_name": "hidden",
                     "edge_builder": {"name": "CutOffEdges", "cutoff_factor": 0.6},
                     "attributes": dict(ea)},
                    {"source_name": "hidden", "target_name": "hidden",
                     "edge_builder": {"name": "MultiScaleEdges", "x_hops": 1},
                     "attributes": dict(ea)},
                    {"source_name": "hidden", "target_name": "data",
                     "edge_builder": {"name": "KNNEdges", "num_nearest_neighbours": 3},
                     "attributes": dict(ea)},
                ],
                "post_processors": [{"name": "SortNodesByIncomingDegree", "nodes_name": "hidden"}],
            }
        },
        "training": {
            "max_epochs": 2,
            "lr": {"rate": 6.25e-05, "min": 3e-07, "warmup": 1000, "iterations": 300000},
            "optimizer": {"name": "adamw", "b1": 0.9, "b2": 0.95, "weight_decay": 0.0},
            "gradient_clip": {"val": 32.0, "algorithm": "value"},
            "rollout": {"start": 1, "epoch_increment": 0, "max": 1},
            "loss": {"name": "WeightedMSELoss", "scalers": ["area", "variable", "level"]},
            "scalers": {
                "area": {"name": "GraphNodeAttributeScaler", "nodes_name": "data",
                         "attribute_name": "area_weight"},
                "variable": {"name": "GeneralVariableLossScaler"},
                "level": {"name": "ReluVariableLevelScaler", "slope": 0.001,
                          "y_intercept": 0.2},
            },
            "remat_rollout": True,
            "precision": precision,
        },
        "diagnostics": {
            "log_interval": 10,
            "checkpoint_interval": 500,
            "checkpoint_keep": 3,
            "callbacks": [
                {"name": "LearningRateMonitor"},
                {"name": "RolloutEvalCallback", "rollout": 4, "every_n_validations": 1,
                 "max_batches": 2},
            ],
        },
        "dataloader": {"batch_size": 1, "validation_fraction": 0.15},
        "output_dir": "runs/o96_gt",
        "data": {
            "datasets": {
                "data": {
                    "kind": "synthetic",
                    "nodes": {"name": "ReducedGaussianGridNodes", "grid": grid},
                    "variables": list(EXAMPLE_VARIABLES),
                    "num_times": num_times,
                }
            },
            "forcing": ["cos_lat"],
            "diagnostic": ["tp"],
            "processors": [{"name": "InputNormalizer", "default": "mean-std"}],
        },
    }

"""Graph builder of the PyTorch port against the JAX package's.

The port copies the numpy graph code but finds neighbours with
``scipy.spatial.cKDTree`` where the JAX package uses scikit-learn.  Node
coordinates and order must be identical (the node order is the row order of
the trainable node attributes).  Edge sets must agree per destination, except
where two candidate sources lie at exactly the same distance at the k-th
(or cutoff) boundary: the two libraries break such ties differently.  The
tests count those ties and check each is a true tie; on the flagship recipe
at o32 -> ico-4 the decoder's KNN-3 set has ties at 2 of 5248 data nodes,
the frozen fixture's recipe has none.  Edge attributes of the shared edges
must match to 1e-6.
"""

import json
import os

import numpy as np
import pytest

from anemoi_tpu.graphs.create import GraphCreator as JaxGraphCreator
from anemoi_tpu_torch.flagship import flagship_recipe
from anemoi_tpu_torch.graphs.create import GraphCreator
from tests.torch_graph_compare import compare_graphs
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures", "inference_ckpt_r2")


def fixture_recipe():
    with open(os.path.join(FIXTURE, "checkpoint.json")) as f:
        return json.load(f)["config"]["graph"]["recipe"]


@pytest.mark.parametrize(
    "name,recipe,max_ties",
    [
        ("flagship_o32_ico4", flagship_recipe("o32", 4), 2),
        ("fixture_o8_ico1", fixture_recipe(), 0),
    ],
)
def test_graph_matches_jax(name, recipe, max_ties):
    ties = compare_graphs(JaxGraphCreator(recipe).create(), GraphCreator(recipe).create())
    print(f"{name}: destinations with a tie broken differently: {ties}")
    assert sum(ties.values()) <= max_ties
    # the mesh and the encoder are tie-free; only KNN decoders can tie
    assert ties[("hidden", "hidden")] == 0

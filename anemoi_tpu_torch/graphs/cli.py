"""``anemoi-tpu-torch-graphs``: the port's graphs CLI.

Port of ``anemoi_tpu.graphs.cli`` with the same arguments:

    create <recipe.yaml|json> <graph.npz> [--overwrite]
    describe <graph.npz>
    inspect <graph.npz> [--plot overview.png]
    export_to_sparse <graph.npz> <output_dir>
    plot <graph.npz> <output_dir> [--max-edges N]

Recipes are read by the port's ``utils/config.load_config`` (no PyYAML).
``plot`` and ``inspect --plot`` draw with matplotlib (``graphs/plotting.py``,
``inspect_tools.plot_graph``), imported when they run.

    python -m anemoi_tpu_torch.graphs.cli create recipe.yaml graph.npz
"""

from __future__ import annotations

import argparse
import json
import os
import sys

def _parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(prog="anemoi-tpu-torch-graphs")
    sub = parser.add_subparsers(dest="command", required=True)

    p_create = sub.add_parser("create", help="Build a graph from a YAML or JSON recipe")
    p_create.add_argument("recipe", help="YAML or JSON recipe file")
    p_create.add_argument("save_path", help="Output .npz path")
    p_create.add_argument("--overwrite", action="store_true")

    p_desc = sub.add_parser("describe", help="Summarise a saved graph")
    p_desc.add_argument("graph", help="Graph .npz path")

    p_insp = sub.add_parser("inspect", help="Per-edge-set statistics and an overview plot")
    p_insp.add_argument("graph")
    p_insp.add_argument("--plot", default=None, help="Write a PNG overview here")

    p_exp = sub.add_parser("export_to_sparse", help="Export edge sets as scipy CSR .npz")
    p_exp.add_argument("graph")
    p_exp.add_argument("output_dir")

    p_plot = sub.add_parser("plot", help="Render node maps, edge maps and attribute "
                                         "distributions")
    p_plot.add_argument("graph")
    p_plot.add_argument("output_dir")
    p_plot.add_argument("--max-edges", type=int, default=3000)
    return parser


def main(argv=None) -> int:
    from anemoi_tpu_torch.graphs.graph import Graph

    args = _parser().parse_args(argv)

    if args.command == "create":
        from anemoi_tpu_torch.graphs.create import GraphCreator, describe
        from anemoi_tpu_torch.utils.config import load_config

        cfg = load_config(args.recipe).to_dict()
        graph = GraphCreator(cfg).create(args.save_path, overwrite=args.overwrite)
        print(describe(graph))
        print(f"saved -> {args.save_path}")
        return 0

    if args.command == "describe":
        from anemoi_tpu_torch.graphs.create import describe

        print(describe(Graph.load(args.graph)))
        return 0

    if args.command == "inspect":
        from anemoi_tpu_torch.graphs.inspect_tools import edge_statistics, plot_graph

        graph = Graph.load(args.graph)
        print(json.dumps(edge_statistics(graph), indent=1))
        if args.plot:
            print(f"plot -> {plot_graph(graph, args.plot)}")
        return 0

    if args.command == "export_to_sparse":
        from anemoi_tpu_torch.graphs.inspect_tools import export_to_sparse

        for key, path in export_to_sparse(Graph.load(args.graph), args.output_dir).items():
            print(f"{key} -> {path}")
        return 0

    if args.command == "plot":
        return _plot(Graph.load(args.graph), args.output_dir, args.max_edges)
    return 1


def _plot(graph, output_dir: str, max_edges: int) -> int:
    """Every node set's map, every edge set's map, the isolated nodes and
    the attribute distributions, as PNG files in ``output_dir``."""
    from anemoi_tpu_torch.graphs import plotting

    os.makedirs(output_dir, exist_ok=True)
    written = []
    for name in graph.nodes:
        path = os.path.join(output_dir, f"nodes_{name}.png")
        plotting.plot_nodes(graph, name, out_file=path)
        written.append(path)
    for key in graph.edges:
        path = os.path.join(output_dir, f"edges_{key[0]}_to_{key[1]}.png")
        plotting.plot_subgraph(graph, key, out_file=path, max_edges=max_edges)
        written.append(path)
    for fn, fname in ((plotting.plot_isolated_nodes, "isolated_nodes.png"),
                      (plotting.plot_distribution_node_attributes, "node_attributes.png"),
                      (plotting.plot_distribution_edge_attributes, "edge_attributes.png")):
        path = os.path.join(output_dir, fname)
        fn(graph, out_file=path)
        written.append(path)
    for path in written:
        print(f"plot -> {path}")
    return 0


if __name__ == "__main__":
    sys.exit(main())

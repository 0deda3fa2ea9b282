"""``anemoi-tpu-torch-graphs``: the port's graphs CLI.

Port of ``anemoi_tpu.graphs.cli`` with the same arguments:

    create <recipe.yaml|json> <graph.npz> [--overwrite]
    describe <graph.npz>
    inspect <graph.npz>
    export_to_sparse <graph.npz> <output_dir>

Recipes are read by the port's ``utils/config.load_config`` (no PyYAML).
``plot`` and ``inspect --plot`` need matplotlib, which the port does not
use: they print so and return 2 (ROADMAP item 10).

    python -m anemoi_tpu_torch.graphs.cli create recipe.yaml graph.npz
"""

from __future__ import annotations

import argparse
import json
import sys

NOT_PORTED = 2


def _not_ported(what: str) -> int:
    print(f"{what}: not ported to anemoi_tpu_torch (needs matplotlib; ROADMAP item 10)")
    return NOT_PORTED


def _parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(prog="anemoi-tpu-torch-graphs")
    sub = parser.add_subparsers(dest="command", required=True)

    p_create = sub.add_parser("create", help="Build a graph from a YAML or JSON recipe")
    p_create.add_argument("recipe", help="YAML or JSON recipe file")
    p_create.add_argument("save_path", help="Output .npz path")
    p_create.add_argument("--overwrite", action="store_true")

    p_desc = sub.add_parser("describe", help="Summarise a saved graph")
    p_desc.add_argument("graph", help="Graph .npz path")

    p_insp = sub.add_parser("inspect", help="Per-edge-set statistics")
    p_insp.add_argument("graph")
    p_insp.add_argument("--plot", default=None, help="(not ported)")

    p_exp = sub.add_parser("export_to_sparse", help="Export edge sets as scipy CSR .npz")
    p_exp.add_argument("graph")
    p_exp.add_argument("output_dir")

    p_plot = sub.add_parser("plot", help="(not ported)")
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
        from anemoi_tpu_torch.graphs.inspect_tools import edge_statistics

        if args.plot:
            return _not_ported("inspect --plot")
        print(json.dumps(edge_statistics(Graph.load(args.graph)), indent=1))
        return 0

    if args.command == "export_to_sparse":
        from anemoi_tpu_torch.graphs.inspect_tools import export_to_sparse

        for key, path in export_to_sparse(Graph.load(args.graph), args.output_dir).items():
            print(f"{key} -> {path}")
        return 0

    return _not_ported(args.command)  # plot


if __name__ == "__main__":
    sys.exit(main())

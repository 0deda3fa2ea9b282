"""K4 (the graph-attention backward's source pass) of this checkout against
the K4 of another checkout, on one card, on the same inputs.

    python3 tools/torch_k4_compare.py --other DIR [--rounds R] [--json PATH]

``DIR`` is another tree of the repository (for instance the parent commit
unpacked with ``git archive`` into a git-ignored folder); its
``anemoi_tpu_torch/kernels/csrc/gt_attention_bwd.cu`` is built with the same
nvcc flags into ``build/kernels_other/`` and its ``gt_attention_bwd_src``
entry called through ctypes (with or without the grid's block count,
whichever its source declares).  At the flagship's three edge sets (o96 ->
ico-5, HD 512), the V-cycle's down set (``hierarchical.yaml``, HD 512) and
its model shard 2 of 2, and the hex and ICON encoder sets (HD 1 024), in
float32 and bfloat16, on seeded dkv rows: whether the two K4s' dk and dv
are equal bit for bit; each one's time single and back to back (50
calls) in R rounds of the turns other, this, this, other (2R times each);
one ``index_add_`` of dkv by source timed the same two ways; K4's byte
bound; the host microseconds a call of this K4 and of ``index_add_`` takes
to enqueue; this K4's launch alone back to back (outputs allocated once, no
checks); and the host microseconds of the current stream as
``torch.cuda.current_stream``'s object and through the raw getter.  This
checkout's K4 is called through its wrapper, the other through a bare
ctypes call (no checks), which favours it in the single-call times.
Needs a CUDA card; prints one line a set and type.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402  (the card's helpers: timers, bounds, graph recipes)
from anemoi_tpu_torch.kernels import gt_attention as kern  # noqa: E402
from anemoi_tpu_torch.kernels.build import NVCC_FLAGS, build_all, find_nvcc, ptxas_usage  # noqa: E402
from anemoi_tpu_torch.ops.gt_attention import SourceOrder  # noqa: E402

DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def build_other(tree: Path):
    """The other tree's K4 C entry, and whether it takes the grid's block
    count (and so has the block query with K4's code 2)."""
    src = tree / "anemoi_tpu_torch" / "kernels" / "csrc" / "gt_attention_bwd.cu"
    out_dir = ROOT / "build" / "kernels_other"
    out_dir.mkdir(parents=True, exist_ok=True)
    lib_path = out_dir / "libgt_attention_bwd.so"
    log = subprocess.run([find_nvcc(), *NVCC_FLAGS, "-o", str(lib_path), str(src)],
                         capture_output=True, text=True)
    if log.returncode != 0:
        raise RuntimeError(f"nvcc failed on {src}:\n{log.stdout}{log.stderr}")
    lib = ctypes.CDLL(str(lib_path))
    entry = re.search(r'extern "C" int gt_attention_bwd_src\((.*?)\)', src.read_text(), re.S)
    with_blocks = "int blocks" in entry.group(1)
    p, i = ctypes.c_void_p, ctypes.c_int
    fn = lib.gt_attention_bwd_src
    fn.argtypes = [i] + [p] * 5 + [i] * (5 if with_blocks else 4) + [p]
    fn.restype = i
    blocks_fn = None
    if with_blocks:
        blocks_fn = lib.gt_attention_bwd_blocks
        blocks_fn.argtypes = [i] * 6 + [p]
        blocks_fn.restype = i
    return fn, blocks_fn, (log.stdout + log.stderr)


def other_k4(fn, blocks_fn, dkv, src_ptr, src_perm):
    b, n_e, two_hd = dkv.shape
    hd, ns = two_hd // 2, src_ptr.shape[0] - 1
    code = DTYPE_CODES[dkv.dtype]
    dk = torch.empty((b, ns, hd), device=dkv.device, dtype=dkv.dtype)
    dv = torch.empty_like(dk)
    extra = ()
    if blocks_fn is not None:
        out = ctypes.c_int(0)
        if blocks_fn(2, code, 0, hd, 1, 0, ctypes.addressof(out)) != 0:
            raise RuntimeError("the other K4's block query failed")
        extra = (out.value,)
    rc = fn(code, dkv.data_ptr(), src_ptr.data_ptr(), src_perm.data_ptr(), dk.data_ptr(),
            dv.data_ptr(), b, ns, n_e, hd, *extra, torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"the other K4 failed: cudaError {rc}")
    return dk, dv


def edge_sets(workdir: str):
    """(label, edge_index [2, E] on the host, sources, HD) of each set."""
    from anemoi_tpu_torch.graphs.create import GraphCreator
    from anemoi_tpu_torch.graphs.generate.icon import write_synthetic_icon_grid
    from anemoi_tpu_torch.utils.config import PACKAGED_CONFIG_DIR

    flagship = GraphCreator(cs.flagship_recipe("o96", 5)).create()
    for key in (("data", "hidden"), ("hidden", "hidden"), ("hidden", "data")):
        yield "flagship " + "->".join(key), flagship[key].edge_index, \
            flagship[key[0]].num_nodes, cs.HD
    hier = cs.composed_preset(os.path.join(PACKAGED_CONFIG_DIR, "hierarchical.yaml"), [], {})
    graph = GraphCreator(hier["graph"]["recipe"]).create()
    yield from down_sets(graph)
    grid = os.path.join(workdir, "icon_grid.nc")
    write_synthetic_icon_grid(grid, cs.ICON_RESOLUTION)
    for label, edit in (("hex", lambda cfg: None), ("icon", cs.with_icon_grid(grid))):
        with open(cs.mesh_config(workdir, label, edit)) as f:
            recipe = json.load(f)["graph"]["recipe"]
        graph = GraphCreator(recipe).create()
        yield f"{label} encoder set data->hidden", graph[cs.ENCODER_SET].edge_index, \
            graph["data"].num_nodes, cs.WIDE_HD


def down_sets(graph):
    """The V-cycle's down set and its model shard 2 of 2 (no overlap: its
    padded and halo source rows edgeless besides the sources no hidden_2
    node reads), as ``chip_smoke.sharded_down_set`` builds it."""
    from anemoi_tpu_torch.models.graph import extract_subgraph

    label = "V-cycle down set " + "->".join(cs.DOWN_SET)
    yield label, graph[cs.DOWN_SET].edge_index, graph[cs.DOWN_SET[0]].num_nodes, cs.HD
    sub = extract_subgraph(graph, *cs.DOWN_SET, None, torch.device("cpu"), torch.float32)
    csr = sub.sharded_edge_data(2, 1, None, overlap=False).full
    yield label + ", model shard 2 of 2", csr.edge_index.numpy(), csr.num_src, cs.HD


def host_us(fn, calls: int = 2000) -> float:
    """Host microseconds a call of ``fn()`` takes to enqueue its work (no
    synchronise between calls; the card keeps up where its kernels are
    shorter)."""
    for _ in range(20):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / calls * 1e6


def compare(fn, blocks_fn, label, edge_index, n_src, hd, device, gen, rounds) -> list:
    ei = torch.as_tensor(edge_index, dtype=torch.int32, device=device).contiguous()
    order = SourceOrder.of(ei, n_src)
    src = ei[0].long()
    n_e = ei.shape[1]
    edgeless = int((torch.bincount(src, minlength=n_src) == 0).sum())
    rows = []
    for dtype in (torch.float32, torch.bfloat16):
        dkv = (torch.randn(1, n_e, 2 * hd, generator=gen, device=device) * 0.1).to(dtype)

        def this():
            return kern.gt_attention_bwd_src(dkv, order.src_ptr, order.src_perm)

        def other():
            return other_k4(fn, blocks_fn, dkv, order.src_ptr, order.src_perm)

        def library():
            return torch.zeros(1, n_src, 2 * hd, device=device, dtype=dtype).index_add_(1, src, dkv)

        mine, theirs = this(), other()
        torch.cuda.synchronize()
        equal = {name: torch.equal(x, y) for name, x, y in zip(("dk", "dv"), mine, theirs)}
        single, b2b = {"other": [], "this": []}, {"other": [], "this": []}
        for name in ("other", "this", "this", "other") * rounds:
            call = other if name == "other" else this
            single[name].append(cs.cuda_ms(call))
            b2b[name].append(cs.cuda_ms_back_to_back(call))
        elt = dkv.element_size()
        bound_ms, bound_by = cs.bound(n_e * 2 * hd * elt + 4 * (n_e + n_src + 1)
                                      + 2 * n_src * hd * elt, n_e * hd * 2)
        host = {name: host_us(call) for name, call in (("this", this), ("library", library))}
        # this K4's launch alone, outputs allocated once: the card's time a
        # call where the wrapper's host time would otherwise set the pace
        dk, dv = (torch.empty(1, n_src, hd, device=device, dtype=dtype) for _ in range(2))
        blocks = kern._resident_blocks("K4", dkv.get_device(), DTYPE_CODES[dtype], False, hd, 1, 0)
        launch, stream = kern._bwd_entries()["src"], kern._stream(dkv)

        def bare():
            launch(DTYPE_CODES[dtype], dkv.data_ptr(), order.src_ptr.data_ptr(),
                   order.src_perm.data_ptr(), dk.data_ptr(), dv.data_ptr(), 1, n_src, n_e, hd,
                   blocks, stream)

        row = {"set": label, "dtype": str(dtype).split(".")[-1], "hd": hd, "n_src": n_src,
               "n_edges": n_e, "sources_without_edges": edgeless, "bitwise_equal": equal,
               "ms_other": single["other"], "ms_this": single["this"],
               "ms_back_to_back_other": b2b["other"], "ms_back_to_back_this": b2b["this"],
               "library_ms": cs.cuda_ms(library),
               "library_ms_back_to_back": cs.cuda_ms_back_to_back(library),
               "host_us_this": host["this"], "host_us_library": host["library"],
               "ms_back_to_back_this_launch_alone": cs.cuda_ms_back_to_back(bare, launches=300),
               "bound_ms": bound_ms, "bound_by": bound_by}
        rows.append(row)
        print(f"[k4] {json.dumps(row)}", flush=True)
        del dkv, mine, theirs
    return rows


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--other", required=True, help="the other tree of the repository")
    ap.add_argument("--rounds", type=int, default=1,
                    help="rounds of the turns other, this, this, other (default 1)")
    ap.add_argument("--json", help="also write the rows here")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_k4_compare: no CUDA device visible", file=sys.stderr)
        return 1
    device = torch.device("cuda")
    card = cs.card_line()
    print(f"[card] {card}", flush=True)
    build_all(["gt_attention_bwd"])
    fn, blocks_fn, log = build_other(Path(args.other).resolve())
    usage = {name: u for name, u in ptxas_usage(log).items() if "bwd_src" in name}
    print(f"[build] the other K4 ({'with' if blocks_fn else 'without'} a block count): "
          f"{json.dumps(usage)}", flush=True)
    stream_host = {"host_us_stream_object": host_us(
        lambda: torch.cuda.current_stream(device).cuda_stream),
        "host_us_raw_stream": host_us(lambda: torch._C._cuda_getCurrentRawStream(0))}
    print(f"[host] {json.dumps(stream_host)}", flush=True)
    gen = torch.Generator(device=device).manual_seed(cs.SEED + 22)
    rows = []
    with tempfile.TemporaryDirectory(prefix="k4_") as workdir:
        for label, edge_index, n_src, hd in edge_sets(workdir):
            rows += compare(fn, blocks_fn, label, edge_index, n_src, hd, device, gen, args.rounds)
    if args.json:
        os.makedirs(os.path.dirname(os.path.abspath(args.json)), exist_ok=True)
        with open(args.json, "w") as f:
            json.dump({"card": card, **stream_host, "rows": rows}, f, indent=1)
    unequal = [(r["set"], r["dtype"]) for r in rows if not all(r["bitwise_equal"].values())]
    print(json.dumps({"card": card, "bitwise_unequal": unequal}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

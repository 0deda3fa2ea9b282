"""Edges built on the device inside each step: dynamic kNN.

Port of ``anemoi_tpu.ops.dynamic`` (``xyz_from_sincos``,
``latlon_from_sincos``, the haversine, ``_edge_directions``,
``runtime_knn_tables``, ``check_out_degree``, ``runtime_edge_attributes``).
The edges of a mapper are recomputed from its node sets' coordinates (the
model's sincos node features) every forward, for node sets whose geometry
may change from batch to batch:

- kNN on the unit sphere is the top ``k`` of the dense float32 similarity
  ``dst_xyz @ src_xyz.T`` (the largest inner product is the nearest by
  great circle), with TF32 off for the product so that the neighbour sets
  do not drift; it is built a block of destinations at a time, each block's
  similarities freed before the next.  Edge ``(dst, j)`` takes slot ``dst *
  k + j``: the set is dst-sorted by construction, ``dst_ptr = arange(Nd +
  1) * k``.
- The backward's source-ordered view (:class:`SourceOrder`) is built on the
  device too (:meth:`SourceOrder.on_device`: a stable ``argsort`` of the
  sources and a ``searchsorted`` of the pointer), with no host round trip.
  It is exact for any out-degree; the JAX package's padded transpose table
  drops the gradient of a source's out-edges beyond ``k_out`` (ROADMAP
  Queue 3), which :func:`check_out_degree` lets a caller bound.
- The edge attributes (``edge_dirs`` unit-std, ``edge_length`` unit-max) are
  recomputed with the host builders' formulas and normalised over the edge
  set on the device, in float32 (:func:`edge_directions` reads its sines and
  cosines from the features, so that a source on the local frame's
  ``lon = +-pi`` cut keeps the host builders' sign; ROADMAP Queue 3).

None of this is a kernel: the JAX package computes it with ``jnp.dot``,
``lax.top_k`` and sorts.  The graph attention then runs K1 / K3 / K4 on the
runtime set as on any other.  ``torch.topk`` and ``lax.top_k`` may break
ties between equally near sources differently.
"""

from __future__ import annotations

import contextlib
from typing import NamedTuple, Optional, Sequence

import torch

from anemoi_tpu_torch.ops.gt_attention import SourceOrder

SIMILARITY_BLOCK_ELEMENTS = 1 << 26  # float32 similarities a block of destinations (256 MB)


def xyz_from_sincos(feat: torch.Tensor) -> torch.Tensor:
    """``[N, 4]`` (sin lat, sin lon, cos lat, cos lon) -> unit xyz ``[N, 3]``."""
    sin_lat, sin_lon, cos_lat, cos_lon = feat.unbind(-1)
    return torch.stack([cos_lat * cos_lon, cos_lat * sin_lon, sin_lat], dim=-1)


def latlon_from_sincos(feat: torch.Tensor) -> torch.Tensor:
    sin_lat, sin_lon, cos_lat, cos_lon = feat.unbind(-1)
    return torch.stack([torch.atan2(sin_lat, cos_lat), torch.atan2(sin_lon, cos_lon)], dim=-1)


def great_circle(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Haversine arc length between ``(lat, lon)`` points."""
    lat1, lon1 = a[..., 0], a[..., 1]
    lat2, lon2 = b[..., 0], b[..., 1]
    h = (torch.sin((lat2 - lat1) / 2.0) ** 2
         + torch.cos(lat1) * torch.cos(lat2) * torch.sin((lon2 - lon1) / 2.0) ** 2)
    return 2.0 * torch.arcsin(torch.sqrt(h.clamp(0.0, 1.0)))


def edge_directions(src_feat: torch.Tensor, dst_feat: torch.Tensor) -> torch.Tensor:
    """The source's ``(lat, lon)`` in the destination-centred frame, from the
    sincos features of each edge's ends: the host builder's rotations, with
    the sines and cosines read from the features instead of recomputed from
    ``atan2`` angles (JAX ``_edge_directions`` recomputes them).  At a pole
    the float32 round trip turns ``cos(lat)`` negative, and a source on the
    frame's ``lon = +-pi`` cut (an ico mesh's pole vertex seen from near the
    pole) then flips sign against the host builders'; read from the
    features, the signs are the host's."""
    sin_lat_s, sin_lon_s, cos_lat_s, cos_lon_s = src_feat.unbind(-1)
    sin_lat_d, sin_lon_d, cos_lat_d, cos_lon_d = dst_feat.unbind(-1)
    x, y, z = cos_lat_s * cos_lon_s, cos_lat_s * sin_lon_s, sin_lat_s
    x1 = cos_lon_d * x + sin_lon_d * y  # about z by -lon_d
    y1 = -sin_lon_d * x + cos_lon_d * y
    x2 = cos_lat_d * x1 - sin_lat_d * z  # about y by -lat_d
    z2 = sin_lat_d * x1 + cos_lat_d * z
    norm = torch.sqrt((x2 ** 2 + y1 ** 2 + z2 ** 2).clamp_min(1e-24))
    lat = torch.arcsin((z2 / norm).clamp(-1.0, 1.0))
    return torch.stack([lat, torch.atan2(y1, x2)], dim=-1)


@contextlib.contextmanager
def _full_float32():
    """float32 products without TF32, restored afterwards."""
    previous = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(previous)


class RuntimeEdges(NamedTuple):
    """A runtime edge set on its device: what K1 / K3 / K4 take."""

    edge_index: torch.Tensor  # [2, Nd * k] int32, row 0 src, row 1 dst
    dst_ptr: torch.Tensor  # [Nd + 1] int32, arange(Nd + 1) * k
    source: SourceOrder  # the source-ordered view, built on the device
    num_src: int
    num_dst: int


def runtime_knn(src_feat: torch.Tensor, dst_feat: torch.Tensor, k: int,
                rows: Optional[slice] = None) -> RuntimeEdges:
    """Each destination's ``k`` nearest sources, nearest first, from the
    sincos features ``[N, 4]`` (float32).  ``rows``: only these destinations
    (a rank's block under model shards; numbered from 0 in the result),
    each computed in the block of destinations one process computes it in,
    so that equally near sources break the same way."""
    ns, nd_all = src_feat.shape[0], dst_feat.shape[0]
    if k > ns:
        raise ValueError(f"asked for {k} neighbours among {ns} nodes")
    rows = slice(0, nd_all) if rows is None else rows
    nd = rows.stop - rows.start
    src_xyz = xyz_from_sincos(src_feat.float())
    dst_xyz = xyz_from_sincos(dst_feat.float())
    block = max(1, SIMILARITY_BLOCK_ELEMENTS // ns)
    dev = src_feat.device
    picked = [torch.zeros((0, k), dtype=torch.long, device=dev)]
    with _full_float32():
        for start in range(rows.start - rows.start % block, rows.stop, block):
            sim = dst_xyz[start:start + block] @ src_xyz.t()
            top = torch.topk(sim, k, dim=1).indices
            picked.append(top[max(rows.start - start, 0) : rows.stop - start])
            del sim
    edge_src = torch.cat(picked).reshape(-1).to(torch.int32)
    edge_dst = torch.arange(nd, dtype=torch.int32, device=dev).repeat_interleave(k)
    edge_index = torch.stack([edge_src, edge_dst])
    dst_ptr = torch.arange(nd + 1, dtype=torch.int32, device=dev) * k
    return RuntimeEdges(edge_index, dst_ptr, SourceOrder.on_device(edge_index, ns), ns, nd)


def check_out_degree(edges: RuntimeEdges) -> int:
    """The largest out-degree of the runtime set (a host read)."""
    return int((edges.source.src_ptr[1:] - edges.source.src_ptr[:-1]).max())


def runtime_edge_attributes(src_feat: torch.Tensor, dst_feat: torch.Tensor,
                            edge_index: torch.Tensor,
                            attributes: Sequence[str] = ("edge_dirs", "edge_length")
                            ) -> torch.Tensor:
    """``EdgeDirection`` (unit-std) and / or ``EdgeLength`` (unit-max) of the
    runtime set, float32 ``[E, F]``, normalised over the set as the host
    builders do."""
    src_e = src_feat.float()[edge_index[0].long()]
    dst_e = dst_feat.float()[edge_index[1].long()]
    s, d = latlon_from_sincos(src_e), latlon_from_sincos(dst_e)
    feats = []
    for name in attributes:
        if name == "edge_dirs":
            dirs = edge_directions(src_e, dst_e)
            std = dirs.std(correction=0)
            feats.append(dirs / torch.where(std == 0, torch.ones_like(std), std))
        elif name == "edge_length":
            length = great_circle(s, d)[:, None]
            feats.append(length / length.max().clamp_min(1e-12))
        else:
            raise ValueError(f"unsupported runtime edge attribute '{name}'")
    return torch.cat(feats, dim=-1)


ATTRIBUTE_WIDTHS = {"edge_dirs": 2, "edge_length": 1}

"""Graph comparison shared by the port's graph tests.

The port copies the JAX package's numpy graph code but finds neighbours with
``scipy.spatial.cKDTree`` where the JAX package uses scikit-learn.  Node
coordinates and order must be identical (the node order is the row order of
the trainable node attributes).  Edge sets must agree per destination, except
where two candidate sources lie at exactly the same distance at the k-th
(or cutoff) boundary: the two libraries break such ties differently.
:func:`compare_graphs` counts those ties and checks each is a true tie; edge
attributes of the shared edges must match to 1e-6.
"""

import numpy as np

from anemoi_tpu_torch.graphs.transforms import latlon_rad_to_xyz


def compare_graphs(g_jax, g_port, by_source=()):
    """Assert the two graphs agree; return the number of tied groups per
    edge set.  Edges are grouped by destination, or by source for the sets
    in ``by_source`` (``ReversedKNNEdges``: each source picks its k nearest
    destinations, so its ties sit at the source's k-th distance).  Every set,
    those in ``by_source`` too, must be laid out by destination as its
    ``dst_ptr`` says."""
    assert list(g_jax.nodes) == list(g_port.nodes)
    for name, ns in g_jax.nodes.items():
        np.testing.assert_array_equal(ns.coords, g_port[name].coords)
        assert sorted(ns.attributes) == sorted(g_port[name].attributes)
        for attr, value in ns.attributes.items():
            np.testing.assert_allclose(g_port[name].attributes[attr], value, rtol=1e-6, atol=1e-6)
    ties = {}
    assert list(g_jax.edges) == list(g_port.edges)
    for key, ej in g_jax.edges.items():
        ep = g_port[key]
        src_xyz = latlon_rad_to_xyz(g_jax[key[0]].coords)
        dst_xyz = latlon_rad_to_xyz(g_jax[key[1]].coords)
        assert ej.num_edges == ep.num_edges
        # both sets are laid out by destination: dst_ptr[d]:dst_ptr[d+1] are
        # the edges into d (the CSR layout the attention kernels read)
        n_dst = g_jax[key[1]].num_nodes
        for es in (ej, ep):
            np.testing.assert_array_equal(
                es.edge_index[1], np.repeat(np.arange(n_dst), np.diff(es.dst_ptr)))
        if key in by_source:  # regroup by source (ties move in-degrees here)
            group = 0
            n_group = g_jax[key[0]].num_nodes
            members = []
            for es in (ej, ep):
                order = np.argsort(es.edge_index[0], kind="stable")
                ptr = np.zeros(n_group + 1, dtype=np.int64)
                np.cumsum(np.bincount(es.edge_index[0], minlength=n_group), out=ptr[1:])
                members.append((es.edge_index[1, order], ptr))
            (mj, ptr_j), (mp, ptr_p) = members
            np.testing.assert_array_equal(ptr_j, ptr_p)  # same out-degrees
        else:  # read through the dst_ptr ranges as laid out
            np.testing.assert_array_equal(ej.dst_ptr, ep.dst_ptr)  # same in-degrees
            group, n_group = 1, n_dst
            mj, ptr_j, mp, ptr_p = ej.edge_index[0], ej.dst_ptr, ep.edge_index[0], ep.dst_ptr
        tied = 0
        for n in range(n_group):
            sj = set(mj[ptr_j[n]:ptr_j[n + 1]])
            sp = set(mp[ptr_p[n]:ptr_p[n + 1]])
            if sj == sp:
                continue
            # a tie: the nodes that differ are all at the boundary distance
            tied += 1
            here = (src_xyz if group == 0 else dst_xyz)[n]
            there = dst_xyz if group == 0 else src_xyz
            dist = {m: np.linalg.norm(there[m] - here) for m in sj | sp}
            boundary = max(dist[m] for m in sj)
            for m in sj ^ sp:
                assert abs(dist[m] - boundary) < 1e-12, (key, n, m)
        ties[key] = tied

        # attributes of the shared edges, aligned by (dst, src)
        def keyed(es):
            order = np.lexsort((es.edge_index[0], es.edge_index[1]))
            pairs = es.edge_index[1, order] * (1 << 32) + es.edge_index[0, order]
            return pairs, {k: v[order] for k, v in es.attributes.items()}

        pj, aj = keyed(ej)
        pp, ap = keyed(ep)
        common, ij, ip = np.intersect1d(pj, pp, return_indices=True)
        assert len(common) >= ej.num_edges - 3 * tied
        for attr in aj:
            np.testing.assert_allclose(ap[attr][ip], aj[attr][ij], rtol=1e-6, atol=1e-6)
    return ties

"""Topology generation for data center networks (numpy; a copy of
``repro.core.graphs`` plus ``Topology.from_arrays``).

``Topology`` is the single currency of the repo: a dense symmetric capacity
matrix ``cap[N, N]`` (cap[u, v] = total link capacity u->v; 0 = no link;
multi-links between a switch pair sum their capacities), a ``servers[N]``
vector giving the number of attached servers per switch, and optional per-
switch class ``labels``.  Capacities are in units of the base line-speed
(1 unit = one 1GbE link); a 10GbE link contributes 10.

Every public generator returns a ``Topology``; the bare capacity-matrix
builders survive as private ``_*_cap`` helpers for callers that compose
matrices by hand.  Generation is plain numpy (paper-scale graphs are small);
the throughput engines (``repro_torch.core.engine``) consume Topologies.
"""
from __future__ import annotations

import dataclasses
from typing import Mapping, Sequence

import numpy as np

__all__ = [
    "Topology",
    "EllGraph",
    "as_cap",
    "connected_components",
    "degree_stats",
    "random_regular_graph",
    "random_graph_from_degrees",
    "random_regular_ell",
    "biased_two_cluster_graph",
    "power_law_degrees",
    "distribute_servers",
]

# non-edge sentinel of the padded-ELL export; numerically identical to
# ``repro_torch.core.apsp._INF`` (this module stays numpy-pure / torch-free, so
# the constant is duplicated and pinned equal by a test)
_ELL_INF = 1.0e18


@dataclasses.dataclass(frozen=True)
class EllGraph:
    """A padded-ELL (fixed-width sparse) view of a weighted graph.

    Row ``v`` of ``(idx, wgt)`` lists ``v``'s neighbors ascending; unused
    slots pad the END of the row with ``idx = v`` (a safe self-gather)
    and ``wgt = _ELL_INF``.  This is the exact table layout
    ``repro_torch.kernels.ell`` relaxes and ``repro_torch.core.apsp._pack_ell``
    produces — for the symmetric capacity patterns ``Topology`` carries,
    the in- and out-neighbor sets coincide, so one table serves both
    orientations.  Shapes are static in ``d_max``, which is what lets
    the ``"ell-bf"`` backend jit, vmap, and AOT-cache cleanly."""

    idx: np.ndarray   # [N, d_max] int32 neighbor ids, pads = own row id
    wgt: np.ndarray   # [N, d_max] float32 lengths, pads = _ELL_INF

    @property
    def n(self) -> int:
        return int(self.idx.shape[0])

    @property
    def d_max(self) -> int:
        return int(self.idx.shape[1])

    def validate(self) -> None:
        assert self.idx.shape == self.wgt.shape and self.idx.ndim == 2
        assert self.idx.dtype == np.int32
        assert self.wgt.dtype == np.float32
        assert np.all((self.idx >= 0) & (self.idx < self.n))
        valid = self.wgt < _ELL_INF / 2
        # pads sit after every valid slot and self-reference their row
        assert np.all(valid[:, 1:] <= valid[:, :-1]), "pads must be last"
        rows = np.arange(self.n)[:, None]
        assert np.all(np.where(valid, True, self.idx == rows)), \
            "pad slots must self-reference"

    def to_dense(self) -> np.ndarray:
        """The dense length matrix this table packs: ``_ELL_INF``
        non-edges, zero diagonal (the ``apsp`` input convention)."""
        w = np.full((self.n, self.n), _ELL_INF, np.float32)
        valid = self.wgt < _ELL_INF / 2
        rows = np.repeat(np.arange(self.n), valid.sum(axis=1))
        w[self.idx[valid], rows] = self.wgt[valid]   # idx row = incoming
        np.fill_diagonal(w, 0.0)
        return w


def degree_stats(cap: "Topology | np.ndarray") -> tuple[int, float]:
    """Host-side density facts of a capacity pattern: ``(d_max,
    mean_degree)`` — max off-diagonal nonzero count over rows, and the
    mean over rows that have at least one edge (padded lanes in a solver
    batch are all-zero rows and must not dilute the density signal).
    Accepts one matrix or a stacked batch; this is what the solvers feed
    ``resolve_backend`` / the ``"ell-bf"`` ``d_max`` static."""
    cap = np.asarray(as_cap(cap))
    n = cap.shape[-1]
    deg = (cap > 0).sum(axis=-1) - (np.einsum("...ii->...i", cap) > 0)
    deg = deg.reshape(-1)
    live = deg > 0
    if not live.any():
        return 0, 0.0
    return int(deg.max()), float(deg[live].mean())


@dataclasses.dataclass(frozen=True)
class Topology:
    """A switch-level network: capacities + server attachment."""

    cap: np.ndarray        # [N, N] float, symmetric, zero diagonal
    servers: np.ndarray    # [N] int, servers attached to each switch
    labels: np.ndarray | None = None  # [N] int class label (e.g. 0=small, 1=large)
    # [N] bool, True = this node is an expanded server leaf (see
    # ``with_server_nodes``); None = a plain switch-level topology
    server_nodes: np.ndarray | None = None

    def __array__(self, dtype=None, copy=None):
        # lets np.asarray/np.stack treat a Topology as its capacity matrix
        return np.asarray(self.cap, dtype=dtype)

    @classmethod
    def from_arrays(cls, fields: Mapping[str, np.ndarray | None]
                    ) -> "Topology":
        """Rebuild a topology from its state arrays (``cap``, ``servers``
        and the optional ``labels`` / ``server_nodes``), e.g. the
        ``dataclasses.asdict`` of ``repro.core.graphs.Topology``.  The
        arrays are copied, so the instance owns its state; unknown keys
        raise ``ValueError``."""
        names = {f.name for f in dataclasses.fields(cls)}
        unknown = set(fields) - names
        if unknown:
            raise ValueError(f"unknown Topology fields {sorted(unknown)}; "
                             f"known: {sorted(names)}")
        kw = {k: None if v is None else np.array(v, copy=True)
              for k, v in fields.items()}
        out = cls(**kw)
        out.validate()
        return out

    @property
    def n(self) -> int:
        return int(self.cap.shape[0])

    @property
    def total_capacity(self) -> float:
        """Total capacity counting both directions (paper's C)."""
        return float(self.cap.sum())

    @property
    def num_servers(self) -> int:
        return int(self.servers.sum())

    def cut_capacity(self, mask: np.ndarray) -> float:
        """Capacity crossing the cut (both directions) for boolean mask."""
        m = np.asarray(mask, bool)
        return float(self.cap[m][:, ~m].sum() + self.cap[~m][:, m].sum())

    def validate(self) -> None:
        assert self.cap.shape[0] == self.cap.shape[1]
        assert np.allclose(self.cap, self.cap.T), "capacity matrix must be symmetric"
        assert np.all(np.diag(self.cap) == 0), "no self loops"
        assert np.all(self.cap >= 0)
        assert self.servers.shape == (self.n,)
        assert np.all(self.servers >= 0)
        if self.server_nodes is not None:
            assert self.server_nodes.shape == (self.n,)
            assert self.server_nodes.dtype == bool

    def degrade(self, link_mask: np.ndarray | None = None,
                dead_switches: Sequence[int] | np.ndarray | None = None
                ) -> "Topology":
        """A validated degraded copy of this topology (failure injection).

        ``link_mask``: [N, N] bool, True = the link survives; must be
        symmetric (a link fails in both directions — ``ValueError``
        otherwise).  ``dead_switches``: switch indices whose row/column is
        zeroed entirely and whose attached servers are stranded.

        Graceful-degradation semantics: servers on a dead switch — or on a
        switch left with zero surviving network capacity — are stranded and
        zeroed in ``servers`` (their demand cannot enter the network).  The
        node count never changes, so degraded variants of one topology all
        share a batch-plan bucket.  The result passes ``validate()``; the
        caller decides how to treat demand between the surviving-but-
        disconnected components (see ``repro_torch.core.mcf.drop_disconnected``).
        """
        cap = self.cap.copy()
        servers = self.servers.copy()
        if link_mask is not None:
            m = np.asarray(link_mask, bool)
            if m.shape != cap.shape:
                raise ValueError(f"link_mask shape {m.shape} != capacity "
                                 f"shape {cap.shape}")
            if not np.array_equal(m, m.T):
                raise ValueError("link_mask must be symmetric: links fail "
                                 "in both directions")
            cap = np.where(m, cap, 0.0)
        if dead_switches is not None:
            dead = np.asarray(dead_switches, np.int64)
            if dead.size and (dead.min() < 0 or dead.max() >= self.n):
                raise ValueError(f"dead switch index out of range [0, "
                                 f"{self.n})")
            cap[dead, :] = 0.0
            cap[:, dead] = 0.0
            servers[dead] = 0
        servers[cap.sum(axis=1) == 0] = 0       # stranded: no surviving link
        out = Topology(cap=cap, servers=servers, labels=self.labels,
                       server_nodes=self.server_nodes)
        out.validate()
        return out

    def with_server_nodes(self, nic_capacity: float = 1.0) -> "Topology":
        """The server-expanded view of this switch-level topology.

        Each of the ``servers[i]`` servers of switch ``i`` becomes its own
        degree-1 leaf node linked to ``i`` with ``nic_capacity``.  Leaves
        are appended AFTER the switch block in ``np.repeat(arange(N),
        servers)`` order — the exact server enumeration
        ``repro_torch.core.traffic`` uses, so a traffic pattern built from the
        expanded ``servers`` vector (one server per leaf) is the
        node-granular version of the same switch-level pattern.  The
        returned topology carries a ``server_nodes`` mask; ``coarsen``
        inverts the expansion exactly."""
        if self.server_nodes is not None:
            raise ValueError("topology is already server-expanded")
        if nic_capacity <= 0:
            raise ValueError(f"nic_capacity must be > 0, got {nic_capacity}")
        n, s = self.n, self.num_servers
        owner = np.repeat(np.arange(n), self.servers)
        m = n + s
        cap = np.zeros((m, m), dtype=np.float64)
        cap[:n, :n] = self.cap
        leaf = n + np.arange(s)
        cap[leaf, owner] = nic_capacity
        cap[owner, leaf] = nic_capacity
        servers = np.concatenate([np.zeros(n, np.int64),
                                  np.ones(s, np.int64)])
        labels = None
        if self.labels is not None:
            labels = np.concatenate([self.labels, self.labels[owner]])
        mask = np.concatenate([np.zeros(n, bool), np.ones(s, bool)])
        out = Topology(cap=cap, servers=servers, labels=labels,
                       server_nodes=mask)
        out.validate()
        return out

    def coarsen(self, dem: np.ndarray | None = None):
        """Contract the server leaves back onto their switches (the exact
        inverse of ``with_server_nodes``).

        Every ``server_nodes``-marked node must be a degree-1 leaf whose
        single link lands on a non-server node (``ValueError`` otherwise
        — contraction of anything else would change the flow problem).
        Its ``servers`` count folds into its switch; an optional node-
        level demand matrix is lifted by summing over each switch's
        leaves, with the diagonal zeroed (intra-switch traffic never
        enters the network — the same pairs switch-level traffic
        construction drops).

        Returns the switch-level ``Topology``, or ``(topology,
        lifted_dem)`` when ``dem`` is given.  A topology without server
        nodes passes through unchanged."""
        if self.server_nodes is None:
            return self if dem is None else (self, dem)
        srv = self.server_nodes
        sw = np.flatnonzero(~srv)
        leaves = np.flatnonzero(srv)
        deg = (self.cap[leaves] > 0).sum(axis=1)
        if np.any(deg != 1):
            bad = leaves[np.flatnonzero(deg != 1)[:5]]
            raise ValueError(f"server nodes {bad.tolist()} are not "
                             "degree-1 leaves; cannot coarsen")
        owner = np.argmax(self.cap[leaves] > 0, axis=1)
        if np.any(srv[owner]):
            bad = leaves[np.flatnonzero(srv[owner])[:5]]
            raise ValueError(f"server nodes {bad.tolist()} attach to "
                             "another server node; cannot coarsen")
        # coarse index of every node: switches keep their relative order
        coarse = np.full(self.n, -1, np.int64)
        coarse[sw] = np.arange(len(sw))
        servers = self.servers[sw].copy()
        np.add.at(servers, coarse[owner], self.servers[leaves])
        labels = self.labels[sw] if self.labels is not None else None
        topo = Topology(cap=self.cap[np.ix_(sw, sw)], servers=servers,
                        labels=labels)
        topo.validate()
        if dem is None:
            return topo
        dem = np.asarray(dem, np.float64)
        if dem.shape != (self.n, self.n):
            raise ValueError(f"demand shape {dem.shape} != node count "
                             f"({self.n}, {self.n})")
        node_to = coarse.copy()
        node_to[leaves] = coarse[owner]
        lifted = np.zeros((len(sw), len(sw)), np.float64)
        np.add.at(lifted, (node_to[:, None], node_to[None, :]), dem)
        np.fill_diagonal(lifted, 0.0)
        return topo, lifted

    def to_ell(self, d_max: int | None = None,
               lengths: np.ndarray | None = None) -> "EllGraph":
        """Export the link pattern as a padded-ELL table (``EllGraph``).

        ``lengths`` gives per-link lengths (defaults to unit hops — the
        ASPL / frontier-probe metric); only its entries on the nonzero
        capacity pattern are read.  ``d_max`` sets the table width:
        defaults to the actual max degree, and a value below it raises
        (silent truncation would drop edges).  Neighbor ids ascend
        within each row; pads self-reference with ``_ELL_INF`` weight."""
        adj = self.cap > 0
        np.fill_diagonal(adj, False)
        deg = adj.sum(axis=1)
        actual = int(deg.max()) if self.n else 0
        if d_max is None:
            d_max = max(actual, 1)
        elif d_max < actual:
            raise ValueError(f"d_max={d_max} < max degree {actual}: the "
                             "padded-ELL table would silently drop edges")
        if lengths is None:
            lengths = np.ones_like(self.cap, dtype=np.float32)
        else:
            lengths = np.asarray(lengths, np.float32)
            if lengths.shape != self.cap.shape:
                raise ValueError(f"lengths shape {lengths.shape} != "
                                 f"capacity shape {self.cap.shape}")
        idx = np.tile(np.arange(self.n, dtype=np.int32)[:, None],
                      (1, d_max))
        wgt = np.full((self.n, d_max), _ELL_INF, np.float32)
        # row-major nonzero enumeration is ascending within each row
        rows, cols = np.nonzero(adj)
        slot = np.arange(len(rows)) - np.searchsorted(rows, rows)
        idx[rows, slot] = cols.astype(np.int32)
        wgt[rows, slot] = lengths[cols, rows]   # incoming: w(col -> row)
        out = EllGraph(idx=idx, wgt=wgt)
        out.validate()
        return out


def as_cap(topo: Topology | np.ndarray) -> np.ndarray:
    """Coerce a Topology or a bare capacity matrix to an [N, N] float array."""
    if isinstance(topo, Topology):
        return topo.cap
    return np.asarray(topo, dtype=np.float64)


def connected_components(topo: Topology | np.ndarray) -> np.ndarray:
    """[N] int component label per switch (equal label = a path exists).

    Plain BFS over the nonzero pattern of the (symmetric) capacity matrix —
    the cheap host-side reachability check failure handling is built on: a
    demanded pair is routable iff its endpoints share a label."""
    adj = as_cap(topo) > 0
    n = adj.shape[0]
    labels = np.full(n, -1, np.int64)
    comp = 0
    for start in range(n):
        if labels[start] >= 0:
            continue
        frontier = np.zeros(n, bool)
        frontier[start] = True
        member = frontier.copy()
        while frontier.any():
            frontier = (adj[frontier].any(axis=0)) & ~member
            member |= frontier
        labels[member] = comp
        comp += 1
    return labels


def _servers_vec(servers: int | Sequence[int], n: int) -> np.ndarray:
    srv = np.asarray(servers, dtype=np.int64)
    if srv.ndim == 0:
        srv = np.full(n, int(srv), dtype=np.int64)
    if srv.shape != (n,):
        raise ValueError(f"servers must be a scalar or a length-{n} vector")
    return srv


def _pair_stubs(stubs_a: np.ndarray, stubs_b: np.ndarray | None,
                rng: np.random.Generator) -> np.ndarray:
    """Randomly pair stubs.  If stubs_b is None pair within stubs_a,
    else pair each of stubs_a with one of stubs_b (bipartite).
    Returns an array of (u, v) pairs (may contain self loops / multi-edges;
    caller repairs)."""
    if stubs_b is None:
        s = rng.permutation(stubs_a)
        half = len(s) // 2
        return np.stack([s[:half], s[half: 2 * half]], axis=1)
    a = rng.permutation(stubs_a)
    b = rng.permutation(stubs_b)
    k = min(len(a), len(b))
    return np.stack([a[:k], b[:k]], axis=1)


def _repair_multigraph(adj: np.ndarray, rng: np.random.Generator,
                       max_iter: int = 4_000) -> np.ndarray:
    """Remove self-loops and multi-edges by double-edge swaps, preserving the
    degree sequence.  ``adj`` is an integer multi-adjacency matrix."""
    adj = adj.copy()
    for _ in range(max_iter):
        bad_self = np.flatnonzero(np.diag(adj) > 0)
        multi = np.argwhere(np.triu(adj, 1) > 1)
        if len(bad_self) == 0 and len(multi) == 0:
            return adj
        # pick one offending placement
        if len(bad_self) > 0:
            u, v = int(bad_self[0]), int(bad_self[0])
        else:
            u, v = int(multi[0][0]), int(multi[0][1])
        # pick a random other edge (x, y) and swap: (u,v),(x,y) -> (u,x),(v,y)
        xs, ys = np.nonzero(np.triu(adj, 0))
        if len(xs) == 0:
            break
        for _try in range(200):
            i = int(rng.integers(len(xs)))
            x, y = int(xs[i]), int(ys[i])
            if rng.random() < 0.5:
                x, y = y, x
            if len({u, v, x, y}) < (3 if u == v else 4):
                continue
            # would the swap introduce new conflicts? allow reductions only
            if adj[u, x] > 0 or adj[v, y] > 0 or u == x or v == y:
                continue
            adj[u, v] -= 1
            adj[v, u] -= 1
            adj[x, y] -= 1
            adj[y, x] -= 1
            adj[u, x] += 1
            adj[x, u] += 1
            adj[v, y] += 1
            adj[y, v] += 1
            break
        else:
            # reshuffle failure: give up this offender ordering; try again
            continue
    raise RuntimeError("could not repair multigraph into a simple graph")


def random_graph_from_degrees(degrees: Sequence[int], seed: int,
                              capacity: float = 1.0,
                              allow_multi: bool = False,
                              servers: int | Sequence[int] = 0) -> Topology:
    """Sample a (near-)uniform simple graph with the given degree sequence via
    the configuration model with double-edge-swap repair (the Jellyfish
    construction).  ``servers`` attaches that many servers per switch (scalar)
    or per-switch counts (vector).

    ``allow_multi=True`` keeps parallel edges (their capacities sum) and only
    repairs self-loops — used for fabrics whose degree sequence is not
    graphical as a simple graph (parallel links are physically fine)."""
    cap = _random_graph_cap(degrees, seed, capacity, allow_multi)
    return Topology(cap=cap, servers=_servers_vec(servers, len(cap)))


def _random_graph_cap(degrees: Sequence[int], seed: int,
                      capacity: float = 1.0,
                      allow_multi: bool = False) -> np.ndarray:
    """Bare-matrix variant of ``random_graph_from_degrees``."""
    degrees = np.asarray(degrees, dtype=np.int64)
    n = len(degrees)
    if degrees.sum() % 2 != 0:
        raise ValueError("degree sum must be even")
    for attempt in range(4):
        rng = np.random.default_rng(seed + 7919 * attempt)
        stubs = np.repeat(np.arange(n), degrees)
        pairs = _pair_stubs(stubs, None, rng)
        adj = np.zeros((n, n), dtype=np.int64)
        np.add.at(adj, (pairs[:, 0], pairs[:, 1]), 1)
        np.add.at(adj, (pairs[:, 1], pairs[:, 0]), 1)
        try:
            if allow_multi:
                adj = _repair_self_loops(adj, rng)
            else:
                adj = _repair_multigraph(adj, rng)
            return adj.astype(np.float64) * capacity
        except RuntimeError:
            if attempt == 3:
                # near-non-graphical sequence: fall back to parallel links
                # (physically valid — capacities sum) rather than failing
                adj = _repair_self_loops(adj, rng)
                return adj.astype(np.float64) * capacity
    raise AssertionError("unreachable")


def _repair_self_loops(adj: np.ndarray, rng: np.random.Generator,
                       max_iter: int = 20_000) -> np.ndarray:
    """Remove self-loops only (multi-edges allowed), preserving degrees: swap
    the loop (u,u) with a random edge (x,y), u != x,y -> (u,x),(u,y)."""
    adj = adj.copy()
    for _ in range(max_iter):
        loops = np.flatnonzero(np.diag(adj) > 0)
        if len(loops) == 0:
            return adj
        u = int(loops[0])
        xs, ys = np.nonzero(np.triu(adj, 1))
        cand = [(x, y) for x, y in zip(xs, ys) if x != u and y != u]
        if not cand:
            # degenerate: all edges touch u; drop the loop (2 ports unused)
            adj[u, u] -= 2
            continue
        x, y = cand[int(rng.integers(len(cand)))]
        adj[u, u] -= 2
        adj[x, y] -= 1
        adj[y, x] -= 1
        adj[u, x] += 1
        adj[x, u] += 1
        adj[u, y] += 1
        adj[y, u] += 1
    raise RuntimeError("could not remove self-loops")


def random_regular_graph(n: int, r: int, seed: int, capacity: float = 1.0,
                         servers: int | Sequence[int] = 0) -> Topology:
    """RRG(n, r): r-regular simple graph on n nodes."""
    cap = _random_regular_cap(n, r, seed, capacity)
    return Topology(cap=cap, servers=_servers_vec(servers, n))


def _random_regular_cap(n: int, r: int, seed: int,
                        capacity: float = 1.0) -> np.ndarray:
    """Bare-matrix variant of ``random_regular_graph``."""
    if n * r % 2 != 0:
        raise ValueError("n*r must be even")
    if r >= n:
        raise ValueError("need r < n")
    return _random_graph_cap([r] * n, seed, capacity)


def random_regular_ell(n: int, r: int, seed: int) -> EllGraph:
    """A degree-(<= r) random regular unit-length graph DIRECTLY in
    padded-ELL form — never materializes the dense matrix, which is the
    point: at N=16384 the dense float32 pattern alone is 1 GB, more than
    the whole streamed APSP budget.

    Construction: a ring (connectivity) unioned with ``r/2 - 1`` random
    permutation cycles, deduped — the standard sparse stand-in for the
    configuration-model RRG (same degree bound, same O(log N) diameter
    regime as Jellyfish graphs).  ``r`` must be even so the cycle union
    respects the degree bound.  Frontier probes in
    ``benchmarks/scale_bench.py`` are built here."""
    if r < 2 or r % 2:
        raise ValueError(f"r must be even and >= 2, got {r}")
    if r >= n:
        raise ValueError("need r < n")
    rng = np.random.default_rng(seed)
    nbrs = [set() for _ in range(n)]

    def add(u: int, v: int) -> None:
        if u != v:
            nbrs[u].add(v)
            nbrs[v].add(u)

    for i in range(n):
        add(i, (i + 1) % n)
    for _ in range(r // 2 - 1):
        perm = rng.permutation(n)
        for i in range(n):
            add(int(perm[i]), int(perm[(i + 1) % n]))
    d_max = max(len(s) for s in nbrs)
    idx = np.tile(np.arange(n, dtype=np.int32)[:, None], (1, d_max))
    wgt = np.full((n, d_max), _ELL_INF, np.float32)
    for v, s in enumerate(nbrs):
        js = sorted(s)
        idx[v, :len(js)] = js
        wgt[v, :len(js)] = 1.0
    out = EllGraph(idx=idx, wgt=wgt)
    out.validate()
    return out


def biased_two_cluster_graph(
    deg_a: Sequence[int],
    deg_b: Sequence[int],
    cross_bias: float,
    seed: int,
    capacity: float = 1.0,
    servers: int | Sequence[int] = 0,
) -> Topology:
    """Two clusters of switches with network degrees ``deg_a`` / ``deg_b``.

    ``cross_bias`` scales the number of cross-cluster edges relative to the
    *expected* number under an unbiased (configuration-model) random graph,
    matching the x-axis normalisation of Figs. 5-7 in the paper.
    ``cross_bias=1`` recovers the vanilla random construction.

    Returns a Topology with labels 0 for cluster A, 1 for cluster B.
    """
    cap, labels = _biased_two_cluster_cap(deg_a, deg_b, cross_bias, seed,
                                          capacity)
    return Topology(cap=cap, servers=_servers_vec(servers, len(cap)),
                    labels=labels)


def _biased_two_cluster_cap(
    deg_a: Sequence[int],
    deg_b: Sequence[int],
    cross_bias: float,
    seed: int,
    capacity: float = 1.0,
) -> tuple[np.ndarray, np.ndarray]:
    """Bare-matrix variant of ``biased_two_cluster_graph``:
    returns (cap[N,N], labels[N])."""
    deg_a = np.asarray(deg_a, dtype=np.int64)
    deg_b = np.asarray(deg_b, dtype=np.int64)
    na, nb = len(deg_a), len(deg_b)
    n = na + nb
    sa, sb = int(deg_a.sum()), int(deg_b.sum())
    s_tot = sa + sb
    if sa % 2 != sb % 2:
        # (sa - n_cross) and (sb - n_cross) always share n_cross's parity
        # flip, so no n_cross leaves both clusters' leftover stub counts
        # even — the old ±1 fixup loop below would never terminate.
        raise ValueError(
            f"cluster stub counts have different parity (sum(deg_a)={sa}, "
            f"sum(deg_b)={sb}); the total stub count must be even and both "
            "cluster degree sums must have the same parity — adjust "
            "deg_a/deg_b")
    rng = np.random.default_rng(seed)

    # expected cross edges under the unbiased configuration model
    exp_cross = sa * sb / max(s_tot - 1, 1)
    n_cross = int(round(cross_bias * exp_cross))
    n_cross = max(0, min(n_cross, min(sa, sb)))
    # parity: remaining stubs inside each cluster must be even (same-parity
    # sums guarantee this resolves in at most one ±1 step)
    while (sa - n_cross) % 2 != 0 or (sb - n_cross) % 2 != 0:
        n_cross += 1 if n_cross < min(sa, sb) else -1

    stubs_a = np.repeat(np.arange(na), deg_a)
    stubs_b = np.repeat(np.arange(nb), deg_b) + na
    stubs_a = rng.permutation(stubs_a)
    stubs_b = rng.permutation(stubs_b)

    pairs = []
    pairs.append(np.stack([stubs_a[:n_cross], stubs_b[:n_cross]], axis=1))
    rest_a = stubs_a[n_cross:]
    rest_b = stubs_b[n_cross:]
    if len(rest_a) >= 2:
        pairs.append(_pair_stubs(rest_a, None, rng))
    if len(rest_b) >= 2:
        pairs.append(_pair_stubs(rest_b, None, rng))
    pairs = np.concatenate([p for p in pairs if len(p)], axis=0)

    adj = np.zeros((n, n), dtype=np.int64)
    np.add.at(adj, (pairs[:, 0], pairs[:, 1]), 1)
    np.add.at(adj, (pairs[:, 1], pairs[:, 0]), 1)
    adj = _repair_two_cluster(adj, na, rng)
    labels = np.concatenate([np.zeros(na, np.int64), np.ones(nb, np.int64)])
    return adj.astype(np.float64) * capacity, labels


def _repair_two_cluster(adj: np.ndarray, na: int, rng: np.random.Generator,
                        max_iter: int = 20_000) -> np.ndarray:
    """Like _repair_multigraph but swaps only with a partner edge of the same
    class (intra-A / intra-B / cross), with the swap oriented so every new
    edge stays in-class — the cross-cluster edge count is preserved exactly.

    * intra offender (u,v) + intra partner (x,y):  -> (u,x),(v,y)
    * cross offender (a1,b1) + cross partner (a2,b2) with a in A, b in B:
                                                   -> (a1,b2),(a2,b1)
    Self-loops only ever occur inside a cluster (a cross pairing has distinct
    endpoints by construction)."""
    adj = adj.copy()

    def is_cross(u, v):
        return (u < na) != (v < na)

    # stall detection: when no swap reduces the offender count for a whole
    # window (a cluster too dense to be simple), jump straight to the
    # multi-edge fallback below instead of burning the full budget — the
    # designer's bias-perturbation moves probe exactly such corners and a
    # hopeless repair here used to cost seconds per candidate
    best_bad = np.inf
    stall = 0
    for _ in range(max_iter):
        bad_self = np.flatnonzero(np.diag(adj) > 0)
        multi = np.argwhere(np.triu(adj, 1) > 1)
        if len(bad_self) == 0 and len(multi) == 0:
            return adj
        bad = len(bad_self) + len(multi)
        if bad < best_bad:
            best_bad, stall = bad, 0
        else:
            stall += 1
            if stall > 200:
                break
        if len(bad_self) > 0:
            i = int(rng.integers(len(bad_self)))
            u = v = int(bad_self[i])
        else:
            i = int(rng.integers(len(multi)))
            u, v = int(multi[i][0]), int(multi[i][1])
        cross = is_cross(u, v)
        xs, ys = np.nonzero(np.triu(adj, 1) if cross else adj)
        # candidate partners of the same class — for intra offenders the
        # partner must be in the SAME cluster (an other-cluster intra swap
        # would mint two cross edges and break the bias semantics)
        same = [(int(x), int(y)) for x, y in zip(xs, ys)
                if is_cross(x, y) == cross
                and (cross or (x < na) == (u < na))]
        rng.shuffle(same)
        for x, y in same[:600]:
            if cross:
                a1, b1 = (u, v) if u < na else (v, u)
                a2, b2 = (x, y) if x < na else (y, x)
                if a1 == a2 or b1 == b2:
                    continue
                if adj[a1, b2] > 0 or adj[a2, b1] > 0:
                    continue
                new_edges = ((a1, b2), (a2, b1))
                old_edges = ((a1, b1), (a2, b2))
            else:
                if len({u, v, x, y}) < (3 if u == v else 4):
                    continue
                if u == x or v == y or adj[u, x] > 0 or adj[v, y] > 0:
                    continue
                if u == v and (adj[u, y] > 0 or x == y):
                    # self-loop (u,u) + (x,y) -> (u,x),(u,y)
                    continue
                if u == v:
                    new_edges = ((u, x), (u, y))
                else:
                    new_edges = ((u, x), (v, y))
                old_edges = ((u, v), (x, y))
            for (p, q) in old_edges:
                adj[p, q] -= 1
                if p != q:
                    adj[q, p] -= 1
                else:
                    adj[p, q] -= 1          # a self-loop uses two stubs
            for (p, q) in new_edges:
                adj[p, q] += 1
                adj[q, p] += 1
            break
    # iteration budget exhausted: a cluster may be too dense for a simple
    # graph (e.g. strongly-biased intra wiring).  Keep the remaining
    # multi-edges as parallel links (capacities sum — physically valid) and
    # retire leftover self-loop ports.
    loops = np.flatnonzero(np.diag(adj) > 0)
    for u in loops:
        adj[u, u] = 0
    return adj


def power_law_degrees(n: int, k_min: int, k_max: int, alpha: float,
                      seed: int) -> np.ndarray:
    """Port counts following a (discretised, truncated) power law
    P(k) ~ k^-alpha on [k_min, k_max] (paper Fig. 4 setup).  ``k_min ==
    k_max`` degenerates to a constant draw; an empty or inverted range
    raises ``ValueError``."""
    if k_min < 1:
        raise ValueError(f"k_min must be >= 1, got {k_min} (a switch needs "
                         "at least one port)")
    if k_max < k_min:
        raise ValueError(f"empty degree range: k_min={k_min} > k_max={k_max}")
    rng = np.random.default_rng(seed)
    ks = np.arange(k_min, k_max + 1, dtype=np.float64)
    p = ks ** (-alpha)
    p /= p.sum()
    return rng.choice(ks.astype(np.int64), size=n, p=p)


def distribute_servers(port_counts: Sequence[int], num_servers: int,
                       beta: float = 1.0) -> np.ndarray:
    """Distribute ``num_servers`` across switches in proportion to
    ``port_count**beta`` (paper Fig. 4), largest-remainder rounding, capped at
    port_count - 1 so every switch keeps at least one network port.

    Edge cases are pinned (expansion steps start from tiny pools):
    ``num_servers == 0`` returns all zeros, fewer servers than switches
    distributes without silent loss, and an empty pool (or a negative
    count) raises instead of returning a bad vector."""
    k = np.asarray(port_counts, dtype=np.float64)
    if num_servers < 0:
        raise ValueError(f"num_servers must be >= 0, got {num_servers}")
    if len(k) == 0:
        if num_servers == 0:
            return np.zeros(0, np.int64)
        raise ValueError("cannot distribute servers over an empty switch "
                         "pool")
    if num_servers == 0:
        return np.zeros(len(k), np.int64)
    w = k ** beta
    ideal = num_servers * w / w.sum()
    base = np.floor(ideal).astype(np.int64)
    rem = num_servers - int(base.sum())
    if rem > 0:
        order = np.argsort(-(ideal - base))
        base[order[:rem]] += 1
    # cap: leave >= 1 network port per switch, reassign overflow greedily
    cap_limit = np.asarray(port_counts, np.int64) - 1
    overflow = np.maximum(base - cap_limit, 0).sum()
    base = np.minimum(base, cap_limit)
    while overflow > 0:
        room = cap_limit - base
        i = int(np.argmax(room))
        if room[i] <= 0:
            raise ValueError("not enough ports for the requested servers")
        take = int(min(overflow, room[i]))
        base[i] += take
        overflow -= take
    return base

"""NCBI-style taxonomy: array-backed tree with ranks and merged-ID mapping.

Equivalent of the reference Taxonomy (Taxonomy.scala): taxa are dense int IDs
indexing `parents`, `rank_depth`, `names` and `primary` arrays; NONE=0 and
ROOT=1 are special. Only ROOT and taxa with a non-NONE parent are defined
(Taxonomy.scala:174-176).

For the device, the taxonomy is exported as small int32 arrays copied to
device memory once (the analogue of the reference's Spark broadcast,
KeyValueIndex.scala:44-47).
"""

from __future__ import annotations

from typing import Iterable, List, Optional, Tuple

import numpy as np

NONE = 0
ROOT = 1

#: Standard ranks, general -> specific, with depths 0..8 (Taxonomy.scala:39-52)
RANKS = [
    ("root", "R", 0),
    ("superkingdom", "D", 1),
    ("kingdom", "K", 2),
    ("phylum", "P", 3),
    ("class", "C", 4),
    ("order", "O", 5),
    ("family", "F", 6),
    ("genus", "G", 7),
    ("species", "S", 8),
]
RANK_TITLES = [r[0] for r in RANKS]
RANK_DEPTH = {title: depth for title, _, depth in RANKS}
RANK_CODE = {depth: code for _, code, depth in RANKS}
RANK_CODE[-1] = "U"  # unclassified

NO_RANK = -128  # sentinel for taxa without a standard rank ("no rank" etc.)
UNCLASSIFIED_DEPTH = -1


def rank_depth_of(title: str) -> int:
    if title == "unclassified":
        return UNCLASSIFIED_DEPTH
    return RANK_DEPTH.get(title, NO_RANK)


def depth_to_title(depth: int) -> Optional[str]:
    for title, _, d in RANKS:
        if d == depth:
            return title
    if depth == UNCLASSIFIED_DEPTH:
        return "unclassified"
    return None


class Taxonomy:
    def __init__(
        self,
        parents: np.ndarray,
        rank_depth: np.ndarray,
        names: List[Optional[str]],
        primary: np.ndarray,
        rank_titles: Optional[List[Optional[str]]] = None,
    ):
        self.parents = np.asarray(parents, dtype=np.int32)
        self.rank_depth = np.asarray(rank_depth, dtype=np.int16)
        self.names = names
        self.primary = np.asarray(primary, dtype=np.int32)
        # raw rank titles (for round-tripping nodes.dmp); optional
        self.rank_titles = rank_titles
        self._children: Optional[List[List[int]]] = None
        self._rpath_table: Optional[np.ndarray] = None
        self._depth_std: Optional[np.ndarray] = None
        self._max_path: Optional[int] = None

    # -- construction -------------------------------------------------------

    @classmethod
    def from_nodes_and_names(
        cls,
        nodes: Iterable[Tuple[int, int, str]],
        names: Iterable[Tuple[int, str]],
        merged: Iterable[Tuple[int, int]] = (),
    ) -> "Taxonomy":
        """Construct from (taxid, parent, rank-title), (taxid, name), and
        merged (secondary, primary) tuples (Taxonomy.scala:81-109)."""
        nodes = list(nodes)
        merged = list(merged)
        max1 = max((t for t, _, _ in nodes), default=-1) + 1
        max2 = max((t for t, _ in merged), default=-1) + 1
        n = max(max1, max2, ROOT + 1)

        parents = np.zeros(n, dtype=np.int32)
        rank_depth = np.full(n, NO_RANK, dtype=np.int16)
        rank_titles: List[Optional[str]] = [None] * n
        name_arr: List[Optional[str]] = [None] * n
        for taxid, parent, rank in nodes:
            parents[taxid] = parent
            rank_depth[taxid] = rank_depth_of(rank)
            rank_titles[taxid] = rank
        for taxid, name in names:
            if taxid < n:
                name_arr[taxid] = name
        name_arr[NONE] = "unclassified"
        primary = np.arange(n, dtype=np.int32)
        for sec, prim in merged:
            primary[sec] = prim
        parents[ROOT] = NONE
        rank_depth[NONE] = UNCLASSIFIED_DEPTH
        rank_depth[ROOT] = 0
        if rank_titles[ROOT] is None:
            rank_titles[ROOT] = "root"
        return cls(parents, rank_depth, name_arr, primary, rank_titles)

    @classmethod
    def load(cls, directory: str) -> "Taxonomy":
        """Read NCBI nodes.dmp / names.dmp / merged.dmp (Taxonomy.scala:116-137)."""

        from . import storage

        def rows(path):
            with storage.open_file(path, "r") as f:
                for line in f:
                    yield [p.strip() for p in line.split("|")]

        nodes = [
            (int(x[0]), int(x[1]), x[2]) for x in rows(storage.join(directory, "nodes.dmp"))
        ]
        names = [
            (int(x[0]), x[1])
            for x in rows(storage.join(directory, "names.dmp"))
            if len(x) > 3 and x[3] == "scientific name"
        ]
        merged_path = storage.join(directory, "merged.dmp")
        merged = (
            [(int(x[0]), int(x[1])) for x in rows(merged_path)]
            if storage.exists(merged_path)
            else []
        )
        return cls.from_nodes_and_names(nodes, names, merged)

    def save(self, directory: str) -> None:
        """Write nodes.dmp / names.dmp / merged.dmp in NCBI format, so the
        index directory is self-contained (cf. Taxonomy.copyToLocation,
        Taxonomy.scala:142-146)."""
        from . import storage

        storage.makedirs(directory)
        with storage.open_file(storage.join(directory, "nodes.dmp"), "w") as f:
            for t in self.taxa():
                title = None
                if self.rank_titles is not None:
                    title = self.rank_titles[t]
                if title is None:
                    d = int(self.rank_depth[t])
                    title = depth_to_title(d) or "no rank"
                f.write(f"{t}\t|\t{int(self.parents[t])}\t|\t{title}\t|\n")
        with storage.open_file(storage.join(directory, "names.dmp"), "w") as f:
            for t in self.taxa():
                name = self.names[t] if t < len(self.names) else None
                if name is not None:
                    f.write(f"{t}\t|\t{name}\t|\t\t|\tscientific name\t|\n")
        with storage.open_file(storage.join(directory, "merged.dmp"), "w") as f:
            for sec in range(len(self.primary)):
                if self.primary[sec] != sec:
                    f.write(f"{sec}\t|\t{int(self.primary[sec])}\t|\n")

    # -- basic queries ------------------------------------------------------

    @property
    def size(self) -> int:
        return len(self.parents)

    def taxa(self):
        """All defined taxa in [1, size)."""
        return (t for t in range(1, self.size) if self.is_defined(t))

    def is_defined(self, taxon: int) -> bool:
        return taxon == ROOT or (0 <= taxon < self.size and self.parents[taxon] != NONE)

    def is_leaf(self, taxon: int) -> bool:
        return len(self.children[taxon]) == 0

    def get_name(self, taxon: int) -> Optional[str]:
        return self.names[taxon] if 0 <= taxon < len(self.names) else None

    @property
    def children(self) -> List[List[int]]:
        """Children lists; iteration order is descending taxid, matching the
        reference's prepend construction (Taxonomy.scala:193-201) which the
        report DFS tie-break depends on."""
        if self._children is None:
            ch: List[List[int]] = [[] for _ in range(self.size)]
            for t in range(self.size - 1, 0, -1):
                if self.is_defined(t) and t != ROOT:
                    ch[self.parents[t]].append(t)
            self._children = ch
        return self._children

    def path_to_root(self, taxon: int):
        """Taxa from `taxon` (inclusive) up to ROOT."""
        t = int(taxon)
        while t != NONE:
            yield t
            t = int(self.parents[t])

    def depth(self, taxon: int) -> int:
        """Standardised depth (0=root .. 8=species), walking up past
        non-standard ranks (Taxonomy.scala:221-228)."""
        return int(self.depth_std[taxon])

    @property
    def depth_std(self) -> np.ndarray:
        """Vectorised standardised depth for all taxa (-1 for NONE/undefined)."""
        if self._depth_std is None:
            n = self.size
            out = np.full(n, UNCLASSIFIED_DEPTH, dtype=np.int16)
            # iterative DP: resolve each taxon by walking up until a
            # standard-ranked ancestor is found
            order = list(self._toposort())
            for t in order:
                d = self.rank_depth[t]
                if d != NO_RANK:
                    out[t] = d
                else:
                    out[t] = out[self.parents[t]]
            out[NONE] = UNCLASSIFIED_DEPTH
            self._depth_std = out
        return self._depth_std

    def _toposort(self):
        """Defined taxa in parent-before-child order."""
        n = self.size
        state = np.zeros(n, dtype=np.uint8)  # 0=unseen, 1=done
        state[NONE] = 1
        state[ROOT] = 1
        yield ROOT
        for t in range(1, n):
            if state[t] or not self.is_defined(t):
                continue
            stack = []
            x = t
            while not state[x]:
                stack.append(x)
                x = int(self.parents[x])
            while stack:
                y = stack.pop()
                state[y] = 1
                yield y

    @property
    def max_path_len(self) -> int:
        """Longest parent-chain length over all defined taxa (for bounding
        device path walks; the reference uses a fixed 256 buffer,
        LowestCommonAncestor.scala:34)."""
        if self._max_path is None:
            n = self.size
            plen = np.zeros(n, dtype=np.int32)
            for t in self._toposort():
                plen[t] = 1 if t == ROOT else plen[self.parents[t]] + 1
            self._max_path = int(plen.max()) if n > 1 else 1
        return self._max_path

    # -- tree algorithms (host) --------------------------------------------

    def lca(self, a: int, b: int) -> int:
        if a == NONE or b == NONE:
            return a if b == NONE else b
        path = set(self.path_to_root(a))
        for t in self.path_to_root(b):
            if t in path:
                return t
        return ROOT

    def has_ancestor(self, tax: int, ancestor: int) -> bool:
        return any(t == ancestor for t in self.path_to_root(tax))

    def steps_to_ancestor(self, tax: int, ancestor: int) -> int:
        for i, t in enumerate(self.path_to_root(tax)):
            if t == ancestor:
                return i
        return -1

    def standard_steps_to_ancestor(self, tax: int, ancestor: int) -> int:
        if self.has_ancestor(tax, ancestor):
            return self.depth(tax) - self.depth(ancestor)
        return -1

    def sublevel(self, tax: int) -> int:
        """S=0, S1=1, S2=2 ... (Taxonomy.scala:259-262)."""
        d = self.depth(tax)
        count = 0
        for t in self.path_to_root(tax):
            if self.depth(t) == d:
                count += 1
            else:
                break
        return count - 1

    def ancestor_at_level(self, query: int, rank_depth: int) -> Optional[int]:
        for t in self.path_to_root(query):
            if self.depth(t) == rank_depth:
                return t
        return None

    def standard_ancestor_at_level(self, query: int, rank_depth: int) -> Optional[int]:
        last = None
        for t in self.path_to_root(query):
            if self.depth(t) >= rank_depth:
                last = t
            else:
                break
        return last

    def taxa_with_ancestors(self, taxa: Iterable[int]) -> set:
        out: set = set()
        for a in taxa:
            for t in self.path_to_root(a):
                if t in out:
                    break
                out.add(t)
        return out

    def taxa_with_descendants(self, taxa: Iterable[int]) -> set:
        out = set(taxa)
        stack = list(out)
        while stack:
            t = stack.pop()
            for c in self.children[t]:
                if c not in out:
                    out.add(c)
                    stack.append(c)
        return out

    def count_distinct_taxa_with_ancestors(self, taxa: Iterable[int]) -> int:
        return len(self.taxa_with_ancestors(taxa))

    def missing_steps_to_root(self, taxon: int) -> List[int]:
        found = {self.depth(t) for t in self.path_to_root(taxon)}
        return [d for d in range(1, 9) if d not in found]

    def rpath_table(self, max_path: Optional[int] = None) -> np.ndarray:
        """Root-aligned ancestor path table [size, D] int32: row t holds the
        ancestors of t indexed by real depth (root at column 0), -1 padded.

        Replicated to device HBM, this turns every tree walk (resolveTree
        scoring, LCA, segment-LCA) into a single contiguous row gather
        instead of D dependent pointer-chasing gathers.
        """
        D = max_path or self.max_path_len
        if D > 256:
            # the reference bounds taxonomy paths at 256
            # (LowestCommonAncestor.scala:34); deeper chains indicate corrupt
            # input and would explode the table (size x D x 4 bytes)
            raise ValueError(
                f"taxonomy path length {D} exceeds the supported bound of 256"
            )
        if getattr(self, "_rpath_table", None) is not None and self._rpath_table.shape[1] >= D:
            return self._rpath_table[:, :D]
        n = self.size
        table = np.full((n, D), -1, dtype=np.int32)
        # real depth per taxon
        depth = np.full(n, -1, dtype=np.int32)
        order = list(self._toposort())
        for t in order:
            depth[t] = 0 if t == ROOT else depth[self.parents[t]] + 1
        # undefined non-NONE taxa sit alone at depth 0 (their path is [t])
        undefined = np.ones(n, bool)
        undefined[[t for t in order]] = False
        undefined[NONE] = False
        depth[undefined] = 0
        # fill level by level: copy the parent's prefix, then set own entry
        order_arr = np.array(order + list(np.flatnonzero(undefined)), dtype=np.int64)
        for d in range(0, int(depth.max()) + 1 if n > 1 else 1):
            nodes = order_arr[depth[order_arr] == d]
            if len(nodes) == 0:
                continue
            if d > 0:
                table[nodes, :d] = table[self.parents[nodes], :d]
            if d < D:
                table[nodes, d] = nodes
        self._rpath_table = table
        return table

    # -- device export ------------------------------------------------------

    def device_arrays(self):
        """Arrays for on-device tree walks: (parents int32, depth_std int32)."""
        return (
            self.parents.astype(np.int32),
            self.depth_std.astype(np.int32),
        )

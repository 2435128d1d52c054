"""What the traffic kinds share: seeds, the deployment's library and taxonomy
made from the seed, the program's index over them, and the comparison of an
index with the reference's."""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

from ..gen.libraries import LIBRARIES, TAXONOMIES
from ..reference.index import ReferenceIndex
from ..reference.minimizers import MinimizerSpec
from ..reference.tree import Tree

#: independent random streams drawn from one --seed
LIBRARY, READS, OUTSIDE, SAMPLE = 1, 2, 3, 4


def subseed(seed: int, stream: int) -> int:
    """A 64-bit seed of its own for each stream of a run's --seed."""
    return int(np.random.SeedSequence([int(seed) % (1 << 64), stream]).generate_state(1, np.uint64)[0])


def rng(seed: int, stream: int) -> np.random.Generator:
    return np.random.default_rng(subseed(seed, stream))


def library(config: dict, seed: int) -> List[Tuple[int, str]]:
    """The deployment's genomes, (taxon, sequence), drawn from the seed;
    their sizes are the configuration's whatever the seed."""
    lib = config["library"]
    return list(LIBRARIES[lib["generator"]](lib, tree_tuples(config)[0], subseed(seed, LIBRARY)))


def tree_tuples(config: dict):
    tax = config["taxonomy"]
    return TAXONOMIES[tax["generator"]](tax)


def reference_tree(config: dict) -> Tree:
    return Tree(*tree_tuples(config))


def program_taxonomy(config: dict):
    from slacken_tpu_torch.taxonomy import Taxonomy

    return Taxonomy.from_nodes_and_names(*tree_tuples(config))


def index_params(config: dict):
    from slacken_tpu_torch.index import IndexParams

    spec = MinimizerSpec.of(config)
    return IndexParams(k=spec.k, m=spec.m, spaces=spec.spaces, toggle_mask=spec.toggle_mask,
                       canonical=True, ordering="xor")


def build_program_index(genomes, config: dict, taxonomy, device, trace: bool = False):
    """The program's index of the genomes, built on `device` as the CLI's
    build does, under the default device budget."""
    from slacken_tpu_torch.index import KeyValueIndex

    return KeyValueIndex.build(iter(genomes), index_params(config), taxonomy, device, trace=trace)


def reference_index(genomes, config: dict, tree: Tree, device, drop_bits: int = 0) -> ReferenceIndex:
    return ReferenceIndex.build(genomes, MinimizerSpec.of(config), tree, device, drop_bits)


def index_diff(keys: torch.Tensor, taxa: torch.Tensor, ref: ReferenceIndex) -> int:
    """Records of either index that the other does not hold alike: the
    program's and the reference's record counts less twice the (key,
    taxon) records they share. 0 when they are the same."""
    keys = keys.to(ref.keys.device).reshape(-1)
    taxa = taxa.to(ref.keys.device).to(torch.int32).reshape(-1)
    n = ref.keys.shape[0]
    if n == 0 or keys.shape[0] == 0:
        return int(n + keys.shape[0])
    pos = torch.searchsorted(ref.keys, keys).clamp(max=n - 1)
    common = int(((ref.keys[pos] == keys) & (ref.taxa[pos] == taxa)).sum())
    return int(keys.shape[0]) + n - 2 * common


def fingerprint(keys: torch.Tensor, taxa: torch.Tensor) -> Tuple[int, torch.Tensor]:
    """(records, a position-weighted 64-bit sum of keys and taxa), the sum
    a tensor on the keys' device, made in blocks and not waited for: two
    indexes with the same records in the same order read alike, and one
    record changed, lost or moved changes it."""
    keys, taxa = keys.reshape(-1), taxa.reshape(-1).to(torch.int64)
    total = torch.zeros((), dtype=torch.int64, device=keys.device)
    block = 1 << 24
    for a in range(0, keys.shape[0], block):
        k, t = keys[a : a + block], taxa[a : a + block]
        w = torch.arange(a, a + k.shape[0], dtype=torch.int64, device=keys.device) * 2 + 1
        total += ((k ^ (t * -7046029254386353131)) * w).sum()
    return int(keys.shape[0]), total


class GenomeList:
    """The genome library interface that BrackenWeights reads (sequences)
    over (taxon, sequence) genomes held in memory."""

    def __init__(self, genomes):
        self.genomes = genomes

    def sequences(self):
        for i, (taxon, seq) in enumerate(self.genomes):
            yield taxon, f"seq{i}", seq

"""Shape-faithful synthetic TIG datasets, copied from ``repro/tig/data.py``
(same generator, same numpy RNG use, so a seed gives the same graph in
both packages), and the JODIE CSV loader.

The paper's datasets (Tab.II) are not redistributable offline, so the
generator matches their *shape*: bipartite interaction streams (user ->
item) with power-law degrees, bursty repeat behaviour and optional dynamic
labels. Presets mirror Tab.II at reduced scale; ``scale`` multiplies nodes
and edges (``wikipedia-s`` at ``scale=10`` is the size of the paper's
Wikipedia, 9,227 nodes / 157,474 edges):

    name          nodes   edges    d_e  labels     paper original
    wikipedia-s   1_000   15_000   172  yes        9_227 / 157_474
    reddit-s      1_100   67_000   172  yes        10_984 / 672_447
    mooc-s          720   41_000   172  yes        7_144 / 411_749
    lastfm-s        200  130_000   172  no         1_980 / 1_293_103
    ml25m-s       4_400  500_000   100  no         221_588 / 25_000_095
    dgraphfin-s  97_000   86_000   100  yes(4)     4_889_537 / 4_300_999
    taobao-s    103_000 2_000_000  100  yes        5_149_747 / 100_135_088
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np

from repro_torch.tig.graph import TemporalGraph

__all__ = ["synthetic_tig", "load_jodie_csv", "PRESETS"]

PRESETS: dict[str, dict] = {
    # scale-reduced mirrors of paper Tab.II
    "wikipedia-s": dict(num_users=250, num_items=750, num_edges=15_000,
                        d_e=172, d_n=172, labeled=True, classes=2),
    "reddit-s": dict(num_users=300, num_items=800, num_edges=67_000,
                     d_e=172, d_n=172, labeled=True, classes=2),
    "mooc-s": dict(num_users=600, num_items=120, num_edges=41_000,
                   d_e=172, d_n=172, labeled=True, classes=2),
    "lastfm-s": dict(num_users=100, num_items=100, num_edges=130_000,
                     d_e=172, d_n=172, labeled=False, classes=0),
    "ml25m-s": dict(num_users=1_600, num_items=2_800, num_edges=500_000,
                    d_e=1, d_n=100, labeled=False, classes=0),
    "dgraphfin-s": dict(num_users=49_000, num_items=48_000, num_edges=86_000,
                        d_e=11, d_n=100, labeled=True, classes=4),
    "taobao-s": dict(num_users=52_000, num_items=51_000, num_edges=2_000_000,
                     d_e=4, d_n=100, labeled=True, classes=16),
    # tiny graphs for unit tests
    "tiny": dict(num_users=40, num_items=60, num_edges=1_200,
                 d_e=16, d_n=16, labeled=True, classes=2),
    "small": dict(num_users=150, num_items=250, num_edges=6_000,
                  d_e=32, d_n=32, labeled=True, classes=2),
}


def _rewire_repeats(
    users: np.ndarray, items: np.ndarray, repeat: np.ndarray
) -> np.ndarray:
    """Each repeat edge takes the item of its user's most recent NON-repeat
    (anchor) edge: a stable sort by user and a per-group forward-fill of
    anchor positions (a group's first row is always an anchor)."""
    ne = len(users)
    if ne == 0:
        return items.copy()
    order = np.argsort(users, kind="stable")
    u_s = users[order]
    first = np.empty(ne, dtype=bool)
    first[0] = True
    first[1:] = u_s[1:] != u_s[:-1]
    anchor = first | ~repeat[order]
    fill = np.maximum.accumulate(
        np.where(anchor, np.arange(ne, dtype=np.int64), 0))
    out = np.empty_like(items)
    out[order] = items[order][fill]
    return out


def synthetic_tig(
    name: str = "tiny",
    *,
    seed: int = 0,
    scale: float = 1.0,
    zipf_users: float = 1.6,
    zipf_items: float = 1.4,
    repeat_prob: float = 0.6,
) -> TemporalGraph:
    """Generate a bipartite power-law temporal interaction stream.

      * user activity and item popularity are zipfian,
      * with probability ``repeat_prob`` a user re-interacts with one of its
        recent items (temporal locality),
      * timestamps arrive as a Poisson-ish process with daily burstiness,
      * dynamic labels flip rarely (state-change indicators, JODIE-style).
    """
    if name not in PRESETS:
        raise KeyError(f"unknown preset {name!r}; options: {list(PRESETS)}")
    p = PRESETS[name]
    rng = np.random.default_rng(seed)
    nu = max(int(p["num_users"] * scale), 2)
    ni = max(int(p["num_items"] * scale), 2)
    ne = max(int(p["num_edges"] * scale), 10)
    n = nu + ni

    users = rng.zipf(zipf_users, ne) % nu
    items = rng.zipf(zipf_items, ne) % ni
    repeat = rng.uniform(size=ne) < repeat_prob
    items = _rewire_repeats(users, items, repeat)

    src = users.astype(np.int64)
    dst = (nu + items).astype(np.int64)

    # bursty timestamps: piecewise-intensity Poisson over ~30 "days"
    day = rng.integers(0, 30, ne)
    within = rng.exponential(1.0, ne)
    t = np.sort(day * 86_400.0 + within.cumsum() / within.sum() * 86_400.0)

    edge_feat = rng.normal(0, 1, (ne, p["d_e"])).astype(np.float32)
    node_feat = np.zeros((n, p["d_n"]), dtype=np.float32)  # paper: zeros

    labels = None
    if p["labeled"]:
        labels = np.full(ne, 0, dtype=np.int64)
        flip = rng.uniform(size=ne) < 0.005 * p["classes"]
        labels[flip] = rng.integers(1, max(p["classes"], 2), flip.sum())

    return TemporalGraph(
        src=src, dst=dst, t=t,
        edge_feat=edge_feat, node_feat=node_feat,
        labels=labels, name=name,
    )


def load_jodie_csv(path: str, *, d_n: int = 172,
                   name: Optional[str] = None) -> TemporalGraph:
    """Load the JODIE / TGN ``ml_<name>.csv`` interaction format::

        user_id, item_id, timestamp, state_label, feat_0, ..., feat_k

    Item ids are moved after the user ids (the bipartite convention).
    Parsing goes through the block reader of ``stream``, which takes
    integer timestamps, missing label columns and ragged feature columns
    (short rows zero-padded to the sniffed width; never an (E, 0) feature
    table). For streams too large to materialize, use
    ``stream.write_jodie_shards``.
    """
    from repro_torch.tig.stream import iter_jodie_blocks

    cols: list[tuple] = list(iter_jodie_blocks(path))
    if not cols:
        raise ValueError(f"{path}: no data rows")
    users = np.concatenate([c[0] for c in cols])
    items = np.concatenate([c[1] for c in cols])
    t = np.concatenate([c[2] for c in cols])
    labels = np.concatenate([c[3] for c in cols])
    feats = np.concatenate([c[4] for c in cols])
    if feats.shape[1] == 0:
        feats = np.zeros((len(users), 1), dtype=np.float32)
    nu = int(users.max()) + 1
    ni = int(items.max()) + 1
    order = np.argsort(t, kind="stable")
    return TemporalGraph(
        src=users[order],
        dst=(nu + items)[order],
        t=t[order],
        edge_feat=feats[order],
        node_feat=np.zeros((nu + ni, d_n), dtype=np.float32),
        labels=labels[order],
        name=name or os.path.basename(path),
    )

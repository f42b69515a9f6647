"""Records as noisy copies of latent entity vectors: two records match when
they share an entity (the recipe of the port's ``make_clustered_tables``,
rewritten here on the device).

``spec``: ``rows`` [n1, n2], ``d``, ``entities``, ``noise`` (the noise's
standard deviation a dimension against unit-variance entities),
``corpus_seed``.  Each side gets a ``value`` column, lognormal(2, 1).

The tables are drawn from ``corpus_seed``, part of the configuration, and
the run's seed puts each side's rows in an order of its own: every seed
joins the same records, so every seed does the same work.
"""
from __future__ import annotations

import torch

from harness.common import Tables, sub_seed


def make(spec: dict, seed: int, device) -> Tables:
    dev = torch.device(device)
    g = torch.Generator(device=dev).manual_seed(sub_seed(spec["corpus_seed"], "clustered"))
    order = torch.Generator(device=dev).manual_seed(sub_seed(seed, "order"))
    d, n_ent, noise = int(spec["d"]), int(spec["entities"]), float(spec["noise"])
    ents = torch.randn(n_ent, d, generator=g, device=dev)
    emb, ids, cols = [], [], []
    for n in spec["rows"]:
        idx = torch.randint(0, n_ent, (int(n),), generator=g, device=dev)
        x = torch.randn(int(n), d, generator=g, device=dev).mul_(noise).add_(ents[idx])
        x.div_(x.norm(dim=1, keepdim=True))
        value = torch.randn(int(n), generator=g, device=dev, dtype=torch.float64)
        perm = torch.randperm(int(n), generator=order, device=dev)
        emb.append(x[perm].cpu().numpy())
        ids.append(idx[perm].cpu().numpy())
        cols.append({"value": value[perm].add_(2.0).exp_().cpu().numpy()})
        del x
    return Tables(emb=emb, ids=ids, columns=cols)

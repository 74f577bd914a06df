"""The port's evidential head, trained alone on the CPU, is useful: its
uncertainty ranks its depth error on a held-out volume.

The port's counterpart of ``tests/test_evidential_training.py``, which
needs the reference core checkpoint and is marked slow; here the
probability volumes are synthetic, built from a seed with numpy, and the
test imports nothing of the JAX package.  About 20 s on two threads.
"""

import numpy as np
import torch

from aa_rmvsnet_tpu_torch.models import EvidentialHead
from aa_rmvsnet_tpu_torch.models import evidential as ev_t

torch.set_num_threads(2)

USEFUL_SIZE, USEFUL_D, PLANE_BIN = 16, 16, 11


def _volume(rng, band: tuple[float, float]):
    """A (1, D, H, W) probability volume of a plane at bin 11 of 16: peaked
    there where there is texture, and diffuse (random logits) inside the
    horizontal ``band`` of rows, where matching is ambiguous.  Returns the
    volume, the depth values and the true depth map."""
    D, size = USEFUL_D, USEFUL_SIZE
    logits = 0.5 * rng.randn(D, size, size)
    logits[PLANE_BIN] = 4.0 + rng.rand(size, size)
    lo, hi = int(band[0] * size), int(band[1] * size)
    logits[:, lo:hi] = 1.5 * rng.randn(D, hi - lo, size)
    prob = np.exp(logits) / np.exp(logits).sum(0, keepdims=True)
    dvals = (425.0 + 5.0 * np.arange(D)).astype(np.float32)
    return (prob[None].astype(np.float32), dvals[None],
            np.full((1, size, size), dvals[PLANE_BIN], np.float32))


def _roc_auc(score: np.ndarray, positive: np.ndarray) -> float:
    """Area under the ROC curve: the chance that a positive outscores a
    negative (ties count half), from the ranks of the scores."""
    order = np.argsort(score, kind="stable")
    ranks = np.empty(len(score))
    ranks[order] = np.arange(1, len(score) + 1)
    for value in np.unique(score):  # tied scores share their mean rank
        tied = score == value
        ranks[tied] = ranks[tied].mean()
    n_pos, n_neg = positive.sum(), (~positive).sum()
    return float((ranks[positive].sum() - n_pos * (n_pos + 1) / 2) / (n_pos * n_neg))


def test_trained_head_ranks_its_error():
    """The port's head alone, 50 Adam steps at 1e-3 on three seeded volumes
    (16x16, D = maxdisp = 16) with the band at three places: the loss falls,
    and on held-out volumes with the band elsewhere the eval-mode head's
    uncertainty ranks its error, ROC-AUC > 0.7 on a median split of
    |gamma - truth| (``tests/test_evidential_training.py``, which needs the
    reference checkpoint).  Before the evaluation one forward pass in train
    mode with momentum 1 sets the running statistics to the final weights'
    batch statistics: after so few steps the momentum-0.1 averages still
    hold the early weights' and put gamma off by several mm."""
    rng = np.random.RandomState(0)
    train = [_volume(rng, band) for band in ((0.25, 0.5), (0.5, 0.75), (0.0, 0.25))]
    prob, dvals, gt = (torch.from_numpy(np.concatenate(a)) for a in zip(*train))
    mask = torch.ones_like(gt)
    head = EvidentialHead(USEFUL_D, generator=torch.Generator().manual_seed(0)).train()
    optimizer = torch.optim.Adam(head.parameters(), lr=1e-3, eps=1e-8)
    losses = []
    for _ in range(50):
        optimizer.zero_grad(set_to_none=True)
        ev = head(prob, dvals)
        loss = ev_t.loss_emvsnet(ev["gamma"], ev["nu"], ev["alpha"], ev["beta"], gt, mask)
        loss.backward()
        optimizer.step()
        losses.append(loss.item())
    assert np.isfinite(losses).all() and losses[-1] < losses[0], losses

    norms = [m for m in head.modules() if isinstance(m, torch.nn.BatchNorm3d)]
    for m in norms:
        m.momentum = 1.0
    with torch.no_grad():
        head(prob, dvals)
        head.eval()
        for seed in (1, 2):
            h_prob, h_dvals, h_gt = _volume(np.random.RandomState(seed), (0.35, 0.65))
            ev = head(torch.from_numpy(h_prob), torch.from_numpy(h_dvals))
            error = np.abs(ev["gamma"][0].numpy() - h_gt[0]).ravel()
            decomp = ev_t.uncertainty_decompositions(ev["nu"], ev["alpha"], ev["beta"])
            positive = error > np.median(error)
            aucs = {k: _roc_auc(decomp[k][0].numpy().ravel(), positive)
                    for k in ("aleatoric_1", "epistemic_1")}
            assert max(aucs.values()) > 0.7, (seed, aucs)

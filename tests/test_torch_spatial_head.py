"""The evidential head split over the spatial mesh axis
(``EvidentialHead.forward(..., mesh)``, ``models/evidential.py``) on two
gloo CPU ranks, against the JAX package's ``EvidentialHead`` on the whole
map with the same weights.

The head is ``utils/synthetic.py:seeded_head`` at maxdisp 8 (the JAX init,
its BatchNorm randomised), crossed to JAX by its converter; the input a
seeded probability volume of D=8 hypotheses at 32x16.  Rank ``s`` takes
rows ``[16 s, 16 s + 16)`` and runs the head on them in eval mode and in
train mode (BatchNorm statistics over both ranks), and backpropagates
``loss_emvsnet`` on its rows of the labels (its share over the whole
map's valid count); JAX applies its head on the whole map and takes the
gradient of the whole map's loss.  flax takes its train-mode variance in
two passes here, as torch does (the one-pass form cancels on the head's
first volumes, ``test_torch_evidential_train.py``).

Bars: the outputs on each rank's rows at ``tests/test_evidential.py:63-68``'s
(gamma 2e-3; nu, alpha and beta 1e-3; ``prob_combine`` 1e-4); the input's
gradient on each rank's rows and each parameter's gradient, summed over
the ranks, within 2e-4 of max(max|g|, 1e-3) (the training bar of
``tests/test_train.py:246-249``); every updated BatchNorm statistic within
1e-5 of max(max|s|, 1e-3), and equal on both ranks.  On the CPU the split
is not bit for bit with the port's head on the whole map: a slab's 3D
convolutions and the half-height volume's separable resize sum in another
order (gamma ~1e-4 apart at depths ~440).

No rank gathers the volume: every all-gather a rank issues in the head
(``parallel/spatial.py:_all_gather``, probed) carries at most 2 rows of
its tensor, fewer than the 4 of a slab at the head's quarter height, and
no rank calls ``dist.gather``.  At this size a halo of 2 rows of 32
channels holds more bytes than a slab of the 8-hypothesis volume, so the
probe counts rows, not bytes.
"""

import json
import sys
import textwrap

import flax.linen.normalization as normalization
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aa_rmvsnet_tpu.models import evidential as ev_j
from aa_rmvsnet_tpu.models.convert import convert_evidential_state_dict
from aa_rmvsnet_tpu_torch.models import evidential_params_from_jax
from aa_rmvsnet_tpu_torch.utils.synthetic import seeded_head

from test_torch_parallel import _free_port, _start_ranks

H, W, D, MAXDISP, S = 32, 16, 8, 8, 2
HEAD_SEED = 3
HEAD_BARS = {"gamma": 2e-3, "nu": 1e-3, "alpha": 1e-3, "beta": 1e-3, "prob_combine": 1e-4}
MODES = ("eval", "train")


def head_inputs() -> tuple:
    """The probability volume ``(1, D, H, W)``, the depth values, and the
    loss's labels ``(1, H, W)``, from a seed."""
    rng = np.random.RandomState(6)
    logits = (2.0 * rng.randn(1, D, H, W)).astype(np.float32)
    prob = np.exp(logits) / np.exp(logits).sum(1, keepdims=True)
    dvals = np.linspace(425.0, 425.0 + 5.0 * (D - 1), D, dtype=np.float32)[None]
    gt = rng.uniform(425.0, 425.0 + 5.0 * (D - 1), (1, H, W)).astype(np.float32)
    mask = (rng.rand(1, H, W) > 0.2).astype(np.float32)
    return prob, dvals, gt, mask


# One rank of two under make_mesh(spatial=2): the head on its rows in eval
# and in train mode, forward and backward, with every all-gather's rows and
# every gather recorded; results to a torch.save file.
WORKER = textwrap.dedent("""
    import json, sys
    import numpy as np, torch
    torch.set_num_threads(1)
    a = json.loads(sys.argv[1])
    from aa_rmvsnet_tpu_torch.models.evidential import batch_statistics_over, loss_emvsnet
    from aa_rmvsnet_tpu_torch.parallel import initialize_distributed, make_mesh, spatial
    from aa_rmvsnet_tpu_torch.utils.synthetic import seeded_head

    initialize_distributed(f"localhost:{a['port']}", 2, a["rank"], backend="gloo")
    mesh = make_mesh(spatial=2, device="cpu")
    s = mesh.coord("spatial")
    data = np.load(a["inputs"])
    prob, dvals, gt, mask = (torch.from_numpy(data[k]) for k in ("prob", "dvals", "gt", "mask"))
    h = prob.shape[-2] // 2
    rows = lambda t: t[..., s * h:(s + 1) * h, :]
    sent, gathers = [], [0]
    all_gather, gather = spatial._all_gather, spatial.dist.gather

    def probed_all_gather(t, group):
        sent.append(tuple(t.shape))
        return all_gather(t, group)

    def probed_gather(*args, **kwargs):
        gathers[0] += 1
        return gather(*args, **kwargs)

    spatial._all_gather, spatial.dist.gather = probed_all_gather, probed_gather
    out = {}
    for mode in a["modes"]:
        head = seeded_head(a["seed"], a["maxdisp"]).train(mode == "train")
        x = rows(prob).clone().requires_grad_()
        with batch_statistics_over(head, (mesh.spatial_group,)):
            ev = head(x, dvals, mesh)
        loss_emvsnet(ev["gamma"], ev["nu"], ev["alpha"], ev["beta"], rows(gt), rows(mask),
                     rows_group=mesh.spatial_group).backward()
        out[mode] = {"outputs": {k: v.detach() for k, v in ev.items()}, "input_grad": x.grad,
                     "param_grads": {k: p.grad for k, p in head.named_parameters()},
                     "state": head.state_dict()}
    out["sent"], out["gathers"] = sent, gathers[0]
    torch.save(out, a["out"])
    torch.distributed.destroy_process_group()
""")


def _jax_heads(variables: dict) -> dict:
    """JAX's head on the whole map in each mode, in one jitted program:
    outputs, the gradients of the whole map's ``loss_emvsnet`` in the input
    and the parameters (on the port's names), and the updated BatchNorm
    statistics in train mode."""
    prob, dvals, gt, mask = (jnp.asarray(t) for t in head_inputs())
    head = ev_j.EvidentialHead(maxdisp=MAXDISP)

    def loss(params, x, train):
        ev, stats = head.apply({"params": params, "batch_stats": variables["batch_stats"]}, x,
                               dvals, train=train, mutable=["batch_stats"] if train else [])
        value = ev_j.loss_emvsnet(ev["gamma"], ev["nu"], ev["alpha"], ev["beta"], gt, mask)
        return value, (ev, stats.get("batch_stats", variables["batch_stats"]))

    def both(params, x):
        return [jax.value_and_grad(loss, argnums=(0, 1), has_aux=True)(params, x, mode == "train")
                for mode in MODES]

    want = {}
    for mode, ((_, (ev, stats)), (g_params, g_input)) in zip(
            MODES, jax.jit(both)(variables["params"], prob)):
        tree = jax.tree.map(np.asarray, {"params": g_params, "batch_stats": stats})
        want[mode] = {"outputs": {k: np.asarray(v) for k, v in ev.items()},
                      "input_grad": np.asarray(g_input),
                      "tensors": {k: v.numpy()
                                  for k, v in evidential_params_from_jax(tree).items()}}
    return want


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The two ranks, started first; then JAX's head in both modes."""
    root = tmp_path_factory.mktemp("spatial_head")
    np.savez(root / "inputs.npz", **dict(zip(("prob", "dvals", "gt", "mask"), head_inputs())))
    port, argvs, outs = _free_port(), [], []
    for rank in range(S):
        out = str(root / f"rank{rank}.pt")
        args = dict(port=port, rank=rank, out=out, inputs=str(root / "inputs.npz"),
                    seed=HEAD_SEED, maxdisp=MAXDISP, modes=MODES)
        argvs.append([sys.executable, "-c", WORKER, json.dumps(args)])
        outs.append(out)
    wait = _start_ranks(argvs)
    state = seeded_head(HEAD_SEED, MAXDISP).state_dict()
    variables = convert_evidential_state_dict({k: v.numpy() for k, v in state.items()})
    with pytest.MonkeyPatch.context() as patch:
        fast = normalization._compute_stats
        patch.setattr(normalization, "_compute_stats",
                      lambda *a, **k: fast(*a, **{**k, "use_fast_variance": False}))
        want = _jax_heads(variables)
    wait()
    return [torch.load(out, weights_only=False) for out in outs], want


def _rows(a: np.ndarray, s: int) -> np.ndarray:
    h = a.shape[-2] // S
    return a[..., s * h:(s + 1) * h, :]


@pytest.mark.parametrize("mode", MODES)
def test_split_head_matches_jax(runs, mode):
    """Each rank's outputs and input gradient on its rows, the parameter
    gradients summed over the ranks and the updated BatchNorm statistics
    (equal on both ranks) against JAX's head on the whole map."""
    ranks, want = runs
    ref = want[mode]
    for s, r in enumerate(ranks):
        got = r[mode]
        assert got["outputs"].keys() == ref["outputs"].keys()
        for key, bar in HEAD_BARS.items():
            np.testing.assert_allclose(got["outputs"][key].numpy(), _rows(ref["outputs"][key], s),
                                       atol=bar, err_msg=f"rank {s} {key}")
        w = ref["input_grad"]
        scale = max(np.abs(w).max(), 1e-3)
        np.testing.assert_allclose(got["input_grad"].numpy() / scale, _rows(w, s) / scale,
                                   atol=2e-4, err_msg=f"rank {s} input gradient")
    names = ranks[0][mode]["param_grads"].keys()
    assert len(names) > 100
    for name in names:
        w = ref["tensors"][name]
        summed = sum(r[mode]["param_grads"][name] for r in ranks).numpy()
        scale = max(np.abs(w).max(), 1e-3)
        np.testing.assert_allclose(summed / scale, w / scale, atol=2e-4, err_msg=name)
    stats = [k for k in ranks[0][mode]["state"] if k.endswith(("running_mean", "running_var"))]
    assert len(stats) == 72
    for name in stats:
        assert torch.equal(ranks[0][mode]["state"][name], ranks[1][mode]["state"][name]), name
        w = ref["tensors"][name]
        scale = max(np.abs(w).max(), 1e-3)
        np.testing.assert_allclose(ranks[0][mode]["state"][name].numpy() / scale, w / scale,
                                   atol=1e-5, err_msg=name)


def test_split_head_gathers_no_volume(runs):
    """Every all-gather of the head carries a halo of at most 2 rows, fewer
    than a slab holds at the head's quarter height (4); no gather."""
    ranks, _ = runs
    for r in ranks:
        assert r["gathers"] == 0
        rows = {shape[-2] for shape in r["sent"]}
        assert r["sent"] and max(rows) <= 2 < H // S // 4, rows

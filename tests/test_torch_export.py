"""``torch.export`` of the port (``utils/export.py``) against eager and the
JAX package's ``jax.export`` (``aa_rmvsnet_tpu/utils/export.py``), on the
CPU, at ``tests/test_export.py``'s shapes.

The weights are one draw crossed to JAX through its own
``convert_state_dict`` / ``convert_evidential_state_dict``: the port's
JAX init with the deformable convs' offset and modulation kernels
replaced by seeded noise (sigma 0.1, as ``test_torch_models.jax_params``
does; at zero they give exactly-zero offsets), and a head with random
BatchNorm statistics.  Bars: the exported program equals eager bit for bit
(the same aten ops in the same order); against JAX's exported forward the
fp32 parity bars of ``tests/test_torch_models.py`` (depth 1e-3, a pixel
excused only on a near-tie, where the cost volume's top two values lie
within 1e-4; confidence 1e-5); the head's gamma, nu and alpha at
``tests/test_export.py``'s rtol and atol 1e-5, and beta at the head's
parity bar, atol 1e-3 (``tests/test_torch_evidential.py``): beta adds
``la * (u_k - u)^2`` over depths near 500, whose differences cancel in
fp32, so the two frameworks' eager heads already differ by ~5e-5 of beta
(1.3e-4 on beta ~3 here, against 2.5e-7 of gamma), export or not.  The
gate kernel is one node of the graph, the custom op
``aa_rmvsnet_torch::lstm_gates``, which runs its plain version here; its
CUDA implementation is checked on the card
(``tests/test_torch_cuda.py::test_gate_op_launches_the_kernel``).
The forward's save and load are checked on the card (``chip_smoke.py``
phase 8), where they take seconds; here they take ~25 s, so the CPU checks
the round trip on the head.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import export as jax_export

from aa_rmvsnet_tpu.models.convert import convert_evidential_state_dict, convert_state_dict
from aa_rmvsnet_tpu.utils import export as export_j
from aa_rmvsnet_tpu_torch.models import (
    AARMVSNetCore,
    EvidentialHead,
    SweepConfig,
    evidential_apply,
    forward,
)
from aa_rmvsnet_tpu_torch.ops import gates
from aa_rmvsnet_tpu_torch.utils import export

from test_models import _random_scene

torch.set_num_threads(2)

SHAPE, D, BLOCK = (1, 3, 16, 16, 3), 4, 2  # tests/test_export.py's forward
HEAD_SHAPE, MAXDISP = (1, 8, 16, 16), 8  # and its head
#: The head's outputs against JAX's: (rtol, atol).
HEAD_BARS = {"gamma": (1e-5, 1e-5), "nu": (1e-5, 1e-5), "alpha": (1e-5, 1e-5),
             "beta": (0.0, 1e-3)}


def _numpy_state(module):
    return {k: v.numpy() for k, v in module.state_dict().items()}


@pytest.fixture(scope="module")
def model():
    net = AARMVSNetCore(generator=torch.Generator().manual_seed(0)).eval()
    rng = np.random.RandomState(100)
    for name, param in net.named_parameters():
        if ".p_conv." in name or ".m_conv." in name:
            param.data = torch.from_numpy((0.1 * rng.randn(*param.shape)).astype(np.float32))
    return net


@pytest.fixture(scope="module")
def scene():
    _, V, H, W, _ = SHAPE
    imgs, proj, depths = _random_scene(V=V, H=H, W=W, D=D, seed=4)
    return imgs, proj, depths


@pytest.fixture(scope="module")
def exported(model, scene):
    """The port's exported forward, its outputs, and eager's with the cost
    volume."""
    data, program = export.export_forward(model, SHAPE, D, BLOCK, device="cpu")
    assert len(data) > 0
    args = [torch.from_numpy(a) for a in scene]
    with torch.no_grad():
        out = program.module()(*args)
        eager = forward(model, *args, SweepConfig(depth_block=BLOCK, collect_volume=True))
    return program, out, eager


def test_exported_forward_equals_eager(exported):
    _, loaded, eager = exported
    assert loaded.keys() == {"depth", "photometric_confidence"}
    for key, value in loaded.items():
        assert value.shape == (1, 16, 16)
        assert torch.equal(value, eager[key]), key


def test_graph_holds_the_gate_op(exported):
    """5 x D nodes of the custom op and none of the plain version's tanh."""
    program, _, _ = exported
    targets = [n.target for n in program.graph.nodes if n.op == "call_function"]
    assert sum(t is torch.ops.aa_rmvsnet_torch.lstm_gates.default for t in targets) == 5 * D
    assert not any("tanh" in str(t) for t in targets)


def test_exported_forward_matches_jax_export(exported, model, scene, tmp_path):
    """JAX's exported forward, saved and called through its
    ``load_and_call``, on the same weights and inputs."""
    _, loaded, eager = exported
    params = convert_state_dict(_numpy_state(model))
    path = str(tmp_path / "forward.stablehlo")
    assert export_j.save_exported(path, params, input_shape=SHAPE, num_depth=D,
                                  depth_block=BLOCK) > 0
    out_j = export_j.load_and_call(path, params, *map(jnp.asarray, scene))
    np.testing.assert_allclose(loaded["photometric_confidence"].numpy(),
                               np.asarray(out_j["photometric_confidence"]), atol=1e-5)
    top2 = np.sort(eager["cost_volume"].numpy(), axis=1)[:, -2:]
    near_tie = (top2[:, 1] - top2[:, 0]) < 1e-4
    off = np.abs(loaded["depth"].numpy() - np.asarray(out_j["depth"])) > 1e-3
    assert not np.any(off & ~near_tie), int(np.sum(off & ~near_tie))


def test_export_evidential_matches_jax_export(tmp_path):
    """The port's exported head (written with ``save_exported_evidential``,
    loaded with ``load_and_call``) against eager, bit for bit, and against
    JAX's exported head on the same variables."""
    head = EvidentialHead(MAXDISP, generator=torch.Generator().manual_seed(1)).eval()
    rng = np.random.RandomState(1)
    for name, buf in head.named_buffers():
        if name.endswith(("running_mean", "running_var")):
            buf.copy_(torch.from_numpy(rng.uniform(0.5, 1.5, buf.shape).astype(np.float32)))
    vol = rng.randn(*HEAD_SHAPE).astype(np.float32)
    depths = np.linspace(400, 600, MAXDISP, dtype=np.float32)[None]
    path = str(tmp_path / "head.pt2")
    assert export.save_exported_evidential(path, head, input_shape=HEAD_SHAPE,
                                           maxdisp=MAXDISP, device="cpu") > 0
    got = export.load_and_call(path, head, torch.from_numpy(vol), torch.from_numpy(depths))
    with torch.no_grad():
        eager = evidential_apply(head, torch.from_numpy(vol), torch.from_numpy(depths))
    for key in eager:
        assert torch.equal(got[key], eager[key]), key

    variables = convert_evidential_state_dict(_numpy_state(head))
    data, _ = export_j.export_evidential(variables, input_shape=HEAD_SHAPE, maxdisp=MAXDISP)
    want = jax_export.deserialize(data).call(variables, jnp.asarray(vol), jnp.asarray(depths))
    for key, (rtol, atol) in HEAD_BARS.items():
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]), rtol=rtol,
                                   atol=atol, err_msg=key)


def test_export_refuses_a_head_of_another_maxdisp():
    with pytest.raises(ValueError, match="maxdisp is 8, not 32"):
        export.export_evidential(EvidentialHead(8), device="cpu")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_gate_op_is_the_plain_version_on_the_cpu(dtype):
    """The op's schema, fake implementation and autograd formula pass
    ``torch.library.opcheck``; on CPU tensors it gives the plain version bit
    for bit, and its gradients are ``LSTMGates``' (the eager autograd
    path), bit for bit."""
    rng = np.random.RandomState(0)
    z = torch.from_numpy(rng.randn(2, 32, 5, 7).astype(np.float32)).to(dtype)
    c = torch.from_numpy(rng.randn(2, 8, 5, 7).astype(np.float32)).to(dtype)
    torch.library.opcheck(gates.lstm_gates_op, (z, c))
    torch.library.opcheck(gates.lstm_gates_backward_op, (z, c, c.clone(), c.clone()))
    for got, want in zip(torch.ops.aa_rmvsnet_torch.lstm_gates(z, c),
                         gates.lstm_gates_reference(z, c)):
        assert torch.equal(got, want)

    grads = []
    for fn in (gates.lstm_gates_op, gates.LSTMGates.apply):
        zg, cg = z.clone().requires_grad_(), c.clone().requires_grad_()
        h, c_next = fn(zg, cg)
        (h.float().sum() + (c_next.float() ** 2).sum()).backward()
        grads.append((zg.grad, cg.grad))
    for got, want in zip(*grads):
        assert torch.equal(got, want)

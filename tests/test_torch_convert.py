"""Orbax checkpoints in the port, read without orbax (``models/convert.py:
read_orbax``, tensorstore alone), and ``cli convert`` from orbax to a torch
``.ckpt``, against the JAX package's own orbax restore and ``cmd_convert``.

Every comparison is bit for bit: the conversions only transpose and flip.
The JAX side (orbax, ``init_params``, ``save_state``, ``cmd_convert``) runs
here on the CPU; the port side imports no JAX (checked in a subprocess).
"""

import os
import subprocess
import sys
import textwrap
from types import SimpleNamespace

import jax
import numpy as np
import optax
import pytest
import torch

from aa_rmvsnet_tpu import cli as cli_j
from aa_rmvsnet_tpu.pipeline.checkpoint import make_manager, save_state
from aa_rmvsnet_tpu_torch import cli
from aa_rmvsnet_tpu_torch.models import (
    AARMVSNetCore,
    EvidentialHead,
    evidential_params_from_jax,
    load_evidential_checkpoint,
    load_reference_checkpoint,
    params_from_jax,
    read_orbax,
)
from aa_rmvsnet_tpu_torch.models import convert

from scenefix import make_plane_scene
from test_torch_models import jax_params
import test_pipeline

torch.set_num_threads(2)

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TRAINED_HEAD = os.path.join(REPO_ROOT, "checkpoints", "evidential_head")


def _leaves(tree, prefix=()):
    if isinstance(tree, dict):
        for key, sub in tree.items():
            yield from _leaves(sub, prefix + (str(key),))
    else:
        yield prefix, np.asarray(tree)


def _assert_states_equal(got: dict, want: dict):
    assert got.keys() == want.keys()
    for key in want:
        assert got[key].dtype == want[key].dtype, key
        assert torch.equal(got[key], want[key]), key


@pytest.fixture(scope="module")
def core_tree():
    """A JAX core tree from ``init_params`` under ``jit`` (deform offsets
    perturbed), numpy leaves."""
    return jax_params(seed=0, size=16)


@pytest.fixture(scope="module")
def train_logdir(tmp_path_factory, core_tree):
    """A JAX ``cli train`` logdir: steps 1 (all weights zero) and 2 (the
    tree) written by ``pipeline/checkpoint.py:save_state`` with Adam
    states; the highest step is the tree."""
    logdir = str(tmp_path_factory.mktemp("jax_train"))
    manager = make_manager(logdir)
    tx = optax.adam(1e-3)
    zeros = jax.tree.map(np.zeros_like, core_tree)
    for step, params in ((1, zeros), (2, core_tree)):
        save_state(manager, step, params, tx.init(params))
    manager.wait_until_finished()
    return logdir


@pytest.fixture(scope="module")
def head_ckpt(tmp_path_factory):
    """``cli convert --evidential`` of the trained head."""
    path = str(tmp_path_factory.mktemp("head") / "head.ckpt")
    cli.main(["convert", "--ckpt", TRAINED_HEAD, "--out", path, "--evidential"])
    return path


def test_read_orbax_equals_orbax_restore():
    """All 185 arrays of the trained head, as orbax restores them, and the
    head's state dict converted from each, bit for bit."""
    import orbax.checkpoint as ocp

    want = jax.tree.map(np.asarray, ocp.StandardCheckpointer().restore(TRAINED_HEAD))
    got = read_orbax(TRAINED_HEAD)
    got_leaves, want_leaves = dict(_leaves(got)), dict(_leaves(want))
    assert len(got_leaves) == 185 and got_leaves.keys() == want_leaves.keys()
    for key, arr in want_leaves.items():
        assert got_leaves[key].dtype == arr.dtype and np.array_equal(got_leaves[key], arr), key
    assert convert.orbax_value_count(got) == 4_311_328
    _assert_states_equal(evidential_params_from_jax(got), evidential_params_from_jax(want))


@pytest.mark.parametrize("where", ["logdir", "step", "params"])
def test_cli_convert_reads_a_jax_train_checkpoint(train_logdir, core_tree, tmp_path, where,
                                                  capsys):
    """JAX ``cli train``'s orbax layout (``<logdir>/<step>/params``): the
    logdir takes its highest step; the port's file loads strictly and is
    ``params_from_jax`` of the tree."""
    path = {"logdir": train_logdir, "step": os.path.join(train_logdir, "2"),
            "params": os.path.join(train_logdir, "2", "params")}[where]
    out = str(tmp_path / "core.ckpt")
    cli.main(["convert", "--ckpt", path, "--out", out])
    assert "(187203 params)" in capsys.readouterr().out
    model = load_reference_checkpoint(AARMVSNetCore(), out)
    _assert_states_equal(model.state_dict(), params_from_jax(core_tree))
    _assert_states_equal(torch.load(out, weights_only=True)["model"], params_from_jax(core_tree))


def test_loaders_read_a_jax_evidential_train_step(tmp_path, core_tree):
    """A JAX ``cli train --evidential`` logdir holds core, head and
    statistics in one ``params`` item (``make_evidential_state``): the core
    loader takes the core, the head loader the head, and ``cli convert``
    either."""
    from aa_rmvsnet_tpu.pipeline.train import make_evidential_state

    head_vars = read_orbax(TRAINED_HEAD)
    state = make_evidential_state(core_tree, head_vars)
    trainable = {"core": state["core"], "head": state["head"]}
    manager = make_manager(str(tmp_path))
    save_state(manager, 5, state, optax.adam(1e-3).init(trainable))
    manager.wait_until_finished()
    core = load_reference_checkpoint(AARMVSNetCore(), str(tmp_path))
    _assert_states_equal(core.state_dict(), params_from_jax(core_tree))
    head = load_evidential_checkpoint(EvidentialHead(), str(tmp_path))
    _assert_states_equal(head.state_dict(), evidential_params_from_jax(head_vars))
    cli.main(["convert", "--ckpt", str(tmp_path), "--out", str(tmp_path / "h.ckpt"),
              "--evidential"])
    load_evidential_checkpoint(EvidentialHead(), str(tmp_path / "h.ckpt"))


def _port_head_state(seed: int) -> dict:
    """A port head's state with random BatchNorm statistics (so that the
    statistics' conversion is exercised)."""
    head = EvidentialHead(8, generator=torch.Generator().manual_seed(seed))
    rng = np.random.RandomState(seed)
    for name, buf in head.named_buffers():
        if name.endswith(("running_mean", "running_var")):
            buf.copy_(torch.from_numpy(rng.uniform(0.5, 1.5, buf.shape).astype(np.float32)))
    return head.state_dict()


@pytest.mark.parametrize("evidential", [False, True], ids=["core", "head"])
def test_round_trip_through_jax_convert(tmp_path, evidential):
    """Port state -> ``.ckpt`` -> JAX ``cmd_convert`` -> orbax -> the port's
    ``cli convert`` -> the same state, bit for bit."""
    if evidential:
        state = _port_head_state(1)
        payload = {"evidential." + k: v for k, v in state.items()}
    else:
        state = AARMVSNetCore(generator=torch.Generator().manual_seed(1)).state_dict()
        payload = state
    torch.save({"model": payload}, tmp_path / "port.ckpt")
    cli_j.cmd_convert(SimpleNamespace(ckpt=str(tmp_path / "port.ckpt"),
                                      out=str(tmp_path / "orbax"), evidential=evidential))
    flags = ["--evidential"] if evidential else []
    cli.main(["convert", "--ckpt", str(tmp_path / "orbax"), "--out",
              str(tmp_path / "back.ckpt"), *flags])
    back = torch.load(tmp_path / "back.ckpt", weights_only=True)["model"]
    _assert_states_equal(back, payload)


def _capture_eval(monkeypatch, tmp_path, flags):
    """``cli eval`` on a small plane scene up to ``run_inference``, which
    records the model and head it is given instead of running."""
    from aa_rmvsnet_tpu_torch.pipeline import infer

    make_plane_scene(str(tmp_path), H=32, W=32, num_views=3)
    (tmp_path / "list.txt").write_text("scan1\n")
    seen = {}

    def record(model, dataset, config, progress=True):
        seen["model"], seen["head"] = model, config.evidential
        return {"count": 0, "maps_per_s": 0.0}

    monkeypatch.setattr(infer, "run_inference", record)
    cli.main(["eval", "--device", "cpu", "--testpath", str(tmp_path), "--testlist",
              str(tmp_path / "list.txt"), "--preset", "dtu_eval_smoke", *flags])
    return seen


def _capture_train(monkeypatch, tmp_path, flags):
    """``cli train`` on the synthetic DTU tree up to ``run_training``."""
    from aa_rmvsnet_tpu_torch.pipeline import train

    listfile = test_pipeline.TestDTUTrainDataset._make_dtu(None, str(tmp_path))
    seen = {}

    def record(model, dataset, config, val_dataset=None, logger=None, head=None):
        seen["model"], seen["head"] = model, head
        return {"start_step": 0, "step": 0}

    monkeypatch.setattr(train, "run_training", record)
    cli.main(["train", "--device", "cpu", "--trainpath", str(tmp_path), "--trainlist",
              listfile, "--logdir", str(tmp_path / "log"), "--no_tensorboard", *flags])
    return seen


@pytest.mark.parametrize("command,flag", [
    ("eval", "--loadckpt"),
    ("train", "--loadckpt"),
    ("eval", "--evidential_ckpt"),
    ("train", "--head_ckpt"),
])
def test_cli_flags_read_orbax(monkeypatch, tmp_path, train_logdir, core_tree, head_ckpt,
                              command, flag):
    """Each checkpoint flag takes an orbax directory and loads, strictly,
    the tensors it takes from the converted ``.ckpt`` (so ``cli eval
    --evidential_ckpt checkpoints/evidential_head`` and ``--evidential_ckpt
    head.ckpt`` give the same head)."""
    capture = _capture_eval if command == "eval" else _capture_train
    what = "model" if flag == "--loadckpt" else "head"
    if what == "model":
        orbax_path, ckpt = train_logdir, str(tmp_path / "core.ckpt")
        cli.main(["convert", "--ckpt", orbax_path, "--out", ckpt])
        other = []
    else:
        orbax_path, ckpt = TRAINED_HEAD, head_ckpt
        core = str(tmp_path / "core.ckpt")
        torch.save({"model": AARMVSNetCore().state_dict()}, core)
        other = ["--loadckpt", core] if command == "eval" else ["--evidential"]
    states = [capture(monkeypatch, tmp_path / f"run{i}", [flag, source, *other])[what]
              .state_dict() for i, source in enumerate((orbax_path, ckpt))]
    _assert_states_equal(states[0], states[1])
    if what == "model":
        _assert_states_equal(states[0], params_from_jax(core_tree))
    else:
        trained = convert.head_state_from_orbax(read_orbax(TRAINED_HEAD))
        _assert_states_equal(states[0], trained)


@pytest.mark.parametrize("command", ["eval", "train"])
def test_loadckpt_refuses_a_directory_by_name(monkeypatch, tmp_path, command):
    """A directory that is no orbax checkpoint is refused under the flag's
    name (``torch.load`` used to fail on it with its own error)."""
    capture = _capture_eval if command == "eval" else _capture_train
    (tmp_path / "empty").mkdir()
    with pytest.raises(SystemExit, match="--loadckpt .*neither a torch .ckpt nor an orbax"):
        capture(monkeypatch, tmp_path / "run", ["--loadckpt", str(tmp_path / "empty")])


def test_orbax_without_tensorstore_is_refused_by_name(monkeypatch, tmp_path):
    monkeypatch.setitem(sys.modules, "tensorstore", None)  # import fails
    with pytest.raises(SystemExit, match="--evidential_ckpt .*needs the tensorstore package"):
        cli.main(["eval", "--device", "cpu", "--testpath", str(tmp_path), "--testlist", "x",
                  "--loadckpt", "x", "--evidential_ckpt", TRAINED_HEAD])
    with pytest.raises(SystemExit, match="--ckpt .*needs the tensorstore package"):
        cli.main(["convert", "--ckpt", TRAINED_HEAD, "--out", str(tmp_path / "x.ckpt")])


def test_cli_convert_imports_no_jax(tmp_path):
    """``cli convert`` in a fresh process: the file is written, and no
    module of JAX, flax, orbax or the JAX package is loaded."""
    out = str(tmp_path / "head.ckpt")
    code = textwrap.dedent(f"""
        import sys
        from aa_rmvsnet_tpu_torch import cli
        cli.main(["convert", "--ckpt", {TRAINED_HEAD!r}, "--out", {out!r}, "--evidential"])
        print("BAD", sorted(n for n in sys.modules if n.split(".")[0] == "aa_rmvsnet_tpu"
                            or n.split(".")[0].startswith(("jax", "flax", "orbax"))))
    """)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    run = subprocess.run([sys.executable, "-c", code], cwd=REPO_ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert run.returncode == 0, run.stderr[-3000:]
    assert "BAD []" in run.stdout and "(4311328 params)" in run.stdout, run.stdout
    load_evidential_checkpoint(EvidentialHead(), out)

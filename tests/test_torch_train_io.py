"""Training I/O of the port: unfolded ``.weights`` (io/weights.py
``load_darknet_weights(fold=False)``, ``allow_partial``, connected layers
with batch norm) and checkpoints (io/checkpoint.py), against the JAX
package's readers and writers. Everything here is exact: the same float32
values move, transposed or not."""

import json

import numpy as np
import pytest
import torch

import jax

from yolo_tensorflow_tpu.io import checkpoint as JCk
from yolo_tensorflow_tpu.io import weights as JW
from yolo_tensorflow_tpu.train import loop as JL
from yolo_tensorflow_tpu_torch.io import checkpoint as TCk
from yolo_tensorflow_tpu_torch.io import weights as TW
from yolo_tensorflow_tpu_torch.models import engine as TE
from yolo_tensorflow_tpu_torch.train import loop as TL

from torch_parity import images, jax_model, model, to_jax, write_weights

SIZE = 64


def _equal_trees(got, want):
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].keys() == want[k].keys(), k
        for n in want[k]:
            np.testing.assert_array_equal(np.asarray(got[k][n]),
                                          np.asarray(want[k][n]),
                                          err_msg=f"{k}/{n}")


@pytest.mark.parametrize("name", ["narrow-v2", "narrow-v1-train",
                                  "narrow-cls"])
def test_unfolded_weights_round_trip_and_match_jax(name, tmp_path):
    """save_darknet_weights -> load_darknet_weights(fold=False) gives back
    the parameters and running statistics (connected + BN included), equal
    to the JAX reader's in the port's layout."""
    _, specs = model(name, SIZE)
    _, jspecs = jax_model(name, SIZE)
    path = tmp_path / "m.weights"
    params, stats = write_weights(specs, SIZE, path)
    got, got_stats, header = TW.load_darknet_weights(specs, SIZE, str(path),
                                                     fold=False)
    _equal_trees(got, params)
    _equal_trees(got_stats, stats)
    want, want_stats, want_header = JW.load_darknet_weights(
        jspecs, SIZE, str(path), fold=False)
    assert header == want_header
    _equal_trees(got, TW.params_from_jax(want))
    _equal_trees(got_stats, want_stats)
    if name == "narrow-v1-train":
        assert set(got["L007"]) == {"w", "gamma", "beta"}


def test_partial_weights_stop_at_a_layer_boundary(tmp_path):
    """allow_partial (the darknet19_448.conv.23 workflow): a file cut after
    a layer loads the layers it holds; without allow_partial, or cut inside
    a layer, it raises."""
    _, specs = model("narrow-v2", SIZE)
    _, jspecs = jax_model("narrow-v2", SIZE)
    path = tmp_path / "full.weights"
    params, stats = write_weights(specs, SIZE, path)
    JW.save_darknet_weights(jspecs, SIZE, to_jax(params), stats,
                            str(tmp_path / "cut.weights"), upto=3)
    cut = (tmp_path / "cut.weights").read_bytes()
    got, got_stats, _ = TW.load_darknet_weights(specs, SIZE, cut,
                                                fold=False,
                                                allow_partial=True)
    assert sorted(got) == ["L000", "L002"]
    _equal_trees(got, {k: params[k] for k in got})
    _equal_trees(got_stats, {k: stats[k] for k in got_stats})
    want, _, _ = JW.load_darknet_weights(jspecs, SIZE, cut, fold=False,
                                         allow_partial=True)
    assert sorted(want) == sorted(got)
    with pytest.raises(TW.WeightsFormatError, match="exhausted"):
        TW.load_darknet_weights(specs, SIZE, cut, fold=False)
    with pytest.raises(TW.WeightsFormatError, match="exhausted"):
        TW.load_darknet_weights(specs, SIZE, cut[:-8], fold=False,
                                allow_partial=True)


def test_folded_load_keeps_its_form(tmp_path):
    """fold=True (the default, serving) still returns (params, header)."""
    _, specs = model("narrow-v1-train", SIZE)
    path = tmp_path / "m.weights"
    write_weights(specs, SIZE, path)
    params, header = TW.load_darknet_weights(specs, SIZE, str(path))
    assert set(params["L007"]) == {"w", "b"} and header["minor"] == 2


def test_train_state_from_jax_carries_connected_bn():
    jcfg, jspecs = jax_model("narrow-v1-train", SIZE)
    tx = JL.make_optimizer(lambda s: 1e-3)
    js = JL.create_train_state(jcfg, tx, jax.random.PRNGKey(1),
                               input_size=SIZE, specs=jspecs)
    p, st, mom = TW.train_state_from_jax(
        jax.tree.map(np.asarray, js.params),
        jax.tree.map(np.asarray, js.batch_stats),
        jax.tree.map(np.asarray, js.opt_state[1][0].trace))
    assert p["L007"]["w"].shape == (32, 48)
    assert set(p["L007"]) == {"w", "gamma", "beta"} and "L007" in st
    assert mom["L007"]["gamma"].shape == (48,)
    np.testing.assert_array_equal(TW.params_to_jax(p)["L000"]["w"],
                                  np.asarray(js.params["L000"]["w"]))


def _trained_state(name="narrow-v1-train", adam=False, steps=2):
    cfg, specs = model(name, SIZE)
    tx = (TL.darknet_adam(lambda s: torch.tensor(1e-4), batch=2) if adam
          else TL.make_optimizer(lambda s: torch.tensor(1e-4)))
    state = TL.create_train_state(cfg, tx, device="cpu", specs=specs,
                                  input_size=SIZE, seed=4)
    step = TL.make_train_step(cfg, tx, input_size=SIZE, specs=specs)
    tr = np.zeros((2, 3, 5), np.float32)
    tr[:, 0] = (0.5, 0.5, 0.3, 0.3, 1)
    for _ in range(steps):
        state, _ = step(state, images(2, SIZE), tr)
    return cfg, specs, tx, state


def _snapshot(state):
    tree = lambda t: {k: {n: v.detach().numpy().copy() for n, v in p.items()}
                      for k, p in t.items()}
    opt = {f: (tree(v) if isinstance(v, dict) else v.numpy().copy())
           for f, v in state.opt_state._asdict().items()}
    return dict(params=tree(state.params), stats=tree(state.batch_stats),
                opt=opt, step=int(state.step),
                gen=state.generator.get_state().numpy().copy())


@pytest.mark.parametrize("adam", [False, True])
def test_checkpoint_restores_every_field(adam, tmp_path):
    """save_train_state -> restore_train_state into a fresh state gives
    back parameters, running statistics, the optimizer's buffers and count,
    the step and the generator's state; the next draw is the same."""
    cfg, specs, tx, state = _trained_state(adam=adam)
    want = _snapshot(state)
    path = TCk.save_train_state(state, str(tmp_path), 2)
    assert path.endswith("ckpt-2.npz")
    fresh = TL.create_train_state(cfg, tx, device="cpu", specs=specs,
                                  input_size=SIZE, seed=9)
    got, step = TCk.restore_train_state(fresh, str(tmp_path))
    assert step == 2
    snap = _snapshot(got)
    for key in ("params", "stats"):
        _equal_trees(snap[key], want[key])
    for f, v in want["opt"].items():
        if isinstance(v, dict):
            _equal_trees(snap["opt"][f], v)
        else:
            np.testing.assert_array_equal(snap["opt"][f], v)
    assert snap["step"] == want["step"] == 2
    np.testing.assert_array_equal(snap["gen"], want["gen"])
    assert torch.equal(torch.rand(4, generator=got.generator),
                       torch.rand(4, generator=state.generator))


def test_checkpoint_keeps_three_and_points_to_the_latest(tmp_path):
    _, _, _, state = _trained_state(steps=1)
    for step in (1, 2, 3, 4):
        TCk.save_train_state(state, str(tmp_path), step)
    files = sorted(p.name for p in tmp_path.glob("ckpt-*.npz"))
    assert files == ["ckpt-2.npz", "ckpt-3.npz", "ckpt-4.npz"]
    assert json.loads((tmp_path / "latest.json").read_text()) == {
        "step": 4, "file": "ckpt-4.npz"}
    assert TCk.checkpoint_has_field(str(tmp_path), "params")
    assert TCk.checkpoint_has_field(str(tmp_path), "generator")
    assert not TCk.checkpoint_has_field(str(tmp_path), "qat_scales")
    assert TCk.restore_train_state(state, str(tmp_path / "none")) == (None,
                                                                       0)


def test_jax_reads_a_port_checkpoint(tmp_path):
    """The TPU package's load_train_params reads the port's params and
    batch stats, in its own layout."""
    _, _, _, state = _trained_state()
    want = _snapshot(state)
    TCk.save_train_state(state, str(tmp_path), 2)
    params, stats, step = JCk.load_train_params(str(tmp_path))
    assert step == 2
    _equal_trees(params, TW.params_to_jax(want["params"]))
    _equal_trees(stats, want["stats"])
    got, got_stats, _ = TCk.load_train_params(str(tmp_path / "ckpt-2.npz"))
    _equal_trees(got, want["params"])
    _equal_trees(got_stats, want["stats"])


def test_port_reads_a_jax_checkpoint(tmp_path):
    """The port's load_train_params reads a TPU-package checkpoint, in the
    port's layout; restoring one as a port TrainState raises (its optimizer
    state is the TPU package's)."""
    jcfg, jspecs = jax_model("narrow-v2", SIZE)
    tx = JL.make_optimizer(lambda s: 1e-3)
    js = JL.create_train_state(jcfg, tx, jax.random.PRNGKey(2),
                               input_size=SIZE, specs=jspecs)
    JCk.save_train_state(js, str(tmp_path), 7)
    params, stats, step = TCk.load_train_params(str(tmp_path))
    assert step == 7
    _equal_trees(params, TW.params_from_jax(jax.tree.map(np.asarray,
                                                         js.params)))
    _equal_trees(stats, jax.tree.map(np.asarray, js.batch_stats))
    cfg, specs = model("narrow-v2", SIZE)
    template = TL.create_train_state(
        cfg, TL.make_optimizer(lambda s: torch.tensor(1e-3)), device="cpu",
        specs=specs, input_size=SIZE)
    with pytest.raises(KeyError, match="optimizer"):
        TCk.restore_train_state(template, str(tmp_path))


def test_save_params_npz_is_the_jax_interchange_format(tmp_path):
    _, specs = model("narrow-v2", SIZE)
    params, _ = TE.init_params(specs, SIZE, 0)
    TCk.save_params_npz(params, str(tmp_path / "p.npz"))
    with np.load(tmp_path / "p.npz") as data:
        np.testing.assert_array_equal(data["L000/w"],
                                      to_jax(params)["L000"]["w"])
        np.testing.assert_array_equal(data["L012/b"], params["L012"]["b"])

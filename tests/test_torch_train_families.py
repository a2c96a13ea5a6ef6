"""One train step of each model family in the port against the JAX
package's ``make_train_step``, from the state JAX's create_train_state
draws, carried across (float32, twopass BN, on the CPU): the v2 region loss
(warm-up on), the v2 ``tf`` loss, v1 (connected layers, one with batch
norm, dropout rate 0) and a darknet19-style classifier, with SGD; and with
darknet Adam. Batch 4, lr 1e-4: at batch 2 the connected layer's batch
norm over two images leaves both packages' float32 gradients 1e-4 off a
float64 evaluation, and at lr 1e-3 the first update (v1's traces reach
~100) amplifies that to 6e-3 by the second step; here both steps agree to
7e-6. JAX's step is jitted: on these narrow nets the port is as close to
it as to the eager step (7.2e-6 against 7.1e-6 for the region family,
6.2e-6 against 3.5e-6 for v1), where on yolov3-tiny's depth XLA's CPU
fusion of the twopass step puts 1e-2 of error into early gradients
(tests/test_torch_train.py), and it runs 10x faster.

Tolerances: metrics rtol 3e-5 plus atol 1e-5 (the cost is a float32 sum of
11,520 squares of deltas from two float32 forwards, measured 1.19e-5 off;
the other metrics are means of values of order 1, and v1's avg_allcat one
of raw outputs that cancel); every optimizer buffer (SGD's trace g +
decay * w, Adam's m and v, all linear or quadratic in the gradient),
updated parameter and running statistic within 1e-4 of its leaf's largest
value plus 1e-6 (test_torch_train.py's twopass LEAF_RTOL). Adam's update is
rate * sign(d) where |d| >> eps, so an element whose gradient is at the
float32 noise floor of its leaf may step either way: parameters are held
where |m| is above 1e-3 of its leaf's largest, and every step is at most
the rate in size.
"""

import functools

import numpy as np
import pytest
import torch

import jax

from yolo_tensorflow_tpu.train import loop as JL
from yolo_tensorflow_tpu_torch.io import weights as TW
from yolo_tensorflow_tpu_torch.train import loop as TL
from yolo_tensorflow_tpu_torch.train import losses as TLo

from torch_parity import images, jax_model, model, to_jax

LR, MOMENTUM, DECAY = 1e-4, 0.9, 5e-4
BATCH = 4
LEAF_RTOL, LEAF_ATOL = 1e-4, 1e-6
SIZE = 64
FAMILIES = {
    "v2-region": ("narrow-v2", {}),
    "v2-tf": ("narrow-v2", {"v2_variant": "tf"}),
    "v1": ("narrow-v1-train", {}),
    "classifier": ("narrow-cls", {}),
}


def _truths(cfg, batch, seed=2):
    rng = np.random.default_rng(seed)
    if cfg.head == 0:
        return rng.integers(0, cfg.num_classes, batch).astype(np.int32)
    tr = np.zeros((batch, 6, 5), np.float32)
    tr[:, :4, :2] = rng.uniform(0.05, 0.95, (batch, 4, 2))
    tr[:, :4, 2:4] = rng.uniform(0.05, 0.6, (batch, 4, 2))
    tr[:, :4, 4] = rng.integers(0, cfg.num_classes, (batch, 4))
    tr[:, 1, :4] = tr[:, 0, :4] + np.float32(1e-3)
    return tr


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _port_np(tree):
    return to_jax({k: {n: v.detach().float().cpu().numpy().copy()
                       for n, v in p.items()} for k, p in tree.items()})


def _assert_leaves(got, want, what, mask=None):
    assert set(got) == set(want), what
    for k in want:
        for n in want[k]:
            w = np.asarray(want[k][n], np.float32)
            err = np.abs(np.asarray(got[k][n]) - w)
            if mask is not None:
                err = err[mask[k][n]]
            tol = LEAF_RTOL * np.abs(w).max() + LEAF_ATOL
            assert err.size == 0 or err.max() <= tol, (
                f"{what} {k}/{n}: |err| {err.max():.3g} > {tol:.3g}")


def _optimizers(adam):
    if adam:
        kw = dict(b1=0.9, b2=0.999, eps=1e-7, decay=DECAY, batch=BATCH)
        return (JL.darknet_adam(lambda s: LR, **kw),
                TL.darknet_adam(lambda s: torch.tensor(LR), **kw))
    return (JL.make_optimizer(JL.darknet_lr_schedule(LR, burn_in=2),
                              momentum=MOMENTUM, weight_decay=DECAY),
            TL.make_optimizer(TL.darknet_lr_schedule(LR, burn_in=2),
                              momentum=MOMENTUM, weight_decay=DECAY))


def _buffers(opt_state, adam, port):
    """{"trace"} or {"m", "v"} in the JAX layout."""
    if port:
        if adam:
            return {"m": _port_np(opt_state.m), "v": _port_np(opt_state.v)}
        return {"trace": _port_np(opt_state.momentum)}
    if adam:
        return {"m": _np(opt_state.m), "v": _np(opt_state.v)}
    return {"trace": _np(opt_state[1][0].trace)}


@functools.lru_cache(maxsize=None)
def _run(family, adam=False, steps=2):
    name, loss_kw = FAMILIES[family]
    cfg, specs = model(name, SIZE)
    jcfg, jspecs = jax_model(name, SIZE)
    jtx, ttx = _optimizers(adam)
    js = JL.create_train_state(jcfg, jtx, jax.random.PRNGKey(0),
                               input_size=SIZE, specs=jspecs)
    p, st, _ = TW.train_state_from_jax(_np(js.params), _np(js.batch_stats))
    ts = TL.create_train_state(cfg, ttx, device="cpu", input_size=SIZE,
                               specs=specs, params=p, batch_stats=st)
    jstep = jax.jit(JL.make_train_step(jcfg, jtx, input_size=SIZE,
                                       specs=jspecs, **loss_kw))
    tstep = TL.make_train_step(cfg, ttx, input_size=SIZE, specs=specs,
                               **loss_kw)
    imgs, tr = images(BATCH, SIZE, seed=5), _truths(cfg, BATCH)
    out = []
    for _ in range(steps):
        js, jm = jstep(js, imgs, tr)
        ts, tm = tstep(ts, torch.from_numpy(imgs), torch.from_numpy(tr))
        out.append(dict(
            jax=dict(params=_np(js.params), stats=_np(js.batch_stats),
                     metrics=_np(jm), **_buffers(js.opt_state, adam, False)),
            port=dict(params=_port_np(ts.params),
                      stats={k: {n: v.numpy().copy() for n, v in d.items()}
                             for k, d in ts.batch_stats.items()},
                      metrics={k: v.detach().numpy() for k, v in tm.items()},
                      **_buffers(ts.opt_state, adam, True))))
    return out


@pytest.mark.parametrize("family", list(FAMILIES))
def test_step_metrics_match_jax(family):
    for k, r in enumerate(_run(family)):
        jm, tm = r["jax"]["metrics"], r["port"]["metrics"]
        assert set(tm) == set(jm)
        for key in jm:
            np.testing.assert_allclose(tm[key], jm[key], rtol=3e-5,
                                       atol=1e-5, err_msg=f"{key} step {k}")


@pytest.mark.parametrize("what", ["trace", "params", "stats"])
@pytest.mark.parametrize("family", list(FAMILIES))
def test_step_state_matches_jax(family, what):
    for k, r in enumerate(_run(family)):
        _assert_leaves(r["port"][what], r["jax"][what],
                       f"{what} after step {k + 1}")


@pytest.mark.parametrize("family", ["v2-region", "v1"])
def test_darknet_adam_step_matches_jax(family):
    (r,) = _run(family, adam=True, steps=1)
    j, t = r["jax"], r["port"]
    for what in ("m", "v", "stats"):
        _assert_leaves(t[what], j[what], what)
    for key in ("cost", "avg_iou", "count"):
        np.testing.assert_allclose(t["metrics"][key], j["metrics"][key],
                                   rtol=3e-5, atol=1e-5)
    m = j["m"]
    robust = {k: {n: np.abs(v) > 1e-3 * np.abs(v).max()
                  for n, v in p.items()} for k, p in m.items()}
    _assert_leaves(t["params"], j["params"], "params", mask=robust)
    p0, _ = _state0(family)
    for k in p0:
        for n in p0[k]:
            step = np.abs(t["params"][k][n] - p0[k][n])
            assert step.max() <= LR * (1 + 1e-3), (k, n, step.max())


@functools.lru_cache(maxsize=None)
def _state0(family):
    name, _ = FAMILIES[family]
    jcfg, jspecs = jax_model(name, SIZE)
    js = JL.create_train_state(jcfg, _optimizers(True)[0],
                               jax.random.PRNGKey(0), input_size=SIZE,
                               specs=jspecs)
    return _np(js.params), _np(js.batch_stats)


def test_darknet_adam_update_matches_jax(rng):
    """Three updates on the same gradients: decay on every tensor, the
    moments, bias correction from t = 1 and the undivided rate."""
    params = {"L000": {"w": rng.normal(0, 1, (4, 3, 3, 3)),
                       "gamma": rng.normal(1, 0.1, 4),
                       "beta": rng.normal(0, 0.1, 4)},
              "L001": {"w": rng.normal(0, 1, (6, 4)),
                       "b": rng.normal(0, 1, 4)}}
    params = jax.tree.map(lambda a: np.asarray(a, np.float32), params)
    opts = TL.NetTrainOptions(adam=True, learning_rate=0.01, decay=1e-3,
                              batch=8, B1=0.8, B2=0.99, eps=1e-6)
    jtx = JL.optimizer_from_net(JL.NetTrainOptions(**vars(opts)))
    ttx = TL.optimizer_from_net(opts)
    assert isinstance(ttx, TL.DarknetAdam) and ttx.batch == 8
    jp, js = params, jtx.init(params)
    tp = {k: {n: torch.tensor(v) for n, v in p.items()}
          for k, p in params.items()}
    ts = ttx.init(tp)
    for i in range(3):
        g = jax.tree.map(lambda a: rng.normal(0, 1, a.shape)
                         .astype(np.float32), params)
        upd, js = jtx.update(g, js, jp)
        jp = jax.tree.map(lambda a, u: a + u, jp, upd)
        ts = ttx.apply_(tp, {k: {n: torch.tensor(v) for n, v in p.items()}
                             for k, p in g.items()}, ts)
        assert int(ts.count) == i + 1
        for k in jp:
            for n in jp[k]:
                np.testing.assert_allclose(tp[k][n].numpy(),
                                           np.asarray(jp[k][n]), rtol=1e-6,
                                           atol=1e-7)


def test_loss_for_config_dispatches_every_head():
    """Heads 2 (both variants), 1 and 0 reach their losses; an unknown head
    raises."""
    cases = [("narrow-v2", {}, [torch.zeros((1, 8, 8, 45))],
              "recall"),
             ("narrow-v2", {"v2_variant": "tf"},
              [torch.zeros((1, 8, 8, 45))], "avg_iou"),
             ("narrow-v1", {}, [torch.zeros((1, 126))], "avg_allcat"),
             ("narrow-cls", {}, [torch.full((1, 4), 0.25)], "accuracy")]
    for name, kw, raw, key in cases:
        cfg, specs = model(name, SIZE)
        truths = (torch.zeros(1) if cfg.head == 0
                  else torch.zeros((1, 2, 5)))
        _, m = TL.loss_for_config(cfg, specs, raw, truths, seen=0, **kw)
        assert key in m and np.isfinite(float(m["cost"]))
    cfg, specs = model("narrow-v2", SIZE)
    with pytest.raises(ValueError, match="unknown head"):
        TL.loss_for_config(TL.C.ModelConfig(name="x", dataset="voc", head=7,
                                            input_size=64), specs,
                           [torch.zeros(1)], torch.zeros((1, 1, 5)))


def test_region_hyper_reaches_the_step():
    """make_train_step hands region_hyper and the step's seen to the loss:
    at step 0 (seen 0) the warm-up's xy pull shows in the cost."""
    cfg, specs = model("narrow-v2", SIZE)
    costs = []
    for warm in (12800, 0):
        _, ttx = _optimizers(False)
        ts = TL.create_train_state(cfg, ttx, device="cpu", input_size=SIZE,
                                   specs=specs, seed=3)
        step = TL.make_train_step(
            cfg, ttx, input_size=SIZE, specs=specs,
            region_hyper=TLo.RegionHyper(warmup_seen=warm))
        _, m = step(ts, images(2, SIZE, seed=5), _truths(cfg, 2))
        costs.append(float(m["cost"]))
    assert costs[0] != costs[1]

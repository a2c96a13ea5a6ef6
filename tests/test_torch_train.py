"""The port's training (ops/layers train primitives, engine.TrainNetwork,
train/losses, train/loop, io/weights.train_state_from_jax) against the JAX
package's, on the same numpy inputs and the state JAX's create_train_state
draws, carried across.

Tolerances, each with its measured value (on the CPU):
- BN statistics and normalization, f32: rtol 1e-5 / atol 1e-6 (sums in
  another order); bf16 outputs within 1 bf16 ulp of |y| (measured 1).
- The v3 delta: grad(raw) = -delta / batch within 1 ulp (rtol 1e-6 /
  atol 1e-7: XLA fuses the delta's arithmetic differently), cost and
  metrics rtol 1e-5.
- f32 train steps (narrow spec and yolov3-tiny@64, twopass and onepass,
  SGD with momentum and decay, 2 steps): cost and metrics rtol 1e-5; every
  gradient, updated parameter, momentum buffer and running statistic within
  LEAF_RTOL of each leaf's largest value plus atol 1e-6. LEAF_RTOL is 1e-4
  for twopass. For onepass JAX's f32 statistics are the less exact side:
  its gradients on XLA:CPU, jitted or eager, are up to 7.6e-3 of a leaf's
  largest value from a float64 evaluation of the same step (narrow), and
  on yolov3-tiny on an AVX-512 CPU further than 1e-2 (0.243 against a
  bound of 0.152), where the port's are within 1.5e-5. So the port's
  gradients are held to that float64 evaluation at 1e-4 in every case, and
  its onepass gradients, parameters and momentum to JAX's by a triangle
  bound (``_onepass_bounds``): per leaf, JAX's own distance from the
  float64 gradient plus the port's 1e-4 bound, carried through the
  momentum and the updates. The onepass running statistics (no gradient
  in them) stay at LEAF_RTOL 1e-2. JAX's twopass step runs eagerly: jitted, XLA's CPU fusion
  of it puts up to 1e-2 of error into early-layer gradients, where its
  eager step and the port match the float64 evaluation to 1e-5.
- bf16 steps: cost rtol 1e-2 against JAX's bf16 step. Direction: the
  parameter change over 2 steps is at least as close (cosine, less a 0.01
  margin) to JAX's float32 step's as JAX's own bf16 step is. JAX's bf16
  step cannot be the reference for the direction itself: on the narrow
  spec (onepass) its first gradient has cosine 0.70 with the float32
  gradient of the same state, the port's 0.9996 (port bf16 against JAX
  bf16: 0.71); on yolov3-tiny@64 both bf16 gradients are 0.91 from the
  float32 one and 0.97 from each other. Measured over the 2 steps, port /
  JAX bf16 against JAX f32: narrow onepass 0.9998 / 0.715, narrow twopass
  0.9998 / 0.715, yolov3-tiny onepass 0.908 / 0.912 (port against JAX
  bf16: 0.716, 0.716, 0.988); step-2 cost within 0.85 % of JAX bf16's.
"""

import contextlib
import dataclasses
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from yolo_tensorflow_tpu.ops import layers as JLy
from yolo_tensorflow_tpu.train import losses as JLo
from yolo_tensorflow_tpu.train import loop as JL
from yolo_tensorflow_tpu_torch.io import weights as TW
from yolo_tensorflow_tpu_torch.models import engine as TE
from yolo_tensorflow_tpu_torch.ops import layers as TLy
from yolo_tensorflow_tpu_torch.ops.kernels import conv_bnstat as BS
from yolo_tensorflow_tpu_torch.train import losses as TLo
from yolo_tensorflow_tpu_torch.train import loop as TL

from torch_parity import images, jax_model, model, to_jax

LR, MOMENTUM, DECAY = 1e-3, 0.9, 5e-4
LEAF_RTOL = {"twopass": 1e-4, "onepass": 1e-2}
# the port's gradients against their float64 evaluation
GRAD64_RTOL = 1e-4
LEAF_ATOL = 1e-6
BF16 = dict(cost_rtol=1e-2, cosine_margin=0.01)


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x)).permute(0, 3, 1, 2)


def truths(batch, num_classes, seed=2, t=6, used=4):
    """(B, T, 5) normalized truths, the last T - used rows w == 0 padding;
    row 1 repeats row 0's cell and size, so the two collide."""
    rng = np.random.default_rng(seed)
    tr = np.zeros((batch, t, 5), np.float32)
    tr[:, :used, :2] = rng.uniform(0.05, 0.95, (batch, used, 2))
    tr[:, :used, 2:4] = rng.uniform(0.04, 0.6, (batch, used, 2))
    tr[:, :used, 4] = rng.integers(0, num_classes, (batch, used))
    tr[:, 1, :4] = tr[:, 0, :4] + np.float32(1e-3)
    return tr


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _port_np(tree):
    """Port tensors {k: {n: tensor}} -> numpy copies in the JAX layout (the
    port updates its tensors in place)."""
    return to_jax({k: {n: v.detach().float().cpu().numpy().copy()
                       for n, v in p.items()} for k, p in tree.items()})


def _assert_leaves(got, want, what, rtol):
    for k in want:
        for n in want[k]:
            w = np.asarray(want[k][n], np.float32)
            err = np.abs(np.asarray(got[k][n]) - w).max()
            tol = rtol * np.abs(w).max() + LEAF_ATOL
            assert err <= tol, f"{what} {k}/{n}: |err| {err:.3g} > {tol:.3g}"


# ---------------------------------------------------------------- layers

@pytest.mark.parametrize("stats", ["twopass", "onepass"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("fused", [False, True])
def test_batch_norm_train_matches_jax(stats, dtype, fused, rng):
    x = rng.normal(0.7, 1.3, (2, 5, 6, 8)).astype(np.float32)
    gamma = rng.uniform(0.5, 1.5, 8).astype(np.float32)
    beta = rng.normal(0, 0.2, 8).astype(np.float32)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    xj = jnp.asarray(x).astype(jdt)
    want, wm, wv = JLy.batch_norm_train(xj, jnp.asarray(gamma),
                                        jnp.asarray(beta), 1e-5, stats=stats)
    xt = _nchw(np.asarray(xj.astype(jnp.float32))).to(getattr(torch, dtype))
    sums = None
    if fused:
        x64 = xt.double()
        sums = (x64.sum(dim=(0, 2, 3)).float(),
                (x64 * x64).sum(dim=(0, 2, 3)).float())
    y, m, v = TLy.batch_norm_train(xt, torch.from_numpy(gamma),
                                   torch.from_numpy(beta), 1e-5, stats=stats,
                                   sums=sums)
    np.testing.assert_allclose(m.numpy(), np.asarray(wm), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(v.numpy(), np.asarray(wv), rtol=1e-5,
                               atol=1e-6)
    assert y.dtype == getattr(torch, dtype)
    want = np.asarray(want.astype(jnp.float32))
    got = y.float().permute(0, 2, 3, 1).numpy()
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    else:
        assert np.all(np.abs(got - want) <= 2 ** -8 * np.abs(want) + 1e-6)


@pytest.mark.parametrize("stats", ["onepass_bf16", "ghost32", "ghost"])
def test_left_out_bn_stats_raise(stats):
    x = torch.zeros((2, 3, 4, 4))
    with pytest.raises(NotImplementedError, match="item 14"):
        TLy.batch_norm_train(x, torch.ones(3), torch.zeros(3), 1e-5,
                             stats=stats)


@pytest.mark.parametrize("bias,out", [(True, None), (False, "bfloat16")])
def test_mixed_precision_conv_matches_jax(bias, out, rng):
    """conv2d(train=True, compute_dtype=bf16): one bf16 rounding of the conv,
    then out_dtype (f32 for the heads, with an f32 bias add)."""
    x = rng.normal(0, 1, (2, 6, 6, 8)).astype(np.float32)
    w = rng.normal(0, 0.2, (3, 3, 8, 5)).astype(np.float32)
    b = rng.normal(0, 1, 5).astype(np.float32) if bias else None
    odt = jnp.bfloat16 if out else None
    want = JLy.conv2d(jnp.asarray(x), jnp.asarray(w),
                      None if b is None else jnp.asarray(b),
                      compute_dtype=jnp.bfloat16, train=True, out_dtype=odt)
    got = TLy.conv2d(_nchw(x), torch.from_numpy(w.transpose(3, 2, 0, 1)),
                     None if b is None else torch.from_numpy(b),
                     compute_dtype=torch.bfloat16, train=True,
                     out_dtype=torch.bfloat16 if out else None)
    assert got.dtype == (torch.bfloat16 if out else torch.float32)
    want = np.asarray(want.astype(jnp.float32))
    # one bf16 rounding of accumulators summed in another order
    assert np.all(np.abs(got.float().permute(0, 2, 3, 1).numpy() - want)
                  <= 2 ** -8 * np.abs(want) + 1e-3)


# ---------------------------------------------------------------- loss

def _raw_scales(rng, batch, grids, per_scale):
    return [rng.normal(0, 1.5, (batch, g, g, per_scale)).astype(np.float32)
            for g in grids]


@pytest.mark.parametrize("truth_thresh", [1.0, 0.3])
def test_v3_delta_and_gradient_identity(truth_thresh, rng):
    """grad(raw) = -delta / batch with JAX's per-scale delta, and the cost
    and Region metrics equal, including colliding truths (last writer
    wins) and the truth_thresh branch."""
    cfg, specs = model("narrow", 64)
    jcfg, _ = jax_model("narrow", 64)
    masks = [(3, 4, 5), (0, 1, 2)]
    raws = _raw_scales(rng, 3, (16, 32), 27)
    tr = truths(3, cfg.num_classes)
    kw = dict(anchor_masks=masks, ignore_thresh=0.5,
              truth_thresh=truth_thresh)
    wl, wm = JLo.yolo_v3_loss([jnp.asarray(r) for r in raws],
                              jnp.asarray(tr), jcfg, **kw)
    rt = [torch.tensor(r, requires_grad=True) for r in raws]
    loss, metrics = TLo.yolo_v3_loss(rt, torch.from_numpy(tr), cfg, **kw)
    grads = torch.autograd.grad(loss, rt)
    anchors = jnp.asarray(jcfg.anchors, jnp.float32)
    for raw, g, mask in zip(raws, grads, masks):
        delta, _ = jax.vmap(functools.partial(
            JLo._v3_scale_delta, anchors_all=anchors, mask=mask,
            input_size=64, ignore_thresh=0.5, truth_thresh=truth_thresh,
            num_classes=cfg.num_classes))(jnp.asarray(raw), jnp.asarray(tr))
        want = -np.asarray(delta).reshape(raw.shape) / raw.shape[0]
        np.testing.assert_allclose(g.numpy(), want, rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(float(loss), float(wl), rtol=1e-5)
    for k, v in wm.items():
        np.testing.assert_allclose(float(metrics[k]), float(v), rtol=1e-5,
                                   err_msg=k)


def test_v3_loss_raises_for_the_scan_assignment():
    cfg, _ = model("narrow", 64)
    with pytest.raises(NotImplementedError, match="item 14"):
        TLo.yolo_v3_loss([torch.zeros((1, 4, 4, 27))], torch.zeros((1, 2, 5)),
                         cfg, anchor_masks=[(0, 1, 2)], truth_assign="scan")


@pytest.mark.parametrize("name", ["yolov2", "yolov1", "darknet19-classifier"])
def test_other_losses_raise(name):
    """The v2, v1 and classifier losses are ported (tests/
    test_torch_losses.py); what of their training still raises names its
    reason: the YOLO9000 softmax tree (Queue 1 item 13), v1's ``random``
    responsibility without a generator, the classifier's QAT training
    (Queue 1 item 13; its in-training evaluation is ported,
    tests/test_torch_runner.py)."""
    cfg = TL.C.get_config(name)
    if cfg.head == 2:
        raw = torch.zeros((1, 13, 13, 5 * 85))
        _, m = TL.loss_for_config(cfg, (), [raw], torch.zeros((1, 1, 5)))
        with pytest.raises(NotImplementedError, match="Queue 1 item 13"):
            TL.losses.yolo_v2_region_loss(raw, torch.zeros((1, 1, 5)), cfg,
                                          tree=object())
    elif cfg.head == 1:
        raw = torch.zeros((1, 1470))
        _, m = TL.loss_for_config(cfg, (), [raw], torch.zeros((1, 1, 5)))
        with pytest.raises(ValueError, match="Generator"):
            TL.loss_for_config(
                cfg, (), [raw], torch.zeros((1, 1, 5)), seen=0,
                detection_hyper=TL.losses.DetectionHyper(random=True))
    else:
        import argparse
        from yolo_tensorflow_tpu_torch.train import runner
        probs = torch.full((1, 1000), 1e-3)
        _, m = TL.loss_for_config(cfg, (), [probs], torch.zeros(1))
        with pytest.raises(NotImplementedError, match="Queue 1 item 13"):
            runner.run_training(argparse.Namespace(
                model=name, list="x", val_list="x", eval_every=1, qat=True))
    assert np.isfinite(float(m["cost"]))


# ---------------------------------------------------------------- schedules

STEPS = [0, 1, 2, 7, 99, 100, 101, 1000, 4000, 9000]


@pytest.mark.parametrize("net", [
    {"policy": "constant", "learning_rate": "0.01"},
    {"policy": "steps", "steps": "100,1000", "scales": ".1,.5",
     "burn_in": "10"},
    {"policy": "step", "step": "100", "scale": "0.5"},
    {"policy": "exp", "gamma": "0.999"},
    {"policy": "poly", "power": "2", "max_batches": "5000"},
    {"policy": "sigmoid", "gamma": "0.01", "step": "1000"},
    {"policy": "nonsense"}])
def test_darknet_schedule_matches_jax(net):
    jopts, topts = (JL.NetTrainOptions.from_net(net),
                    TL.NetTrainOptions.from_net(net))
    assert dataclasses.asdict(jopts) == dataclasses.asdict(topts)
    with (pytest.warns(UserWarning, match="going with constant")
          if net["policy"] == "nonsense" else contextlib.nullcontext()):
        js, ts = JL.darknet_schedule(jopts), TL.darknet_schedule(topts)
    for s in STEPS:
        np.testing.assert_allclose(float(ts(torch.tensor(s))),
                                   float(js(jnp.int32(s))), rtol=1e-6,
                                   err_msg=f"step {s}")


def test_darknet_lr_schedule_matches_jax():
    kw = dict(burn_in=50, power=4.0, steps=(100, 1000), scales=(0.1, 0.1))
    js, ts = (JL.darknet_lr_schedule(1e-3, **kw),
              TL.darknet_lr_schedule(1e-3, **kw))
    for s in STEPS:
        np.testing.assert_allclose(float(ts(torch.tensor(s))),
                                   float(js(jnp.int32(s))), rtol=1e-6)


NET = {"learning_rate": "0.1", "momentum": "0.8", "decay": "0.001",
       "policy": "steps", "steps": "2", "scales": "0.5", "burn_in": "2"}


@pytest.mark.parametrize("build", [
    lambda pkg: pkg.make_optimizer(
        pkg.darknet_lr_schedule(0.1, burn_in=2, steps=(2,), scales=(0.5,)),
        momentum=MOMENTUM, weight_decay=DECAY),
    lambda pkg: pkg.optimizer_from_net(pkg.NetTrainOptions.from_net(NET))])
def test_sgd_update_matches_optax(build, rng):
    """Decay on "w" only, momentum, lr from the schedule at the count
    before the update: three updates against optax's chain, built by
    make_optimizer and from a [net] section."""
    params = {"L000": {"w": rng.normal(0, 1, (4, 3, 3, 3)),
                       "gamma": rng.normal(1, 0.1, 4),
                       "beta": rng.normal(0, 0.1, 4)},
              "L001": {"w": rng.normal(0, 1, (2, 4, 1, 1)),
                       "b": rng.normal(0, 1, 2)}}
    params = jax.tree.map(lambda a: np.asarray(a, np.float32), params)
    jtx, ttx = build(JL), build(TL)
    jp, js = params, jtx.init(params)
    tp = {k: {n: torch.tensor(v) for n, v in p.items()}
          for k, p in params.items()}
    ts = ttx.init(tp)
    for i in range(3):
        g = jax.tree.map(lambda a: rng.normal(0, 1, a.shape)
                         .astype(np.float32), params)
        upd, js = jtx.update(g, js, jp)
        jp = optax.apply_updates(jp, upd)
        ts = ttx.apply_(tp, {k: {n: torch.tensor(v) for n, v in p.items()}
                             for k, p in g.items()}, ts)
        assert int(ts.count) == i + 1
        for k in jp:
            for n in jp[k]:
                np.testing.assert_allclose(tp[k][n].numpy(),
                                           np.asarray(jp[k][n]), rtol=1e-6,
                                           atol=1e-7)


@pytest.mark.parametrize("call,match", [
    (lambda: TL.darknet_schedule(TL.NetTrainOptions(policy="random")),
     "random"),
    (lambda: TL.losses.yolo_v2_region_loss(
        torch.zeros((1, 2, 2, 10)), torch.zeros((1, 1, 5)),
        model("narrow-v2", 64)[0], tree=object()), "item 13"),
    (lambda: TL.make_train_step(model("narrow", 64)[0], None,
                                remat_every=2), "remat"),
    (lambda: TL.make_train_step(model("narrow", 64)[0], None,
                                bn_stats="ghost8"), "item 14"),
    (lambda: TL.create_train_state(model("narrow", 64)[0], None, qat=True,
                                   device="cpu"), "QAT")])
def test_unported_training_options_raise(call, match):
    with pytest.raises(NotImplementedError, match=match):
        call()


def test_create_train_state_runs_on_the_card_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg, specs = model("narrow", 64)
    with pytest.raises(RuntimeError, match="CUDA"):
        TL.create_train_state(cfg, TL.make_optimizer(lambda s: 0.1),
                              specs=specs)


def test_train_network_rejects_folded_params():
    _, specs = model("narrow", 64)
    params, _ = TE.init_params(specs, 64, 0)
    params["L000"] = {"w": params["L000"]["w"], "b": np.zeros(8)}
    with pytest.raises(ValueError, match="unfolded"):
        TE.TrainNetwork(specs, params)


# ---------------------------------------------------------------- steps

def _jax_tx():
    return JL.make_optimizer(JL.darknet_lr_schedule(LR, burn_in=2),
                             momentum=MOMENTUM, weight_decay=DECAY)


def _port_tx():
    return TL.make_optimizer(TL.darknet_lr_schedule(LR, burn_in=2),
                             momentum=MOMENTUM, weight_decay=DECAY)


@functools.lru_cache(maxsize=None)
def _runs(name, bn_stats, dtype, steps=2):
    """The same 2 steps in both packages from JAX's create_train_state.
    Returns per step k = 0..steps: JAX and port params, momentum, running
    stats (numpy, JAX layout), the metrics of each step, and the gradients
    at the states before steps 1 and 2."""
    cfg, specs = model(name, 64)
    jcfg, jspecs = jax_model(name, 64)
    jdt, tdt = ((None, None) if dtype == "float32"
                else (jnp.bfloat16, torch.bfloat16))
    tx = _jax_tx()
    js = JL.create_train_state(jcfg, tx, jax.random.PRNGKey(0),
                               input_size=64, specs=jspecs)
    jstep = JL.make_train_step(jcfg, tx, input_size=64, specs=jspecs,
                               compute_dtype=jdt, bn_stats=bn_stats)
    if bn_stats == "onepass" or dtype != "float32":
        jstep = jax.jit(jstep)
    p, st, mom = TW.train_state_from_jax(
        _np(js.params), _np(js.batch_stats),
        _np(js.opt_state[1][0].trace))
    ptx = _port_tx()
    ts = TL.create_train_state(cfg, ptx, device="cpu", input_size=64,
                               specs=specs, params=p, batch_stats=st,
                               momentum=mom)
    tstep = TL.make_train_step(cfg, ptx, input_size=64, specs=specs,
                               compute_dtype=tdt, bn_stats=bn_stats)
    imgs = images(2, 64, seed=5)
    tr = truths(2, cfg.num_classes)
    out = {"jax": [], "port": [], "grads": [], "grads64": []}

    def record(js, ts, jm=None, tm=None):
        out["jax"].append(dict(params=_np(js.params),
                               stats=_np(js.batch_stats),
                               momentum=_np(js.opt_state[1][0].trace),
                               metrics=jm))
        out["port"].append(dict(params=_port_np(ts.params),
                                stats={k: {n: v.numpy().copy()
                                           for n, v in d.items()}
                                       for k, d in ts.batch_stats.items()},
                                momentum=_port_np(ts.opt_state.momentum),
                                metrics=tm))

    record(js, ts)
    for _ in range(steps):
        if dtype == "float32":
            for key, cd in (("grads", None), ("grads64", torch.float64)):
                g, _, _ = TL.loss_and_grads(
                    cfg, specs, ts.network, torch.from_numpy(imgs),
                    torch.from_numpy(tr), input_size=64, compute_dtype=cd,
                    bn_stats=bn_stats)
                out[key].append(_port_np(g))
        js, jm = jstep(js, imgs, tr)
        ts, tm = tstep(ts, torch.from_numpy(imgs), torch.from_numpy(tr))
        record(js, ts, _np(jm), {k: v.numpy() for k, v in tm.items()})
    return out


F32_CASES = [(n, s) for n in ("narrow", "yolov3-tiny")
             for s in ("twopass", "onepass")]


@pytest.mark.parametrize("name,bn_stats", F32_CASES)
def test_f32_step_metrics_match_jax(name, bn_stats):
    r = _runs(name, bn_stats, "float32")
    for k in (1, 2):
        jm, tm = r["jax"][k]["metrics"], r["port"][k]["metrics"]
        assert set(tm) == set(jm)
        for key in jm:
            np.testing.assert_allclose(tm[key], jm[key], rtol=1e-5,
                                       atol=1e-7, err_msg=f"{key} step {k}")


def _jax_grads(r, k):
    """JAX's gradient at the state before step k, read back from its
    optimizer: g1 = t1 - decay * w0 and g2 = t2 - momentum * t1 - decay *
    w1 (decay on "w" only)."""
    j = r["jax"]
    want = {}
    for key, p in j[k]["momentum"].items():
        want[key] = {}
        for n, t in p.items():
            prev = MOMENTUM * j[k - 1]["momentum"][key][n]
            dec = DECAY * j[k - 1]["params"][key][n] if n == "w" else 0
            want[key][n] = t - prev - dec
    return want


def _max_abs(a):
    return float(np.abs(np.asarray(a, np.float64)).max())


def _ulps(a, n=2):
    """n float32 ulp of the largest magnitude in ``a``."""
    return n * float(np.spacing(np.float32(_max_abs(a))))


def _onepass_bounds(r):
    """Per step k and leaf, how far the port's onepass gradient, momentum
    and parameters may lie from JAX's (``{"grads", "momentum", "params"}``,
    lists over k = 1, 2). The triangle inequality through the float64
    gradient g64 of the port's state: |port g - JAX g| <= |port g - g64| +
    |g64 - JAX g|, the first at most GRAD64_RTOL * max|g64| + LEAF_ATOL
    (test_f32_step_gradients_match_float64), the second measured. Both
    sides start from the same state; the bounds follow the updates t_k =
    g_k + decay * w_(k-1) + momentum * t_(k-1), w_k = w_(k-1) - lr_k * t_k
    (optax.sgd after add_decayed_weights), each side rounding t_k and w_k
    to float32: 2 ulp of the leaf's largest value a step."""
    lr = TL.darknet_lr_schedule(LR, burn_in=2)
    out = {"grads": [], "momentum": [], "params": []}
    t_prev = w_prev = None
    for k in (1, 2):
        jg, g64 = _jax_grads(r, k), r["grads64"][k - 1]
        g_b, t_b, w_b = {}, {}, {}
        for key in jg:
            g_b[key], t_b[key], w_b[key] = {}, {}, {}
            for n in jg[key]:
                g = (_max_abs(np.asarray(jg[key][n], np.float64)
                              - np.asarray(g64[key][n], np.float64))
                     + GRAD64_RTOL * _max_abs(g64[key][n]) + LEAF_ATOL)
                t = g + _ulps(r["jax"][k]["momentum"][key][n])
                if k > 1:
                    t += MOMENTUM * t_prev[key][n]
                    if n == "w":
                        t += DECAY * w_prev[key][n]
                w = ((w_prev[key][n] if k > 1 else 0.0)
                     + float(lr(k - 1)) * t
                     + _ulps(r["jax"][k]["params"][key][n]))
                g_b[key][n], t_b[key][n], w_b[key][n] = g, t, w
        out["grads"].append(g_b)
        out["momentum"].append(t_b)
        out["params"].append(w_b)
        t_prev, w_prev = t_b, w_b
    return out


def _assert_bounded(got, want, bound, what):
    for k in want:
        for n in want[k]:
            err = np.abs(np.asarray(got[k][n], np.float64)
                         - np.asarray(want[k][n], np.float64)).max()
            assert err <= bound[k][n], (f"{what} {k}/{n}: |err| {err:.3g} > "
                                        f"{bound[k][n]:.3g}")


@pytest.mark.parametrize("name,bn_stats", F32_CASES)
def test_f32_step_gradients_match_jax(name, bn_stats):
    """The port's gradients at the states before steps 1 and 2 against
    JAX's (``_jax_grads``): twopass at LEAF_RTOL, onepass within the
    triangle bound of ``_onepass_bounds``."""
    r = _runs(name, bn_stats, "float32")
    bounds = _onepass_bounds(r) if bn_stats == "onepass" else None
    for k in (1, 2):
        what = f"gradient before step {k}"
        if bounds is None:
            _assert_leaves(r["grads"][k - 1], _jax_grads(r, k), what,
                           LEAF_RTOL[bn_stats])
        else:
            _assert_bounded(r["grads"][k - 1], _jax_grads(r, k),
                            bounds["grads"][k - 1], what)


@pytest.mark.parametrize("name,bn_stats", F32_CASES)
def test_f32_step_gradients_match_float64(name, bn_stats):
    """The same gradients evaluated in float64 (compute_dtype float64: the
    same weights and inputs, every op in double)."""
    r = _runs(name, bn_stats, "float32")
    for k in (0, 1):
        _assert_leaves(r["grads"][k], r["grads64"][k],
                       f"gradient before step {k + 1}", GRAD64_RTOL)


@pytest.mark.parametrize("what", ["params", "momentum", "stats"])
@pytest.mark.parametrize("name,bn_stats", F32_CASES)
def test_f32_step_state_matches_jax(name, bn_stats, what):
    """twopass at LEAF_RTOL; onepass parameters and momentum within the
    triangle bound of ``_onepass_bounds``, its running statistics at
    LEAF_RTOL."""
    r = _runs(name, bn_stats, "float32")
    bounds = (_onepass_bounds(r) if bn_stats == "onepass" and what != "stats"
              else None)
    for k in (1, 2):
        if bounds is None:
            _assert_leaves(r["port"][k][what], r["jax"][k][what],
                           f"{what} after step {k}", LEAF_RTOL[bn_stats])
        else:
            _assert_bounded(r["port"][k][what], r["jax"][k][what],
                            bounds[what][k - 1], f"{what} after step {k}")


def _flat_delta(run, side):
    p0, p2 = run[side][0]["params"], run[side][-1]["params"]
    return np.concatenate([(np.asarray(p2[k][n], np.float64)
                            - np.asarray(p0[k][n], np.float64)).ravel()
                           for k in sorted(p0) for n in sorted(p0[k])])


@pytest.mark.parametrize("name,bn_stats", [("narrow", "onepass"),
                                           ("yolov3-tiny", "onepass"),
                                           ("narrow", "twopass")])
def test_bf16_step_tracks_jax(name, bn_stats):
    r = _runs(name, bn_stats, "bfloat16")
    for k in (1, 2):
        np.testing.assert_allclose(r["port"][k]["metrics"]["cost"],
                                   r["jax"][k]["metrics"]["cost"],
                                   rtol=BF16["cost_rtol"])
    ref = _flat_delta(_runs(name, bn_stats, "float32"), "jax")

    def cosine(side):
        a = _flat_delta(r, side)
        return a @ ref / np.linalg.norm(a) / np.linalg.norm(ref)

    assert cosine("port") >= cosine("jax") - BF16["cosine_margin"], (
        cosine("port"), cosine("jax"))


def test_multi_step_equals_sequential_steps():
    cfg, specs = model("narrow", 64)
    imgs = torch.from_numpy(np.stack([images(2, 64, seed=s)
                                      for s in (5, 6)]))
    tr = torch.from_numpy(np.stack([truths(2, cfg.num_classes, seed=s)
                                    for s in (2, 3)]))
    states = []
    for _ in range(2):
        tx = _port_tx()
        states.append((tx, TL.create_train_state(cfg, tx, device="cpu",
                                                 input_size=64, specs=specs,
                                                 seed=1)))
    (tx_a, a), (tx_b, b) = states
    multi = TL.make_multi_step(cfg, tx_a, 2, input_size=64, specs=specs)
    a, ma = multi(a, imgs, tr)
    step = TL.make_train_step(cfg, tx_b, input_size=64, specs=specs)
    costs = []
    for i in range(2):
        b, mb = step(b, imgs[i], tr[i])
        costs.append(float(mb["cost"]))
    assert ma["cost"].shape == (2,) and ma["step"].tolist() == [0, 1]
    np.testing.assert_array_equal(ma["cost"].numpy(), costs)
    assert int(a.step) == int(b.step) == 2
    for k, p in a.params.items():
        for n, v in p.items():
            assert torch.equal(v, b.params[k][n])


def test_train_step_launches_no_kernel_on_the_cpu():
    cfg, specs = model("narrow", 64)
    tx = _port_tx()
    state = TL.create_train_state(cfg, tx, device="cpu", input_size=64,
                                  specs=specs)
    before = BS.launches
    state, m = TL.make_train_step(cfg, tx, input_size=64, specs=specs,
                                  bn_stats="onepass")(
        state, images(2, 64), truths(2, cfg.num_classes))
    assert BS.launches == before
    assert all(v.dim() == 0 for v in m.values())
    assert np.isfinite(float(m["cost"]))


def test_train_state_from_jax_transposes_kernels():
    jcfg, jspecs = jax_model("narrow", 64)
    js = JL.create_train_state(jcfg, _jax_tx(), jax.random.PRNGKey(3),
                               input_size=64, specs=jspecs)
    p, st, mom = TW.train_state_from_jax(_np(js.params),
                                         _np(js.batch_stats),
                                         _np(js.opt_state[1][0].trace))
    assert p["L000"]["w"].shape == (8, 3, 3, 3)
    np.testing.assert_array_equal(to_jax(p)["L006"]["w"],
                                  np.asarray(js.params["L006"]["w"]))
    np.testing.assert_array_equal(p["L000"]["gamma"],
                                  np.asarray(js.params["L000"]["gamma"]))
    assert mom["L009"]["w"].shape == p["L009"]["w"].shape
    assert set(st) == set(js.batch_stats)

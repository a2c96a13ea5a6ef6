"""The port's v2 (darknet region and TF ``tf`` variant), v1 and classifier
losses against the JAX package's, on the same numpy inputs (float32, on
the CPU): the loss value, every metric and d loss / d raw.

Tolerances: loss and metrics rtol 1e-5; gradients rtol 1e-5 plus an atol
of 1e-6 of the largest |gradient| (the delta losses' gradient is -delta /
batch, elementwise arithmetic that the two packages round in another
order; measured within 3 ulp). The truths hold two boxes in one cell with
the same best anchor (the later one must win the region loss's cell, the
earlier one v1's grid), a padded row between valid ones and, for v1, a box
below its 0.005 size floor.
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from yolo_tensorflow_tpu.train import losses as JLo
from yolo_tensorflow_tpu_torch.ops import layers as TLy
from yolo_tensorflow_tpu_torch.train import losses as TLo

from torch_parity import jax_model, model

B = 3


def _truths(num_classes, seed=4, t=8):
    """(B, T, 5): rows 0-3 valid, row 1 in row 0's cell at nearly its size,
    row 4 padding, rows 5-6 valid, row 5 tiny (w, h < 0.005), row 7
    padding."""
    rng = np.random.default_rng(seed)
    tr = np.zeros((B, t, 5), np.float32)
    for r in (0, 1, 2, 3, 5, 6):
        tr[:, r, :2] = rng.uniform(0.05, 0.95, (B, 2))
        tr[:, r, 2:4] = rng.uniform(0.05, 0.7, (B, 2))
        tr[:, r, 4] = rng.integers(0, num_classes, B)
    tr[:, 1, :4] = tr[:, 0, :4] + np.float32(2e-3)
    tr[:, 5, 2:4] = 0.004
    return tr


def _close(got, want, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    atol = 1e-6 * max(np.abs(want).max(), 1e-30)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=atol, err_msg=what)


def _compare(jax_fn, port_fn, raw):
    """loss, metrics and d loss / d raw of both packages."""
    (wl, wm), wg = jax.jit(jax.value_and_grad(jax_fn, has_aux=True))(
        jnp.asarray(raw))
    rt = torch.tensor(raw, requires_grad=True)
    loss, metrics = port_fn(rt)
    (g,) = torch.autograd.grad(loss, rt)
    _close(float(loss.detach()), float(wl), "loss")
    assert set(metrics) == set(wm)
    for k in wm:
        _close(float(metrics[k]), float(wm[k]), k)
    _close(g.numpy(), np.asarray(wg), "gradient")
    return metrics


@pytest.mark.parametrize("seen,rescore,bias_match", [
    (0, True, True), (12800, True, True), (0, False, True),
    (20000, True, False)])
def test_region_loss_matches_jax(seen, rescore, bias_match, rng):
    """forward_region_layer: the warm-up on (seen < 12800) and off, rescore
    on and off, anchors matched by their own or the predicted size."""
    cfg, _ = model("narrow-v2", 64)
    jcfg, _ = jax_model("narrow-v2", 64)
    raw = rng.normal(0, 1.5, (B, 8, 8, 5 * 9)).astype(np.float32)
    tr = _truths(cfg.num_classes)
    kw = dict(rescore=rescore, bias_match=bias_match, thresh=0.5)
    m = _compare(
        lambda r: JLo.yolo_v2_region_loss(r, jnp.asarray(tr), jcfg,
                                          seen=jnp.int32(seen),
                                          hyper=JLo.RegionHyper(**kw)),
        lambda r: TLo.yolo_v2_region_loss(r, torch.from_numpy(tr), cfg,
                                          seen=torch.tensor(seen),
                                          hyper=TLo.RegionHyper(**kw)),
        raw)
    assert float(m["count"]) == 6 * B       # the tiny box is valid here


def test_region_delta_keeps_the_last_writer(rng):
    """Two truths at one (cell, anchor): the cell holds the later one's row,
    as darknet's sequential walk leaves it; the metrics count both."""
    cfg, _ = model("narrow-v2", 64)
    raw = rng.normal(0, 1.0, (1, 8, 8, 45)).astype(np.float32)
    tr = np.zeros((1, 3, 5), np.float32)
    tr[0, 0] = (0.30, 0.30, 0.20, 0.20, 1)
    tr[0, 1] = (0.31, 0.31, 0.21, 0.21, 3)
    anchors = torch.tensor(cfg.anchors, dtype=torch.float32)
    hyper = TLo.RegionHyper()
    args = (anchors, torch.tensor(20000), hyper, cfg.num_classes)
    both, m = TLo._region_delta(torch.from_numpy(raw), torch.from_numpy(tr),
                                *args)
    alone, _ = TLo._region_delta(torch.from_numpy(raw),
                                 torch.from_numpy(tr[:, 1:]), *args)
    assert torch.equal(both, alone) and float(m["count"]) == 2


@pytest.mark.parametrize("grid", [8, 5])
def test_tf_v2_loss_matches_jax(grid, rng):
    """The TF reference's Loss.py: targets, loss, avg_iou and gradient."""
    cfg, _ = model("narrow-v2", 64)
    jcfg, _ = jax_model("narrow-v2", 64)
    raw = rng.normal(0, 1.0, (B, grid, grid, 45)).astype(np.float32)
    tr = _truths(cfg.num_classes)
    want = JLo.build_v2_targets(jnp.asarray(tr), jcfg, grid)
    got = TLo.build_v2_targets(torch.from_numpy(tr), cfg, grid)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]),
                                      err_msg=k)
    _compare(lambda r: JLo.yolo_v2_loss(r, want, jcfg, grid=grid),
             lambda r: TLo.yolo_v2_loss(r, got, cfg, grid=grid), raw)


V1_HYPERS = [dict(), dict(sqrt=False, rescore=False), dict(forced=True),
             dict(softmax=True, object_scale=2.0)]


@pytest.mark.parametrize("kw", V1_HYPERS, ids=["default", "plain",
                                               "forced", "softmax"])
def test_v1_loss_matches_jax(kw, rng):
    """forward_detection_layer: grid targets (first box of a cell wins, the
    tiny box skipped), the sequential IoU/rmse responsibility scan, rescore,
    sqrt, forced and softmax."""
    cfg, _ = model("narrow-v1", 64)
    jcfg, _ = jax_model("narrow-v1", 64)
    pred = rng.normal(0.3, 0.4, (B, 9 * 14)).astype(np.float32)
    tr = _truths(cfg.num_classes)
    want = JLo.build_v1_truth_grid(jnp.asarray(tr), 4, 3)
    got = TLo.build_v1_truth_grid(torch.from_numpy(tr), 4, 3)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    _compare(lambda r: JLo.yolo_v1_loss(r, jnp.asarray(tr), jcfg,
                                        hyper=JLo.DetectionHyper(**kw)),
             lambda r: TLo.yolo_v1_loss(r, torch.from_numpy(tr), cfg,
                                        hyper=TLo.DetectionHyper(**kw)),
             pred)


def test_v1_sequential_argmax_is_not_argmax():
    """The C's scan: once an IoU > 0 is seen the rmse branch is dead, so a
    box with IoU 0 and the smaller rmse (an argmin of rmse would take it)
    loses to a later box with IoU > 0, and the first of equal IoUs wins.
    Both packages, one cell."""
    S, n, C = 1, 3, 1
    truth = np.array([[1, 1, 0.5, 0.5, 0.2, 0.2]], np.float32)[None]
    boxes = np.array([[0.75, 0.5, 0.2, 0.2],     # IoU 0, rmse 0.25
                      [0.5, 0.5, 3.0, 3.0],      # IoU 0.0044, rmse 3.96
                      [0.5, 0.5, 3.0, 3.0]],     # the same IoU, later
                     np.float32)
    pred = np.concatenate([[0.5], [0.1, 0.2, 0.3],
                           boxes.ravel()]).astype(np.float32)[None]
    hyper = dict(sqrt=False)
    jd, _ = jax.vmap(functools.partial(
        JLo._v1_delta, hyper=JLo.DetectionHyper(**hyper), side=S,
        num_boxes=n, num_classes=C))(jnp.asarray(pred), jnp.asarray(truth),
                                     jnp.zeros((1, 1), jnp.int32),
                                     jnp.zeros((1,), bool))
    td, _ = TLo._v1_delta(torch.from_numpy(pred), torch.from_numpy(truth),
                          None, None, TLo.DetectionHyper(**hyper), S, n, C)
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=1e-6)
    coords = td.numpy()[0, 1 + n:].reshape(n, 4)
    assert np.all(coords[0] == 0) and np.all(coords[2] == 0)
    assert np.any(coords[1] != 0)


def test_v1_random_responsibility_matches_jax_for_the_same_draw(rng):
    """hyper.random: JAX draws from a PRNG keyed by seen, the port from a
    torch.Generator; given the same draw both pick the same boxes."""
    cfg, _ = model("narrow-v1", 64)
    pred = rng.normal(0.3, 0.4, (B, 9 * 14)).astype(np.float32)
    tr = _truths(cfg.num_classes)
    grid = TLo.build_v1_truth_grid(torch.from_numpy(tr), 4, 3)
    idx = rng.integers(0, 2, (B, 9)).astype(np.int32)
    h = dict(random=True)
    jd, _ = jax.vmap(functools.partial(
        JLo._v1_delta, hyper=JLo.DetectionHyper(**h), side=3, num_boxes=2,
        num_classes=4))(jnp.asarray(pred), jnp.asarray(grid.numpy()),
                        jnp.asarray(idx), jnp.ones((B,), bool))
    td, _ = TLo._v1_delta(torch.from_numpy(pred), grid,
                          torch.from_numpy(idx).long(), torch.tensor(True),
                          TLo.DetectionHyper(**h), 3, 2, 4)
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=1e-6,
                               atol=1e-7)


def test_v1_random_draw_rate_and_gate(rng):
    """The port's draw: each responsibility uniform over the n boxes (a 5
    sigma binomial bound over 20000 cells) while seen < 64000, and the loss
    equals the non-random one from then on."""
    cfg, _ = model("narrow-v1", 64)
    g = torch.Generator().manual_seed(7)
    draws = torch.randint(0, 2, (20000,), generator=g)
    assert abs(float(draws.float().mean()) - 0.5) < 5 * (0.25 / 20000) ** .5
    pred = torch.from_numpy(rng.normal(0.3, 0.4, (B, 126)).astype(
        np.float32))
    tr = torch.from_numpy(_truths(cfg.num_classes))
    late, _ = TLo.yolo_v1_loss(pred, tr, cfg, seen=torch.tensor(64000),
                               hyper=TLo.DetectionHyper(random=True),
                               generator=g)
    plain, _ = TLo.yolo_v1_loss(pred, tr, cfg)
    assert float(late) == float(plain)
    with pytest.raises(ValueError, match="Generator"):
        TLo.yolo_v1_loss(pred, tr, cfg, seen=torch.tensor(0),
                         hyper=TLo.DetectionHyper(random=True))


@pytest.mark.parametrize("from_probs", [True, False])
def test_classifier_loss_matches_jax(from_probs, rng):
    logits = rng.normal(0, 2.0, (5, 7)).astype(np.float32)
    x = (np.asarray(jax.nn.softmax(jnp.asarray(logits), -1))
         if from_probs else logits)
    labels = rng.integers(0, 7, 5).astype(np.int32)
    _compare(lambda r: JLo.classifier_loss(r, jnp.asarray(labels),
                                           from_probs=from_probs),
             lambda r: TLo.classifier_loss(r, torch.from_numpy(labels),
                                           from_probs=from_probs), x)


def test_dropout_rate_and_scale():
    """Kept with probability 1 - rate (5 sigma over 200000 elements),
    kept values scaled by 1 / (1 - rate), the draw a pure function of the
    generator's seed; rate 0 is the identity."""
    x = torch.ones(200000)
    y = TLy.dropout(x, 0.3, torch.Generator().manual_seed(1))
    kept = (y != 0).float().mean().item()
    assert abs(kept - 0.7) < 5 * (0.21 / 200000) ** 0.5
    assert torch.allclose(y[y != 0], torch.tensor(1 / 0.7))
    again = TLy.dropout(x, 0.3, torch.Generator().manual_seed(1))
    assert torch.equal(y, again)
    assert torch.equal(TLy.dropout(x, 0.0, torch.Generator()), x)


def test_region_hyper_from_options_matches_jax():
    opts = {"thresh": ".55", "object_scale": "4", "rescore": "0",
            "bias_match": "0", "softmax": "1", "coords": "4"}
    assert (dataclasses.asdict(TLo.RegionHyper.from_options(opts))
            == dataclasses.asdict(JLo.RegionHyper.from_options(opts)))
    opts = {"coord_scale": "3", "sqrt": "0", "forced": "1", "random": "1"}
    assert (dataclasses.asdict(TLo.DetectionHyper.from_options(opts))
            == dataclasses.asdict(JLo.DetectionHyper.from_options(opts)))


def test_softmax_tree_raises():
    cfg, _ = model("narrow-v2", 64)
    with pytest.raises(NotImplementedError, match="Queue 1 item 13"):
        TLo.yolo_v2_region_loss(torch.zeros((1, 8, 8, 45)),
                                torch.zeros((1, 2, 5)), cfg, tree=object())

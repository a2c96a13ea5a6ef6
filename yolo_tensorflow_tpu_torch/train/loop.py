"""The training step, its optimizer and its schedules, in PyTorch.

Counterpart of yolo_tensorflow_tpu/train/loop.py for one card: darknet's
SGD + momentum + decay and its Adam (src/network.c update_network) over
the v3, v2 (region or ``tf``), v1 and classifier losses. Where the TPU
package is pure and jitted, the port runs eagerly and updates the
parameters, optimizer buffers and running statistics in place, which keeps
one copy of each on the card. Nothing in a step syncs with the host: the
learning rate, the step counter, ``seen`` and the metrics stay tensors on
the device until the caller reads them. Random draws (dropout masks, v1's
``random`` responsibility) come from the TrainState's torch.Generator, where
the TPU package splits a JAX PRNG key: the same distributions, not the same
draws.

Not ported: the ``random`` lr policy and rematerialization (ROADMAP.md,
Queue 1 item 9), QAT (item 13), data parallelism (item 10).
"""

from __future__ import annotations

import dataclasses as _dc
import warnings
from typing import Any, NamedTuple, Optional, Sequence

import numpy as np
import torch

from yolo_tensorflow_tpu_torch import config as C
from yolo_tensorflow_tpu_torch.models import engine, specs as S
from yolo_tensorflow_tpu_torch.ops import layers as L
from yolo_tensorflow_tpu_torch.pipeline import normalize_images
from yolo_tensorflow_tpu_torch.train import losses

_ITEM = "ROADMAP.md, Queue 1 item 9"


class SGDState(NamedTuple):
    """optax's state of ``make_optimizer``: the schedule's update count and
    the momentum buffer of every parameter ({layer_key: {name: tensor}})."""
    count: torch.Tensor
    momentum: dict


class DarknetAdamState(NamedTuple):
    """darknet_adam's state: the update count and the first and second
    moments of every parameter ({layer_key: {name: tensor}})."""
    count: torch.Tensor
    m: dict
    v: dict


class TrainState(NamedTuple):
    """The TPU package's TrainState on one card. ``network`` holds the
    parameters (``engine.TrainNetwork``, updated in place); batch_stats are
    the running {layer_key: {"mean", "var"}}; step is an int64 0-d tensor
    on the card; ``generator`` the torch.Generator on the card that dropout
    and v1's ``random`` responsibility draw from (the TPU package's rng)."""
    network: Any
    batch_stats: dict
    opt_state: Any
    step: torch.Tensor
    generator: torch.Generator

    @property
    def params(self) -> dict:
        return self.network.params_tree()


def _step_f32(step):
    return torch.as_tensor(step).to(torch.float32)


def darknet_lr_schedule(base_lr: float, *, burn_in: int = 1000,
                        power: float = 4.0,
                        steps: Sequence[int] = (400000, 450000),
                        scales: Sequence[float] = (0.1, 0.1)):
    """darknet 'steps' policy with burn-in (src/network.c get_current_rate):
    lr * ((step + 1) / burn_in)^power up to 1, then piecewise-constant
    decays. step is a tensor; the rate is a float32 tensor beside it."""
    def schedule(step):
        step = torch.as_tensor(step)
        lr = base_lr * torch.clamp((_step_f32(step) + 1) / burn_in,
                                   max=1.0) ** power
        for s, sc in zip(steps, scales):
            lr = lr * torch.where(step >= s, sc, 1.0)
        return lr
    return schedule


@_dc.dataclass(frozen=True)
class NetTrainOptions:
    """[net] training hyperparameters: parse_net_options
    (src/parser.c:643-724)."""
    learning_rate: float = 1e-3
    momentum: float = 0.9
    decay: float = 1e-4
    batch: int = 1
    subdivisions: int = 1
    burn_in: int = 0
    power: float = 4.0
    policy: str = "constant"
    step: int = 1
    scale: float = 1.0
    steps: Sequence[int] = ()
    scales: Sequence[float] = ()
    gamma: float = 1.0
    max_batches: int = 0
    adam: bool = False
    B1: float = 0.9
    B2: float = 0.999
    eps: float = 1e-7

    @classmethod
    def from_net(cls, net: dict) -> "NetTrainOptions":
        """Build from a parsed [net] section dict."""
        kw = dict(
            learning_rate=float(net.get("learning_rate", 1e-3)),
            momentum=float(net.get("momentum", 0.9)),
            decay=float(net.get("decay", 1e-4)),
            batch=int(net.get("batch", 1)),
            subdivisions=int(net.get("subdivisions", 1)),
            burn_in=int(net.get("burn_in", 0)),
            power=float(net.get("power", 4)),
            policy=net.get("policy", "constant"),
            gamma=float(net.get("gamma", 1)),
            step=int(net.get("step", 1)),
            scale=float(net.get("scale", 1)),
            max_batches=int(net.get("max_batches", 0)),
            adam=bool(int(net.get("adam", 0))),
            B1=float(net.get("B1", 0.9)),
            B2=float(net.get("B2", 0.999)),
            eps=float(net.get("eps", 1e-7)),
        )
        if kw["policy"] == "steps":
            if "steps" not in net or "scales" not in net:
                raise ValueError(
                    "STEPS policy must have steps and scales in cfg file")
            kw["steps"] = tuple(int(v) for v in net["steps"].split(","))
            kw["scales"] = tuple(float(v) for v in net["scales"].split(","))
        return cls(**kw)


def darknet_schedule(opts: NetTrainOptions):
    """get_current_rate (src/network.c:90-120): burn-in ramp
    lr * (i / burn_in)^power while i < burn_in, then the cfg's policy
    (constant, step, steps, exp, poly, sigmoid); an unknown name warns and
    falls back to constant, as the C does. 'random' raises: the TPU package
    draws it from a JAX PRNG, which has no exact counterpart here."""
    policy = opts.policy
    if policy == "random":
        raise NotImplementedError(
            f"lr policy 'random' is not ported ({_ITEM}: it draws from a "
            "JAX PRNG)")
    if policy not in ("constant", "step", "steps", "exp", "poly", "sigmoid"):
        warnings.warn(f"Couldn't find policy {policy}, going with constant")
        policy = "constant"
    lr = opts.learning_rate

    def schedule(step):
        step = torch.as_tensor(step)
        s = _step_f32(step)
        if policy == "step":
            rate = lr * torch.pow(opts.scale, (step // opts.step).float())
        elif policy == "steps":
            rate = torch.full((), lr, dtype=torch.float32,
                              device=step.device)
            for si, sc in zip(opts.steps, opts.scales):
                rate = rate * torch.where(step >= si, sc, 1.0)
        elif policy == "exp":
            rate = lr * torch.pow(opts.gamma, s)
        elif policy == "poly":
            # steps past max_batches hold ~0, as in the TPU package
            frac = torch.clamp(s / max(opts.max_batches, 1), max=1.0)
            rate = lr * (1.0 - frac) ** opts.power
        elif policy == "sigmoid":
            rate = lr * (1.0 / (1.0 + torch.exp(opts.gamma
                                                * (s - opts.step))))
        else:
            rate = torch.full((), lr, dtype=torch.float32,
                              device=step.device)
        if opts.burn_in > 0:
            burn = lr * (s / opts.burn_in) ** opts.power
            return torch.where(s < opts.burn_in, burn, rate)
        return rate

    return schedule


class SGD:
    """optax.chain(add_decayed_weights(weight_decay, mask=conv "w"),
    sgd(schedule, momentum)), applied in place: darknet's update rule
    (src/convolutional_layer.c update_convolutional_layer), decay on conv
    weights only, not on biases or BN scales; dampening 0, no Nesterov.

        g' = g + weight_decay * w          ("w" leaves only)
        t  = momentum * t + g'
        w  = w - schedule(count) * t,  count = updates before this one
    """

    def __init__(self, schedule, *, momentum: float = 0.9,
                 weight_decay: float = 5e-4):
        self.schedule = schedule
        self.momentum = momentum
        self.weight_decay = weight_decay

    def init(self, params) -> SGDState:
        leaf = next(iter(next(iter(params.values())).values()))
        return SGDState(
            count=torch.zeros((), dtype=torch.int64, device=leaf.device),
            momentum={k: {n: torch.zeros_like(v) for n, v in p.items()}
                      for k, p in params.items()})

    @torch.no_grad()
    def apply_(self, params, grads, state: SGDState) -> SGDState:
        """Update params and the momentum buffers in place; returns the
        state with the count advanced."""
        names = [(k, n) for k, p in params.items() for n in p]
        ws = [params[k][n] for k, n in names]
        gs = [grads[k][n] for k, n in names]
        ts = [state.momentum[k][n] for k, n in names]
        decayed = [i for i, (_, n) in enumerate(names) if n == "w"]
        for i, g in zip(decayed, torch._foreach_add(
                [gs[i] for i in decayed], [ws[i] for i in decayed],
                alpha=self.weight_decay)):
            gs[i] = g
        torch._foreach_mul_(ts, self.momentum)
        torch._foreach_add_(ts, gs)
        lr = self.schedule(state.count).to(ws[0].dtype)
        torch._foreach_sub_(ws, torch._foreach_mul(ts, lr))
        return SGDState(state.count + 1, state.momentum)


def make_optimizer(schedule, *, momentum: float = 0.9,
                   weight_decay: float = 5e-4) -> SGD:
    """SGD + momentum + decoupled weight decay, darknet's update rule."""
    return SGD(schedule, momentum=momentum, weight_decay=weight_decay)


class DarknetAdam:
    """darknet's Adam (``[net] adam=1``), the TPU package's ``darknet_adam``
    transcribed from the GPU kernels (adam_update_gpu / adam_kernel,
    src/blas_kernels.cu), applied in place:

        d  = -batch * (g + decay * w)       every tensor, biases and BN
                                            scales too (unlike SGD)
        m  = B1 * m + (1 - B1) * d ;  v = B2 * v + (1 - B2) * d^2
        w  = w + rate * (m / (1 - B1^t)) / (sqrt(v / (1 - B2^t)) + eps)

    with ``rate`` the schedule's learning rate at the count before the
    update, undivided by batch, and t the update's number, from 1. The
    gradients here are -d_darknet / batch (the losses' delta identity), so
    d is rebuilt as -batch * (g + decay * w)."""

    def __init__(self, schedule, *, b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-7, decay: float = 0.0, batch: int = 1):
        self.schedule = schedule
        self.b1, self.b2, self.eps = b1, b2, eps
        self.decay, self.batch = decay, batch

    def init(self, params) -> DarknetAdamState:
        leaf = next(iter(next(iter(params.values())).values()))
        zeros = lambda: {k: {n: torch.zeros_like(v) for n, v in p.items()}
                         for k, p in params.items()}
        return DarknetAdamState(
            count=torch.zeros((), dtype=torch.int64, device=leaf.device),
            m=zeros(), v=zeros())

    @torch.no_grad()
    def apply_(self, params, grads, state: DarknetAdamState):
        """Update params and both moments in place; returns the state with
        the count advanced."""
        names = [(k, n) for k, p in params.items() for n in p]
        ws = [params[k][n] for k, n in names]
        ms = [state.m[k][n] for k, n in names]
        vs = [state.v[k][n] for k, n in names]
        d = torch._foreach_add([grads[k][n] for k, n in names], ws,
                               alpha=self.decay)
        torch._foreach_mul_(d, -float(self.batch))
        torch._foreach_mul_(ms, self.b1)
        torch._foreach_add_(ms, torch._foreach_mul(d, 1.0 - self.b1))
        torch._foreach_mul_(vs, self.b2)
        torch._foreach_add_(vs, torch._foreach_mul(
            torch._foreach_mul(d, d), 1.0 - self.b2))
        dtype = ws[0].dtype
        rate = self.schedule(state.count).to(dtype)
        t = (state.count + 1).to(dtype)
        c1 = 1.0 - torch.pow(torch.full_like(t, self.b1), t)
        c2 = 1.0 - torch.pow(torch.full_like(t, self.b2), t)
        den = torch._foreach_sqrt(torch._foreach_div(vs, c2))
        torch._foreach_add_(den, self.eps)
        upd = torch._foreach_div(torch._foreach_mul(
            torch._foreach_div(ms, c1), rate), den)
        torch._foreach_add_(ws, upd)
        return DarknetAdamState(state.count + 1, state.m, state.v)


darknet_adam = DarknetAdam        # the TPU package's name for it


def optimizer_from_net(opts: NetTrainOptions, *,
                       batch: Optional[int] = None, schedule=None):
    """The optimizer update_network would run for this [net] section:
    darknet_adam when adam=1 (at ``batch``, by default the section's), else
    SGD + momentum + decay."""
    schedule = darknet_schedule(opts) if schedule is None else schedule
    if opts.adam:
        return darknet_adam(schedule, b1=opts.B1, b2=opts.B2, eps=opts.eps,
                            decay=opts.decay,
                            batch=batch or max(opts.batch, 1))
    return make_optimizer(schedule, momentum=opts.momentum,
                          weight_decay=opts.decay)


def _tensors(tree, device):
    return {k: {n: torch.tensor(np.asarray(v, np.float32), device=device)
                for n, v in p.items()} for k, p in tree.items()}


def create_train_state(cfg: C.ModelConfig, tx, *, seed: int = 0,
                       input_size: Optional[int] = None, specs=None,
                       qat: bool = False, device="cuda", params=None,
                       batch_stats=None, momentum=None) -> TrainState:
    """A fresh TrainState on ``device`` (the card unless the caller asks for
    the CPU). Parameters and running statistics are the numpy
    ``engine.init_params`` of ``seed`` (the TPU package draws its own with
    jax.random), unless ``params`` and ``batch_stats`` (port layout, as
    ``io.weights.train_state_from_jax`` gives them) are passed;
    ``momentum`` likewise seeds an SGD optimizer's buffers. The state's
    generator is seeded with ``seed``."""
    if qat:
        raise NotImplementedError("QAT training is not ported (ROADMAP.md, "
                                  "Queue 1 item 13: ops/qat.py)")
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("create_train_state(device='cuda') needs a CUDA "
                           "device and torch.cuda.is_available() is false")
    specs = C.build_specs(cfg) if specs is None else specs
    size = input_size or cfg.input_size
    if params is None:
        params, batch_stats = engine.init_params(specs, size, seed)
    network = engine.TrainNetwork(specs, params, device=device)
    opt_state = tx.init(network.params_tree())
    if momentum is not None:
        for k, p in _tensors(momentum, device).items():
            for n, v in p.items():
                opt_state.momentum[k][n].copy_(v.reshape(
                    opt_state.momentum[k][n].shape))
    return TrainState(network=network,
                      batch_stats=_tensors(batch_stats, device),
                      opt_state=opt_state,
                      step=torch.zeros((), dtype=torch.int64, device=device),
                      generator=torch.Generator(device=device).manual_seed(
                          seed))


def loss_for_config(cfg: C.ModelConfig, specs, raw_scales, truths, *,
                    ignore_thresh=0.5, truth_thresh=1.0, input_size=None,
                    seen=None, v2_variant: str = "darknet",
                    region_hyper: Optional[losses.RegionHyper] = None,
                    detection_hyper: Optional[losses.DetectionHyper] = None,
                    truth_assign: str = "vectorized", generator=None):
    """The loss of the model family: v3 for head 3; for head 2 darknet's
    region loss (rescore, the warm-up driven by ``seen``, the images
    processed so far) or, with v2_variant "tf", the TF reference's Loss.py;
    v1's detection loss for head 1 (``generator`` feeds its ``random``
    responsibility); softmax cross-entropy for head 0, whose ``truths`` are
    the (B,) labels."""
    if cfg.head == 3:
        masks = [spec.anchor_mask for spec in specs
                 if isinstance(spec, S.Detect)]
        eff_cfg = cfg if input_size is None else _dc.replace(
            cfg, input_size=input_size)
        return losses.yolo_v3_loss(raw_scales, truths, eff_cfg,
                                   anchor_masks=masks,
                                   ignore_thresh=ignore_thresh,
                                   truth_thresh=truth_thresh,
                                   truth_assign=truth_assign)
    if cfg.head == 2:
        (raw,) = raw_scales
        grid = raw.shape[1]
        if v2_variant == "tf":
            targets = losses.build_v2_targets(truths, cfg, grid)
            return losses.yolo_v2_loss(raw, targets, cfg, grid=grid)
        return losses.yolo_v2_region_loss(
            raw, truths, cfg, seen=seen,
            hyper=region_hyper or losses.RegionHyper())
    if cfg.head == 1:
        (pred_flat,) = raw_scales
        return losses.yolo_v1_loss(
            pred_flat, truths, cfg,
            hyper=detection_hyper or losses.DetectionHyper(), seen=seen,
            generator=generator)
    if cfg.head == 0:
        (probs,) = raw_scales
        return losses.classifier_loss(probs, truths.long())
    raise ValueError(f"unknown head {cfg.head}")


def loss_and_grads(cfg: C.ModelConfig, specs, network, images, truths, *,
                   input_size: Optional[int] = None,
                   ignore_thresh: float = 0.5, compute_dtype=None,
                   bn_stats: str = "twopass", marks=None, seen=None,
                   generator=None, **loss_kw):
    """One forward and backward: (grads {layer_key: {name: tensor}},
    new batch statistics, metrics). ``images`` uint8 (B, S, S, 3) and
    ``truths`` (B, T, 5), or (B,) labels for a classifier, on the network's
    device. ``seen`` and ``generator`` (dropout, v1's ``random``) go to the
    network and the loss. ``marks``, if given, is called with "forward",
    "loss" and "backward" as each part is enqueued (``chip_smoke.py``
    records CUDA events there)."""
    mark = marks or (lambda _: None)
    params = network.params_tree()
    leaves = [(k, n) for k, p in params.items() for n in p]
    with L.exact_f32_convs(not L.is_narrow(compute_dtype)
                           and images.is_cuda):
        x = normalize_images(images, cfg)
        dets, new_stats = network(x, compute_dtype, bn_stats, cfg.bn_eps,
                                  generator=generator)
        mark("forward")
        loss, metrics = loss_for_config(
            cfg, specs, [f for f, _ in dets], truths,
            ignore_thresh=ignore_thresh, input_size=input_size, seen=seen,
            generator=generator, **loss_kw)
        mark("loss")
        flat = torch.autograd.grad(loss, [params[k][n] for k, n in leaves])
        mark("backward")
    grads = {k: {} for k in params}
    for (k, n), g in zip(leaves, flat):
        grads[k][n] = g
    return grads, new_stats, metrics


def make_train_step(cfg: C.ModelConfig, tx, *,
                    input_size: Optional[int] = None,
                    ignore_thresh: float = 0.5, compute_dtype=None,
                    specs=None, remat_every: Optional[int] = None,
                    bn_stats: str = "twopass", marks=None, **loss_kw):
    """Build (state, images_u8, truths) -> (state, metrics).

    The step runs ``loss_and_grads`` with darknet's ``seen`` = step * batch
    (a tensor on the device), the optimizer (``SGD`` or ``DarknetAdam``) and
    the running-stat update m * run + (1 - m) * new (m = cfg.bn_momentum).
    ``compute_dtype`` None or float32 trains in full float32 (TF32 off);
    bfloat16 is the TPU package's mixed precision. ``loss_kw`` (v2_variant,
    region_hyper, detection_hyper, truth_thresh) go to ``loss_for_config``.
    ``marks`` also hears "optimizer". ``remat_every`` raises:
    rematerialization is not ported."""
    if remat_every:
        raise NotImplementedError(f"remat_every: rematerialization is not "
                                  f"ported ({_ITEM})")
    L.check_bn_stats(bn_stats)
    specs = C.build_specs(cfg) if specs is None else specs
    mark = marks or (lambda _: None)

    def train_step(state: TrainState, images, truths):
        dev = state.step.device
        images = torch.as_tensor(images, device=dev)
        truths = torch.as_tensor(truths, dtype=torch.float32, device=dev)
        grads, new_stats, metrics = loss_and_grads(
            cfg, specs, state.network, images, truths,
            input_size=input_size, ignore_thresh=ignore_thresh,
            compute_dtype=compute_dtype, bn_stats=bn_stats, marks=marks,
            seen=state.step * images.shape[0], generator=state.generator,
            **loss_kw)
        opt_state = tx.apply_(state.params, grads, state.opt_state)
        m = cfg.bn_momentum
        with torch.no_grad():
            batch_stats = {
                k: {n: m * run[n] + (1.0 - m) * new_stats[k][n]
                    for n in run}
                for k, run in state.batch_stats.items()
            } if new_stats else state.batch_stats
        mark("optimizer")
        return (state._replace(batch_stats=batch_stats, opt_state=opt_state,
                               step=state.step + 1),
                dict(metrics, step=state.step))

    return train_step


def make_multi_step(cfg: C.ModelConfig, tx, n_steps: int, **kw):
    """(state, images (N, B, ...), truths (N, B, T, 5)) -> (state, metrics
    stacked over the N steps): ``n_steps`` train steps in a loop, the
    counterpart of the TPU package's scan inside one jit."""
    step = make_train_step(cfg, tx, **kw)

    def multi(state, images, truths):
        out = []
        for i in range(n_steps):
            state, m = step(state, images[i], truths[i])
            out.append(m)
        return state, {k: torch.stack([m[k] for m in out]) for k in out[0]}

    return multi

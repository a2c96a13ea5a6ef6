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
draws. The ``random`` lr policy is the exception: its rate is JAX's draw,
bit for bit (``train/threefry.py``). Quantization-aware training
(``create_train_state(qat=True)``): the step fake-quantizes the quantizable
convs (``ops/qat.py``) and updates the activation scales, 0-d tensors on
the device, after the optimizer.

Parameter, gradient and optimizer trees are {layer_key: {name: tensor}},
one level deeper for a recurrent layer's sublayers (``tree_leaves``).

Data parallelism, one process per card: ``make_sharded_train_step`` over a
``parallel.mesh.Mesh``, whose BN statistics, metrics and gradients are the
global batch's.
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
from yolo_tensorflow_tpu_torch.ops import qat as QAT
from yolo_tensorflow_tpu_torch.parallel import mesh as P
from yolo_tensorflow_tpu_torch.pipeline import normalize_images
from yolo_tensorflow_tpu_torch.train import losses, threefry

def tree_leaves(tree, prefix=()):
    """[(path, leaf)] of a nested dict, depth first in insertion order."""
    out = []
    for k, v in tree.items():
        if isinstance(v, dict):
            out += tree_leaves(v, prefix + (k,))
        else:
            out.append((prefix + (k,), v))
    return out


def tree_get(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of ``tree`` (and the same leaves of
    ``rest``), into a tree of the same shape."""
    return {k: (tree_map(fn, v, *[r[k] for r in rest]) if isinstance(v, dict)
                else fn(v, *[r[k] for r in rest]))
            for k, v in tree.items()}


def _first_leaf(tree):
    return tree_leaves(tree)[0][1]


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
    and v1's ``random`` responsibility draw from (the TPU package's rng);
    ``qat_scales`` the activation scales of quantization-aware training,
    {layer_key: 0-d float32 tensor on the card} (``ops/qat.py``), or None
    for float training."""
    network: Any
    batch_stats: dict
    opt_state: Any
    step: torch.Tensor
    generator: torch.Generator
    qat_scales: Any = None

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


RANDOM_POLICY_STEPS = 500200     # the runner's default run length


def darknet_schedule(opts: NetTrainOptions, *, steps: Optional[int] = None):
    """get_current_rate (src/network.c:90-120): burn-in ramp
    lr * (i / burn_in)^power while i < burn_in, then the cfg's policy
    (constant, step, steps, exp, poly, sigmoid, random); an unknown name
    warns and falls back to constant, as the C does. 'random' is lr *
    uniform ** power with the TPU package's draw, uniform(fold_in(
    PRNGKey(0x5EED), step)): a table of the rates of steps 0 .. n - 1,
    computed once on the host in numpy (``train/threefry.py``, equal to the
    TPU package's rates bit for bit), copied to a device at its first call
    there and indexed by the step tensor, so no step syncs. n is ``steps``,
    else the section's max_batches, else RANDOM_POLICY_STEPS; a step past
    the table gets a NaN rate."""
    policy = opts.policy
    if policy not in ("constant", "step", "steps", "exp", "poly", "sigmoid",
                      "random"):
        warnings.warn(f"Couldn't find policy {policy}, going with constant")
        policy = "constant"
    lr = opts.learning_rate
    if policy == "random":
        n = steps or opts.max_batches or RANDOM_POLICY_STEPS
        host_rates = torch.from_numpy(threefry.random_policy_rates(
            lr, opts.power, np.arange(n)))
        tables = {}

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
        elif policy == "random":
            table = tables.get(step.device)
            if table is None:
                table = tables[step.device] = host_rates.to(step.device)
            # torch.take, not table[step]: a 0-dim index tensor is read
            # back to the host
            at = step.long().clamp(0, len(table) - 1)
            rate = torch.where(step < len(table), torch.take(table, at),
                               float("nan"))
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
        return SGDState(
            count=torch.zeros((), dtype=torch.int64,
                              device=_first_leaf(params).device),
            momentum=tree_map(torch.zeros_like, params))

    @torch.no_grad()
    def apply_(self, params, grads, state: SGDState) -> SGDState:
        """Update params and the momentum buffers in place; returns the
        state with the count advanced."""
        names = [path for path, _ in tree_leaves(params)]
        ws = [tree_get(params, n) for n in names]
        gs = [tree_get(grads, n) for n in names]
        ts = [tree_get(state.momentum, n) for n in names]
        decayed = [i for i, n in enumerate(names) if n[-1] == "w"]
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
        return DarknetAdamState(
            count=torch.zeros((), dtype=torch.int64,
                              device=_first_leaf(params).device),
            m=tree_map(torch.zeros_like, params),
            v=tree_map(torch.zeros_like, params))

    @torch.no_grad()
    def apply_(self, params, grads, state: DarknetAdamState):
        """Update params and both moments in place; returns the state with
        the count advanced."""
        names = [path for path, _ in tree_leaves(params)]
        ws = [tree_get(params, n) for n in names]
        ms = [tree_get(state.m, n) for n in names]
        vs = [tree_get(state.v, n) for n in names]
        d = torch._foreach_add([tree_get(grads, n) for n in names], ws,
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
                       batch: Optional[int] = None, schedule=None,
                       steps: Optional[int] = None):
    """The optimizer update_network would run for this [net] section:
    darknet_adam when adam=1 (at ``batch``, by default the section's), else
    SGD + momentum + decay; ``steps`` is the run's length, for the
    ``random`` policy's table (``darknet_schedule``)."""
    schedule = (darknet_schedule(opts, steps=steps) if schedule is None
                else schedule)
    if opts.adam:
        return darknet_adam(schedule, b1=opts.B1, b2=opts.B2, eps=opts.eps,
                            decay=opts.decay,
                            batch=batch or max(opts.batch, 1))
    return make_optimizer(schedule, momentum=opts.momentum,
                          weight_decay=opts.decay)


def _tensors(tree, device):
    return tree_map(lambda v: torch.tensor(np.asarray(v, np.float32),
                                           device=device), tree)


def create_train_state(cfg: C.ModelConfig, tx, *, seed: int = 0,
                       input_size: Optional[int] = None, specs=None,
                       qat: bool = False, device="cuda", params=None,
                       batch_stats=None, momentum=None,
                       mesh=None) -> TrainState:
    """A fresh TrainState on ``device`` (the card unless the caller asks for
    the CPU). Parameters and running statistics are the numpy
    ``engine.init_params`` of ``seed`` (the TPU package draws its own with
    jax.random), unless ``params`` and ``batch_stats`` (port layout, as
    ``io.weights.train_state_from_jax`` gives them) are passed;
    ``momentum`` likewise seeds an SGD optimizer's buffers. The state's
    generator is seeded with ``seed``, on a rank of ``mesh`` (a
    ``parallel.mesh.Mesh``) with ``parallel.mesh.rank_seed(seed, mesh)``:
    ranks draw dropout masks of their own. ``qat`` starts the activation
    scales of quantization-aware training at zero
    (``ops.qat.init_scales``)."""
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
        for path, v in tree_leaves(_tensors(momentum, device)):
            buf = tree_get(opt_state.momentum, path)
            buf.copy_(v.reshape(buf.shape))
    return TrainState(network=network,
                      batch_stats=_tensors(batch_stats, device),
                      opt_state=opt_state,
                      step=torch.zeros((), dtype=torch.int64, device=device),
                      generator=torch.Generator(device=device).manual_seed(
                          P.rank_seed(seed, mesh)),
                      qat_scales=QAT.init_scales(specs, device) if qat
                      else None)


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
                   generator=None, remat_every=None, qat_scales=None,
                   act_ranges=None, tf32: bool = False, **loss_kw):
    """One forward and backward: (grads {layer_key: {name: tensor}},
    new batch statistics, metrics). ``images`` uint8 (B, S, S, 3) and
    ``truths`` (B, T, 5), or (B,) labels for a classifier, on the network's
    device. ``seen`` and ``generator`` (dropout, v1's ``random``) go to the
    network and the loss, ``remat_every``, ``qat_scales`` and
    ``act_ranges`` to the network (rematerialization and
    quantization-aware training, ``engine.TrainNetwork``). A float32
    compute dtype runs its convolutions without TF32 unless ``tf32``,
    which leaves the card's defaults (cuDNN's TF32). ``marks``, if
    given, is called with
    "forward", "loss" and "backward" as each part is enqueued
    (``chip_smoke.py`` records CUDA events there)."""
    mark = marks or (lambda _: None)
    params = network.params_tree()
    leaves = tree_leaves(params)
    with L.exact_f32_convs(not tf32 and not L.is_narrow(compute_dtype)
                           and images.is_cuda):
        x = normalize_images(images, cfg)
        dets, new_stats = network(x, compute_dtype, bn_stats, cfg.bn_eps,
                                  generator=generator,
                                  remat_every=remat_every,
                                  qat_scales=qat_scales,
                                  act_ranges=act_ranges)
        mark("forward")
        with P.over_data():
            # under a spatial axis every peer holds the whole heads: the
            # loss runs on them as on one card, its metrics summed over
            # the data axis alone
            loss, metrics = loss_for_config(
                cfg, specs, [f for f, _ in dets], truths,
                ignore_thresh=ignore_thresh, input_size=input_size,
                seen=seen, generator=generator, **loss_kw)
        mark("loss")
        flat = torch.autograd.grad(loss, [v for _, v in leaves])
        mark("backward")
    grads = {}
    for (path, _), g in zip(leaves, flat):
        node = grads
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = g
    return grads, new_stats, metrics


def make_train_step(cfg: C.ModelConfig, tx, *,
                    input_size: Optional[int] = None,
                    ignore_thresh: float = 0.5, compute_dtype=None,
                    specs=None, remat_every: Optional[int] = None,
                    bn_stats: str = "twopass", marks=None,
                    qat_momentum: float = 0.99, mesh=None,
                    tf32: bool = False, **loss_kw):
    """Build (state, images_u8, truths) -> (state, metrics).

    The step runs ``loss_and_grads`` with darknet's ``seen`` = step * batch
    (a tensor on the device), the optimizer (``SGD`` or ``DarknetAdam``) and
    the running-stat update m * run + (1 - m) * new (m = cfg.bn_momentum).
    ``compute_dtype`` None or float32 trains in full float32 (TF32 off;
    ``tf32`` turns it on, the card's default precision for float32
    convolutions); bfloat16 is the TPU package's mixed precision.
    ``loss_kw`` (v2_variant, region_hyper, detection_hyper, truth_thresh)
    go to ``loss_for_config``.
    ``marks`` also hears "optimizer". ``remat_every`` N keeps every Nth
    layer's output for the backward pass and recomputes the layers between
    (``engine.TrainNetwork``): the same gradients for less activation
    memory and one more forward's work. A state with ``qat_scales`` trains
    quantization-aware: after the optimizer the scales take the EMA of
    each quantized conv's input abs-max at ``qat_momentum``
    (``ops.qat.update_scales``), on the device. ``mesh``: see
    ``make_sharded_train_step``."""
    L.check_bn_stats(bn_stats)
    specs = C.build_specs(cfg) if specs is None else specs
    mark = marks or (lambda _: None)
    world = 1 if mesh is None else mesh.num_data

    def train_step(state: TrainState, images, truths):
        dev = state.step.device
        images = torch.as_tensor(images, device=dev)
        truths = torch.as_tensor(truths, dtype=torch.float32, device=dev)
        ranges = {} if state.qat_scales is not None else None
        with P.batch_reduction(mesh):
            grads, new_stats, metrics = loss_and_grads(
                cfg, specs, state.network, images, truths,
                input_size=input_size, ignore_thresh=ignore_thresh,
                compute_dtype=compute_dtype, bn_stats=bn_stats, marks=marks,
                seen=state.step * (images.shape[0] * world),
                generator=state.generator, remat_every=remat_every,
                qat_scales=state.qat_scales, act_ranges=ranges, tf32=tf32,
                **loss_kw)
        if P.reduces(mesh):
            leaves = tree_leaves(grads)
            replicated = ()
            if mesh.num_spatial > 1:
                b, h, w, c = images.shape
                keys = state.network.replicated_keys((b, c, h, w))
                replicated = {j for j, (path, _) in enumerate(leaves)
                              if path[0] in keys}
            for (path, _), g in zip(leaves, P.all_reduce_mean_(
                    [g for _, g in leaves], mesh, replicated)):
                tree_get(grads, path[:-1])[path[-1]] = g
            mark("all-reduce")
        opt_state = tx.apply_(state.params, grads, state.opt_state)
        m = cfg.bn_momentum
        with torch.no_grad():
            batch_stats = tree_map(
                lambda run, new: m * run + (1.0 - m) * new,
                state.batch_stats, new_stats) if new_stats \
                else state.batch_stats
            qat_scales = state.qat_scales
            if qat_scales is not None and ranges:
                qat_scales = QAT.update_scales(qat_scales, ranges,
                                               momentum=qat_momentum)
        mark("optimizer")
        return (state._replace(batch_stats=batch_stats, opt_state=opt_state,
                               step=state.step + 1, qat_scales=qat_scales),
                dict(metrics, step=state.step))

    return train_step


def make_sharded_train_step(cfg: C.ModelConfig, tx, mesh, **kw):
    """The step over ``mesh`` (``parallel.mesh.make_mesh``, data x
    spatial): (state, this rank's images, its truths) -> (state, metrics),
    the TPU package's ``make_sharded_train_step``, which jits one program
    over the global batch. Here each rank runs ``make_train_step``'s step
    on its data block (``parallel.mesh.shard_batch``), and under a spatial
    axis on its rows of every level (``models/spatial.py``), with its
    replica of the state, and these make it that program's step:

    * every BN's statistics, QAT's activation abs-max and the losses'
      metrics are the global batch's (``parallel.mesh.batch_reduction``),
      so the running statistics, the QAT scales and the metrics are too;
      under a spatial axis the statistics sum every rank's rows with their
      count, and the metrics reduce over the data axis alone;
    * darknet's ``seen`` counts the global batch, step * (rows * data
      blocks);
    * the gradients are summed over every rank in one bucketed all-reduce
      and divided by the data blocks (``parallel.mesh.all_reduce_mean_``)
      before the optimizer.

    Why the average is the global batch's gradient: the TPU package's loss
    is L = sum over all rows / B (B the global batch), and rank r's is
    l_r = sum over its rows / b with b = B / ranks, equal on every rank, so
    L = mean_r l_r. Each l_r also depends on every rank's rows through the
    global statistics: their all-reduce is differentiable, its backward
    an all-reduce of the cotangents, so the gradient rank r computes
    carries, besides d l_r through its own rows, every rank's
    d l_s / d stat times d stat / d (its rows). Summed over the ranks these
    are every path of d (sum_r l_r), and the mean over ranks is dL. No DDP
    wrapper: the step calls ``torch.autograd.grad`` itself.

    The spatial axis: the S peers of a data block compute one loss l_d
    together. Each gathers the heads whole and computes the same l_d on
    them; the gather's backward hands each peer the cotangent of its own
    rows, and every halo exchange's backward sends a row's cotangent back
    to its owner, so peer s's gradient is d l_d through its rows, and the
    sum over the peers is d l_d, counted once. The BN statistics of a
    level sum every rank's rows, so their all-reduce's backward sums every
    peer's partial cotangent too. Summed over the world and divided by
    the D data blocks, the gradients are again dL. A layer the peers run
    replicated on whole rows (a connected head after the flatten's gather)
    gives each peer the whole d l_d: its sum over the world is divided by
    D x S instead.

    Parameters, optimizer state and running statistics stay equal on every
    rank: every rank applies the same update to the same values, and NCCL's
    and gloo's all-reduce give every rank the same bits of a sum (two ranks:
    a + b = b + a in floating point, whatever the order;
    tests/test_torch_parallel.py checks it). Random draws (dropout, v1's
    ``random`` responsibility) come from each rank's generator
    (``create_train_state(mesh=)``). A mesh of one rank, with a process
    group or without, is the one-card ``make_train_step``: it calls no
    collective."""
    return make_train_step(cfg, tx, mesh=mesh, **kw)


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
